"""The kept lane pools (integrator/wavefront.py::_POOLS) on the card, with
real CUDA graphs: frames that replay the graphs an earlier frame captured,
bit for bit the frames run op by op, and the memory a dropped scene's pool
gives back.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX (tests/conftest.py does), so on the card it runs alone:

    python -m pytest tests/test_torch_pool_card.py --noconftest -p no:cacheprovider -q
"""

import gc

import pytest
import torch

from montecarlopathtracing_torch import api
from montecarlopathtracing_torch.config import RenderOptions
from montecarlopathtracing_torch.integrator import wavefront as twf
from montecarlopathtracing_torch.scene.builtin import write_box_scene
from montecarlopathtracing_torch.utils import timing

# Frames of spp 4 in two dispatches of 2 on the default lanes: blocks of 8
# iterations meet one flush phase (a flush every 4), so the first dispatch
# captures every graph the frames need.
OPTS = RenderOptions(spp=4, spp_chunk=2)


@pytest.fixture
def box(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the lane pool captures graphs only there")
    write_box_scene(str(tmp_path), "box", width=256, height=256)
    for cache in (twf._POOLS, twf._FRAME_TABLES):
        cache.clear()
    yield str(tmp_path)
    for cache in (twf._POOLS, twf._FRAME_TABLES):
        cache.clear()


def _load(box):
    return api.load_scene(box, "box", OPTS, device="cuda")[0]


def _frame(scene, seed: int):
    img, rays = twf.render_image_host_chunked(scene, None,
                                              OPTS.replace(seed=seed),
                                              device="cuda")
    torch.cuda.synchronize()
    return img, rays


@pytest.mark.card
def test_frames_replay_kept_graphs_bit_for_bit(box):
    scene = _load(box)
    twf.reset_loop_stats()
    first = _frame(scene, 7)
    with timing.tracing() as tr:
        second = _frame(scene, 8)
    st = twf.loop_stats()
    with twf.eager():
        eager = [_frame(scene, k) for k in (7, 8)]
    assert not torch.equal(first[0], second[0])
    for (img, rays), (img_e, rays_e) in zip((first, second), eager):
        assert torch.equal(img, img_e) and rays == rays_e > 0
    names = [s["name"] for s in tr.spans]
    assert "replay" in names
    assert "capture" not in names and "eager_block" not in names
    assert st["dispatches"] == 4 and st["eager_blocks"] == 1
    assert st["graphs"] == 1 and st["pool_reuses"] == 3
    assert len(twf._POOLS.entries) == 1


@pytest.mark.card
def test_a_dropped_scene_gives_its_pool_memory_back(box):
    # A first scene's frame makes what lives on past any scene (the
    # kernels' libraries' state); its own pool goes with it.
    scene = _load(box)
    _frame(scene, 1)
    del scene
    gc.collect()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    scene = _load(box)
    for k in (2, 3):
        img, _ = _frame(scene, k)
    assert len(twf._POOLS.entries) == len(twf._FRAME_TABLES.entries) == 1
    assert torch.cuda.memory_allocated() > before
    del scene, img
    gc.collect()
    torch.cuda.synchronize()
    assert not twf._POOLS.entries and not twf._FRAME_TABLES.entries
    assert torch.cuda.memory_allocated() == before
