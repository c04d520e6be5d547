"""The kept lane pools (integrator/wavefront.py::_POOLS, _GRAD_POOLS) on
the card, with real CUDA graphs: frames and gradient steps that replay the
graphs an earlier frame or step captured, bit for bit the frames and steps
run op by op, and the memory a dropped scene's pool gives back.

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
    for cache in (twf._POOLS, twf._FRAME_TABLES, twf._GRAD_POOLS):
        cache.clear()
    yield str(tmp_path)
    for cache in (twf._POOLS, twf._FRAME_TABLES, twf._GRAD_POOLS):
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


@pytest.mark.card
def test_gradient_steps_leave_no_memory_behind(box):
    """The gradient's lane pool, its graphs and buffers are kept from one
    step to the next (wavefront._GRAD_POOLS), and a step frees all else it
    made when it returns (no reference cycle); the captures run on the
    device's one side stream, so no library keeps per-stream state for a
    step: what is allocated after a step is the same after every step."""
    from montecarlopathtracing_torch.diff import gradients as G

    scene = _load(box)
    params = G.SceneParams.from_scene(scene)
    target = torch.zeros(256, 256, 3, device="cuda")
    opts = RenderOptions(spp=2)
    after = []
    for seed in range(4):
        G.loss_and_grad(params, scene, None, opts.replace(seed=seed), target,
                        device="cuda")
        torch.cuda.synchronize()
        after.append(torch.cuda.memory_allocated())
    assert after[0] == after[1] == after[2] == after[3], after
    assert len(twf._GRAD_POOLS.entries) == 1
    del scene
    assert not twf._GRAD_POOLS.entries


def _sgd_steps(scene, opts, seeds):
    """Box gradient steps with an out-of-place SGD update between them:
    [(image, loss, gradient)] a step, and grad_loop_stats() of the steps
    after the first."""
    from montecarlopathtracing_torch.diff import gradients as G

    params, out, stats = G.SceneParams.from_scene(scene), [], []
    h, w = scene.camera.height, scene.camera.width
    target = torch.rand((h, w, 3), generator=torch.Generator().manual_seed(5))
    target = target.to("cuda")
    for k, seed in enumerate(seeds):
        leaves = params.leaves("cuda")
        o = opts.replace(seed=seed)
        img = G.render_with_params(leaves, scene, None, o, device="cuda")
        loss = torch.mean((img - target) ** 2)
        g = G.param_grads(loss, leaves)
        torch.cuda.synchronize()
        out.append((img.detach(), loss.detach(), g))
        params = params.map(lambda p, d: p.detach() - 0.05 * d, g)
        if k == 0:
            twf.reset_loop_stats()
    return out, twf.grad_loop_stats()


@pytest.mark.card
def test_gradient_steps_replay_kept_graphs_bit_for_bit(box):
    """Box gradient steps 2-4, each with another seed and new parameter
    values, capture nothing and run no block op by op: both passes replay
    the graphs step 1 captured, and every image, loss and gradient is bit
    for bit the step run op by op."""
    from montecarlopathtracing_torch.diff import gradients as G

    scene = _load(box)
    opts = RenderOptions(spp=4)
    seeds = (31, 32, 33, 34)
    with timing.tracing() as tr:
        steps, st = _sgd_steps(scene, opts, seeds)
    with twf.eager():
        eager, _ = _sgd_steps(scene, opts, seeds)
    assert not torch.equal(steps[0][0], steps[1][0])
    for (img, loss, g), (img_e, loss_e, g_e) in zip(steps, eager):
        assert torch.equal(img, img_e) and torch.equal(loss, loss_e)
        for f in G.PARAM_FIELDS:
            assert torch.equal(getattr(g, f), getattr(g_e, f)), f
    assert st["dispatches"] == st["bwd_passes"] == 3
    assert st["fwd_graphs"] == st["bwd_graphs"] == 0
    assert st["fwd_eager_blocks"] == st["bwd_eager_blocks"] == 0
    assert st["fwd_pool_reuses"] == st["bwd_pool_reuses"] == 3
    reused = [s["counts"]["reused"] for s in tr.spans
              if s["name"] == "pool_setup"]
    assert reused == [0, 1, 1, 1]
