"""The forward lane pool's block loop (integrator/wavefront.py::_Blocks).

On a CUDA device every block of ``check_every`` iterations after the first
replays a CUDA graph; on the CPU the same block function runs op by op.
These tests hold, on the CPU:

* the block loop to the per-iteration loop (blocks of one iteration, the
  drain predicate read after every iteration), bit for bit in the film and
  the ray count, for block lengths that the flush cadence (n_pend * spp
  iterations) does and does not divide, in compat and MODERN mode, once
  inside ``eager()``;
* the graph bookkeeping, with a stand-in for ``torch.cuda.CUDAGraph``
  whose capture runs the block's Python once and whose replays run it with
  the launch counters held still (as a replay runs no Python): the film,
  the ray count and ``launch_counts()`` the same as op by op, with graphs
  captured and replayed;
* the kernels' launch counts to one key and one intersect launch per
  iteration plus the bootstrap's, however the iterations are grouped;
* the block-structured render to the JAX package's ``render_pixels_refill``
  (Pallas in interpret mode) at tests/test_torch_render.py's whole-render
  tolerance;
* the kept lane pools (``wavefront._POOLS``): frames of several dispatches
  and seeds through ``render_image_host_chunked`` on one pool, bit for bit
  the frames run op by op, its graphs captured once over them; a new pool
  for a new key; a pool that goes with its scene.  The stand-in replays
  run the captured block's Python again, so a seed or a sample offset
  baked into a block would show.

On the CPU the kernel wrappers run their plain versions and count nothing,
so the launch-count tests count through a stand-in for the card's wrappers
that adds one launch of each kernel of the single-table plan per intersect
call.
"""

import contextlib
import gc
import os
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopathtracing_tpu.config import MODERN as JMODERN
from montecarlopathtracing_tpu.config import RenderOptions as JOpts
from montecarlopathtracing_tpu.integrator.wavefront import (
    render_pixels_refill as jrefill)
from montecarlopathtracing_tpu.scene.builtin import box_scene_text
from montecarlopathtracing_tpu.scene.loader import build_scene as jbuild
from montecarlopathtracing_torch.config import MODERN, RenderOptions
from montecarlopathtracing_torch.integrator import wavefront as twf
from montecarlopathtracing_torch.kernels import cluster as K
from montecarlopathtracing_torch.scene.loader import build_scene as tbuild
from montecarlopathtracing_torch.utils import timing

torch.set_num_threads(2)

BASE = dict(max_depth=8, cluster_width=4, cluster_rays=16, sort_rays=True)
LANES = 96


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("graph_blocks"))
    obj, mtl, cam = box_scene_text(with_specular=True, with_glass=True,
                                   width=16, height=16)
    for ext, text in ((".obj", obj), (".mtl", mtl), (".camera", cam)):
        with open(os.path.join(d, "box" + ext), "w") as fh:
            fh.write(text)
    return d


def _opts(spp: int, modern: bool, **kw):
    return RenderOptions(spp=spp, **BASE, **({"compat": MODERN} if modern else {}),
                         **kw)


def _render(scene_dir, spp: int, modern: bool, length: int):
    opts = _opts(spp, modern)
    ts, _ = tbuild(scene_dir, "box", opts, device="cpu")
    ids, fn = twf._frame_ids(ts, opts)
    return twf.render_pixels_refill(ts, None, opts, ids, lanes=LANES,
                                    pixel_fn=fn, check_every=length)


@pytest.fixture(scope="module")
def per_iteration(scene_dir):
    """The per-iteration loop's (film, rays) by (spp, modern), made once."""
    cache = {}

    def get(spp: int, modern: bool):
        if (spp, modern) not in cache:
            cache[(spp, modern)] = _render(scene_dir, spp, modern, 1)
        return cache[(spp, modern)]

    return get


# spp -> flush cadence n_pend * spp: 1 -> 2, 3 -> 6, 5 -> 10, 16 -> 16; the
# cadence divides block lengths 8 (spp 1), 24 (spp 1, 3) and 40 (spp 1, 5),
# and no others.
CASES = [pytest.param(spp, length, modern, False,
                      id=f"spp{spp}-len{length}-{'modern' if modern else 'compat'}")
         for spp in (1, 3, 5, 16) for length in (8, 24, 40)
         for modern in (False, True)]
CASES += [pytest.param(16, 8, True, True, id="spp16-len8-modern-eager"),
          pytest.param(5, 24, False, True, id="spp5-len24-compat-eager")]


@pytest.mark.parametrize("spp,length,modern,under_eager", CASES)
def test_blocks_match_per_iteration_loop(scene_dir, per_iteration, spp, length,
                                         modern, under_eager):
    if under_eager:
        with twf.eager():
            img, rays = _render(scene_dir, spp, modern, length)
        assert not twf._eager  # restored on the way out
    else:
        img, rays = _render(scene_dir, spp, modern, length)
    ref_img, ref_rays = per_iteration(spp, modern)
    assert torch.equal(img, ref_img)
    assert int(rays) == int(ref_rays)


class FakeGraph:
    """Stand-in for a captured CUDA graph on the CPU.  The capture ran the
    block (a real capture launches nothing, and its first replay does the
    work, so the first replay here does nothing); every later replay runs
    the block again with the launch counters held still, since a real
    replay runs no Python."""

    def __init__(self, fn):
        self.fn, self.first = fn, True

    def replay(self):
        if self.first:
            self.first = False
            return
        held = [w.launches for w in twf._COUNTED]
        self.fn()
        for w, n in zip(twf._COUNTED, held):
            w.launches = n


class FakeGraphs:
    def __init__(self, dev):
        self.dev = dev

    def warm_up(self, fn):
        fn()

    def capture(self, fn):
        fn()
        return FakeGraph(fn)


@pytest.fixture
def fake_graphs(monkeypatch):
    """The card's path on the CPU: blocks after the first are 'captured' and
    'replayed' through FakeGraph."""
    monkeypatch.setattr(twf, "_captures", lambda dev: True)
    monkeypatch.setattr(twf, "_CudaGraphs", FakeGraphs)


@pytest.fixture
def counting(monkeypatch):
    """Each intersect call counts one launch of the single-table plan's key
    and intersect kernels, as their wrappers do on the card."""
    real = twf.intersect_any

    def counted(*args, **kw):
        for name in ("cluster_keys", "cluster_intersect"):
            K._WRAPPERS[name].launches += 1
        return real(*args, **kw)

    monkeypatch.setattr(twf, "intersect_any", counted)
    K.reset_launch_counts()
    twf.reset_loop_stats()
    yield
    K.reset_launch_counts()
    twf.reset_loop_stats()


def _counted_render(scene_dir, spp, modern, length):
    K.reset_launch_counts()
    twf.reset_loop_stats()
    img, rays = _render(scene_dir, spp, modern, length)
    return img, int(rays), K.launch_counts(), twf.loop_stats()


# Flush phases met: spp 3 at length 8 (cadence 6) two, spp 5 at 8 (cadence
# 10) four, spp 16 at 24 and at 40 (cadence 16) two each.
@pytest.mark.parametrize("spp,length,modern", [(3, 8, False), (5, 8, True),
                                               (16, 24, True), (16, 40, False)])
def test_graph_replays_match_op_by_op(scene_dir, counting, monkeypatch, spp,
                                      length, modern):
    img, rays, launches, stats = _counted_render(scene_dir, spp, modern, length)
    assert stats["graphs"] == stats["replays"] == 0
    assert stats["eager_blocks"] * length == stats["iterations"]
    monkeypatch.setattr(twf, "_captures", lambda dev: True)
    monkeypatch.setattr(twf, "_CudaGraphs", FakeGraphs)
    g_img, g_rays, g_launches, g_stats = _counted_render(scene_dir, spp, modern,
                                                         length)
    assert torch.equal(g_img, img) and g_rays == rays
    assert g_launches == launches and launches["cluster_intersect"] > 0
    assert g_stats["eager_blocks"] == 1
    flush_every = 2 * spp if spp < 16 else spp  # n_pend * spp
    phases = len({i0 % flush_every
                  for i0 in range(length, g_stats["iterations"], length)})
    assert g_stats["graphs"] == phases >= 1
    assert g_stats["replays"] == g_stats["iterations"] // length - 1 > 1
    assert g_stats["iterations"] == stats["iterations"]
    assert g_stats["idle_iterations"] == stats["idle_iterations"] < length


@pytest.mark.parametrize("length", [1, 8, 24, 40])
@pytest.mark.parametrize("graphs", [False, True], ids=["op_by_op", "graphs"])
def test_launch_counts_follow_iterations(scene_dir, counting, monkeypatch,
                                         length, graphs):
    """One key and one intersect launch per iteration and one for the
    bootstrap, however the iterations are grouped into blocks; blocks of
    one iteration run none past the drain."""
    if graphs:
        monkeypatch.setattr(twf, "_captures", lambda dev: True)
        monkeypatch.setattr(twf, "_CudaGraphs", FakeGraphs)
    _, _, launches, stats = _counted_render(scene_dir, 3, True, length)
    n = stats["iterations"]
    assert stats["dispatches"] == 1 and n % length == 0
    assert launches == {"cluster_keys": n + 1, "cluster_intersect": n + 1,
                        "cluster_keys_chunked": 0, "cluster_intersect_ftb": 0,
                        "cluster_intersect_hbm": 0}
    assert 0 <= stats["idle_iterations"] < length
    if length == 1:
        assert stats["idle_iterations"] == 0


def test_eager_restores_on_error():
    with pytest.raises(RuntimeError):
        with twf.eager():
            assert twf._eager and not twf._captures(torch.device("cuda"))
            raise RuntimeError("inside")
    assert not twf._eager
    assert twf._captures(torch.device("cuda"))
    assert not twf._captures(torch.device("cpu"))


def _outside(a, b):
    return np.abs(a - b) > 1e-5 + 1e-4 * np.abs(a)


@pytest.mark.parametrize("length", [8, 24])
def test_block_render_matches_jax_refill(scene_dir, fake_graphs, length):
    """The block-structured lane pool (graph bookkeeping on) against the JAX
    package's render_pixels_refill with interpret-mode Pallas, MODERN, spp
    4: tests/test_torch_render.py's whole-render tolerance (at most 0.5% of
    values outside rtol 1e-4 / atol 1e-5, means within 1e-4 relative, rays
    within 0.5%)."""
    opts = _opts(4, True)
    jopts = JOpts(intersector="cluster_interpret", spp=4, compat=JMODERN, **BASE)
    ts, _ = tbuild(scene_dir, "box", opts, device="cpu")
    js, _ = jbuild(scene_dir, "box", jopts)
    ids, _ = twf._frame_ids(ts, opts)
    ti, tr = twf.render_pixels_refill(ts, None, opts, ids, lanes=LANES,
                                      check_every=length)
    ji, jr = jrefill(js, None, jopts, jnp.asarray(ids.numpy()), lanes=LANES)
    ji, ti = np.asarray(ji), ti.numpy()
    assert ti.shape == ji.shape == (ids.shape[0], 3)
    assert np.isfinite(ti).all() and ti.mean() > 0
    assert _outside(ji, ti).any(axis=1).mean() <= 0.005
    assert abs(ti.mean() - ji.mean()) <= 1e-4 * abs(ji.mean())
    assert abs(int(tr) - float(jr)) <= 0.005 * float(jr)


@pytest.fixture
def kept_pools(monkeypatch):
    """The card's path on the CPU with the stand-in graphs, ``eager()``
    turning it off as on the card, and no pool kept from another test."""
    monkeypatch.setattr(twf, "_captures", lambda dev: not twf._eager)
    monkeypatch.setattr(twf, "_CudaGraphs", FakeGraphs)
    for cache in (twf._POOLS, twf._FRAME_TABLES):
        cache.clear()
    yield
    for cache in (twf._POOLS, twf._FRAME_TABLES):
        cache.clear()


def _frames(scene, opts, seeds):
    return [twf.render_image_host_chunked(scene, None, opts.replace(seed=k),
                                          device="cpu") for k in seeds]


def _pool_opts(spp: int, spp_chunk: int, modern: bool = False, **kw):
    return _opts(spp, modern, spp_chunk=spp_chunk, chunk_size=LANES, **kw)


# Frame spp in dispatches of spp_chunk samples: a flush every 4 iterations
# (dispatches of 2: blocks of 8 meet one flush phase), every 6 (of 3: phases
# 0, 2, 4) or every 10 (of 5: phases 0, 8, 6, 4, 2; on 48 lanes, so that
# the first dispatch runs past its fifth block and meets phase 0 again).
@pytest.mark.parametrize("spp,spp_chunk,modern,lanes", [
    pytest.param(4, 2, False, LANES, id="spp4-by2-compat"),
    pytest.param(6, 3, True, LANES, id="spp6-by3-modern"),
    pytest.param(10, 5, False, 48, id="spp10-by5-compat")])
def test_frames_on_a_kept_pool_match_op_by_op(scene_dir, kept_pools,
                                              monkeypatch, spp, spp_chunk,
                                              modern, lanes):
    opts = _pool_opts(spp, spp_chunk, modern).replace(chunk_size=lanes)
    scene, _ = tbuild(scene_dir, "box", opts, device="cpu")
    starts = []  # each block's first iteration, in order
    run = twf._Blocks.run

    def recorded(blocks, i0):
        starts.append(i0)
        return run(blocks, i0)

    monkeypatch.setattr(twf._Blocks, "run", recorded)
    twf.reset_loop_stats()
    frames = _frames(scene, opts, (3, 4))
    st = twf.loop_stats()
    with twf.eager():
        eager = _frames(scene, opts, (3, 4))
    assert frames[0][1] != frames[1][1]  # the seeds differ
    for (img, rays), (img_e, rays_e) in zip(frames, eager):
        assert torch.equal(img, img_e) and rays == rays_e > 0
    n = 2 * len(twf.spp_steps(opts))
    assert twf.spp_steps(opts) == [spp_chunk] * (spp // spp_chunk)
    assert st["dispatches"] == n and len(twf._POOLS.entries) == 1
    # The pool's first block ran op by op; every later block replays the
    # graph of its flush phase, captured where the phase first came up.
    starts = starts[:st["iterations"] // 8]
    flush_every = 2 * spp_chunk  # n_pend * spp of a dispatch
    assert st["eager_blocks"] == 1
    assert st["graphs"] == len({i0 % flush_every for i0 in starts[1:]})
    assert st["replays"] == len(starts) - 1
    # Every dispatch after the first met only captured phases.
    bounds = [k for k, i0 in enumerate(starts) if i0 == 0] + [len(starts)]
    assert len(bounds) == n + 1
    captured = {i0 % flush_every for i0 in starts[1:bounds[1]]}
    for a, b in zip(bounds[1:], bounds[2:]):
        assert {i0 % flush_every for i0 in starts[a:b]} <= captured
    assert st["pool_reuses"] == n - 1


# What one frame changes after a frame of spp 4 in dispatches of 2 on 96
# lanes: nothing, the dispatch's spp, the lanes, one option, the scene (the
# same files loaded again: other tensors), a scene tensor in place (as an
# optimizer step would: the stale pool is replaced, not kept beside).
CHANGES = {"nothing": {}, "dispatch_spp": dict(spp=6, spp_chunk=3),
           "lanes": dict(chunk_size=64), "option": dict(max_depth=5),
           "scene": {}, "in_place": {}}


@pytest.mark.parametrize("change", list(CHANGES))
def test_a_changed_key_makes_a_new_pool(scene_dir, kept_pools, change):
    opts = _pool_opts(4, 2)
    scene, _ = tbuild(scene_dir, "box", opts, device="cpu")
    _frames(scene, opts, (3,))
    assert len(twf._POOLS.entries) == 1
    first = scene  # held: its pool stays
    if change == "scene":
        scene = tbuild(scene_dir, "box", opts, device="cpu")[0]
    if change == "in_place":
        with torch.no_grad():
            scene.kd.mul_(0.75)
    opts = opts.replace(**CHANGES[change])
    twf.reset_loop_stats()
    with timing.tracing() as tr:
        ((img, rays),) = _frames(scene, opts, (4,))
    st = twf.loop_stats()
    with twf.eager():
        ((img_e, rays_e),) = _frames(scene, opts, (4,))
    assert torch.equal(img, img_e) and rays == rays_e > 0
    reused = [s["counts"]["reused"] for s in tr.spans
              if s["name"] == "pool_setup"]
    assert len(reused) == st["dispatches"] == 2
    if change == "nothing":
        assert reused == [1, 1] and st["eager_blocks"] == 0
        assert st["pool_reuses"] == 2 and len(twf._POOLS.entries) == 1
    else:
        assert reused == [0, 1] and st["eager_blocks"] == 1
        kept = 1 if change == "in_place" else 2
        assert len(twf._POOLS.entries) == len(twf._FRAME_TABLES.entries) == kept
    del first


@pytest.mark.parametrize("inside_capture", [False, True],
                         ids=["outside_capture", "inside_capture"])
def test_a_dropped_scene_takes_its_pool_along(scene_dir, kept_pools,
                                              inside_capture):
    """The kept pool and frame tables hold the scene by alias: when the
    caller drops the scene they go, by reference counting alone (no cycle
    is left to the collector); inside a capture, when it ends."""
    opts = _pool_opts(4, 2)
    scene, _ = tbuild(scene_dir, "box", opts, device="cpu")
    _frames(scene, opts, (3, 4))
    ((pool, *_),) = twf._POOLS.entries.values()
    pool = weakref.ref(pool)
    kd = weakref.ref(scene.kd)
    assert len(twf._FRAME_TABLES.entries) == 1
    gc.disable()
    try:
        with twf._capture_guard() if inside_capture else contextlib.nullcontext():
            del scene
            assert kd() is None
            assert not twf._POOLS.entries and not twf._FRAME_TABLES.entries
            assert (pool() is not None) == inside_capture
        assert pool() is None and not twf._doomed
    finally:
        gc.enable()
    gc.collect()
    assert not twf._POOLS.entries and not twf._FRAME_TABLES.entries
