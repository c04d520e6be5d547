"""The scan renderer (``refill=False``) on fixed buffers in blocks
(integrator/wavefront.py::_ScanFrame, _ScanCall).

On a CUDA device each kind of block of the scan renderer (the primary
block, a block of bounces, the last block cut at ``max_depth``, the finish
block; in a gradient's backward pass the recompute and the VJP) replays a
CUDA graph after its first run, one set of graphs for every chunk of a
frame; on the CPU, and inside ``eager()``, the same block functions run op
by op.  These tests hold, on the CPU, with the stand-in graphs of
tests/test_torch_graph_blocks.py (a capture runs the block's Python once,
every later replay runs it again with the launch counters held still):

* the frame, its ray count and its launches, and the gradient (image, rays,
  every field, launches of both passes), bit for bit the same under
  ``eager()``, on the 16 x 16 spec+glass box and the checker-textured box
  (the atlas's gradient), compat and MODERN, spp 1, 3 and 5, max_depth 6
  and 32, two chunks of 128 lanes; the gradient's image bit for bit the
  forward frame (the bounces past the drain change nothing);
* the gradient against plain autograd through every bounce (the same block
  functions recorded by autograd, nothing recomputed) at atol 1e-6 + 1e-5
  x the field's largest magnitude: the per-block sums associate
  differently, so bit for bit is not expected;
* the frame and the gradient against the JAX package's
  ``render_image_stats(refill=False)`` and jitted ``loss_and_grad``
  (interpret-mode Pallas) at tests/test_torch_scan.py's and
  tests/test_torch_diff.py's tolerances;
* the RNG with the bounce depth and the sample index as device tensors,
  as the blocks pass them, bit for bit the RNG with Python ints;
* one set of graphs per frame, shared by every chunk and spp step, freed
  with the frame when its last user lets go of it;
* the backward pass recomputes every sample (the JAX package's
  ``jax.checkpoint(sample_body)``): its key and intersect launches are
  exactly the forward pass's, kernel by kernel; a tracked call holds
  nothing of its samples between the passes, and the backward pass holds
  one sample's residual copies at a time, whatever ``spp`` and the number
  of chunks (``scan_stats()["residual_bytes"]``).
"""

import gc
import os
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopathtracing_tpu.config import MODERN as JMODERN
from montecarlopathtracing_tpu.config import RenderOptions as JOpts
from montecarlopathtracing_tpu.diff import gradients as jgrad
from montecarlopathtracing_tpu.integrator import wavefront as jwf
from montecarlopathtracing_tpu.scene.builtin import box_scene_text
from montecarlopathtracing_tpu.scene.loader import build_scene as jbuild
from montecarlopathtracing_torch.config import MODERN, RenderOptions
from montecarlopathtracing_torch.diff import gradients as tgrad
from montecarlopathtracing_torch.diff.gradients import PARAM_FIELDS, SceneParams
from montecarlopathtracing_torch.integrator import rng
from montecarlopathtracing_torch.integrator import wavefront as twf
from montecarlopathtracing_torch.kernels import cluster as K
from montecarlopathtracing_torch.scene.builtin import write_box_scene
from montecarlopathtracing_torch.scene.loader import build_scene as tbuild
from montecarlopathtracing_torch.scene.types import scene_params_from_numpy
from test_torch_graph_blocks import FakeGraphs, counting  # noqa: F401 (fixture)

torch.set_num_threads(2)

# 16 x 16 frames in 4 x 4 subtiles: 256 pixel ids, two chunks of 128 lanes.
BASE = dict(cluster_width=4, cluster_rays=16, sort_rays=True, chunk_size=128,
            refill=False, ns_gradient=True)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("scan_graphs"))
    obj, mtl, cam = box_scene_text(with_specular=True, with_glass=True,
                                   width=16, height=16)
    for ext, text in ((".obj", obj), (".mtl", mtl), (".camera", cam)):
        with open(os.path.join(d, "sg16" + ext), "w") as fh:
            fh.write(text)
    write_box_scene(d, "tex", with_texture=True, width=16, height=16)
    return d


def _opts(spp: int, max_depth: int, modern: bool, **kw):
    return RenderOptions(spp=spp, max_depth=max_depth, **{**BASE, **kw},
                         **({"compat": MODERN} if modern else {}))


def _weights():
    return torch.as_tensor(np.random.default_rng(4).uniform(
        0.5, 1.5, (16, 16, 3)).astype(np.float32))


def _frame(scene, opts):
    """(image, rays, launches, scan_stats) of render_image_stats."""
    K.reset_launch_counts()
    twf.reset_loop_stats()
    img, rays = twf.render_image_stats(scene, None, opts, device="cpu")
    return img, int(rays), K.launch_counts(), twf.scan_stats()


def _gradient(scene, opts):
    """d sum(w * image) / d SceneParams through render_image_stats:
    (image, rays, gradient, launches forward, launches backward,
    scan_stats)."""
    leaves = SceneParams.from_scene(scene).leaves("cpu")
    K.reset_launch_counts()
    twf.reset_loop_stats()
    img, rays = twf.render_image_stats(tgrad.apply_params(scene, leaves), None,
                                       opts, differentiable=True, device="cpu")
    fwd = K.launch_counts()
    K.reset_launch_counts()
    g = tgrad.param_grads(torch.sum(img * _weights()), leaves)
    return img.detach(), int(rays), g, fwd, K.launch_counts(), twf.scan_stats()


def _captured(monkeypatch, fn):
    """fn() on the card's path, with the stand-in graphs."""
    with monkeypatch.context() as m:
        m.setattr(twf, "_captures", lambda dev: True)
        m.setattr(twf, "_CudaGraphs", FakeGraphs)
        return fn()


CASES = [pytest.param(name, spp, depth, modern,
                      id=f"{name}-spp{spp}-depth{depth}-"
                      + ("modern" if modern else "compat"))
         for name, spp, depth, modern in (
             ("sg16", 1, 6, False), ("sg16", 3, 32, True), ("sg16", 5, 32, False),
             ("tex", 5, 6, True), ("tex", 3, 32, False), ("tex", 1, 32, True))]


@pytest.mark.parametrize("name,spp,depth,modern", CASES)
def test_captured_scan_is_bitwise_eager(scene_dir, counting, monkeypatch, name,
                                        spp, depth, modern):
    opts = _opts(spp, depth, modern)
    ts, _ = tbuild(scene_dir, name, opts, device="cpu")
    with twf.eager():
        img_e, rays_e, launches_e, st_e = _frame(ts, opts)
        gimg_e, grays_e, g_e, fwd_e, bwd_e, gst_e = _gradient(ts, opts)
    img, rays, launches, st = _captured(monkeypatch, lambda: _frame(ts, opts))
    gimg, grays, g, fwd, bwd, gst = _captured(monkeypatch,
                                              lambda: _gradient(ts, opts))
    assert torch.equal(img, img_e) and rays == rays_e > 0
    assert launches == launches_e and launches["cluster_intersect"] > 0
    assert torch.equal(gimg, img) and grays == rays
    assert torch.equal(gimg, gimg_e) and grays == grays_e
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(g, f), getattr(g_e, f)), f
    assert float(g.kd.abs().max()) > 0
    if name == "tex":
        assert float(g.atlas.abs().max()) > 0
    assert fwd == fwd_e and fwd["cluster_intersect"] > 0
    # Backward recomputes every sample: the forward's launches again.
    assert bwd == bwd_e == fwd
    for s, s_e, passes in ((st, st_e, ("fwd",)), (gst, gst_e, ("fwd", "bwd"))):
        assert s["frames"] == s_e["frames"] == 1
        assert s["calls"] == s_e["calls"] == 2  # two chunks
        assert s["samples"] == 2 * spp
        for k in ("bounces", "idle_bounces"):
            assert s[k] == s_e[k]
        for p in passes:
            blocks = s_e[f"{p}_eager_blocks"]
            assert s_e[f"{p}_graphs"] == s_e[f"{p}_replays"] == 0
            # Each kind of block runs op by op once, then replays a graph.
            assert s[f"{p}_eager_blocks"] + s[f"{p}_replays"] == blocks
            assert 1 <= s[f"{p}_graphs"] <= s[f"{p}_eager_blocks"] <= (
                4 if p == "fwd" else 6)
            assert s[f"{p}_replays"] >= s[f"{p}_graphs"]
    # A differentiable render runs exactly max_depth bounces a sample.
    assert gst["bounces"] == 2 * spp * depth >= st["bounces"]
    assert st["idle_bounces"] < 8 * 2 * spp  # the last block's overrun


def test_one_set_of_graphs_per_frame(scene_dir, counting, monkeypatch):
    """render_image_host_chunked's dispatches (two chunks x three spp steps)
    share one frame's graphs; render_pixels alone makes its own; the
    captured film is bit for bit the eager one."""
    opts = _opts(5, 32, True, spp_chunk=2)
    ts, _ = tbuild(scene_dir, "sg16", opts, device="cpu")

    def host_chunked():
        K.reset_launch_counts()
        twf.reset_loop_stats()
        img, rays = twf.render_image_host_chunked(ts, None, opts, device="cpu")
        return img, rays, K.launch_counts(), twf.scan_stats()

    with twf.eager():
        img_e, rays_e, launches_e, st_e = host_chunked()
    img, rays, launches, st = _captured(monkeypatch, host_chunked)
    assert torch.equal(img, img_e) and rays == rays_e > 0
    assert launches == launches_e
    assert st["frames"] == 1 and st["calls"] == 2 * 3 and st["samples"] == 10
    # Each kind of block (at most four) ran op by op once in the frame and
    # was captured once; every other block of the six calls is a replay.
    assert st["fwd_eager_blocks"] == st["fwd_graphs"] <= 4
    assert st_e["fwd_eager_blocks"] == st["fwd_eager_blocks"] + st["fwd_replays"]
    assert st["fwd_replays"] > 6 * st["fwd_graphs"]
    twf.reset_loop_stats()
    ids, _ = twf._frame_ids(ts, opts)
    _captured(monkeypatch, lambda: (
        twf.render_pixels(ts, None, opts, ids[:128]),
        twf.render_pixels(ts, None, opts, ids[128:])))
    assert twf.scan_stats()["frames"] == 2


def test_frames_are_freed_without_the_garbage_collector(scene_dir,
                                                         monkeypatch):
    """A frame, and with it its graphs, is freed when its last user lets it
    go (a forward render when it returns, a gradient when its autograd
    graph is dropped), not left to the cyclic garbage collector, which may
    run inside a later capture, where destroying a graph breaks it."""
    opts = _opts(2, 8, True)
    ts, _ = tbuild(scene_dir, "sg16", opts, device="cpu")
    frames = []
    init = twf._ScanFrame.__init__

    def tracked(self, *a, **kw):
        init(self, *a, **kw)
        frames.append(weakref.ref(self))

    monkeypatch.setattr(twf._ScanFrame, "__init__", tracked)
    gc.disable()
    try:
        _captured(monkeypatch, lambda: _frame(ts, opts))
        assert frames[0]() is None
        leaves = SceneParams.from_scene(ts).leaves("cpu")
        img, _ = _captured(monkeypatch, lambda: twf.render_image_stats(
            tgrad.apply_params(ts, leaves), None, opts, differentiable=True,
            device="cpu"))
        tgrad.param_grads(img.sum(), leaves)
        assert frames[1]() is not None  # the autograd graph holds it
        del img
        assert frames[1]() is None
    finally:
        gc.enable()


def test_rng_takes_device_counters():
    """rng.lane_keys and rng.bounce_uniforms with the sample index and the
    bounce depth as 0-d int64 tensors (the blocks' device buffers) give
    the Python-int path's bits."""
    pix = torch.as_tensor(np.random.default_rng(0).integers(
        0, 1 << 21, 512).astype(np.int32))
    for s in (0, 1, 7, 1 << 20, (1 << 31) + 5, (1 << 32) - 1):
        keys = rng.lane_keys(9, pix, s)
        assert torch.equal(keys, rng.lane_keys(9, pix, torch.tensor(s)))
        for depth in (0, 1, 31, 1 << 30):
            a = rng.bounce_uniforms(keys, depth, 9)
            assert torch.equal(a, rng.bounce_uniforms(keys, torch.tensor(depth), 9))


class PlainAutograd:
    """Stand-in for _CheckpointedBlocks: the call's samples through the
    same block functions recorded by autograd through every bounce, the
    radiance summed out of place, nothing recomputed."""

    @staticmethod
    def apply(call, *inputs):
        f = call.frame
        env = twf._grad_env(f.scene, inputs)
        res = twf._Residuals()
        st = dict(f.state)
        st.update(acc=torch.zeros_like(st["acc"]), rays=torch.zeros_like(st["rays"]))
        for s in range(call.spp):
            f.load(call.pix, call.offset + s)
            f._primary(st, env, res)
            for n in f.sizes:
                f._bounces(st, env, res, n)
            f._finish(st)
        with torch.no_grad():  # the caller reads the ray count here
            f.state["rays"].copy_(st["rays"])
        return st["acc"]


@pytest.mark.parametrize("name,spp,depth,modern", [("sg16", 3, 32, True),
                                                   ("tex", 5, 6, False)])
def test_scan_gradient_matches_plain_autograd(scene_dir, monkeypatch, name, spp,
                                              depth, modern):
    opts = _opts(spp, depth, modern)
    ts, _ = tbuild(scene_dir, name, opts, device="cpu")
    img, rays, g, *_ = _captured(monkeypatch, lambda: _gradient(ts, opts))
    with monkeypatch.context() as m:
        m.setattr(twf, "_CheckpointedBlocks", PlainAutograd)
        img_p, rays_p, g_p, *_ = _gradient(ts, opts)
    assert torch.equal(img, img_p) and rays == rays_p
    for f in PARAM_FIELDS:
        a, b = getattr(g_p, f), getattr(g, f)
        scale = float(a.abs().max()) if a.numel() else 0.0
        err = (a - b).abs()
        assert bool((err <= 1e-6 + 1e-5 * scale).all()), (
            f"{f}: max error {float(err.max())} against largest magnitude {scale}")
    assert float(g.kd.abs().max()) > 0


def _pair(scene_dir, **kw):
    base = {**BASE, "spp": 3, "max_depth": 8, "seed": 7, **kw}
    jopts = JOpts(intersector="cluster_interpret", compat=JMODERN, **base)
    topts = RenderOptions(compat=MODERN, **base)
    return (jbuild(scene_dir, "sg16", jopts)[0],
            tbuild(scene_dir, "sg16", topts, device="cpu")[0], jopts, topts)


def test_captured_scan_frame_matches_jax(scene_dir, monkeypatch):
    """render_image_stats with refill=False, two chunks, the stand-in
    graphs, against the JAX package's (interpret-mode Pallas), MODERN:
    tests/test_torch_scan.py's tolerance (at most 0.5% of pixels outside
    rtol 1e-4 / atol 1e-5, means within 1e-4 relative, rays within
    0.5%)."""
    js, ts, jopts, topts = _pair(scene_dir)
    ji, jr = jwf.render_image_stats(js, None, jopts)
    ti, tr = _captured(monkeypatch, lambda: twf.render_image_stats(
        ts, None, topts, device="cpu"))
    ji, ti = np.asarray(ji), ti.numpy()
    assert ti.shape == ji.shape == (16, 16, 3)
    assert np.isfinite(ti).all() and ti.mean() > 0
    outside = np.abs(ji - ti) > 1e-5 + 1e-4 * np.abs(ji)
    assert outside.any(axis=-1).mean() <= 0.005
    assert abs(ti.mean() - ji.mean()) <= 1e-4 * abs(ji.mean())
    assert abs(int(tr) - float(jr)) <= 0.005 * float(jr)


def test_captured_scan_gradient_matches_jax(scene_dir, monkeypatch):
    """loss_and_grad with refill=False, two chunks, the stand-in graphs,
    against the JAX package's jitted loss_and_grad (interpret-mode
    Pallas), MODERN, perturbed parameters: tests/test_torch_diff.py's
    tolerance, atol 1e-6 + 1e-4 x the field's largest magnitude."""
    js, ts, jopts, topts = _pair(scene_dir, spp=2)
    r = np.random.default_rng(0)
    fields = {f: (np.asarray(getattr(js, f)) * (1 + 0.2 * r.uniform(
        -1, 1, np.asarray(getattr(js, f)).shape))).astype(np.float32)
        for f in PARAM_FIELDS}
    jp = jgrad.SceneParams(**{f: jnp.asarray(v) for f, v in fields.items()})
    tp = scene_params_from_numpy(fields, "cpu")
    target = np.random.default_rng(1).uniform(0.1, 0.6, (16, 16, 3)).astype(
        np.float32)
    jl, jg = jgrad.loss_and_grad(jp, js, None, jopts, jnp.asarray(target))
    twf.reset_loop_stats()
    tl, tg = _captured(monkeypatch, lambda: tgrad.loss_and_grad(
        tp, ts, None, topts, torch.as_tensor(target), device="cpu"))
    st = twf.scan_stats()
    assert st["frames"] == 1 and st["calls"] == 2
    assert st["fwd_replays"] > 0 and st["bwd_replays"] > 0
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
    assert float(np.abs(np.asarray(jg.ns)).max()) > 0
    for f in PARAM_FIELDS:
        a, b = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
        scale = float(np.abs(a).max()) if a.size else 0.0
        err = np.abs(a - b)
        assert a.shape == b.shape and (err <= 1e-6 + 1e-4 * scale).all(), (
            f"{f}: max error {err.max()} against largest magnitude {scale}")


def _held_bytes(obj, seen=None) -> int:
    """Bytes of the tensors a scan call or frame holds: its attributes,
    through dicts, lists, tuples and _Residuals (each tensor once)."""
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return 0
    seen.add(id(obj))
    if isinstance(obj, torch.Tensor):
        return obj.nbytes
    if isinstance(obj, dict):
        return sum(_held_bytes(v, seen) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_held_bytes(v, seen) for v in obj)
    if isinstance(obj, (twf._Residuals, twf._ScanCall, twf._ScanFrame)):
        return _held_bytes(vars(obj), seen)
    return 0


def test_tracked_scan_call_holds_no_residuals(scene_dir, monkeypatch):
    """Between the passes a tracked call keeps only which samples to redo
    (the pixel ids, the sample offset, spp), and the call and its frame
    hold the same bytes at spp 1, 3 and 5: nothing per sample."""
    calls = []
    init = twf._ScanCall.__init__

    def tracked(self, *a, **kw):
        init(self, *a, **kw)
        calls.append(self)

    monkeypatch.setattr(twf._ScanCall, "__init__", tracked)
    held = []
    for spp in (1, 3, 5):
        opts = _opts(spp, 32, False)
        ts, _ = tbuild(scene_dir, "sg16", opts, device="cpu")
        leaves = SceneParams.from_scene(ts).leaves("cpu")
        calls.clear()
        img, _ = _captured(monkeypatch, lambda: twf.render_image_stats(
            tgrad.apply_params(ts, leaves), None, opts, differentiable=True,
            device="cpu"))
        assert len(calls) == 2  # two chunks
        for call in calls:
            assert set(vars(call)) == {"frame", "pix", "offset", "spp"}
            assert call.spp == spp
        held.append(_held_bytes(calls))
        g = _captured(monkeypatch, lambda: tgrad.param_grads(img.mean(), leaves))
        assert float(g.kd.abs().max()) > 0
    assert held[0] == held[1] == held[2] > 0


@pytest.mark.parametrize("depth", [6, 32])
def test_backward_holds_one_sample_of_residuals(scene_dir, monkeypatch, depth):
    """scan_stats()["residual_bytes"], the most bytes of residual copies
    held at once in backward, is one sample's at spp 1, 3 and 5 over two
    chunks of 128 lanes: ``max_depth`` bounces of the intersect results of
    [bounce rays; one shadow ray per light] (hit, t, tri: 9 bytes a ray)
    and the sort order with its inverse (16 bytes a lane)."""
    r = 128
    for spp in (1, 3, 5):
        opts = _opts(spp, depth, True)
        ts, _ = tbuild(scene_dir, "tex", opts, device="cpu")
        *_, st = _captured(monkeypatch, lambda: _gradient(ts, opts))
        assert st["calls"] == 2 and st["samples"] == 2 * spp
        assert st["residual_bytes"] == depth * r * (
            (1 + ts.num_lights) * 9 + 16), (spp, st["residual_bytes"])
