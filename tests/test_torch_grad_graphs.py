"""The lane pool's gradient loop (integrator/wavefront.py::_GradPool) as
one autograd node (_CheckpointedBlocks over a _GradCall, _Backward).

On a CUDA device the gradient's forward blocks and its backward blocks
(recompute one block with its recorded residuals, then take its VJP) replay
CUDA graphs; on the CPU, and inside ``eager()``, the same block function
runs op by op.  These tests hold, on the CPU, with the stand-in graphs of
tests/test_torch_graph_blocks.py (a capture runs the block's Python once,
every later replay runs it again with the launch counters held still):

* the image and the gradient bit for bit those of the same render under
  ``eager()``, with the same ray count, at spp 1, 3 and 16, compat and
  MODERN, on the 16 x 16 spec+glass box and on the checker-textured box
  (the atlas's gradient), each render of four or more blocks (the reverse
  loop and the state cotangent's hand-off between blocks), with a forward
  and a backward graph captured and replayed;
* the gradient against plain autograd through every iteration (the same
  blocks recorded by autograd, nothing recomputed) at atol 1e-6 + 1e-5 x
  the field's largest magnitude: the per-block sums associate differently,
  so bit for bit is not expected;
* the gradient against the JAX package's jitted gradient (interpret-mode
  Pallas) at tests/test_torch_diff.py's tolerance;
* ``launch_counts()`` the same captured and under ``eager()``: the key and
  intersect launches of the forward pass, none in backward;
* the kept gradient pools (``wavefront._GRAD_POOLS``): four gradient steps
  on one scene, each with another seed and new parameter values, replaying
  the graphs the first step captured, bit for bit the steps run op by op;
  two forward passes before either backward; a new pool for a new key (a
  new backward graph for other fields); a pool that goes with its scene.
"""

import contextlib
import dataclasses
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
from montecarlopathtracing_tpu.scene.builtin import box_scene_text
from montecarlopathtracing_tpu.scene.loader import build_scene as jbuild
from montecarlopathtracing_torch.config import MODERN, RenderOptions
from montecarlopathtracing_torch.diff import gradients as tgrad
from montecarlopathtracing_torch.diff.gradients import PARAM_FIELDS, SceneParams
from montecarlopathtracing_torch.integrator import wavefront as twf
from montecarlopathtracing_torch.kernels import cluster as K
from montecarlopathtracing_torch.scene.builtin import write_box_scene
from montecarlopathtracing_torch.scene.loader import build_scene as tbuild
from montecarlopathtracing_torch.scene.types import scene_params_from_numpy
from montecarlopathtracing_torch.utils import timing
from test_torch_graph_blocks import FakeGraphs, counting  # noqa: F401 (fixture)

torch.set_num_threads(2)

BASE = dict(max_depth=6, cluster_width=4, cluster_rays=16, sort_rays=True,
            ns_gradient=True)
LANES = 96


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("grad_graphs"))
    obj, mtl, cam = box_scene_text(with_specular=True, with_glass=True,
                                   width=16, height=16)
    for ext, text in ((".obj", obj), (".mtl", mtl), (".camera", cam)):
        with open(os.path.join(d, "sg16" + ext), "w") as fh:
            fh.write(text)
    write_box_scene(d, "tex", with_texture=True, width=16, height=16)
    return d


def _opts(spp: int, modern: bool):
    return RenderOptions(spp=spp, **BASE, **({"compat": MODERN} if modern else {}))


def _weights(n: int):
    return torch.as_tensor(np.random.default_rng(4).uniform(
        0.5, 1.5, (n, 3)).astype(np.float32))


def _gradient(scene_dir, name: str, spp: int, modern: bool):
    """d sum(w * radiance) / d SceneParams through render_pixels_refill with
    96 lanes over the frame's swizzled ids: (radiance, rays, gradient,
    launches forward, launches backward, grad_loop_stats)."""
    opts = _opts(spp, modern)
    ts, _ = tbuild(scene_dir, name, opts, device="cpu")
    ids, fn = twf._frame_ids(ts, opts)
    leaves = SceneParams.from_scene(ts).leaves("cpu")
    K.reset_launch_counts()
    twf.reset_loop_stats()
    rad, rays = twf.render_pixels_refill(
        tgrad.apply_params(ts, leaves), None, opts, ids, lanes=LANES,
        differentiable=True, pixel_fn=fn)
    fwd = K.launch_counts()
    K.reset_launch_counts()
    g = tgrad.param_grads(torch.sum(rad * _weights(rad.shape[0])), leaves)
    return rad.detach(), int(rays), g, fwd, K.launch_counts(), twf.grad_loop_stats()


def _captured(monkeypatch, fn):
    """fn() on the card's path, with the stand-in graphs."""
    with monkeypatch.context() as m:
        m.setattr(twf, "_captures", lambda dev: True)
        m.setattr(twf, "_CudaGraphs", FakeGraphs)
        return fn()


CASES = [pytest.param(name, spp, modern, id=f"{name}-spp{spp}-"
                      + ("modern" if modern else "compat"))
         for name in ("sg16", "tex") for spp in (1, 3, 16)
         for modern in (False, True)]


@pytest.mark.parametrize("name,spp,modern", CASES)
def test_captured_gradient_is_bitwise_eager(scene_dir, counting, monkeypatch,
                                            name, spp, modern):
    with twf.eager():
        img_e, rays_e, g_e, fwd_e, bwd_e, st_e = _gradient(scene_dir, name,
                                                           spp, modern)
    img, rays, g, fwd, bwd, st = _captured(
        monkeypatch, lambda: _gradient(scene_dir, name, spp, modern))
    assert torch.equal(img, img_e) and rays == rays_e > 0
    for f in PARAM_FIELDS:
        assert torch.equal(getattr(g, f), getattr(g_e, f)), f
    assert float(g.kd.abs().max()) > 0
    if name == "tex":
        assert float(g.atlas.abs().max()) > 0
    assert fwd == fwd_e and fwd["cluster_intersect"] > 0
    assert bwd == bwd_e and not any(bwd.values())
    blocks = st["blocks"]
    assert blocks == st_e["blocks"] >= 4 and st["dispatches"] == 1
    assert (st_e["fwd_graphs"], st_e["bwd_graphs"]) == (0, 0)
    assert st_e["fwd_eager_blocks"] == st_e["bwd_eager_blocks"] == blocks
    for p in ("fwd", "bwd"):
        assert st[f"{p}_eager_blocks"] == st[f"{p}_graphs"] == 1
        assert st[f"{p}_replays"] == blocks - 1


class PlainAutograd:
    """Stand-in for _CheckpointedBlocks: the same blocks recorded by
    autograd through every iteration, the film added to out of place,
    nothing recomputed."""

    @staticmethod
    def apply(call, *inputs):
        pool = call.pool
        env = twf._grad_env(pool.scene, inputs)
        st = {k: v.clone() for k, v in pool.s.items()}
        film = pool.film
        for _ in range(pool.n_blocks):
            if pool.drained(st):
                break
            slots, vals = pool.block(st, env, pool.res)
            film = film.index_add(1, slots, vals)
        with torch.no_grad():  # the caller reads the drain and the rays here
            for k, v in pool.s.items():
                v.copy_(st[k])
        return film


@pytest.mark.parametrize("name,spp,modern", [("sg16", 3, True), ("tex", 16, False)])
def test_gradient_matches_plain_autograd(scene_dir, monkeypatch, name, spp,
                                         modern):
    img, rays, g, *_ = _captured(
        monkeypatch, lambda: _gradient(scene_dir, name, spp, modern))
    with monkeypatch.context() as m:
        m.setattr(twf, "_CheckpointedBlocks", PlainAutograd)
        img_p, rays_p, g_p, *_ = _gradient(scene_dir, name, spp, modern)
    assert torch.equal(img, img_p) and rays == rays_p
    for f in PARAM_FIELDS:
        a, b = getattr(g_p, f), getattr(g, f)
        scale = float(a.abs().max()) if a.numel() else 0.0
        err = (a - b).abs()
        assert bool((err <= 1e-6 + 1e-5 * scale).all()), (
            f"{f}: max error {float(err.max())} against largest magnitude {scale}")
    assert float(g.kd.abs().max()) > 0


def test_captured_gradient_matches_jax(scene_dir, monkeypatch):
    """image_loss's gradient with the stand-in graphs against the JAX
    package's loss_and_grad (jitted, interpret-mode Pallas), MODERN, spp 4,
    perturbed parameters: tests/test_torch_diff.py's tolerance, atol 1e-6 +
    1e-4 x the field's largest magnitude."""
    base = dict(spp=4, max_depth=8, cluster_width=4, cluster_rays=16,
                sort_rays=True, chunk_size=256, ns_gradient=True)
    jopts = JOpts(intersector="cluster_interpret", compat=JMODERN, **base)
    topts = RenderOptions(compat=MODERN, **base)
    js, _ = jbuild(scene_dir, "sg16", jopts)
    ts, _ = tbuild(scene_dir, "sg16", topts, device="cpu")
    rng = np.random.default_rng(0)
    fields = {f: (np.asarray(getattr(js, f)) * (1 + 0.2 * rng.uniform(
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
    st = twf.grad_loop_stats()
    assert st["fwd_graphs"] == st["bwd_graphs"] == 1 and st["bwd_replays"] > 0
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
    for f in PARAM_FIELDS:
        a, b = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
        scale = float(np.abs(a).max()) if a.size else 0.0
        err = np.abs(a - b)
        assert a.shape == b.shape and (err <= 1e-6 + 1e-4 * scale).all(), (
            f"{f}: max error {err.max()} against largest magnitude {scale}")


def test_without_grad_records_nothing(scene_dir, monkeypatch):
    """differentiable=True with no scene tensor needing a gradient (the
    finite-difference sums) runs the same forward blocks, captured, and
    keeps no entry state or residual: the image is the recorded render's."""
    opts = _opts(3, True)
    ts, _ = tbuild(scene_dir, "sg16", opts, device="cpu")
    ids, fn = twf._frame_ids(ts, opts)
    calls = []
    real = twf._GradCall

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            calls.append(self)

    monkeypatch.setattr(twf, "_GradCall", Spy)

    def render(scene):
        return twf.render_pixels_refill(scene, None, opts, ids, lanes=LANES,
                                        differentiable=True, pixel_fn=fn)

    img, rays = _captured(monkeypatch, lambda: render(ts))
    assert not img.requires_grad and not calls[0].pool.res.bufs
    assert not calls[0].entries and not calls[0].saved
    leaves = SceneParams.from_scene(ts).leaves("cpu")
    img_g, rays_g = render(tgrad.apply_params(ts, leaves))
    assert img_g.requires_grad and calls[1].pool.res.bufs
    assert len(calls[1].entries) == len(calls[1].saved) > 0
    assert torch.equal(img, img_g.detach()) and int(rays) == int(rays_g) > 0


@pytest.mark.parametrize("rows", [6, 64, 65, 150])
def test_table_rows_backward_sums_per_row(rows):
    """_TableRows' backward (the material rows' cotangent sums): every
    table row's sum against the float64 sum, for tables of up to 64 rows
    (one one-hot product) and past 64 (64 rows at a time, a fixed order of
    addition on the card too)."""
    g = np.random.default_rng(rows)
    idx = torch.as_tensor(g.integers(0, rows, 4096))
    ct = torch.as_tensor(g.normal(size=(4096, 3)).astype(np.float32))
    table = torch.zeros((rows, 3), requires_grad=True)
    (grad,) = torch.autograd.grad(twf._TableRows.apply(table, idx), table, ct)
    want = torch.zeros((rows, 3), dtype=torch.float64).index_add_(
        0, idx, ct.double())
    assert grad.shape == (rows, 3)
    assert torch.allclose(grad.double(), want, rtol=1e-5, atol=1e-4)


@pytest.fixture
def kept_grad_pools(monkeypatch):
    """The card's path on the CPU with the stand-in graphs, ``eager()``
    turning it off as on the card, and no gradient pool kept from another
    test."""
    monkeypatch.setattr(twf, "_captures", lambda dev: not twf._eager)
    monkeypatch.setattr(twf, "_CudaGraphs", FakeGraphs)
    twf._GRAD_POOLS.clear()
    twf.reset_loop_stats()
    yield
    twf._GRAD_POOLS.clear()


def _step_opts(spp: int = 3, **kw):
    return _opts(spp, True).replace(chunk_size=LANES, **kw)


def _target(scene):
    h, w = scene.camera.height, scene.camera.width
    return torch.as_tensor(np.random.default_rng(7).uniform(
        0.1, 0.6, (h, w, 3)).astype(np.float32))


def _images(monkeypatch):
    """The frames that loss_and_grad renders, in order (its own forward
    pass's image, recorded on the way)."""
    frames, real = [], tgrad.render_with_params

    def recorded(*a, **kw):
        img = real(*a, **kw)
        frames.append(img.detach().clone())
        return img

    monkeypatch.setattr(tgrad, "render_with_params", recorded)
    return frames


def _sgd_steps(scene, opts, seeds, frames):
    """loss_and_grad steps with an out-of-place SGD update between them:
    [(image, loss, gradient)] a step."""
    params, out = SceneParams.from_scene(scene), []
    target = _target(scene)
    for seed in seeds:
        loss, g = tgrad.loss_and_grad(params, scene, None,
                                      opts.replace(seed=seed), target,
                                      device="cpu")
        out.append((frames[-1], loss, g))
        params = params.map(lambda p, d: p.detach() - 0.05 * d, g)
    return out


@pytest.mark.parametrize("name", ["sg16", "tex"])
def test_steps_on_a_kept_pool_are_bitwise_eager(scene_dir, kept_grad_pools,
                                                monkeypatch, name):
    """Four gradient steps on one scene, each with another seed and new
    parameter values, replay the graphs the first step captured: every
    image, loss and field's gradient bit for bit the step run op by op.
    The stand-in replays run the block's Python again, so a seed or a
    parameter that a graph had frozen would show."""
    opts = _step_opts()
    scene, _ = tbuild(scene_dir, name, opts, device="cpu")
    frames = _images(monkeypatch)
    seeds = (11, 12, 13, 14)
    steps = _sgd_steps(scene, opts, seeds, frames)
    st = twf.grad_loop_stats()
    with twf.eager():
        eager = _sgd_steps(scene, opts, seeds, frames)
    assert not torch.equal(steps[0][0], steps[1][0])
    for (img, loss, g), (img_e, loss_e, g_e) in zip(steps, eager):
        assert torch.equal(img, img_e) and torch.equal(loss, loss_e)
        for f in PARAM_FIELDS:
            assert torch.equal(getattr(g, f), getattr(g_e, f)), f
        assert float(g.kd.abs().max()) > 0
        if name == "tex":
            assert float(g.atlas.abs().max()) > 0
    ((pool, *_),) = twf._GRAD_POOLS.entries.values()
    # The stand-in replays read the pool's attributes again; a card's graph
    # reads addresses, so the seed's word and the offset are device buffers.
    assert all(isinstance(t, torch.Tensor) and t.dim() == 0
               for t in (pool.word, pool.offset))
    assert st["dispatches"] == st["bwd_passes"] == 4
    assert st["fwd_graphs"] == st["bwd_graphs"] == 1
    assert st["fwd_eager_blocks"] == st["bwd_eager_blocks"] == 1
    assert st["fwd_pool_reuses"] == st["bwd_pool_reuses"] == 3
    assert st["fwd_replays"] == st["blocks"] - 1 > 4


def test_two_forwards_before_either_backward(scene_dir, kept_grad_pools):
    """Two differentiable renders on one kept pool, then their backward
    passes in reverse order: each pass copies its own call's inputs in, so
    both gradients are those of each render alone, run op by op."""
    opts = _step_opts()
    scene, _ = tbuild(scene_dir, "tex", opts, device="cpu")
    base = SceneParams.from_scene(scene)
    other = base.map(lambda p: p * 0.8)
    weights = _weights(scene.camera.height * scene.camera.width).reshape(
        scene.camera.height, scene.camera.width, 3)

    def forward(params, seed):
        leaves = params.leaves("cpu")
        img = tgrad.render_with_params(leaves, scene, None,
                                       opts.replace(seed=seed), device="cpu")
        return img, leaves

    def backward(img, leaves):
        return tgrad.param_grads(torch.sum(img * weights), leaves)

    a, b = forward(base, 21), forward(other, 22)
    g_b, g_a = backward(*b), backward(*a)
    st = twf.grad_loop_stats()
    with twf.eager():
        alone = [(img.detach(), backward(img, leaves)) for img, leaves
                 in (forward(base, 21), forward(other, 22))]
    for (img, _), g, (img_e, g_e) in zip((a, b), (g_a, g_b), alone):
        assert torch.equal(img.detach(), img_e)
        for f in PARAM_FIELDS:
            assert torch.equal(getattr(g, f), getattr(g_e, f)), f
    assert not torch.equal(g_a.kd, g_b.kd)
    assert len(twf._GRAD_POOLS.entries) == 1
    assert st["fwd_pool_reuses"] == st["bwd_pool_reuses"] == 1


# What a second gradient step changes after a first on the spec+glass box:
# nothing, the samples, the resolution, a geometry tensor in place (the
# stale pool is replaced, not kept beside), the fields that need a
# gradient (the same pool, a backward graph of its own).
GRAD_CHANGES = ("nothing", "spp", "resolution", "in_place", "needs")


@pytest.mark.parametrize("change", GRAD_CHANGES)
def test_a_changed_key_makes_a_new_grad_pool(scene_dir, kept_grad_pools,
                                             change):
    opts = _step_opts()
    scene, _ = tbuild(scene_dir, "sg16", opts, device="cpu")
    first = scene  # held: its pool stays
    params = SceneParams.from_scene(scene)

    def step(scene, opts, needs=PARAM_FIELDS):
        leaves = params.leaves("cpu")
        leaves = SceneParams(**{f: getattr(leaves, f).requires_grad_(f in needs)
                                for f in PARAM_FIELDS})
        img = tgrad.render_with_params(leaves, scene, None, opts, device="cpu")
        wrt = [getattr(leaves, f) for f in needs]
        return img.detach(), torch.autograd.grad(img.sum(), wrt)

    step(scene, opts.replace(seed=3))
    needs = PARAM_FIELDS
    if change == "spp":
        opts = opts.replace(spp=2)
    if change == "resolution":
        cam = dataclasses.replace(scene.camera, width=12, height=12)
        scene = dataclasses.replace(scene, camera=cam)
    if change == "in_place":
        with torch.no_grad():
            scene.v0.mul_(1.001)
    if change == "needs":
        needs = ("kd", "light_radiance")
    twf.reset_loop_stats()
    with timing.tracing() as tr:
        img, g = step(scene, opts.replace(seed=4), needs)
    st = twf.grad_loop_stats()
    with twf.eager():
        img_e, g_e = step(scene, opts.replace(seed=4), needs)
    assert torch.equal(img, img_e)
    assert all(torch.equal(a, b) for a, b in zip(g, g_e))
    (reused,) = [s["counts"]["reused"] for s in tr.spans
                 if s["name"] == "pool_setup"]
    kept = change in ("nothing", "needs")
    assert reused == int(kept) and st["fwd_pool_reuses"] == int(kept)
    assert st["fwd_eager_blocks"] == 1 - int(kept)
    assert st["bwd_pool_reuses"] == int(change == "nothing")
    assert st["bwd_graphs"] == 1 - int(change == "nothing")
    entries = 1 if kept or change == "in_place" else 2
    assert len(twf._GRAD_POOLS.entries) == entries
    del first


@pytest.mark.parametrize("inside_capture", [False, True],
                         ids=["outside_capture", "inside_capture"])
def test_a_dropped_scene_takes_its_grad_pool_along(scene_dir, kept_grad_pools,
                                                   inside_capture):
    """The kept gradient pool holds the scene by alias and its parameters
    by copy: when the caller drops the scene it goes, by reference counting
    alone (no cycle is left to the collector); inside a capture, when it
    ends.  The step's own parameter tensors dying between steps does not
    drop it."""
    opts = _step_opts()
    scene, _ = tbuild(scene_dir, "sg16", opts, device="cpu")
    target = _target(scene)
    for seed in (3, 4):
        tgrad.loss_and_grad(SceneParams.from_scene(scene), scene, None,
                            opts.replace(seed=seed), target, device="cpu")
    assert twf.grad_loop_stats()["fwd_pool_reuses"] == 1
    ((pool, *_),) = twf._GRAD_POOLS.entries.values()
    pool = weakref.ref(pool)
    v0 = weakref.ref(scene.v0)
    gc.disable()
    try:
        with twf._capture_guard() if inside_capture else contextlib.nullcontext():
            del scene
            assert v0() is None and not twf._GRAD_POOLS.entries
            assert (pool() is not None) == inside_capture
        assert pool() is None and not twf._doomed
    finally:
        gc.enable()
