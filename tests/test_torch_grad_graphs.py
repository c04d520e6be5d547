"""The differentiable lane pool's blocks as one autograd node
(integrator/wavefront.py::_CheckpointedBlocks, _BlockScan).

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
  intersect launches of the forward pass, none in backward.
"""

import os

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
    def apply(scan, *inputs):
        env = scan.env(inputs)
        st = {k: v.clone() for k, v in scan.state.items()}
        film = scan.film
        for _ in range(scan.n_blocks):
            if scan.drained(st):
                break
            slots, vals = scan.block(st, env, scan.res)
            film = film.index_add(1, slots, vals)
        with torch.no_grad():  # the caller reads the drain and the rays here
            for k, v in scan.state.items():
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
    scans = []
    real = twf._BlockScan

    class Spy(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            scans.append(self)

    monkeypatch.setattr(twf, "_BlockScan", Spy)

    def render(scene):
        return twf.render_pixels_refill(scene, None, opts, ids, lanes=LANES,
                                        differentiable=True, pixel_fn=fn)

    img, rays = _captured(monkeypatch, lambda: render(ts))
    assert not img.requires_grad and not scans[0].res.bufs
    assert not scans[0].entries and not scans[0].saved
    leaves = SceneParams.from_scene(ts).leaves("cpu")
    img_g, rays_g = render(tgrad.apply_params(ts, leaves))
    assert img_g.requires_grad and scans[1].res.bufs
    assert len(scans[1].entries) == len(scans[1].saved) > 0
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
