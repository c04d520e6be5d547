"""Port parity: the differentiable renderer and the gradient API.

The port's gradients (autograd through ``render_pixels_refill`` /
``render_pixels`` with ``differentiable=True``, blocks checkpointed, the
intersect results and sort orders replayed in the recompute) against the
JAX package's (``jax.grad`` with its Pallas kernels in interpret mode), on
identical scenes and identical parameters (``scene_params_from_numpy``),
MODERN mode, field by field over SceneParams.

Tolerance: every element within atol 1e-6 + rtol 1e-4 of the field's
largest magnitude.  Measured on these cases, the largest error over the
largest magnitude: 1.9e-7 (kd, the 16 x 16 spec+glass box), 1.3e-6 (the
atlas of the checker box), 1.6e-6 (pixel_gradient), 6.4e-7 (20 x 12),
4.6e-6 (4 x 4); on the interior the kd gradient is 7e-4 at most and the
atol holds it.

Then the checks of tests/test_gradients.py on the port alone: finite
differences, the channelwise red wall, an SGD step that lowers the loss,
and the static budget's truncation signal.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopathtracing_tpu.config import MODERN as JMODERN
from montecarlopathtracing_tpu.config import RenderOptions as JOpts
from montecarlopathtracing_tpu.diff import gradients as jgrad
from montecarlopathtracing_tpu.scene.builtin import box_scene_text, write_box_scene
from montecarlopathtracing_tpu.scene.builtin import load_builtin_large as jlarge
from montecarlopathtracing_tpu.scene.loader import build_scene as jbuild
from montecarlopathtracing_torch.config import MODERN, RenderOptions
from montecarlopathtracing_torch.diff import gradients as tgrad
from montecarlopathtracing_torch.diff.gradients import SceneParams
from montecarlopathtracing_torch.integrator import wavefront as twf
from montecarlopathtracing_torch.kernels import cluster as tcl
from montecarlopathtracing_torch.scene.builtin import load_builtin_large as tlarge
from montecarlopathtracing_torch.scene.loader import build_scene as tbuild
from montecarlopathtracing_torch.scene.types import scene_params_from_numpy

torch.set_num_threads(2)

BASE = dict(spp=4, max_depth=8, cluster_width=4, cluster_rays=16,
            sort_rays=True, chunk_size=256)
FIELDS = tgrad.PARAM_FIELDS


def _write(d, name, obj, mtl, cam):
    for ext, text in ((".obj", obj), (".mtl", mtl), (".camera", cam)):
        with open(os.path.join(d, name + ext), "w") as fh:
            fh.write(text)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_diff"))
    _write(d, "sg16", *box_scene_text(with_specular=True, with_glass=True,
                                      width=16, height=16))
    # Frames with repeated pixel ids: the specular box.
    for name, (w, h) in (("s20x12", (20, 12)), ("s4", (4, 4))):
        _write(d, name, *box_scene_text(with_specular=True, width=w, height=h))
    return d


def _pair(scene_dir, name, **kw):
    """(JAX scene, port scene, JAX options, port options)."""
    base = {**BASE, **kw}
    jopts = JOpts(intersector="cluster_interpret", compat=JMODERN, **base)
    topts = RenderOptions(compat=MODERN, **base)
    return (jbuild(scene_dir, name, jopts)[0],
            tbuild(scene_dir, name, topts, device="cpu")[0], jopts, topts)


def _params_pair(js, perturb=0.0, seed=0):
    """The JAX scene's parameters (scaled by 1 + perturb * noise) in both
    packages, with identical values."""
    rng = np.random.default_rng(seed)
    fields = {}
    for f in FIELDS:
        a = np.asarray(getattr(js, f))
        fields[f] = (a * (1 + perturb * rng.uniform(-1, 1, a.shape))).astype(a.dtype)
    jp = jgrad.SceneParams(**{f: jnp.asarray(v) for f, v in fields.items()})
    return jp, scene_params_from_numpy(fields, "cpu")


def _assert_grads_close(jg, tg, fields=FIELDS):
    for f in fields:
        a, b = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
        assert a.shape == b.shape and np.isfinite(b).all(), f
        scale = float(np.abs(a).max()) if a.size else 0.0
        err = np.abs(a - b)
        assert (err <= 1e-6 + 1e-4 * scale).all(), (
            f"{f}: max error {err.max()} against largest magnitude {scale}")


def _target(shape, seed=1):
    return np.random.default_rng(seed).uniform(0.1, 0.6, shape).astype(np.float32)


# -- the permute Function ----------------------------------------------------

def test_permuted_take_gradcheck():
    g = torch.Generator().manual_seed(0)
    perm = torch.randperm(37, generator=g)
    mat = torch.randn(37, 5, dtype=torch.float64, generator=g, requires_grad=True)
    assert torch.autograd.gradcheck(
        lambda m: twf._PermutedTake.apply(m, perm, None), (mat,))
    inv = twf.inverse_permutation(perm)
    assert torch.autograd.gradcheck(
        lambda m: twf._PermutedTake.apply(m, perm, inv), (mat,))


def test_permuted_take_backward_is_inverse_gather():
    g = torch.Generator().manual_seed(1)
    perm = torch.randperm(64, generator=g)
    inv = twf.inverse_permutation(perm)
    assert torch.equal(inv, torch.argsort(perm))
    mat = torch.randn(64, 7, generator=g, requires_grad=True)
    ct = torch.randn(64, 7, generator=g)
    out = twf._PermutedTake.apply(mat, perm, None)
    assert torch.equal(out, mat[perm])
    (grad,) = torch.autograd.grad(out, mat, ct)
    assert torch.equal(grad, ct.index_select(0, inv))


def test_permute_rows_keeps_the_graph():
    """With an f32 field that needs a gradient, _permute_rows gives the same
    values as the one-payload bit-view path, and the gradient arrives."""
    g = torch.Generator().manual_seed(2)
    perm = torch.randperm(50, generator=g)
    a = torch.randn(50, 3, generator=g, requires_grad=True)
    b = torch.randn(50, generator=g)
    ints = (torch.randint(0, 9, (50,), generator=g, dtype=torch.int32),
            torch.randint(0, 1 << 40, (50, 2), generator=g),
            torch.rand(50, generator=g) > 0.5)
    (pa, pb), pi = twf._permute_rows(perm, (a, b[:, None]), ints)
    with torch.no_grad():
        (qa, qb), qi = twf._permute_rows(perm, (a, b[:, None]), ints)
    assert torch.equal(pa, qa) and torch.equal(pb, qb)
    assert all(torch.equal(x, y) and x.dtype == y.dtype for x, y in zip(pi, qi))
    assert torch.equal(pa, a[perm]) and pa.requires_grad
    (grad,) = torch.autograd.grad(pa.sum() * 2, a)
    assert torch.equal(grad, torch.full_like(a, 2.0))


# -- the differentiable forward pass -----------------------------------------

@pytest.mark.parametrize("refill", [True, False], ids=["refill", "scan"])
def test_differentiable_forward_is_bitwise_equal(scene_dir, refill):
    """The differentiable render, gradients recorded, is bit for bit the
    forward render: the same film and the same ray count."""
    _, ts, _, topts = _pair(scene_dir, "sg16", refill=refill)
    img, rays = twf.render_image_stats(ts, None, topts, device="cpu")
    leaves = SceneParams.from_scene(ts).leaves("cpu")
    dimg, drays = twf.render_image_stats(tgrad.apply_params(ts, leaves), None,
                                         topts, differentiable=True, device="cpu")
    assert dimg.requires_grad
    assert torch.equal(img, dimg.detach()) and int(rays) == int(drays) > 0


def test_bwd_seg_budget(box_scene_dir):
    """bwd_seg_per_sample sets the static budget: a sufficient one gives the
    default budget's film exactly and a positive ray count; a starved one
    flags itself by a negative ray count (tests/test_gradients.py)."""
    opts = RenderOptions(spp=2, max_depth=4, chunk_size=256)
    ts, _ = tbuild(box_scene_dir, "box", opts, device="cpu")
    img0, nr0 = twf.render_image_stats(ts, None, opts, differentiable=True,
                                       device="cpu")
    assert int(nr0) > 0
    img1, nr1 = twf.render_image_stats(
        ts, None, opts.replace(bwd_seg_per_sample=2.6), differentiable=True,
        device="cpu")
    assert int(nr1) == int(nr0)
    assert torch.equal(img0, img1)
    _, nr2 = twf.render_image_stats(
        ts, None, opts.replace(bwd_seg_per_sample=0.01, max_depth=1),
        differentiable=True, device="cpu")
    assert int(nr2) < 0  # a truncated budget is flagged, not silent


# -- gradients against the JAX package ---------------------------------------

@pytest.mark.parametrize("refill", [True, False], ids=["refill", "scan"])
def test_image_loss_grad_matches_jax(scene_dir, refill):
    """image_loss gradients over every field, the Phong exponents through
    the score-function surrogate (ns_gradient=True), at perturbed
    parameters."""
    js, ts, jopts, topts = _pair(scene_dir, "sg16", refill=refill,
                                 ns_gradient=True)
    jp, tp = _params_pair(js, perturb=0.2)
    target = _target((16, 16, 3))
    jl, jg = jgrad.loss_and_grad(jp, js, None, jopts, jnp.asarray(target))
    tl, tg = tgrad.loss_and_grad(tp, ts, None, topts, torch.as_tensor(target),
                                 device="cpu")
    assert abs(float(tl) - float(jl)) <= 1e-4 * abs(float(jl))
    assert float(np.abs(np.asarray(jg.ns)).max()) > 0
    _assert_grads_close(jg, tg)


@pytest.mark.parametrize("scene", ["textured_box", "interior"])
def test_textured_grad_matches_jax(tmp_path, scene):
    """Textured scenes: the built-in box with its checker-textured back wall
    (the atlas's gradient), and the 2k-triangle interior (96 materials, so
    the JAX package takes its material rows by gather rather than one-hot
    matmul; its textured floor gets no direct light in this view, and its
    atlas gradient is zero in both packages)."""
    base = dict(spp=2, max_depth=4, cluster_width=32 if scene == "interior" else 4,
                cluster_rays=16, sort_rays=True, chunk_size=256)
    jopts = JOpts(intersector="cluster_interpret", compat=JMODERN, **base)
    topts = RenderOptions(compat=MODERN, **base)
    if scene == "interior":
        js, _ = jlarge(n_tris=2000, options=jopts, width=16, height=16,
                       n_textures=1)
        ts, _ = tlarge(n_tris=2000, options=topts, width=16, height=16,
                       n_textures=1, device="cpu")
    else:
        write_box_scene(str(tmp_path), "tex", with_texture=True, width=16,
                        height=16)
        js, _ = jbuild(str(tmp_path), "tex", jopts)
        ts, _ = tbuild(str(tmp_path), "tex", topts, device="cpu")
    jp, tp = _params_pair(js)
    target = _target((16, 16, 3))
    _, jg = jgrad.loss_and_grad(jp, js, None, jopts, jnp.asarray(target))
    _, tg = tgrad.loss_and_grad(tp, ts, None, topts, torch.as_tensor(target),
                                device="cpu")
    assert tg.atlas.shape[0] > 0
    if scene == "interior":
        assert int((tg.kd.abs().amax(dim=1) > 0).sum()) >= 3
    else:
        assert float(tg.atlas.abs().max()) > 0
    _assert_grads_close(jg, tg)


def test_pixel_gradient_matches_jax(scene_dir):
    js, ts, jopts, topts = _pair(scene_dir, "sg16")
    ids = np.arange(40, 200, dtype=np.int32)
    select = _target((ids.shape[0], 3), seed=3)
    jg = jgrad.pixel_gradient(js, None, jopts, jnp.asarray(ids),
                              select=jnp.asarray(select))
    tg = tgrad.pixel_gradient(ts, None, topts, torch.as_tensor(ids),
                              select=torch.as_tensor(select), device="cpu")
    _assert_grads_close(jg, tg)


@pytest.mark.parametrize("refill", [True, False], ids=["refill", "scan"])
@pytest.mark.parametrize("name,shape,seed", [("s20x12", (12, 20, 3), 0),
                                             ("s4", (4, 4, 3), 1)],
                         ids=["20x12", "4x4"])
def test_grad_with_repeated_pixel_ids_matches_jax(scene_dir, name, shape, seed,
                                                  refill):
    """Frames that are not a multiple of the 8 x 8 tile (cluster_rays 64):
    edge tiles repeat pixel ids (a 4 x 4 frame pads to 64 slots, 49 of them
    pixel 15).  Each pixel's gradient must be counted once.  The 4 x 4
    frame renders seed 1: at seed 0 one of its 16 pixels (6.39, ten times
    its neighbours) holds a light sample a hair from its hit point, whose
    inverse-square term the two frameworks round 5e-5 apart, and that one
    pixel sets its kd gradient's error at 9.8e-5 of the largest."""
    js, ts, jopts, topts = _pair(scene_dir, name, cluster_rays=64, refill=refill,
                                 seed=seed)
    ids = twf._tile_swizzled_ids(shape[0], shape[1], 64)
    assert ids.shape[0] > shape[0] * shape[1]  # ids repeat
    jp, tp = _params_pair(js)
    target = _target(shape)
    _, jg = jgrad.loss_and_grad(jp, js, None, jopts, jnp.asarray(target))
    _, tg = tgrad.loss_and_grad(tp, ts, None, topts, torch.as_tensor(target),
                                device="cpu")
    _assert_grads_close(jg, tg)


# -- the checks of tests/test_gradients.py, on the port -----------------------

OPTS = RenderOptions(spp=4, max_depth=4, chunk_size=256)


@pytest.fixture(scope="module")
def box(box_scene_dir):
    scene, meta = tbuild(box_scene_dir, "box", OPTS, device="cpu")
    return scene, meta


def _image_sum(scene, params):
    return torch.sum(tgrad.render_with_params(params, scene, None, OPTS,
                                              device="cpu"))


def _fd_check(scene, get, bump, eps, rtol):
    """Central finite difference on one coordinate against autodiff."""
    params = SceneParams.from_scene(scene)
    leaves = params.leaves("cpu")
    g = tgrad.param_grads(_image_sum(scene, leaves), leaves)
    gval = float(get(g))
    with torch.no_grad():
        fd = (float(_image_sum(scene, bump(params, eps)))
              - float(_image_sum(scene, bump(params, -eps)))) / (2 * eps)
    assert np.isclose(gval, fd, rtol=rtol, atol=1e-3), (gval, fd)
    return gval


def _bump(field, index):
    def bump(p, e):
        t = getattr(p, field).clone()
        t[index] += e
        return dataclasses.replace(p, **{field: t})
    return bump


def test_kd_gradient_matches_fd(box):
    scene, meta = box
    mi = meta.material_names.index("White")
    gval = _fd_check(scene, lambda g: g.kd[mi, 0], _bump("kd", (mi, 0)),
                     eps=1e-3, rtol=2e-2)
    assert gval > 0  # brighter walls, brighter image


def test_light_radiance_gradient_matches_fd(box):
    scene, _ = box
    gval = _fd_check(scene, lambda g: g.light_radiance[0, 1],
                     _bump("light_radiance", (0, 1)), eps=1e-2, rtol=5e-3)
    assert gval > 0


def test_red_wall_gradient_is_channelwise(box):
    """The red wall's green kd reaches only green radiance."""
    scene, meta = box
    mi = meta.material_names.index("Red")
    leaves = SceneParams.from_scene(scene).leaves("cpu")
    img = tgrad.render_with_params(leaves, scene, None, OPTS, device="cpu")
    g = tgrad.param_grads(torch.sum(img[..., 0]), leaves)
    assert float(g.kd[:, 1].abs().max()) == 0.0
    assert float(g.kd[mi, 0]) > 0.0


def test_pixel_gradient_api(box):
    scene, _ = box
    g = tgrad.pixel_gradient(scene, None, OPTS, torch.arange(64, dtype=torch.int32),
                             device="cpu")
    assert all(bool(torch.isfinite(getattr(g, f)).all()) for f in FIELDS)
    assert float(g.kd.abs().max()) > 0


def test_inverse_rendering_step_reduces_loss(box):
    """One SGD step toward a darker target lowers the loss; the loss
    train_step returns is the loss before the step."""
    scene, _ = box
    params = SceneParams.from_scene(scene)
    with torch.no_grad():
        target = tgrad.render_with_params(params, scene, None, OPTS,
                                          device="cpu") * 0.5
        loss0 = float(tgrad.image_loss(params, scene, None, OPTS, target,
                                       device="cpu"))
    p1, l1 = tgrad.train_step(params, scene, None, OPTS, target, lr=0.05,
                              device="cpu")
    assert np.isclose(float(l1), loss0, rtol=1e-5)
    assert not any(getattr(p1, f).requires_grad for f in FIELDS)
    with torch.no_grad():
        loss1 = float(tgrad.image_loss(p1, scene, None, OPTS, target,
                                       device="cpu"))
    assert loss1 < loss0


def test_backward_launches_no_intersect(box, monkeypatch):
    """The forward pass intersects; backward replays the recorded results
    and calls neither the key nor the intersect kernel's plain version."""
    calls = {"keys": 0, "isect": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(tcl, "cluster_keys_plain",
                        counting("keys", tcl.cluster_keys_plain))
    monkeypatch.setattr(tcl, "cluster_intersect_padded_plain",
                        counting("isect", tcl.cluster_intersect_padded_plain))
    scene, _ = box
    for refill in (True, False):
        opts = OPTS.replace(refill=refill, max_depth=6)
        leaves = SceneParams.from_scene(scene).leaves("cpu")
        img = tgrad.render_with_params(leaves, scene, None, opts, device="cpu")
        fwd = dict(calls)
        assert fwd["keys"] > 0 and fwd["isect"] > 0
        g = tgrad.param_grads(img.mean(), leaves)
        assert calls == fwd, (refill, fwd, calls)
        assert float(g.kd.abs().max()) > 0


def test_scene_params_from_numpy_keeps_values(box):
    scene, _ = box
    fields = {f: getattr(scene, f).numpy() for f in FIELDS}
    p = scene_params_from_numpy(fields, "cpu")
    for f in FIELDS:
        t = getattr(p, f)
        assert t.dtype == getattr(scene, f).dtype and torch.equal(t, getattr(scene, f))


def test_entry_points_need_cuda_unless_cpu(box):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    scene, _ = box
    params = SceneParams.from_scene(scene)
    target = torch.zeros((32, 32, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        twf.render_image_stats(scene, None, OPTS, differentiable=True)
    for call in (lambda: tgrad.render_with_params(params, scene, None, OPTS),
                 lambda: tgrad.image_loss(params, scene, None, OPTS, target),
                 lambda: tgrad.loss_and_grad(params, scene, None, OPTS, target),
                 lambda: tgrad.train_step(params, scene, None, OPTS, target),
                 lambda: tgrad.pixel_gradient(scene, None, OPTS,
                                              torch.arange(4))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
