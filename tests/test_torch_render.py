"""Port parity: whole renders of the forward main path.

The PyTorch port's render_image_stats (lane-pool refill renderer, cluster
intersector through its plain versions on the CPU) against the JAX
package's (Pallas kernels in interpret mode), on identical scenes built by
each package's own loader, with sort_rays=True on both sides.

Tolerance, MODERN mode: rtol 1e-4 / atol 1e-5 per value, as in
tests/test_refill.py; at most 0.5% of pixels may fall outside it (a path
whose f32 arithmetic rounds differently in the two frameworks can diverge at
a triangle edge or a sampling branch), and the image mean must agree within
1e-4 relative.  Compat mode shoots every sample through the pixel's lattice
corner, and those rays hit triangle edges exactly, where the hit depends on
FP contraction; so compat is compared per colour channel mean
(1% relative) and on the share of pixels within tolerance (>= 95%).
"""

import os

import numpy as np
import pytest
import torch

from montecarlopathtracing_tpu.config import MODERN as JMODERN
from montecarlopathtracing_tpu.config import RenderOptions as JOpts
from montecarlopathtracing_tpu.integrator.wavefront import render_image_stats as jstats
from montecarlopathtracing_tpu.scene.builtin import box_scene_text
from montecarlopathtracing_tpu.scene.loader import build_scene as jbuild
from montecarlopathtracing_torch import api
from montecarlopathtracing_torch.config import MODERN, RenderOptions
from montecarlopathtracing_torch.film.film import Film
from montecarlopathtracing_torch.integrator import wavefront as twf
from montecarlopathtracing_torch.scene.loader import build_scene as tbuild

torch.set_num_threads(2)

BASE = dict(spp=4, max_depth=8, cluster_width=4, cluster_rays=16, sort_rays=True)


def _write(d, name, obj, mtl, cam):
    for ext, text in ((".obj", obj), (".mtl", mtl), (".camera", cam)):
        with open(os.path.join(d, name + ext), "w") as fh:
            fh.write(text)


def _two_light_box():
    """The built-in box with a second, smaller and dimmer area light of its
    own material on the left wall (no in-repo scene has two lights)."""
    obj, mtl, cam = box_scene_text(with_specular=True, width=16, height=16)
    n_v = obj.count("\nv ") + obj.startswith("v ")
    mtl += "newmtl Light2\nKd 0 0 0\nKs 0 0 0\nNs 1\nNi 1\n"
    obj += ("v 0.02 0.6 0.6\nv 0.02 0.6 1.1\nv 0.02 1.1 1.1\nv 0.02 1.1 0.6\n"
            f"usemtl Light2\nf {n_v + 1} {n_v + 2} {n_v + 3}\n"
            f"f {n_v + 1} {n_v + 3} {n_v + 4}\n")
    cam += "mtlname Light2 8 6 4\n"
    return obj, mtl, cam


SCENES = {
    "one_light": lambda: box_scene_text(width=16, height=16),
    "two_lights": _two_light_box,
    "spec_glass": lambda: box_scene_text(with_specular=True, with_glass=True,
                                         width=16, height=16),
}


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_render"))
    for name, make in SCENES.items():
        _write(d, name, *make())
    return d


@pytest.fixture(scope="module")
def renders(scene_dir):
    """JAX (interpret-mode kernels) and port renders, shared by the tests."""
    out = {}
    for name, modern in (("one_light", True), ("two_lights", True),
                         ("spec_glass", True), ("spec_glass", False)):
        jopts = JOpts(intersector="cluster_interpret", **BASE,
                      **({"compat": JMODERN} if modern else {}))
        topts = RenderOptions(**BASE, **({"compat": MODERN} if modern else {}))
        js, _ = jbuild(scene_dir, name, jopts)
        ts, _ = tbuild(scene_dir, name, topts, device="cpu")
        ji, jr = jstats(js, None, jopts)
        ti, tr = twf.render_image_stats(ts, None, topts, device="cpu")
        out[(name, modern)] = (np.asarray(ji), float(jr), ti.numpy(), int(tr), ts)
    return out


def _outside(a, b):
    return np.abs(a - b) > 1e-5 + 1e-4 * np.abs(a)


@pytest.mark.parametrize("name", ["one_light", "two_lights", "spec_glass"])
def test_modern_render_matches_jax(renders, name):
    ji, jr, ti, tr, scene = renders[(name, True)]
    assert scene.num_lights == (2 if name == "two_lights" else 1)
    assert ti.shape == ji.shape == (16, 16, 3)
    assert np.isfinite(ti).all() and ti.mean() > 0
    frac = _outside(ji, ti).any(axis=2).mean()
    assert frac <= 0.005, f"{frac:.2%} of pixels outside rtol 1e-4 / atol 1e-5"
    assert abs(ti.mean() - ji.mean()) <= 1e-4 * abs(ji.mean())
    assert abs(tr - jr) <= 0.005 * jr  # rays traced (identical paths)


def test_compat_render_matches_jax_per_channel(renders):
    ji, jr, ti, tr, _ = renders[("spec_glass", False)]
    assert np.isfinite(ti).all()
    jm, tm = ji.reshape(-1, 3).mean(0), ti.reshape(-1, 3).mean(0)
    np.testing.assert_allclose(tm, jm, rtol=1e-2)
    assert _outside(ji, ti).any(axis=2).mean() <= 0.05
    assert abs(tr - jr) <= 0.01 * jr


def test_two_light_post_sort_nee_matches_unsorted(scene_dir):
    """>= 2 lights with sorting takes the post-sort NEE path; the estimator
    is the same as without sorting (pixels pinned to lanes, same streams)."""
    opts = RenderOptions(**BASE, compat=MODERN)
    ts, _ = tbuild(scene_dir, "two_lights", opts, device="cpu")
    a, ra = twf.render_image_stats(ts, None, opts, device="cpu")
    b, rb = twf.render_image_stats(ts, None, opts.replace(sort_rays=False),
                                   device="cpu")
    assert int(ra) == int(rb)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("compat,k,spp", [
    pytest.param(False, 8, 4, id="modern"),
    pytest.param(True, 8, 4, id="compat"),
    pytest.param(False, 24, 4, id="modern-k24"),
    pytest.param(True, 24, 4, id="compat-k24"),
    pytest.param(False, 40, 3, id="modern-k40-spp3"),
    pytest.param(True, 40, 3, id="compat-k40-spp3"),
])
def test_termination_check_interval_is_invisible(scene_dir, monkeypatch,
                                                compat, k, spp):
    """Reading the drain predicate every k iterations (the forward loop's
    block length) instead of every iteration leaves the film bitwise
    unchanged (extra iterations are no-ops), whether or not the flush
    cadence (n_pend * spp = 8 at spp 4, 6 at spp 3) divides k."""
    opts = RenderOptions(**{**BASE, "spp": spp},
                         **({} if compat else {"compat": MODERN}))
    ts, _ = tbuild(scene_dir, "spec_glass", opts, device="cpu")
    ids, fn = twf._frame_ids(ts, opts)
    out = {}
    for every in (1, k):
        monkeypatch.setattr(twf, "_CHECK_EVERY", every)
        out[every] = twf.render_pixels_refill(ts, None, opts, ids, lanes=96,
                                              pixel_fn=fn)
    assert torch.equal(out[1][0], out[k][0])
    assert int(out[1][1]) == int(out[k][1])


def test_host_chunked_matches_one_shot(scene_dir):
    opts = RenderOptions(**BASE, compat=MODERN)
    ts, _ = tbuild(scene_dir, "one_light", opts, device="cpu")
    one, r1 = twf.render_image_stats(ts, None, opts, device="cpu")
    chunked, r2 = twf.render_image_host_chunked(ts, None, opts.replace(spp_chunk=2),
                                                device="cpu")
    assert int(r1) == int(r2)
    np.testing.assert_allclose(one.numpy(), chunked.numpy(), rtol=1e-5, atol=1e-6)


def test_render_progressive_resume(scene_dir, tmp_path):
    opts = RenderOptions(**BASE, compat=MODERN, spp_chunk=2)
    ts, _ = tbuild(scene_dir, "one_light", opts, device="cpu")
    ck = str(tmp_path / "film.npz")
    half = api.render_progressive(ts, opts.replace(spp=2), checkpoint_path=ck,
                                  device="cpu")
    assert float(half.n_samples) == 2
    full = api.render_progressive(ts, opts, checkpoint_path=ck, device="cpu")
    assert float(full.n_samples) == 4
    once = api.render_progressive(ts, opts, device="cpu")
    np.testing.assert_allclose(full.mean.numpy(), once.mean.numpy(),
                               rtol=1e-5, atol=1e-6)
    # Resuming a finished film renders nothing more.
    again = api.render_progressive(ts, opts, film=full, device="cpu")
    assert torch.equal(again.radiance_sum, full.radiance_sum)
    assert isinstance(Film.zeros(2, 2).mean, torch.Tensor)


def test_unported_paths_raise(scene_dir):
    """Only the JAX package's Pallas interpreter mode has no counterpart
    and raises.  The LBVH walks and the distributed training step, which
    raised before they were ported, now resolve and run (their parity is in
    tests/test_torch_lbvh.py and tests/test_torch_parallel.py)."""
    opts = RenderOptions(**BASE)
    ts, _ = tbuild(scene_dir, "one_light", opts, device="cpu")
    for kind in ("bvh", "bvh_perray"):
        assert twf.resolve_plan(opts.replace(intersector=kind), 16) == (
            kind, None, None, 1)
        img, rays = twf.render_image_stats(ts, None, opts.replace(intersector=kind),
                                           device="cpu")
        assert img.shape == (16, 16, 3) and int(rays) > 0
    from montecarlopathtracing_torch.diff.gradients import (
        make_distributed_train_step)
    from montecarlopathtracing_torch.parallel.mesh import make_mesh
    assert callable(make_distributed_train_step(ts, None, opts, make_mesh(),
                                                device="cpu"))
    with pytest.raises(NotImplementedError):
        twf.resolve_plan(RenderOptions(intersector="cluster_interpret"), 16)
    assert twf.resolve_plan(RenderOptions(), 16)[0] == "cluster"
    assert twf._should_sort(RenderOptions(), 16)
