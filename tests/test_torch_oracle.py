"""The port's f64 oracle (oracle/cpu_reference.py).

1. Against the JAX package's oracle on the same scene, options and pixel
   ids: the same NumPy f64 code on the same uniforms (the port's RNG is
   bitwise equal to the JAX package's), so the two agree bit for bit; held
   to 1e-12 relative.
2. The port's renders (cluster intersector, plain versions on the CPU)
   against the port's oracle, under tests/test_oracle.py's and
   tests/test_texture.py's thresholds: the identical uniform stream makes
   the f32 render match the f64 oracle to f32 arithmetic on almost every
   lane; the rest are grazing rays whose f32 hit or CDF decision flips.
"""

import numpy as np
import pytest
import torch

from montecarlopathtracing_tpu.config import MODERN as JMODERN
from montecarlopathtracing_tpu.config import RenderOptions as JOpts
from montecarlopathtracing_tpu.oracle.cpu_reference import oracle_render_pixels as joracle
from montecarlopathtracing_tpu.scene.builtin import load_builtin_box as jbox
from montecarlopathtracing_tpu.scene.loader import build_scene as jbuild
from montecarlopathtracing_torch.accel.lbvh import brute_force_intersect
from montecarlopathtracing_torch.config import MODERN, RenderOptions
from montecarlopathtracing_torch.integrator.camera import primary_rays
from montecarlopathtracing_torch.integrator.wavefront import render_pixels
from montecarlopathtracing_torch.ops.intersect import barycentric
from montecarlopathtracing_torch.oracle.cpu_reference import oracle_render_pixels
from montecarlopathtracing_torch.scene.builtin import load_builtin_box
from montecarlopathtracing_torch.scene.loader import build_scene

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def box(box_scene_dir):
    return build_scene(box_scene_dir, "box", RenderOptions(), device="cpu")[0]


def _compare(scene, opts, ids=None):
    n = scene.camera.width * scene.camera.height
    ids = np.arange(n, dtype=np.int32) if ids is None else ids
    got, _ = render_pixels(scene, None, opts, torch.as_tensor(ids))
    want = oracle_render_pixels(scene, opts, ids)
    got = got.numpy().astype(np.float64)
    return got, want, np.abs(got - want) / np.maximum(np.abs(want), 1e-2)


# --------------------------------------------------------------------------
# The two oracles.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["compat", "modern", "spec", "glass", "textured"])
def test_oracle_matches_jax_oracle(box_scene_dir, case):
    kw = dict(spp=2, max_depth=5, seed=3)
    ids = np.arange(0, 1024, 5, dtype=np.int32)
    if case in ("glass", "textured"):
        bk = (dict(with_glass=True, with_specular=True) if case == "glass"
              else dict(with_texture=True))
        js, _ = jbox(width=32, height=32, **bk)
        ts, _ = load_builtin_box(width=32, height=32, device="cpu", **bk)
    else:
        name = "boxspec" if case == "spec" else "box"
        js, _ = jbuild(box_scene_dir, name, JOpts())
        ts, _ = build_scene(box_scene_dir, name, RenderOptions(), device="cpu")
    jo = JOpts(compat=JMODERN, **kw) if case == "modern" else JOpts(**kw)
    to = RenderOptions(compat=MODERN, **kw) if case == "modern" else RenderOptions(**kw)
    want = joracle(js, jo, ids)
    got = oracle_render_pixels(ts, to, ids)
    assert got.dtype == np.float64 and got.shape == (len(ids), 3)
    assert want.mean() > 0
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


# --------------------------------------------------------------------------
# The port's renders against the port's oracle.
# --------------------------------------------------------------------------

def test_direct_lighting_matches_oracle(box):
    """On interior pixels, as test_compat_refill_matches_oracle: compat
    primaries go through lattice corners, some of them exactly on an edge,
    where the f32 hit decision (uncontracted here, the same with the cluster,
    walk and brute-force intersectors) can differ from the f64 one.  Over
    the whole frame 13 of 1,024 lanes fall outside 1e-3 here (98.7%); the
    JAX package's contracted f32 has 8 (99.2%): both sit at the 0.99 line,
    which holds on the interior pixels."""
    opts = RenderOptions(spp=4, max_depth=1, chunk_size=256, refill=False)
    ids = np.arange(box.camera.width * box.camera.height, dtype=np.int32)
    interior = _interior_pixel_mask(box, ids)
    assert interior.mean() > 0.5
    _, _, rel = _compare(box, opts, ids)
    rel = rel[interior]
    assert np.median(rel) < 1e-5, np.median(rel)
    assert (rel.max(axis=1) < 1e-3).mean() > 0.99


def test_full_path_matches_oracle(box):
    opts = RenderOptions(spp=4, max_depth=6, chunk_size=256, refill=False)
    _, _, rel = _compare(box, opts)
    assert np.median(rel) < 1e-4, np.median(rel)
    assert (rel.max(axis=1) < 1e-2).mean() > 0.98


def test_specular_scene_matches_oracle(box_scene_dir):
    scene, _ = build_scene(box_scene_dir, "boxspec", RenderOptions(), device="cpu")
    opts = RenderOptions(spp=4, max_depth=6, chunk_size=256, refill=False)
    _, _, rel = _compare(scene, opts)
    assert np.median(rel) < 1e-4, np.median(rel)
    assert (rel.max(axis=1) < 1e-2).mean() > 0.97


def test_glass_scene_matches_oracle():
    scene, _ = load_builtin_box(width=32, height=32, with_glass=True,
                                with_specular=True, device="cpu")
    opts = RenderOptions(spp=4, max_depth=5, chunk_size=256, refill=False)
    ids = np.arange(256, dtype=np.int32) + 512  # a strip crossing the panel
    got, _ = render_pixels(scene, None, opts, torch.as_tensor(ids))
    want = oracle_render_pixels(scene, opts, ids)
    rel = np.abs(got.numpy().astype(np.float64) - want) / (np.abs(want) + 1e-4)
    assert np.median(rel) < 1e-4
    assert (rel.max(axis=1) < 1e-2).mean() > 0.95


def test_modern_mode_matches_oracle(box):
    opts = RenderOptions(spp=4, max_depth=6, chunk_size=256, refill=False,
                         compat=MODERN)
    _, _, rel = _compare(box, opts)
    assert np.median(rel) < 1e-4, np.median(rel)
    assert (rel.max(axis=1) < 1e-2).mean() > 0.98


def _interior_pixel_mask(scene, ids, margin=1e-3):
    """Pixels whose compat lattice-corner primary hits a triangle interior
    (all barycentric coordinates > margin): edge-exact primaries classify by
    FP contraction and are left out, as in tests/test_oracle.py."""
    o, d = primary_rays(scene.camera, torch.as_tensor(ids))
    hit, t, tri = brute_force_intersect(scene, o, d)
    p = o + d * torch.where(hit, t, 0.0)[:, None]
    tc = torch.clamp(tri, min=0).long()
    bary = barycentric(p, scene.v0[tc], scene.v1[tc], scene.v2[tc])
    return (hit & (torch.amin(bary, dim=1) > margin)).numpy()


def test_compat_refill_matches_oracle(box):
    """The default path (compat + refill) on interior pixels."""
    opts = RenderOptions(spp=4, max_depth=6, chunk_size=256, refill=True)
    ids = np.arange(box.camera.width * box.camera.height, dtype=np.int32)
    interior = _interior_pixel_mask(box, ids)
    assert interior.mean() > 0.5
    _, _, rel = _compare(box, opts, ids)
    rel = rel[interior]
    assert np.median(rel) < 1e-4, np.median(rel)
    assert (rel.max(axis=1) < 1e-2).mean() > 0.98


def test_modern_refill_matches_oracle(box):
    opts = RenderOptions(spp=4, max_depth=6, chunk_size=256, refill=True,
                         compat=MODERN)
    _, _, rel = _compare(box, opts)
    assert np.median(rel) < 1e-4, np.median(rel)
    assert (rel.max(axis=1) < 1e-2).mean() > 0.98


def test_textured_render_matches_oracle():
    scene, _ = load_builtin_box(width=32, height=32, with_texture=True, device="cpu")
    opts = RenderOptions(spp=4, max_depth=2, chunk_size=256, refill=False)
    ids = np.arange(256, dtype=np.int32)
    got, _ = render_pixels(scene, None, opts, torch.as_tensor(ids))
    want = oracle_render_pixels(scene, opts, ids)
    rel = np.abs(got.numpy().astype(np.float64) - want) / (np.abs(want) + 1e-6)
    assert np.median(rel) < 1e-5
    assert (rel.max(axis=1) < 1e-3).mean() > 0.97
