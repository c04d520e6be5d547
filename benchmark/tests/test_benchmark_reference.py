"""The frozen reference on cases checked by hand, and against the port's
own float64 oracle (the test may import the port; the reference may not)."""

import math
import os

import numpy as np
import pytest
import torch

from benchmark import core
from benchmark.reference import rng, scene as RS, tracer

COMPAT = {k: True for k in (
    "no_pixel_jitter", "simplex_light_sampling", "clamp_light_distance",
    "double_receiver_cosine", "frozen_light_pick", "material_equality_visibility",
    "plane_sign_triangle_test", "hardcoded_morton_bounds",
    "unnormalized_shading_normal", "no_transmission_epsilon")}
OPTS = {"rr_probability": 0.6, "max_depth": 6, "ray_epsilon": 0.01, "compat": COMPAT}


def write_scene(d, obj, mtl, cam):
    for ext, text in (("obj", obj), ("mtl", mtl), ("camera", cam)):
        with open(os.path.join(d, f"s.{ext}"), "w") as fh:
            fh.write(text)
    return RS.load(str(d), "s")


LIGHT_ONLY = ("v -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\nusemtl L\n"
              "f 1 2 3\nf 1 3 4\n",
              "newmtl L\nKd 0 0 0\nKs 0 0 0\nNs 1\nNi 1\n",
              "eye 0 0 5\nlookat 0 0 0\nup 0 1 0\nfovy 30\nwidth 4\nheight 4\n"
              "mtlname L 2.5 3.5 4.5\n")


def test_a_pixel_that_sees_the_light_reads_its_radiance(tmp_path):
    s = write_scene(tmp_path, *LIGHT_ONLY)
    # The 4 x 4 frame's top-left lattice corners all fall on the 2 x 2 quad
    # (half-height tan(15 deg) * 5 = 1.34 at the quad): every corner ray but
    # the first row and column hits it.
    out = tracer.render(s, OPTS, 3, torch.arange(16), 2)
    inside = [5, 6, 7, 9, 10, 11, 13, 14, 15]
    assert torch.equal(out[inside], torch.tensor([[2.5, 3.5, 4.5]] * 9,
                                                 dtype=torch.float64))
    assert torch.equal(out[[0, 1, 2, 3, 4, 8, 12]], torch.zeros(7, 3,
                                                               dtype=torch.float64))


def test_nearest_hit_by_hand(tmp_path):
    s = write_scene(tmp_path, *LIGHT_ONLY)
    tris = tracer._Triangles(s, True)
    o = torch.tensor([[0.5, -0.5, 2.0], [-0.5, 0.5, 2.0], [3.0, 0.0, 2.0]],
                     dtype=torch.float64)
    d = torch.tensor([[0.0, 0.0, -1.0]] * 3, dtype=torch.float64)
    hit, t, tri = tracer._Triangles(s, False).nearest(o, d)
    assert hit.tolist() == [True, True, False]
    assert t[:2].tolist() == [2.0, 2.0] and tri.tolist() == [0, 1, -1]
    assert tris.nearest(o, d)[2].tolist() == [0, 1, -1]


def test_light_cdf_in_parse_order(tmp_path):
    obj = ("v 0 0 0\nv 2 0 0\nv 2 0 1\nv 0 0 1\nv 5 0 0\nv 6 0 0\nv 6 0 3\n"
           "usemtl W\nf 1 2 3\nusemtl L\nf 5 6 7\nf 1 3 4\n")
    mtl = "newmtl W\nKd 0.5 0.5 0.5\nnewmtl L\nKd 0 0 0\n"
    cam = "eye 0 5 0\nlookat 0 0 0\nup 0 0 1\nfovy 30\nwidth 2\nheight 2\nmtlname L 1 1 1\n"
    s = write_scene(tmp_path, obj, mtl, cam)
    assert s.light_faces.tolist() == [[1, 2]]
    assert s.light_cum.tolist() == [[1.5, 2.5]]
    assert s.light_total.tolist() == [2.5]


def test_rng_is_the_ports():
    from montecarlopathtracing_torch.integrator import rng as port_rng

    pix = torch.tensor([0, 5, 2**20, 921599])
    for seed in (0, 7, 2**31 + 12345):
        k = rng.lane_keys(seed, pix, 3)
        assert torch.equal(k, port_rng.lane_keys(seed, pix, 3))
        assert torch.equal(rng.bounce_uniforms(k, 4, 9),
                           port_rng.bounce_uniforms(k, 4, 9))
        assert torch.equal(rng.primary_uniforms(k), port_rng.primary_uniforms(k))


@pytest.mark.parametrize("generator", ["cornell_box", "procedural_interior"])
def test_reference_matches_the_ports_float64_oracle(tmp_path, generator):
    """The port's oracle holds the port's float32 tables; the reference
    parses the text in float64: most pixels agree to float32 rounding."""
    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.oracle.cpu_reference import oracle_render_pixels
    from montecarlopathtracing_torch.scene.loader import build_scene

    params = {"cornell_box": dict(width=24, height=24, light_radiance=[30, 30, 30]),
              "procedural_interior": dict(width=64, height=36, n_tris=4000,
                                          n_materials=96, n_textures=8,
                                          scene_seed=0,
                                          light_radiance=[40, 40, 40])}[generator]
    core.load_module("scenes", generator).write(str(tmp_path), "s", params, 0)
    opts = RenderOptions(spp=2, max_depth=6, seed=11)
    port, _ = build_scene(str(tmp_path), "s", opts, device="cpu")
    ids = np.arange(params["width"] * params["height"])
    want = oracle_render_pixels(port, opts, ids)
    got = tracer.render(RS.load(str(tmp_path), "s"), OPTS, 11,
                        torch.as_tensor(ids), 2).numpy()
    lit = np.abs(want).max(1) > 0
    gap = np.abs(got - want).max(1) / (np.abs(want).max(1) + 1e-6)
    assert lit.sum() > 10
    assert np.median(gap[lit]) < 1e-5
    assert (gap > 1e-3).mean() < 0.05
    assert math.isfinite(got.sum())
