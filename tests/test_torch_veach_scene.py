"""The benchmark's veach-mis stand-in (benchmark/scenes/veach_mis.py: five
lights of 760 faces, Phong plates of Ns 300 to 100,000) through the port's
frame driver on the CPU, at 60 x 45, spp 2, depth 6, held to the benchmark's
float64 reference (benchmark/reference/tracer.py) on seeded pixels.

512 lanes are more than ``cluster_rays``, so the wavefront is sorted and,
with five lights, the NEE prep runs after the sort (``post_nee``); the
unsorted path (``sort_rays=False``) runs the prep before.  Both take the
lane pool the card's frames take.

Tolerances, from the numbers the two renders give here (the same RNG
streams, float32 against float64):

* ``pixel_gap_median`` (checks.py: the median over lit pixels of the
  largest channel's gap over the reference's largest channel) at most
  ``MEDIAN_GAP`` = 1e-4: float32 rounding reads ~5e-7 here, and the control
  (the reference with the scene's floats in bfloat16) ~1e-2;
* ``pixel_bad_share`` (pixels past a gap of 1e-3) at most ``BAD_SHARE`` =
  0.02: a path that parts at a shared edge or a light's rim moves one pixel
  far, and none part here; the control parts ~95% of them.

The control fails both, so a float32 program that rounded its tables to
bfloat16 would too.  The shadow rays are counted exactly: each is one
light's row of a lane that shades a surface of non-black kd, which the
reference counts as one shadow query at that depth.
"""

import pytest
import torch

from benchmark import checks
from benchmark.reference import scene as RS
from benchmark.reference import tracer
from benchmark.scenes import veach_mis
from montecarlopathtracing_torch import api
from montecarlopathtracing_torch.config import RenderOptions
from montecarlopathtracing_torch.integrator import wavefront as twf
from montecarlopathtracing_torch.utils import timing

torch.set_num_threads(2)

W, H, SPP, DEPTH, SEED = 60, 45, 2, 6, 2_147_483_701
OPTS = RenderOptions(spp=SPP, max_depth=DEPTH, chunk_size=512, seed=SEED)
REF_OPTS = {"rr_probability": OPTS.rr_probability, "max_depth": DEPTH,
            "ray_epsilon": OPTS.ray_epsilon,
            "compat": {k: True for k in (
                "no_pixel_jitter", "simplex_light_sampling",
                "clamp_light_distance", "double_receiver_cosine",
                "frozen_light_pick", "material_equality_visibility",
                "plane_sign_triangle_test", "hardcoded_morton_bounds",
                "unnormalized_shading_normal", "no_transmission_epsilon")}}
MEDIAN_GAP, BAD_SHARE = 1e-4, 0.02
N_CHECK = 384


@pytest.fixture(scope="module")
def veach(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("veach"))
    veach_mis.write(d, "veach-mis", {"width": W, "height": H}, 0)
    scene, meta = api.load_scene(d, "veach-mis", OPTS, device="cpu")
    ref = RS.load(d, "veach-mis", device="cpu")
    g = torch.Generator()
    g.manual_seed(2024)
    pix = torch.randperm(W * H, generator=g)[:N_CHECK]
    counts = {}
    ref_px = tracer.render(ref, REF_OPTS, SEED, pix, SPP, counts=counts)
    return scene, meta, ref, pix, ref_px, counts


@pytest.fixture(scope="module")
def frames(veach):
    """{sort_rays: (image, rays)} of the whole frame, sorted and unsorted."""
    return {sort: twf.render_image_host_chunked(
        veach[0], None, OPTS.replace(sort_rays=sort), device="cpu")
        for sort in (None, False)}


def _numbers(values, ref_px):
    gap = checks.pixel_gap(values, ref_px)
    return checks.pixel_numbers([gap], [checks.is_lit(ref_px)])


def test_the_port_loads_five_lights_in_an_l_by_fmax_table(veach):
    scene, meta, *_ = veach
    assert meta.num_faces == 3812 and scene.num_lights == 5
    assert tuple(scene.light_face_tri.shape) == (5, 160)
    assert tuple(scene.light_face_cum_area.shape) == (5, 160)
    faces = [int(((scene.mat_id == m) & scene.tri_valid).sum())
             for m in scene.light_mat.tolist()]
    assert faces == [120, 160, 160, 160, 160]
    assert scene.light_radiance[:, 0].tolist() == pytest.approx(
        [901.8, 100.0, 11.1, 1.23, 800.0], rel=1e-6)
    # The frozen pick draws from the first light's area, the smallest.
    areas = scene.light_total_area.tolist()
    assert areas[0] == pytest.approx(0.011, rel=1e-5) == min(areas)
    assert max(areas) == pytest.approx(10.06, rel=1e-5)
    assert sorted(set(scene.ns.tolist())) == [1.0, 300.0, 1000.0, 10000.0,
                                             100000.0]


@pytest.mark.parametrize("sort", [None, False], ids=["sorted", "unsorted"])
def test_frame_matches_the_float64_reference(veach, frames, sort):
    _, _, _, pix, ref_px, _ = veach
    img, rays = frames[sort]
    assert img.shape == (H, W, 3) and torch.isfinite(img).all()
    nums = _numbers(img.reshape(-1, 3)[pix], ref_px)
    assert nums["pixel_gap_median"] <= MEDIAN_GAP, nums
    assert nums["pixel_bad_share"] <= BAD_SHARE, nums
    # Every lit part of the scene is seen: lights, plates, floor.
    assert checks.is_lit(ref_px).float().mean() > 0.9 and int(rays) > 0


def test_sorted_and_unsorted_frames_agree(frames):
    (a, ra), (b, rb) = frames[None], frames[False]
    assert int(ra) == int(rb)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_the_bfloat16_control_fails_both_tolerances(veach):
    _, _, ref, pix, ref_px, _ = veach
    ctl = tracer.render(checks.control_scene(ref), REF_OPTS, SEED, pix, SPP)
    nums = _numbers(ctl, ref_px)
    assert nums["pixel_gap_median"] > MEDIAN_GAP
    assert nums["pixel_bad_share"] > BAD_SHARE


@pytest.mark.parametrize("sort,post_nee", [(None, 1), (False, 0)],
                         ids=["sorted", "unsorted"])
def test_shadow_rays_are_the_references_shadow_queries(veach, sort, post_nee):
    scene, _, _, pix, _, counts = veach
    twf.reset_loop_stats()
    with timing.tracing() as tr:
        _, rays = twf.render_pixels_refill(
            scene, None, OPTS.replace(sort_rays=sort), pix.to(torch.int32),
            lanes=128)
    st = twf.loop_stats()
    assert st["shadow_rays"] == counts["shadow"] > 0
    assert st["shadow_rows"] == st["iterations"] * 128 * 5
    assert st["shadow_rays"] < st["shadow_rows"]
    assert st["query_rows"] == st["iterations"] * 128 * 6
    (setup,) = [s["counts"] for s in tr.spans if s["name"] == "pool_setup"]
    assert setup == {"lanes": 128, "reused": 0, "lights": 5,
                     "post_nee": post_nee}
