"""The veach-mis configuration (scenes/veach_mis.py, configs/
veach-mis-1200x900.json), its cell, and the shadow rows' share of NEE
(metrics/shadow_occupancy.fwd.py)."""

import math

import pytest
import torch

from benchmark import core
from benchmark.reference import scene as RS

CELL = "veach-1200x900-spp10"


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    cell = core.Cell(CELL)
    d = str(tmp_path_factory.mktemp("veach"))
    cell.generator.write(d, cell.scene_name, cell.config, 12345)
    return RS.load(d, cell.scene_name)


def test_the_generator_keeps_the_upstreams_counts(ref):
    assert ref.num_tris == 3812
    assert ref.num_lights == 5
    faces = ref.light_count.tolist()
    assert faces == [120, 160, 160, 160, 160] and sum(faces) == 760
    assert ref.light_radiance[:, 0].tolist() == [901.8, 100.0, 11.1, 1.23, 800.0]
    # Each light its own material, in the .camera file's order.
    assert len(set(ref.light_mat.tolist())) == 5
    areas = ref.light_total.tolist()
    assert areas[0] == pytest.approx(0.011, rel=1e-9) == min(areas)
    assert max(areas) == pytest.approx(10.06, rel=1e-9)
    glossy = sorted({float(n) for n, k in zip(ref.ns.tolist(), ref.ks[:, 0].tolist())
                     if k > 0})
    assert glossy == [300.0, 1000.0, 10000.0, 100000.0]
    assert (ref.width, ref.height) == (1200, 900)
    assert ref.fovy == pytest.approx(27.39)


def test_the_stand_in_does_not_depend_on_the_seed(tmp_path):
    cell = core.Cell(CELL)
    texts = []
    for seed in (1, 2 ** 31 + 5):
        d = tmp_path / str(seed)
        cell.generator.write(str(d), "s", cell.config, seed)
        texts.append([(d / f"s.{e}").read_text() for e in ("obj", "mtl", "camera")])
    assert texts[0] == texts[1]


def test_the_configuration_lists_its_cut_and_its_assumptions():
    cell = core.Cell(CELL)
    cfg = cell.config
    assert list(cfg["reduced"]) == ["geometry"]
    for key in ("camera", "lights", "light_areas", "plates", "plate_material",
                "floor", "triangles"):
        assert cfg["assumed"][key]
    # The render options are the other configurations' block.
    box = core.Cell("cornell-1024-spp25").config["render_options"]
    assert cfg["render_options"] == box
    assert cell.options["spp"] == 10 and cell.chips == 1


def shadow_reader():
    return core.load_module("metrics", "shadow_occupancy.fwd")


def test_shadow_occupancy_reads_nothing_without_the_counters():
    read = shadow_reader().read
    assert read({}) is None
    # A program without the counters: the loop's statistics lack them.
    stats = {"iterations": 10, "query_rows": 6000, "rays": 3000}
    assert read({"kind": "frames", "loop_stats": stats}) is None
    # One light: its rows are half of lane_occupancy's, and read there.
    one = dict(stats, query_rows=2000, shadow_rows=1000, shadow_rays=700)
    assert read({"kind": "frames", "loop_stats": one}) is None
    assert read({"kind": "grad_steps", "loop_stats": dict(
        stats, shadow_rows=5000, shadow_rays=100)}) is None


def test_shadow_occupancy_reads_the_share_of_a_planted_trace():
    # 10 iterations of 100 lanes and five lights: 5,000 NEE rows, of which
    # 3,100 carried rays; every name the harness gives the trace is there.
    trace = {"kind": "frames", "units": 2, "loop_stats": {
        "iterations": 10, "query_rows": 6000, "rays": 3900,
        "shadow_rows": 5000, "shadow_rays": 3100}}
    assert shadow_reader().read(trace) == pytest.approx(62.0)
    assert core.per_layer(trace)["shadow_occupancy.fwd"] == {
        "value": pytest.approx(62.0), "unit": "%"}


def tiny_cell():
    """The cell cut for the CPU: 40 x 30, spp 2, depth 6, 512 lanes (more
    than cluster_rays, so the NEE prep runs after the sort)."""
    c = core.Cell(CELL)
    c.config.update(width=40, height=30)
    c.config["render_options"].update(chunk_size=512, max_depth=6)
    c.traffic["render_options"]["spp"] = 2
    c.traffic["check_pixels"] = 256
    return c


def run_tiny(trace=False):
    r = core.Run(tiny_cell(), 2 ** 31 + 99, 0.3, trace, device="cpu")
    try:
        return core.execute(r)
    finally:
        r.cleanup()


def test_a_sound_frame_is_correct_and_reads_its_shadow_occupancy():
    out = run_tiny(trace=True)
    assert out["correct"]
    share = out["metrics"]["shadow_occupancy.fwd"]["value"]
    assert 0 < share < 100 and math.isfinite(share)


def test_a_frame_without_one_lights_nee_fails(monkeypatch):
    from montecarlopathtracing_torch.integrator import wavefront as W

    real = W._nee_resolve

    def without_the_last_light(scene, opts, contrib, *rest):
        keep = torch.ones(contrib.shape[0], 1, 1, dtype=contrib.dtype,
                          device=contrib.device)
        keep[-1] = 0.0
        return real(scene, opts, contrib * keep, *rest)

    monkeypatch.setattr(W, "_nee_resolve", without_the_last_light)
    assert not run_tiny()["correct"]
