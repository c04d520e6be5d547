"""The arithmetic of the end-to-end and per-layer metrics and of the
check, on numbers worked out by hand."""

import math

import pytest

from benchmark import checks, core, profiling

import torch


def test_closed_loop_rate_over_the_window(monkeypatch):
    clock = iter([0.0, 0.0, 3.0, 3.0, 6.0, 6.0, 9.0, 9.0, 12.0])
    monkeypatch.setattr(core.time, "monotonic", lambda: next(clock))
    start, end, recs = core.closed_loop(10.0, lambda k: k)
    # Units run until the one that ends past 10 s; all of them count.
    assert (start, end) == (0.0, 12.0)
    assert [r[2] for r in recs] == [1, 2, 3, 4]
    samples = len(recs) * 1024 * 1024 * 25
    assert samples / (end - start) == pytest.approx(8738133.333333334)


def test_roofline_bytes_by_hand():
    rl = core.load_module("metrics", "_roofline")
    # 1e6 queries of 24 + 8 bytes and 1000 triangles of 36 bytes.
    assert rl.frame_bytes(1e6, 1000) == 32e6 + 36e3
    assert rl.least_seconds(1e6, 1000) == pytest.approx(32.036e6 / 3.35e12)
    assert rl.is_intersector("cluster_intersect_kernel(float const*, int)")
    assert rl.is_intersector("void cluster_ftb_chunked_kernel<4>(Params)")
    assert rl.is_intersector("walk_rays_per_thread(float const*)")
    assert not rl.is_intersector("void at::native::vectorized_elementwise_kernel")


def test_roofline_reader():
    mod = core.load_module("metrics", "intersect_roofline")
    trace = {"kind": "frames", "units": 2, "queries_per_frame": 1e8,
             "triangles": 12,
             "kernels": [("cluster_intersect_kernel(x)", 0.02, 10),
                         ("cluster_keys_kernel(p)", 0.01, 10),
                         ("void at::native::sort", 1.0, 5)]}
    least = (1e8 * 32 + 12 * 36) / 3.35e12
    assert mod.read(trace) == pytest.approx(100 * least / 0.015)
    assert mod.read(dict(trace, kind="grad_steps")) is None


def test_busy_is_the_union_and_gaps_are_labelled():
    events = [("a(x)", 0.0, 1.0), ("b", 0.5, 2.0), ("c(y)", 3.0, 3.5),
              ("d", 3.2, 3.3), ("e", 6.0, 7.0)]
    busy, gaps = profiling.busy_and_gaps(events)
    assert busy == pytest.approx(2.0 + 0.5 + 1.0)
    assert gaps == [("before e", pytest.approx(2.5)), ("before c", pytest.approx(1.0))]
    s = profiling.summarize(events + [("Memset (Device)", 7.0, 7.5)])
    assert s["kernel_count"] == 5
    assert s["kernels"][0][0] == "b"


def test_idle_share_and_per_unit_readers():
    idle = core.load_module("metrics", "device_idle_share.fwd")
    assert idle.read({"kind": "frames", "busy_s": 1.5, "wall_s": 2.0}) == \
        pytest.approx(25.0)
    kpi = core.load_module("metrics", "kernels_per_iter.fwd")
    assert kpi.read({"kind": "frames", "kernel_count": 7600,
                     "iterations": 10}) == 760
    cap = core.load_module("metrics", "graph_capture_ms.grad")
    assert cap.read({"kind": "grad_steps", "units": 2, "grad_loop_stats": {
        "fwd_graphs": 1, "bwd_graphs": 1, "fwd_capture_s": 0.1,
        "bwd_capture_s": 0.3}}) == pytest.approx(200.0)
    bwd = core.load_module("metrics", "bwd_device_ms.grad")
    assert bwd.read({"kind": "grad_steps", "units": 2, "bwd_busy_s": 2.5}) == \
        pytest.approx(1250.0)
    assert bwd.read({"kind": "frames", "units": 2, "bwd_busy_s": 2.5}) is None


def test_pixel_gap_and_numbers_by_hand():
    prog = torch.tensor([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0], [1.1, 1.0, 1.0],
                         [float("nan"), 0.0, 0.0]])
    ref = torch.tensor([[1.0, 2.0, 3.003], [0.0, 0.0, 0.0], [1.0, 1.0, 1.0],
                        [1.0, 1.0, 1.0]], dtype=torch.float64)
    gap = checks.pixel_gap(prog, ref)
    assert gap[0] == pytest.approx(0.003 / (3.003 + 1e-6), rel=1e-5)
    assert gap[1] == 0.0
    assert gap[2] == pytest.approx(0.1 / (1.0 + 1e-6), rel=1e-5)
    assert math.isinf(gap[3])
    n = checks.pixel_numbers([gap], [checks.is_lit(ref)])
    # lit pixels 0, 2, 3: gaps ~0.001, ~0.1, inf -> median ~0.1
    assert n["pixel_gap_median"] == pytest.approx(0.1 / (1.0 + 1e-6), rel=1e-5)
    # gaps past 1e-3: pixel 2 and pixel 3 of four
    assert n["pixel_bad_share"] == 0.5


def test_field_gap_by_hand():
    ref = {"kd": torch.tensor([3.0, 4.0]), "ks": torch.zeros(2),
           "ns": torch.zeros(2), "light_radiance": torch.tensor([1.0]),
           "atlas": torch.tensor([0.5])}
    prog = dict(ref, kd=torch.tensor([3.0, 4.5]), ks=torch.tensor([0.0, 0.1]))
    # norms 5, 0, 0, 1, 0.5 -> median of the moved fields 1; kd 0.5 / 5,
    # ks 0.1 / 1
    assert checks.field_gap(prog, ref) == pytest.approx(0.1)
    # A field the reference leaves at zero is held against that median,
    # not against 0.
    ref = dict(ref, atlas=torch.zeros(1))
    prog = dict(ref, atlas=torch.tensor([1e-9]))
    assert checks.field_gaps(prog, ref)["atlas"] == pytest.approx(1e-9 / 5.0)


def test_judge():
    ok, rows = checks.judge({"a": 1.0, "b": 2.0}, {"a": 1.0, "b": 3.0})
    assert ok and rows == [("a", 1.0, 1.0), ("b", 2.0, 3.0)]
    assert not checks.judge({"a": 1.5}, {"a": 1.0})[0]
    assert not checks.judge({"a": float("nan")}, {"a": 1.0})[0]
    assert not checks.judge({"a": 0.5}, {"a": 1.0, "b": 1.0})[0]
