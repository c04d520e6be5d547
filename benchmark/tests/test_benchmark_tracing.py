"""The program's spans laid over the device's activity
(``benchmark/attribute.py``) on synthetic events and spans, the lane
pool's occupancy reader, a tiny run of ``attribute.py`` on the CPU, and,
on the card, the shared clock of the spans and the profiler's events."""

import time

import pytest
import torch

from benchmark import attribute, core, profiling
from benchmark.tests import _tiny


class _Trace:
    """A tracer's spans on a clock whose offset to the events' is 0."""

    def __init__(self, *spans):
        self.spans = [{"name": n, "start_ns": int(a * 1e9), "end_ns": int(b * 1e9)}
                      for n, a, b in spans]

    @staticmethod
    def unix_ns(t_ns):
        return t_ns


def _events(*busy):
    return [(f"k{i}", a, b) for i, (a, b) in enumerate(busy)]


def test_a_gap_under_a_capture_span_counts_toward_the_capture_share():
    # Busy 0-1, 4-5, 6-7; the gaps 1-4 (under capture) and 5-6 (under
    # replay), both inside one dispatch.
    tr = _Trace(("dispatch", 0.5, 6.5), ("capture", 1.0, 4.0),
                ("replay", 4.5, 6.2))
    out = attribute.attribute("frames", _events((0, 1), (4, 5), (6, 7)), tr, 1)
    assert out["idle_by_span_s"] == {"capture": 3.0, "replay": 1.0}
    assert out["capture_idle_share"] == 75.0
    assert out["eager_idle_share"] == 0.0
    assert out["unattributed_idle_share"] == 0.0
    assert (out["busy_s"], out["idle_s"]) == (3.0, 4.0)


def test_a_gap_under_nested_spans_goes_to_the_innermost():
    # One gap, 1-5: 1-2 under frame alone, 2-4 under frame > dispatch >
    # eager_block, 4-5 under frame > dispatch.
    tr = _Trace(("frame", 0.0, 10.0), ("dispatch", 2.0, 9.0),
                ("eager_block", 2.0, 4.0))
    out = attribute.attribute("frames", _events((0, 1), (5, 6)), tr, 1)
    assert out["idle_by_span_s"] == {"eager_block": 2.0, "frame": 1.0,
                                     "dispatch": 1.0}
    assert out["eager_idle_share"] == 50.0
    assert out["unattributed_idle_share"] == 50.0
    assert out["idle_gaps"] == [("eager_block before k1", 4.0)]


def test_a_gap_under_no_span_counts_as_outside():
    # Gaps 1-2 (no span), 3-5 (capture 3-3.5, then nothing); two units.
    tr = _Trace(("capture", 3.0, 3.5))
    out = attribute.attribute("frames", _events((0, 1), (2, 3), (5, 6)), tr, 2)
    assert out["idle_by_span_s"] == {"outside": 1.25, "capture": 0.25}
    assert out["unattributed_idle_share"] == pytest.approx(250 / 3)
    assert out["capture_idle_share"] == pytest.approx(50 / 3)
    assert [label for label, _ in out["idle_gaps"]] == ["outside before k2",
                                                         "outside before k1"]


def test_gaps_and_busy_time_are_the_profilings_own():
    events = sorted(_events((0, 1), (0.5, 2), (3, 4), (3.5, 3.7), (6, 7)),
                    key=lambda e: e[1])
    busy, gaps = profiling.busy_and_gaps(events)
    assert sum(b - a for a, b in attribute.busy_intervals(events)) == busy
    assert sorted(b - a for a, b, _ in attribute.idle_gaps(events)) == \
        sorted(s for _, s in gaps)


def test_device_time_inside_the_backward_span():
    tr = _Trace(("grad_step", 0.0, 10.0), ("forward", 0.0, 3.0),
                ("backward", 3.0, 10.0), ("capture", 3.5, 5.0))
    out = attribute.attribute("grad_steps", _events((1, 2), (2.5, 4), (5, 6)),
                              tr, 1)
    # Busy 2.5-4 holds 1 s inside backward, 5-6 another.
    assert out["bwd_span_device_ms"] == 2000.0
    assert out["idle_by_span_s"] == {"forward": 0.5, "capture": 1.0}
    assert out["capture_idle_share"] == pytest.approx(200 / 3)
    assert "eager_idle_share" not in out


def test_lane_occupancy_reads_the_programs_counters():
    mod = core.load_module("metrics", "lane_occupancy.fwd")
    stats = {"iterations": 10, "query_rows": 400, "rays": 100}
    assert mod.read({"kind": "frames", "loop_stats": stats}) == 25.0
    assert mod.read({"kind": "grad_steps", "loop_stats": stats}) is None


def test_a_trace_without_program_spans_or_counters_reads_nothing():
    """The parent's program: loop_stats without the pool's row counters."""
    mod = core.load_module("metrics", "lane_occupancy.fwd")
    parent = {"kind": "frames", "units": 1, "loop_stats": {
        "dispatches": 5, "iterations": 400, "idle_iterations": 3,
        "eager_blocks": 5, "graphs": 25, "replays": 45, "capture_s": 4.2}}
    assert mod.read(parent) is None
    assert "lane_occupancy.fwd" not in core.per_layer(parent)


@pytest.mark.parametrize("name", ["cornell-1024-spp25", "interior-720p-grad-spp4"])
def test_attribute_runs_a_tiny_cell(name):
    cell = _tiny.cell(name)
    out = attribute.measure(cell, 2**31 + 5, 1, torch.device("cpu"))
    assert out["device"]["platform"] == "cpu"
    assert {"load_scene_s", "parse_s", "build_s", "upload_s"} <= set(out["scene_load"])
    prof = out["profiled"]
    # No device activity on the CPU: nothing is idle, nothing captured.
    assert prof["idle_s"] == 0.0 and prof["capture"]["spans"] == 0
    assert prof["spans"] > 0
    if cell.traffic["kind"] == "frames":
        assert 0 < prof["lane_occupancy"] <= 100
    cost = out["tracer_cost"]
    assert len(cost["off_s"]) == len(cost["on_s"]) == 1


@pytest.mark.card
def test_spans_share_the_device_traces_clock(card):
    """A span of 50 ms between two kernels lies inside the device's gap
    between them, each end within 1 ms of the gap's: the first kernel ended
    before the span opened, the second was launched after it closed.  The
    profiler's first launch and synchronise take milliseconds of their own
    on the host, so one kernel runs under it before the measured two."""
    from montecarlopathtracing_torch.utils import timing

    x = torch.ones(1 << 22, device=card)
    with profiling.device_profile() as prof, timing.tracing() as tr:
        for _ in range(2):
            x.mul_(2)
            torch.cuda.synchronize(card)
        with timing.span("sleep"):
            time.sleep(0.05)
        x.mul_(2)
        torch.cuda.synchronize(card)
    kernels = [e for e in profiling.device_events(prof) if "Mul" in e[0]]
    assert len(kernels) == 3
    gap = (kernels[1][2], kernels[2][1])
    (sp,) = tr.spans
    span = (tr.unix_ns(sp["start_ns"]) * 1e-9, tr.unix_ns(sp["end_ns"]) * 1e-9)
    print(f"gap {gap[1] - gap[0]:.6f} s, span {span[1] - span[0]:.6f} s, "
          f"opening {span[0] - gap[0]:+.6f} s, closing {gap[1] - span[1]:+.6f} s")
    assert gap[0] <= span[0] < span[1] <= gap[1]
    assert span[0] - gap[0] < 1e-3 and gap[1] - span[1] < 1e-3
