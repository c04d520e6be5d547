"""Where a cell's device-idle time goes, by the program's own spans, and
what the program's tracer costs when it is on, in one process:

    python3 benchmark/attribute.py --workload <cell> --seed <n> [--repeats 3]

The cell's scene is loaded with the program's tracer on
(``montecarlopathtracing_torch.utils.timing.tracing``), then its units are
warmed up as a run's are.  The traced run's units (``trace_frames`` or
``trace_steps`` of the mix, seeds seed + 1, ...) are then run under the
device profiler with the tracer on, a gradient step as users call it
(``loss_and_grad``, no synchronise between its halves).  Every idle gap
between the device's activity intervals is put down to the innermost
program span open over it; a span's times are put on the profiler's clock
by the tracer's own offset (``Trace.unix_ns``).  Last, the same units run
unprofiled ``--repeats`` times with the tracer off and on, in turns, each
repeat starting with the other.

Prints one JSON line: the device; the scene load's spans; the idle and the
busy time a unit by innermost span (``outside`` where none is open); the
shares the program's spans give (``capture_idle_share``,
``eager_idle_share``, ``unattributed_idle_share`` and ``lane_occupancy``
for frames, ``capture_idle_share`` and ``bwd_span_device_ms`` for
gradient steps); the ten longest gaps labelled by span, then by the
activity that ended them;
the capture spans against ``capture_s``; and the unprofiled seconds a
unit with the tracer off and on.  The benchmark's runs do not run this.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import sys
import time
from typing import Dict, List, Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import core, profiling, program  # noqa: E402

OUTSIDE = "outside"
# A frame's spans that only hold others: idle time under them alone is
# not put down to any work.
CONTAINERS = ("frame", "dispatch")


def busy_intervals(events) -> List[Tuple[float, float]]:
    """The union of the activity intervals [(name, start, end)], sorted by
    start, as disjoint [(start, end)]."""
    out: List[List[float]] = []
    for _, a, b in events:
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def idle_gaps(events) -> List[Tuple[float, float, str]]:
    """The gaps between the activity intervals, as ``busy_and_gaps`` counts
    them: [(start, end, the activity that ended the gap)]."""
    gaps, end = [], None
    for name, a, b in events:
        if end is not None and a > end:
            gaps.append((end, a, name))
        end = b if end is None else max(end, b)
    return gaps


def innermost(spans, to_s) -> List[Tuple[float, float, Optional[str]]]:
    """The spans' whole range cut into pieces [(start, end, name)], each
    labelled with the innermost span open over it (None where none is);
    ``to_s`` puts a span's time in ns on the events' clock, in seconds.
    Spans nest (a child closes before its parent)."""
    order = sorted(spans, key=lambda s: (s["start_ns"], -s["end_ns"]))
    pieces: List[Tuple[float, float, Optional[str]]] = []
    stack: List[Tuple[float, str]] = []
    t = None

    def cut(upto, name):
        if t is not None and upto > t:
            pieces.append((t, upto, name))

    for s in order:
        a, b = to_s(s["start_ns"]), to_s(s["end_ns"])
        while stack and stack[-1][0] <= a:
            end, name = stack.pop()
            cut(end, name)
            t = end
        cut(a, stack[-1][1] if stack else None)
        t = a
        stack.append((b, s["name"]))
    while stack:
        end, name = stack.pop()
        cut(end, name)
        t = end
    return pieces


def overlap_by_name(intervals, pieces) -> Dict[str, float]:
    """Seconds of the sorted disjoint ``intervals`` [(start, end, ...)]
    under each innermost span name of ``pieces`` (``outside`` where no span
    is open)."""
    out: Dict[str, float] = {}
    j = 0
    for iv in intervals:
        a, b = iv[0], iv[1]
        covered = 0.0
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            if hi > lo:
                name = pieces[k][2] or OUTSIDE
                out[name] = out.get(name, 0.0) + hi - lo
                covered += hi - lo
            k += 1
        if b - a > covered:
            out[OUTSIDE] = out.get(OUTSIDE, 0.0) + (b - a - covered)
    return out


def gap_labels(gaps, pieces, top: int = 10) -> List[Tuple[str, float]]:
    """The ``top`` longest gaps as [(label, seconds)]: the span that holds
    most of the gap, then ``before`` the activity that ended it."""
    out = []
    for a, b, name in sorted(gaps, key=lambda g: -(g[1] - g[0]))[:top]:
        under = overlap_by_name([(a, b)], pieces)
        span = max(under, key=under.get)
        out.append((f"{span} before {profiling.short_name(name)}", b - a))
    return out


def clipped_busy(busy, spans, name: str, to_s) -> float:
    """Device-busy seconds inside the spans called ``name``."""
    total = 0.0
    for s in spans:
        if s["name"] != name:
            continue
        a, b = to_s(s["start_ns"]), to_s(s["end_ns"])
        total += sum(max(0.0, min(b, hi) - max(a, lo)) for lo, hi in busy)
    return total


def shares(kind: str, idle: Dict[str, float]) -> Dict[str, float]:
    total = sum(idle.values())
    if total <= 0:
        return {}

    def pct(names):
        return 100.0 * sum(idle.get(n, 0.0) for n in names) / total

    out = {"capture_idle_share": pct(["capture"])}
    if kind == "frames":
        out["eager_idle_share"] = pct(["eager_block"])
        out["unattributed_idle_share"] = pct([OUTSIDE, *CONTAINERS])
    return out


def attribute(kind: str, events, trace, units: int) -> dict:
    """The profiled units' idle time by span, and the shares and gaps."""
    def to_s(t_ns):
        return trace.unix_ns(t_ns) * 1e-9

    pieces = innermost(trace.spans, to_s)
    busy = busy_intervals(events)
    gaps = idle_gaps(events)
    idle = overlap_by_name(gaps, pieces)
    out = {"busy_s": sum(b - a for a, b in busy) / units,
           "idle_s": sum(b - a for a, b, _ in gaps) / units,
           "idle_by_span_s": _per_unit(idle, units),
           # Where the host was while the device worked: a span's device
           # work may run after the span has closed.
           "busy_by_span_s": _per_unit(overlap_by_name(busy, pieces), units),
           "idle_gaps": gap_labels(gaps, pieces)}
    out.update(shares(kind, idle))
    if kind == "grad_steps":
        out["bwd_span_device_ms"] = 1e3 * clipped_busy(
            busy, trace.spans, "backward", to_s) / units
    return out


def _per_unit(seconds: Dict[str, float], units: int) -> Dict[str, float]:
    return {k: v / units for k, v in sorted(seconds.items(), key=lambda kv: -kv[1])}


def capture_check(spans, seconds: float) -> dict:
    """The capture spans' total against the counter's ``capture_s``."""
    caps = [s["end_ns"] - s["start_ns"] for s in spans if s["name"] == "capture"]
    return {"spans": len(caps), "spans_s": sum(caps) * 1e-9,
            "capture_s": seconds}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = measure(core.Cell(args.workload), args.seed, args.repeats,
                  torch.device(args.device))
    smi = core.nvidia_smi() if out["device"]["platform"] == "gpu" else None
    if smi:
        out["device"]["nvidia_smi"] = smi
    print(json.dumps(out), flush=True)
    return 0


def measure(cell: core.Cell, seed: int, repeats: int, dev) -> dict:
    from montecarlopathtracing_torch.diff import gradients as G
    from montecarlopathtracing_torch.integrator import wavefront as W
    from montecarlopathtracing_torch.utils import timing

    kind = cell.traffic["kind"]
    if kind not in ("frames", "grad_steps"):
        raise core.HarnessError(f"attribute.py takes frames or gradient steps on "
                                f"one device, not {kind!r}")
    run = core.Run(cell, seed, 0.0, True, dev.type)
    try:
        opts = program.render_options(cell.options)
        with timing.tracing() as load_trace:
            scene = program.load_scene(run, opts, dev)
        if kind == "frames":
            loop = cell.loop
            n_units = int(cell.traffic["trace_frames"])

            def unit(k):
                loop.frame(scene, opts, seed, k, dev)
        else:
            n_units = int(cell.traffic["trace_steps"])
            params = G.SceneParams.from_scene(scene)
            target = cell.loop.target_image(
                seed, scene.camera.height, scene.camera.width).to(dev)

            def unit(k):
                G.loss_and_grad(params, scene, None,
                                opts.replace(seed=core.unit_seed(seed, k)),
                                target, device=dev)
                program.sync(dev)

        for _ in range(core.WARMUP_UNITS):
            unit(0)
        W.reset_loop_stats()
        with profiling.device_profile(dev.type == "cuda") as prof, \
                timing.tracing() as tr:
            for k in range(1, n_units + 1):
                unit(k)
        stats = W.loop_stats() if kind == "frames" else W.grad_loop_stats()
        capture_s = (stats["capture_s"] if kind == "frames"
                     else stats["fwd_capture_s"] + stats["bwd_capture_s"])
        res = attribute(kind, profiling.device_events(prof), tr, n_units)
        if kind == "frames" and stats["query_rows"]:
            res["lane_occupancy"] = 100.0 * stats["rays"] / stats["query_rows"]
        res["capture"] = capture_check(tr.spans, capture_s)
        res["spans"] = len(tr.spans)

        def timed(on: bool) -> float:
            with timing.tracing() if on else contextlib.nullcontext():
                a = time.monotonic()
                for k in range(1, n_units + 1):
                    unit(k)
                return (time.monotonic() - a) / n_units

        cost = {"off_s": [], "on_s": []}
        for r in range(repeats):
            for on in ((False, True) if r % 2 == 0 else (True, False)):
                cost["on_s" if on else "off_s"].append(timed(on))
        if repeats:
            off, on = (statistics.median(cost[k]) for k in ("off_s", "on_s"))
            cost.update(off_median_s=off, on_median_s=on,
                        on_over_off=on / off - 1.0)
        load = {s["name"] + "_s": (s["end_ns"] - s["start_ns"]) * 1e-9
                for s in load_trace.spans}
        return {"cell": cell.name, "seed": seed, "units": n_units,
                "device": core.device_info(dev, cell.chips,
                                           program.memory_peak(dev)),
                "scene_load": load, "profiled": res, "tracer_cost": cost}
    finally:
        run.cleanup()


if __name__ == "__main__":
    sys.exit(main())
