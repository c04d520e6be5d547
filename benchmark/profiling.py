"""Device activity from a ``torch.profiler`` run: busy time, kernels by
name, and the idle gaps between them.

``kernel_table`` sums kernels by name as ``profile_torch.py::kernel_stats``
does (frozen from commit 8674dbe); the busy time here is the union of the
device's activity intervals, so that work on two streams at once counts
once.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Tuple

import torch


@contextlib.contextmanager
def device_profile(enabled: bool = True):
    """A profiler recording device activity only (no host ops: a frame
    launches ~1M kernels), or nothing when ``enabled`` is false."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        yield prof


def device_events(prof) -> List[Tuple[str, float, float]]:
    """[(name, start s, end s)] of every device activity (kernels, copies,
    fills) of a finished profiler run, in start order."""
    if prof is None:
        return []
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    try:
        events = prof.profiler.kineto_results.events()
    except AttributeError:
        events = None
    if events is not None:
        for e in events:
            if e.device_type() != cuda:
                continue
            if hasattr(e, "start_ns"):
                start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            else:
                start, dur = e.start_us() * 1e-6, e.duration_us() * 1e-6
            out.append((e.name(), start, start + dur))
    else:
        for e in prof.events():
            if getattr(e, "device_type", None) == cuda:
                out.append((e.name, e.time_range.start * 1e-6,
                            e.time_range.end * 1e-6))
    out.sort(key=lambda x: x[1])
    return out


def kernel_table(events) -> List[Tuple[str, float, int]]:
    """[(name, device seconds, count)] summed by name, longest first."""
    acc: Dict[str, list] = {}
    for name, a, b in events:
        rec = acc.setdefault(name, [0.0, 0])
        rec[0] += b - a
        rec[1] += 1
    return sorted(((n, s, c) for n, (s, c) in acc.items()), key=lambda k: -k[1])


def busy_and_gaps(events, top: int = 10):
    """(busy seconds, the ``top`` longest idle gaps as [(label, seconds)]):
    the union of the activity intervals, and each gap between them labelled
    by the activity that ended it (what the device waited to start)."""
    busy, gaps = 0.0, []
    cur_a = cur_b = None
    for name, a, b in events:
        if cur_b is None:
            cur_a, cur_b = a, b
        elif a > cur_b:
            busy += cur_b - cur_a
            gaps.append((f"before {short_name(name)}", a - cur_b))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        busy += cur_b - cur_a
    gaps.sort(key=lambda g: -g[1])
    return busy, gaps[:top]


def is_copy(name: str) -> bool:
    """Whether a device activity is a copy or a fill, not a kernel: the
    profiler's ``Memcpy ...`` and ``Memset ...``, and the memcpy and memset
    nodes of a CUDA graph captured before the profiler started, which it
    reports by the driver's names (``memset32``, ``memcpy32_post``,
    ``memcpy128``)."""
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def short_name(name: str, limit: int = 120) -> str:
    """A kernel's name without anonymous namespaces and its argument list,
    cut to ``limit``."""
    return name.replace("(anonymous namespace)::", "").split("(")[0][:limit]


def summarize(events, top: int = 10) -> dict:
    """busy_s, kernel table, count, and the breakdown's two lists."""
    busy, gaps = busy_and_gaps(events, top)
    table = kernel_table(events)
    return {
        "busy_s": busy,
        "kernels": table,
        "kernel_count": sum(c for n, _, c in table if not is_copy(n)),
        "device_ops": [[short_name(n), s] for n, s, _ in table[:top]],
        "idle_gaps": [[label, s] for label, s in gaps],
    }
