"""Phase timing with throughput counters, and a profiler trace context."""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

from .logging import get_logger

log = get_logger(__name__)


def _sync(result) -> None:
    if isinstance(result, torch.Tensor) and result.is_cuda:
        torch.cuda.synchronize(result.device)


@contextlib.contextmanager
def phase_timer(label: str, work: Optional[float] = None, unit: str = "items"):
    """Wall timer.  Put the phase's output tensor in ``box["result"]`` and the
    timer waits for the card to finish it before reading the clock."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        if "result" in box:
            _sync(box["result"])
        dt = time.perf_counter() - t0
        if work:
            log.info("%s: %.1f ms (%.3e %s/s)", label, dt * 1e3, work / dt, unit)
        else:
            log.info("%s: %.1f ms", label, dt * 1e3)
        box["seconds"] = dt


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """torch.profiler trace of the block, CPU and (when there is a card)
    CUDA activity, written to ``logdir`` as a Chrome trace
    (``trace.json``, view in chrome://tracing or Perfetto).  Counterpart of
    the JAX package's jax.profiler trace context."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    log.info("profiler trace written to %s", path)
