"""Phase timing with throughput counters."""

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
