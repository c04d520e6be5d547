"""Percent of a sharded frame that the devices spend waiting for the
slowest rank: 100 x the mean over the ranks of (that rank's ``AllReduce``
kernel time - the least of the ranks') over the frame's unprofiled wall
time, averaged over the profiled frames.  A waiting collective kernel
counts as busy, so the device's idle share cannot show this.  Reads what
``allreduce_ms.shard`` reads, over the same ranks and frames."""

import importlib.util
import os

UNIT = "%"

_spec = importlib.util.spec_from_file_location(
    "benchmark_metrics_allreduce_ms_shard",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "allreduce_ms.shard.py"))
_allreduce = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_allreduce)


def read(trace: dict):
    frames = _allreduce.per_frame(trace)
    if frames is None or not trace.get("wall_s"):
        return None
    wall = trace["wall_s"] / trace["units"]
    waits = [sum(t - min(f) for t in f) / len(f) for f in frames]
    return 100.0 * sum(waits) / len(waits) / wall
