"""Percent of the profiled frames' lane-pool dispatches that replayed only
graphs an earlier dispatch had captured, on a pool kept from it: 100 x
``pool_reuses`` / ``dispatches`` of ``wavefront.loop_stats()``.  A program
without the counter reads nothing."""

UNIT = "%"


def read(trace: dict):
    stats = trace.get("loop_stats")
    if trace.get("kind") != "frames" or not stats \
            or "pool_reuses" not in stats or not stats.get("dispatches"):
        return None
    return 100.0 * stats["pool_reuses"] / stats["dispatches"]
