"""Percent of the lane pool's intersect rows that carried a ray in the
profiled frames: 100 x ``rays`` / ``query_rows`` of
``wavefront.loop_stats()`` (each iteration's combined intersect call has
lanes x (1 + lights) rows, a dead lane's rows parked; ``rays`` is the
dispatches' ray count).  A program without those counters reads nothing."""

UNIT = "%"


def read(trace: dict):
    stats = trace.get("loop_stats")
    if trace.get("kind") != "frames" or not stats or not stats.get("query_rows"):
        return None
    return 100.0 * stats["rays"] / stats["query_rows"]
