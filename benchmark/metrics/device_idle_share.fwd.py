"""Percent of a frame's wall time in which no operation ran on the device:
100 x (1 - busy / wall), busy the union of the device's activity in the
profiled frames, wall the same frames' time unprofiled (the profiler slows
the host, not the device)."""

UNIT = "%"


def read(trace: dict):
    if trace.get("kind") != "frames" or not trace.get("busy_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["wall_s"])
