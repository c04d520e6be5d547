"""Device kernels (copies and fills left out) a lane-pool iteration of a
frame: the profiler's count over ``wavefront.loop_stats()["iterations"]``."""

UNIT = "kernels"


def read(trace: dict):
    if trace.get("kind") != "frames":
        return None
    if not trace.get("kernel_count") or not trace.get("iterations"):
        return None
    return trace["kernel_count"] / trace["iterations"]
