"""Milliseconds a frame spends capturing and instantiating the lane pool's
CUDA graphs (``wavefront.loop_stats()["capture_s"]``; each dispatch
captures its own)."""

UNIT = "ms"


def read(trace: dict):
    stats = trace.get("loop_stats")
    if trace.get("kind") != "frames" or not stats \
            or not stats.get("graphs"):
        return None
    return 1e3 * stats["capture_s"] / trace["units"]
