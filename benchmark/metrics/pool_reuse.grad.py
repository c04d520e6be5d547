"""Percent of the profiled gradient steps' differentiable lane-pool passes,
forward and backward, that replayed only graphs an earlier step had
captured, on a pool kept from it: 100 x (``fwd_pool_reuses`` +
``bwd_pool_reuses``) / (``dispatches`` + ``bwd_passes``) of
``wavefront.grad_loop_stats()``.  A program without those counters reads
nothing."""

UNIT = "%"

COUNTERS = ("fwd_pool_reuses", "bwd_pool_reuses", "bwd_passes", "dispatches")


def read(trace: dict):
    stats = trace.get("grad_loop_stats")
    if trace.get("kind") != "grad_steps" or not stats \
            or any(k not in stats for k in COUNTERS):
        return None
    passes = stats["dispatches"] + stats["bwd_passes"]
    if not passes:
        return None
    return 100.0 * (stats["fwd_pool_reuses"] + stats["bwd_pool_reuses"]) / passes
