"""Device kernels (copies and fills left out) of a gradient step, both
passes, a forward lane-pool iteration (``grad_loop_stats()["blocks"]`` x
spp)."""

UNIT = "kernels"


def read(trace: dict):
    if trace.get("kind") != "grad_steps":
        return None
    if not trace.get("kernel_count") or not trace.get("iterations"):
        return None
    return trace["kernel_count"] / trace["iterations"]
