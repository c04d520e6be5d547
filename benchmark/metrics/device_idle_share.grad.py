"""Percent of a gradient step's wall time (both passes) in which no
operation ran on the device: busy from the profiled steps, wall from the
same steps unprofiled."""

UNIT = "%"


def read(trace: dict):
    if trace.get("kind") != "grad_steps" or not trace.get("busy_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["wall_s"])
