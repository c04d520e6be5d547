"""Device-busy milliseconds of a gradient step's backward pass
(``param_grads``, profiled apart from the forward pass)."""

UNIT = "ms"


def read(trace: dict):
    if trace.get("kind") != "grad_steps" or not trace.get("bwd_busy_s"):
        return None
    return 1e3 * trace["bwd_busy_s"] / trace["units"]
