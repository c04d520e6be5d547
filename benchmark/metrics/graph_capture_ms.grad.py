"""Milliseconds a gradient step spends capturing and instantiating CUDA
graphs, forward and backward pass together
(``wavefront.grad_loop_stats()``: ``fwd_capture_s + bwd_capture_s``)."""

UNIT = "ms"


def read(trace: dict):
    stats = trace.get("grad_loop_stats")
    if trace.get("kind") != "grad_steps" or not stats or not (
            stats.get("fwd_graphs") or stats.get("bwd_graphs")):
        return None
    return 1e3 * (stats["fwd_capture_s"] + stats["bwd_capture_s"]) / trace["units"]
