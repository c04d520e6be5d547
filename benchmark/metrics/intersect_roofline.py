"""The intersector kernels' share of their roofline in a frame: the least
time the card could take for the frame's ray queries (``_roofline.py``,
bound by bytes) over those kernels' device time a frame.  The queries are
counted by the reference on the pixels it checks, scaled to the frame, so
they do not depend on the intersector that runs."""

import importlib.util
import os

UNIT = "%"

_spec = importlib.util.spec_from_file_location(
    "benchmark_metrics__roofline",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "_roofline.py"))
_roofline = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_roofline)


def read(trace: dict):
    if trace.get("kind") != "frames":
        return None
    if "queries_per_frame" not in trace:
        return None
    seconds = sum(s for name, s, _ in trace.get("kernels", ())
                  if _roofline.is_intersector(name))
    if seconds <= 0:
        return None
    least = _roofline.least_seconds(trace["queries_per_frame"],
                                    trace["triangles"])
    return 100.0 * least / (seconds / trace["units"])
