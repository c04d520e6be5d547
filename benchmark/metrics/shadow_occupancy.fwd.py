"""Percent of the lane pool's NEE rows that carried a shadow ray in the
profiled frames: 100 x ``shadow_rays`` / ``shadow_rows`` of
``wavefront.loop_stats()`` (each iteration's combined intersect call has
lanes x lights NEE rows; a lane that shades a surface of non-black kd sends
a ray in each of its rows, the other rows are parked).  Read where the
frames have more than one light (lights = shadow_rows / (query_rows -
shadow_rows)): with one light these rows are half of those that
``lane_occupancy.fwd`` reads.  A program without the counters reads
nothing."""

UNIT = "%"


def read(trace: dict):
    stats = trace.get("loop_stats")
    if trace.get("kind") != "frames" or not stats or not stats.get("shadow_rows"):
        return None
    lights = stats["shadow_rows"] / (stats["query_rows"] - stats["shadow_rows"])
    if lights < 2:
        return None
    return 100.0 * stats["shadow_rays"] / stats["shadow_rows"]
