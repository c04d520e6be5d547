"""Percent of the lanes summed by the profiled gradient steps' atlas
gather backward that carried a texel's gradient (a textured hit): 100 x
``atlas_texel_rows`` / ``atlas_rows`` of ``wavefront.grad_loop_stats()``.
The rest hit an untextured material, and the backward sends their rows to
its sentinel; a miss or dead lane counts with the material of the
triangle its fetch clamps to.  A program without those counters, or a
scene whose atlas takes no gradient, reads nothing."""

UNIT = "%"

COUNTERS = ("atlas_rows", "atlas_texel_rows")


def read(trace: dict):
    stats = trace.get("grad_loop_stats")
    if trace.get("kind") != "grad_steps" or not stats \
            or any(k not in stats for k in COUNTERS) or not stats["atlas_rows"]:
        return None
    return 100.0 * stats["atlas_texel_rows"] / stats["atlas_rows"]
