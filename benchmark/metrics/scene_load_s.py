"""Seconds of ``api.load_scene`` on the scene's text (the native parser,
the cluster order, the light CDFs, the atlas, the upload), the benchmark's
span around the call."""

UNIT = "s"


def read(trace: dict):
    return trace.get("spans", {}).get("scene_load_s")
