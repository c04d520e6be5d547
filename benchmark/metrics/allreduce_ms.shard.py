"""Milliseconds of a sharded frame's sum all-reduce on the devices: over
the profiled frames, the mean of the least over the ranks of that frame's
``AllReduce`` kernel time.  The rank that reached the collective last
waited least in it, so its kernel time is the exchange itself.  Reads a
trace with ``ranks`` (loop ``sharded_frames``), each rank with its
all-reduce seconds in each profiled frame (None where its profiler
recorded none: the least is then over the ranks that have one, and a
frame that fewer than two have is left out); nothing without a frame."""

UNIT = "ms"


def per_frame(trace: dict):
    """[[the all-reduce seconds of each rank that has one] for each
    profiled frame that two ranks or more have one for], or None where
    there is none such."""
    ranks = trace.get("ranks")
    if not ranks:
        return None
    frames = [[t for t in f if t is not None]
              for f in zip(*(r["allreduce_s"] for r in ranks))]
    frames = [f for f in frames if len(f) >= 2]
    return frames or None


def read(trace: dict):
    frames = per_frame(trace)
    if frames is None:
        return None
    return 1e3 * sum(min(f) for f in frames) / len(frames)
