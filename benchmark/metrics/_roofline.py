"""The intersector's least time a frame, set by the bytes it has to move.

For each ray query the frame needs, its origin and direction (6 float32,
24 bytes) are read once and its hit (a float32 distance and an int32
triangle id, 8 bytes) written once; the scene's triangles (3 vertices of 3
float32, 36 bytes each) are read once a frame.  The bytes over the card's
HBM bandwidth bound the time from below.  The operations are left out: a
count of them that does not depend on how the intersector culls is not
made yet, so this bound is the lower one and the share it gives the lower.
"""

# NVIDIA H100 SXM5 80 GB HBM3 (NVIDIA's data sheet; at its 700 W limit).
HBM_BYTES_PER_S = 3.35e12
RAY_BYTES = 24
HIT_BYTES = 8
TRIANGLE_BYTES = 36

# The intersector's kernels by name: the cluster plans' key and intersect
# kernels, the per-ray walk, and the packet walk's two kernels.
KERNEL_PREFIXES = ("cluster_", "bvh_walk", "walk_thread_per_ray",
                   "walk_rays_per_thread")


def frame_bytes(queries: float, triangles: int) -> float:
    return queries * (RAY_BYTES + HIT_BYTES) + triangles * TRIANGLE_BYTES


def least_seconds(queries: float, triangles: int) -> float:
    return frame_bytes(queries, triangles) / HBM_BYTES_PER_S


def is_intersector(name: str) -> bool:
    s = name.replace("(anonymous namespace)::", "").split("(")[0]
    s = s.split("<")[0].strip().split(" ")[-1].split("::")[-1]
    return s.startswith(KERNEL_PREFIXES)
