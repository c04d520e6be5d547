"""Brute-force nearest hit: the oracle the cluster intersector is held to.

Counterpart of ``brute_force_intersect`` in
``montecarlopathtracing_tpu/accel/lbvh.py``.  The LBVH build and its walks
are not ported yet (ROADMAP.md item A11).
"""

from __future__ import annotations

import torch

from ..ops.intersect import ray_triangle

BIG = 1e30


def brute_force_intersect(scene, origin, direction, compat: bool = True,
                          block: int = 512):
    """Test every triangle; returns (hit (R,) bool, t (R,) f32, tri (R,) i32).

    Scans triangle blocks to bound the (R, block) live set; ties at equal t
    go to the lowest triangle id.
    """
    tpad = scene.num_tris_padded
    block = min(block, tpad)
    r = origin.shape[0]
    dev = origin.device
    best_t = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    best_tri = torch.full((r,), -1, dtype=torch.int32, device=dev)
    o = origin[:, None, :]
    d = direction[:, None, :]
    for s in range(0, tpad, block):
        sl = slice(s, s + block)
        hit, t, _ = ray_triangle(o, d, scene.v0[sl][None], scene.v1[sl][None],
                                 scene.v2[sl][None], scene.geom_n[sl][None],
                                 compat)
        ok = hit & scene.tri_valid[sl][None, :] & (t > 0)
        t = torch.where(ok, t, torch.full_like(t, BIG))
        tj, j = torch.min(t, dim=1)
        better = tj < best_t
        best_t = torch.where(better, tj, best_t)
        best_tri = torch.where(better, (j + s).to(torch.int32), best_tri)
    return best_tri >= 0, best_t, best_tri
