"""Ray-primitive intersection, vectorized over lanes (rays x triangles).

Counterpart of ``montecarlopathtracing_tpu/ops/intersect.py``:

* ``ray_triangle_compat``: the reference's plane solve for t plus three
  edge-cross sign agreements, no backface cull, no t range
  (``MTPC/sceneManagement.cpp:316-338``);
* ``ray_triangle_mt``: Moller-Trumbore, no backface cull (modern mode);
* ``barycentric``: the cross-product formula of ``findGarCor``
  (``MTPC/pathTracing.cpp:394-432``).

Every function broadcasts: ray fields (...,3), triangle fields (...,3).
"""

from __future__ import annotations

import torch

from .sampling import cross


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def ray_triangle_compat(origin, direction, p0, p1, p2, geom_n):
    """Reference plane + sign-product test. Returns (hit, t, bary (...,3))."""
    denom = _dot(geom_n, direction)
    t = _dot(p0 - origin, geom_n) / denom  # inf/nan when parallel: rejected
    p = origin + direction * t[..., None]
    c1 = _dot(cross(p1 - p0, p - p0), geom_n)
    c2 = _dot(cross(p2 - p1, p - p1), geom_n)
    c3 = _dot(cross(p0 - p2, p - p2), geom_n)
    hit = (c1 * c2 >= 0) & (c1 * c3 >= 0) & (c2 * c3 >= 0)
    hit &= torch.isfinite(t)
    return hit, t, barycentric(p, p0, p1, p2)


def ray_triangle_mt(origin, direction, p0, p1, p2, geom_n=None):
    """Moller-Trumbore, no backface cull. Returns (hit, t, bary (...,3))."""
    e1 = p1 - p0
    e2 = p2 - p0
    pvec = cross(direction, e2)
    det = _dot(e1, pvec)
    inv_det = 1.0 / det  # inf for degenerate; rejected by isfinite below
    tvec = origin - p0
    u = _dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = _dot(direction, qvec) * inv_det
    t = _dot(e2, qvec) * inv_det
    hit = (u >= 0) & (v >= 0) & (u + v <= 1) & torch.isfinite(t)
    bary = torch.stack([1.0 - u - v, u, v], dim=-1)
    return hit, t, bary


def barycentric(p, p0, p1, p2):
    """findGarCor's cross formula; weights for (p0, p1, p2)."""
    e1 = p2 - p1
    e2 = p0 - p2
    e3 = p1 - p0
    d1 = p - p0
    d2 = p - p1
    d3 = p - p2
    n = cross(e1, e2)
    an = _dot(n, n)
    b0 = _dot(cross(e1, d3), n) / an
    b1 = _dot(cross(e2, d1), n) / an
    b2 = _dot(cross(e3, d2), n) / an
    return torch.stack([b0, b1, b2], dim=-1)


def ray_triangle(origin, direction, p0, p1, p2, geom_n, compat: bool):
    if compat:
        return ray_triangle_compat(origin, direction, p0, p1, p2, geom_n)
    return ray_triangle_mt(origin, direction, p0, p1, p2, geom_n)
