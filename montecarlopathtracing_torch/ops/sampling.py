"""BSDF lobe sampling, Fresnel/refraction, and area-light sampling.

Counterpart of ``montecarlopathtracing_tpu/ops/sampling.py`` (reference
``MTPC/pathTracing.cpp:13-64,77-113,177-200``), vectorized over lanes.
Sampled directions and light sample points are detached: gradients flow
through the weights of a path, never through where it goes.
"""

from __future__ import annotations

import math

import torch

PI = math.pi


def _dot(a, b):
    return torch.sum(a * b, dim=-1, keepdim=True)


def cross(a, b):
    """Cross product over the last axis, broadcasting like jnp.cross."""
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def normalize(v, eps=1e-30):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=eps)


def lobe_frame(axis):
    """Dominant-axis tangent frame about a possibly unnormalized axis.
    Returns (right, axis, front)."""
    ax, ay, az = axis[..., 0], axis[..., 1], axis[..., 2]
    use_x = torch.abs(ax) > torch.abs(ay)
    zero = torch.zeros_like(ax)
    front = torch.where(use_x[..., None],
                        torch.stack([az, zero, -ax], dim=-1),
                        torch.stack([zero, -az, ay], dim=-1))
    front = normalize(front)
    right = cross(axis, front)
    return right, axis, front


def sample_lobe(axis, u_phi, u_theta, is_diffuse, ns):
    """Direction about ``axis``: cosine-weighted where ``is_diffuse``, Phong
    with exponent ``ns`` elsewhere.  Returns a unit direction (detached)."""
    phi = u_phi * (2.0 * PI)
    sin_d = torch.sqrt(u_theta)
    cos_d = torch.sqrt(torch.clamp(1.0 - u_theta, min=0.0))
    cos_s = torch.pow(u_theta, 1.0 / (ns + 1.0))
    sin_s = torch.sqrt(torch.clamp(1.0 - cos_s * cos_s, min=0.0))
    sin_t = torch.where(is_diffuse, sin_d, sin_s)
    cos_t = torch.where(is_diffuse, cos_d, cos_s)
    sx = sin_t * torch.cos(phi)
    sy = cos_t
    sz = sin_t * torch.sin(phi)
    right, up, front = lobe_frame(axis)
    d = right * sx[..., None] + up * sy[..., None] + front * sz[..., None]
    return normalize(d).detach()


def reflect(incoming, normal):
    """r = i - 2 (i.n) n; normal may be unnormalized."""
    return incoming - normal * (2.0 * _dot(incoming, normal))


def schlick_fresnel(n1, n2, cos_in):
    """rf0 + (1-rf0)(1-|cos|)^5."""
    rf0 = ((n1 - n2) / (n1 + n2)) ** 2
    return rf0 + (1.0 - rf0) * torch.pow(1.0 - torch.abs(cos_in), 5.0)


def refract_dir(incoming, normal, eta):
    """Snell refraction. Returns (ok, direction); ok=False means total
    internal reflection."""
    cosi = _dot(incoming, normal)[..., 0]
    cost2 = 1.0 - eta * eta * (1.0 - cosi * cosi)
    ok = cost2 >= 0.0
    safe = torch.sqrt(torch.clamp(cost2, min=0.0))
    d = incoming * eta[..., None] - normal * (eta * cosi + safe)[..., None]
    return ok, d


def pick_light_face(cum_area, total_area, u, pick_total=None):
    """Area-weighted CDF pick within one light.

    cum_area: (F,) cumulative face areas (parse order); u: (R,) uniforms.
    ``pick_total`` is the draw's range: None uses this light's own area;
    compat quirk #4 passes the first light's total area (the reference's
    frozen ``static uniform_real_distribution``).
    Returns ((R,) int64 face index, (R,) bool found).
    """
    rnd = u * (total_area if pick_total is None else pick_total)
    j = torch.searchsorted(cum_area.contiguous(), rnd.contiguous(), right=True)
    found = rnd < total_area
    return torch.clamp(j, 0, cum_area.shape[0] - 1), found


def sample_triangle_point(v0, v1, v2, n0, n1, n2, u1, u2, u3, simplex: bool):
    """Point + interpolated normal on a triangle: simplex weights r_i/sum(r)
    (reference) or the uniform sqrt warp.  Both outputs are detached (light
    geometry is not differentiated)."""
    if simplex:
        s = u1 + u2 + u3
        w0, w1, w2 = u1 / s, u2 / s, u3 / s
    else:
        su = torch.sqrt(u1)
        w0 = 1.0 - su
        w1 = su * (1.0 - u2)
        w2 = su * u2
    x = v0 * w0[..., None] + v1 * w1[..., None] + v2 * w2[..., None]
    n = n0 * w0[..., None] + n1 * w1[..., None] + n2 * w2[..., None]
    return x.detach(), n.detach()
