"""30-bit 3D Morton codes on integer tensors.

Counterpart of ``montecarlopathtracing_tpu/ops/morton.py`` (reference
``MTPC/morton code.cpp:3-32``): the magic-number bit expansion of
``expandBits``, 10 bits per axis, with the world bounds pinned to [-1, 4]
(``MTPC/morton code.h:6-7``) in compat mode, else the points' own AABB.

PyTorch has no uint32 arithmetic on the CPU, so codes are carried as int64
tensors holding values in [0, 2^30) and masked to 32 bits after each
product, which reproduces uint32 wrap-around exactly.  The loader's
``scene.loader.morton_codes_np`` is the NumPy twin used at load time.
"""

from __future__ import annotations

import torch

# Reference hardcoded world bounds (MTPC/morton code.h:6-7).
COMPAT_MINP = -1.0
COMPAT_MAXP = 4.0

_MASK = 0xFFFFFFFF


def expand_bits(v):
    """Spread the low 10 bits of each value out to every 3rd bit (int64)."""
    v = v.to(torch.int64) & _MASK
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(xyz01):
    """Morton codes (int64) for points normalised to [0,1]^3. xyz01: (N,3)
    float."""
    q = torch.clamp(xyz01.to(torch.float32) * 1024.0, 0.0, 1023.0).to(torch.int64)
    xx = expand_bits(q[..., 0])
    yy = expand_bits(q[..., 1])
    zz = expand_bits(q[..., 2])
    # x in the top bit of each triple, then y, then z (MTPC/morton code.cpp:20).
    return xx * 4 + yy * 2 + zz


def morton_codes(points, lo=None, hi=None, compat_bounds=True):
    """Codes for world-space points (N,3).

    ``compat_bounds=True`` normalises by the hardcoded [-1, 4] box
    (``getMortonCode``, MTPC/morton code.cpp:23-32); otherwise ``lo`` / ``hi``
    default to the points' own AABB.  The normalisation is f32, as in the
    JAX package.
    """
    points = torch.as_tensor(points, dtype=torch.float32)
    if compat_bounds:
        lo = torch.tensor(COMPAT_MINP, dtype=torch.float32, device=points.device)
        hi = torch.tensor(COMPAT_MAXP, dtype=torch.float32, device=points.device)
        normalized = (points - lo) / (hi - lo)
    else:
        lo = (torch.amin(points, dim=0) if lo is None
              else torch.as_tensor(lo, dtype=torch.float32, device=points.device))
        hi = (torch.amax(points, dim=0) if hi is None
              else torch.as_tensor(hi, dtype=torch.float32, device=points.device))
        normalized = (points - lo) / torch.clamp(hi - lo, min=1e-20)
    return morton3d(normalized)


def morton_argsort(points, compat_bounds=True):
    """Stable argsort of points by Morton code (the reference's std::sort over
    faces, MTPC/MTPC.cpp:44 + predicate MTPC/sceneManagement.cpp:311-314).
    Returns (order (N,) int64, codes (N,) int64)."""
    codes = morton_codes(points, compat_bounds=compat_bounds)
    return torch.sort(codes, stable=True).indices, codes
