"""Cluster-culled nearest-hit intersector.

Counterpart of ``montecarlopathtracing_tpu/kernels/cluster.py``.  The
triangle array (in the loader's cluster order) is cut into ``C = T/width``
contiguous clusters.  For each subtile of ``tile`` rays:

1. ``cluster_keys`` slab-tests every cluster AABB against the subtile's rays
   and emits the ascending list of clusters any ray touches;
2. ``cluster_intersect_padded`` tests the subtile's rays against just those
   clusters' triangles, with the reference's plane + edge-sign test or
   Moller-Trumbore, from a per-triangle constant table (16 rows per
   triangle, the ``_R_*`` or ``_M_*`` layout), and keeps the lexicographic
   (t, triangle id) minimum.

Each of the two is a CUDA kernel (``csrc/cluster_keys.cu``,
``csrc/cluster_intersect.cu``) with a plain PyTorch version of the same
signature beside it.  A wrapper runs the plain version only for a tensor on
the CPU; for a CUDA tensor it launches the kernel or raises.  Each wrapper
counts its launches in a ``launches`` attribute.

``cluster_group``, ``cluster_mega`` and ``defer`` are TPU panel-shape
mechanisms: they are accepted (and clamped, for the same padding) but do not
change results.  The front-to-back early exit (``ftb``) belongs to the
chunked large-scene path and is not ported yet (ROADMAP.md item A10).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any

import torch

from ..ops.sampling import cross

BIG = 1e30
_INT_MAX = 2 ** 31 - 1

# Row layout of the per-triangle constant table (16 rows per cluster block),
# compat (plane + edge-sign) variant.
_R_N = 0      # rows 0..2   geometric normal n
_R_KN = 3     # row  3      n . v0
_R_M1 = 4     # rows 4..6   m1 = n x (v1 - v0)
_R_K1 = 7     # row  7      v0 . m1
_R_M2 = 8     # rows 8..10  m2 = n x (v2 - v1)
_R_K2 = 11    # row 11      v1 . m2
_R_M3 = 12    # rows 12..14 m3 = n x (v0 - v2)
_R_K3 = 15    # row 15      v2 . m3

# Moller-Trumbore variant (modern mode); with a per-ray w = o x d:
#     det = -d . n_raw,  t * det = o . n_raw - kn,
#     u * det = w . e2 + d . k_u,  v * det = -w . e1 + d . k_v
_M_N = 0      # rows 0..2   n_raw = e1 x e2
_M_KN = 3     # row  3      v0 . n_raw
_M_E1 = 4     # rows 4..6   e1 = v1 - v0
_M_E2 = 7     # rows 7..9   e2 = v2 - v0
_M_KU = 10    # rows 10..12 k_u = v0 x e2
_M_KV = 13    # rows 13..15 k_v = e1 x v0

# Elements per temporary in the plain versions' blocked loops.
_PLAIN_BLOCK = 1 << 21


@dataclasses.dataclass(frozen=True)
class ClusterAccel:
    """Intersection tables.

    tconst: (C, 16, width) f32 per-cluster triangle constant blocks
            (padding triangles zeroed, so they never hit).
    cmin/cmax: (C, 3) f32 cluster AABBs (padding-only clusters inverted-empty).
    """

    tconst: Any
    cmin: Any
    cmax: Any

    @property
    def num_clusters(self) -> int:
        return self.tconst.shape[0]

    @property
    def width(self) -> int:
        return self.tconst.shape[2]


def build_cluster_accel(scene, width: int = 128, mt: bool = False) -> ClusterAccel:
    """Constant tables from a SceneArrays in cluster order: the compat
    plane + sign constants (``mt=False``, _R_* rows) or the Moller-Trumbore
    constants (``mt=True``, _M_* rows)."""
    t = scene.num_tris_padded
    width = min(width, t)
    valid = scene.tri_valid[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=scene.v0.device)
    v0 = torch.where(valid, scene.v0, zero)
    v1 = torch.where(valid, scene.v1, zero)
    v2 = torch.where(valid, scene.v2, zero)

    if mt:
        e1 = v1 - v0
        e2 = v2 - v0
        n = cross(e1, e2)
        ku = cross(v0, e2)
        kv = cross(e1, v0)
        rows = [n[:, 0], n[:, 1], n[:, 2], torch.sum(v0 * n, dim=-1),
                e1[:, 0], e1[:, 1], e1[:, 2],
                e2[:, 0], e2[:, 1], e2[:, 2],
                ku[:, 0], ku[:, 1], ku[:, 2],
                kv[:, 0], kv[:, 1], kv[:, 2]]
    else:
        n = torch.where(valid, scene.geom_n, zero)
        m1 = cross(n, v1 - v0)
        m2 = cross(n, v2 - v1)
        m3 = cross(n, v0 - v2)
        rows = [n[:, 0], n[:, 1], n[:, 2], torch.sum(n * v0, dim=-1),
                m1[:, 0], m1[:, 1], m1[:, 2], torch.sum(v0 * m1, dim=-1),
                m2[:, 0], m2[:, 1], m2[:, 2], torch.sum(v1 * m2, dim=-1),
                m3[:, 0], m3[:, 1], m3[:, 2], torch.sum(v2 * m3, dim=-1)]
    tconst = (torch.stack(rows, dim=0).reshape(16, t // width, width)
              .permute(1, 0, 2).contiguous())

    vmin = torch.where(valid, torch.minimum(torch.minimum(scene.v0, scene.v1),
                                            scene.v2), BIG)
    vmax = torch.where(valid, torch.maximum(torch.maximum(scene.v0, scene.v1),
                                            scene.v2), -BIG)
    cmin = torch.amin(vmin.reshape(-1, width, 3), dim=1)
    cmax = torch.amax(vmax.reshape(-1, width, 3), dim=1)
    return ClusterAccel(tconst=tconst, cmin=cmin, cmax=cmax)


def _caabb(cmin, cmax):
    """(8, C) rows [minx miny minz maxx maxy maxz 0 0]."""
    c = cmin.shape[0]
    return torch.cat([cmin.T, cmax.T, cmin.new_zeros((2, c))], dim=0).contiguous()


def _check_cuda_inputs(name, **tensors):
    dev = None
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}; every input "
                             "must be on the same CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: inputs span {dev} and {t.device}")
        dev = t.device
    return dev


def _ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


# --------------------------------------------------------------------------
# Kernel 1: candidate keys and ascending candidate lists.
# --------------------------------------------------------------------------

def cluster_keys_plain(rays, caabb, tile: int):
    """Plain PyTorch version of the cluster_keys kernel.

    rays: (R, k >= 6) f32 [ox oy oz dx dy dz ...], R a multiple of ``tile``;
    caabb: (8, C) f32.  Returns (keys (R/tile, C) f32, counts (R/tile,) i32,
    ids (R/tile, C) i32): each subtile's min clamped slab-entry distance per
    cluster (1e30 = no ray hits it; all-parked subtiles, min origin.x > 5e8,
    get 1e30 throughout) and its hit clusters ascending in ids[:, :count]
    (the rest of each row holds the other clusters, ascending).
    """
    n_sub = rays.shape[0] // tile
    c = caabb.shape[1]
    sub = rays[:, :6].reshape(n_sub, tile, 6)
    lo = caabb[0:3].T[None, None]  # (1, 1, C, 3)
    hi = caabb[3:6].T[None, None]
    keys = torch.empty((n_sub, c), dtype=torch.float32, device=rays.device)
    step = max(1, _PLAIN_BLOCK // max(1, tile * c))
    for s0 in range(0, n_sub, step):
        blk = sub[s0:s0 + step]
        o = blk[..., None, 0:3]  # (b, tile, 1, 3)
        inv = 1.0 / blk[..., None, 3:6]
        neg = inv < 0
        near = torch.where(neg, hi, lo)
        far = torch.where(neg, lo, hi)
        tn = (near - o) * inv
        tf = (far - o) * inv
        tn = torch.where(torch.isnan(tn), -torch.inf, tn)
        tf = torch.where(torch.isnan(tf), torch.inf, tf)
        enter = torch.maximum(torch.maximum(tn[..., 0], tn[..., 1]), tn[..., 2])
        exit_ = torch.minimum(torch.minimum(tf[..., 0], tf[..., 1]), tf[..., 2])
        hit = (enter <= exit_) & (exit_ >= 0)
        key = torch.where(hit, torch.clamp(enter, min=0.0), BIG)
        keys[s0:s0 + step] = torch.amin(key, dim=1)
    parked = torch.amin(sub[..., 0], dim=1) > 5e8
    keys = torch.where(parked[:, None], BIG, keys)
    hit = keys < BIG
    iota = torch.arange(c, dtype=torch.int32, device=rays.device).expand(n_sub, c)
    order = torch.sort(torch.where(hit, iota, iota + c), dim=1).values
    ids = torch.where(order >= c, order - c, order)
    counts = hit.sum(dim=1, dtype=torch.int32)
    return keys, counts, ids


def cluster_keys(rays, caabb, tile: int):
    """Candidate keys and lists per ray subtile; see cluster_keys_plain for
    the contract (on the card, ids past each row's count are unwritten)."""
    if rays.device.type == "cpu":
        return cluster_keys_plain(rays, caabb, tile)
    from .build import load

    dev = _check_cuda_inputs("cluster_keys", rays=rays, caabb=caabb)
    if rays.dtype != torch.float32 or caabb.dtype != torch.float32:
        raise TypeError("cluster_keys: rays and caabb must be float32")
    if rays.dim() != 2 or rays.shape[1] < 6 or rays.shape[0] % tile:
        raise ValueError(f"cluster_keys: rays {tuple(rays.shape)} must be "
                         f"(R, >=6) with R a multiple of tile={tile}")
    if caabb.shape[0] != 8 or not 1 <= tile <= 1024:
        raise ValueError("cluster_keys: caabb must be (8, C), tile in [1, 1024]")
    n_sub = rays.shape[0] // tile
    c = caabb.shape[1]
    keys = torch.empty((n_sub, c), dtype=torch.float32, device=dev)
    counts = torch.empty((n_sub,), dtype=torch.int32, device=dev)
    ids = torch.empty((n_sub, c), dtype=torch.int32, device=dev)
    fn = load("cluster_keys")
    with torch.cuda.device(dev):
        err = fn(_ptr(rays), rays.shape[1], n_sub, tile, _ptr(caabb), c,
                 _ptr(keys), _ptr(counts), _ptr(ids),
                 ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"cluster_keys launch failed: CUDA error {err}")
    cluster_keys.launches += 1
    return keys, counts, ids


cluster_keys.launches = 0


# --------------------------------------------------------------------------
# Kernel 2: nearest hit over each subtile's candidate clusters.
# --------------------------------------------------------------------------

def cluster_intersect_padded_plain(rays, counts, ids, tconst, tile: int,
                                   mt: bool = False):
    """Plain PyTorch version of the cluster_intersect kernel.

    rays: (R, 8) [o d cap 0] or, with ``mt``, (R, 16) [o d w cap 0...] f32,
    R = len(counts) * tile; counts (R/tile,) i32 and ids (R/tile, C) i32 from
    cluster_keys; tconst (C, 16, W) f32.  Returns (t (R,) f32, tri (R,) i32):
    the lexicographic (t, tri) minimum over accepted triangles of each ray's
    candidate clusters, (1e30, -1) for a miss.  Every expression keeps the
    TPU kernel's operation order, so the CUDA kernel matches it bit for bit.
    """
    n_sub = counts.shape[0]
    width = tconst.shape[2]
    dev = rays.device
    out_t = torch.full((n_sub, tile), BIG, dtype=torch.float32, device=dev)
    out_i = torch.full((n_sub, tile), -1, dtype=torch.int32, device=dev)
    if n_sub == 0:
        return out_t.reshape(-1), out_i.reshape(-1)
    sub = rays.reshape(n_sub, tile, rays.shape[1])
    kmax = int(counts.max())
    step = max(1, _PLAIN_BLOCK // max(1, tile * kmax * width))
    col = torch.arange(width, dtype=torch.int32, device=dev)
    for s0 in range(0, n_sub, step):
        cnt = counts[s0:s0 + step]
        k = int(cnt.max())
        if k == 0:
            continue
        b = cnt.shape[0]
        used = torch.arange(k, device=dev)[None, :] < cnt[:, None]  # (b, k)
        cid = torch.where(used, ids[s0:s0 + step, :k], 0)
        tc = (tconst[cid.long()].permute(0, 2, 1, 3)
              .reshape(b, 16, 1, k * width))  # rows broadcast over rays
        tri = (cid[:, :, None] * width + col).reshape(b, 1, k * width)
        live = used[:, :, None].expand(b, k, width).reshape(b, 1, k * width)
        ray = sub[s0:s0 + step]
        ox, oy, oz = ray[..., 0:1], ray[..., 1:2], ray[..., 2:3]
        dx, dy, dz = ray[..., 3:4], ray[..., 4:5], ray[..., 5:6]

        def dot(r, ax, ay, az):
            return ax * tc[:, r] + ay * tc[:, r + 1] + az * tc[:, r + 2]

        if mt:
            wx, wy, wz = ray[..., 6:7], ray[..., 7:8], ray[..., 8:9]
            det = -dot(_M_N, dx, dy, dz)
            o_n = dot(_M_N, ox, oy, oz)
            t = (o_n - tc[:, _M_KN]) / det
            au = dot(_M_E2, wx, wy, wz) + dot(_M_KU, dx, dy, dz)
            av = -dot(_M_E1, wx, wy, wz) + dot(_M_KV, dx, dy, dz)
            inside = ((au * det >= 0) & (av * det >= 0)
                      & ((det - au - av) * det >= 0))
        else:
            n_o = dot(_R_N, ox, oy, oz)
            n_d = dot(_R_N, dx, dy, dz)
            t = (tc[:, _R_KN] - n_o) / n_d
            c1 = dot(_R_M1, ox, oy, oz) + t * dot(_R_M1, dx, dy, dz) - tc[:, _R_K1]
            c2 = dot(_R_M2, ox, oy, oz) + t * dot(_R_M2, dx, dy, dz) - tc[:, _R_K2]
            c3 = dot(_R_M3, ox, oy, oz) + t * dot(_R_M3, dx, dy, dz) - tc[:, _R_K3]
            inside = (c1 * c2 >= 0) & (c1 * c3 >= 0) & (c2 * c3 >= 0)
        good = inside & (t > 0) & (t < BIG) & live
        tm = torch.where(good, t, BIG)
        bt = torch.amin(tm, dim=2)  # (b, tile)
        bi = torch.amin(torch.where(good & (tm == bt[..., None]), tri, _INT_MAX),
                        dim=2)
        out_t[s0:s0 + step] = bt
        out_i[s0:s0 + step] = torch.where(bt < BIG, bi, -1)
    return out_t.reshape(-1), out_i.reshape(-1)


def cluster_intersect_padded(rays, counts, ids, tconst, tile: int,
                             mt: bool = False):
    """Nearest hit per ray over its subtile's candidate clusters; see
    cluster_intersect_padded_plain for the contract."""
    if rays.device.type == "cpu":
        return cluster_intersect_padded_plain(rays, counts, ids, tconst, tile, mt)
    from .build import load

    dev = _check_cuda_inputs("cluster_intersect", rays=rays, counts=counts,
                             ids=ids, tconst=tconst)
    if (rays.dtype != torch.float32 or tconst.dtype != torch.float32
            or counts.dtype != torch.int32 or ids.dtype != torch.int32):
        raise TypeError("cluster_intersect: rays/tconst float32, counts/ids int32")
    n_sub = counts.shape[0]
    width = tconst.shape[2]
    if rays.shape != (n_sub * tile, 16 if mt else 8):
        raise ValueError(f"cluster_intersect: rays {tuple(rays.shape)} must be "
                         f"({n_sub * tile}, {16 if mt else 8})")
    if (tconst.dim() != 3 or tconst.shape[1] != 16
            or ids.shape != (n_sub, tconst.shape[0])):
        raise ValueError("cluster_intersect: tconst must be (C, 16, W) and ids "
                         "(n_subtiles, C)")
    if not 1 <= tile <= 1024 or width > 512:
        raise ValueError("cluster_intersect: tile in [1, 1024], width <= 512")
    out_t = torch.empty((n_sub * tile,), dtype=torch.float32, device=dev)
    out_i = torch.empty((n_sub * tile,), dtype=torch.int32, device=dev)
    fn = load("cluster_intersect")
    with torch.cuda.device(dev):
        err = fn(_ptr(rays), rays.shape[1], n_sub, tile, _ptr(counts), _ptr(ids),
                 tconst.shape[0], _ptr(tconst), width, int(mt), _ptr(out_t),
                 _ptr(out_i),
                 ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise RuntimeError(f"cluster_intersect launch failed: CUDA error {err}")
    cluster_intersect_padded.launches += 1
    return out_t, out_i


cluster_intersect_padded.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches so far} for the two kernels of this module."""
    return {"cluster_keys": cluster_keys.launches,
            "cluster_intersect": cluster_intersect_padded.launches}


def reset_launch_counts() -> None:
    cluster_keys.launches = 0
    cluster_intersect_padded.launches = 0


# --------------------------------------------------------------------------
# The intersector.
# --------------------------------------------------------------------------

def pack_rays(origin, direction, mt: bool = False):
    """Kernel ray rows: (R, 8) [o d cap 0], or (R, 16) [o d w cap 0*6] with
    w = o x d when ``mt``.  The cap column (the TPU kernel's front-to-back
    exit cap) is 1e30: uncapped."""
    r = origin.shape[0]
    cap = origin.new_full((r, 1), BIG)
    if mt:
        w = cross(origin, direction)
        return torch.cat([origin, direction, w, cap, origin.new_zeros((r, 6))],
                         dim=1).contiguous()
    return torch.cat([origin, direction, cap, origin.new_zeros((r, 1))],
                     dim=1).contiguous()


def _candidates(rays, cmin, cmax, tile: int):
    """(counts, ids): each subtile's ascending candidate clusters."""
    _, counts, ids = cluster_keys(rays, _caabb(cmin, cmax), tile)
    return counts, ids


def cluster_intersect(accel: ClusterAccel, origin, direction,
                      tile: int = 256, mega: int = 16, group: int = 4,
                      mt: bool = False, defer: bool = True, ftb: bool = False):
    """Nearest-hit query: (hit (R,) bool, t (R,) f32, tri (R,) i32).

    Same result contract as brute_force_intersect (smallest t > 0; a miss is
    t = 1e30, tri = -1); ties between coincident triangles go to the lowest
    triangle id.  ``mt`` selects the Moller-Trumbore test (the accel must be
    built with the matching ``build_cluster_accel(..., mt=...)`` table).
    """
    if ftb:
        raise NotImplementedError(
            "the front-to-back early exit belongs to the chunked large-scene "
            "intersector, not ported yet (ROADMAP.md item A10, kernel B3)")
    r = origin.shape[0]
    tile = min(tile, max(8, r))
    mega = max(1, min(mega, r // tile if r >= tile else 1))
    group = min(max(1, group), accel.num_clusters)
    group = 1 << (group.bit_length() - 1)  # accepted for parity; no effect
    step = tile * mega
    pad = (-r) % step
    if pad:
        # Dummy rays far outside every scene: their candidate lists stay empty.
        origin = torch.cat([origin, origin.new_full((pad, 3), 1e9)])
        direction = torch.cat([direction, direction.new_tensor(
            [[1.0, 0.0, 0.0]]).expand(pad, 3)])
    rays = pack_rays(origin, direction)
    counts, ids = _candidates(rays, accel.cmin, accel.cmax, tile)
    if mt:
        rays = pack_rays(origin, direction, mt=True)
    bt, bi = cluster_intersect_padded(rays, counts, ids, accel.tconst, tile, mt)
    bt, bi = bt[:r], bi[:r]
    hit = bi >= 0
    return hit, torch.where(hit, bt, BIG), bi
