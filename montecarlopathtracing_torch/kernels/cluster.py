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
counts its launches in a ``launches`` attribute.  The intersect kernel cuts
a long candidate list over several blocks, which meet in one 64-bit
``atomicMin`` per ray; the wrapper presets those words to the miss and
unpacks them (``_unpack_hits``).

Scenes whose table is past the single-table budget (the plan is the
integrator's, ``wavefront.resolve_plan``) take one of two further paths, both
front to back with an early exit:

* ``cluster_intersect_chunked``: the triangle range cut into K chunks with a
  table each.  A routing slab pass against the K chunk AABBs gives every
  (chunk, ray) an exit cap, -1 where the ray misses the chunk; the key kernel
  runs over all chunks in one launch (``cluster_keys_chunked_ftb``) and
  itself orders each (chunk, subtile)'s candidates by entry key (the packed
  words of ``_ftb_order``, the hits only) and lists the rows that have any;
  ``cluster_intersect_ftb`` starts a block per listed row and tests a row's
  candidates until the next key is past every ray's min(best t, cap); the K
  chunks meet in one join word per ray, the lexicographic (t, global
  triangle id) minimum.
* ``cluster_intersect_hbm``: one table, swizzled into supergroups of ``sg``
  clusters; candidates and the exit work per supergroup.

``cluster_intersect(..., ftb=True)`` is the single-table entry to the same
front-to-back kernel.  The supergroup kernel deals a subtile's 128-column
pieces out to ``HBM_SPLIT`` blocks that share the rays' best hits (and so
the exit bound) through the same join words as the single-table kernel; both
front-to-back kernels start their rows longest candidate list first (the key
kernel's row list is bucketed by count).  The
exit never changes a result: the best hit is an
order-independent lexicographic minimum and a skipped candidate's entry is
beyond every ray's bound.

``cluster_group``, ``cluster_mega`` and ``defer`` are TPU panel-shape
mechanisms: they are accepted (and clamped, for the same padding) but do not
change results.  The Hopper kernels check the exit at their own granularity
(every candidate), not the TPU kernel's stride of 4 panels of ``group``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
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
    """The tensor's device address; a null pointer for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _stream(dev) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)


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
        # "+ 0.0" turns a clamped -0.0 into +0.0 (what a maximum that orders
        # -0 < +0 returns, on the card and in the JAX package), so a key's
        # bits are never negative.
        key = torch.where(hit, torch.clamp(enter, min=0.0) + 0.0, BIG)
        keys[s0:s0 + step] = torch.amin(key, dim=1)
    parked = torch.amin(sub[..., 0], dim=1) > 5e8
    keys = torch.where(parked[:, None], BIG, keys)
    hit = keys < BIG
    iota = torch.arange(c, dtype=torch.int32, device=rays.device).expand(n_sub, c)
    order = torch.sort(torch.where(hit, iota, iota + c), dim=1).values
    ids = torch.where(order >= c, order - c, order)
    counts = hit.sum(dim=1, dtype=torch.int32)
    return keys, counts, ids


# Tables up to this many clusters get their front-to-back order from the key
# kernel (a row's hit words are sorted in shared memory); a wider table's
# keys go through ``torch.sort`` (_ftb_candidates).  kSortMax of
# csrc/cluster_keys.cu.
FUSED_SORT_MAX_CLUSTERS = 2048

# Buckets of the row list (kBuckets of csrc/cluster_rows.cuh), by the least
# candidate count of each: 128 and more, 64-127, ..., 2-3, 1.
_BUCKET_MIN = (128, 64, 32, 16, 8, 4, 2, 1)
FTB_BUCKETS = len(_BUCKET_MIN)


@dataclasses.dataclass(frozen=True)
class FtbCandidates:
    """What the key kernel hands the front-to-back intersect kernels.

    order (rows, C) i32, qkeys (rows, C) f32: each row's first ``count``
        entries are its hit clusters front to back and their quantised-down
        keys, equal to the same entries of _ftb_candidates(keys); the rest
        of a row is unspecified.
    heads (FTB_BUCKETS,) i32, rows (FTB_BUCKETS, n_rows) i32: the row list.
        rows[b, :heads[b]] are the rows whose count falls in bucket b (128
        and more, 64-127, ..., 4-7, 2-3, 1), in no particular order; together
        exactly the rows with count > 0.
    """

    order: Any
    qkeys: Any
    heads: Any
    rows: Any

    @property
    def row_list(self):
        return self.heads, self.rows


def ftb_compact_plain(keys):
    """Plain PyTorch version of the key kernel's fused front-to-back list.

    keys (rows, C) f32 as cluster_keys_plain returns them.  Returns (order
    (rows, C) i32, qkeys (rows, C) f32): only the hits' packed words
    (key bits & ~mask) | id are sorted (a miss takes the largest int); past a
    row's count order is 0 and qkeys 1e30.  The first ``count`` entries of a
    row equal those of _ftb_candidates(keys).
    """
    c = keys.shape[1]
    idb = max(1, (c - 1).bit_length())
    mask = (1 << idb) - 1
    hit = keys < BIG
    iota = torch.arange(c, dtype=torch.int32, device=keys.device)
    words = (keys.contiguous().view(torch.int32) & ~mask) | iota
    packed = torch.sort(torch.where(hit, words, _INT_MAX), dim=1).values
    used = iota[None, :] < hit.sum(dim=1, dtype=torch.int32)[:, None]
    order = torch.where(used, packed & mask, 0)
    qkeys = torch.where(used, (packed & ~mask).view(torch.float32), BIG)
    return order, qkeys


def ftb_row_list_plain(counts):
    """Plain PyTorch version of the key kernel's row list: (heads, rows) as
    FtbCandidates describes them, each bucket's rows ascending."""
    n = counts.shape[0]
    heads = torch.zeros(FTB_BUCKETS, dtype=torch.int32, device=counts.device)
    rows = torch.zeros((FTB_BUCKETS, n), dtype=torch.int32, device=counts.device)
    upper = None
    for b, least in enumerate(_BUCKET_MIN):
        member = counts >= least
        if upper is not None:
            member &= counts < upper
        upper = least
        idx = torch.nonzero(member)[:, 0].to(torch.int32)
        heads[b] = idx.shape[0]
        rows[b, :idx.shape[0]] = idx
    return heads, rows


def listed_rows(heads, rows):
    """The rows of a row list in the order a consumer takes them (bucket by
    bucket), as one (n,) int64 tensor."""
    return torch.cat([rows[b, :int(heads[b])] for b in range(FTB_BUCKETS)]).long()


def _launch_keys(name, rays, chunk_cap, caabb, tile: int, with_keys: bool,
                 with_ids: bool, with_list: bool):
    """Launch the key kernel (entry point ``name``) on CUDA tensors.
    Returns (keys, counts, ids, FtbCandidates), None for what was not asked
    for.  A table past FUSED_SORT_MAX_CLUSTERS gets its row list from the
    kernel and its order from torch.sort over the keys: the rule looks at C
    alone."""
    from .build import load

    more = {} if chunk_cap is None else {"chunk_cap": chunk_cap}
    dev = _check_cuda_inputs(name, rays=rays, caabb=caabb, **more)
    if any(t.dtype != torch.float32 for t in (rays, caabb, *more.values())):
        raise TypeError(f"{name}: inputs must be float32")
    if rays.dim() != 2 or rays.shape[1] < 6 or rays.shape[0] % tile:
        raise ValueError(f"{name}: rays {tuple(rays.shape)} must be (R, >=6) "
                         f"with R a multiple of tile={tile}")
    if not 1 <= tile <= 1024:
        raise ValueError(f"{name}: tile in [1, 1024]")
    chunked = chunk_cap is not None
    if chunked:
        if (caabb.dim() != 3 or caabb.shape[1] != 8 or caabb.shape[0] > 65535
                or chunk_cap.shape != (caabb.shape[0], rays.shape[0])):
            raise ValueError(f"{name}: caabb must be (K <= 65535, 8, C), "
                             "chunk_cap (K, R)")
        k_n = caabb.shape[0]
    else:
        if caabb.dim() != 2 or caabb.shape[0] != 8:
            raise ValueError(f"{name}: caabb must be (8, C)")
        k_n = 1
    c = caabb.shape[-1]
    n_sub = rays.shape[0] // tile
    n_rows = k_n * n_sub
    fused = with_list and c <= FUSED_SORT_MAX_CLUSTERS
    keys = (torch.empty((n_rows, c), dtype=torch.float32, device=dev)
            if with_keys or (with_list and not fused) else None)
    counts = torch.empty((n_rows,), dtype=torch.int32, device=dev)
    ids = (torch.empty((n_rows, c), dtype=torch.int32, device=dev)
           if with_ids else None)
    order = qkeys = heads = wrows = None
    if with_list:
        heads = torch.zeros(FTB_BUCKETS, dtype=torch.int32, device=dev)
        wrows = torch.empty((FTB_BUCKETS, n_rows), dtype=torch.int32, device=dev)
    if fused:
        order = torch.empty((n_rows, c), dtype=torch.int32, device=dev)
        qkeys = torch.empty((n_rows, c), dtype=torch.float32, device=dev)
    fn = load(name)
    outs = (_ptr(order), _ptr(qkeys), _ptr(heads), _ptr(wrows), _stream(dev))
    with torch.cuda.device(dev):
        if chunked:
            err = fn(_ptr(rays), rays.shape[1], n_sub, tile, k_n,
                     _ptr(chunk_cap), _ptr(caabb), c, _ptr(keys), _ptr(counts),
                     *outs)
        else:
            err = fn(_ptr(rays), rays.shape[1], n_sub, tile, _ptr(caabb), c,
                     _ptr(keys), _ptr(counts), _ptr(ids), *outs)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    _WRAPPERS[name].launches += 1
    cand = None
    if with_list:
        if not fused:
            order, qkeys = _ftb_candidates(keys)
        cand = FtbCandidates(order, qkeys, heads, wrows)
    return (keys if with_keys else None), counts, ids, cand


def _plain_candidates(keys, counts):
    return FtbCandidates(*ftb_compact_plain(keys), *ftb_row_list_plain(counts))


def cluster_keys(rays, caabb, tile: int, with_ids: bool = True):
    """Candidate keys and lists per ray subtile; see cluster_keys_plain for
    the contract (on the card, ids past each row's count are unwritten, and
    ids is None when ``with_ids`` is false)."""
    if rays.device.type == "cpu":
        return cluster_keys_plain(rays, caabb, tile)
    return _launch_keys("cluster_keys", rays, None, caabb, tile, True,
                        with_ids, False)[:3]


cluster_keys.launches = 0


def cluster_keys_ftb(rays, caabb, tile: int, with_keys: bool = False):
    """The key kernel with the front-to-back list fused in: (keys or None,
    counts, FtbCandidates).  On the CPU the plain versions
    (cluster_keys_plain, ftb_compact_plain, ftb_row_list_plain).  A table of
    more than FUSED_SORT_MAX_CLUSTERS clusters is ordered by torch.sort over
    the kernel's keys instead; nothing else decides that."""
    if rays.device.type == "cpu":
        keys, counts, _ = cluster_keys_plain(rays, caabb, tile)
        return (keys if with_keys else None), counts, _plain_candidates(keys, counts)
    keys, counts, _, cand = _launch_keys("cluster_keys", rays, None, caabb,
                                         tile, with_keys, False, True)
    return keys, counts, cand


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
    col = torch.arange(width, dtype=torch.int32, device=dev)
    # Subtiles in order of their candidate count, so that a block pads its
    # lists to a count close to each member's own; one read of the counts.
    cnt_sorted, by_count = torch.sort(counts)
    for lo, hi, k in _plain_blocks(cnt_sorted.tolist(), tile * width):
        rows = by_count[lo:hi]
        cnt = cnt_sorted[lo:hi]
        b = hi - lo
        used = torch.arange(k, device=dev)[None, :] < cnt[:, None]  # (b, k)
        cid = torch.where(used, ids[rows, :k], 0)
        tc = (tconst[cid.long()].permute(0, 2, 1, 3)
              .reshape(b, 16, 1, k * width))  # rows broadcast over rays
        tri = (cid[:, :, None] * width + col).reshape(b, 1, k * width)
        live = used[:, :, None].expand(b, k, width).reshape(b, 1, k * width)
        ray = sub[rows]
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
        out_t[rows] = bt
        out_i[rows] = torch.where(bt < BIG, bi, -1)
    return out_t.reshape(-1), out_i.reshape(-1)


def _plain_blocks(counts_ascending, per_candidate: int):
    """Cut subtiles (given by their ascending candidate counts) into blocks
    of at most _PLAIN_BLOCK temporary elements: yields (lo, hi, k) with k the
    block's largest count; subtiles without candidates are left out."""
    n = len(counts_ascending)
    lo = 0
    while lo < n and counts_ascending[lo] == 0:
        lo += 1
    while lo < n:
        hi = lo + 1
        while (hi < n and (hi + 1 - lo) * counts_ascending[hi] * per_candidate
               <= _PLAIN_BLOCK):
            hi += 1
        yield lo, hi, counts_ascending[hi - 1]
        lo = hi


# The intersect kernel's join word: (float32 bits of t) << 32 | triangle id.
# An accepted t is positive, so the words order as (t, id) does, and the
# least word over any split of a subtile's candidates is the subtile's
# result.  The miss (1e30, -1) is the largest word a kernel can meet.
_PACKED_MISS = (0x7149F2CA << 32) | 0xFFFFFFFF

# Blocks a subtile's candidate list is cut over at most.
INTERSECT_SPLIT = 8


def _kernel_outputs(n_split: int, shape, dev):
    """(packed, out_t, out_i) for an intersect launch: join words preset to
    the miss when the blocks of several grid rows meet on a ray, else the
    output arrays that the ray's one block writes."""
    if n_split > 1:
        return torch.full((math.prod(shape),), _PACKED_MISS, dtype=torch.int64,
                          device=dev), None, None
    return (None, torch.empty(shape, dtype=torch.float32, device=dev),
            torch.empty(shape, dtype=torch.int32, device=dev))


def _unpack_hits(packed):
    """(t (R,) f32, tri (R,) i32) from (R,) int64 join words; the miss word
    gives (1e30, -1).  Reads the words as little-endian int32 pairs."""
    words = packed.view(torch.int32).reshape(-1, 2)
    return (words[:, 1].contiguous().view(torch.float32),
            words[:, 0].contiguous())


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
    n_split = max(1, min(INTERSECT_SPLIT, tconst.shape[0]))
    packed, out_t, out_i = _kernel_outputs(n_split, (n_sub * tile,), dev)
    fn = load("cluster_intersect")
    with torch.cuda.device(dev):
        err = fn(_ptr(rays), rays.shape[1], n_sub, tile, _ptr(counts), _ptr(ids),
                 tconst.shape[0], _ptr(tconst), width, int(mt), n_split,
                 _ptr(packed), _ptr(out_t), _ptr(out_i), _stream(dev))
    if err != 0:
        raise RuntimeError(f"cluster_intersect launch failed: CUDA error {err}")
    cluster_intersect_padded.launches += 1
    return (out_t, out_i) if packed is None else _unpack_hits(packed)


cluster_intersect_padded.launches = 0


# --------------------------------------------------------------------------
# Front-to-back candidate order.
# --------------------------------------------------------------------------

def _ftb_order(key, c: int, group: int, mega: int):
    """Front-to-back candidate order from per-(subtile, cluster) entry keys,
    as one int32 sort: a non-negative f32 key keeps its order when viewed as
    int32, its low ceil(log2 c) mantissa bits are replaced by the cluster id,
    and the packed word is sorted.

    Returns (order (rows, c) i32, gkeys (rows / mega, mega, c / group) f32):
    the cluster ids by ascending key, and the key of every ``group``-th one,
    quantised DOWN (clearing low mantissa bits of a non-negative float rounds
    toward zero), so an exit that compares it can only be more conservative.
    Integer work: equal to the JAX package's function bit for bit.
    """
    idb = max(1, (c - 1).bit_length())
    mask = (1 << idb) - 1
    kbits = key.contiguous().view(torch.int32)
    iota = torch.arange(c, dtype=torch.int32, device=key.device)
    packed = torch.sort((kbits & ~mask) | iota, dim=1).values
    order = packed & mask
    gq = (packed & ~mask).view(torch.float32)
    return order, gq[:, ::group].reshape(-1, mega, c // group)


def _ftb_candidates(keys):
    """(order, qkeys) per row of ``keys``: all ids front to back and each
    one's quantised-down key.  The candidates are each row's first
    ``count`` (the key kernels' count of keys < 1e30)."""
    c = keys.shape[1]
    order, qkeys = _ftb_order(keys, c, 1, 1)
    return order, qkeys.reshape(-1, c)


def ftb_needed(bt, cap, counts, qkeys, tile: int):
    """Per row, the number of leading candidates whose quantised key is <=
    the row's bound max over rays of min(bt, cap): the candidates that no
    exact exit can skip once the rays' best distances are ``bt``.  bt, cap
    (rows * tile,); counts (rows,), qkeys (rows, C) ascending.  The bound of
    the final result is a lower limit for every exit; the bound of a partial
    result (from a prefix of the candidates) is an upper one."""
    rows = counts.shape[0]
    bound = torch.amax(torch.minimum(bt, cap).reshape(rows, tile), dim=1)
    j = torch.arange(qkeys.shape[1], device=qkeys.device)[None, :]
    ok = (qkeys <= bound[:, None]) & (j < counts[:, None])
    return ok.sum(dim=1, dtype=torch.int32)


# --------------------------------------------------------------------------
# Kernel 3: candidate keys over a chunk axis, one launch for all chunks.
# --------------------------------------------------------------------------

def _park_rays(rays, cap, mt: bool):
    """The ray rows as one chunk sees them: where cap < 0 the origin moves to
    1e9 (and w = o x d follows, with ``mt``)."""
    moved = (cap < 0)[:, None]
    origin = torch.where(moved, 1e9, rays[:, 0:3])
    out = rays.clone()
    out[:, 0:3] = origin
    if mt:
        out[:, 6:9] = cross(origin, rays[:, 3:6])
    return out


def cluster_keys_chunked_plain(rays, chunk_cap, caabb, tile: int):
    """Plain PyTorch version of the chunked key kernel.

    rays (R, k >= 6) f32, shared by all chunks; chunk_cap (K, R) f32, < 0
    where the ray is parked for the chunk (its origin counts as 1e9);
    caabb (K, 8, C) f32.  Returns (keys (K * R/tile, C) f32, counts
    (K * R/tile,) i32), rows chunk-major: cluster_keys_plain's keys of chunk
    k's table against chunk k's view of the rays.
    """
    keys, counts = [], []
    for k in range(caabb.shape[0]):
        kk, cc, _ = cluster_keys_plain(_park_rays(rays, chunk_cap[k], False),
                                       caabb[k], tile)
        keys.append(kk)
        counts.append(cc)
    return torch.cat(keys), torch.cat(counts)


def cluster_keys_chunked(rays, chunk_cap, caabb, tile: int):
    """Candidate keys of every (chunk, subtile) in one launch; see
    cluster_keys_chunked_plain for the contract."""
    if rays.device.type == "cpu":
        return cluster_keys_chunked_plain(rays, chunk_cap, caabb, tile)
    return _launch_keys("cluster_keys_chunked", rays, chunk_cap, caabb, tile,
                        True, False, False)[:2]


cluster_keys_chunked.launches = 0


def cluster_keys_chunked_ftb(rays, chunk_cap, caabb, tile: int,
                             with_keys: bool = False):
    """cluster_keys_chunked with the front-to-back list fused in: (keys or
    None, counts, FtbCandidates); see cluster_keys_ftb."""
    if rays.device.type == "cpu":
        keys, counts = cluster_keys_chunked_plain(rays, chunk_cap, caabb, tile)
        return (keys if with_keys else None), counts, _plain_candidates(keys, counts)
    keys, counts, _, cand = _launch_keys("cluster_keys_chunked", rays,
                                         chunk_cap, caabb, tile, with_keys,
                                         False, True)
    return keys, counts, cand


# --------------------------------------------------------------------------
# Kernels 4 and 5: nearest hit over front-to-back candidates, early exit.
# --------------------------------------------------------------------------

# Leading candidates the plain versions test first to get a bound.
_PLAIN_FIRST = 2


def _ftb_plain(rays, cap, counts, order, qkeys, tconst, tile: int, mt: bool):
    """Nearest hit over one table's front-to-back candidates in two passes of
    cluster_intersect_padded_plain: the first _PLAIN_FIRST candidates of each
    subtile give a bound, and the second pass tests the prefix that this
    bound cannot exclude (ftb_needed).  Same result as testing every
    candidate, at a fraction of the temporaries."""
    first = torch.clamp(counts, max=_PLAIN_FIRST)
    bt, _ = cluster_intersect_padded_plain(rays, first, order, tconst, tile, mt)
    need = ftb_needed(bt, cap, counts, qkeys, tile)
    return cluster_intersect_padded_plain(rays, need, order, tconst, tile, mt)


def cluster_intersect_ftb_plain(rays, counts, order, qkeys, tconst, tile: int,
                                mt: bool = False, chunk_cap=None, offsets=None):
    """Plain PyTorch version of the front-to-back intersect kernel.

    rays (R, 8) [o d cap 0] or, with ``mt``, (R, 16) [o d w cap 0...] f32,
    shared by all chunks; counts (K * R/tile,) i32, order (K * R/tile, C) i32
    and qkeys (K * R/tile, C) f32 from _ftb_candidates, rows chunk-major;
    tconst (K * C, 16, W) f32.  ``chunk_cap`` (K, R) f32 gives each (chunk,
    ray) its cap and parks the ray for the chunk where it is < 0; without it
    K = 1, the cap is the rays' cap column and no ray is moved.  ``offsets``
    (K,) i32 is each chunk's first global triangle id (0 for every chunk
    without it).  Returns (t (R,) f32, tri (R,) i32): per chunk,
    cluster_intersect_padded_plain's result over each row's first
    ``counts`` candidates, tri made global by the chunk's offset; then the
    lexicographic (t, global tri) minimum over the chunks, in ascending
    chunk order, as the JAX package merges them.
    """
    r = rays.shape[0]
    n_sub = r // tile
    caps = rays[:, 9 if mt else 6][None] if chunk_cap is None else chunk_cap
    c = order.shape[1]
    best_t = rays.new_full((r,), BIG)
    best_i = torch.full((r,), _INT_MAX, dtype=torch.int32, device=rays.device)
    for k in range(caps.shape[0]):
        rows = slice(k * n_sub, (k + 1) * n_sub)
        rays_k = rays if chunk_cap is None else _park_rays(rays, caps[k], mt)
        bt, bi = _ftb_plain(rays_k, caps[k], counts[rows], order[rows],
                            qkeys[rows], tconst[k * c:(k + 1) * c], tile, mt)
        hit = bi >= 0
        off = 0 if offsets is None else offsets[k]
        gi = torch.where(hit, bi + off, _INT_MAX)
        tk = torch.where(hit, bt, BIG)
        better = (tk < best_t) | ((tk == best_t) & (gi < best_i))
        best_t = torch.where(better, tk, best_t)
        best_i = torch.where(better, gi, best_i)
    return best_t, torch.where(best_t < BIG, best_i, -1)


# Blocks a subtile's 128-column pieces are dealt out to, front to back in
# turn, by the supergroup kernel (a supergroup of 4 clusters is four pieces,
# so 16 blocks take the quarters of 4 candidates at a time).  The blocks of a
# subtile share their rays' best hits, and with them the exit bound, through
# the join words.
HBM_SPLIT = 16


def _check_row_list(name, row_list, n_rows: int, dev):
    heads, wrows = row_list
    if (heads.dtype != torch.int32 or wrows.dtype != torch.int32
            or heads.device != dev or wrows.device != dev
            or heads.shape != (FTB_BUCKETS,)
            or wrows.shape != (FTB_BUCKETS, n_rows)
            or not wrows.is_contiguous()):
        raise ValueError(f"{name}: row_list must be (heads ({FTB_BUCKETS},)"
                         f", rows ({FTB_BUCKETS}, {n_rows})) int32 on {dev}")
    return heads, wrows


def _listed_outputs(n_split: int, shape, dev):
    """_kernel_outputs for a launch over a row list: the rows that the list
    leaves out get no block, so the output arrays are preset to the miss
    too."""
    packed, out_t, out_i = _kernel_outputs(n_split, shape, dev)
    if packed is None:
        out_t.fill_(BIG)
        out_i.fill_(-1)
    return packed, out_t, out_i


def _check_ftb_inputs(name, rays, counts, order, qkeys, tconst, tile, mt,
                      k_n, counter, **more):
    dev = _check_cuda_inputs(name, rays=rays, counts=counts, order=order,
                             qkeys=qkeys, tconst=tconst, **more)
    if (rays.dtype != torch.float32 or tconst.dtype != torch.float32
            or qkeys.dtype != torch.float32 or counts.dtype != torch.int32
            or order.dtype != torch.int32):
        raise TypeError(f"{name}: rays/qkeys/tconst float32, counts/order int32")
    if (rays.dim() != 2 or rays.shape[1] != (16 if mt else 8)
            or rays.shape[0] % tile or not 1 <= tile <= 1024):
        raise ValueError(f"{name}: rays {tuple(rays.shape)} must be (R, "
                         f"{16 if mt else 8}), R a multiple of tile={tile} "
                         "in [1, 1024]")
    rows = k_n * (rays.shape[0] // tile)
    if (tconst.dim() != 3 or tconst.shape[1] != 16 or tconst.shape[0] % k_n
            or counts.shape != (rows,)
            or order.shape != (rows, tconst.shape[0] // k_n)
            or qkeys.shape != order.shape):
        raise ValueError(f"{name}: tconst must be (K * C, 16, W), counts "
                         "(K * R/tile,), order and qkeys (K * R/tile, C)")
    cols = tconst.shape[2]
    if cols & (cols - 1):
        raise ValueError(f"{name}: the table's column count {cols} must be a "
                         "power of two")
    if counter is not None and (counter.dtype != torch.int64
                                or counter.numel() < 1
                                or not counter.is_contiguous()
                                or counter.device != dev):
        raise ValueError(f"{name}: counter must be int64 on {dev} (one; a "
                         "measurement build with -DMCPT_COUNT_STATS fills "
                         "kCounters)")
    return dev


def cluster_intersect_ftb(rays, counts, order, qkeys, tconst, tile: int,
                          mt: bool = False, chunk_cap=None, counter=None, *,
                          row_list, offsets=None):
    """Nearest hit per ray over every chunk's front-to-back candidate
    clusters, each (chunk, subtile) stopping once its next candidate's key is
    past every ray's min(best t, cap); see cluster_intersect_ftb_plain for
    the contract.  The chunks meet in one 64-bit join word per ray, (t bits)
    << 32 | global triangle id, so no merge follows.  ``row_list``
    (FtbCandidates.row_list, from the key kernel that made ``counts``) names
    the rows with candidates, longest lists first: it is the order in which
    blocks start, and no row is sorted here.  ``counter`` (int64 on the
    card, or None) receives the number of (subtile, candidate) pairs
    tested."""
    if rays.device.type == "cpu":
        return cluster_intersect_ftb_plain(rays, counts, order, qkeys, tconst,
                                           tile, mt, chunk_cap, offsets)
    from .build import load

    k_n = 1 if chunk_cap is None else chunk_cap.shape[0]
    more = {} if chunk_cap is None else {"chunk_cap": chunk_cap}
    if offsets is not None:
        more["offsets"] = offsets
    dev = _check_ftb_inputs("cluster_intersect_ftb", rays, counts, order, qkeys,
                            tconst, tile, mt, k_n, counter, **more)
    r = rays.shape[0]
    if chunk_cap is not None and (chunk_cap.dtype != torch.float32
                                  or chunk_cap.shape != (k_n, r)):
        raise ValueError("cluster_intersect_ftb: chunk_cap must be (K, R) "
                         "float32")
    if offsets is not None and (offsets.dtype != torch.int32
                                or offsets.shape != (k_n,)):
        raise ValueError("cluster_intersect_ftb: offsets must be (K,) int32")
    heads, wrows = _check_row_list("cluster_intersect_ftb", row_list,
                                   counts.shape[0], dev)
    packed = torch.full((r,), _PACKED_MISS, dtype=torch.int64, device=dev)
    fn = load("cluster_intersect_ftb")
    with torch.cuda.device(dev):
        err = fn(_ptr(rays), rays.shape[1], r // tile, tile, k_n,
                 _ptr(chunk_cap), _ptr(offsets), _ptr(counts), _ptr(order),
                 _ptr(qkeys), _ptr(heads), _ptr(wrows), order.shape[1],
                 _ptr(tconst), tconst.shape[2], int(mt), _ptr(packed),
                 _ptr(counter), _stream(dev))
    if err != 0:
        raise RuntimeError(f"cluster_intersect_ftb launch failed: CUDA error {err}")
    cluster_intersect_ftb.launches += 1
    return _unpack_hits(packed)


cluster_intersect_ftb.launches = 0


def cluster_intersect_hbm_plain(rays, counts, order, qkeys, tconst, tile: int,
                                mt: bool = False):
    """Plain PyTorch version of the supergroup intersect kernel.

    rays (R, 8 | 16) with the cap in column 6 (9 with ``mt``); counts
    (R/tile,) i32, order (R/tile, S) i32 and qkeys (R/tile, S) f32 from
    _ftb_candidates over the supergroup AABBs; tconst (S, 16, sg * W) f32,
    the swizzled table (build_hbm_accel).  Returns (t (R,) f32, tri (R,)
    i32), tri = supergroup * sg * W + column: a global triangle id.
    """
    cap = rays[:, 9 if mt else 6]
    return _ftb_plain(rays, cap, counts, order, qkeys, tconst, tile, mt)


def cluster_intersect_hbm_padded(rays, counts, order, qkeys, tconst, tile: int,
                                 mt: bool = False, counter=None, *, row_list):
    """Nearest hit per ray over front-to-back candidate supergroups, the exit
    checked before each supergroup; see cluster_intersect_hbm_plain for the
    contract and cluster_intersect_ftb for ``row_list`` and ``counter``."""
    if rays.device.type == "cpu":
        return cluster_intersect_hbm_plain(rays, counts, order, qkeys, tconst,
                                           tile, mt)
    from .build import load

    dev = _check_ftb_inputs("cluster_intersect_hbm", rays, counts, order, qkeys,
                            tconst, tile, mt, 1, counter)
    r = rays.shape[0]
    heads, wrows = _check_row_list("cluster_intersect_hbm", row_list,
                                   counts.shape[0], dev)
    packed, out_t, out_i = _listed_outputs(HBM_SPLIT, (r,), dev)
    fn = load("cluster_intersect_hbm")
    with torch.cuda.device(dev):
        err = fn(_ptr(rays), rays.shape[1], r // tile, tile, _ptr(counts),
                 _ptr(order), _ptr(qkeys), _ptr(heads), _ptr(wrows),
                 order.shape[1], _ptr(tconst), tconst.shape[2], int(mt),
                 HBM_SPLIT, _ptr(packed), _ptr(out_t), _ptr(out_i),
                 _ptr(counter), _stream(dev))
    if err != 0:
        raise RuntimeError(f"cluster_intersect_hbm launch failed: CUDA error {err}")
    cluster_intersect_hbm_padded.launches += 1
    return (out_t, out_i) if packed is None else _unpack_hits(packed)


cluster_intersect_hbm_padded.launches = 0

_WRAPPERS = {
    "cluster_keys": cluster_keys,
    "cluster_intersect": cluster_intersect_padded,
    "cluster_keys_chunked": cluster_keys_chunked,
    "cluster_intersect_ftb": cluster_intersect_ftb,
    "cluster_intersect_hbm": cluster_intersect_hbm_padded,
}


def launch_counts() -> dict:
    """{kernel name: launches so far} for the kernels of this module."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


# --------------------------------------------------------------------------
# The intersectors.
# --------------------------------------------------------------------------

def pack_rays(origin, direction, mt: bool = False, t_cap=None):
    """Kernel ray rows: (R, 8) [o d cap 0], or (R, 16) [o d w cap 0*6] with
    w = o x d when ``mt``.  The cap column is the front-to-back exit cap
    ``t_cap`` (R,), 1e30 (uncapped) without one."""
    r = origin.shape[0]
    cap = (origin.new_full((r, 1), BIG) if t_cap is None
           else t_cap.to(origin.dtype)[:, None])
    if mt:
        w = cross(origin, direction)
        return torch.cat([origin, direction, w, cap, origin.new_zeros((r, 6))],
                         dim=1).contiguous()
    return torch.cat([origin, direction, cap, origin.new_zeros((r, 1))],
                     dim=1).contiguous()


def _parked_directions(direction, pad: int):
    """(pad, 3) rows (1, 0, 0) for parked rays, made by fills (no copy from
    the host, which a CUDA graph capture would refuse)."""
    rows = direction.new_zeros((pad, 3))
    rows[:, 0] = 1.0
    return rows


def _shape_and_pad(origin, direction, tile: int, mega: int, t_cap=None):
    """The TPU entry points' shape rules: tile and mega clamped to the ray
    count, the rays padded to a multiple of tile * mega with parked dummies
    (origin 1e9, cap -1) whose candidate lists stay empty.  Returns (origin,
    direction, t_cap, tile)."""
    r = origin.shape[0]
    tile = min(tile, max(8, r))
    mega = max(1, min(mega, r // tile if r >= tile else 1))
    pad = (-r) % (tile * mega)
    if pad:
        origin = torch.cat([origin, origin.new_full((pad, 3), 1e9)])
        direction = torch.cat([direction, _parked_directions(direction, pad)])
        if t_cap is not None:
            t_cap = torch.cat([t_cap, t_cap.new_full((pad,), -1.0)])
    return origin, direction, t_cap, tile


def _result(bt, bi, r: int):
    bt, bi = bt[:r], bi[:r]
    hit = bi >= 0
    return hit, torch.where(hit, bt, BIG), torch.where(hit, bi, -1)


def cluster_intersect(accel: ClusterAccel, origin, direction,
                      tile: int = 256, mega: int = 16, group: int = 4,
                      mt: bool = False, defer: bool = True, ftb: bool = False,
                      t_cap=None):
    """Nearest-hit query: (hit (R,) bool, t (R,) f32, tri (R,) i32).

    Same result contract as brute_force_intersect (smallest t > 0; a miss is
    t = 1e30, tri = -1); ties between coincident triangles go to the lowest
    triangle id.  ``mt`` selects the Moller-Trumbore test (the accel must be
    built with the matching ``build_cluster_accel(..., mt=...)`` table).
    ``ftb`` orders the candidates front to back and stops early (kernel
    cluster_intersect_ftb): identical results; ``t_cap`` (R,) then caps each
    ray's bound (its exit distance from the scene's box, say).
    """
    r = origin.shape[0]
    origin, direction, t_cap, tile = _shape_and_pad(origin, direction, tile,
                                                    mega, t_cap)
    width = accel.width
    ftb = ftb and width & (width - 1) == 0
    rays = pack_rays(origin, direction, t_cap=t_cap)
    caabb = _caabb(accel.cmin, accel.cmax)
    if ftb:
        _, counts, cand = cluster_keys_ftb(rays, caabb, tile)
    else:
        _, counts, ids = cluster_keys(rays, caabb, tile)
    if mt:
        rays = pack_rays(origin, direction, mt=True, t_cap=t_cap)
    if ftb:
        bt, bi = cluster_intersect_ftb(rays, counts, cand.order, cand.qkeys,
                                       accel.tconst, tile, mt,
                                       row_list=cand.row_list)
    else:
        bt, bi = cluster_intersect_padded(rays, counts, ids, accel.tconst, tile,
                                          mt)
    return _result(bt, bi, r)


def candidate_stats(scene, opts, bvh=None):
    """Measured candidate-cluster density: mean candidate clusters per ray
    subtile on (a) the frame's primary tiles and (b) a bounce-like
    wavefront (cosine lobes about the primary hits' normals, sorted by (hit
    cluster, 6-bit direction bin) as the renderer's wavefront sort does),
    and the mix 0.3 primary + 0.7 bounce.  Returns {"candidates_per_ray",
    "primary_cand", "bounce_cand"}, or {"candidates_per_ray": 0.0} when the
    plan is no cluster intersector.  Counterpart of the JAX package's
    candidate_stats (``bvh`` is accepted and unused there too); the key
    kernel counts the candidates on the card, its plain version on the
    CPU."""
    import numpy as np

    from ..integrator.camera import primary_rays
    from ..integrator.wavefront import (_tile_swizzled_ids, resolve_plan,
                                        swizzle_tile)

    kind, width, group = resolve_plan(opts, scene.num_tris_padded)[:3]
    if not (kind or "").startswith("cluster"):
        return {"candidates_per_ray": 0.0}
    dev = scene.v0.device
    accel = build_cluster_accel(scene, width=width)
    caabb = _caabb(accel.cmin, accel.cmax)
    tile, mega = opts.cluster_rays, 16
    h, w = scene.camera.height, scene.camera.width
    ids = _tile_swizzled_ids(h, w, swizzle_tile(opts, scene.num_tris_padded))
    r = min(65536, (len(ids) // (tile * mega)) * (tile * mega))
    # Whole tiles strided across the frame (a contiguous prefix would sample
    # only the top rows), each subtile kept coherent.
    tiles = ids.reshape(-1, tile)
    step = max(1, tiles.shape[0] // (r // tile))
    ids = torch.as_tensor(tiles[::step][: r // tile].reshape(-1).astype(np.int64),
                          device=dev)
    r = int(ids.shape[0])
    o, d = primary_rays(scene.camera, ids)

    def popmean(o, d):
        rays = torch.cat([o, d, o.new_zeros((o.shape[0], 2))], dim=1).contiguous()
        counts = cluster_keys(rays, caabb, tile, with_ids=False)[1]
        return float(counts.to(torch.float64).mean())

    prim = popmean(o, d)

    hit, t, tri = cluster_intersect(accel, o, d, tile=tile, group=group)
    p = (o + d * torch.where(hit, t, torch.ones_like(t))[:, None]).cpu().numpy()
    tri = tri.cpu().numpy()
    gn = scene.geom_n.cpu().numpy()[np.maximum(tri, 0)]
    rng_ = np.random.default_rng(0)
    u = rng_.uniform(size=(r, 2))
    phi, ct = 2 * np.pi * u[:, 0], np.sqrt(u[:, 1])
    st = np.sqrt(1 - ct * ct)
    a = np.where(np.abs(gn[:, :1]) > 0.9, [[0.0, 1.0, 0.0]], [[1.0, 0.0, 0.0]])
    tx = np.cross(gn, a)
    tx /= np.maximum(np.linalg.norm(tx, axis=1, keepdims=True), 1e-9)
    ty = np.cross(gn, tx)
    bd = (tx * (st * np.cos(phi))[:, None] + ty * (st * np.sin(phi))[:, None]
          + gn * ct[:, None]).astype(np.float32)
    # The renderer's 6-bit direction bin (sign and |component| > 0.5 per
    # axis), so the density is that of the wavefront sort's order.
    db = ((bd[:, 0] > 0) * 32 + (bd[:, 1] > 0) * 16 + (bd[:, 2] > 0) * 8
          + (np.abs(bd[:, 0]) > 0.5) * 4 + (np.abs(bd[:, 1]) > 0.5) * 2
          + (np.abs(bd[:, 2]) > 0.5)).astype(int)
    key = np.maximum(tri, 0) // width * 64 + db
    perm = np.argsort(key, kind="stable")
    bounce = popmean(torch.as_tensor(p[perm] + bd[perm] * 0.01, device=dev),
                     torch.as_tensor(bd[perm], device=dev))
    return {"candidates_per_ray": float(0.3 * prim + 0.7 * bounce),
            "primary_cand": float(prim), "bounce_cand": float(bounce)}


# --------------------------------------------------------------------------
# Chunked tables: scenes past the single-table budget.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChunkedClusterAccel:
    """Stacked per-chunk tables.

    tconst: (K*C, 16, width), chunk k's constant blocks at rows
            [k*C, (k+1)*C) (zero rows past a chunk's own clusters: t = 0/0 =
            NaN, never hit).
    cmin/cmax: (K, C, 3) cluster AABBs (padding clusters inverted-empty).
    kmin/kmax: (K, 3) whole-chunk AABBs for ray routing.
    offsets: (K,) i32, chunk k's first global (padded) triangle id.
    caabb: (K, 8, C), the key kernel's view of cmin/cmax, built once.
    """

    tconst: Any
    cmin: Any
    cmax: Any
    kmin: Any
    kmax: Any
    offsets: Any
    caabb: Any

    @property
    def num_chunks(self) -> int:
        return self.cmin.shape[0]

    @property
    def clusters_per_chunk(self) -> int:
        return self.cmin.shape[1]

    @property
    def width(self) -> int:
        return self.tconst.shape[2]


def build_cluster_accel_chunked(scene, width: int, n_chunks: int,
                                mt: bool = False):
    """Cut the (cluster-ordered, padded) triangle range into ``n_chunks``
    width-aligned contiguous chunks and stack their tables.  Chunk k covers
    triangles [offsets[k], offsets[k+1]); the order keeps each chunk
    spatially tight, so a ray's candidates concentrate in few chunks.
    Returns (accel, offsets as a Python list)."""
    t = scene.num_tris_padded
    per = -(-(t // width) // n_chunks) * width
    accels, offsets = [], []
    for k in range(n_chunks):
        a, b = k * per, min((k + 1) * per, t)
        if a >= b:
            break
        sub = dataclasses.replace(
            scene, v0=scene.v0[a:b], v1=scene.v1[a:b], v2=scene.v2[a:b],
            geom_n=scene.geom_n[a:b], tri_valid=scene.tri_valid[a:b])
        accels.append(build_cluster_accel(sub, width=width, mt=mt))
        offsets.append(a)
    # A common C, a multiple of 8 as in the JAX package (so the tables have
    # the same shape); padding clusters are inverted-empty, never candidates.
    c = -(-max(a.num_clusters for a in accels) // 8) * 8

    def padded(x, value):
        extra = x.new_full((c - x.shape[0],) + tuple(x.shape[1:]), value)
        return torch.cat([x, extra])

    tconst = torch.cat([padded(a.tconst, 0.0) for a in accels])
    cmin = torch.stack([padded(a.cmin, BIG) for a in accels])
    cmax = torch.stack([padded(a.cmax, -BIG) for a in accels])
    caabb = torch.cat([cmin.transpose(1, 2), cmax.transpose(1, 2),
                       cmin.new_zeros((len(accels), 2, c))], dim=1).contiguous()
    accel = ChunkedClusterAccel(
        tconst=tconst, cmin=cmin, cmax=cmax,
        kmin=torch.amin(cmin, dim=1), kmax=torch.amax(cmax, dim=1),
        offsets=torch.tensor(offsets, dtype=torch.int32, device=tconst.device),
        caabb=caabb)
    return accel, offsets


def chunk_caps(accel: ChunkedClusterAccel, origin, direction):
    """Routing slab pass against the K chunk AABBs: (K, R) f32, each ray's
    exit distance from each chunk's box, -1 where it misses the box (the ray
    is parked for that chunk).  A NaN slab distance (0 * inf) counts as an
    open axis, as in the key kernel."""
    inv = 1.0 / direction  # (R, 3); +-inf on zero components
    lo = (accel.kmin[:, None] - origin[None]) * inv[None]  # (K, R, 3)
    hi = (accel.kmax[:, None] - origin[None]) * inv[None]
    tn = torch.minimum(lo, hi)
    tf = torch.maximum(lo, hi)
    tn = torch.where(torch.isnan(tn), -torch.inf, tn)
    tf = torch.where(torch.isnan(tf), torch.inf, tf)
    enter = torch.amax(tn, dim=2)
    exit_ = torch.amin(tf, dim=2)
    touch = (enter <= exit_) & (exit_ >= 0)
    return torch.where(touch, exit_, -1.0)


def cluster_intersect_chunked(accel: ChunkedClusterAccel, offsets, origin,
                              direction, tile: int = 256, mega: int = 16,
                              group: int = 4, mt: bool = False):
    """Nearest hit over a chunked accel in two kernel launches (one key
    kernel that also orders the candidates and lists the rows that have any,
    one test kernel, each over all K chunks, whose chunks meet in the
    lexicographic (t, global triangle id) minimum): the single-table
    contract (chunks ascend in triangle id).  ``offsets`` is accepted for
    the JAX package's signature; ``accel.offsets`` is what is used.

    A ray is parked for every chunk whose box it misses, so a (chunk,
    subtile) pair none of whose rays touch the chunk costs one skipped block
    in each kernel.  The rays are not copied per chunk: the (K, R) caps carry
    what differs between the chunks' views of a ray.
    """
    width = accel.width
    if width & (width - 1):
        raise ValueError("the chunked path requires a power-of-two width")
    r = origin.shape[0]
    origin, direction, _, tile = _shape_and_pad(origin, direction, tile, mega)
    cap = chunk_caps(accel, origin, direction)
    rays = pack_rays(origin, direction, mt=mt)
    _, counts, cand = cluster_keys_chunked_ftb(rays, cap, accel.caabb, tile)
    bt, bi = cluster_intersect_ftb(rays, counts, cand.order, cand.qkeys,
                                   accel.tconst, tile, mt, chunk_cap=cap,
                                   row_list=cand.row_list,
                                   offsets=accel.offsets)
    return _result(bt, bi, r)


# --------------------------------------------------------------------------
# Supergroup tables: one table of any size, candidates per supergroup.
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HbmClusterAccel:
    """The swizzled table of the supergroup intersector.

    tconst: (S, 16, sg*width): supergroup s's sg clusters side by side, so
            column c of block s is triangle s*sg*width + c (zero rows past
            the last cluster: never hit).
    caabb: (8, S) supergroup AABBs as the key kernel reads them.
    sgroup: clusters per supergroup.
    """

    tconst: Any
    caabb: Any
    sgroup: int

    @property
    def num_supergroups(self) -> int:
        return self.tconst.shape[0]


def supergroup_size(num_clusters: int, max_s: int = 2048) -> int:
    """Smallest power-of-two supergroup size (at least 4) keeping
    S = C/sg <= max_s."""
    sg = 4
    while -(-num_clusters // sg) > max_s:
        sg *= 2
    return sg


def build_hbm_accel(accel: ClusterAccel, sgroup: int | None = None):
    """Supergroup tables from a single-table accel: per-supergroup AABBs and
    the table swizzled to (S, 16, sg*width), padded with empty clusters to a
    whole number of supergroups."""
    c, width = accel.num_clusters, accel.width
    if width & (width - 1):
        raise ValueError("the supergroup path requires a power-of-two width")
    sg = sgroup or supergroup_size(c)
    s_n = -(-c // sg)
    pad = s_n * sg - c
    cmin = torch.cat([accel.cmin, accel.cmin.new_full((pad, 3), BIG)])
    cmax = torch.cat([accel.cmax, accel.cmax.new_full((pad, 3), -BIG)])
    smin = torch.amin(cmin.reshape(s_n, sg, 3), dim=1)
    smax = torch.amax(cmax.reshape(s_n, sg, 3), dim=1)
    tconst = torch.cat([accel.tconst, accel.tconst.new_zeros((pad, 16, width))])
    tconst = (tconst.reshape(s_n, sg, 16, width).permute(0, 2, 1, 3)
              .reshape(s_n, 16, sg * width).contiguous())
    return HbmClusterAccel(tconst=tconst, caabb=_caabb(smin, smax), sgroup=sg)


def cluster_intersect_hbm(accel, origin, direction, tile: int = 64,
                          mega: int = 16, sgroup: int | None = None,
                          mt: bool = False, t_cap=None):
    """Nearest hit over the supergroup tables; same result contract as
    cluster_intersect.  ``accel`` is an HbmClusterAccel (build it once per
    scene with build_hbm_accel) or a ClusterAccel, from which the supergroup
    tables are built here with ``sgroup``."""
    if isinstance(accel, ClusterAccel):
        accel = build_hbm_accel(accel, sgroup)
    r = origin.shape[0]
    origin, direction, t_cap, tile = _shape_and_pad(origin, direction, tile,
                                                    mega, t_cap)
    rays = pack_rays(origin, direction, t_cap=t_cap)
    _, counts, cand = cluster_keys_ftb(rays, accel.caabb, tile)
    if mt:
        rays = pack_rays(origin, direction, mt=True, t_cap=t_cap)
    bt, bi = cluster_intersect_hbm_padded(rays, counts, cand.order, cand.qkeys,
                                          accel.tconst, tile, mt,
                                          row_list=cand.row_list)
    return _result(bt, bi, r)
