"""Wavefront path-tracing integrator: forward and differentiable renders.

Counterpart of ``montecarlopathtracing_tpu/integrator/wavefront.py``: the
reference's recursive ``shade`` (``MTPC/pathTracing.cpp:137-266``) as a
persistent pool of lanes carrying per-lane throughput, with the reference's
event semantics (emitter short-circuit, one NEE sample per light, RR at 0.6,
diffuse/specular/transmission weights, nearest-neighbour textures).

The JAX ``lax.while_loop`` becomes a host loop over blocks of
``_CHECK_EVERY`` iterations, and the termination predicate is read back only
between blocks: an iteration after the pool has drained changes nothing (no
lane is active, none is refilled, nothing is staged), so the film does not
depend on it.  On a CUDA device every forward block after the first replays
a CUDA graph (``_Blocks``), the counterpart of the JAX package's jitted
loop; on the CPU, and inside ``eager()``, the same block function runs op by
op.

Two renderers: the lane pool (``render_pixels_refill``, the default) and the
scan over samples (``render_pixels`` with ``refill=False``, a bounce loop at
full width per sample, ``trace_paths``; ``_ScanFrame``: blocks of bounces,
the drain read between them, graphs captured once a frame).
``differentiable=True`` makes either a function of the scene's material and
light tensors that autograd can take apart: traversal, visibility and the
sampled directions are detached (the JAX package's ``stop_gradient``
points), and the loop runs a static budget in checkpointed blocks.  The
lane pool records its intersect results and sort permutations on the
forward pass and replays them when a block is recomputed for backward, so
its backward launches no intersect kernel; the scan renderer keeps nothing
of a sample and recomputes it whole for backward, recording them there, so
its backward launches the forward's keys and intersects again and holds
one sample's residuals at a time.  The lane pool's blocks, and each
scan-renderer call's samples, are one autograd node
(``_CheckpointedBlocks``, the counterpart of the JAX package's jitted
``lax.scan`` over ``jax.checkpoint``-ed blocks or samples): on a CUDA
device its forward blocks and its backward recompute-and-VJP blocks replay
CUDA graphs too.

A scene whose triangle table is past the single-table budget renders through
the chunked or the supergroup ("HBM") cluster intersector, as
``resolve_plan`` decides; their tables are built once per scene
(``intersector_tables``).  ``intersector="bvh"`` and ``"bvh_perray"`` take
the LBVH walks instead (accel/lbvh.py), as does a chunked plan past its chunk
cap; their tables are the scene's LBVH, passed as ``bvh`` or built here.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import time
import warnings
import weakref

import numpy as np
import torch

from ..accel.lbvh import _WRAPPERS as _WALK_WRAPPERS
from ..accel.lbvh import (build_lbvh, brute_force_intersect, bvh_intersect,
                          packet_intersect)
from ..config import RenderOptions
from ..kernels.cluster import _WRAPPERS as _CLUSTER_WRAPPERS
from ..kernels.cluster import (
    build_cluster_accel,
    build_cluster_accel_chunked,
    build_hbm_accel,
    cluster_intersect,
    cluster_intersect_chunked,
    cluster_intersect_hbm,
)
from ..ops.intersect import barycentric
from ..ops.sampling import (
    PI,
    normalize,
    pick_light_face,
    reflect,
    refract_dir,
    sample_lobe,
    sample_triangle_point,
    schlick_fresnel,
)
from ..scene.types import SCENE_FIELDS, SceneArrays
from ..utils.device import resolve_device
from ..utils.timing import record, span
from . import rng
from .camera import primary_rays

RAY_DIFFUSE = 0
RAY_SPECULAR = 1
RAY_TRANSMISSION = 2
KIND_PRIMARY = -1  # `kind` of a camera segment; bounce segments carry RAY_*.

BIG = 1e30
_I32 = torch.int32


@functools.lru_cache(maxsize=16)
def _tile_swizzled_ids(h: int, w: int, packet_size: int):
    """Pixel ids reordered so every ``packet_size`` consecutive lanes form a
    compact sqrt(P) x sqrt(P) tile; off-image lanes of edge tiles are clamped
    to the tile's last valid pixel (a duplicate id re-renders the identical
    sample).  Host numpy int32 (n_tiles*packet_size,); read-only."""
    ts = int(np.sqrt(packet_size))
    if ts * ts != packet_size or (h < ts and w < ts):
        n = h * w
        n_pad = -(-n // packet_size) * packet_size
        return np.minimum(np.arange(n_pad, dtype=np.int32), n - 1)
    nty, ntx = -(-h // ts), -(-w // ts)
    ty, tx = np.meshgrid(np.arange(nty), np.arange(ntx), indexing="ij")
    iy, ix = np.meshgrid(np.arange(ts), np.arange(ts), indexing="ij")
    yy = np.minimum(ty[:, :, None, None] * ts + iy[None, None], h - 1)
    xx = np.minimum(tx[:, :, None, None] * ts + ix[None, None], w - 1)
    return (yy * w + xx).reshape(-1).astype(np.int32)


@functools.lru_cache(maxsize=64)
def _swizzle_pixel_fn(h: int, w: int, packet_size: int):
    """Arithmetic twin of _tile_swizzled_ids: slot index -> pixel id, with
    exact integer division."""
    ts = int(np.sqrt(packet_size))
    n = h * w
    if ts * ts != packet_size or (h < ts and w < ts):
        return lambda slot: torch.clamp(slot, max=n - 1)
    ntx = -(-w // ts)

    def fn(slot):
        tile, within = slot // (ts * ts), slot % (ts * ts)
        ty, tx = tile // ntx, tile % ntx
        iy, ix = within // ts, within % ts
        yy = torch.clamp(ty * ts + iy, max=h - 1)
        xx = torch.clamp(tx * ts + ix, max=w - 1)
        return yy * w + xx

    return fn


def resolve_intersector(opts: RenderOptions) -> str:
    """'auto' is the cluster intersector on every device: the CUDA kernels on
    the card, their plain PyTorch versions on the CPU.  (The JAX package's
    'auto' is the LBVH packet walk off the TPU.)"""
    kind = "cluster" if opts.intersector == "auto" else opts.intersector
    if kind == "cluster_interpret":
        raise NotImplementedError(
            "intersector='cluster_interpret' is the JAX package's Pallas "
            "interpreter; in this package intersector='cluster' on a CPU "
            "scene runs the kernels' plain PyTorch versions")
    if kind not in ("cluster", "brute", "bvh", "bvh_perray"):
        raise ValueError(f"unknown intersector {opts.intersector!r}")
    return kind


def resolve_plan(opts: RenderOptions, num_tris: int):
    """The intersector that will run for this (options, scene) pair, a
    4-tuple: ('cluster', width, group, n_chunks) for the cluster kernels
    (n_chunks > 1: chunked tables), ('cluster_hbm', 128, group, 1) for the
    supergroup intersector, or (kind, None, None, 1) for 'bvh' (the packet
    walk), 'bvh_perray' and 'brute'.

    The policy is the JAX package's.  A table within the single-table budget
    is one table; past it the triangle range is cut into chunks, unless
    ``large_mode="hbm_always"`` asks for the supergroup intersector; past
    ``max_table_chunks`` chunks, ``large_mode`` "hbm" and "hbm_always" take
    the supergroup intersector, and "chunked" falls back to the LBVH packet
    walk, with a warning when the cluster intersector was asked for by
    name."""
    kind = resolve_intersector(opts)
    if kind != "cluster":
        return kind, None, None, 1
    plan = _cluster_plan(opts, num_tris)
    if plan is not None and (plan[2] == 1 or opts.large_mode != "hbm_always"):
        return kind, plan[0], plan[1], plan[2]
    if opts.large_mode in ("hbm", "hbm_always"):
        g = max(1, (opts.cluster_width * opts.cluster_group) // 128)
        return kind + "_hbm", 128, g, 1
    if opts.intersector != "auto":
        warnings.warn(
            f"intersector={opts.intersector!r} requested but the scene's "
            f"{num_tris} (padded) triangles are past the chunk cap "
            f"(max_table_chunks={opts.max_table_chunks}); falling back to the "
            "LBVH packet walk", stacklevel=2)
    return "bvh", None, None, 1


def swizzle_tile(opts: RenderOptions, num_tris: int) -> int:
    """Pixel-tile granularity for ray coherence (cluster subtiles)."""
    kind = resolve_plan(opts, num_tris)[0]
    return opts.cluster_rays if kind.startswith("cluster") else opts.packet_size


# The JAX package's table budget model: it decides the cluster width, and
# through the loader's matching switch, the triangle order and cluster ids.
# Kept unchanged so both packages cut the same clusters.
_VMEM_TABLE_BUDGET = 10 << 20
_VMEM_CHUNK_BUDGET = 5 << 20


def _tconst_bytes_per_tri(width: int) -> int:
    return 16 * max(width, 128) * 4 // width


def _cluster_plan(opts: RenderOptions, num_tris: int):
    """(width, group, n_chunks) of the cluster tables: the requested width
    while the table fits the budget, width 128 past it, chunked tables past
    that, None past the chunk cap."""
    if num_tris * _tconst_bytes_per_tri(opts.cluster_width) <= _VMEM_TABLE_BUDGET:
        return opts.cluster_width, opts.cluster_group, 1
    if num_tris * _tconst_bytes_per_tri(128) <= _VMEM_TABLE_BUDGET:
        return 128, max(1, (opts.cluster_width * opts.cluster_group) // 128), 1
    n_chunks = -(-num_tris * _tconst_bytes_per_tri(128) // _VMEM_CHUNK_BUDGET)
    if n_chunks <= opts.max_table_chunks:
        return 128, max(1, (opts.cluster_width * opts.cluster_group) // 128), int(n_chunks)
    return None


def intersector_tables(scene, opts: RenderOptions, bvh=None):
    """The tables intersect_any needs for this scene, by plan: a
    ClusterAccel, a ChunkedClusterAccel, an HbmClusterAccel, the LBVH for
    the walks (``bvh`` if given, else built on the scene's device), or None
    for the brute-force oracle.  Build once per scene and pass as
    ``accel``."""
    kind, width, _, n_chunks = resolve_plan(opts, scene.num_tris_padded)
    if kind == "brute":
        return None
    if kind in ("bvh", "bvh_perray"):
        return build_lbvh(scene) if bvh is None else bvh.to(scene.device)
    mt = not opts.compat.plane_sign_triangle_test
    if kind == "cluster_hbm":
        return build_hbm_accel(build_cluster_accel(scene, width=width, mt=mt))
    if n_chunks > 1:
        return build_cluster_accel_chunked(scene, width=width,
                                           n_chunks=n_chunks, mt=mt)[0]
    return build_cluster_accel(scene, width=width, mt=mt)


def intersect_any(scene, bvh, origin, direction, opts: RenderOptions,
                  accel=None):
    """Nearest-hit dispatch (the reference's ray_intersect,
    MTPC/pathTracing.cpp:382): (hit (R,) bool, t (R,) f32, tri (R,) i32).
    ``bvh`` is the scene's LBVH for the walks, or None; ``accel`` takes the
    prebuilt tables (intersector_tables), built here when it is None.
    Traversal is outside the gradient: the rays are detached."""
    origin, direction = origin.detach(), direction.detach()
    compat_tri = opts.compat.plane_sign_triangle_test
    kind, _, group, n_chunks = resolve_plan(opts, scene.num_tris_padded)
    if kind == "brute":
        return brute_force_intersect(scene, origin, direction, compat=compat_tri)
    if accel is None:
        accel = intersector_tables(scene, opts, bvh)
    if kind == "bvh_perray":
        return bvh_intersect(accel, scene, origin, direction, compat=compat_tri)
    if kind == "bvh":
        return packet_intersect(accel, scene, origin, direction,
                                compat=compat_tri, packet_size=opts.packet_size,
                                leaf_width=opts.leaf_width)
    shape = dict(tile=opts.cluster_rays, mega=opts.cluster_mega,
                 mt=not compat_tri)
    if kind == "cluster_hbm":
        return cluster_intersect_hbm(accel, origin, direction, **shape)
    if n_chunks > 1:
        return cluster_intersect_chunked(accel, None, origin, direction,
                                         group=group, **shape)
    return cluster_intersect(accel, origin, direction, group=group, **shape)


def inverse_permutation(perm):
    """``inv`` with ``inv[perm] = arange``: one scatter, no second sort."""
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype, device=perm.device)
    return inv


class _PermutedTake(torch.autograd.Function):
    """``mat[perm]`` for a full permutation ``perm``, whose backward is a row
    gather of the cotangent by the inverse permutation, not the scatter-add
    of index_select's backward (the JAX package's ``_permuted_take``).  The
    inverse is computed once in the forward pass (or passed in) and saved."""

    @staticmethod
    def forward(ctx, mat, perm, inv):
        ctx.save_for_backward(inverse_permutation(perm) if inv is None else inv)
        return mat.index_select(0, perm)

    @staticmethod
    def backward(ctx, ct):
        (inv,) = ctx.saved_tensors
        return ct.index_select(0, inv), None, None


def _permute_rows(perm, f32_fields, int_fields, inv=None):
    """Permute per-lane state with one row gather per payload: every int
    field is packed as int32 columns (bool as 0/1, int64 as two words),
    gathered by ``perm``, and unpacked to its own dtype and shape.  The f32
    fields ride the same payload by bit view, unless one of them needs a
    gradient: then they travel as a payload of their own through
    _PermutedTake (``inv``: perm's inverse, if known)."""
    r = perm.shape[0]
    grad = torch.is_grad_enabled() and any(f.requires_grad for f in f32_fields)
    specs, cols = [], []
    for f in (list(int_fields) if grad else list(f32_fields) + list(int_fields)):
        if f.dtype == torch.bool:
            c = f.to(_I32)
        elif f.dtype in (torch.float32, torch.int64):
            c = f.contiguous().view(_I32)
        else:
            c = f
        c = c.reshape(r, -1)
        specs.append((f.dtype, f.shape, c.shape[1]))
        cols.append(c)
    payload = torch.cat(cols, dim=1).index_select(0, perm)
    out, pos = [], 0
    for dtype, shape, k in specs:
        c = payload[:, pos:pos + k]
        pos += k
        if dtype == torch.bool:
            c = c != 0
        elif dtype in (torch.float32, torch.int64):
            c = c.contiguous().view(dtype)
        out.append(c.reshape(shape))
    if grad:
        payload = _PermutedTake.apply(
            torch.cat([f.reshape(r, -1) for f in f32_fields], dim=1), perm, inv)
        out_f, pos = [], 0
        for f in f32_fields:
            k = f.numel() // r
            out_f.append(payload[:, pos:pos + k].reshape(f.shape))
            pos += k
        return out_f, out
    nf = len(f32_fields)
    return out[:nf], out[nf:]


# Packed material-row columns (see _shading_tables).
_MF_KD = slice(0, 3)
_MF_KS = slice(3, 6)
_MF_EMIT = slice(6, 9)
_MF_NS = 9
_MF_NI = 10
_MF_IS_EMITTER = 11
_MF_HAS_TEX = 12
_MF_TEX_OFF = 13
_MF_TEX_H = 14
_MF_TEX_W = 15


def _shading_tables(scene):
    """Packed per-triangle (T, 24) [v0 v1 v2 n0 n1 n2 uv0 uv1 uv2] and
    per-material (M, 16) shading tables, one row gather per hit."""
    tab = torch.cat([scene.v0, scene.v1, scene.v2, scene.n0, scene.n1, scene.n2,
                     scene.uv0, scene.uv1, scene.uv2], dim=1)
    return tab, _material_table(scene)


def _material_table(scene):
    """_shading_tables' per-material (M, 16) table."""
    f = torch.float32
    return torch.cat([
        scene.kd, scene.ks, scene.emission,
        scene.ns[:, None], scene.ni[:, None],
        scene.is_emitter[:, None].to(f), scene.has_texture[:, None].to(f),
        scene.tex_offset[:, None].to(f), scene.tex_h[:, None].to(f),
        scene.tex_w[:, None].to(f),
    ], dim=1)


class _TableRows(torch.autograd.Function):
    """``table[idx]`` for a table of a few rows that every lane reads (the
    materials).  The forward pass is the plain row gather; the backward
    pass sums the cotangent rows per table row by a one-hot matrix product
    (the JAX package's form for up to 64 materials), past 64 rows 64 table
    rows at a time, rather than by the indexing backward, which sorts the
    indices and serialises on repeats: 6.7 ms a call at 65,536 lanes and six
    materials (profile_torch.py --grad; NVIDIA H100 80GB HBM3, 700 W), or by
    index_add_, whose CUDA kernel adds with atomics in no fixed order, so
    its sums were not reproducible bit for bit."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        if ctx.rows <= 64:
            onehot = torch.nn.functional.one_hot(idx, ctx.rows).to(ct.dtype)
            return onehot.T @ ct, None
        parts = []
        for base in range(0, ctx.rows, 64):
            rows = torch.arange(base, min(base + 64, ctx.rows), device=idx.device)
            onehot = (idx[:, None] == rows[None, :]).to(ct.dtype)
            parts.append(onehot.T @ ct)
        return torch.cat(parts), None


def _material_rows(mtab, mat):
    """Rows of a per-material table (mtab (M, 16) material fields, or the
    (M, 3) emission) by material id: a plain row gather in the forward pass
    (exact in f32, so texture offsets and extents survive unrounded)."""
    return _TableRows.apply(mtab, mat.long())


def _gather_hit(scene, opts, origin, direction, t, tri, tables):
    """Hit record: (p (R,3), pn (R,3) shading normal, matf (R,16) material
    fields, kd (R,3) with the texture applied).  t, the barycentrics and pn
    are detached; matf and kd carry the material gradients."""
    tab, mtab = tables
    tri_c = torch.clamp(tri, min=0).long()
    rowt = tab[tri_c]
    p = origin + direction * t.detach()[:, None]
    bary = barycentric(p, rowt[:, 0:3], rowt[:, 3:6], rowt[:, 6:9]).detach()
    pn = (rowt[:, 9:12] * bary[:, 0:1] + rowt[:, 12:15] * bary[:, 1:2]
          + rowt[:, 15:18] * bary[:, 2:3])
    if not opts.compat.unnormalized_shading_normal:
        pn = normalize(pn)
    pn = pn.detach()
    matf = _material_rows(mtab, scene.mat_id[tri_c])
    kd = matf[:, _MF_KD]

    if scene.atlas.shape[0] > 0:
        # Texture fetch (quirk #8): row from interpolated vt.x, col from
        # vt.y, frac wrap, nearest neighbour, clamped at the high edge.
        row = (rowt[:, 18] * bary[:, 0] + rowt[:, 20] * bary[:, 1]
               + rowt[:, 22] * bary[:, 2])
        col = (rowt[:, 19] * bary[:, 0] + rowt[:, 21] * bary[:, 1]
               + rowt[:, 23] * bary[:, 2])
        h = matf[:, _MF_TEX_H]
        w = matf[:, _MF_TEX_W]
        r = torch.minimum(torch.clamp((row - torch.floor(row)) * h, min=0.0),
                          h - 1).to(_I32)
        c = torch.minimum(torch.clamp((col - torch.floor(col)) * w, min=0.0),
                          w - 1).to(_I32)
        idx = matf[:, _MF_TEX_OFF].to(_I32) + r * w.to(_I32) + c
        # Out-of-range indices (only from miss lanes' non-finite
        # barycentrics) clamp, as an XLA gather does.
        texel = scene.atlas[torch.clamp(idx, 0, scene.atlas.shape[0] - 1).long()]
        kd = torch.where(matf[:, _MF_HAS_TEX:_MF_HAS_TEX + 1] > 0, texel, kd)
    return p, pn, matf, kd


def _nee_prep(scene, opts: RenderOptions, p, pn, kd, u, alive, tables):
    """Per-light NEE shadow rays and visibility-independent contributions.

    Returns (so (L,R,3), dirn (L,R,3), contrib (L,R,3), ok (L,R), dist (L,R),
    smat (L,R), lit (R,)); the shadow rays of lanes that are not ``lit``
    (dead or black-kd lanes) are parked at 1e9.
    """
    compat = opts.compat
    tab, _ = tables
    r = p.shape[0]
    num_lights = scene.num_lights
    if num_lights == 0:
        e3 = p.new_zeros((0, r, 3))
        return e3, e3, e3, alive.new_zeros((0, r)), p.new_zeros((0, r)), \
            torch.zeros((0, r), dtype=_I32, device=p.device), alive.new_zeros((r,))
    pn_len = torch.linalg.vector_norm(pn, dim=-1)
    pick_total = scene.light_total_area[0] if compat.frozen_light_pick else None
    # Quirk #4 fall-through: a not-found pick reuses the previous light's
    # sample (initially a zero face whose material -1 never matches).
    prev_xl = torch.zeros_like(p)
    prev_vnl = torch.zeros_like(p)
    prev_mat = torch.full((r,), -1, dtype=_I32, device=p.device)
    lit = alive & torch.any(kd != 0, dim=-1)
    so_l, dirn_l, contrib_l, ok_l, dist_l, smat_l = [], [], [], [], [], []
    for li in range(num_lights):
        base = rng.N_BASE_SLOTS + 4 * li
        j, found = pick_light_face(scene.light_face_cum_area[li],
                                   scene.light_total_area[li], u[:, base],
                                   pick_total)
        lrow = tab[scene.light_face_tri[li][j].long()]
        xl, vnl = sample_triangle_point(
            lrow[:, 0:3], lrow[:, 3:6], lrow[:, 6:9],
            lrow[:, 9:12], lrow[:, 12:15], lrow[:, 15:18],
            u[:, base + 1], u[:, base + 2], u[:, base + 3],
            simplex=compat.simplex_light_sampling)
        xl = torch.where(found[:, None], xl, prev_xl)
        vnl = torch.where(found[:, None], vnl, prev_vnl)
        smat = torch.where(found, scene.light_mat[li], prev_mat)
        prev_xl, prev_vnl, prev_mat = xl, vnl, smat
        delta = xl - p
        dist_real = torch.linalg.vector_norm(delta, dim=-1)
        dirn = delta / torch.clamp(dist_real, min=1e-30)[:, None]
        so = torch.where(lit[:, None], p + dirn * opts.ray_epsilon, 1e9)

        cos_l = torch.abs(torch.sum(dirn * normalize(vnl), dim=-1))
        kd_dots = torch.sum(dirn * pn, dim=-1)
        dist = torch.clamp(dist_real, min=1.0) if compat.clamp_light_distance \
            else dist_real
        area = scene.light_total_area[li]  # pdf = 1/A of the whole light
        rad = scene.light_radiance[li]
        if compat.double_receiver_cosine:
            cos_r = torch.abs(kd_dots) / torch.clamp(pn_len, min=1e-30)
            geom = cos_l * cos_r / (dist * dist) * area * kd_dots
        else:
            cos_r = kd_dots / torch.clamp(pn_len, min=1e-30)
            geom = cos_l * torch.clamp(cos_r, min=0.0) / (dist * dist) * area
        ok = alive & (kd_dots > 0)
        contrib = kd * rad[None, :] * (geom / PI)[:, None]
        so_l.append(so); dirn_l.append(dirn); contrib_l.append(contrib)
        ok_l.append(ok); dist_l.append(dist_real); smat_l.append(smat)
    return (torch.stack(so_l), torch.stack(dirn_l), torch.stack(contrib_l),
            torch.stack(ok_l), torch.stack(dist_l), torch.stack(smat_l), lit)


def _nee_resolve(scene, opts: RenderOptions, contrib, ok, dist_real, smat,
                 hit_s, t_s, tri_s):
    """Visibility half of NEE from the per-light shadow results ((L,R)
    each).  Returns (R,3) direct light.  Under quirk #5 a shadow ray sees the
    light when its hit's material equals the sampled face's material."""
    compat = opts.compat
    l_dir = contrib.new_zeros(contrib.shape[1:])
    for li in range(scene.num_lights):
        if compat.material_equality_visibility:
            m_s = scene.mat_id[torch.clamp(tri_s[li], min=0).long()]
            vis = hit_s[li] & (m_s == smat[li])
        else:
            vis = (~hit_s[li]) | (t_s[li] + opts.ray_epsilon >= dist_real[li] - 1e-3)
        l_dir = l_dir + torch.where((ok[li] & vis)[:, None], contrib[li], 0.0)
    return l_dir


def _next_ray(scene, opts: RenderOptions, p, pn, matf, kd, incoming, u):
    """Lobe / event selection (nextRay, MTPC/pathTracing.cpp:66-134).
    Returns (origin, direction, ray_type, weight).  The direction and the
    lobe test are detached; the weight (kd, ks or 1) carries gradients."""
    compat = opts.compat
    ni = matf[:, _MF_NI]
    ks = matf[:, _MF_KS]
    cos_in = torch.sum(incoming * pn, dim=-1)
    exiting = cos_in > 0
    normal_r = torch.where(exiting[:, None], -pn, pn)
    n1 = torch.where(exiting, ni, 1.0)
    n2 = torch.where(exiting, 1.0, ni)
    fresnel = schlick_fresnel(n1, n2, cos_in)
    take_refract = (ni > 1.0) & (fresnel < u[:, 1])

    ok_refr, d_refr = refract_dir(incoming, normal_r, n1 / n2)
    d_tir = reflect(incoming, normal_r)
    d_trans = torch.where(ok_refr[:, None], d_refr, d_tir)
    type_trans = torch.where(ok_refr, RAY_TRANSMISSION, RAY_SPECULAR).to(_I32)

    kd_n = torch.linalg.vector_norm(kd.detach(), dim=-1)
    ks_n = torch.linalg.vector_norm(ks.detach(), dim=-1)
    ratio = torch.where(ks_n > 0, kd_n / torch.clamp(ks_n, min=1e-30), torch.inf)
    spec = (ks_n != 0) & (ratio < u[:, 2])
    mirror = reflect(incoming, pn)
    axis = torch.where(spec[:, None], mirror, pn)
    d_lobe = sample_lobe(axis, u[:, 3], u[:, 4], ~spec, matf[:, _MF_NS])
    type_lobe = torch.where(spec, RAY_SPECULAR, RAY_DIFFUSE).to(_I32)

    direction = torch.where(take_refract[:, None], d_trans, d_lobe).detach()
    ray_type = torch.where(take_refract, type_trans, type_lobe)
    # Transmission / TIR rays leave with no offset in compat mode.
    no_eps = take_refract & compat.no_transmission_epsilon
    eps = torch.where(no_eps, 0.0, opts.ray_epsilon).to(p.dtype)
    origin = p + direction * eps[:, None]
    weight = torch.where(
        (ray_type == RAY_TRANSMISSION)[:, None], torch.ones_like(kd),
        torch.where((ray_type == RAY_SPECULAR)[:, None], ks, kd))
    if opts.ns_gradient:
        # Score-function surrogate for the Phong exponent: the lobe direction
        # is the only quantity that depends on Ns, and it is detached.
        # exp(logp - logp.detach()) is exactly 1.0 (the forward pass is
        # bitwise unchanged) with gradient d logp / dNs, where
        # logp = log(Ns + 1) + Ns * log cos(theta) + const at the sampled
        # direction, log cos(theta) = log(u) / (Ns + 1) held fixed.
        ns = matf[:, _MF_NS]
        phong = (ray_type == RAY_SPECULAR) & ~take_refract
        logcos = (torch.log(torch.clamp(u[:, 4], min=1e-12)) / (ns + 1.0)).detach()
        logp = torch.log(ns + 1.0) + ns * logcos
        surrogate = torch.where(phong, torch.exp(logp - logp.detach()), 1.0)
        weight = weight * surrogate[:, None]
    return origin, direction, ray_type, weight


def _should_sort(opts: RenderOptions, num_tris: int) -> bool:
    if opts.sort_rays is not None:
        return opts.sort_rays
    return resolve_plan(opts, num_tris)[0].startswith("cluster")


def _tracks_grad(scene) -> bool:
    """True when autograd is recording and a scene tensor needs a gradient:
    only then does a differentiable render checkpoint and record."""
    return torch.is_grad_enabled() and any(
        getattr(scene, f).requires_grad for f in SCENE_FIELDS)


class _Residuals:
    """A block's results that do not depend on the scene's parameters, for
    ``k_steps`` steps (iterations of the lane pool, bounces of the scan
    renderer): each step's intersect results and sort order with its
    inverse (the JAX package's named residuals ``isect_*`` and
    ``perm_inv``) in fixed buffers, one row per step.  ``mode`` None
    computes them; ``"record"`` computes them and copies them into the
    buffers; ``"replay"`` hands the rows back in place of computing them,
    so a block recomputed for backward launches no intersect kernel and
    sorts nothing.  The buffers (for ``k_steps`` steps of ``n_isect``
    intersected rays and ``n_sort`` sorted lanes; none by default) are made
    up front, outside any capture, and a captured block reads and writes
    them in place.  A step whose rays go to several intersect calls gives
    each call its ``rows`` of the step's row."""

    def __init__(self, k_steps: int = 0, n_isect: int = 0, n_sort: int = 0,
                 dev=None):
        self.mode, self.bufs = None, {}
        if not k_steps:
            return
        self.bufs["isect"] = (
            torch.zeros((k_steps, n_isect), dtype=torch.bool, device=dev),
            torch.zeros((k_steps, n_isect), dtype=torch.float32, device=dev),
            torch.zeros((k_steps, n_isect), dtype=_I32, device=dev))
        if n_sort:
            self.bufs["perm"] = tuple(
                torch.zeros((k_steps, n_sort), dtype=torch.int64, device=dev)
                for _ in range(2))

    def __call__(self, key, fn, rows=slice(None)):
        name, k = key
        if self.mode == "replay":
            return tuple(b[k, rows] for b in self.bufs[name])
        out = fn()
        if self.mode == "record":
            for b, x in zip(self.bufs[name], out):
                b[k, rows].copy_(x)
        return out

    def copies(self, k_steps=None) -> list:
        """Copies of the first ``k_steps`` rows (all by default)."""
        return [b[:k_steps].clone() for bufs in self.bufs.values() for b in bufs]

    def load(self, copies) -> None:
        for b, c in zip((b for bufs in self.bufs.values() for b in bufs), copies):
            b[:c.shape[0]].copy_(c)


def _grad_inputs(scene, tables) -> tuple:
    """The tensors a lane-pool iteration or a scan bounce reads that can
    carry a gradient: the packed triangle and material tables
    (_shading_tables: the vertices, normals, uvs and every material field),
    the texture atlas, and the lights' radiance and total areas (the NEE
    weights).  The lights' CDFs only pick a face, and the integer fields
    carry none."""
    return (*tables, scene.atlas, scene.light_radiance, scene.light_total_area)


def _grad_env(scene, xs):
    """(scene, tables) that read the tensors ``xs`` in _grad_inputs' order."""
    tab, mtab, atlas, radiance, area = xs
    return (dataclasses.replace(scene, atlas=atlas, light_radiance=radiance,
                                light_total_area=area), (tab, mtab))


# The lane state that carries a gradient from one iteration to the next: the
# throughput and the radiance sum.  The pend registers leave a block as its
# outputs and enter the next reset; the ray origins, directions and hit
# distances are detached or built from detached values.
_GRAD_STATE = ("beta", "rad")


def _sort_perm(sort_key, with_inverse: bool):
    """(stable ascending order of sort_key, its inverse or None)."""
    perm = torch.argsort(sort_key, stable=True)
    return perm, inverse_permutation(perm) if with_inverse else None


def _direction_bin(d):
    """6-bit direction bin: sign and |component| > 0.5 per axis."""
    return ((d[:, 0] > 0).to(_I32) * 32 + (d[:, 1] > 0).to(_I32) * 16
            + (d[:, 2] > 0).to(_I32) * 8 + (torch.abs(d[:, 0]) > 0.5).to(_I32) * 4
            + (torch.abs(d[:, 1]) > 0.5).to(_I32) * 2
            + (torch.abs(d[:, 2]) > 0.5).to(_I32))


def trace_paths(scene: SceneArrays, bvh, opts: RenderOptions, keys, origin,
                direction, differentiable: bool = False, accel=None):
    """Full light transport for a batch of primary rays, all lanes in
    lockstep: bounces at full width in blocks of ``_SCAN_BLOCK``, the drain
    read between blocks, up to ``max_depth`` bounces (exactly ``max_depth``
    when ``differentiable``).  One sample of the scan renderer
    (_ScanFrame), from the given rays.

    With sorting on and more lanes than one subtile, each bounce permutes
    the wavefront by (hit cluster, new direction bin) before its NEE and
    bounce rays are intersected; every per-lane quantity rides the
    permutation and ``slot`` unscrambles the radiance at the end.

    Returns (radiance (R,3), n_rays) where n_rays (int64 tensor) counts the
    primaries, one shadow ray per light per live lane and the bounce rays.
    """
    scan = _ScanFrame(scene, bvh, opts, origin.shape[0], differentiable, accel,
                      rays=(keys, origin, direction))
    return scan.render(None, 0, 1)


def render_pixels(scene: SceneArrays, bvh, opts: RenderOptions, pixel_ids,
                  differentiable: bool = False, sample_offset: int = 0,
                  accel=None, scan=None):
    """Mean radiance over ``opts.spp`` samples for flat pixel ids (R,).

    With ``opts.refill`` (the default) this is the lane pool with one lane
    per pixel (render_pixels_refill).  Otherwise the scan over samples runs
    each sample at full width (_ScanFrame: a primary block, bounce blocks,
    the radiance added into the sum); a differentiable render whose scene
    needs a gradient is one autograd node that keeps nothing of its samples
    and recomputes each one for backward (the JAX package's
    ``jax.checkpoint(sample_body)``).  ``scan`` is the _ScanFrame of a
    frame's chunks (made for this scene and these options at this width;
    one is made here when it is None).  ``sample_offset`` slides the absolute sample window, so the
    samples of a split render are those of a one-pass one.

    Returns (mean radiance (R,3), rays traced as an int64 tensor).
    """
    if opts.refill:
        return render_pixels_refill(scene, bvh, opts, pixel_ids, sample_offset,
                                    differentiable=differentiable, accel=accel)
    if scan is None:
        scan = _ScanFrame(scene, bvh, opts, pixel_ids.shape[0], differentiable,
                          accel)
    return scan.render(pixel_ids, sample_offset, opts.spp)


# The launch counters of every kernel wrapper (kernels/cluster.py,
# accel/lbvh.py), which _Blocks keeps right under graph replays.
_COUNTED = (*_CLUSTER_WRAPPERS.values(), *_WALK_WRAPPERS.values())

_eager = False
_loop_stats = dict.fromkeys(("dispatches", "iterations", "idle_iterations",
                             "eager_blocks", "graphs", "replays", "capture_s",
                             "query_rows", "rays", "pool_reuses",
                             "shadow_rows", "shadow_rays"), 0)
_grad_stats = dict.fromkeys(
    ("dispatches", "blocks", "bwd_passes")
    + tuple(f"{p}_{k}" for p in ("fwd", "bwd")
            for k in ("eager_blocks", "graphs", "replays", "capture_s",
                      "pool_reuses")), 0)
_scan_stats = dict.fromkeys(
    ("frames", "calls", "samples", "bounces", "idle_bounces", "residual_bytes")
    + tuple(f"{p}_{k}" for p in ("fwd", "bwd")
            for k in ("eager_blocks", "graphs", "replays", "capture_s")), 0)


@contextlib.contextmanager
def eager():
    """Inside this context the lane pool and the scan renderer run every
    block op by op on the card too, as they do on the CPU, the forward
    frames and both passes of a gradient: the counterpart of ``jax.disable_jit()``, for debugging and
    for recording a frame's kernel calls (a graph replay runs no Python, so
    a wrapper that records its calls would see only the captures)."""
    global _eager
    before, _eager = _eager, True
    try:
        yield
    finally:
        _eager = before


def loop_stats() -> dict:
    """Totals over the forward lane-pool dispatches since the last reset:
    dispatches, iterations, ``idle_iterations`` (iterations that started on
    a drained pool: the last block's overrun), blocks run op by op, CUDA
    graphs captured, graph replays, ``capture_s``, the seconds spent
    capturing and instantiating the graphs, ``query_rows``, the rows of the
    iterations' combined intersect calls (lanes x (1 + lights) each, a dead
    lane's rows parked), ``rays``, the rays those rows carried (the
    dispatches' ray counts): rays over query_rows is the share of rows
    that did work; and ``pool_reuses``, the dispatches that ran no block op
    by op and captured no graph, every block a replay of a graph that an
    earlier dispatch on the same kept pool had captured; ``shadow_rows``,
    the NEE rows of those calls (lanes x lights an iteration), and
    ``shadow_rays``, the shadow rays they carried (a lane that shades a
    surface of non-black kd sends one to each light; the other rows are
    parked): shadow_rays over shadow_rows is the share of NEE rows that
    did work.  Both are read at a dispatch's end with ``rays``."""
    return dict(_loop_stats)


def grad_loop_stats() -> dict:
    """loop_stats' counterpart for the differentiable lane pool, totals since
    the last reset: dispatches (forward passes), blocks of the forward
    passes, ``bwd_passes``, and for the forward (``fwd_``) and the backward
    (``bwd_``) pass apart the blocks run op by op, graphs captured, replays,
    capture seconds and ``pool_reuses``, the passes that ran no block op by
    op and captured no graph, every block a replay of a graph that an
    earlier call on the same kept pool had captured.  A backward pass runs
    each recorded block once, in reverse."""
    return dict(_grad_stats)


def scan_stats() -> dict:
    """Totals over the scan renderer (``refill=False``) since the last
    reset: frames (_ScanFrame sets of graphs made), calls (one per chunk and
    spp step), samples, bounces run in forward passes and ``idle_bounces``
    (bounces that started on a drained wavefront: the last block's overrun,
    and in a differentiable render every bounce past the drain), and for
    the forward (``fwd_``) and the backward (``bwd_``: the recompute and
    the VJP) blocks apart the blocks run op by op, graphs captured, replays
    and capture seconds; ``residual_bytes``, the most bytes of residual
    copies a backward pass held at once (one sample's bounce blocks)."""
    return dict(_scan_stats)


def reset_loop_stats() -> None:
    for stats in (_loop_stats, _grad_stats, _scan_stats):
        for k in stats:
            stats[k] = 0


def _captures(dev) -> bool:
    """Whether the blocks replay CUDA graphs on ``dev``."""
    return dev.type == "cuda" and not _eager


# Graph captures in progress, and the kept entries (_SceneCache) whose scene
# died meanwhile: they are freed when the capture ends.
_capturing = 0
_doomed = []


@contextlib.contextmanager
def _capture_guard():
    """Around a graph capture: a kept entry whose scene dies inside (the
    garbage collector may run there) is freed when the block ends, since
    destroying a graph inside a capture breaks the capture."""
    global _capturing
    _capturing += 1
    try:
        yield
    finally:
        _capturing -= 1
        if not _capturing:
            _doomed.clear()


_CAPTURE_STREAMS = {}


def _capture_stream(dev):
    """The side stream every capture on ``dev`` runs on, one per device.
    The libraries keep state for each stream that ran their calls and never
    free it (cuBLAS's workspace, 32 MiB on an H100, for each stream that
    ran a matrix product), so a stream made for each loop would leave that
    behind every gradient step."""
    dev = torch.device(dev)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[index] = torch.cuda.Stream(index)
    return _CAPTURE_STREAMS[index]


class _CudaGraphs:
    """The CUDA graphs of one lane pool (kept with it from one dispatch to
    the next), of one backward pass or of one scan frame: captured
    on the device's side stream (_capture_stream) into one memory pool.  Every capture frees all it
    allocates before it ends (the block's results are copied into buffers
    made outside the graphs), so the graphs may share the pool in any order
    of replay."""

    def __init__(self, dev):
        self.dev, self.pool = dev, None
        self.stream = _capture_stream(dev)

    def warm_up(self, fn):
        """fn run op by op on the capture stream, ordered after the current
        stream's work and before its next: the first block, which builds and
        loads the kernels and makes each library's state for that stream
        (cuBLAS's workspace among it) before a capture could need it."""
        current = torch.cuda.current_stream(self.dev)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            fn()
        current.wait_stream(self.stream)

    def capture(self, fn):
        """fn's CUDA work as a graph, instantiated; nothing runs.  Whatever
        fn launches on the capture stream is captured, the autograd engine's
        backward kernels included (they run on the stream of their forward
        op)."""
        graph = torch.cuda.CUDAGraph()
        with _capture_guard(), torch.cuda.device(self.dev), torch.cuda.graph(
                graph, pool=self.pool, stream=self.stream,
                capture_error_mode="thread_local"):
            fn()
        self.pool = graph.pool()
        return graph


class _Blocks:
    """Runs a lane-pool loop body ``block(i0)`` (a block of iterations on
    fixed state buffers, starting at iteration i0) one block at a time.

    On the CPU, and on the card inside ``eager()``, a block runs op by op.
    On the card the first block does too, on the capture stream: it builds
    and loads the kernels at first use, reads the tables' cached host values
    (``BVHArrays.finite``) and makes the libraries' per-stream state, none
    of which may happen under capture.  Every later block replays a CUDA
    graph, one for each flush phase (``i0 % flush_every`` fixes where the
    block flushes), captured when its phase first comes up.  Errors in a
    capture or a replay are raised: no block falls back to running op by
    op.

    A capture runs the block's Python once and launches nothing, and a
    replay runs no Python.  So the launches the kernel wrappers count during
    a capture are taken off their counters again and added on every replay:
    ``launch_counts()`` reads the same in both modes.  ``stats`` and
    ``prefix`` name the counters this loop adds to; ``graphs`` (a
    _CudaGraphs) lets several loops capture into one pool."""

    def __init__(self, block, dev, flush_every: int, stats: dict,
                 prefix: str = "", graphs=None):
        self.block, self.flush_every = block, flush_every
        self.stats, self.prefix = stats, prefix
        if graphs is None and _captures(dev):
            graphs = _CudaGraphs(dev)
        self.graphs = graphs
        self.warm = False
        self.replays = {}  # flush phase -> (graph, launches per replay)

    def _add(self, key: str, n=1) -> None:
        self.stats[self.prefix + key] += n

    @contextlib.contextmanager
    def one_pass(self):
        """Around one pass over these blocks: counts it in ``pool_reuses``
        when it ran no block op by op and captured no graph."""
        keys = [self.prefix + k for k in ("eager_blocks", "graphs")]
        before = [self.stats[k] for k in keys]
        yield
        self._add("pool_reuses", [self.stats[k] for k in keys] == before)

    def run(self, i0: int) -> None:
        if not self.warm:
            with span("eager_block"):
                if self.graphs is None:
                    self.block(i0)
                else:
                    self.graphs.warm_up(lambda: self.block(i0))
                    self.warm = True
            self._add("eager_blocks")
            return
        phase = i0 % self.flush_every
        if phase not in self.replays:
            before = [w.launches for w in _COUNTED]
            t0 = time.monotonic_ns()
            graph = self.graphs.capture(lambda: self.block(i0))
            t1 = time.monotonic_ns()
            self._add("capture_s", (t1 - t0) * 1e-9)
            record("capture", t0, t1, {"phase": phase})
            self._add("graphs")
            self.replays[phase] = graph, [w.launches - n for w, n
                                          in zip(_COUNTED, before)]
            for w, n in zip(_COUNTED, before):
                w.launches = n
        graph, launches = self.replays[phase]
        with span("replay"):
            graph.replay()
        for w, n in zip(_COUNTED, launches):
            w.launches += n
        self._add("replays")


class _Backward:
    """The backward passes of a checkpointed loop (_CheckpointedBlocks)
    whose inputs are ``xs`` (in _grad_inputs' order) and whose state
    buffers are ``state``: for each mask ``needs`` of the inputs that need
    a gradient, made at its first pass, the leaves (the inputs detached:
    the same storage), the (scene, tables) that read them, ``wrt`` (the
    leaves that need a gradient) and their gradients' accumulators; the
    cotangents ``ct_state`` of the state's _GRAD_STATE entries; and the
    reverse loop.  A captured VJP reads them by address."""

    def __init__(self, scene, xs, state):
        self.scene, self.xs = scene, xs
        self.ct_state = {f: torch.zeros_like(state[f]) for f in _GRAD_STATE}
        self.masks = {}

    def mask(self, needs) -> None:
        """Makes the mask ``needs``'s leaves at its first pass; zeroes its
        accumulators and ``ct_state``."""
        if needs not in self.masks:
            leaves = [x.detach().requires_grad_(n) for x, n in zip(self.xs, needs)]
            wrt = [x for x in leaves if x.requires_grad]
            self.masks[needs] = (_grad_env(self.scene, leaves), wrt,
                                 [torch.zeros_like(x) for x in wrt])
        with torch.no_grad():
            for x in self.masks[needs][2] + list(self.ct_state.values()):
                x.zero_()

    def vjp(self, block, state, needs) -> None:
        """One block's VJP: ``block(st, env)`` recomputed under autograd
        with the mask's ``env`` on a copy of ``state`` whose _GRAD_STATE
        entries are fresh leaves (it replaces the copy's entries and
        returns its other (output, cotangent) pairs), and the gradients
        taken for those pairs and the exit state's cotangents ``ct_state``,
        which become the entry state's, in place; the gradients of ``wrt``
        are added into the accumulators."""
        env, wrt, acc = self.masks[needs]
        ct_state = self.ct_state
        with torch.enable_grad():
            st = dict(state)
            entry = [st[f].detach().requires_grad_() for f in _GRAD_STATE]
            st.update(zip(_GRAD_STATE, entry))
            pairs = list(block(st, env)) + [(st[f], ct_state[f])
                                            for f in _GRAD_STATE]
            pairs = [(o, c) for o, c in pairs if o.requires_grad]
            grads = (torch.autograd.grad(
                [o for o, _ in pairs], entry + wrt, [c for _, c in pairs],
                allow_unused=True) if pairs else [None] * (len(entry) + len(wrt)))
        for f, g in zip(_GRAD_STATE, grads):
            if g is None:
                ct_state[f].zero_()
            else:
                ct_state[f].copy_(g)
        for a, g in zip(acc, grads[len(_GRAD_STATE):]):
            if g is not None:
                a.add_(g)

    def reverse(self, state, res, entries, saved, vjp) -> None:
        """The recorded blocks, the last first: block i's entry state
        (``entries``) copied back into ``state``, its residuals (``saved``)
        loaded into ``res`` to be replayed, and its VJP ``vjp(i)`` run.
        Each block's copies go as soon as they are loaded."""
        res.mode = "replay"
        while entries:
            for k, v in entries.pop().items():
                state[k].copy_(v)
            res.load(saved.pop())
            vjp(len(entries))
        res.mode = None

    def grads(self, needs) -> list:
        """Copies of the mask's gradients, None where ``needs`` is false."""
        acc = iter(self.masks[needs][2])
        return [next(acc).clone() if n else None for n in needs]


class _CheckpointedBlocks(torch.autograd.Function):
    """A differentiable render's blocks as one autograd node, the tensors of
    _grad_inputs its inputs: one call of the lane pool's gradient loop (a
    _GradCall, the film its output) or the samples of one scan-renderer
    call (a _ScanCall, the sum of their radiance its output).
    ``call.forward`` and ``call.backward`` are its two passes.  Between
    them it holds no activation: the lane pool's blocks' entry states and
    named residuals (the JAX package's ``save_only_these_names``), and of a
    scan call only which samples to redo (its
    ``jax.checkpoint(sample_body)``)."""

    @staticmethod
    def forward(ctx, call, *inputs):
        ctx.call = call
        return call.forward()

    @staticmethod
    def backward(ctx, ct):
        return (None, *ctx.call.backward(ct, ctx.needs_input_grad[1:]))


_SCAN_BLOCK = 8  # bounces of a scan block, between two reads of the drain


class _ScanFrame:
    """The scan renderer (``refill=False``) on ``r`` lanes: the counterpart
    of the JAX package's jitted ``lax.map`` over pixel chunks, ``lax.scan``
    over samples and ``lax.while_loop`` over bounces.  One frame serves
    every chunk of a render_image_stats or render_image_host_chunked call
    (all of one width), so its graphs are captured once a frame.

    A sample runs on fixed state buffers: a primary block (the camera rays
    of the pixel ids ``pix`` at the sample index ``samp``, or the rays
    given to trace_paths; their intersect; the emitter term), bounce blocks
    of ``_SCAN_BLOCK`` bounces (the last cut at ``max_depth``), and a
    finish block that adds the unscrambled radiance and the ray count into
    ``acc`` and ``rays``.  The pixel ids and the sample index are device
    buffers filled between blocks, and the bounce depth a device buffer
    that each bounce advances: no graph holds a Python int that changes
    between its replays.  A forward render reads the drain between bounce
    blocks (a bounce past it changes nothing: it adds +0.0 and 0 rays, and
    the stable sort of all-parked keys is the identity); a differentiable
    one runs exactly ``max_depth`` bounces a sample, and when the scene
    needs a gradient each call is one autograd node (_CheckpointedBlocks
    over a _ScanCall) that recomputes each sample in backward, recording
    its residuals there.

    On a CUDA device each kind of block (primary, bounce block, last bounce
    block, finish; backward: the recompute that records and the VJP) runs
    op by op the first time and replays one CUDA graph after (``_Blocks``),
    all in one pool; on the CPU, and inside ``eager()``, every block runs
    op by op."""

    def __init__(self, scene, bvh, opts: RenderOptions, r: int,
                 differentiable: bool, accel=None, rays=None):
        dev = scene.device
        self.scene, self.bvh, self.opts, self.r, self.dev = (scene, bvh, opts,
                                                             r, dev)
        self.accel = intersector_tables(scene, opts, bvh) if accel is None else accel
        self.differentiable = differentiable
        self.track = differentiable and _tracks_grad(scene)
        self.tables = _shading_tables(scene)
        self.inputs = _grad_inputs(scene, self.tables)
        self.n_slots = rng.n_bounce_slots(scene.num_lights)
        self.do_sort = (_should_sort(opts, scene.num_tris_padded)
                        and r > opts.cluster_rays)
        self.sizes = [_SCAN_BLOCK] * (opts.max_depth // _SCAN_BLOCK)
        if opts.max_depth % _SCAN_BLOCK:
            self.sizes.append(opts.max_depth % _SCAN_BLOCK)
        self.given = None if rays is None else tuple(x.detach() for x in rays)
        i64 = dict(dtype=torch.int64, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        i32 = dict(dtype=_I32, device=dev)
        self.pix = None
        self.samp = torch.zeros((), **i64)
        self.iota = torch.arange(r, **i32)
        self.state = dict(
            keys=torch.zeros((r, 2), **i64), origin=torch.zeros((r, 3), **f32),
            direction=torch.zeros((r, 3), **f32),
            alive=torch.zeros((r,), dtype=torch.bool, device=dev),
            t=torch.zeros((r,), **f32), tri=torch.zeros((r,), **i32),
            beta=torch.zeros((r, 3), **f32), rad=torch.zeros((r, 3), **f32),
            slot=torch.zeros((r,), **i32), n_rays=torch.zeros((), **i64),
            depth=torch.zeros((), **i64), live=torch.zeros((), **i64),
            acc=torch.zeros((r, 3), **f32), rays=torch.zeros((), **i64))
        if self.track:
            self.res_p = _Residuals(1, r, 0, dev)
            self.res_b = _Residuals(_SCAN_BLOCK, r * (1 + scene.num_lights),
                                    r if self.do_sort else 0, dev)
        else:
            self.res_p, self.res_b = _Residuals(), _Residuals()
        self.graphs = _CudaGraphs(dev) if _captures(dev) else None
        self.blocks = {}
        self.bwd = None  # made by the first backward pass (_ScanCall.backward)
        _scan_stats["frames"] += 1

    def render(self, pix, sample_offset: int, spp: int):
        """(mean radiance (r, 3), rays) of ``spp`` samples from
        ``sample_offset`` of the pixel ids ``pix`` (None: the given rays)."""
        call = _ScanCall(self, pix, sample_offset, spp)
        acc = (_CheckpointedBlocks.apply(call, *self.inputs) if self.track
               else call.forward())
        return acc / spp, self.state["rays"].clone()

    def load(self, pix, s: int) -> None:
        """Fills the pixel ids and the sample index of sample ``s``."""
        if pix is not None:
            if self.pix is None:
                self.pix = pix.to(self.dev).clone()
            else:
                self.pix.copy_(pix)
        self.samp.fill_(s)

    def drained(self) -> bool:
        with span("drain_read"):
            return not bool(self.state["alive"].any())

    def run(self, kind) -> None:
        """Runs the block ``kind`` once: ("primary", mode), ("bounce", n,
        mode) with the residuals' mode (None, or "record" in backward),
        ("finish",), or ("vjp", n, needs), the VJP of n bounces or (n = 0)
        of the primary block for the mask ``needs``."""
        blocks = self.blocks.get(kind)
        if blocks is None:
            prefix = "bwd_" if kind[0] == "vjp" or kind[-1] == "record" else "fwd_"
            blocks = self.blocks[kind] = _Blocks(
                self._block_fn(kind), self.dev, 1, _scan_stats, prefix,
                self.graphs)
        blocks.run(0)

    def _block_fn(self, kind):
        # The frame holds its blocks, so their functions reach it through a
        # weak proxy: a reference cycle would leave the frame and its CUDA
        # graphs to the garbage collector, which may run inside a later
        # capture, where destroying a graph breaks that capture.
        f = weakref.proxy(self)
        name = kind[0]
        if name == "vjp":
            n, needs = kind[1:]
            bwd = self.bwd

            def block(st, env):
                f.res_p.mode = f.res_b.mode = "replay"
                if n:
                    f._bounces(st, env, f.res_b, n)
                else:
                    f._primary(st, env, f.res_p)
                return []

            return lambda _: bwd.vjp(block, f.state, needs)
        env = (self.scene, self.tables)

        def run(_):
            f.res_p.mode = f.res_b.mode = kind[-1] if name != "finish" else None
            st = dict(f.state)
            if name == "primary":
                f._primary(st, env, f.res_p)
            elif name == "bounce":
                f._bounces(st, env, f.res_b, kind[1])
            else:
                f._finish(st)
            for k, v in f.state.items():
                if st[k] is not v:
                    v.copy_(st[k])

        return run

    def _isect(self, origin, direction):
        return intersect_any(self.scene, self.bvh, origin, direction, self.opts,
                             accel=self.accel)

    def _primary(self, st, env, res):
        scene, (_, mtab) = env
        if self.given is None:
            keys = rng.lane_keys(self.opts.seed, self.pix, self.samp)
            jitter = (None if self.opts.compat.no_pixel_jitter
                      else rng.primary_uniforms(keys))
            origin, direction = primary_rays(scene.camera, self.pix, jitter)
        else:
            keys, origin, direction = self.given
        hit, t, tri = res(("isect", 0), lambda: self._isect(origin, direction))
        mat0 = scene.mat_id[torch.clamp(tri, min=0).long()].long()
        emit0 = hit & scene.is_emitter[mat0]
        # A primary emitter hit returns the light radiance.
        rad = torch.where(emit0[:, None],
                          _material_rows(mtab[:, _MF_EMIT], mat0), 0.0)
        st.update(keys=keys, origin=origin, direction=direction,
                  alive=hit & ~emit0, t=t, tri=tri, beta=torch.ones_like(rad),
                  rad=rad, slot=self.iota,
                  n_rays=torch.full((), self.r, dtype=torch.int64,
                                    device=self.dev),
                  depth=torch.zeros((), dtype=torch.int64, device=self.dev))

    def _bounces(self, st, env, res, n: int):
        for k in range(n):
            self._bounce(st, env, res, k)

    def _bounce(self, st, env, res, k: int):
        """Bounce ``k`` of a block, at the depth in ``st["depth"]``."""
        scene, tables = env
        opts, r, num_lights = self.opts, self.r, scene.num_lights
        alive, direction, keys, slot = (st["alive"], st["direction"], st["keys"],
                                        st["slot"])
        beta, rad, tri, depth = st["beta"], st["rad"], st["tri"], st["depth"]
        live = st["live"] + alive.any()
        u = rng.bounce_uniforms(keys, depth, self.n_slots)
        p, pn, matf, kd = _gather_hit(scene, opts, st["origin"], direction,
                                      st["t"], tri, tables)
        cont = alive & (u[:, 0] < opts.rr_probability)
        new_o, new_d, ray_type, weight = _next_ray(scene, opts, p, pn, matf, kd,
                                                   direction, u)
        if self.do_sort:
            cluster = torch.clamp(tri, min=0) // opts.cluster_width
            sort_key = torch.where(alive, cluster * 64 + _direction_bin(new_d),
                                   2 ** 30)
            perm, inv = res(("perm", k), lambda: _sort_perm(sort_key, self.track))
            (p, pn, kd, new_o, new_d, weight, beta, rad, u), \
                (ray_type, keys, slot, alive, cont) = _permute_rows(
                    perm, (p, pn, kd, new_o, new_d, weight, beta, rad, u),
                    (ray_type, keys, slot, alive, cont), inv)

        # Next-event estimation: one full nearest-hit shadow query per light,
        # light li's results in rows (li + 1) r .. (li + 2) r of the step.
        so, dirn, contrib, ok, dist, smat, _ = _nee_prep(
            scene, opts, p, pn, kd, u, alive, tables)
        shadow = [res(("isect", k), lambda li=li: self._isect(so[li], dirn[li]),
                      slice((li + 1) * r, (li + 2) * r))
                  for li in range(num_lights)]
        if num_lights:
            l_dir = _nee_resolve(scene, opts, contrib, ok, dist, smat,
                                 *(torch.stack(x) for x in zip(*shadow)))
            rad = rad + torch.where(alive[:, None], beta * l_dir, 0.0)
        beta2 = (beta / opts.rr_probability) * weight

        # Russian-roulette-terminated lanes are parked.
        new_o = torch.where(cont[:, None], new_o, 1e9)
        hit2, t2, tri2 = res(("isect", k), lambda: self._isect(new_o, new_d),
                             slice(0, r))
        mat2 = scene.mat_id[torch.clamp(tri2, min=0).long()].long()
        emit2 = hit2 & scene.is_emitter[mat2]
        alive2 = cont & hit2
        # Specular and transmission bounces see emitters, diffuse ones do not.
        sees_emitter = alive2 & emit2 & (ray_type != RAY_DIFFUSE)
        rad = rad + torch.where(
            sees_emitter[:, None],
            beta2 * _material_rows(tables[1][:, _MF_EMIT], mat2), 0.0)
        n_rays = st["n_rays"] + alive.sum() * num_lights + cont.sum()
        st.update(alive=alive2 & ~emit2, origin=new_o, direction=new_d, t=t2,
                  tri=tri2, beta=beta2, rad=rad, keys=keys, slot=slot,
                  n_rays=n_rays, depth=depth + 1, live=live)

    def _finish(self, st):
        rad = st["rad"]
        if self.do_sort:
            rad = torch.zeros_like(rad).index_copy(0, st["slot"].long(), rad)
        st.update(acc=st["acc"] + rad, rays=st["rays"] + st["n_rays"])


class _ScanCall:
    """One call on a _ScanFrame: ``spp`` samples from ``offset`` of the
    pixel ids ``pix`` (None: the frame's given rays).  ``forward`` and
    ``backward`` are _CheckpointedBlocks's two passes, the two halves of
    the JAX package's ``lax.scan`` over ``jax.checkpoint(sample_body)``:
    between them the call holds only ``pix``, ``offset`` and ``spp``, and
    backward recomputes each sample."""

    def __init__(self, frame: _ScanFrame, pix, offset: int, spp: int):
        self.frame, self.pix, self.offset, self.spp = frame, pix, offset, spp

    def forward(self):
        """Runs the samples without recording autograd and keeps nothing of
        them; returns the sum of their radiance (a copy)."""
        f = self.frame
        bounces = 0
        for k in ("acc", "rays", "live"):
            f.state[k].zero_()
        with torch.no_grad():
            for s in range(self.spp):
                f.load(self.pix, self.offset + s)
                f.run(("primary", None))
                for n in f.sizes:
                    if not f.differentiable and f.drained():
                        break
                    f.run(("bounce", n, None))
                    bounces += n
                f.run(("finish",))
        _scan_stats["calls"] += 1
        _scan_stats["samples"] += self.spp
        _scan_stats["bounces"] += bounces
        _scan_stats["idle_bounces"] += bounces - int(f.state["live"])
        return f.state["acc"].clone()

    def backward(self, ct, needs) -> list:
        """The inputs' gradients (None where ``needs`` is false) for the
        cotangent ``ct`` of the radiance sum: the samples in reverse order
        (_sample_backward), each input's gradient summed over their blocks,
        the last sample's last block first."""
        f = self.frame
        if f.bwd is None:  # held for the captured VJPs
            f.bwd = _Backward(f.scene, f.inputs, f.state)
            f.grad_ct = torch.zeros_like(f.state["acc"])
        f.bwd.mask(needs)
        f.grad_ct.copy_(ct)
        with torch.no_grad():
            for s in reversed(range(self.spp)):
                self._sample_backward(s, needs)
        return f.bwd.grads(needs)

    def _sample_backward(self, s: int, needs) -> None:
        """Sample ``s`` recomputed from its primary block, recording its
        residuals (the primary intersect stays in its buffer; each bounce
        block's intersects and sort orders are copied out, with the block's
        entry state), then the VJP of each bounce block in reverse with its
        residuals replayed, and of the primary block, the cotangents of
        ``beta`` and ``rad`` passed from block to block.  The copies are
        one sample's and die with the call."""
        f = self.frame
        f.load(self.pix, self.offset + s)
        f.run(("primary", "record"))
        entries, saved = [], []
        for n in f.sizes:
            entries.append({k: v.clone() for k, v in f.state.items()})
            f.run(("bounce", n, "record"))
            saved.append(f.res_b.copies(n))
        _scan_stats["residual_bytes"] = max(
            _scan_stats["residual_bytes"],
            sum(c.nbytes for copies in saved for c in copies))
        ct_state = f.bwd.ct_state
        ct_state["rad"].copy_(
            f.grad_ct.index_select(0, f.state["slot"].long())
            if f.do_sort else f.grad_ct)
        ct_state["beta"].zero_()
        f.bwd.reverse(f.state, f.res_b, entries, saved,
                      lambda i: f.run(("vjp", f.sizes[i], needs)))
        f.run(("vjp", 0, needs))


class _SceneCache:
    """Values built from a scene and kept from one call to the next, under a
    key, while the scene's tensors live.

    An entry holds the scene only through an alias (each tensor
    ``detach()``-ed: the same storage, other tensor objects) and the
    caller's tensors by weak reference, so it keeps none of them alive: when
    the caller drops a tensor of the scene the entry goes, freed at once by
    reference counting (inside a graph capture, where freeing a graph would
    break the capture, right after it).  An entry is keyed by the tensors'
    identity, and holds their version counters and the identity of the
    objects it was built on (``held``): where a tensor was changed in place
    since, or another object is given, the entry is replaced, not joined by
    a second one.  At most ``size`` entries are kept, the least recently
    used dropped first.

    Fields named ``loose`` (a gradient step's parameters, new tensors every
    step) are keyed by shape and dtype alone: the entry holds no reference
    to them, and its alias holds copies of their values at the first call,
    of its own storage."""

    def __init__(self, size: int):
        self.size, self.entries = size, collections.OrderedDict()

    def get(self, scene, key, build, held=(), loose=()):
        """(value, whether it was kept from an earlier call): the entry of
        ``key`` and ``scene``'s tensors, built on the objects ``held`` (the
        value holds them), or a new one, ``build(alias)``."""
        cam = scene.camera
        fields = [f for f in SCENE_FIELDS if f not in loose]
        tensors = ([getattr(scene, f) for f in fields]
                   + [cam.eye, cam.look_at, cam.up, cam.fovy])
        key = (key, cam.width, cam.height, tuple(id(t) for t in tensors),
               tuple((getattr(scene, f).shape, getattr(scene, f).dtype)
                     for f in loose))
        stamp = (tuple(t._version for t in tensors), tuple(id(o) for o in held))
        entry = self.entries.get(key)
        if entry is not None and entry[2] == stamp:
            self.entries.move_to_end(key)
            return entry[0], True
        # A stale entry goes before its replacement is built.
        del entry
        self._drop(key, None)
        alias = SceneArrays(
            **{f: getattr(scene, f).detach() for f in fields},
            **{f: getattr(scene, f).detach().clone() for f in loose},
            camera=dataclasses.replace(
                cam, eye=cam.eye.detach(), look_at=cam.look_at.detach(),
                up=cam.up.detach(), fovy=cam.fovy.detach()))
        value = build(alias)
        drop = functools.partial(self._drop, key)
        self.entries[key] = (value, [weakref.ref(t, drop) for t in tensors],
                             stamp)
        while len(self.entries) > self.size:
            self.entries.popitem(last=False)
        return value, False

    def _drop(self, key, _ref) -> None:
        entry = self.entries.pop(key, None)
        if entry is not None and _capturing:
            _doomed.append(entry)

    def clear(self) -> None:
        self.entries.clear()


# The forward lane pools kept between dispatches, each frame's pixel ids and
# intersector tables (render_image_host_chunked), and the differentiable
# lane pools kept between calls: three caches of the one kind, on a CUDA
# device outside eager().
_POOLS = _SceneCache(4)
_FRAME_TABLES = _SceneCache(4)
_GRAD_POOLS = _SceneCache(4)

# The scene fields a gradient step hands in anew with every call: the
# parameters' leaves (diff/gradients.py) and the emission table that
# apply_params rebuilds from the lights' radiance.  A kept differentiable
# pool keys them by shape and dtype, and each call copies their values in.
_STEP_FIELDS = ("kd", "ks", "ns", "emission", "atlas", "light_radiance")

# Iterations of a forward lane-pool block, between two reads of the drain.
_CHECK_EVERY = 8


class _LanePool:
    """The lane pool of render_pixels_refill: ``r`` lanes over ``n_pix``
    pixel slots of ``scene`` under ``opts``, ``n_pend`` pend registers a
    lane, its constants, its shading and intersector tables, and its
    iteration (``step``); its two kinds are the frame loop (_FramePool) and
    the gradient's (_GradPool), each with its ``kept`` and ``loose``
    (_kept_pool).  ``track``: the iterations record for backward.

    Each dispatch fills the buffers that its blocks read and write by
    address (``for_dispatch``), made at the pool's first dispatch: the
    state ``s``, the film, what its kind adds (``_make_buffers``), and the
    dispatch's inputs (``take``; the seed's word and the offset as 0-d
    device buffers, so no graph holds a number that changes between
    dispatches).

    The block functions reach the pool through a weak proxy: a reference
    cycle would leave the pool and its graphs to the garbage collector,
    which may run inside another loop's capture, where destroying a graph
    breaks that capture."""

    loose, track = (), False

    def __init__(self, scene, bvh, opts: RenderOptions, r: int, n_pix: int,
                 n_pend: int, pixel_fn=None, accel=None):
        dev = scene.device
        self.scene, self.bvh, self.opts, self.r, self.n_pix, self.dev = (
            scene, bvh, opts, r, n_pix, dev)
        self.pixel_fn, self.n_pend = pixel_fn, n_pend
        self.spp = opts.spp
        self.n_slots = rng.n_bounce_slots(scene.num_lights)
        self.do_sort = (_should_sort(opts, scene.num_tris_padded)
                        and r > opts.cluster_rays)
        self.num_lights = scene.num_lights
        # With >= 2 lights and sorting, the NEE prep runs after the sort.
        self.post_nee = self.do_sort and self.num_lights >= 2
        self.lane_iota = torch.arange(r, dtype=_I32, device=dev)
        # Out-of-range dummies: the film has r * n_pend spare columns past
        # n_pix where non-pending lanes' flushes land; they are sliced off.
        self.dummy_slot = n_pix + self.lane_iota
        self.pend_iota = torch.arange(n_pend, dtype=_I32, device=dev)
        self.dummy_pend = (n_pix + self.lane_iota[:, None] * n_pend
                           + self.pend_iota[None, :])
        self.tables = _shading_tables(scene)
        self.accel = intersector_tables(scene, opts, bvh) if accel is None else accel
        self.pixel_ids = self.word = self.offset = None
        self.s = self.film = None

    def isect(self, o, d):
        return intersect_any(self.scene, self.bvh, o, d, self.opts,
                             accel=self.accel)

    def primary_for(self, pix, keys):
        jitter = (None if self.opts.compat.no_pixel_jitter
                  else rng.primary_uniforms(keys))
        return primary_rays(self.scene.camera, pix, jitter)

    def step(self, s, it: int, env, replay):
        """Iteration ``it`` on the state dict ``s`` (its entries replaced,
        no tensor changed in place): shade arrivals, stage completed
        pixels, intersect.  ``env`` is the (scene, shading tables) to shade
        with (a backward recompute passes its leaves); ``replay`` (a
        _Residuals) computes, records or replays the intersect results and
        sort orders.  Returns ``lit``, whether each lane's shadow rows (one
        a light) carried rays."""
        opts, r, n_pix, spp = self.opts, self.r, self.n_pix, self.spp
        n_slots, do_sort, num_lights = self.n_slots, self.do_sort, self.num_lights
        n_pend = self.n_pend
        scene, tables = env
        active, kind, depth, keys = s["active"], s["kind"], s["depth"], s["keys"]
        origin, direction, beta, rad = (s["origin"], s["direction"], s["beta"],
                                        s["rad"])
        hit_a, t_a, tri_a = s["hit_a"], s["t_a"], s["tri_a"]
        samp_left, slot, pix, samp = s["samp_left"], s["slot"], s["pix"], s["samp"]
        prim_ok, prim_hit, prim_t, prim_tri = (s["prim_ok"], s["prim_hit"],
                                               s["prim_t"], s["prim_tri"])
        was_fresh, q = s["was_fresh"], s["q"]
        pend_slot, pend_count = s["pend_slot"], s["pend_count"]
        pend_r, pend_g, pend_b = s["pend_r"], s["pend_g"], s["pend_b"]

        n_rays = s["n_rays"] + active.sum()

        # Cache the pixel's first-sample primary hit for reuse.
        is_prim = kind == KIND_PRIMARY
        fresh_prim = active & was_fresh & is_prim
        prim_hit = torch.where(fresh_prim, hit_a, prim_hit)
        prim_t = torch.where(fresh_prim, t_a, prim_t)
        prim_tri = torch.where(fresh_prim, tri_a, prim_tri)
        prim_ok = prim_ok | fresh_prim

        p, pn, matf, kd = _gather_hit(scene, opts, origin, direction, t_a, tri_a,
                                      tables)
        emit = hit_a & (matf[:, _MF_IS_EMITTER] > 0)
        emission = matf[:, _MF_EMIT]
        # Primary emitter hits return the light radiance; specular and
        # transmission bounces see emitters, diffuse ones do not.
        add_prim = active & is_prim & emit
        rad = rad + torch.where(add_prim[:, None], emission, 0.0)
        add_spec = active & ~is_prim & emit & (kind != RAY_DIFFUSE)
        rad = rad + torch.where(add_spec[:, None], beta * emission, 0.0)

        shade = active & hit_a & ~emit & (depth < opts.max_depth)
        sample_done = active & ~shade

        u = rng.bounce_uniforms(keys, depth, n_slots)
        # With >= 2 lights the NEE prep runs after the sort on the permuted
        # inputs, with uniforms re-derived from the permuted keys (the same
        # streams); with one light it runs here and its outputs ride the sort.
        post_nee = self.post_nee
        if post_nee:
            beta_nee, keys_nee, depth_nee = beta, keys, depth
        else:
            so_s, dirn_s, contrib, ok_n, dist_n, smat_n, lit = _nee_prep(
                scene, opts, p, pn, kd, u, shade, tables)
            contrib = contrib * beta[None]
        cont = shade & (u[:, 0] < opts.rr_probability)
        new_o, new_d, rtype, weight = _next_ray(scene, opts, p, pn, matf, kd,
                                                direction, u)
        beta = torch.where(cont[:, None], (beta / opts.rr_probability) * weight,
                           beta)
        sample_done = sample_done | (shade & ~cont)
        n_rays = n_rays + shade.sum() * num_lights

        # Sample / pixel transitions.
        pixel_done = sample_done & (samp_left <= 0)
        next_samp = sample_done & (samp_left > 0)
        rank = torch.cumsum(pixel_done.to(_I32), dim=0, dtype=_I32) - 1
        new_slot = q + rank
        take = pixel_done & (new_slot < n_pix)
        slot_done = torch.where(pixel_done, slot, self.dummy_slot)
        safe_slot = torch.clamp(new_slot, max=n_pix - 1)
        pix_new = (self.pixel_fn(safe_slot) if self.pixel_fn is not None
                   else self.pixel_ids[safe_slot.long()])
        restart = next_samp | take
        pix2 = torch.where(take, pix_new, pix)
        samp2 = torch.where(take, self.offset,
                            torch.where(next_samp, samp + 1, samp))
        keys2 = rng.word_lane_keys(self.word, pix2, samp2)
        o_prim, d_prim = self.primary_for(pix2, keys2)
        reuse = (next_samp & prim_ok if opts.compat.no_pixel_jitter
                 else torch.zeros_like(next_samp))

        active = (active & ~sample_done) | restart
        slot = torch.where(take, new_slot, slot)
        pix, samp = pix2, samp2
        samp_left = torch.where(take, spp - 1,
                                torch.where(next_samp, samp_left - 1, samp_left))
        keys = torch.where(restart[:, None], keys2, keys)
        depth = torch.where(restart, 0, depth + cont.to(_I32))
        kind = torch.where(restart, KIND_PRIMARY, torch.where(cont, rtype, kind))
        origin = torch.where(restart[:, None], o_prim,
                             torch.where(cont[:, None], new_o, origin))
        direction = torch.where(restart[:, None], d_prim,
                                torch.where(cont[:, None], new_d, direction))
        beta = torch.where(restart[:, None], 1.0, beta)
        prim_ok = prim_ok & ~take
        was_fresh = active & ~reuse
        q = q + take.sum(dtype=_I32)

        if do_sort:
            # Coherence grouping for the coming combined call: bounce
            # segments by (origin cluster, direction bin), camera segments
            # in one bucket, cached / inactive lanes at the end.
            w = opts.cluster_width
            cluster = torch.clamp(tri_a, min=0) // w
            bucket = torch.where(kind == KIND_PRIMARY, 1 << 20, cluster)
            sort_key = torch.where(
                active & was_fresh, bucket * 64 + _direction_bin(direction),
                torch.where(active, 1 << 27, 2 ** 30))
            perm, inv = replay(("perm", it),
                               lambda: _sort_perm(sort_key, self.track))
            ints = (slot, pix, samp, samp_left, keys, depth, kind, active,
                    was_fresh, prim_ok, prim_hit, prim_tri, pend_slot,
                    pend_count, shade, take, pixel_done, slot_done)
            if post_nee:
                (origin, direction, beta, rad, pend_r, pend_g, pend_b, f_pack,
                 p_s, pn_s, kd_s, beta_nee), ints_p = _permute_rows(
                    perm,
                    (origin, direction, beta, rad, pend_r, pend_g, pend_b,
                     prim_t[:, None], p, pn, kd, beta_nee),
                    ints + (keys_nee, depth_nee), inv)
                keys_nee, depth_nee = ints_p[-2:]
                u2 = rng.bounce_uniforms(keys_nee, depth_nee, n_slots)
                so_s, dirn_s, contrib, ok_n, dist_n, smat_n, lit = _nee_prep(
                    scene, opts, p_s, pn_s, kd_s, u2, ints_p[14], tables)
                contrib = contrib * beta_nee[None]
            else:
                l = num_lights
                (origin, direction, beta, rad, pend_r, pend_g, pend_b, f_pack,
                 so_p, dn_p, ct_p), ints_p = _permute_rows(
                    perm,
                    (origin, direction, beta, rad, pend_r, pend_g, pend_b,
                     torch.cat([prim_t[:, None], dist_n.T], dim=1),
                     so_s.permute(1, 0, 2).reshape(r, 3 * l),
                     dirn_s.permute(1, 0, 2).reshape(r, 3 * l),
                     contrib.permute(1, 0, 2).reshape(r, 3 * l)),
                    ints + (ok_n.T, smat_n.T), inv)
                dist_n = f_pack[:, 1:].T
                so_s = so_p.reshape(r, l, 3).permute(1, 0, 2)
                dirn_s = dn_p.reshape(r, l, 3).permute(1, 0, 2)
                contrib = ct_p.reshape(r, l, 3).permute(1, 0, 2)
                ok_n, smat_n = ints_p[-2].T, ints_p[-1].T
            prim_t = f_pack[:, 0]
            (slot, pix, samp, samp_left, keys, depth, kind, active, was_fresh,
             prim_ok, prim_hit, prim_tri, pend_slot, pend_count, shade, take,
             pixel_done, slot_done) = ints_p[:18]

        # One combined intersect: next arrivals + every light's shadow rays.
        ray_o = torch.where((active & was_fresh)[:, None], origin, 1e9)
        all_o = torch.cat([ray_o] + [so_s[i] for i in range(num_lights)])
        all_d = torch.cat([direction] + [dirn_s[i] for i in range(num_lights)])
        hit_q, t_q, tri_q = replay(("isect", it), lambda: self.isect(all_o, all_d))
        hit2, t2, tri2 = hit_q[:r], t_q[:r], tri_q[:r]
        hs = hit_q[r:].reshape(num_lights, r)
        ts = t_q[r:].reshape(num_lights, r)
        tris = tri_q[r:].reshape(num_lights, r)

        l_dir = _nee_resolve(scene, opts, contrib, ok_n, dist_n, smat_n,
                             hs, ts, tris)
        rad = rad + torch.where(shade[:, None], l_dir, 0.0)

        # Stage completed pixel sums into the lane's next free pend slot; a
        # lane completes at most one pixel per spp iterations, so n_pend
        # slots are flushed (every n_pend * spp iterations) before reuse.
        pc = torch.clamp(pend_count, max=n_pend - 1)
        stage = (self.pend_iota[None, :] == pc[:, None]) & pixel_done[:, None]
        pend_slot = torch.where(stage, slot_done[:, None], pend_slot)
        pend_r = torch.where(stage, rad[:, 0:1], pend_r)
        pend_g = torch.where(stage, rad[:, 1:2], pend_g)
        pend_b = torch.where(stage, rad[:, 2:3], pend_b)
        pend_count = pend_count + pixel_done.to(_I32)
        rad = torch.where(take[:, None], 0.0, rad)  # next_samp keeps the sum

        # Arrivals for the next iteration: fresh traversal results, or the
        # cached primary hit for reuse lanes.
        s.update(
            q=q, n_rays=n_rays, active=active, slot=slot, pix=pix, samp=samp,
            samp_left=samp_left, keys=keys, depth=depth, kind=kind,
            was_fresh=was_fresh,
            hit_a=torch.where(was_fresh, hit2, prim_hit),
            t_a=torch.where(was_fresh, t2, prim_t),
            tri_a=torch.where(was_fresh, tri2, prim_tri),
            prim_ok=prim_ok, prim_hit=prim_hit, prim_t=prim_t,
            prim_tri=prim_tri, pend_slot=pend_slot, pend_count=pend_count,
            origin=origin, direction=direction, beta=beta, rad=rad,
            pend_r=pend_r, pend_g=pend_g, pend_b=pend_b)
        return lit

    def bootstrap(self, pixel_ids, seed: int, sample_offset: int) -> dict:
        """The state the loop starts from.  The loop carries each lane's
        arrival, so the first batch of primaries is intersected once up
        front."""
        r, dev = self.r, self.dev
        pix0 = pixel_ids[:r]
        keys0 = rng.lane_keys(seed, pix0, sample_offset)
        o0, d0 = self.primary_for(pix0, keys0)
        hit0, t0, tri0 = self.isect(o0, d0)
        i32 = dict(dtype=_I32, device=dev)
        f32 = dict(dtype=torch.float32, device=dev)
        n_pend = self.n_pend
        return dict(
            q=torch.tensor(r, **i32),
            n_rays=torch.zeros((), dtype=torch.int64, device=dev),
            active=torch.ones((r,), dtype=torch.bool, device=dev),
            slot=self.lane_iota.clone(),
            pix=pix0,
            samp=torch.full((r,), sample_offset, **i32),
            samp_left=torch.full((r,), self.spp - 1, **i32),
            keys=keys0,
            depth=torch.zeros((r,), **i32),
            kind=torch.full((r,), KIND_PRIMARY, **i32),
            was_fresh=torch.ones((r,), dtype=torch.bool, device=dev),
            hit_a=hit0, t_a=t0, tri_a=tri0,
            prim_ok=torch.zeros((r,), dtype=torch.bool, device=dev),
            prim_hit=torch.zeros((r,), dtype=torch.bool, device=dev),
            prim_t=torch.zeros((r,), **f32),
            prim_tri=torch.zeros((r,), **i32),
            pend_slot=self.dummy_pend.clone(),
            pend_count=torch.zeros((r,), **i32),
            origin=o0.contiguous(), direction=d0,
            beta=torch.ones((r, 3), **f32),
            rad=torch.zeros((r, 3), **f32),
            pend_r=torch.zeros((r, n_pend), **f32),
            pend_g=torch.zeros((r, n_pend), **f32),
            pend_b=torch.zeros((r, n_pend), **f32),
        )

    def drained(self, st) -> bool:
        with span("drain_read"):
            return not bool(((st["q"] < self.n_pix) | st["active"].any()).item())

    def for_dispatch(self, pixel_ids, seed: int, sample_offset: int) -> None:
        """Takes a dispatch's inputs, the pixel ids, the seed ``seed``'s
        word and the sample offset, and fills the state buffers ``s`` with
        the state the loop starts from (bootstrapped), the film zeroed.
        The pool makes its buffers at its first dispatch and writes every
        later one into the same tensors, whose addresses the graphs hold."""
        with torch.no_grad():
            boot = self.bootstrap(pixel_ids, seed, sample_offset)
            if self.s is None:
                # Fixed storage: each block starts from these buffers and
                # copies its results back into them (the film is added to
                # in place), so a captured block replays on the same
                # addresses.  The film is channel-major, with r * n_pend
                # spare columns for the dummies.
                i64 = dict(dtype=torch.int64, device=self.dev)
                self.s = {k: torch.empty_like(v) for k, v in boot.items()}
                self.film = torch.empty((3, self.n_pix + self.r * self.n_pend),
                                        dtype=torch.float32, device=self.dev)
                self.word = torch.zeros((), **i64)
                self.offset = torch.zeros((), **i64)
                if self.pixel_fn is None:
                    self.pixel_ids = torch.empty_like(pixel_ids)
                self._make_buffers()
            for k, v in boot.items():
                self.s[k].copy_(v)
            self.film.zero_()
        self.take(pixel_ids, seed, sample_offset)

    def take(self, pixel_ids, seed: int, sample_offset: int) -> None:
        """A dispatch's inputs into the buffers the step reads: the pixel
        ids (without ``pixel_fn``), the seed's word, the sample offset."""
        with torch.no_grad():
            if self.pixel_ids is not None:
                self.pixel_ids.copy_(pixel_ids)
            self.word.fill_(rng.seed_word(seed))
            self.offset.fill_(sample_offset)

    @staticmethod
    def pend(st):
        """(film columns, (3, r * n_pend) sums) of the pend registers in
        ``st``.  Real slots are unique (a pixel completes once a dispatch),
        so every film entry receives one add and the order is immaterial."""
        slots = st["pend_slot"].reshape(-1).long()
        vals = torch.stack([st[c].reshape(-1)
                            for c in ("pend_r", "pend_g", "pend_b")])
        return slots, vals


class _FramePool(_LanePool):
    """The frame loop: 2 pend registers a lane below spp 16 (1 from there),
    added into the film every n_pend * spp iterations, and blocks of
    _CHECK_EVERY iterations with the drain read between them (``run``),
    whose _Blocks replays one graph for each flush phase.  Its state adds
    ``n_lit``, each lane's iterations whose shadow rows carried rays, and
    ``live``, the iterations that started before the pool drained."""

    kept = _POOLS

    def __init__(self, scene, bvh, opts: RenderOptions, r: int, n_pix: int,
                 pixel_fn=None, accel=None):
        super().__init__(scene, bvh, opts, r, n_pix,
                         max(1, min(2, -(-16 // opts.spp))), pixel_fn, accel)
        self.check_every = _CHECK_EVERY

    @classmethod
    def variant(cls, scene, pixel_ids):
        return {}, (_CHECK_EVERY,)

    def bootstrap(self, pixel_ids, seed: int, sample_offset: int) -> dict:
        return dict(super().bootstrap(pixel_ids, seed, sample_offset),
                    n_lit=torch.zeros((self.r,), dtype=_I32, device=self.dev))

    def _make_buffers(self) -> None:
        self.s["live"] = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.blocks = _Blocks(self._block_fn(), self.dev,
                              max(1, self.n_pend * self.spp), _loop_stats)

    def _block_fn(self):
        f = weakref.proxy(self)
        n_pix, check_every = self.n_pix, self.check_every
        flush_every = max(1, self.n_pend * self.spp)
        i32 = dict(dtype=_I32, device=self.dev)
        env, res = (self.scene, self.tables), _Residuals()

        def block(i0: int):
            st = dict(f.s)
            for i in range(i0, i0 + check_every):
                st["live"] = st["live"] + ((st["q"] < n_pix) | st["active"].any())
                # Summed at the dispatch's end: one kernel an iteration.
                st["n_lit"] = st["n_lit"] + f.step(st, i, env, res)
                if (i + 1) % flush_every == 0:
                    f.film.index_add_(1, *f.pend(st))
                    st["pend_slot"] = f.dummy_pend
                    st["pend_count"] = torch.zeros((f.r,), **i32)
            for k, v in f.s.items():
                v.copy_(st[k])

        return block

    def run(self):
        """Runs the loaded dispatch's blocks until the pool drains:
        (mean radiance (n_pix, 3), rays traced (a copy))."""
        s, stats = self.s, _loop_stats
        with self.blocks.one_pass(), torch.no_grad():
            s["live"].zero_()
            i = 0
            while not self.drained(s):
                self.blocks.run(i)
                i += self.check_every
            with span("release"):
                self.film.index_add_(1, *self.pend(s))  # since the last flush
                live, rays, lit = torch.stack(
                    (s["live"], s["n_rays"], s["n_lit"].sum())).tolist()
        stats["dispatches"] += 1
        stats["iterations"] += i
        stats["idle_iterations"] += i - live
        stats["query_rows"] += i * self.r * (1 + self.num_lights)
        stats["rays"] += rays
        stats["shadow_rows"] += i * self.r * self.num_lights
        stats["shadow_rays"] += lit * self.num_lights
        return self.film[:, :self.n_pix].T / self.spp, s["n_rays"].clone()


class _GradCall:
    """One call of a _GradPool: its inputs (in _grad_inputs' order), its
    ``dispatch`` (pixel ids, seed, sample offset: _LanePool.take), and the
    entry state and residual copies of each block its forward pass
    recorded.  The pool's passes copy the call's inputs and dispatch in
    first, so two calls on one kept pool may both run forward before
    either runs backward."""

    def __init__(self, pool, inputs, dispatch):
        self.pool, self.inputs, self.dispatch = pool, inputs, dispatch
        self.entries, self.saved = [], []

    def forward(self):
        return self.pool.forward(self)

    def backward(self, ct_film, needs) -> list:
        return self.pool.backward(self, ct_film, needs)


class _GradPool(_LanePool):
    """The differentiable loop: one pend register a lane, a static budget
    of ``n_blocks`` blocks of ``k_steps`` = spp iterations (a lane completes
    at most one pixel a block), each ending with its pend registers
    gathered and reset (``block``).  ``forward`` and ``backward`` are the
    two halves of the JAX package's ``lax.scan`` over ``jax.checkpoint``-ed
    blocks that save only the named residuals.  Its buffers add the
    residuals, copies of the inputs (``xs``), the film's cotangent, a
    _Backward, and one graph pool for the _Blocks of both passes."""

    kept, loose = _GRAD_POOLS, _STEP_FIELDS

    def __init__(self, scene, bvh, opts: RenderOptions, r: int, n_pix: int,
                 pixel_fn=None, accel=None, track: bool = False):
        super().__init__(scene, bvh, opts, r, n_pix, 1, pixel_fn, accel)
        self.track = track
        e_seg = (opts.bwd_seg_per_sample if opts.bwd_seg_per_sample is not None
                 else 1.2 / (1.0 - opts.rr_probability))
        n_iter = (int(np.ceil(n_pix * opts.spp * e_seg / r)) + opts.max_depth
                  + opts.spp + 4)
        self.k_steps = opts.spp
        self.n_blocks = -(-n_iter // self.k_steps)

    @classmethod
    def variant(cls, scene, pixel_ids):
        # A scene whose geometry needs a gradient makes a pool a call.
        track = _tracks_grad(scene)
        geometry = any(getattr(scene, f).requires_grad for f in SCENE_FIELDS
                       if f not in _STEP_FIELDS)
        return {"track": track}, None if geometry else (pixel_ids.dtype, track)

    def _make_buffers(self) -> None:
        r, dev = self.r, self.dev
        self.zero_count = torch.zeros((r,), dtype=_I32, device=dev)
        self.zero_pend = torch.zeros((r, self.n_pend), dtype=torch.float32,
                                     device=dev)
        self.res = (_Residuals(self.k_steps, r * (1 + self.num_lights),
                               r if self.do_sort else 0, dev)
                    if self.track else _Residuals())
        # The triangle table is the pool's own (it carries no gradient when
        # the pool is kept: variant); every other input is copied in by
        # each pass (load).
        xs = _grad_inputs(self.scene, self.tables)
        self.xs = [xs[0].detach()] + [x.detach().clone() for x in xs[1:]]
        self.ct_film = torch.zeros_like(self.film)
        self.bwd = _Backward(self.scene, self.xs, self.s)
        self.graphs = _CudaGraphs(dev) if _captures(dev) else None
        self.fwd = _Blocks(self._fwd_fn(), dev, 1, _grad_stats, "fwd_",
                           self.graphs)
        self.bwd_blocks = {}

    def load(self, inputs) -> None:
        """Copies a call's gradient inputs (_grad_inputs' order, the pool's
        own triangle table first) into the buffers the blocks read."""
        with torch.no_grad():
            for x, y in zip(self.xs[1:], inputs[1:]):
                x.copy_(y)

    def block(self, st, env, res):
        """One block on the state dict ``st`` (its entries replaced):
        ``k_steps`` iterations, then the pend registers reset; returns the
        film columns and the (3, n) sums they staged.  ``env`` is the
        (scene, tables) to shade with, ``res`` the residuals' mode and
        buffers."""
        for k in range(self.k_steps):
            self.step(st, k, env, res)
        slots, vals = self.pend(st)
        st.update(pend_slot=self.dummy_pend, pend_count=self.zero_count,
                  pend_r=self.zero_pend, pend_g=self.zero_pend,
                  pend_b=self.zero_pend)
        return slots, vals

    def _fwd_fn(self):
        f = weakref.proxy(self)
        s, film, res = self.s, self.film, self.res
        env = _grad_env(self.scene, self.xs)

        def run(_):
            st = dict(s)
            film.index_add_(1, *f.block(st, env, res))
            for k, v in s.items():
                v.copy_(st[k])

        return run

    def _bwd_blocks(self, needs):
        """The backward pass's _Blocks for the mask ``needs``, made at its
        first pass: a block's VJP (_Backward.vjp), its staged sums' cotangent
        read at their film columns."""
        if needs not in self.bwd_blocks:
            f, bwd = weakref.proxy(self), self.bwd
            s, res, ct_film = self.s, self.res, self.ct_film

            def block(st, env):
                slots, vals = f.block(st, env, res)
                return [(vals, ct_film.index_select(1, slots))]

            self.bwd_blocks[needs] = _Blocks(
                lambda _: bwd.vjp(block, s, needs), self.dev, 1, _grad_stats,
                "bwd_", self.graphs)
        return self.bwd_blocks[needs]

    def run(self, scene, dispatch):
        """One call on the loaded dispatch ``dispatch`` (pixel ids, seed,
        sample offset), its inputs read off the caller's ``scene``: (mean
        radiance (n_pix, 3), rays traced, negated when the budget ended
        with samples in flight)."""
        call = _GradCall(self, _grad_inputs(
            scene, (self.tables[0], _material_table(scene))), dispatch)
        film = (_CheckpointedBlocks.apply(call, *call.inputs) if self.track
                else call.forward())
        _grad_stats["dispatches"] += 1
        # A copy: backward loads each block's entry state into these
        # buffers, and the next call on a kept pool bootstraps into them.
        s = self.s
        n_rays = s["n_rays"].clone() if self.drained(s) else -s["n_rays"]
        return film[:, :self.n_pix].T / self.spp, n_rays

    def forward(self, call):
        """Runs the call's blocks without recording autograd, the drain
        read between them, each adding its staged sums into the film in
        place; returns a copy of the film.  A ``track``-ing pool keeps each
        block's entry state and residuals in ``call`` for ``backward``."""
        record = self.track
        self.load(call.inputs)
        self.res.mode = "record" if record else None
        with self.fwd.one_pass(), torch.no_grad():
            for _ in range(self.n_blocks):
                if self.drained(self.s):
                    break
                if record:
                    call.entries.append({k: v.clone()
                                         for k, v in self.s.items()})
                self.fwd.run(0)
                if record:
                    call.saved.append(self.res.copies())
                _grad_stats["blocks"] += 1
            film = self.film.clone()
        self.res.mode = None
        return film

    def backward(self, call, ct_film, needs) -> list:
        """The inputs' gradients (None where ``needs`` is false) for the
        film cotangent ``ct_film``: the call's recorded blocks in reverse
        order, each recomputed from its entry state with its residuals
        replayed, and its VJP taken for its staged sums and its exit state;
        each input's gradient summed over the blocks, the last first."""
        blocks = self._bwd_blocks(needs)
        self.bwd.mask(needs)
        with torch.no_grad():
            self.ct_film.copy_(ct_film)
        self.load(call.inputs)
        self.take(*call.dispatch)
        with blocks.one_pass():
            self.bwd.reverse(self.s, self.res, call.entries, call.saved,
                             lambda _: blocks.run(0))
        _grad_stats["bwd_passes"] += 1
        return self.bwd.grads(needs)


def _kept_pool(cls, scene, bvh, opts: RenderOptions, r: int, pixel_ids,
               pixel_fn, accel):
    """(the pool of kind ``cls`` for this dispatch, whether it was kept
    from an earlier one).  ``cls.variant(scene, pixel_ids)`` gives the
    pool's keyword arguments past the shared ones and its kind's part of
    the key (None: keep none).  Where the blocks replay CUDA graphs, a pool
    is kept in ``cls.kept`` for every dispatch whose blocks' Python would
    be the same: the options but the seed, the lanes, pixel slots, the
    device, the ``pixel_fn``, ``accel`` and ``bvh`` (by identity), the
    scene's tensors (_SceneCache; the fields ``cls.loose``, which each call
    copies in, by shape and dtype alone) and the kind's part.  A pool built
    on other tables, or before a scene tensor changed in place, is
    replaced."""
    n_pix = pixel_ids.shape[0]
    kw, own = cls.variant(scene, pixel_ids)

    def build(sc):
        return cls(sc, bvh, opts, r, n_pix, pixel_fn, accel, **kw)

    if own is None or not _captures(scene.device):
        return build(scene), False
    key = (opts.replace(seed=0), r, n_pix, scene.device, pixel_fn is None,
           accel is None, bvh is None, *own)
    return cls.kept.get(scene, key, build, (pixel_fn, accel, bvh),
                        loose=cls.loose)


def render_pixels_refill(
    scene: SceneArrays,
    bvh,
    opts: RenderOptions,
    pixel_ids,
    sample_offset: int = 0,
    lanes: int | None = None,
    differentiable: bool = False,
    pixel_fn=None,
    accel=None,
):
    """Persistent-wavefront renderer with pixel-pinned lane refill.

    A pool of ``lanes`` lanes drains a queue of pixel slots (``pixel_ids``);
    a lane runs all ``spp`` samples of its pixel back to back, summing their
    radiance in its own register, and stages the sum in its pend registers
    when the pixel completes.  The staged sums are added to a channel-major
    film every ``n_pend * spp`` iterations.  In compat mode the first
    sample's primary hit is cached and reused by the pixel's later samples
    (quirk #1: identical primaries), whose rays are parked.

    Each iteration shades the lanes' arrivals, builds the NEE shadow rays
    and the next segments, sorts the wavefront by (hit cluster, direction
    bin) when sorting is on, and makes one combined intersect call over
    [next arrivals; every light's shadow rays].

    Estimator and per-path RNG streams are those of the JAX package; every
    pixel is pinned to one lane, so the film does not depend on lane order.

    The forward loop (_FramePool) runs in blocks of ``_CHECK_EVERY``
    iterations, under ``torch.no_grad()``, and reads the drain predicate
    back between blocks.  ``differentiable=True`` (_GradPool) runs a static
    budget of iterations, ceil(n_pix * spp * e_seg / lanes) + max_depth +
    spp + 4 with e_seg = ``opts.bwd_seg_per_sample`` or 1.2 / (1 -
    rr_probability), in blocks of spp iterations, each ending by adding its
    pend registers into the film, and stops at a block boundary once the
    pool has drained.  If the budget ends with samples in flight, the ray
    count is negated: those samples are missing from the film.  When a
    scene tensor needs a gradient the blocks are one autograd node
    (_CheckpointedBlocks) that keeps each block's entry state and residuals
    and recomputes the block for backward.

    On a CUDA device every block after the first, of both passes, replays a
    CUDA graph (``_Blocks``; ``eager()`` turns that off), bit for bit the
    block run op by op; the pool, its buffers and its graphs are kept for
    the next call of the same shape (_kept_pool), whatever a gradient
    step's parameter values.

    Returns (mean radiance (n_pix, 3) aligned with pixel_ids, rays traced as
    an int64 scalar tensor).
    """
    n_pix = pixel_ids.shape[0]
    r = min(lanes or n_pix, n_pix)
    dispatch = (pixel_ids, opts.seed, sample_offset)
    with span("pool_setup", {"lanes": r}) as setup:
        pool, reused = _kept_pool(_GradPool if differentiable else _FramePool,
                                  scene, bvh, opts, r, pixel_ids, pixel_fn,
                                  accel)
        setup.note(reused=int(reused), lights=pool.num_lights,
                   post_nee=int(pool.post_nee))
        pool.for_dispatch(*dispatch)
    return pool.run(scene, dispatch) if differentiable else pool.run()


@functools.lru_cache(maxsize=16)
def _first_slots(h: int, w: int, tile: int):
    """For each pixel of an h x w frame, the first slot of the tile-swizzled
    id list that holds it (host numpy, read-only)."""
    return np.unique(_tile_swizzled_ids(h, w, tile), return_index=True)[1]


def _frame_ids(scene, opts: RenderOptions):
    """(swizzled pixel ids (n_slots,) on the scene's device, their
    arithmetic twin)."""
    h, w = scene.camera.height, scene.camera.width
    tile = swizzle_tile(opts, scene.num_tris_padded)
    ids = torch.as_tensor(_tile_swizzled_ids(h, w, tile), device=scene.device)
    return ids, _swizzle_pixel_fn(h, w, tile)


def _frame_tables(scene, bvh, opts: RenderOptions):
    """(pixel ids, their pixel_fn, intersector tables) of a frame
    (_frame_ids, intersector_tables).  Where the blocks replay CUDA graphs
    they are kept from one frame to the next (_FRAME_TABLES, by the options
    but the seed, ``bvh`` and the scene's tensors), so that the frames'
    dispatches find their kept lane pools."""
    def build(sc):
        # ``bvh`` is held with the tables: the entry is built on it.
        return (*_frame_ids(sc, opts), intersector_tables(sc, opts, bvh), bvh)

    if not _captures(scene.device):
        return build(scene)[:3]
    return _FRAME_TABLES.get(scene, (opts.replace(seed=0), bvh is None), build,
                             (bvh,))[0][:3]


def _chunked_ids(ids, chunk: int):
    """(n_chunks, chunk) pixel ids, the last chunk padded with the last id."""
    pad = (-ids.shape[0]) % chunk
    return torch.cat([ids, ids[-1:].expand(pad)]).reshape(-1, chunk)


def _assemble_frame(acc, scene, opts: RenderOptions, spp: int):
    """(H, W, 3) frame from sums over _frame_ids' slots (padded chunks may
    add slots past them): each pixel from its first slot.  A duplicate id
    (an edge-tile clamp, a chunk's padding) renders the same value, and only
    its first slot is read, so each pixel's gradient is counted once, as in
    the JAX package's scatter."""
    h, w = scene.camera.height, scene.camera.width
    with span("assemble"):
        first = _first_slots(h, w, swizzle_tile(opts, scene.num_tris_padded))
        return (acc.index_select(0, torch.as_tensor(first, device=acc.device))
                / spp).reshape(h, w, 3)


def render_image_stats(scene: SceneArrays, bvh, opts: RenderOptions,
                       differentiable: bool = False, sample_offset: int = 0,
                       device=None):
    """Full-frame render -> ((H, W, 3) f32 radiance, rays traced).

    With ``opts.refill`` the whole frame's queue drains through one
    ``opts.chunk_size`` lane pool; otherwise pixel chunks of
    ``opts.chunk_size`` lanes (the last padded with its last id) go through
    the scan over samples one after another, on one _ScanFrame.  ``sample_offset`` slides the
    absolute sample window (progressive and resumed renders continue the
    same per-pixel RNG streams).  ``differentiable=True`` makes the image a
    function of the scene's material and light tensors for autograd
    (montecarlopathtracing_torch.diff.gradients).
    """
    scene = scene.to(resolve_device(device))
    h, w = scene.camera.height, scene.camera.width
    chunk = min(opts.chunk_size, max(1024, h * w))
    ids, pixel_fn = _frame_ids(scene, opts)
    if opts.refill:
        out, rays = render_pixels_refill(scene, bvh, opts, ids, sample_offset,
                                         lanes=chunk,
                                         differentiable=differentiable,
                                         pixel_fn=pixel_fn)
        return _assemble_frame(out, scene, opts, 1), rays
    accel = intersector_tables(scene, opts, bvh)
    scan = _ScanFrame(scene, bvh, opts, chunk, differentiable, accel)
    outs, rays = [], 0
    for pix in _chunked_ids(ids, chunk):
        out, n = render_pixels(scene, bvh, opts, pix, differentiable,
                               sample_offset=sample_offset, accel=accel,
                               scan=scan)
        outs.append(out)
        rays = rays + n
    return _assemble_frame(torch.cat(outs), scene, opts, 1), rays


def render_image(scene: SceneArrays, bvh, opts: RenderOptions,
                 differentiable: bool = False, sample_offset: int = 0,
                 device=None):
    """Full-frame render -> (H, W, 3) f32 radiance (pre-tonemap)."""
    return render_image_stats(scene, bvh, opts, differentiable, sample_offset,
                              device=device)[0]


def render_image_host_chunked(scene: SceneArrays, bvh, opts: RenderOptions,
                              progress=None, retries: int = 0, device=None):
    """Full-frame render as one dispatch per (pixel chunk, spp chunk).

    Same result as render_image (identical RNG keying).  With
    ``opts.refill`` each dispatch drains the whole frame's queue for a slice
    of the samples, chunk sizes balanced (spp 25 at spp_chunk 8 renders
    5 x 5, not 8+8+8+1); otherwise each pixel chunk is rendered in
    ``spp_chunk`` slices by the scan over samples, all on one _ScanFrame.  A dispatch that raises
    is run again up to ``retries`` times: its samples are keyed by (pixel,
    absolute sample index), so a retry renders the same samples.
    Returns ((H, W, 3) f32 tensor on the render device, rays traced).
    The frame is one span, ``frame``, its request the seed.
    """
    with span("frame", {"spp": opts.spp}, request=opts.seed):
        scene = scene.to(resolve_device(device))
        h, w = scene.camera.height, scene.camera.width
        chunk = min(opts.chunk_size, max(1024, h * w))
        ids, pixel_fn, accel = _frame_tables(scene, bvh, opts)

        def dispatch(fn, **kw):
            for attempt in range(retries + 1):
                try:
                    with span("dispatch", {"spp": kw["opts"].spp,
                                           "attempt": attempt}):
                        out = fn(scene, bvh, accel=accel, **kw)
                        with span("sync"):  # surface faults here
                            if out[0].is_cuda:
                                torch.cuda.synchronize(out[0].device)
                    return out
                except Exception:
                    if attempt == retries:
                        raise
            raise AssertionError("unreachable")

        total_rays = 0
        steps = spp_steps(opts)
        if not opts.refill:
            chunks = _chunked_ids(ids, chunk)
            scan = _ScanFrame(scene, bvh, opts, chunk, False, accel)
            outs = []
            for ci, pix in enumerate(chunks):
                acc, done = None, 0
                for k in steps:
                    rad, rays = dispatch(render_pixels, opts=opts.replace(spp=k),
                                         pixel_ids=pix, sample_offset=done,
                                         scan=scan)
                    acc = rad * k if acc is None else acc + rad * k
                    total_rays += int(rays)
                    done += k
                outs.append(acc)
                if progress is not None:
                    progress(ci + 1, chunks.shape[0])
            return (_assemble_frame(torch.cat(outs), scene, opts, opts.spp),
                    float(total_rays))

        acc, done = None, 0
        for step, k in enumerate(steps):
            rad, rays = dispatch(render_pixels_refill, opts=opts.replace(spp=k),
                                 pixel_ids=ids, sample_offset=done, lanes=chunk,
                                 pixel_fn=pixel_fn)
            acc = rad * k if acc is None else acc + rad * k
            total_rays += int(rays)
            done += k
            if progress is not None:
                progress(step + 1, len(steps))
        return _assemble_frame(acc, scene, opts, opts.spp), float(total_rays)


def spp_steps(opts: RenderOptions) -> list:
    """The samples of each dispatch of render_image_host_chunked, in order.
    The lane pool balances them (spp 25 at spp_chunk 8 renders 5 x 5, not
    8+8+8+1); the scan over samples takes ``spp_chunk`` at a time."""
    spp = opts.spp
    spp_chunk = max(1, min(opts.spp_chunk, spp))
    if not opts.refill:
        return [min(spp_chunk, spp - done) for done in range(0, spp, spp_chunk)]
    n_steps = -(-spp // spp_chunk)
    for n in range(n_steps, min(2 * n_steps, spp) + 1):
        if spp % n == 0:
            n_steps = n
            break
    base, extra = divmod(spp, n_steps)
    return [base + (1 if step < extra else 0) for step in range(n_steps)]
