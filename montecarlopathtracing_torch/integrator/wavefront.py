"""Wavefront path-tracing integrator: forward and differentiable renders.

Counterpart of ``montecarlopathtracing_tpu/integrator/wavefront.py``: the
reference's recursive ``shade`` (``MTPC/pathTracing.cpp:137-266``) as a
persistent pool of lanes carrying per-lane throughput, with the reference's
event semantics (emitter short-circuit, one NEE sample per light, RR at 0.6,
diffuse/specular/transmission weights, nearest-neighbour textures).

The JAX ``lax.while_loop`` becomes a host loop over device tensors.  The
termination predicate is read back only every ``check_every`` iterations:
an iteration after the pool has drained changes nothing (no lane is active,
none is refilled, nothing is staged), so the film does not depend on it.

Two renderers: the lane pool (``render_pixels_refill``, the default) and the
scan over samples (``render_pixels`` with ``refill=False``, a bounce loop at
full width per sample, ``trace_paths``).  ``differentiable=True`` makes
either a function of the scene's material and light tensors that autograd
can take apart: traversal, visibility and the sampled directions are
detached (the JAX package's ``stop_gradient`` points), the loop runs a
static budget in blocks checkpointed with ``torch.utils.checkpoint``, and
intersect results and sort permutations are recorded on the forward pass and
replayed when a block is recomputed for backward (``_Replay``), so backward
launches no intersect kernel.

A scene whose triangle table is past the single-table budget renders through
the chunked or the supergroup ("HBM") cluster intersector, as
``resolve_plan`` decides; their tables are built once per scene
(``intersector_tables``).

Not ported yet: the LBVH walks (ROADMAP.md item A11).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..accel.lbvh import brute_force_intersect
from ..config import RenderOptions
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
    the card, their plain PyTorch versions on the CPU."""
    kind = "cluster" if opts.intersector == "auto" else opts.intersector
    if kind in ("bvh", "bvh_perray"):
        raise NotImplementedError(
            f"intersector={kind!r}: the LBVH walks are not ported yet "
            "(ROADMAP.md item A11)")
    if kind == "cluster_interpret":
        raise NotImplementedError(
            "intersector='cluster_interpret' is the JAX package's Pallas "
            "interpreter; in this package intersector='cluster' on a CPU "
            "scene runs the kernels' plain PyTorch versions")
    if kind not in ("cluster", "brute"):
        raise ValueError(f"unknown intersector {opts.intersector!r}")
    return kind


def resolve_plan(opts: RenderOptions, num_tris: int):
    """The intersector that will run for this (options, scene) pair, a
    4-tuple: ('cluster', width, group, n_chunks) for the cluster kernels
    (n_chunks > 1: chunked tables), ('cluster_hbm', 128, group, 1) for the
    supergroup intersector, or ('brute', None, None, 1).

    The policy is the JAX package's.  A table within the single-table budget
    is one table; past it the triangle range is cut into chunks, unless
    ``large_mode="hbm_always"`` asks for the supergroup intersector; past
    ``max_table_chunks`` chunks, ``large_mode`` "hbm" and "hbm_always" take
    the supergroup intersector, and "chunked" falls back to the LBVH packet
    walk, which is not ported yet."""
    kind = resolve_intersector(opts)
    if kind != "cluster":
        return kind, None, None, 1
    plan = _cluster_plan(opts, num_tris)
    if plan is not None and (plan[2] == 1 or opts.large_mode != "hbm_always"):
        return kind, plan[0], plan[1], plan[2]
    if opts.large_mode in ("hbm", "hbm_always"):
        g = max(1, (opts.cluster_width * opts.cluster_group) // 128)
        return kind + "_hbm", 128, g, 1
    raise NotImplementedError(
        f"a scene of {num_tris} padded triangles is past the chunk cap "
        f"(max_table_chunks={opts.max_table_chunks}) and large_mode="
        f"{opts.large_mode!r} falls back to the LBVH packet walk, not ported "
        "yet (ROADMAP.md item A11); large_mode='hbm' renders it")


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


def intersector_tables(scene, opts: RenderOptions):
    """The tables intersect_any needs for this scene, by plan: a
    ClusterAccel, a ChunkedClusterAccel, an HbmClusterAccel, or None for the
    brute-force oracle.  Build once per scene and pass as ``accel``."""
    kind, width, _, n_chunks = resolve_plan(opts, scene.num_tris_padded)
    if kind == "brute":
        return None
    mt = not opts.compat.plane_sign_triangle_test
    if kind == "cluster_hbm":
        return build_hbm_accel(build_cluster_accel(scene, width=width, mt=mt))
    if n_chunks > 1:
        return build_cluster_accel_chunked(scene, width=width,
                                           n_chunks=n_chunks, mt=mt)[0]
    return build_cluster_accel(scene, width=width, mt=mt)


def intersect_any(scene, bvh, origin, direction, opts: RenderOptions,
                  accel=None):
    """Nearest-hit dispatch: (hit (R,) bool, t (R,) f32, tri (R,) i32).
    ``bvh`` is unused (None) until the LBVH is ported; ``accel`` takes the
    prebuilt tables (intersector_tables), built here when it is None.
    Traversal is outside the gradient: the rays are detached."""
    origin, direction = origin.detach(), direction.detach()
    compat_tri = opts.compat.plane_sign_triangle_test
    kind, _, group, n_chunks = resolve_plan(opts, scene.num_tris_padded)
    if kind == "brute":
        return brute_force_intersect(scene, origin, direction, compat=compat_tri)
    if accel is None:
        accel = intersector_tables(scene, opts)
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
    f = torch.float32
    mtab = torch.cat([
        scene.kd, scene.ks, scene.emission,
        scene.ns[:, None], scene.ni[:, None],
        scene.is_emitter[:, None].to(f), scene.has_texture[:, None].to(f),
        scene.tex_offset[:, None].to(f), scene.tex_h[:, None].to(f),
        scene.tex_w[:, None].to(f),
    ], dim=1)
    return tab, mtab


class _TableRows(torch.autograd.Function):
    """``table[idx]`` for a table of a few rows that every lane reads (the
    materials).  The forward pass is the plain row gather; the backward
    pass sums the cotangent rows per table row by a one-hot matrix product
    (the JAX package's form for up to 64 materials), or by index_add past
    64 rows, rather than by the indexing backward, which sorts the indices
    and serialises on repeats: 6.7 ms a call at 65,536 lanes and six
    materials (profile_torch.py --grad; NVIDIA H100 80GB HBM3, 700 W)."""

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
        return ct.new_zeros((ctx.rows,) + ct.shape[1:]).index_add_(0, idx, ct), None


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
    smat (L,R)); dead / black-kd lanes' shadow rays are parked at 1e9.
    """
    compat = opts.compat
    tab, _ = tables
    r = p.shape[0]
    num_lights = scene.num_lights
    if num_lights == 0:
        e3 = p.new_zeros((0, r, 3))
        return e3, e3, e3, alive.new_zeros((0, r)), p.new_zeros((0, r)), \
            torch.zeros((0, r), dtype=_I32, device=p.device)
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
            torch.stack(ok_l), torch.stack(dist_l), torch.stack(smat_l))


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


class _Replay:
    """Results that do not depend on the scene's parameters (intersect
    results, sort permutations and their inverses), recorded under a key on
    the forward pass and handed back when torch.utils.checkpoint recomputes
    a block for backward, so the recompute launches no intersect kernel and
    sorts nothing (the JAX package saves the same residuals by name,
    ``isect_*`` and ``perm_inv``).  Keys make the replay independent of the
    order of nested recomputes; ``scope`` prefixes them.  Disabled, it just
    calls."""

    def __init__(self, enabled: bool, saved=None, prefix=()):
        self.enabled = enabled
        self.saved = {} if saved is None else saved
        self.prefix = prefix

    def scope(self, *key) -> "_Replay":
        return _Replay(self.enabled, self.saved, self.prefix + key)

    def __call__(self, key, fn):
        if not self.enabled:
            return fn()
        key = self.prefix + key
        if key not in self.saved:
            self.saved[key] = fn()
        return self.saved[key]


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
                direction, differentiable: bool = False, accel=None,
                replay=None):
    """Full light transport for a batch of primary rays, all lanes in
    lockstep: a bounce loop at full width while any lane is alive, up to
    ``max_depth`` bounces (exactly ``max_depth`` when ``differentiable``,
    each bounce checkpointed when ``max_depth > 4``).

    With sorting on and more lanes than one subtile, each bounce permutes
    the wavefront by (hit cluster, new direction bin) before its NEE and
    bounce rays are intersected; every per-lane quantity rides the
    permutation and ``slot`` unscrambles the radiance at the end.

    Returns (radiance (R,3), n_rays) where n_rays (int64 tensor) counts the
    primaries, one shadow ray per light per live lane and the bounce rays.
    ``replay`` (a _Replay) records the intersect results and sort orders of
    a differentiable render for its backward recompute.
    """
    if accel is None:
        accel = intersector_tables(scene, opts)
    track = differentiable and _tracks_grad(scene)
    if replay is None:
        replay = _Replay(track)
    tables = _shading_tables(scene)
    num_lights = scene.num_lights
    n_slots = rng.n_bounce_slots(num_lights)
    r = origin.shape[0]
    do_sort = _should_sort(opts, scene.num_tris_padded) and r > opts.cluster_rays

    def isect(key, o, d):
        return replay(key, lambda: intersect_any(scene, bvh, o, d, opts,
                                                 accel=accel))

    hit, t, tri = isect(("primary",), origin, direction)
    mat0 = scene.mat_id[torch.clamp(tri, min=0).long()].long()
    emit0 = hit & scene.is_emitter[mat0]
    # A primary emitter hit returns the light radiance.
    radiance = torch.where(emit0[:, None], _material_rows(scene.emission, mat0),
                           0.0)
    state = dict(alive=hit & ~emit0, origin=origin, direction=direction, t=t,
                 tri=tri, beta=torch.ones_like(radiance), radiance=radiance,
                 keys=keys, slot=torch.arange(r, dtype=_I32, device=origin.device),
                 n_rays=torch.tensor(r, dtype=torch.int64, device=origin.device))

    def bounce(st, depth: int):
        alive, direction, keys, slot = (st["alive"], st["direction"], st["keys"],
                                        st["slot"])
        beta, radiance, tri = st["beta"], st["radiance"], st["tri"]
        u = rng.bounce_uniforms(keys, depth, n_slots)
        p, pn, matf, kd = _gather_hit(scene, opts, st["origin"], direction,
                                      st["t"], tri, tables)
        cont = alive & (u[:, 0] < opts.rr_probability)
        new_o, new_d, ray_type, weight = _next_ray(scene, opts, p, pn, matf, kd,
                                                   direction, u)
        if do_sort:
            cluster = torch.clamp(tri, min=0) // opts.cluster_width
            sort_key = torch.where(alive, cluster * 64 + _direction_bin(new_d),
                                   2 ** 30)
            perm, inv = replay(("perm", depth),
                               lambda: _sort_perm(sort_key, track))
            (p, pn, kd, new_o, new_d, weight, beta, radiance, u), \
                (ray_type, keys, slot, alive, cont) = _permute_rows(
                    perm, (p, pn, kd, new_o, new_d, weight, beta, radiance, u),
                    (ray_type, keys, slot, alive, cont), inv)

        # Next-event estimation: one full nearest-hit shadow query per light.
        so, dirn, contrib, ok, dist, smat = _nee_prep(scene, opts, p, pn, kd, u,
                                                      alive, tables)
        shadow = [isect(("shadow", depth, li), so[li], dirn[li])
                  for li in range(num_lights)]
        if num_lights:
            l_dir = _nee_resolve(scene, opts, contrib, ok, dist, smat,
                                 *(torch.stack(x) for x in zip(*shadow)))
            radiance = radiance + torch.where(alive[:, None], beta * l_dir, 0.0)
        beta2 = (beta / opts.rr_probability) * weight

        # Russian-roulette-terminated lanes are parked.
        new_o = torch.where(cont[:, None], new_o, 1e9)
        hit2, t2, tri2 = isect(("bounce", depth), new_o, new_d)
        mat2 = scene.mat_id[torch.clamp(tri2, min=0).long()].long()
        emit2 = hit2 & scene.is_emitter[mat2]
        alive2 = cont & hit2
        # Specular and transmission bounces see emitters, diffuse ones do not.
        sees_emitter = alive2 & emit2 & (ray_type != RAY_DIFFUSE)
        radiance = radiance + torch.where(sees_emitter[:, None],
                                          beta2 * _material_rows(scene.emission,
                                                                 mat2), 0.0)
        n_rays = st["n_rays"] + alive.sum() * num_lights + cont.sum()
        return dict(alive=alive2 & ~emit2, origin=new_o, direction=new_d, t=t2,
                    tri=tri2, beta=beta2, radiance=radiance, keys=keys,
                    slot=slot, n_rays=n_rays)

    if differentiable:
        for depth in range(opts.max_depth):
            if track and opts.max_depth > 4:
                state = checkpoint(bounce, state, depth, use_reentrant=False,
                                   preserve_rng_state=False)
            else:
                state = bounce(state, depth)
    else:
        depth = 0
        while depth < opts.max_depth and bool(state["alive"].any()):
            state = bounce(state, depth)
            depth += 1
    radiance = state["radiance"]
    if do_sort:
        radiance = torch.zeros_like(radiance).index_copy(
            0, state["slot"].long(), radiance)
    return radiance, state["n_rays"]


def render_pixels(scene: SceneArrays, bvh, opts: RenderOptions, pixel_ids,
                  differentiable: bool = False, sample_offset: int = 0,
                  accel=None):
    """Mean radiance over ``opts.spp`` samples for flat pixel ids (R,).

    With ``opts.refill`` (the default) this is the lane pool with one lane
    per pixel (render_pixels_refill).  Otherwise a loop over sample indices
    runs trace_paths at full width for each, checkpointed per sample when
    ``differentiable``.  ``sample_offset`` slides the absolute sample
    window, so the samples of a split render are those of a one-pass one.

    Returns (mean radiance (R,3), rays traced as an int64 tensor).
    """
    if opts.refill:
        return render_pixels_refill(scene, bvh, opts, pixel_ids, sample_offset,
                                    differentiable=differentiable, accel=accel)
    if accel is None:
        accel = intersector_tables(scene, opts)
    track = differentiable and _tracks_grad(scene)
    replay = _Replay(track)
    compat = opts.compat

    def sample(s: int):
        keys = rng.lane_keys(opts.seed, pixel_ids, s + sample_offset)
        jitter = None if compat.no_pixel_jitter else rng.primary_uniforms(keys)
        origin, direction = primary_rays(scene.camera, pixel_ids, jitter)
        return trace_paths(scene, bvh, opts, keys, origin, direction,
                           differentiable, accel=accel, replay=replay.scope(s))

    acc = torch.zeros((pixel_ids.shape[0], 3), dtype=torch.float32,
                      device=scene.device)
    rays = torch.zeros((), dtype=torch.int64, device=scene.device)
    for s in range(opts.spp):
        rad, n = (checkpoint(sample, s, use_reentrant=False,
                               preserve_rng_state=False) if track
                  else sample(s))
        acc = acc + rad
        rays = rays + n
    return acc / opts.spp, rays


def render_pixels_refill(
    scene: SceneArrays,
    bvh,
    opts: RenderOptions,
    pixel_ids,
    sample_offset: int = 0,
    lanes: int | None = None,
    differentiable: bool = False,
    pixel_fn=None,
    check_every: int = 8,
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

    ``differentiable=True`` runs a static budget of iterations,
    ceil(n_pix * spp * e_seg / lanes) + max_depth + spp + 4 with e_seg =
    ``opts.bwd_seg_per_sample`` or 1.2 / (1 - rr_probability), in blocks of
    spp iterations (one pend slot per lane; a lane completes at most one
    pixel per spp iterations).  Each block is checkpointed when a scene
    tensor needs a gradient; its pend registers leave it as outputs and are
    reset, and all blocks' outputs are added into the film once, out of
    place, at the end.  The loop stops early at a block boundary once the
    pool has drained (later iterations change nothing).  If the budget ends
    with samples in flight, the ray count is negated: those samples are
    missing from the film.

    Returns (mean radiance (n_pix, 3) aligned with pixel_ids, rays traced as
    an int64 scalar tensor).
    """
    dev = scene.device
    n_pix = pixel_ids.shape[0]
    r = min(lanes or n_pix, n_pix)
    spp = opts.spp
    n_slots = rng.n_bounce_slots(scene.num_lights)
    do_sort = _should_sort(opts, scene.num_tris_padded) and r > opts.cluster_rays
    compat = opts.compat
    num_lights = scene.num_lights
    reuse_primary = compat.no_pixel_jitter
    lane_iota = torch.arange(r, dtype=_I32, device=dev)
    # Out-of-range dummies: the film has r * n_pend spare columns past
    # n_pix where non-pending lanes' flushes land; they are sliced off.
    dummy_slot = n_pix + lane_iota
    n_pend = 1 if differentiable else max(1, min(2, -(-16 // spp)))
    pend_iota = torch.arange(n_pend, dtype=_I32, device=dev)
    dummy_pend = n_pix + lane_iota[:, None] * n_pend + pend_iota[None, :]
    tables = _shading_tables(scene)
    if accel is None:
        accel = intersector_tables(scene, opts)

    track = differentiable and _tracks_grad(scene)
    replay = _Replay(track)

    def isect(o, d):
        return intersect_any(scene, bvh, o, d, opts, accel=accel)

    def primary_for(pix, keys):
        jitter = None if compat.no_pixel_jitter else rng.primary_uniforms(keys)
        return primary_rays(scene.camera, pix, jitter)

    def step(s, it: int):
        """Iteration ``it`` on the state dict ``s`` (its entries replaced,
        no tensor changed in place): shade arrivals, stage completed
        pixels, intersect."""
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
        post_nee = do_sort and num_lights >= 2
        if post_nee:
            beta_nee, keys_nee, depth_nee = beta, keys, depth
        else:
            so_s, dirn_s, contrib, ok_n, dist_n, smat_n = _nee_prep(
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
        slot_done = torch.where(pixel_done, slot, dummy_slot)
        safe_slot = torch.clamp(new_slot, max=n_pix - 1)
        pix_new = (pixel_fn(safe_slot) if pixel_fn is not None
                   else pixel_ids[safe_slot.long()])
        restart = next_samp | take
        pix2 = torch.where(take, pix_new, pix)
        samp2 = torch.where(take, sample_offset,
                            torch.where(next_samp, samp + 1, samp))
        keys2 = rng.lane_keys(opts.seed, pix2, samp2)
        o_prim, d_prim = primary_for(pix2, keys2)
        reuse = (next_samp & prim_ok if reuse_primary
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
            perm, inv = replay(("perm", it), lambda: _sort_perm(sort_key, track))
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
                so_s, dirn_s, contrib, ok_n, dist_n, smat_n = _nee_prep(
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
        hit_q, t_q, tri_q = replay(("isect", it), lambda: isect(all_o, all_d))
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
        stage = (pend_iota[None, :] == pc[:, None]) & pixel_done[:, None]
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

    # Bootstrap: the loop carries each lane's arrival, so the first batch of
    # primaries is intersected once up front.
    pix0 = pixel_ids[:r]
    keys0 = rng.lane_keys(opts.seed, pix0, sample_offset)
    o0, d0 = primary_for(pix0, keys0)
    hit0, t0, tri0 = isect(o0, d0)
    i32 = dict(dtype=_I32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    s = dict(
        q=torch.tensor(r, **i32),
        n_rays=torch.zeros((), dtype=torch.int64, device=dev),
        active=torch.ones((r,), dtype=torch.bool, device=dev),
        slot=lane_iota.clone(),
        pix=pix0,
        samp=torch.full((r,), sample_offset, **i32),
        samp_left=torch.full((r,), spp - 1, **i32),
        keys=keys0,
        depth=torch.zeros((r,), **i32),
        kind=torch.full((r,), KIND_PRIMARY, **i32),
        was_fresh=torch.ones((r,), dtype=torch.bool, device=dev),
        hit_a=hit0, t_a=t0, tri_a=tri0,
        prim_ok=torch.zeros((r,), dtype=torch.bool, device=dev),
        prim_hit=torch.zeros((r,), dtype=torch.bool, device=dev),
        prim_t=torch.zeros((r,), **f32),
        prim_tri=torch.zeros((r,), **i32),
        pend_slot=dummy_pend.clone(),
        pend_count=torch.zeros((r,), **i32),
        origin=o0.contiguous(), direction=d0,
        beta=torch.ones((r, 3), **f32),
        rad=torch.zeros((r, 3), **f32),
        pend_r=torch.zeros((r, n_pend), **f32),
        pend_g=torch.zeros((r, n_pend), **f32),
        pend_b=torch.zeros((r, n_pend), **f32),
    )

    # Channel-major film with r * n_pend spare columns for the dummies.
    film = torch.zeros((3, n_pix + r * n_pend), **f32)

    def drained() -> bool:
        return not bool(((s["q"] < n_pix) | s["active"].any()).item())

    if differentiable:
        e_seg = (opts.bwd_seg_per_sample if opts.bwd_seg_per_sample is not None
                 else 1.2 / (1.0 - opts.rr_probability))
        n_iter = int(np.ceil(n_pix * spp * e_seg / r)) + opts.max_depth + spp + 4
        k_steps = n_pend * spp

        def block(b: int, st):
            st = dict(st)
            for k in range(k_steps):
                step(st, b * k_steps + k)
            out = (st["pend_slot"].reshape(-1),
                   torch.stack([st[k].reshape(-1)
                                for k in ("pend_r", "pend_g", "pend_b")]))
            zero = torch.zeros((r, n_pend), **f32)
            st.update(pend_slot=dummy_pend, pend_count=torch.zeros((r,), **i32),
                      pend_r=zero, pend_g=zero, pend_b=zero)
            return st, out

        outs = []
        for b in range(-(-n_iter // k_steps)):
            if drained():
                break
            s, out = (checkpoint(block, b, s, use_reentrant=False,
                                 preserve_rng_state=False) if track
                      else block(b, s))
            outs.append(out)
        # Real slots are unique over the frame; dummies repeat across blocks
        # and land in the spare columns.
        film = film.index_add(1, torch.cat([o[0] for o in outs]).long(),
                              torch.cat([o[1] for o in outs], dim=1))
        n_rays = s["n_rays"] if drained() else -s["n_rays"]
        return film[:, :n_pix].T / spp, n_rays

    def flush():
        # Real slots are unique (each pixel completes once per dispatch), so
        # every film entry receives one add and the order is immaterial.
        idx = s["pend_slot"].reshape(-1).long()
        vals = torch.stack([s["pend_r"].reshape(-1), s["pend_g"].reshape(-1),
                            s["pend_b"].reshape(-1)])
        film.index_add_(1, idx, vals)
        s["pend_slot"] = dummy_pend
        s["pend_count"] = torch.zeros((r,), **i32)

    flush_every = max(1, n_pend * spp)
    i = 0
    while True:
        if i % check_every == 0 and drained():
            break
        step(s, i)
        if (i + 1) % flush_every == 0:
            flush()
        i += 1
    flush()  # pendings staged since the last cadence boundary
    return film[:, :n_pix].T / spp, s["n_rays"]


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
    the scan over samples one after another.  ``sample_offset`` slides the
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
    accel = intersector_tables(scene, opts)
    outs, rays = [], 0
    for pix in _chunked_ids(ids, chunk):
        out, n = render_pixels(scene, bvh, opts, pix, differentiable,
                               sample_offset=sample_offset, accel=accel)
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
    ``spp_chunk`` slices by the scan over samples.  A dispatch that raises
    is run again up to ``retries`` times: its samples are keyed by (pixel,
    absolute sample index), so a retry renders the same samples.
    Returns ((H, W, 3) f32 tensor on the render device, rays traced).
    """
    scene = scene.to(resolve_device(device))
    h, w = scene.camera.height, scene.camera.width
    chunk = min(opts.chunk_size, max(1024, h * w))
    spp_chunk = max(1, min(opts.spp_chunk, opts.spp))
    ids, pixel_fn = _frame_ids(scene, opts)
    accel = intersector_tables(scene, opts)

    def dispatch(fn, **kw):
        for attempt in range(retries + 1):
            try:
                out = fn(scene, bvh, accel=accel, **kw)
                if out[0].is_cuda:
                    torch.cuda.synchronize(out[0].device)  # surface faults here
                return out
            except Exception:
                if attempt == retries:
                    raise
        raise AssertionError("unreachable")

    total_rays = 0
    if not opts.refill:
        chunks = _chunked_ids(ids, chunk)
        outs = []
        for ci, pix in enumerate(chunks):
            acc, done = None, 0
            while done < opts.spp:
                k = min(spp_chunk, opts.spp - done)
                rad, rays = dispatch(render_pixels, opts=opts.replace(spp=k),
                                     pixel_ids=pix, sample_offset=done)
                acc = rad * k if acc is None else acc + rad * k
                total_rays += int(rays)
                done += k
            outs.append(acc)
            if progress is not None:
                progress(ci + 1, chunks.shape[0])
        return (_assemble_frame(torch.cat(outs), scene, opts, opts.spp),
                float(total_rays))

    n_steps = -(-opts.spp // spp_chunk)
    for n in range(n_steps, min(2 * n_steps, opts.spp) + 1):
        if opts.spp % n == 0:
            n_steps = n
            break
    base, extra = divmod(opts.spp, n_steps)
    acc, done, step = None, 0, 0
    while done < opts.spp:
        k = base + (1 if step < extra else 0)
        rad, rays = dispatch(render_pixels_refill, opts=opts.replace(spp=k),
                             pixel_ids=ids, sample_offset=done, lanes=chunk,
                             pixel_fn=pixel_fn)
        acc = rad * k if acc is None else acc + rad * k
        total_rays += int(rays)
        done += k
        step += 1
        if progress is not None:
            progress(step, n_steps)
    return _assemble_frame(acc, scene, opts, opts.spp), float(total_rays)
