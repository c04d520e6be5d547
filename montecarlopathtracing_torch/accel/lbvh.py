"""LBVH over the scene's triangle order as a perfect implicit heap, and its
two nearest-hit walks.

Counterpart of ``montecarlopathtracing_tpu/accel/lbvh.py``.  The triangle
array is already padded to ``Lc = 2^ceil(log2 T)`` slots whose padding rows
get empty boxes (min = +BIG, max = -BIG), so the tree is perfect:

* flat node arrays of ``2 * Lc`` rows in 1-based heap order: children of
  ``k`` are ``2k`` and ``2k+1``, leaves are ``k`` in ``[Lc, 2 Lc)``, slot 0
  is unused;
* the build is log2(Lc) pairwise min / max reductions (exact in f32, so the
  tensor build, the NumPy build and the JAX build agree bit for bit);
* the walks are stackless: descend left on a box hit, else ``_advance`` to
  the next subtree in preorder.

``bvh_intersect`` walks one ray at a time and ``packet_intersect`` walks a
packet of rays down one shared trail to fat leaves of ``leaf_width``
triangles.  Each is a wrapper: on CUDA tensors it launches its kernel
(``kernels/csrc/bvh_walk.cu``, ``kernels/csrc/packet_walk.cu``), on CPU
tensors it runs its plain PyTorch version (``bvh_intersect_plain``,
``packet_intersect_plain``).  The JAX package's walks are XLA while loops; a
PyTorch host loop would end every step in a host sync, so on the card each
walk is one kernel with its loop on the device.  ``brute_force_intersect``
tests every triangle: the oracle the intersectors are held to.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import numpy as np
import torch

from ..ops.intersect import ray_aabb, ray_triangle

BIG = 1e30
_I32 = torch.int32

# Host-sync cadence of the plain walks: a step after every walk has ended
# changes nothing, so the loops read the termination predicate back only
# every few steps.
_CHECK_EVERY = 8


@dataclasses.dataclass(frozen=True)
class BVHArrays:
    """1-based heap: slot 0 unused, root at 1, leaves at [num_leaves, 2*num_leaves)."""

    node_min: Any  # (2*Lc, 3) f32
    node_max: Any  # (2*Lc, 3) f32

    @property
    def num_leaves(self) -> int:
        return self.node_min.shape[0] // 2

    @functools.cached_property
    def node_records(self):
        """(2*Lc, 6) f32, one 24-byte row per node: min xyz, max xyz.  The
        walk kernels' layout (a node's box in three 8-byte loads), made once
        per BVHArrays on first use."""
        return torch.cat([self.node_min, self.node_max], dim=1).contiguous()

    @functools.cached_property
    def finite(self) -> bool:
        """Every node box value is finite (a NaN or infinite vertex would
        put one there): then the walk kernels may take their fmaxf slab
        test.  Read back once per BVHArrays."""
        return bool(torch.isfinite(self.node_records).all())

    def to(self, device) -> "BVHArrays":
        return BVHArrays(node_min=self.node_min.to(device),
                         node_max=self.node_max.to(device))


def build_lbvh(scene) -> BVHArrays:
    """Level-synchronous bottom-up build on the scene's device.

    Internal box = union of the children; padded subtrees stay empty, so a
    node whose right subtree is all padding gets exactly its left child's
    box (the reference's single-child copy, ``findBondingBox(BVHNode&)``,
    MTPC/BVH.cpp:116-124).
    """
    valid = scene.tri_valid[:, None]
    big = torch.full_like(scene.v0, BIG)
    leaf_min = torch.where(valid, torch.minimum(torch.minimum(scene.v0, scene.v1),
                                                scene.v2), big)
    leaf_max = torch.where(valid, torch.maximum(torch.maximum(scene.v0, scene.v1),
                                                scene.v2), -big)
    mins, maxs = [leaf_min], [leaf_max]
    while mins[0].shape[0] > 1:
        mins.insert(0, torch.amin(mins[0].reshape(-1, 2, 3), dim=1))
        maxs.insert(0, torch.amax(maxs[0].reshape(-1, 2, 3), dim=1))
    # Concatenated by depth, node k sits at flat row k - 1; a dummy slot 0
    # makes the children 2k / 2k+1.
    node_min = torch.cat([big[:1]] + mins, dim=0)
    node_max = torch.cat([-big[:1]] + maxs, dim=0)
    return BVHArrays(node_min=node_min, node_max=node_max)


def build_lbvh_host(scene) -> BVHArrays:
    """NumPy twin of build_lbvh, run on the host and uploaded to the scene's
    device.  Bit-identical node arrays (min / max are exact in f32)."""
    v0, v1, v2 = (getattr(scene, f).detach().cpu().numpy() for f in ("v0", "v1", "v2"))
    valid = scene.tri_valid.cpu().numpy()[:, None]
    big = np.float32(BIG)
    leaf_min = np.where(valid, np.minimum(np.minimum(v0, v1), v2), big)
    leaf_max = np.where(valid, np.maximum(np.maximum(v0, v1), v2), -big)
    mins, maxs = [leaf_min], [leaf_max]
    while mins[0].shape[0] > 1:
        mins.insert(0, np.min(mins[0].reshape(-1, 2, 3), axis=1))
        maxs.insert(0, np.max(maxs[0].reshape(-1, 2, 3), axis=1))
    node_min = np.concatenate([np.full((1, 3), big, np.float32)] + mins, axis=0)
    node_max = np.concatenate([np.full((1, 3), -big, np.float32)] + maxs, axis=0)
    dev = scene.v0.device
    return BVHArrays(node_min=torch.as_tensor(node_min, device=dev),
                     node_max=torch.as_tensor(node_max, device=dev))


def _advance(k):
    """Next subtree in preorder: strip trailing 1-bits (pop while right
    child), then step to the sibling.  0 (done) past the root.

    For 1-based heap keys "is a right child" is the lowest bit, so the pop
    loop is one divide by the lowest zero bit z = ~k & (k+1)."""
    z = torch.bitwise_and(torch.bitwise_not(k), k + 1)
    up = torch.div(k, z, rounding_mode="floor")
    return torch.where(up <= 1, torch.zeros_like(up), up + 1)


def _check_walk_inputs(name, origin, direction):
    if origin.shape != direction.shape or origin.dim() != 2 or origin.shape[1] != 3:
        raise ValueError(f"{name}: origin and direction must both be (R, 3)")
    if origin.dtype != torch.float32 or direction.dtype != torch.float32:
        raise TypeError(f"{name}: origin and direction must be float32")


# --------------------------------------------------------------------------
# The per-ray walk.
# --------------------------------------------------------------------------

def bvh_intersect_plain(bvh: BVHArrays, scene, origin, direction,
                        compat: bool = True, max_steps: int | None = None,
                        counts: dict | None = None):
    """Plain PyTorch version of the per-ray walk (see bvh_intersect): every
    ray steps in lockstep, one heap node per ray per step.  ``counts``, if
    given, receives the (ray, node) slab tests and (ray, triangle) tests the
    walk made ("node_tests", "tri_tests")."""
    origin = origin.detach()
    direction = direction.detach()
    lc = bvh.num_leaves
    r = origin.shape[0]
    dev = origin.device
    inv_dir = 1.0 / direction
    if max_steps is None:
        max_steps = 4 * lc + 64  # full-tree preorder walk upper bound
    k = torch.ones(r, dtype=torch.int64, device=dev)
    best_t = torch.full((r,), BIG, dtype=torch.float32, device=dev)
    best_tri = torch.full((r,), -1, dtype=_I32, device=dev)
    n_node = n_tri = torch.zeros((), dtype=torch.int64, device=dev)
    for step in range(max_steps):
        if step % _CHECK_EVERY == 0 and not bool((k > 0).any()):
            break
        active = k > 0
        ksafe = torch.clamp(k, min=1)
        hit_box = ray_aabb(origin, inv_dir, bvh.node_min[ksafe],
                           bvh.node_max[ksafe], t_max=best_t) & active
        is_leaf = ksafe >= lc
        if counts is not None:
            n_node = n_node + active.sum()
            n_tri = n_tri + (hit_box & is_leaf).sum()
        tri = torch.where(is_leaf, ksafe - lc, torch.zeros_like(ksafe))
        hit_t, t, _ = ray_triangle(origin, direction, scene.v0[tri], scene.v1[tri],
                                   scene.v2[tri], scene.geom_n[tri], compat)
        better = (hit_box & is_leaf & hit_t & scene.tri_valid[tri] & (t > 0)
                  & (t < best_t))
        best_t = torch.where(better, t, best_t)
        best_tri = torch.where(better, tri.to(_I32), best_tri)
        k_next = torch.where(hit_box & ~is_leaf, 2 * ksafe, _advance(ksafe))
        k = torch.where(active, k_next, torch.zeros_like(k_next))
    _add_counts(counts, n_node, n_tri)
    hit = best_tri >= 0
    return hit, torch.where(hit, best_t, torch.full_like(best_t, BIG)), best_tri


def _add_counts(counts, n_node, n_tri):
    if counts is not None:
        counts["node_tests"] = counts.get("node_tests", 0) + int(n_node)
        counts["tri_tests"] = counts.get("tri_tests", 0) + int(n_tri)


# Counters per ray that a measurement build of csrc/bvh_walk.cu
# (-DMCPT_WALK_STATS in kernels/build.py's EXTRA_FLAGS) writes into
# bvh_intersect's ``stats``: steps, leaf steps with a triangle test, clock
# cycles of the ray's walk and of its steps' parts (waiting for the node's
# box, the slab test and the choice of the next key, waiting for the leaf's
# triangle, the triangle test), the global index of the thread and the block
# that ended it, %globaltimer (ns) at the walk's start and end, the steps
# it took as the only lane of its warp still walking, its steps at nodes of
# the top 11 levels, and its share of warp iterations: the sum over its
# steps of 2^20 / the lanes stepping in its warp then (kRayStats).
BVH_WALK_STATS = ("steps", "leaf_tests", "cycles", "cycles_node", "cycles_slab",
                  "cycles_leaf_load", "cycles_leaf_test", "thread", "block",
                  "start_ns", "end_ns", "lone_steps", "top_steps", "warp_share")
_SHARE_ONE = 2 ** 20


def bvh_intersect(bvh: BVHArrays, scene, origin, direction, compat: bool = True,
                  max_steps: int | None = None, stats=None):
    """Nearest hit for a batch of rays, each walking the heap on its own.

    origin/direction: (R,3).  Returns (hit (R,) bool, t (R,) f32, tri (R,)
    i32): the smallest t > 0 over valid triangles (MTPC/pathTracing.cpp:
    355-361), a miss as t = 1e30, tri = -1.  A box is entered when its slab
    test passes with t_max = the ray's best t so far; a leaf's triangle wins
    only at t strictly below it.  The walk stops after ``max_steps`` steps
    (default 4 Lc + 64).  Traversal is outside the gradient.  On CUDA
    tensors this launches csrc/bvh_walk.cu, which reads ``bvh.node_records``
    and ``scene.tri_records``; on CPU tensors it runs bvh_intersect_plain.
    ``stats`` (card only): None, or an int64 (R, len(BVH_WALK_STATS)) tensor
    that a -DMCPT_WALK_STATS build of the kernel fills (others leave it).
    """
    _check_walk_inputs("bvh_intersect", origin, direction)
    if origin.device.type == "cpu":
        if stats is not None:
            raise ValueError("bvh_intersect: stats come from a measurement "
                             "build of the CUDA kernel; the CPU has none")
        return bvh_intersect_plain(bvh, scene, origin, direction, compat, max_steps)
    from ..kernels.cluster import _check_cuda_inputs, _ptr, _stream
    from ..kernels.build import load

    lc = bvh.num_leaves
    if max_steps is None:
        max_steps = 4 * lc + 64
    origin = origin.detach().contiguous()
    direction = direction.detach().contiguous()
    nodes, tris = _walk_records("bvh_intersect", bvh, scene)
    dev = _check_cuda_inputs("bvh_intersect", origin=origin, direction=direction,
                             node_records=nodes, tri_records=tris)
    r = origin.shape[0]
    if stats is not None and (stats.dtype != torch.int64 or stats.device != dev
                              or not stats.is_contiguous()
                              or stats.shape != (r, len(BVH_WALK_STATS))):
        raise ValueError(f"bvh_intersect: stats must be int64 ({r}, "
                         f"{len(BVH_WALK_STATS)}) on {dev}")
    out_t = torch.empty((r,), dtype=torch.float32, device=dev)
    out_tri = torch.empty((r,), dtype=_I32, device=dev)
    if r == 0:
        return out_tri >= 0, out_t, out_tri
    fn = load("bvh_walk")
    with torch.cuda.device(dev):
        err = fn(_ptr(origin), _ptr(direction), r, _ptr(nodes), lc, _ptr(tris),
                 int(not compat), int(min(max_steps, 2**31 - 1)), int(bvh.finite),
                 _ptr(out_t), _ptr(out_tri), _ptr(stats), _stream(dev))
    if err != 0:
        raise RuntimeError(f"bvh_walk launch failed: CUDA error {err}")
    bvh_intersect.launches += 1
    return out_tri >= 0, out_t, out_tri


bvh_intersect.launches = 0


def bvh_walk_stats_summary(stats) -> dict:
    """What the counters of a -DMCPT_WALK_STATS build of the per-ray walk say
    over several calls: ``stats`` a list of (R, len(BVH_WALK_STATS)) int64
    tensors, one per call (each reduced on its own device first).  Steps
    per ray (mean, p99, max), leaf tests per ray; SIMT efficiency, the
    rays' steps over 32 times the warp iterations they took part in (each
    iteration counted once, by its lanes' shares); the share of those warp
    iterations in which one lane alone walked, and the share of steps at
    the top 11 levels; clock cycles per step and their split (node load,
    slab test and choice, leaf load, leaf test, the rest); and per call the
    span of the launch (first start to last end, ns) beside its blocks' own
    times: the mean block, the slowest block, and the times at which half,
    90% and all of the blocks had ended (from the first start), averaged
    over the calls."""
    col = {n: j for j, n in enumerate(BVH_WALK_STATS)}
    summed = ("steps", "leaf_tests", "cycles", "cycles_node", "cycles_slab",
              "cycles_leaf_load", "cycles_leaf_test", "lone_steps", "top_steps",
              "warp_share")
    tot = {k: 0.0 for k in summed + ("rays",)}
    hist = torch.zeros(1, dtype=torch.float64)
    steps_max = 0
    spans = {k: [] for k in ("span_ns", "block_mean_ns", "block_max_ns",
                             "blocks_half_done_ns", "blocks_90_done_ns")}
    for s in stats:
        s = s.detach()
        steps = s[:, col["steps"]]
        for k in summed:
            tot[k] += float(s[:, col[k]].sum())
        tot["rays"] += s.shape[0]
        steps_max = max(steps_max, int(steps.max()))
        h = torch.bincount(steps, minlength=hist.numel()).to(torch.float64).cpu()
        hist = torch.nn.functional.pad(hist, (0, h.numel() - hist.numel())) + h
        block = s[:, col["block"]]
        blocks, binv = torch.unique(block, return_inverse=True)
        nb = blocks.numel()
        t0 = torch.full((nb,), 2**62, dtype=torch.int64, device=s.device
                        ).scatter_reduce_(0, binv, s[:, col["start_ns"]], reduce="amin")
        t1 = torch.zeros(nb, dtype=torch.int64, device=s.device).scatter_reduce_(
            0, binv, s[:, col["end_ns"]], reduce="amax")
        first = int(t0.min())
        ends = torch.sort(t1 - first).values.to(torch.float64)
        spans["span_ns"].append(float(ends[-1]))
        dur = (t1 - t0).to(torch.float64)
        spans["block_mean_ns"].append(float(dur.mean()))
        spans["block_max_ns"].append(float(dur.max()))
        spans["blocks_half_done_ns"].append(float(ends[(nb - 1) // 2]))
        spans["blocks_90_done_ns"].append(float(ends[(9 * nb - 1) // 10]))
    rays = max(1.0, tot["rays"])
    steps = max(1.0, tot["steps"])
    warp_iters = tot["warp_share"] / _SHARE_ONE
    cdf = torch.cumsum(hist, 0) / rays
    out = {"calls": len(stats), "rays": int(tot["rays"]),
           "steps_per_ray_mean": tot["steps"] / rays,
           "steps_per_ray_p99": int(torch.searchsorted(cdf, torch.tensor(
               [0.99], dtype=torch.float64))[0]),
           "steps_per_ray_max": steps_max,
           "leaf_tests_per_ray": tot["leaf_tests"] / rays,
           "simt_efficiency": tot["steps"] / max(1.0, 32 * warp_iters),
           "lone_share_of_warp_steps": tot["lone_steps"] / max(1.0, warp_iters),
           "top_share_of_steps": tot["top_steps"] / steps,
           "cycles_per_step": tot["cycles"] / steps}
    parts = 0.0
    for part in ("node", "slab", "leaf_load", "leaf_test"):
        v = tot["cycles_" + part] / steps
        out["cycles_per_step_" + part] = v
        parts += v
    out["cycles_per_step_rest"] = out["cycles_per_step"] - parts
    for k, v in spans.items():
        out[k] = sum(v) / max(1, len(v))
    return out


def _check_tables(bvh: BVHArrays, scene):
    if bvh.node_min.shape != (2 * scene.num_tris_padded, 3):
        raise ValueError("walk: the LBVH was not built for this scene "
                         f"({tuple(bvh.node_min.shape)} nodes, "
                         f"{scene.num_tris_padded} padded triangles)")


def _walk_records(name: str, bvh: BVHArrays, scene):
    """The node and triangle records the walk kernels read
    (``bvh.node_records``, ``scene.tri_records``), checked."""
    _check_tables(bvh, scene)
    nodes, tris = bvh.node_records, scene.tri_records
    if nodes.dtype != torch.float32 or tris.dtype != torch.float32:
        raise TypeError(f"{name}: node_records and tri_records must be float32")
    lc = bvh.num_leaves
    if tris.shape != (lc, 12):
        raise ValueError(f"{name}: tri_records must be ({lc}, 12)")
    if nodes.data_ptr() % 8 or tris.data_ptr() % 16:
        raise ValueError(f"{name}: node_records and tri_records must be "
                         "8- and 16-byte aligned")
    return nodes, tris


# --------------------------------------------------------------------------
# The packet walk.
# --------------------------------------------------------------------------

def _packets(origin, direction, packet_size: int):
    """Rays padded with parked ones (origin 1e9, direction (1,0,0)) to a
    multiple of packet_size, as (n_packets, packet_size, 3)."""
    from ..kernels.cluster import _parked_directions

    r = origin.shape[0]
    pad = (-r) % packet_size
    if pad:
        origin = torch.cat([origin, origin.new_full((pad, 3), 1e9)])
        direction = torch.cat([direction, _parked_directions(direction, pad)])
    return (origin.reshape(-1, packet_size, 3),
            direction.reshape(-1, packet_size, 3))


def _packet_shape(bvh: BVHArrays, r: int, packet_size: int, leaf_width: int,
                  max_steps):
    lc = bvh.num_leaves
    leaf_width = min(leaf_width, lc)
    packet_size = max(1, min(packet_size, r))
    fat_start = lc // leaf_width  # heap key of the first fat leaf
    if max_steps is None:
        max_steps = 8 * fat_start + 64
    return lc, leaf_width, packet_size, fat_start, max_steps


def packet_intersect_plain(bvh: BVHArrays, scene, origin, direction,
                           compat: bool = True, packet_size: int = 1024,
                           leaf_width: int = 8, max_steps: int | None = None,
                           counts: dict | None = None):
    """Plain PyTorch version of the packet walk (see packet_intersect).  All
    packets step in lockstep, each with its own heap key; a step tests the
    fat leaves of only the packets that reached one with a box hit.
    ``counts`` as in bvh_intersect_plain (every ray of a walking packet
    makes the node's slab test; each ray that hit a fat leaf's box tests its
    leaf_width triangles)."""
    origin = origin.detach()
    direction = direction.detach()
    r = origin.shape[0]
    lc, lw, packet_size, fat_start, max_steps = _packet_shape(
        bvh, r, packet_size, leaf_width, max_steps)
    o, d = _packets(origin, direction, packet_size)
    n_pk = o.shape[0]
    dev = o.device
    inv_dir = 1.0 / d
    k = torch.ones(n_pk, dtype=torch.int64, device=dev)
    best_t = torch.full((n_pk, packet_size), BIG, dtype=torch.float32, device=dev)
    best_tri = torch.full((n_pk, packet_size), -1, dtype=_I32, device=dev)
    wide = torch.arange(lw, dtype=torch.int64, device=dev)
    n_node = n_tri = torch.zeros((), dtype=torch.int64, device=dev)
    for step in range(max_steps):
        if step % _CHECK_EVERY == 0 and not bool((k > 0).any()):
            break
        active = k > 0
        ksafe = torch.clamp(k, min=1)
        hits = ray_aabb(o, inv_dir, bvh.node_min[ksafe][:, None, :],
                        bvh.node_max[ksafe][:, None, :], t_max=best_t)  # (N, P)
        any_hit = hits.any(dim=1) & active
        is_fat = ksafe >= fat_start
        idx = torch.nonzero(any_hit & is_fat)[:, 0]
        if counts is not None:
            n_node = n_node + active.sum() * packet_size
            n_tri = n_tri + hits[idx].sum() * lw
        if idx.numel():
            # Dense (P, W) test of each such packet's fat leaf.
            tri0 = torch.clamp((ksafe[idx] - fat_start) * lw, 0, lc - lw)
            tris = tri0[:, None] + wide[None, :]  # (n, W)
            ht, t, _ = ray_triangle(
                o[idx][:, :, None, :], d[idx][:, :, None, :],
                scene.v0[tris][:, None], scene.v1[tris][:, None],
                scene.v2[tris][:, None], scene.geom_n[tris][:, None], compat)
            bt = best_t[idx]
            ok = (ht & scene.tri_valid[tris][:, None, :] & (t > 0)
                  & (t < bt[:, :, None]) & hits[idx][:, :, None])
            t = torch.where(ok, t, torch.full_like(t, BIG))
            j = torch.argmin(t, dim=2, keepdim=True)  # lowest j at equal t
            tj = torch.gather(t, 2, j)[:, :, 0]
            better = tj < bt
            best_t[idx] = torch.where(better, tj, bt)
            best_tri[idx] = torch.where(better, (tri0[:, None] + j[:, :, 0]).to(_I32),
                                        best_tri[idx])
        k_next = torch.where(any_hit & ~is_fat, 2 * ksafe, _advance(ksafe))
        k = torch.where(active, k_next, torch.zeros_like(k_next))
    _add_counts(counts, n_node, n_tri)
    best_t = best_t.reshape(-1)[:r]
    best_tri = best_tri.reshape(-1)[:r]
    hit = best_tri >= 0
    return hit, torch.where(hit, best_t, torch.full_like(best_t, BIG)), best_tri


# Counters per packet that a measurement build of csrc/packet_walk.cu
# (-DMCPT_WALK_STATS in kernels/build.py's EXTRA_FLAGS) writes into
# packet_intersect's ``stats``: steps, fat-leaf visits with a box hit, rays
# and warps that hit at those visits, then clock cycles as the block's
# thread 0 sees them: the whole walk, until the node's box is in registers,
# the slab tests, the step's barrier, staging the leaf, the leaf tests
# (kWalkStats).
PACKET_WALK_STATS = ("steps", "leaf_visits", "leaf_rays", "leaf_warps",
                     "cycles", "cycles_node", "cycles_slab", "cycles_barrier",
                     "cycles_leaf_stage", "cycles_leaf_test")


def packet_intersect(bvh: BVHArrays, scene, origin, direction,
                     compat: bool = True, packet_size: int = 1024,
                     leaf_width: int = 8, max_steps: int | None = None,
                     stats=None):
    """Nearest hit with packet traversal and fat leaves.

    Rays go in packets of ``packet_size`` consecutive rays (the tail padded
    with parked rays); a packet walks one shared trail, entering a node when
    ANY of its rays hits the node's box (each ray's slab test capped at its
    own best t), and stops ``log2(leaf_width)`` levels above the leaves: a
    fat leaf's ``leaf_width`` consecutive triangles are tested densely
    against the packet's rays whose box test passed.  A triangle wins when
    it is a hit, valid, 0 < t < the ray's best t; at equal t the lowest
    triangle wins.  At most ``max_steps`` steps (default 8 Lc / leaf_width
    + 64).  Results equal bvh_intersect's up to that tie rule and the step
    caps.  Returns (hit, t, tri) as bvh_intersect.  On CUDA tensors this
    launches csrc/packet_walk.cu (one block per packet, so packet_size <=
    1024); on CPU tensors it runs packet_intersect_plain.  ``stats`` (card
    only): None, or an int64 (n_packets, len(PACKET_WALK_STATS)) tensor
    that a -DMCPT_WALK_STATS build of the kernel fills (others leave it).
    """
    _check_walk_inputs("packet_intersect", origin, direction)
    if origin.device.type == "cpu":
        if stats is not None:
            raise ValueError("packet_intersect: stats come from a measurement "
                             "build of the CUDA kernel; the CPU has none")
        return packet_intersect_plain(bvh, scene, origin, direction, compat,
                                      packet_size, leaf_width, max_steps)
    from ..kernels.cluster import _check_cuda_inputs, _ptr, _stream
    from ..kernels.build import load

    r = origin.shape[0]
    lc, lw, packet_size, fat_start, max_steps = _packet_shape(
        bvh, r, packet_size, leaf_width, max_steps)
    if packet_size > 1024:
        raise ValueError(f"packet_intersect: packet_size {packet_size} > 1024, "
                         "the kernel's block size")
    if lw > 256:
        raise ValueError(f"packet_intersect: leaf_width {lw} > 256")
    nodes, tris = _walk_records("packet_intersect", bvh, scene)
    o, d = _packets(origin.detach().contiguous(), direction.detach().contiguous(),
                    packet_size)
    o, d = o.contiguous(), d.contiguous()
    dev = _check_cuda_inputs("packet_intersect", origin=o, direction=d,
                             node_records=nodes, tri_records=tris)
    n_pk = o.shape[0]
    if stats is not None and (stats.dtype != torch.int64 or stats.device != dev
                              or not stats.is_contiguous()
                              or stats.shape != (n_pk, len(PACKET_WALK_STATS))):
        raise ValueError(f"packet_intersect: stats must be int64 ({n_pk}, "
                         f"{len(PACKET_WALK_STATS)}) on {dev}")
    out_t = torch.empty((n_pk * packet_size,), dtype=torch.float32, device=dev)
    out_tri = torch.empty((n_pk * packet_size,), dtype=_I32, device=dev)
    if r == 0:
        return out_tri[:0] >= 0, out_t[:0], out_tri[:0]
    fn = load("packet_walk")
    with torch.cuda.device(dev):
        err = fn(_ptr(o), _ptr(d), n_pk, packet_size, _ptr(nodes), lc, lw,
                 _ptr(tris), int(not compat), int(min(max_steps, 2**31 - 1)),
                 int(bvh.finite), _ptr(out_t), _ptr(out_tri), _ptr(stats),
                 _stream(dev))
    if err != 0:
        raise RuntimeError(f"packet_walk launch failed: CUDA error {err}")
    packet_intersect.launches += 1
    out_t, out_tri = out_t[:r], out_tri[:r]
    return out_tri >= 0, out_t, out_tri


packet_intersect.launches = 0

def packet_walk_stats_summary(stats) -> dict:
    """What the counters of a -DMCPT_WALK_STATS build say over several
    calls: ``stats`` a list of (n_packets, len(PACKET_WALK_STATS)) int64
    tensors, one per call.  Steps per packet (mean, max), fat-leaf visits
    with a box hit per packet, rays and warps that hit per such visit,
    clock cycles per step and their split (node fetch, slab tests, barrier,
    leaf stage, leaf tests, the rest), and the longest trail of
    each call (the packet with the most cycles: a launch lasts as long as
    it), averaged over the calls."""
    rows = [s.detach().cpu().to(torch.float64) for s in stats]
    allr = torch.cat(rows)
    c = dict(zip(PACKET_WALK_STATS, allr.T))
    steps = max(1.0, float(c["steps"].sum()))
    visits = max(1.0, float(c["leaf_visits"].sum()))
    out = {"calls": len(rows), "packets": int(allr.shape[0]),
           "steps_per_packet_mean": float(c["steps"].mean()),
           "steps_per_packet_max": float(c["steps"].max()),
           "leaf_visits_per_packet": float(c["leaf_visits"].mean()),
           "rays_per_leaf_visit": float(c["leaf_rays"].sum()) / visits,
           "warps_per_leaf_visit": float(c["leaf_warps"].sum()) / visits,
           "cycles_per_step": float(c["cycles"].sum()) / steps}
    parts = 0.0
    for part in ("node", "slab", "barrier", "leaf_stage", "leaf_test"):
        v = float(c["cycles_" + part].sum()) / steps
        out["cycles_per_step_" + part] = v
        parts += v
    out["cycles_per_step_rest"] = out["cycles_per_step"] - parts
    longest = [r[int(torch.argmax(r[:, 4]))] for r in rows]
    out["longest_steps_mean"] = sum(float(r[0]) for r in longest) / len(rows)
    out["longest_cycles_mean"] = sum(float(r[4]) for r in longest) / len(rows)
    out["longest_cycles_per_step"] = out["longest_cycles_mean"] / max(
        1.0, out["longest_steps_mean"])
    return out


# Kernel name (kernels/build.py) -> its wrapper.
_WRAPPERS = {"bvh_walk": bvh_intersect, "packet_walk": packet_intersect}


def launch_counts() -> dict:
    """{kernel name: launches so far} for the walk kernels."""
    return {name: fn.launches for name, fn in _WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS.values():
        fn.launches = 0


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
