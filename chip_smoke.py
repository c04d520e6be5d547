#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases, always all of them, one JSON line each (any failure raises and
exits non-zero):

1. device   the card's name and power limit (nvidia-smi);
2. build    every CUDA kernel compiled from kernels/csrc (one nvcc per
            source, started together);
3. kernels  each kernel against its plain PyTorch version on the same CUDA
            tensors (keys, candidate lists, t and tri exactly equal), and the
            whole intersectors against brute force:
            (a) the box table with random rays, a ragged count and one parked
            subtile; (b) the 100k-triangle interior's table in compat and
            Moller-Trumbore mode, plus its camera and shadow rays at the main
            path's shape (131,072 rays); (c) the 400k-triangle interior's
            chunked and supergroup tables, compat and Moller-Trumbore: random
            rays (ragged, a parked subtile), rays from a corner that leave
            whole chunks parked, camera and shadow rays at the main path's
            shape, and the front-to-back kernel against the single-table
            kernel on one candidate set; (d) the key kernel on narrow tables
            (1, 2, 7 and 33 clusters) and the 400k tables with adversarial
            rays (0.0, -0.0 and denormal direction components, origins on a
            box face, parked rays, an all-parked subtile), single and over a
            chunk axis, keys, counts, ids, the fused front-to-back list and
            the row list all exact;
4. box      api.render_scene on the built-in box at 1024 x 1024, spp 16;
5. large    the 100k-triangle interior at 1280 x 720, spp 4, through
            render_image_host_chunked (single-table plan);
6. large400 the 400k-triangle interior at 1280 x 720 through
            api.render_scene, once with the default options (chunked plan)
            and once with large_mode="hbm_always" (supergroup plan); the two
            images must agree;
            each of 4, 5 and 6 renders its frame twice: once timed, with the
            launch counters zeroed just before and read just after, and once
            with the intersect calls recorded for phase 8;
7. parity   a 64 x 64 MODERN render on the card against the same render on
            the CPU (plain versions);
   scan     render_pixels with refill=False (the scan over samples) against
            refill=True on a 64 x 64 MODERN spec+glass box, spp 4, max_depth
            8: identical ray counts, every value within rtol 1e-4 / atol 1e-5;
   grad     (a) gradients of diff.gradients.image_loss on that box (MODERN,
            ns_gradient on) on the card against the port on the CPU, every
            SceneParams field within atol 1e-6 + 1e-4 of its largest
            magnitude; (b) central finite differences on the card for the
            White wall's kd[0] and light_radiance[0, 1] (eps and rtol of
            tests/test_gradients.py); (c) the full-width gradient, bench.py's
            backward configuration: the built-in box at 1024 x 1024, spp 16,
            max_depth 32, 65,536 lanes, bwd_seg_per_sample 2.15, d mean(image)
            / d SceneParams, once to warm up and once timed (forward and
            backward seconds, fwd+bwd rays/s, peak memory), the key and
            intersect launches counted in the forward pass (> 0) and in the
            backward pass (must be 0); (d) five diff.gradients.train_step
            calls at 256 x 256, spp 4, max_depth 8, from a grey red wall
            toward a target rendered with the true kd: the loss must fall and
            the red kd move toward the truth; (e) a gradient through the
            chunked plan (the 2k-triangle interior past lowered table
            budgets, 3 chunks, MODERN, 32 x 32) on the card against the CPU
            within (a)'s tolerance, rows 3 and 4 launched in the forward pass
            and no key or intersect kernel in the backward pass;
8. timing   every intersect call of the four frames replayed: each kernel
            and its plain version on the call's inputs, checked exactly
            equal and timed (CUDA events, device time only), with its bound,
            its bound with contraction off (bound_unfused_ms: the kernels are
            built with -fmad=false, so a multiply-add is two instructions
            and the card does half its f32 peak at most), and
            the ratio of the frame's slowest launch to the mean; on the 400k
            frames the key kernel's fused front-to-back list is held to the
            first ``count`` entries of the sorted list (_ftb_candidates) and
            its row list to exactly the rows with candidates on every call,
            the intersect kernels fed by the fused list to the same kernels
            fed by the sorted list, and the key kernel is timed with and
            without the list beside ``torch.sort`` on the same packed words
            (library_ms: the library call for the ordering part; on the box
            and 100k frames the ``torch.sort`` that lists a call's hit
            clusters ascending);
            for the front-to-back kernels also the (subtile, candidate) pairs
            tested, against all candidate pairs and against the pairs no
            exact exit could skip; row 4 also under two measurement builds of
            its source: its tests compiled out (ms_skip_tests), and its
            counters (blocks that found no row, the share of (ray, triangle)
            pairs and of warp steps that an exact plane-distance reject would
            decide), beside the row list's length per call;
9. a "kernels" line with one row per ported kernel, then the card's
   nvidia-smi line, then the last line {"ok": true, "device": {...}}.

The recording renders and the replays of phase 8 come after the counters are
read and are not counted.
Imports only numpy, torch and montecarlopathtracing_torch.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# NVIDIA H100 SXM published peaks (data sheet): f32 outside the tensor
# cores, and HBM3 bandwidth.
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
OPS_KEY_PAIR = 20      # f32 ops per (ray, cluster) slab test
OPS_TRI_PAIR = 34      # f32 ops per (ray, triangle) test

# Rays tested per kernel call on the main path: 65,536 lanes' next segments
# plus one shadow ray each (one light).
MAIN_RAYS = 131072

# Samples per pixel of the 400k-triangle frames (every intersect call of
# both is replayed against the plain versions, which bounds it).
LARGE400_SPP = 4
MEGA = 16              # RenderOptions().cluster_mega: the ray padding unit

# GPU clock cycles the stream sleeps before a timed call (~1 ms on an H100),
# so the host has enqueued the call before the start event is stamped.
SLEEP_CYCLES = 2_000_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# Phase 3 helpers.
# ---------------------------------------------------------------------------

def camera_and_shadow_rays(scene, n_lanes: int, seed: int, accel=None):
    """[camera segments of the first n_lanes swizzled pixels; one shadow ray
    from each primary hit toward a random point of the light], as the main
    path's combined intersect call sees them.  Misses' shadow rays park."""
    from montecarlopathtracing_torch.integrator.camera import primary_rays
    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.integrator.wavefront import (
        _tile_swizzled_ids, intersect_any)

    cam = scene.camera
    ids = torch.as_tensor(_tile_swizzled_ids(cam.height, cam.width, 64)[:n_lanes],
                          device=scene.device)
    o, d = primary_rays(cam, ids)
    o = o.contiguous()
    hit, t, _ = intersect_any(scene, None, o, d, RenderOptions(), accel=accel)
    p = o + d * torch.where(hit, t, 0.0)[:, None]
    g = torch.Generator(device="cpu").manual_seed(seed)
    f = scene.light_face_tri[0][0].long()
    lv = torch.stack([scene.v0[f], scene.v1[f], scene.v2[f]])
    w = torch.rand((n_lanes, 3), generator=g).to(scene.device)
    w = w / w.sum(dim=1, keepdim=True)
    xl = w @ lv
    sd = xl - p
    sd = sd / torch.linalg.vector_norm(sd, dim=1, keepdim=True)
    so = torch.where(hit[:, None], p + 0.01 * sd, 1e9)
    return torch.cat([o, so]), torch.cat([d, sd])


def pad_rays(origin, direction, tile: int):
    """Pad to a multiple of ``tile`` with parked rays, as cluster_intersect
    does."""
    pad = (-origin.shape[0]) % tile
    return (torch.cat([origin, origin.new_full((pad, 3), 1e9)]),
            torch.cat([direction,
                       direction.new_tensor([[1.0, 0.0, 0.0]]).expand(pad, 3)]))


def exact_match(accel, origin, direction, mt: bool, tile: int, label: str):
    """Each kernel against its plain version on the same CUDA tensors: keys,
    counts, candidate lists, t and tri must be exactly equal.  Returns the
    kernels' outputs and the largest differences (0 when they match)."""
    from montecarlopathtracing_torch.kernels import cluster as K

    r = origin.shape[0]
    o, d = pad_rays(origin, direction, tile)
    rays = K.pack_rays(o, d)
    caabb = K._caabb(accel.cmin, accel.cmax)
    keys, counts, ids = K.cluster_keys(rays, caabb, tile)
    keys_p, counts_p, ids_p = K.cluster_keys_plain(rays, caabb, tile)
    check(torch.equal(keys, keys_p), f"{label}: keys differ from the plain version")
    check(torch.equal(counts, counts_p), f"{label}: candidate counts differ")
    used = (torch.arange(ids.shape[1], device=ids.device)[None, :]
            < counts[:, None])
    check(torch.equal(torch.where(used, ids, -1), torch.where(used, ids_p, -1)),
          f"{label}: candidate lists differ")
    rays_i = K.pack_rays(o, d, mt=True) if mt else rays
    bt, bi = K.cluster_intersect_padded(rays_i, counts, ids, accel.tconst, tile, mt)
    bt_p, bi_p = K.cluster_intersect_padded_plain(rays_i, counts, ids,
                                                  accel.tconst, tile, mt)
    check(torch.equal(bt, bt_p) and torch.equal(bi, bi_p),
          f"{label}: intersect (t, tri) differ from the plain version")
    finite = keys < 1e30
    return {"case": label, "rays": r, "clusters": accel.num_clusters,
            "width": accel.width, "mt": mt, "candidates": int(counts.sum()),
            "keys_max_abs_err": float(torch.abs(keys - keys_p)[finite].max())
            if bool(finite.any()) else 0.0,
            "t_max_abs_err": float(torch.abs(bt - bt_p).max())}


def brute_contract(scene, got, origin, direction, mt: bool, label: str,
                   outliers: float = 0.0):
    """A whole intersector's result ``got`` against brute force under the
    test suite's contract: hit mask equal, t within rtol 1e-4 / atol 1e-5,
    tri equal on >= 99% of hits (ids may differ only at equal-t ties).  At
    most the share ``outliers`` of the rays may fall outside it: 0 on the
    small tables; 1 in 1,000 on the 400k-triangle scene, where among
    thousands of rays through triangles a few millimetres across some ray
    grazes a silhouette edge and accept or reject hangs on the last bit
    (brute force on the card rounds its fused elementwise expressions
    differently from the table form, whose kernels and plain versions are
    held equal bit for bit elsewhere), so that ray hits what lies behind."""
    from montecarlopathtracing_torch.accel.lbvh import brute_force_intersect

    hc, tc, ic = got
    hb, tb, ib = brute_force_intersect(scene, origin, direction, compat=not mt)
    both = hb & hc
    outside = (hb != hc) | (both & (torch.abs(tb - tc)
                                    > 1e-5 + 1e-4 * torch.abs(tc)))
    n_out = int(outside.sum())
    check(n_out <= outliers * origin.shape[0],
          f"{label}: {n_out} of {origin.shape[0]} rays differ from brute "
          "force in hit or t (rtol 1e-4 / atol 1e-5)")
    diff = both & ~outside & (ib != ic)
    check(float(diff.sum()) <= 0.01 * max(1, int(both.sum())),
          f"{label}: tri differs from brute force on more than 1% of hits")
    return {"hits": int(hb.sum()), "tri_ties": int(diff.sum()),
            "rays_outside_tolerance": n_out}


def compare_kernels(scene, accel, origin, direction, mt: bool, tile: int,
                    label: str):
    """exact_match, then the whole single-table intersector against brute
    force (brute_contract, no outliers)."""
    from montecarlopathtracing_torch.kernels import cluster as K

    res = exact_match(accel, origin, direction, mt, tile, label)
    got = K.cluster_intersect(accel, origin, direction, tile=tile, mt=mt)
    return {**res, **brute_contract(scene, got, origin, direction, mt, label)}


def bounds(rays_n: int, tile: int, c: int, width: int, ray_cols: int,
           live_subtiles: int, cand_pairs: int):
    """The bytes each of kernels 1 and 2 must move on these inputs (inputs
    read once, outputs written once) and the f32 operations it must do."""
    n_sub = rays_n // tile
    key_bytes = 4 * (rays_n * 8 + 8 * c + n_sub * c + n_sub + cand_pairs)
    key_ops = OPS_KEY_PAIR * live_subtiles * tile * c
    isect_bytes = 4 * (rays_n * ray_cols + n_sub + cand_pairs
                       + c * 16 * width + 2 * rays_n)
    isect_ops = OPS_TRI_PAIR * tile * width * cand_pairs
    return {"cluster_keys": {"bytes": key_bytes, "ops": key_ops},
            "cluster_intersect": {"bytes": isect_bytes, "ops": isect_ops}}


def sleep_ms() -> float:
    """Device time of one torch.cuda._sleep(SLEEP_CYCLES), in ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def timed(fn, sleep: float, warm: bool = False):
    """(ms, host_outlasted_sleep, result) of one call, by CUDA events around
    it.  The stream sleeps first, so the start event is stamped only after
    the host has enqueued the call, and the window holds device time rather
    than the wrapper's host work.  The flag is set where the host took
    longer than the sleep (``sleep`` ms), so some host time may be inside.
    A call that synchronises inside (the plain versions do) still counts
    its host time after the sync.  The window holds all that the call puts
    on the stream: a kernel wrapper's launch and the fills that preset its
    outputs.  ``warm`` calls ``fn`` once before, untimed, so that the
    allocator already holds the call's output buffers and no cudaMalloc
    falls into the window."""
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    out = fn()
    end.record()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    return start.elapsed_time(end), host_ms > sleep, out


def frame_kernel_stats(calls, tile: int, label: str):
    """Replay every intersect call of a main-path frame: each kernel and its
    plain version on the call's own inputs, checked exactly equal, each
    timed once (one launch, CUDA events).  Returns per-kernel means over the
    frame's calls (ms, plain_ms, bound_ms) and the slowest launch."""
    from montecarlopathtracing_torch.kernels import cluster as K

    rows = {"cluster_keys": [], "cluster_intersect": []}
    pairs = []
    sleep = sleep_ms()
    for acc, origin, direction, mt in calls:
        o, d = pad_rays(origin, direction, tile)
        rays = K.pack_rays(o, d)
        caabb = K._caabb(acc.cmin, acc.cmax)
        ms1, late1, (keys, counts, ids) = timed(
            lambda: K.cluster_keys(rays, caabb, tile), sleep, warm=True)
        pm1, _, (keys_p, counts_p, ids_p) = timed(
            lambda: K.cluster_keys_plain(rays, caabb, tile), sleep)
        used = (torch.arange(ids.shape[1], device=ids.device)[None, :]
                < counts[:, None])
        check(torch.equal(keys, keys_p) and torch.equal(counts, counts_p)
              and torch.equal(torch.where(used, ids, -1),
                              torch.where(used, ids_p, -1)),
              f"{label}: keys differ from the plain version on a frame call")
        lib1 = ids_sort_ms(keys, sleep)
        rays_i = K.pack_rays(o, d, mt=True) if mt else rays
        ms2, late2, (bt, bi) = timed(lambda: K.cluster_intersect_padded(
            rays_i, counts, ids, acc.tconst, tile, mt), sleep, warm=True)
        pm2, _, (bt_p, bi_p) = timed(lambda: K.cluster_intersect_padded_plain(
            rays_i, counts, ids, acc.tconst, tile, mt), sleep)
        check(torch.equal(bt, bt_p) and torch.equal(bi, bi_p),
              f"{label}: intersect differs from the plain version on a frame call")
        live = int((torch.amin(rays[:, 0].reshape(-1, tile), dim=1) <= 5e8).sum())
        n_pairs = int(counts.sum())
        pairs.append(n_pairs)
        b = bounds(rays.shape[0], tile, acc.num_clusters, acc.width,
                   rays_i.shape[1], live, n_pairs)
        for name, ms, pm, late in (("cluster_keys", ms1, pm1, late1),
                                   ("cluster_intersect", ms2, pm2, late2)):
            rows[name].append({"ms": ms, "plain_ms": pm, "late": late,
                               "bytes": b[name]["bytes"], "ops": b[name]["ops"]})
        rows["cluster_keys"][-1]["library_ms"] = lib1
    out = {name: aggregate(r) for name, r in rows.items()}
    emit({"phase": "kernel_time", "case": label, "calls": len(pairs),
          "rays_per_call_max": max(int(c[1].shape[0]) for c in calls),
          "clusters": calls[0][0].num_clusters, "width": calls[0][0].width,
          "candidate_pairs_mean": sum(pairs) / len(pairs),
          "candidate_pairs_max": max(pairs), "sleep_ms": sleep, **out})
    return out


def bound_of(n_bytes: int, n_ops: int):
    """(bound_ms, bound_by): the larger of bytes over HBM bandwidth and f32
    operations over the f32 peak."""
    tb, to = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32 * 1e3
    return max(tb, to), "bytes" if tb >= to else "operations"


def aggregate(rows):
    """Means over a frame's calls of one kernel; rows are dicts with ms,
    plain_ms, bytes, ops and late (the host outlasted the sleep).
    bound_unfused_ms is bound_ms with the operations counted at half the f32
    peak (no contraction of a*b+c); ms_max_over_mean is the slowest launch
    over the mean."""
    n = len(rows)
    _, by = bound_of(sum(r["bytes"] for r in rows), sum(r["ops"] for r in rows))
    ms = sum(r["ms"] for r in rows) / n
    ms_max = max(r["ms"] for r in rows)
    extra = {k: sum(r[k] for r in rows) / n
             for k in ("ms_keys_only", "library_ms") if k in rows[0]}
    return {**extra, "ms": ms, "ms_max": ms_max, "ms_max_over_mean": ms_max / ms,
            "plain_ms": sum(r["plain_ms"] for r in rows) / n,
            "bound_ms": sum(bound_of(r["bytes"], r["ops"])[0] for r in rows) / n,
            "bound_unfused_ms": sum(bound_of(r["bytes"], 2 * r["ops"])[0]
                                    for r in rows) / n,
            "bound_by": by, "calls": n,
            "host_outlasted_sleep": sum(r["late"] for r in rows)}


def max_err(a, b) -> float:
    """Largest |a - b| over the finite entries (0.0 when exactly equal)."""
    ok = (a < 1e30) & (b < 1e30)
    return float(torch.abs(a - b)[ok].max()) if bool(ok.any()) else 0.0


def check_fused_list(keys, counts, cand, label: str):
    """The key kernel's fused outputs against the sorted list and the counts:
    order and qkeys equal _ftb_candidates(keys) on each row's first ``count``
    entries (bit for bit), the row list holds exactly the rows with
    candidates, each in its bucket."""
    from montecarlopathtracing_torch.kernels import cluster as K

    order_s, qkeys_s = K._ftb_candidates(keys)
    used = (torch.arange(keys.shape[1], device=keys.device)[None, :]
            < counts[:, None])
    check(torch.equal(torch.where(used, cand.order, -1),
                      torch.where(used, order_s, -1)),
          f"{label}: fused front-to-back order differs from the sorted list")
    check(torch.equal(torch.where(used, cand.qkeys, 0.0).view(torch.int32),
                      torch.where(used, qkeys_s, 0.0).view(torch.int32)),
          f"{label}: fused quantised keys differ from the sorted list")
    heads = cand.heads.tolist()
    listed = K.listed_rows(cand.heads, cand.rows)
    want = torch.nonzero(counts > 0)[:, 0]
    check(torch.equal(torch.sort(listed).values, want),
          f"{label}: the row list is not the set of rows with candidates")
    hi = None
    for b, lo in enumerate(K._BUCKET_MIN):
        cnt = counts[cand.rows[b, :heads[b]].long()]
        check(bool((cnt >= lo).all()) and (hi is None or bool((cnt < hi).all())),
              f"{label}: a row sits in the wrong bucket of the row list")
        hi = lo
    return order_s, qkeys_s


def adversarial_keys(dev, label: str, caabb, tile: int, seed: int):
    """Phase 3 (d): the key kernel against its plain version on rays made to
    hit every special case of the slab test, on ``caabb`` ((8, C), or
    (K, 8, C) with random chunk caps, a third of them parking the ray)."""
    from montecarlopathtracing_torch.kernels import cluster as K

    rng = np.random.default_rng(seed)
    flat = caabb.reshape(-1, 8, caabb.shape[-1])
    real = flat[0, 0] < 1e29
    lo = flat[0, 0:3][:, real].min(dim=1).values.cpu().numpy()
    hi = flat[0, 3:6][:, real].max(dim=1).values.cpu().numpy()
    n = 24 * tile
    o = rng.uniform(lo - 0.3, hi + 0.3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[0::7, 0] = 0.0
    d[1::7, 1] = -0.0
    d[2::7, 2] = np.float32(1e-40)    # denormal: 1 / d overflows to inf
    d[3::11, 0] = np.float32(-1e-41)
    d[5::19] = [0.0, -0.0, 1.0]
    o[4::13, 0] = lo[0]               # on a box face, some with d.x = 0
    o[0::21, 1] = hi[1]
    o[6::17] = 1e9                    # parked rays in live subtiles
    o[tile:2 * tile] = 1e9            # an all-parked subtile
    rays = K.pack_rays(torch.as_tensor(o, device=dev),
                       torch.as_tensor(d, device=dev))
    if caabb.dim() == 3:
        cap = torch.as_tensor(
            rng.uniform(-1.0, 2.0, (caabb.shape[0], n)).astype(np.float32),
            device=dev)
        cap[0, 2 * tile:3 * tile] = -1.0  # a subtile parked for one chunk
        keys, counts = K.cluster_keys_chunked(rays, cap, caabb, tile)
        keys_p, counts_p = K.cluster_keys_chunked_plain(rays, cap, caabb, tile)
        keys_f, counts_f, cand = K.cluster_keys_chunked_ftb(rays, cap, caabb,
                                                            tile, with_keys=True)
    else:
        keys, counts, ids = K.cluster_keys(rays, caabb, tile)
        keys_p, counts_p, ids_p = K.cluster_keys_plain(rays, caabb, tile)
        used = (torch.arange(ids.shape[1], device=dev)[None, :] < counts[:, None])
        check(torch.equal(torch.where(used, ids, -1), torch.where(used, ids_p, -1)),
              f"{label}: candidate lists differ on adversarial rays")
        keys_f, counts_f, cand = K.cluster_keys_ftb(rays, caabb, tile,
                                                    with_keys=True)
    check(torch.equal(keys.view(torch.int32), keys_p.view(torch.int32))
          and torch.equal(counts, counts_p),
          f"{label}: keys differ from the plain version on adversarial rays")
    check(torch.equal(keys_f.view(torch.int32), keys_p.view(torch.int32))
          and torch.equal(counts_f, counts_p),
          f"{label}: keys of the fused-list launch differ")
    check_fused_list(keys_p, counts_p, cand, label)
    return {"case": label, "clusters": int(caabb.shape[-1]),
            "chunks": int(flat.shape[0]), "rows": int(counts.shape[0]),
            "rows_with_candidates": int((counts > 0).sum()),
            "candidates": int(counts.sum()),
            "inf_keys": int(torch.isinf(keys).sum())}


def ids_sort_ms(keys, sleep: float) -> float:
    """Device ms of the one torch.sort that lists a call's hit clusters in
    ascending order (the plain version's sort of the hits' ids ahead of the
    misses'): the library call for the list part of the key kernel."""
    c = keys.shape[1]
    iota = torch.arange(c, dtype=torch.int32, device=keys.device)
    words = torch.where(keys < 1e30, iota, iota + c)
    return timed(lambda: torch.sort(words, dim=1), sleep, warm=True)[0]


def sort_ms(keys, sleep: float) -> float:
    """Device ms of the one torch.sort that orders a call's packed words
    (_ftb_order): the library call for the ordering part of the key kernel."""
    c = keys.shape[1]
    mask = (1 << max(1, (c - 1).bit_length())) - 1
    words = ((keys.view(torch.int32) & ~mask)
             | torch.arange(c, dtype=torch.int32, device=keys.device))
    return timed(lambda: torch.sort(words, dim=1), sleep, warm=True)[0]


def ftb_pairs(bt, cap, counts, qkeys, tile: int, counter):
    """(candidate pairs, pairs the kernel tested, pairs no exact exit could
    skip): per (chunk, subtile) row, all candidates, the kernel's count, and
    the candidates whose key is <= the row's final max over rays of
    min(best t, cap).  ``bt`` is the result over every chunk (R,), the least
    best any exit could know; ``cap`` (K, R) or (R,)."""
    from montecarlopathtracing_torch.kernels import cluster as K

    k_n = cap.numel() // bt.numel()
    need = K.ftb_needed(bt.repeat(k_n), cap.reshape(-1), counts, qkeys, tile)
    return int(counts.sum()), int(counter[0]), int(need.sum())


def chunked_call(acc, origin, direction, mt: bool, tile: int, sleep: float,
                 label: str):
    """One chunked intersect call taken apart: kernels 3 (chunk-axis keys)
    and 4 (front-to-back intersect) and their plain versions on the call's
    own inputs, checked exactly equal, each timed once.  Returns per-kernel
    rows for ``aggregate`` and the pair counts."""
    from montecarlopathtracing_torch.kernels import cluster as K

    o, d, _, tile = K._shape_and_pad(origin, direction, tile, MEGA)
    cap = K.chunk_caps(acc, o, d)
    rays = K.pack_rays(o, d, mt=mt)
    ms1, late1, (keys, counts) = timed(
        lambda: K.cluster_keys_chunked(rays, cap, acc.caabb, tile), sleep,
        warm=True)
    pm1, _, (keys_p, counts_p) = timed(
        lambda: K.cluster_keys_chunked_plain(rays, cap, acc.caabb, tile), sleep)
    check(torch.equal(keys, keys_p) and torch.equal(counts, counts_p),
          f"{label}: chunk-axis keys differ from the plain version")
    # The main path's launch: the list fused in, no keys written.
    msl, latel, (_, counts_f, fused) = timed(
        lambda: K.cluster_keys_chunked_ftb(rays, cap, acc.caabb, tile), sleep,
        warm=True)
    check(torch.equal(counts_f, counts_p),
          f"{label}: counts of the fused-list launch differ")
    order, qkeys = check_fused_list(keys_p, counts_p, fused, label)
    lib_ms = sort_ms(keys, sleep)
    ms2, late2, (bt, bi) = timed(lambda: K.cluster_intersect_ftb(
        rays, counts, fused.order, fused.qkeys, acc.tconst, tile, mt,
        chunk_cap=cap, row_list=fused.row_list, offsets=acc.offsets), sleep,
        warm=True)
    pm2, _, (bt_p, bi_p) = timed(lambda: K.cluster_intersect_ftb_plain(
        rays, counts, order, qkeys, acc.tconst, tile, mt, chunk_cap=cap,
        offsets=acc.offsets), sleep)
    check(torch.equal(bt, bt_p) and torch.equal(bi, bi_p),
          f"{label}: front-to-back intersect differs from the plain version")
    bt_s, bi_s = K.cluster_intersect_ftb(rays, counts, order, qkeys, acc.tconst,
                                         tile, mt, chunk_cap=cap,
                                         row_list=fused.row_list,
                                         offsets=acc.offsets)
    check(torch.equal(bt, bt_s) and torch.equal(bi, bi_s),
          f"{label}: the kernel fed by the fused list differs from the kernel "
          "fed by the sorted list")
    counter = torch.zeros(1, dtype=torch.int64, device=rays.device)
    bt_c, bi_c = K.cluster_intersect_ftb(rays, counts, fused.order, fused.qkeys,
                                         acc.tconst, tile, mt, chunk_cap=cap,
                                         counter=counter,
                                         row_list=fused.row_list,
                                         offsets=acc.offsets)
    check(torch.equal(bt, bt_c) and torch.equal(bi, bi_c),
          f"{label}: the pair counter changed the result")
    cand, tested, needed = ftb_pairs(bt, cap, counts, qkeys, tile, counter)
    check(needed <= tested <= cand, f"{label}: pairs {needed} <= {tested} <= {cand}")
    k_n, c, w = acc.num_chunks, acc.clusters_per_chunk, acc.width
    r = rays.shape[0]
    n_rows = counts.shape[0]
    live = int(((cap.reshape(n_rows, tile) >= 0)
                & (rays[:, 0].reshape(-1, tile).repeat(k_n, 1) <= 5e8))
               .any(dim=1).sum())
    # Out: counts, order and qkeys of the candidates, one int per listed row.
    # The intersect kernel's out: one 8-byte join word per ray.
    key_row = {"ms": msl, "plain_ms": pm1, "late": latel,
               "ms_keys_only": ms1, "library_ms": lib_ms,
               "bytes": 4 * (r * 8 + k_n * r + k_n * 8 * c + n_rows + 2 * cand
                             + int((counts > 0).sum())),
               "ops": OPS_KEY_PAIR * live * tile * c}
    isect_row = {"ms": ms2, "plain_ms": pm2, "late": late2,
                 "bytes": 4 * (r * rays.shape[1] + k_n * r + n_rows + 2 * needed
                               + min(k_n * c, needed) * 16 * w + 2 * r),
                 "ops": OPS_TRI_PAIR * tile * w * needed,
                 "ops_all": OPS_TRI_PAIR * tile * w * cand}
    return {"keys": key_row, "isect": isect_row, "cand": cand, "tested": tested,
            "needed": needed, "rays": origin.shape[0],
            "listed": int(fused.heads.sum()),
            "err_keys": max_err(keys, keys_p), "err_t": max_err(bt, bt_p)}


def hbm_call(acc, origin, direction, mt: bool, tile: int, sleep: float,
             label: str):
    """One supergroup intersect call taken apart: kernel 1 over the
    supergroup AABBs (keys only) and kernel 5 with their plain versions,
    checked exactly equal, each timed once."""
    from montecarlopathtracing_torch.kernels import cluster as K

    o, d, _, tile = K._shape_and_pad(origin, direction, tile, MEGA)
    rays8 = K.pack_rays(o, d)
    ms1, late1, (keys, counts, _) = timed(
        lambda: K.cluster_keys(rays8, acc.caabb, tile, with_ids=False), sleep,
        warm=True)
    pm1, _, (keys_p, counts_p, _) = timed(
        lambda: K.cluster_keys_plain(rays8, acc.caabb, tile), sleep)
    check(torch.equal(keys, keys_p) and torch.equal(counts, counts_p),
          f"{label}: supergroup keys differ from the plain version")
    msl, latel, (_, counts_f, fused) = timed(
        lambda: K.cluster_keys_ftb(rays8, acc.caabb, tile), sleep,
        warm=True)
    check(torch.equal(counts_f, counts_p),
          f"{label}: counts of the fused-list launch differ")
    order, qkeys = check_fused_list(keys_p, counts_p, fused, label)
    lib_ms = sort_ms(keys, sleep)
    rays = K.pack_rays(o, d, mt=True) if mt else rays8
    ms2, late2, (bt, bi) = timed(lambda: K.cluster_intersect_hbm_padded(
        rays, counts, fused.order, fused.qkeys, acc.tconst, tile, mt,
        row_list=fused.row_list), sleep, warm=True)
    pm2, _, (bt_p, bi_p) = timed(lambda: K.cluster_intersect_hbm_plain(
        rays, counts, order, qkeys, acc.tconst, tile, mt), sleep)
    check(torch.equal(bt, bt_p) and torch.equal(bi, bi_p),
          f"{label}: supergroup intersect differs from the plain version")
    bt_s, bi_s = K.cluster_intersect_hbm_padded(rays, counts, order, qkeys,
                                                acc.tconst, tile, mt,
                                                row_list=fused.row_list)
    check(torch.equal(bt, bt_s) and torch.equal(bi, bi_s),
          f"{label}: the kernel fed by the fused list differs from the kernel "
          "fed by the sorted list")
    counter = torch.zeros(1, dtype=torch.int64, device=rays.device)
    bt_c, bi_c = K.cluster_intersect_hbm_padded(rays, counts, fused.order,
                                                fused.qkeys, acc.tconst, tile,
                                                mt, counter=counter,
                                                row_list=fused.row_list)
    check(torch.equal(bt, bt_c) and torch.equal(bi, bi_c),
          f"{label}: the pair counter changed the result")
    cap = rays[:, 9 if mt else 6]
    cand, tested, needed = ftb_pairs(bt, cap, counts, qkeys, tile, counter)
    check(needed <= tested <= cand, f"{label}: pairs {needed} <= {tested} <= {cand}")
    s_n, cols = acc.num_supergroups, acc.tconst.shape[2]
    r = rays.shape[0]
    n_rows = counts.shape[0]
    live = int((torch.amin(rays8[:, 0].reshape(-1, tile), dim=1) <= 5e8).sum())
    key_row = {"ms": msl, "plain_ms": pm1, "late": latel,
               "ms_keys_only": ms1, "library_ms": lib_ms,
               "bytes": 4 * (r * 8 + 8 * s_n + n_rows + 2 * cand
                             + int((counts > 0).sum())),
               "ops": OPS_KEY_PAIR * live * tile * s_n}
    isect_row = {"ms": ms2, "plain_ms": pm2, "late": late2,
                 "bytes": 4 * (r * rays.shape[1] + n_rows + 2 * needed
                               + min(s_n, needed) * 16 * cols + 2 * r),
                 "ops": OPS_TRI_PAIR * tile * cols * needed,
                 "ops_all": OPS_TRI_PAIR * tile * cols * cand}
    return {"keys": key_row, "isect": isect_row, "cand": cand, "tested": tested,
            "needed": needed, "rays": origin.shape[0],
            "err_keys": max_err(keys, keys_p), "err_t": max_err(bt, bt_p)}


# Counters of the chunked intersect kernel's -DMCPT_COUNT_STATS build
# (kCounters of csrc/cluster_intersect_ftb.cu).
FTB_COUNTERS = ("units_tested", "blocks_without_row", "pairs",
                "pairs_rejectable", "warp_steps", "warp_steps_all_reject")


def ftb_measurement_builds(calls, tile: int):
    """Row 4 on every chunked call of the frame under two measurement builds
    of its source: with the triangle tests compiled out (-DMCPT_SKIP_TESTS:
    what a launch costs besides its tests, device ms) and with its counters
    (-DMCPT_COUNT_STATS: blocks that found no row on the list, and the pairs
    and warp steps that an exact plane-distance reject would decide)."""
    from montecarlopathtracing_torch.kernels import build as B
    from montecarlopathtracing_torch.kernels import cluster as K

    sleep = sleep_ms()
    ms, totals = [], torch.zeros(len(FTB_COUNTERS), dtype=torch.int64)
    try:
        for flag in ("-DMCPT_SKIP_TESTS", "-DMCPT_COUNT_STATS"):
            B.EXTRA_FLAGS = (flag,)
            B.load.cache_clear()
            for acc, origin, direction, mt in calls:
                o, d, _, tl = K._shape_and_pad(origin, direction, tile, MEGA)
                cap = K.chunk_caps(acc, o, d)
                rays = K.pack_rays(o, d, mt=mt)
                _, counts, cand = K.cluster_keys_chunked_ftb(rays, cap,
                                                             acc.caabb, tl)
                ctr = (torch.zeros(len(FTB_COUNTERS), dtype=torch.int64,
                                   device=rays.device)
                       if flag == "-DMCPT_COUNT_STATS" else None)
                run = lambda: K.cluster_intersect_ftb(
                    rays, counts, cand.order, cand.qkeys, acc.tconst, tl, mt,
                    chunk_cap=cap, counter=ctr, row_list=cand.row_list,
                    offsets=acc.offsets)
                if ctr is None:
                    ms.append(timed(run, sleep, warm=True)[0])
                else:
                    run()
                    totals += ctr.cpu()
    finally:
        B.EXTRA_FLAGS = ()
        B.load.cache_clear()
    c = dict(zip(FTB_COUNTERS, totals.tolist()))
    n = len(calls)
    out = {"ms_skip_tests": sum(ms) / n,
           "blocks_without_row_per_call": c["blocks_without_row"] / n,
           "pairs_rejectable_share": c["pairs_rejectable"] / max(1, c["pairs"]),
           "warp_steps_all_reject_share":
               c["warp_steps_all_reject"] / max(1, c["warp_steps"]),
           "counts": c}
    emit({"phase": "kernel_measurement_builds", "case": "large400_chunked",
          "kernel": "cluster_intersect_ftb", "calls": n, **out})
    return out


def ftb_frame_stats(calls, call_fn, tile: int, label: str, names):
    """Replay every intersect call of a 400k frame through ``call_fn``
    (chunked_call or hbm_call).  ``names`` = (key kernel, intersect kernel).
    Returns {kernel name: aggregate} plus the frame's pair counts."""
    sleep = sleep_ms()
    recs = [call_fn(acc, o, d, mt, tile, sleep, label) for acc, o, d, mt in calls]
    out = {names[0]: aggregate([r["keys"] for r in recs]),
           names[1]: aggregate([r["isect"] for r in recs])}
    cand, tested, needed = (sum(r[k] for r in recs)
                            for k in ("cand", "tested", "needed"))
    check(tested < cand, f"{label}: the early exit never fired "
                         f"({tested} of {cand} pairs tested)")
    pairs = {"candidate_pairs": cand, "tested_pairs": tested,
             "unskippable_pairs": needed, "tested_share": tested / cand,
             "candidate_pairs_max": max(r["cand"] for r in recs)}
    if "listed" in recs[0]:  # the row list's length per call
        pairs["listed_rows_per_call"] = sum(r["listed"] for r in recs) / len(recs)
    # The intersect kernel's bound had every candidate been tested, beside
    # the bound over the pairs no exact exit could skip.
    pairs["bound_ms_all_candidates"] = sum(
        bound_of(r["isect"]["bytes"], r["isect"]["ops_all"])[0]
        for r in recs) / len(recs)
    emit({"phase": "kernel_time", "case": label, "calls": len(recs),
          "rays_per_call_max": max(r["rays"] for r in recs),
          "sleep_ms": sleep, **pairs, **out})
    out["pairs"] = pairs
    out["err"] = {names[0]: max(r["err_keys"] for r in recs),
                  names[1]: max(r["err_t"] for r in recs)}
    return out


# ---------------------------------------------------------------------------
# Phases.
# ---------------------------------------------------------------------------

def phase_kernels(dev, state):
    from montecarlopathtracing_torch.kernels import cluster as K
    from montecarlopathtracing_torch.scene.builtin import (load_builtin_box,
                                                           load_builtin_large)

    tile = 64
    rng = np.random.default_rng(0)
    box, _ = load_builtin_box(width=1024, height=1024, device=dev)
    accel_box = K.build_cluster_accel(box, width=32)
    # (a) box table: random rays, ragged count, one parked subtile.
    n = 10_000 + 37
    o = rng.uniform(-0.5, 2.5, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[tile:2 * tile] = 1e9
    o_t, d_t = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    results = [compare_kernels(box, accel_box, o_t, d_t, False, tile, "box")]
    accel_box_mt = K.build_cluster_accel(box, width=32, mt=True)
    results.append(compare_kernels(box, accel_box_mt, o_t, d_t, True, tile,
                                   "box_mt"))

    # (b) the large interior's table, compat and MT, on main-path rays.
    t0 = time.perf_counter()
    large, _ = load_builtin_large(n_tris=100_000, width=1280, height=720,
                                  device=dev)
    torch.cuda.synchronize()
    state["large"] = large
    state["large_load_s"] = time.perf_counter() - t0
    # Random rays inside the room for the brute-force contract (lattice
    # camera rays can run exactly along a triangle edge, where the two
    # formulations of the test may classify differently).
    n = 8192 + 21
    o = rng.uniform(0.1, 2.9, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o_r, d_r = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    o_l, d_l = camera_and_shadow_rays(large, MAIN_RAYS // 2, seed=1)
    for mt in (False, True):
        acc = K.build_cluster_accel(large, width=128, mt=mt)
        results.append(compare_kernels(large, acc, o_r, d_r, mt, tile,
                                       "large_mt" if mt else "large"))
        # Kernel vs plain at the full main-path shape as well.
        results.append(exact_match(acc, o_l, d_l, mt, tile,
                                   "large_camera_shadow" + ("_mt" if mt else "")))
    # (d) narrow tables: random boxes, the last cluster an inverted-empty
    # padding one; single and over a chunk axis of 3.
    adversarial = []
    for c in (1, 2, 7, 33):
        cmin = rng.uniform(0.0, 2.0, (3, c, 3)).astype(np.float32)
        cmax = cmin + rng.uniform(0.05, 1.0, (3, c, 3)).astype(np.float32)
        if c > 1:
            cmin[:, -1], cmax[:, -1] = 1e30, -1e30
        cmin_t, cmax_t = (torch.as_tensor(x, device=dev) for x in (cmin, cmax))
        chunked = torch.stack([K._caabb(cmin_t[k], cmax_t[k]) for k in range(3)])
        adversarial.append(adversarial_keys(dev, f"narrow_c{c}", chunked[0],
                                            tile, seed=10 + c))
        adversarial.append(adversarial_keys(dev, f"narrow_c{c}_chunked",
                                            chunked, tile, seed=20 + c))
    emit({"phase": "kernels", "ok": True, "cases": results,
          "adversarial": adversarial})
    state["max_abs_err"] = {
        "cluster_keys": max(r["keys_max_abs_err"] for r in results),
        "cluster_intersect": max(r["t_max_abs_err"] for r in results)}


def phase_timing(state):
    """Each kernel's time per launch and its plain version's, replayed over
    every intersect call of the four frames."""
    for label in ("box", "large"):
        calls = state.pop(f"calls_{label}")
        state[f"time_{label}"] = frame_kernel_stats(calls, 64, label)
        del calls
        torch.cuda.empty_cache()
    for label, fn, names in (("large400_chunked", chunked_call,
                              PATH_KERNELS["chunked"]),
                             ("large400_hbm", hbm_call, PATH_KERNELS["hbm"])):
        calls = state.pop(f"calls_{label}")
        state[f"time_{label}"] = ftb_frame_stats(calls, fn, 64, label, names)
        if label == "large400_chunked":
            state["ftb_builds"] = ftb_measurement_builds(calls, 64)
        del calls
        torch.cuda.empty_cache()


# The kernels each plan's render must go through.
PATH_KERNELS = {
    "single": ("cluster_keys", "cluster_intersect"),
    "chunked": ("cluster_keys_chunked", "cluster_intersect_ftb"),
    "hbm": ("cluster_keys", "cluster_intersect_hbm"),
}


def check_launched(launches, names, label: str):
    check(all(launches[n] > 0 for n in names),
          f"{label}: a kernel of the path was not launched: {launches}")


def image_checks(img, label: str):
    check(tuple(img.shape[2:]) == (3,), f"{label}: image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), f"{label}: non-finite pixels")
    mean = float(img.mean())
    check(mean > 0.0, f"{label}: black image")
    return mean


class CaptureCall:
    """Wraps the intersector the wavefront calls (by its name in the
    integrator module) and keeps the inputs of every call (the combined
    [arrivals; shadow rays] batches), so the kernels can be replayed on a
    real frame.  Calls pass through unchanged.  The
    wavefront builds fresh ray tensors for each call, so references are kept,
    not copies.  Used only on a second, untimed render of a frame."""

    def __init__(self, name: str = "cluster_intersect"):
        from montecarlopathtracing_torch.integrator import wavefront

        self.module, self.name, self.calls = wavefront, name, []
        self.inner = getattr(wavefront, name)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)

    def __call__(self, accel, *args, **kw):
        origin, direction = args[-2:]  # the chunked entry takes offsets first
        self.calls.append((accel, origin, direction, kw.get("mt", False)))
        return self.inner(accel, *args, **kw)


def phase_box(dev, state):
    from montecarlopathtracing_torch import api, read_png
    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.kernels import cluster as K
    from montecarlopathtracing_torch.scene.builtin import write_box_scene

    with tempfile.TemporaryDirectory() as d:
        write_box_scene(d, "box", width=1024, height=1024)
        stats = {}
        K.reset_launch_counts()
        img, path = api.render_scene(d, "box", spp=16,
                                     options=RenderOptions(spp_chunk=16),
                                     out_dir=os.path.join(d, "out"),
                                     device=dev, stats=stats)
        torch.cuda.synchronize()
        launches = K.launch_counts()
        with CaptureCall() as cap:
            api.render_scene(d, "box", spp=16, options=RenderOptions(spp_chunk=16),
                             out_dir=os.path.join(d, "capture"), device=dev)
        state["calls_box"] = cap.calls
        check_launched(launches, PATH_KERNELS["single"], "box")
        mean = image_checks(img, "box")
        check(img.shape == (1024, 1024, 3), "box: image shape")
        png = read_png(path)
        check(png.shape == (1024, 1024, 3) and png.max() > 0, "box: PNG")
    state["launches_box"] = launches
    emit({"phase": "box", "width": 1024, "height": 1024, "spp": 16,
          "lanes": 65536, "seconds": stats["phase2_s"],
          "load_seconds": stats["phase1_s"], "rays": stats["rays"],
          "rays_per_s": stats["rays"] / stats["phase2_s"], "mean": mean,
          "launches": launches})


def phase_large(dev, state):
    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.integrator.wavefront import (
        render_image_host_chunked, resolve_plan)
    from montecarlopathtracing_torch.kernels import cluster as K

    scene = state["large"]
    opts = RenderOptions(spp=4, spp_chunk=4)
    plan = resolve_plan(opts, scene.num_tris_padded)
    check(plan[1] == 128 and scene.num_tris_padded == 131072,
          f"large: unexpected plan {plan}")
    torch.cuda.synchronize()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    img, rays = render_image_host_chunked(scene, None, opts, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = K.launch_counts()
    with CaptureCall() as cap:
        render_image_host_chunked(scene, None, opts, device=dev)
    state["calls_large"] = cap.calls
    check_launched(launches, PATH_KERNELS["single"], "large")
    mean = image_checks(img, "large")
    state["launches_large"] = launches
    emit({"phase": "large", "width": 1280, "height": 720, "spp": 4,
          "tris_padded": scene.num_tris_padded, "clusters": 1024,
          "cluster_width": 128, "materials": scene.num_materials,
          "textured": int(scene.atlas.shape[0] > 0), "seconds": secs,
          "load_seconds": state["large_load_s"], "rays": rays,
          "rays_per_s": rays / secs, "mean": mean, "launches": launches})


def phase_kernels_large400(dev, state):
    """Phase 3 (c): kernels 3, 4 and 5 on the 400k-triangle interior's
    chunked and supergroup tables."""
    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.integrator.wavefront import resolve_plan
    from montecarlopathtracing_torch.kernels import cluster as K
    from montecarlopathtracing_torch.scene.builtin import load_builtin_large

    tile = 64
    t0 = time.perf_counter()
    scene, _ = load_builtin_large(n_tris=400_000, width=1280, height=720,
                                  device=dev)
    torch.cuda.synchronize()
    state["large400"] = scene
    state["large400_load_s"] = time.perf_counter() - t0
    kind, width, _, n_chunks = resolve_plan(RenderOptions(), scene.num_tris_padded)
    check(kind == "cluster" and n_chunks > 1,
          f"large400: expected the chunked plan, got {(kind, width, n_chunks)}")

    rng = np.random.default_rng(2)
    n = 8192 + 21
    o = rng.uniform(0.1, 2.9, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[tile:2 * tile] = 1e9  # one parked subtile
    o_r, d_r = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
    # Rays from the room's near corner pointing out of it: they miss the box
    # of every chunk of props, so whole chunks are parked.
    m = 4096 + 5
    o_c = torch.as_tensor(rng.uniform(0.02, 0.05, (m, 3)).astype(np.float32),
                          device=dev)
    d_c = -torch.abs(d_r[:m])
    sleep = sleep_ms()
    results = []
    cam = None
    for mt in (False, True):
        tag = "_mt" if mt else ""
        single = K.build_cluster_accel(scene, width=width, mt=mt)
        chunked, _ = K.build_cluster_accel_chunked(scene, width=width,
                                                   n_chunks=n_chunks, mt=mt)
        hbm = K.build_hbm_accel(single)
        if cam is None:
            cam = camera_and_shadow_rays(scene, MAIN_RAYS // 2, seed=3,
                                         accel=chunked)
        for label, (oo, dd) in (("random", (o_r, d_r)), ("corner", (o_c, d_c)),
                                ("camera_shadow", cam)):
            rec = chunked_call(chunked, oo, dd, mt, tile, sleep,
                               f"large400_chunked_{label}{tag}")
            rec_h = hbm_call(hbm, oo, dd, mt, tile, sleep,
                             f"large400_hbm_{label}{tag}")
            # The whole intersectors agree with the single-table kernels.
            base = K.cluster_intersect(single, oo, dd, tile=tile, mt=mt)
            ftb = K.cluster_intersect(single, oo, dd, tile=tile, mt=mt, ftb=True)
            ch = K.cluster_intersect_chunked(chunked, None, oo, dd, tile=tile,
                                             mt=mt)
            hb = K.cluster_intersect_hbm(hbm, oo, dd, tile=tile, mt=mt)
            for name, got in (("ftb", ftb), ("chunked", ch), ("hbm", hb)):
                check(all(torch.equal(a, b) for a, b in zip(base, got)),
                      f"large400 {label}{tag}: {name} intersector differs from "
                      "the single-table kernel on the same rays")
            extra = {}
            if label == "random":
                extra = brute_contract(scene, ch, oo, dd, mt,
                                       f"large400_chunked{tag}", outliers=1e-3)
                # A supergroup of 32 clusters (what a table of ~5M triangles
                # gets): 4,096 columns, staged in 32 pieces.
                hbm32 = K.build_hbm_accel(single, 32)
                rec32 = hbm_call(hbm32, oo, dd, mt, tile, sleep,
                                 f"large400_hbm_sg32{tag}")
                extra["hbm_sg32_pairs"] = [rec32["cand"], rec32["tested"],
                                           rec32["needed"]]
                del hbm32
            if label == "corner":
                parked = int((K.chunk_caps(chunked, oo, dd) < 0).all(dim=1).sum())
                check(parked > 0, "large400 corner rays: no chunk was parked "
                                  "for every ray")
                extra = {"chunks_parked_for_every_ray": parked}
            results.append({
                "case": f"large400_{label}{tag}", "rays": int(oo.shape[0]),
                "mt": mt, "chunks": chunked.num_chunks,
                "clusters_per_chunk": chunked.clusters_per_chunk,
                "supergroups": hbm.num_supergroups, "sgroup": hbm.sgroup,
                "chunked_pairs": [rec["cand"], rec["tested"], rec["needed"]],
                "hbm_pairs": [rec_h["cand"], rec_h["tested"], rec_h["needed"]],
                "keys_max_abs_err": max(rec["err_keys"], rec_h["err_keys"]),
                "t_max_abs_err": max(rec["err_t"], rec_h["err_t"]), **extra})
        if not mt:
            adversarial = [
                adversarial_keys(dev, "large400_chunked_adversarial",
                                 chunked.caabb, tile, seed=31),
                adversarial_keys(dev, "large400_hbm_adversarial", hbm.caabb,
                                 tile, seed=32)]
        del single, chunked, hbm
        torch.cuda.empty_cache()
    emit({"phase": "kernels_large400", "ok": True, "adversarial": adversarial,
          "load_seconds": state["large400_load_s"],
          "tris_padded": scene.num_tris_padded, "cases": results})
    state["max_abs_err_400"] = {
        "keys": max(r["keys_max_abs_err"] for r in results),
        "t": max(r["t_max_abs_err"] for r in results)}


def phase_large400(dev, state):
    """Phase 6: the 400k-triangle interior through
    render_image_host_chunked (the frame loop under api.render_scene; the
    built-in interior is built in memory and has no OBJ file to parse),
    under the chunked plan (default options) and the supergroup plan."""
    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.integrator.wavefront import (
        render_image_host_chunked, resolve_plan)
    from montecarlopathtracing_torch.kernels import cluster as K

    scene = state["large400"]
    spp = LARGE400_SPP
    images = {}
    for label, mode, capture in (
            ("large400_chunked", "hbm", "cluster_intersect_chunked"),
            ("large400_hbm", "hbm_always", "cluster_intersect_hbm")):
        opts = RenderOptions(spp=spp, spp_chunk=spp, large_mode=mode)
        plan_name = "chunked" if mode == "hbm" else "hbm"
        plan = resolve_plan(opts, scene.num_tris_padded)
        check(plan[0] == ("cluster" if plan_name == "chunked" else "cluster_hbm"),
              f"{label}: unexpected plan {plan}")
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        img, rays = render_image_host_chunked(scene, None, opts, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = K.launch_counts()
        check_launched(launches, PATH_KERNELS[plan_name], label)
        with CaptureCall(capture) as cap:
            render_image_host_chunked(scene, None, opts, device=dev)
        state[f"calls_{label}"] = cap.calls
        check(len(cap.calls) > 0, f"{label}: no intersect call recorded")
        mean = image_checks(img, label)
        check(img.shape == (720, 1280, 3), f"{label}: image shape")
        images[label] = img
        acc = cap.calls[0][0]
        shape = ({"chunks": acc.num_chunks,
                  "clusters_per_chunk": acc.clusters_per_chunk}
                 if plan_name == "chunked" else
                 {"supergroups": acc.num_supergroups, "sgroup": acc.sgroup})
        state[f"launches_{label}"] = launches
        emit({"phase": label, "width": 1280, "height": 720, "spp": spp,
              "lanes": 65536, "tris_padded": scene.num_tris_padded,
              "plan": list(plan), **shape, "seconds": secs,
              "load_seconds": state["large400_load_s"], "rays": rays,
              "rays_per_s": rays / secs, "mean": mean, "launches": launches})
    a = images["large400_chunked"].cpu().numpy()
    b = images["large400_hbm"].cpu().numpy()
    outside = np.abs(a - b) > 1e-5 + 1e-4 * np.abs(a)
    frac = float(outside.any(axis=2).mean())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / max(abs(float(a.mean())), 1e-30)
    check(frac <= 0.005, f"large400: {frac:.4%} pixels differ between the plans")
    check(mean_rel <= 1e-4, f"large400: image means differ by {mean_rel:.3e}")
    emit({"phase": "large400_plans_agree", "frac_pixels_outside": frac,
          "mean_rel_diff": mean_rel, "max_abs_diff": float(np.abs(a - b).max())})


def phase_scan(dev):
    """The scan over samples against the lane pool on the card: the same
    estimator on the same RNG streams (tests/test_refill.py's contract)."""
    from montecarlopathtracing_torch.config import MODERN, RenderOptions
    from montecarlopathtracing_torch.integrator.wavefront import render_pixels
    from montecarlopathtracing_torch.kernels import cluster as K
    from montecarlopathtracing_torch.scene.builtin import load_builtin_box

    scene, _ = load_builtin_box(width=64, height=64, with_specular=True,
                                with_glass=True, device=dev)
    opts = RenderOptions(spp=4, max_depth=8, compat=MODERN)
    ids = torch.arange(64 * 64, dtype=torch.int32, device=dev)
    out = {}
    for name, refill in (("scan", False), ("refill", True)):
        K.reset_launch_counts()
        t0 = time.perf_counter()
        rad, rays = render_pixels(scene, None, opts.replace(refill=refill), ids)
        torch.cuda.synchronize()
        out[name] = (rad, int(rays), time.perf_counter() - t0, K.launch_counts())
        check_launched(out[name][3], PATH_KERNELS["single"], f"scan {name}")
    (a, ra, sa, la), (b, rb, sb, lb) = out["scan"], out["refill"]
    check(ra == rb and ra > 0, f"scan: rays {ra} (scan) != {rb} (refill)")
    check(bool(torch.isfinite(a).all()), "scan: non-finite radiance")
    check(bool(torch.allclose(a, b, rtol=1e-4, atol=1e-5)),
          "scan: radiance differs from the lane pool beyond rtol 1e-4 / atol 1e-5")
    emit({"phase": "scan", "width": 64, "height": 64, "spp": 4, "max_depth": 8,
          "rays": ra, "seconds_scan": sa, "seconds_refill": sb,
          "max_abs_diff": float((a - b).abs().max()),
          "launches_scan": la, "launches_refill": lb})


def grad_errors(ref, got):
    """{field: (max |ref - got|, largest |ref|)} over SceneParams fields, and
    whether every element is within atol 1e-6 + 1e-4 x the largest |ref|."""
    from montecarlopathtracing_torch.diff.gradients import PARAM_FIELDS

    errs, ok = {}, True
    for f in PARAM_FIELDS:
        a, b = getattr(ref, f).cpu(), getattr(got, f).cpu()
        if a.numel() == 0:
            continue
        scale = float(a.abs().max())
        err = (a - b).abs()
        ok = ok and bool((err <= 1e-6 + 1e-4 * scale).all())
        errs[f] = (float(err.max()), scale)
    return errs, ok


def grads_finite(g) -> bool:
    from montecarlopathtracing_torch.diff.gradients import PARAM_FIELDS

    return all(bool(torch.isfinite(getattr(g, f)).all()) for f in PARAM_FIELDS)


def phase_grad(dev, state):
    """Phase grad (a)-(d), see the module docstring."""
    import dataclasses

    from montecarlopathtracing_torch.config import MODERN, RenderOptions
    from montecarlopathtracing_torch.diff import gradients as G
    from montecarlopathtracing_torch.integrator.wavefront import render_image_stats
    from montecarlopathtracing_torch.kernels import cluster as K
    from montecarlopathtracing_torch.scene.builtin import load_builtin_box

    # (a) the card against the CPU.
    opts = RenderOptions(spp=4, max_depth=8, compat=MODERN, ns_gradient=True)
    target = np.random.default_rng(5).uniform(0.1, 0.6, (64, 64, 3)).astype(np.float32)
    grads, secs = {}, {}
    for name in ("cuda", "cpu"):
        scene, meta = load_builtin_box(width=64, height=64, with_specular=True,
                                       with_glass=True, device=name)
        t0 = time.perf_counter()
        _, grads[name] = G.loss_and_grad(G.SceneParams.from_scene(scene), scene,
                                         None, opts, torch.as_tensor(target),
                                         device=name)
        if name == "cuda":
            torch.cuda.synchronize()
            box64 = scene
        secs[name] = time.perf_counter() - t0
    check(grads_finite(grads["cuda"]), "grad (a): non-finite gradients on the card")
    errs, ok = grad_errors(grads["cpu"], grads["cuda"])
    check(ok, f"grad (a): card gradients differ from the CPU's: {errs}")
    emit({"phase": "grad_card_vs_cpu", "width": 64, "height": 64, "spp": 4,
          "max_depth": 8, "tolerance": "atol 1e-6 + 1e-4 x field max",
          "max_abs_err_and_scale": errs, "seconds_cuda": secs["cuda"],
          "seconds_cpu": secs["cpu"]})

    # (b) central finite differences on the card.
    fd_opts = opts.replace(ns_gradient=False)
    mi = meta.material_names.index("White")
    params = G.SceneParams.from_scene(box64)

    def image_sum(p):
        return torch.sum(G.render_with_params(p, box64, None, fd_opts, device=dev))

    leaves = params.leaves(dev)
    g = G.param_grads(image_sum(leaves), leaves)
    fds = []
    for field, idx, eps, rtol in (("kd", (mi, 0), 1e-3, 2e-2),
                                  ("light_radiance", (0, 1), 1e-2, 5e-3)):
        sums = []
        for sign in (1, -1):
            t = getattr(params, field).clone()
            t[idx] += sign * eps
            with torch.no_grad():
                sums.append(float(image_sum(dataclasses.replace(params, **{field: t}))))
        fd = (sums[0] - sums[1]) / (2 * eps)
        gval = float(getattr(g, field)[idx])
        check(bool(np.isclose(gval, fd, rtol=rtol, atol=1e-3)) and gval > 0,
              f"grad (b): {field}{list(idx)} autodiff {gval} vs FD {fd}")
        fds.append({"field": field, "index": list(idx), "eps": eps, "rtol": rtol,
                    "autodiff": gval, "fd": fd, "rel_err": abs(gval - fd) / abs(fd)})
    emit({"phase": "grad_fd", "cases": fds})

    # (c) the full-width gradient.
    scene, meta = load_builtin_box(width=1024, height=1024, device=dev)
    opts = RenderOptions(spp=16, max_depth=32, chunk_size=65536,
                         bwd_seg_per_sample=2.15)
    params = G.SceneParams.from_scene(scene)
    for _ in range(2):  # a warm-up run, then the timed one
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        leaves = params.leaves(dev)
        img, rays = render_image_stats(G.apply_params(scene, leaves), None, opts,
                                       differentiable=True, device=dev)
        loss = img.mean()
        rays = int(rays)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fwd = K.launch_counts()
        K.reset_launch_counts()
        g = G.param_grads(loss, leaves)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        bwd = K.launch_counts()
        peak = torch.cuda.max_memory_allocated() - base
        del img, loss, leaves
    check(rays > 0, f"grad (c): the budget truncated the render (n_rays {rays})")
    check(grads_finite(g), "grad (c): non-finite gradients")
    check(float(g.kd[meta.material_names.index("White"), 0]) > 0,
          "grad (c): the White kd gradient is not positive")
    check_launched(fwd, PATH_KERNELS["single"], "grad (c) forward")
    check(all(v == 0 for v in bwd.values()),
          f"grad (c): the backward pass launched key or intersect kernels: {bwd}")
    state["launches_grad_forward"], state["launches_grad_backward"] = fwd, bwd
    emit({"phase": "grad_full_width", "width": 1024, "height": 1024, "spp": 16,
          "max_depth": 32, "lanes": 65536, "bwd_seg_per_sample": 2.15,
          "rays": rays, "forward_seconds": t1 - t0, "backward_seconds": t2 - t1,
          "seconds": t2 - t0, "fwd_bwd_rays_per_s": rays / (t2 - t0),
          "backward_over_forward": (t2 - t1) / (t1 - t0),
          "peak_bytes_over_baseline": peak, "baseline_bytes": base,
          "launches_forward": fwd, "launches_backward": bwd,
          "kd_grad_white": float(g.kd[meta.material_names.index("White"), 0])})
    del g
    torch.cuda.empty_cache()

    # (d) inverse rendering.
    scene, meta = load_builtin_box(width=256, height=256, device=dev)
    opts = RenderOptions(spp=4, max_depth=8)
    mi = meta.material_names.index("Red")
    truth = G.SceneParams.from_scene(scene)
    with torch.no_grad():
        target = G.render_with_params(truth, scene, None, opts, device=dev)
    kd = truth.kd.clone()
    kd[mi] = 0.5
    params = dataclasses.replace(truth, kd=kd)
    losses = []
    t0 = time.perf_counter()
    for _ in range(5):
        params, loss = G.train_step(params, scene, None, opts, target, lr=0.9,
                                    device=dev)
        losses.append(float(loss))
        emit({"phase": "grad_inverse_step", "step": len(losses) - 1,
              "loss": losses[-1], "kd_red": params.kd[mi].tolist()})
    secs = time.perf_counter() - t0
    with torch.no_grad():
        final = float(G.image_loss(params, scene, None, opts, target, device=dev))
    err0 = float((kd[mi] - truth.kd[mi]).norm())
    err1 = float((params.kd[mi] - truth.kd[mi]).norm())
    check(final < losses[0], f"grad (d): loss {losses[0]} -> {final} did not fall")
    check(err1 < err0, f"grad (d): red kd moved away from the truth ({err0} -> {err1})")
    emit({"phase": "grad_inverse", "width": 256, "height": 256, "spp": 4,
          "max_depth": 8, "lr": 0.9, "losses": losses, "final_loss": final,
          "kd_red_true": truth.kd[mi].tolist(), "kd_red_error": [err0, err1],
          "seconds": secs})


def phase_grad_chunked(dev, state):
    """Phase grad (e): a gradient through the chunked plan on the card
    against the CPU.  The table budgets are lowered as tests/test_torch_large
    lowers them, so the 2k-triangle interior (2,048 padded triangles) is past
    the single-table budget and cut into 3 chunks; MODERN, 32 x 32, spp 2,
    max_depth 5, subtiles of 16 rays.  Keys and intersect are counted in the
    forward pass (rows 3 and 4, > 0) and in the backward pass (0)."""
    from montecarlopathtracing_torch.config import MODERN, RenderOptions
    from montecarlopathtracing_torch.diff import gradients as G
    from montecarlopathtracing_torch.integrator import wavefront as W
    from montecarlopathtracing_torch.kernels import cluster as K
    from montecarlopathtracing_torch.scene.builtin import load_builtin_large

    opts = RenderOptions(spp=2, max_depth=5, seed=11, cluster_width=4,
                         cluster_rays=16, sort_rays=True, compat=MODERN)
    target = np.random.default_rng(6).uniform(0.1, 0.6, (32, 32, 3)).astype(
        np.float32)
    saved = W._VMEM_TABLE_BUDGET, W._VMEM_CHUNK_BUDGET
    W._VMEM_TABLE_BUDGET, W._VMEM_CHUNK_BUDGET = 64 << 10, 48 << 10
    grads, launches = {}, {}
    try:
        for name in ("cuda", "cpu"):
            scene, _ = load_builtin_large(n_tris=2000, options=opts, width=32,
                                          height=32, n_textures=1, device=name)
            plan = W.resolve_plan(opts, scene.num_tris_padded)
            check(plan == ("cluster", 128, 1, 3),
                  f"grad (e): expected the chunked plan, got {plan}")
            leaves = G.SceneParams.from_scene(scene).leaves(name)
            K.reset_launch_counts()
            img, rays = W.render_image_stats(G.apply_params(scene, leaves), None,
                                             opts, differentiable=True,
                                             device=name)
            loss = torch.mean((img - torch.as_tensor(target, device=name)) ** 2)
            fwd = K.launch_counts()
            K.reset_launch_counts()
            grads[name] = G.param_grads(loss, leaves)
            launches[name] = (fwd, K.launch_counts())
            check(int(rays) > 0, f"grad (e): the budget truncated the render "
                                 f"on {name} (n_rays {int(rays)})")
    finally:
        W._VMEM_TABLE_BUDGET, W._VMEM_CHUNK_BUDGET = saved
    fwd, bwd = launches["cuda"]
    check_launched(fwd, PATH_KERNELS["chunked"], "grad (e) forward")
    check(all(v == 0 for v in bwd.values()),
          f"grad (e): the backward pass launched key or intersect kernels: {bwd}")
    check(grads_finite(grads["cuda"]), "grad (e): non-finite gradients on the card")
    errs, ok = grad_errors(grads["cpu"], grads["cuda"])
    check(ok, f"grad (e): card gradients differ from the CPU's: {errs}")
    check(float(grads["cuda"].kd.abs().max()) > 0, "grad (e): zero kd gradient")
    emit({"phase": "grad_chunked_card_vs_cpu", "width": 32, "height": 32,
          "spp": 2, "max_depth": 5, "plan": list(plan),
          "tolerance": "atol 1e-6 + 1e-4 x field max",
          "max_abs_err_and_scale": errs, "launches_forward": fwd,
          "launches_backward": bwd})


def phase_parity(dev, state):
    from montecarlopathtracing_torch.config import MODERN, RenderOptions
    from montecarlopathtracing_torch.integrator.wavefront import render_image_stats
    from montecarlopathtracing_torch.scene.builtin import load_builtin_box

    opts = RenderOptions(spp=4, max_depth=8, compat=MODERN)
    out = {}
    for name in ("cuda", "cpu"):
        scene, _ = load_builtin_box(width=64, height=64, with_specular=True,
                                    with_glass=True, device=name)
        img, rays = render_image_stats(scene, None, opts, device=name)
        out[name] = (img.cpu().numpy(), int(rays))
    a, b = out["cpu"][0], out["cuda"][0]
    # Same tolerance as the CPU parity test against the JAX package:
    # rtol 1e-4 / atol 1e-5 per value, at most 0.5% of pixels outside it
    # (paths that diverge at an edge), image mean within 1e-4 relative.
    outside = np.abs(a - b) > 1e-5 + 1e-4 * np.abs(a)
    frac = float(outside.any(axis=2).mean())
    mean_rel = abs(float(a.mean()) - float(b.mean())) / max(abs(float(a.mean())), 1e-30)
    check(frac <= 0.005, f"parity: {frac:.4%} pixels outside tolerance")
    check(mean_rel <= 1e-4, f"parity: image mean differs by {mean_rel:.3e}")
    emit({"phase": "parity", "width": 64, "height": 64, "spp": 4,
          "rays_cuda": out["cuda"][1], "rays_cpu": out["cpu"][1],
          "frac_pixels_outside": frac, "mean_rel_diff": mean_rel,
          "max_abs_diff": float(np.abs(a - b).max())})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from montecarlopathtracing_torch.kernels import build as B

    dev = "cuda"
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count()})

    state = {}
    t0 = time.perf_counter()
    built = B.build()
    info = {}
    for name, b in built.items():
        regs = [ln.strip() for ln in b["log"].splitlines() if "registers" in ln]
        info[name] = {"seconds": b["seconds"], "ptxas": regs}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels": info})
    phase_kernels(dev, state)
    phase_kernels_large400(dev, state)
    phase_box(dev, state)
    phase_large(dev, state)
    phase_large400(dev, state)
    phase_parity(dev, state)
    phase_scan(dev)
    phase_grad(dev, state)
    phase_grad_chunked(dev, state)
    phase_timing(state)

    csrc = "montecarlopathtracing_torch/kernels/csrc/"
    tpu = "montecarlopathtracing_tpu/kernels/cluster.py:"
    frames = ("box", "large", "large400_chunked", "large400_hbm")
    t400c, t400h = state["time_large400_chunked"], state["time_large400_hbm"]
    # name -> (source, TPU call site, the frame its launches and times are
    # from, that frame's stats, max_abs_err over the kernels phases).
    table = {
        "cluster_keys": (
            "cluster_keys.cu", "257", "large", state["time_large"],
            state["max_abs_err"]["cluster_keys"]),
        "cluster_intersect": (
            "cluster_intersect.cu", "618", "large", state["time_large"],
            state["max_abs_err"]["cluster_intersect"]),
        "cluster_keys_chunked": (
            "cluster_keys.cu", "955", "large400_chunked", t400c,
            max(state["max_abs_err_400"]["keys"],
                t400c["err"]["cluster_keys_chunked"])),
        "cluster_intersect_ftb": (
            "cluster_intersect_ftb.cu", "987", "large400_chunked", t400c,
            max(state["max_abs_err_400"]["t"],
                t400c["err"]["cluster_intersect_ftb"])),
        "cluster_intersect_hbm": (
            "cluster_intersect_hbm.cu", "1270", "large400_hbm", t400h,
            max(state["max_abs_err_400"]["t"],
                t400h["err"]["cluster_intersect_hbm"])),
    }
    rows = []
    for name, (src, site, frame, stats, err) in table.items():
        t = stats[name]
        by_frame = {f: state[f"launches_{f}"][name]
                    for f in frames + ("grad_forward", "grad_backward")}
        check(by_frame[frame] > 0, f"{name} was not launched on frame {frame}")
        row = {
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": tpu + site, "launches": by_frame[frame],
            "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t.get("library_ms"), "frame": frame,
            "ms_max": t["ms_max"],
            "ms_max_over_mean": t["ms_max_over_mean"],
            "bound_unfused_ms": t["bound_unfused_ms"],
            "launches_by_frame": by_frame,
        }
        if frame == "large":
            tb = state["time_box"][name]
            row.update(ms_box=tb["ms"], plain_ms_box=tb["plain_ms"],
                       library_ms_box=tb.get("library_ms"),
                       bound_ms_box=tb["bound_ms"],
                       bound_unfused_ms_box=tb["bound_unfused_ms"])
        if name == "cluster_keys":
            th = t400h[name]
            row.update(ms_large400_hbm=th["ms"],
                       ms_keys_only_large400_hbm=th["ms_keys_only"],
                       library_ms_large400_hbm=th["library_ms"],
                       plain_ms_large400_hbm=th["plain_ms"],
                       bound_ms_large400_hbm=th["bound_ms"],
                       bound_unfused_ms_large400_hbm=th["bound_unfused_ms"])
        if "ms_keys_only" in t:
            row["ms_keys_only"] = t["ms_keys_only"]
        if "pairs" in stats and name.startswith("cluster_intersect"):
            row.update(stats["pairs"])
        if name == "cluster_intersect_ftb":
            fb = state["ftb_builds"]
            row.update(ms_skip_tests=fb["ms_skip_tests"],
                       pairs_rejectable_share=fb["pairs_rejectable_share"],
                       blocks_without_row_per_call=fb["blocks_without_row_per_call"])
        rows.append(row)
    emit({"kernels": rows})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
