#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths once on one CUDA card.

    python3 chip_smoke.py

Phases, always all of them, one JSON line each (any failure raises and
exits non-zero):

1. device   the card's name and power limit (nvidia-smi), and whether PIL
            is installed (the port's textures load without it);
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
            render_image_host_chunked (single-table plan); then
            kernels.cluster.candidate_stats on it; 5 and 6 check that the
            interior's atlas holds all 327,680 texels;
6. large400 the 400k-triangle interior at 1280 x 720 through
            api.render_scene, once with the default options (chunked plan)
            and once with large_mode="hbm_always" (supergroup plan); the two
            images must agree;
            each of 4, 5 and 6 renders its frame twice: once timed, its
            lane pool's blocks replayed as CUDA graphs, with the launch
            counters zeroed just before and read just after, and once under
            wavefront.eager() (one launch per op) with the intersect calls
            recorded for phase 8; the two frames must be bit for bit equal,
            with the same rays and launch counts;
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
            / d SceneParams, once to warm up, once timed (forward and
            backward seconds, fwd+bwd rays/s, peak memory) and once under
            wavefront.eager(), the key and
            intersect launches counted in the forward pass (> 0) and in the
            backward pass (must be 0); (d) five diff.gradients.train_step
            calls at 256 x 256, spp 4, max_depth 8, from a grey red wall
            toward a target rendered with the true kd: the loss must fall and
            the red kd move toward the truth; (e) a gradient through the
            chunked plan (the 2k-triangle interior past lowered table
            budgets, 3 chunks, MODERN, 32 x 32) on the card against the CPU
            within (a)'s tolerance, rows 3 and 4 launched in the forward pass
            and no key or intersect kernel in the backward pass; (f) the scan
            renderer's gradient: in scan_graphs below; (g) (e)'s scene,
            budgets and loss under large_mode="hbm_always" (the supergroup
            plan): rows 1 and 5 launched in the forward pass, none in the
            backward pass, card against CPU within (a)'s tolerance;
            (a), (c), (e), (g) and the ranks' gradients on the card are
            computed with both passes replayed as CUDA graphs and again
            under wavefront.eager(), and held together (grad_graphs below);
   scan_graphs  the scan renderer (refill=False) with its blocks replayed
            as CUDA graphs, one set of graphs a frame, each frame at full
            width and at a check size (one chunk of 65,536 lanes) captured
            and again under wavefront.eager(): image bit for bit, the same
            rays, launches, bounces and idle bounces past the drain, every
            kind of block captured after its first op-by-op run and every
            later block a replay; per frame captured / eager seconds at the
            check size, the full-width seconds, rays/s, graphs, replays,
            capture ms and idle bounces:
            box-1024-spp16-scan, the built-in box at 1024 x 1024, spp 16,
            max_depth 32, 65,536 lanes, compat (bench_torch.py's fwd options
            with refill=False; kernels 1 and 2): the check at 256 x 256, spp
            4, through render_image and render_image_host_chunked; the full
            frame (render_image) within rtol 1e-4 / atol 1e-5 of the lane
            pool's frame of the same options, with equal rays, and at the
            image limit of the port's CPU render at 16,384 of
            bench_torch.py's pixel ids;
            box-1024-spp16-scan-grad, d mean(image) / d SceneParams of that
            frame (grad (c)'s loss), once, captured: its image bit for bit
            the scan frame's (the bounces past the drain add nothing), its
            gradient within grad (a)'s tolerance of grad (c)'s lane-pool
            gradient, its backward pass (which recomputes every sample, the
            JAX package's jax.checkpoint(sample_body)) launching each key
            and intersect kernel exactly as often as its forward pass, its
            forward and backward seconds and peak memory over the baseline
            (under 1 GB: one sample's residuals are held at a time); the
            check (grad (f)) on the 256 x 256 MODERN spec+glass box, spp 2,
            max_depth 32, d mean((image - target)^2) / d SceneParams,
            captured against eager(), loss_and_grad's gradient bit for bit
            the same, the card within grad (a)'s tolerance of the CPU, and
            every intersect call of its backward pass (recorded under
            eager()) replayed: keys and intersect exactly their plain
            versions;
            box-256-scan-grad-memory, that gradient of the 256 x 256 box
            (one chunk of 65,536 lanes) at spp 2 and at spp 16: the two
            peaks over the baseline differ by less than one sample's
            residual bytes (scan_stats' residual_bytes);
            interior-400k-720p-spp4-scan, the 400k interior at 1280 x 720,
            spp 4, chunked plan (kernels 3 and 4), through
            render_image_host_chunked, held to the CPU at 4,096 of
            bench_torch.py's pixel ids; its check is one chunk of the
            frame's pixel ids through render_pixels;
            interior-400k-720p-spp4-scan-grad, d mean(image) / d
            SceneParams of that frame through render_image_stats, captured:
            its image bit for bit the scan frame of the same options and
            entry point, equal rays, backward launches equal to the
            forward's, kernels 3 and 4 in both; seconds, launches and peak
            memory of each pass; at 512 of bench_torch.py's pixel ids
            through render_pixels(differentiable=True) the card (under
            eager()) within grad (a)'s tolerance of the CPU, every intersect
            call of its backward pass replayed, kernels 3 and 4 exactly
            their plain versions;
            interior-400k-720p-spp4-grad, the lane pool's gradient of the
            same scene, options and loss (bwd_seg_per_sample 4: no sample
            dropped, its image within rtol 1e-4 / atol 1e-5 of the lane
            pool's frame), kernels 3 and 4 in forward, none in backward;
            the scan gradient within grad (a)'s tolerance of it;
   compat_frame  the box at 256 x 256, spp 4, compat, rendered whole
            through render_image_host_chunked on the card and on the CPU,
            every pixel held to the image limit (pixels outside printed);
   recovery test_failure_recovery.py's options on a 64 x 64 box on the
            card: a dispatch that raises once under retries=1 and a
            truncated checkpoint that makes render_progressive start over,
            each film bit for bit the uninterrupted card film's; with
            retries=0 the fault propagates;
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
   walks    the two LBVH walk kernels (csrc/bvh_walk.cu, csrc/packet_walk.cu):
            (a) on the box and the 100k interior, compat and MT, random rays
            with adversarial ones (axis-parallel on node planes, -0.0,
            parked, misses) and the interior's camera and shadow rays,
            exactly equal to the plain walks and within the brute-force
            contract; (b) frames at full width under intersector="bvh" and
            "bvh_perray", MODERN: the box at 1024 x 1024, spp 16, max_depth
            32, and the 100k interior at 1280 x 720, spp 4, each held to the
            cluster render of the same options (the card-vs-CPU image
            limits), with the walk's launches counted (no cluster kernel may
            run); (c) the 400k interior past a chunk cap of 4 under
            large_mode="chunked": resolve_plan gives the packet walk, and
            the frame renders; each walk frame rendered twice, timed
            (CUDA graphs), then under wavefront.eager() recorded for the
            replay, bit for bit the same; the packet walk also on adversarial
            packets (equal-t ties in one fat leaf and across leaves, a ray
            that misses a node its packet enters and meets its own leaf
            later, small max_steps, packet sizes and leaf widths off their
            defaults, a tree with NaN boxes), compat and MT, exactly equal
            to the plain walk, and
            the per-ray walk under the package's build and its parent
            design (-DMCPT_BVH_WALK_V1) on adversarial rays (1, 31, 33 and
            fewer rays than the card's SMs, equal-t ties across leaves on the
            box floor and on the doubled box, max_steps 1 and 3, a tree
            with NaN boxes), exactly equal to the plain walk;
   oracle   (d) a 16 x 16 box on the card against the port's f64 oracle
            (tests/test_oracle.py's limits);
   native   (e) the box and the 100k interior written to OBJ / MTL and loaded
            with use_native=True: the C++ parser ran and its fields equal
            the Python parser's;
   ranks    (f) two ranks spawned on the card with gloo collectives on CUDA
            tensors: render_image_sharded on a 2 x 1 and a 1 x 2 grid
            against one process, and one make_distributed_train_step step
            against train_step (tests/test_parallel.py's tolerances); d
            mean(image) / d SceneParams through render_image_sharded with
            differentiable=True (64 x 64 box, MODERN) on both grids, bit for
            bit the same on both ranks and within grad (a)'s tolerance of one
            process's, rows 1 and 2 launched in every rank;
   torchrun the CLI under python -m torch.distributed.run with two ranks on
            the card and --mesh-tile 2 (gloo): exit code 0, its PNG byte for
            byte the one-process CLI's or within the image limit;
   profile  (g) the CLI's --profile writes a trace holding device kernels;
   atlas_grad  the atlas gather's backward kernel (csrc/atlas_grad.cu,
            through kernels/atlas.py, its torch.sort included) at the
            interior's shapes (65,536 lanes, 327,680 texels; 61% of the
            lanes untextured at texel 0, 9% misses at the last, 30% on
            2,000 texels): its sums within 1e-6 of a float64 index_add_
            (relative to each texel's sum of |rows|), bit for bit the same
            over two calls, its counters; timed beside its byte bound, the
            plain version (index_add_ with a sentinel row) and the library
            call it replaces, index_put_(accumulate=True) of every lane's
            masked row (the autograd of atlas[idx]), and torch.sort alone;
   bench    (h) bench_torch.py run as a subprocess at a reduced size (the
            box at 256 x 256, stages fwd, bwd and stats, one timed run): exit
            code 0, correct: true, this card's name;
   grad_graphs  every gradient of (a), (c), (e), (g) and the ranks (the one
            process's and each rank's on both grids), computed with its
            forward and backward blocks replayed as CUDA graphs and again
            under wavefront.eager(): per gradient the forward and backward
            seconds of both, blocks, graphs, replays and capture ms of each
            pass, the launches of the forward pass (the backward's must be
            0), whether the images are bit-equal (they must be, with the same
            rays and launches) and each field's largest difference; each pass
            must replay a graph, every block after its first (so more than
            once past two blocks); a gradient field must equal the eager one
            bit for bit unless a second eager gradient differs from the
            first, and then agree within (a)'s tolerance
            (``not_reproducible_eager`` lists such fields);
   graphs   every forward frame above rendered with CUDA graphs and under
            wavefront.eager() (phases 4-6, the walk frames, compat_frame,
            recovery, the ranks' and the one process's sharded frames): per
            frame the seconds of both, graphs captured, replays, capture and
            instantiate ms, iterations and idle iterations past the drain,
            and bit-equal (every one must be); a dispatch of more than one
            block must capture a graph and replay every later block, and
            the full-size frames more than one replay per dispatch;
   walk timing  every walk frame's recorded calls replayed: the kernel on
            the whole call against the plain walk on a slice of it (whole
            packets for the packet walk), and a few whole calls timed with
            both, exact; the bound's operations are the slab and triangle
            tests the per-ray plain walk makes on the same call (the
            function's needs), the packet walk's own tests printed beside;
            every call of every walk frame replayed whole under its walk's
            designs (WALK_DESIGNS), each build held bit for bit to the
            package's, ms per launch mean and max over all calls: the packet
            walk's three frames under the package's build and builds that
            take one of its two kernels for every call (the parent design,
            -DMCPT_PACKET_WALK_V1; the redesign, -DMCPT_PACKET_WALK_V2), and
            their -DMCPT_WALK_STATS builds (steps per packet, fat-leaf visits
            with a hit, rays and warps per visit, clock cycles per step and
            their split; "packet_walk_designs" lines); the per-ray walk's two
            frames under the package's build (the redesign) and the parent
            design (-DMCPT_BVH_WALK_V1), and both -DMCPT_WALK_STATS builds
            (steps per ray mean, p99 and max, leaf tests, SIMT efficiency,
            clock cycles per step and their split, the blocks' end times;
            "bvh_walk_designs" lines);
9. a "phase_seconds" line (each phase's wall seconds), a "kernels" line
   with one row per ported kernel (the five cluster
   kernels and the two walks), then the card's nvidia-smi line, then the
   last line {"ok": true, "device": {...}}.

The recording renders and the replays of phase 8 come after the counters are
read and are not counted.  A replay runs no Python, so every render that
records calls runs under wavefront.eager().
Imports only numpy, torch and montecarlopathtracing_torch.
"""

from __future__ import annotations

import importlib.util
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

# Texels of the built-in interior's atlas: the 256 x 256 floor and seven
# prop textures (four at 128, three at 256), whatever its triangle count.
INTERIOR_TEXELS = 327_680

# GPU clock cycles the stream sleeps before a timed call (~1 ms on an H100),
# so the host has enqueued the call before the start event is stamped.
SLEEP_CYCLES = 2_000_000


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    large, state["large_meta"] = load_builtin_large(n_tris=100_000, width=1280,
                                                    height=720, device=dev)
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


def check_interior_atlas(scene, label: str):
    """The built-in interior loaded every texture (with or without PIL)."""
    check(int(scene.atlas.shape[0]) == INTERIOR_TEXELS,
          f"{label}: the interior's atlas holds {int(scene.atlas.shape[0])} "
          f"texels, not {INTERIOR_TEXELS}")


def image_agreement(ref, img, label: str):
    """``img`` held to ``ref`` at the card-vs-CPU image limit
    (utils/image_limit.py: at most 0.5% of pixels outside rtol 1e-4 / atol
    1e-5 of ``ref``, the means within 1e-4 relative)."""
    from montecarlopathtracing_torch.utils.image_limit import (
        image_agreement as agreement, within_image_limit)

    res = agreement(img, ref)
    check(within_image_limit(res), f"{label}: the image is outside the limit: {res}")
    return res


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


# The forward frames' graph records (frame -> record), printed as the
# "graphs" line; the full-size frames (MAIN_GRAPH_FRAMES) must replay graphs
# more than once per dispatch, and each builds one lane pool unless
# hold_graphs is told otherwise.
GRAPH_FRAMES = {}
MAIN_GRAPH_FRAMES = ("box", "large", "large400_chunked", "large400_hbm",
                     "box_bvh", "box_bvh_perray", "large_bvh",
                     "large_bvh_perray", "large400_fallback", "box_pool",
                     "box_kept", "large_pool", "large_kept")


def counted(fn, eager: bool = False):
    """fn() (a render returning (image, rays)) with the kernels' launch
    counters and the lane pool's loop stats zeroed just before and read just
    after; inside wavefront.eager() when ``eager``.  Returns (image, rays,
    seconds, launches, loop stats)."""
    import contextlib

    from montecarlopathtracing_torch.accel import lbvh as L
    from montecarlopathtracing_torch.integrator import wavefront as W
    from montecarlopathtracing_torch.kernels import cluster as K

    torch.cuda.synchronize()
    K.reset_launch_counts()
    L.reset_launch_counts()
    W.reset_loop_stats()
    t0 = time.perf_counter()
    with W.eager() if eager else contextlib.nullcontext():
        img, rays = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return (img, rays, secs, {**K.launch_counts(), **L.launch_counts()},
            W.loop_stats())


def hold_graphs(label: str, captured, eager, pools=None):
    """A frame rendered with its blocks replayed as CUDA graphs
    (``captured``) against the same frame under wavefront.eager(), each a
    counted() result: the image bit for bit, the same rays and the same
    launch counts; every block replayed a graph but the first block of each
    new lane pool (a dispatch on a kept pool runs none op by op, and one
    that captured nothing counts in ``pool_reuses``).  ``pools``, where
    given (1 for a full-size frame by default), is the number of lane pools
    the frame builds: each captures a graph; a frame that builds none
    captures nothing and counts every dispatch in ``pool_reuses``.  Records
    the frame for the graphs line."""
    from montecarlopathtracing_torch.integrator import wavefront as W

    img, rays, secs, launches, st = captured
    img_e, rays_e, secs_e, launches_e, st_e = eager
    equal = bool(torch.equal(img, img_e))
    check(equal, f"{label}: the captured frame differs from the eager one")
    check(float(rays) == float(rays_e),
          f"{label}: rays {float(rays)} captured, {float(rays_e)} eager")
    check(launches == launches_e, f"{label}: launches {launches} captured, "
                                  f"{launches_e} eager")
    d, blocks = st["dispatches"], st["iterations"] // W._CHECK_EVERY
    check(d > 0 and st["iterations"] == st_e["iterations"]
          and st["idle_iterations"] == st_e["idle_iterations"]
          and st["eager_blocks"] + st["replays"] == blocks
          and st["eager_blocks"] + st["pool_reuses"] <= d
          and st_e["graphs"] == st_e["pool_reuses"] == 0,
          f"{label}: loop stats {st} captured, {st_e} eager")
    if label in MAIN_GRAPH_FRAMES:
        check(st["replays"] > d,
              f"{label}: fewer replays than the dispatches need: {st}")
        pools = 1 if pools is None else pools
    if pools is not None:
        check(st["eager_blocks"] == pools
              and (st["graphs"] >= pools if pools else
                   st["graphs"] == 0 and st["pool_reuses"] == d),
              f"{label}: {pools} new lane pools expected, loop stats {st}")
    GRAPH_FRAMES[label] = {
        "seconds_captured": secs, "seconds_eager": secs_e,
        "eager_over_captured": secs_e / secs, "dispatches": d,
        "graphs": st["graphs"], "replays": st["replays"],
        "pool_reuses": st["pool_reuses"],
        "capture_ms": st["capture_s"] * 1e3, "iterations": st["iterations"],
        "idle_iterations": st["idle_iterations"], "bit_equal": equal}


def kept_frames(label: str, scene, opts, dev):
    """Two frames of ``opts`` (spp in dispatches of ``spp_chunk``) on one
    scene, of seeds 1 and 2, each held bit for bit to the same frame under
    wavefront.eager() (hold_graphs): the first builds a lane pool, whose
    later dispatches replay the graphs its first dispatch captured; the
    second runs on the kept pool alone, with a new seed word and sample
    offsets written into the buffers its graphs read."""
    from montecarlopathtracing_torch.integrator.wavefront import (
        render_image_host_chunked)

    def frame(seed: int):
        return lambda: render_image_host_chunked(
            scene, None, opts.replace(seed=seed), device=dev)

    first = counted(frame(1))
    hold_graphs(f"{label}_pool", first, counted(frame(1), eager=True), pools=1)
    second = counted(frame(2))
    hold_graphs(f"{label}_kept", second, counted(frame(2), eager=True), pools=0)
    st = first[4]
    check(st["dispatches"] > 1 and st["pool_reuses"] == st["dispatches"] - 1,
          f"{label}_pool: a later dispatch did not replay the first's graphs "
          f"alone: {st}")
    check(not torch.equal(first[0], second[0]),
          f"{label}: the frames of seeds 1 and 2 are equal")


def phase_box(dev, state):
    from montecarlopathtracing_torch import api, read_png
    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.scene.builtin import write_box_scene

    with tempfile.TemporaryDirectory() as d:
        write_box_scene(d, "box", width=1024, height=1024)
        stats, paths = {}, []

        def render(out: str):
            img, path = api.render_scene(d, "box", spp=16,
                                         options=RenderOptions(spp_chunk=16),
                                         out_dir=os.path.join(d, out),
                                         device=dev, stats=stats)
            paths.append(path)
            return img, stats["rays"]

        captured = counted(lambda: render("out"))
        img, path, launches = captured[0], paths[0], captured[3]
        phase2_s, phase1_s, rays = stats["phase2_s"], stats["phase1_s"], stats["rays"]
        with CaptureCall() as cap:
            hold_graphs("box", captured, counted(lambda: render("capture"),
                                                 eager=True))
        state["calls_box"] = cap.calls
        check_launched(launches, PATH_KERNELS["single"], "box")
        mean = image_checks(img, "box")
        check(img.shape == (1024, 1024, 3), "box: image shape")
        png = read_png(path)
        check(png.shape == (1024, 1024, 3) and png.max() > 0, "box: PNG")
        # The benchmark's box frames' dispatch shape (spp 5: five flush
        # phases) on a scene loaded once.
        scene, _ = api.load_scene(d, "box", device=dev)
        kept_frames("box", scene, RenderOptions(spp=10, spp_chunk=5), dev)
        del scene
    state["launches_box"] = launches
    emit({"phase": "box", "width": 1024, "height": 1024, "spp": 16,
          "lanes": 65536, "seconds": phase2_s, "load_seconds": phase1_s,
          "rays": rays, "rays_per_s": rays / phase2_s, "mean": mean,
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
    captured = counted(lambda: render_image_host_chunked(scene, None, opts,
                                                         device=dev))
    img, rays, secs, launches = captured[:4]
    with CaptureCall() as cap:
        hold_graphs("large", captured, counted(
            lambda: render_image_host_chunked(scene, None, opts, device=dev),
            eager=True))
    state["calls_large"] = cap.calls
    check_launched(launches, PATH_KERNELS["single"], "large")
    # The benchmark's interior frames' dispatch shape (spp 10 in two of 5).
    kept_frames("large", scene, RenderOptions(spp=10, spp_chunk=5), dev)
    # Candidate clusters per subtile on this frame's tiles and a bounce
    # wavefront (the key kernel on the card), as bench.py's stats stage
    # reports them.
    cand = K.candidate_stats(scene, opts)
    check(all(np.isfinite(v) for v in cand.values()) and cand["primary_cand"] >= 1,
          f"large: candidate_stats gave {cand}")
    emit({"phase": "candidate_stats", "case": "large", **cand})
    mean = image_checks(img, "large")
    check_interior_atlas(scene, "large")
    state["launches_large"] = launches
    emit({"phase": "large", "width": 1280, "height": 720, "spp": 4,
          "tris_padded": scene.num_tris_padded, "clusters": 1024,
          "cluster_width": 128, "materials": scene.num_materials,
          "texels": int(scene.atlas.shape[0]), "seconds": secs,
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

    scene = state["large400"]
    check_interior_atlas(scene, "large400")
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
        captured = counted(lambda: render_image_host_chunked(scene, None, opts,
                                                             device=dev))
        img, rays, secs, launches = captured[:4]
        check_launched(launches, PATH_KERNELS[plan_name], label)
        with CaptureCall(capture) as cap:
            hold_graphs(label, captured, counted(
                lambda: render_image_host_chunked(scene, None, opts, device=dev),
                eager=True))
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
              "texels": int(scene.atlas.shape[0]),
              "plan": list(plan), **shape, "seconds": secs,
              "load_seconds": state["large400_load_s"], "rays": rays,
              "rays_per_s": rays / secs, "mean": mean, "launches": launches})
    emit({"phase": "large400_plans_agree",
          **image_agreement(images["large400_chunked"], images["large400_hbm"],
                            "large400 plans")})


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


# The gradients' graph records (gradient -> record), printed as the
# "grad_graphs" line.
GRAD_FRAMES = {}


def timed_gradient(forward, eager: bool = False) -> dict:
    """One gradient: ``forward()`` returns (image, rays, loss, leaves), then
    d loss / d leaves, with the kernels' launch counters and the loop stats
    zeroed just before and read after each pass; inside wavefront.eager()
    when ``eager``.  Returns the image, rays, gradient, each pass's seconds
    and launches, grad_loop_stats(), scan_stats() and the peak memory over
    the allocation before it."""
    import contextlib

    from montecarlopathtracing_torch.accel import lbvh as L
    from montecarlopathtracing_torch.diff import gradients as G
    from montecarlopathtracing_torch.integrator import wavefront as W
    from montecarlopathtracing_torch.kernels import cluster as K

    def launches():
        return {**K.launch_counts(), **L.launch_counts()}

    with W.eager() if eager else contextlib.nullcontext():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launch_counts()
        L.reset_launch_counts()
        W.reset_loop_stats()
        t0 = time.perf_counter()
        img, rays, loss, leaves = forward()
        rays = int(rays)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fwd = launches()
        K.reset_launch_counts()
        L.reset_launch_counts()
        grads = G.param_grads(loss, leaves)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
    return {"img": img.detach(), "rays": rays, "grads": grads,
            "forward_s": t1 - t0, "backward_s": t2 - t1, "launches_forward": fwd,
            "launches_backward": launches(), "stats": W.grad_loop_stats(),
            "scan_stats": W.scan_stats(),
            "peak_over_baseline": torch.cuda.max_memory_allocated() - base}


def hold_grad_graphs(label: str, forward, captured=None) -> dict:
    """A gradient with both passes replayed as CUDA graphs (``captured``, a
    timed_gradient() result, or made here) against the same gradient under
    wavefront.eager(): the image bit for bit and the same rays and launch
    counts (none in backward); every block of each pass is a replay but the
    first of a pass on a new lane pool, which runs op by op and captures (a
    pass on a pool kept from an earlier call captures nothing).
    The gradient must equal the eager one bit for bit, except in a field
    where a second eager gradient differs from the first (an operation that
    does not reproduce itself); there it must agree within atol 1e-6 + 1e-4
    x the field's largest magnitude.  Records the gradient for the
    grad_graphs line and returns the captured result."""
    from montecarlopathtracing_torch.diff.gradients import PARAM_FIELDS

    cap = timed_gradient(forward) if captured is None else captured
    eag = timed_gradient(forward, eager=True)
    equal = bool(torch.equal(cap["img"], eag["img"]))
    check(equal, f"{label}: the captured gradient's image differs from the "
                 "eager one")
    check(cap["rays"] == eag["rays"],
          f"{label}: rays {cap['rays']} captured, {eag['rays']} eager")
    for p in ("forward", "backward"):
        check(cap[f"launches_{p}"] == eag[f"launches_{p}"],
              f"{label}: {p} launches {cap[f'launches_{p}']} captured, "
              f"{eag[f'launches_{p}']} eager")
    check(not any(cap["launches_backward"].values()),
          f"{label}: the backward pass launched key or intersect kernels: "
          f"{cap['launches_backward']}")
    st, st_e = cap["stats"], eag["stats"]
    blocks = st["blocks"]
    check(blocks == st_e["blocks"] > st["dispatches"]
          and st_e["fwd_graphs"] == st_e["bwd_graphs"] == 0, f"{label}: grad loop "
          f"stats {st} captured, {st_e} eager")
    for p in ("fwd", "bwd"):
        fresh = st["dispatches"] - st[f"{p}_pool_reuses"]
        check((st[f"{p}_graphs"] >= 1 if fresh else st[f"{p}_graphs"] == 0)
              and st[f"{p}_eager_blocks"] == fresh
              and st[f"{p}_replays"] == blocks - fresh
              and (blocks <= 2 or st[f"{p}_replays"] > 1),
              f"{label}: {p} graphs or replays missing: {st}")
    diffs, unrepro, again = {}, [], None
    for f in PARAM_FIELDS:
        a, b = getattr(eag["grads"], f), getattr(cap["grads"], f)
        diffs[f] = float((a - b).abs().max()) if a.numel() else 0.0
        if torch.equal(a, b):
            continue
        if again is None:
            again = timed_gradient(forward, eager=True)
        check(not torch.equal(a, getattr(again["grads"], f)),
              f"{label}: the captured {f} gradient differs from the eager one, "
              f"which reproduces itself (max {diffs[f]})")
        scale = float(a.abs().max())
        check(bool(((a - b).abs() <= 1e-6 + 1e-4 * scale).all()),
              f"{label}: the captured {f} gradient is outside the tolerance "
              f"(max {diffs[f]} against {scale})")
        unrepro.append(f)
    GRAD_FRAMES[label] = {
        "forward_s": cap["forward_s"], "backward_s": cap["backward_s"],
        "forward_s_eager": eag["forward_s"], "backward_s_eager": eag["backward_s"],
        "blocks": blocks, "dispatches": st["dispatches"],
        **{f"{p}_{k}": st[f"{p}_{k}"] for p in ("fwd", "bwd")
           for k in ("graphs", "replays")},
        "fwd_capture_ms": st["fwd_capture_s"] * 1e3,
        "bwd_capture_ms": st["bwd_capture_s"] * 1e3,
        "launches_forward": cap["launches_forward"],
        "launches_backward": sum(cap["launches_backward"].values()),
        "image_bit_equal": equal, "grad_max_abs_diff": diffs,
        "grad_bit_equal": not unrepro, "not_reproducible_eager": unrepro}
    return cap


def gradient_of(scene, opts, loss_fn, dev: str, render=None):
    """A timed_gradient() forward: d loss_fn(image) / d SceneParams at the
    scene's own parameters through ``render`` (render_image_stats with
    differentiable=True by default) on ``dev``."""
    from montecarlopathtracing_torch.diff import gradients as G
    from montecarlopathtracing_torch.integrator.wavefront import render_image_stats

    def forward():
        leaves = G.SceneParams.from_scene(scene).leaves(dev)
        sc = G.apply_params(scene, leaves)
        img, rays = (render(sc) if render is not None else render_image_stats(
            sc, None, opts, differentiable=True, device=dev))
        return img, rays, loss_fn(img), leaves

    return forward


def phase_grad(dev, state):
    """Phase grad (a)-(d), see the module docstring."""
    import dataclasses

    from montecarlopathtracing_torch.config import MODERN, RenderOptions
    from montecarlopathtracing_torch.diff import gradients as G
    from montecarlopathtracing_torch.scene.builtin import load_builtin_box

    # (a) the card against the CPU.
    opts = RenderOptions(spp=4, max_depth=8, compat=MODERN, ns_gradient=True)
    target = np.random.default_rng(5).uniform(0.1, 0.6, (64, 64, 3)).astype(np.float32)
    grads, secs = {}, {}
    box64, meta = load_builtin_box(width=64, height=64, with_specular=True,
                                   with_glass=True, device=dev)
    t0 = time.perf_counter()
    grads["cuda"] = hold_grad_graphs("grad_a", gradient_of(
        box64, opts, lambda img: torch.mean(
            (img - torch.as_tensor(target, device=dev)) ** 2), dev))["grads"]
    secs["cuda"] = time.perf_counter() - t0
    scene, _ = load_builtin_box(width=64, height=64, with_specular=True,
                                with_glass=True, device="cpu")
    t0 = time.perf_counter()
    _, grads["cpu"] = G.loss_and_grad(G.SceneParams.from_scene(scene), scene,
                                      None, opts, torch.as_tensor(target),
                                      device="cpu")
    secs["cpu"] = time.perf_counter() - t0
    check(grads_finite(grads["cuda"]), "grad (a): non-finite gradients on the card")
    errs, ok = grad_errors(grads["cpu"], grads["cuda"])
    check(ok, f"grad (a): card gradients differ from the CPU's: {errs}")
    emit({"phase": "grad_card_vs_cpu", "width": 64, "height": 64, "spp": 4,
          "max_depth": 8, "tolerance": "atol 1e-6 + 1e-4 x field max",
          "max_abs_err_and_scale": errs, "seconds_cuda_captured_and_eager":
          secs["cuda"], "seconds_cpu": secs["cpu"]})

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

    # (c) the full-width gradient: a warm-up, the timed gradient (both passes
    # replayed as CUDA graphs), then the same gradient under eager().
    scene, meta = load_builtin_box(width=1024, height=1024, device=dev)
    opts = RenderOptions(spp=16, max_depth=32, chunk_size=65536,
                         bwd_seg_per_sample=2.15)
    forward = gradient_of(scene, opts, torch.mean, dev)
    timed_gradient(forward)
    res = hold_grad_graphs("grad_c_full_width", forward, timed_gradient(forward))
    g, rays, fwd, bwd = (res["grads"], res["rays"], res["launches_forward"],
                         res["launches_backward"])
    t_fwd, t_bwd = res["forward_s"], res["backward_s"]
    check(rays > 0, f"grad (c): the budget truncated the render (n_rays {rays})")
    check(grads_finite(g), "grad (c): non-finite gradients")
    check(float(g.kd[meta.material_names.index("White"), 0]) > 0,
          "grad (c): the White kd gradient is not positive")
    check_launched(fwd, PATH_KERNELS["single"], "grad (c) forward")
    state["launches_grad_forward"], state["launches_grad_backward"] = fwd, bwd
    state["grad_c"] = g
    emit({"phase": "grad_full_width", "width": 1024, "height": 1024, "spp": 16,
          "max_depth": 32, "lanes": 65536, "bwd_seg_per_sample": 2.15,
          "rays": rays, "forward_seconds": t_fwd, "backward_seconds": t_bwd,
          "seconds": t_fwd + t_bwd, "fwd_bwd_rays_per_s": rays / (t_fwd + t_bwd),
          "backward_over_forward": t_bwd / t_fwd,
          "peak_bytes_over_baseline": res["peak_over_baseline"],
          "launches_forward": fwd, "launches_backward": bwd,
          "kd_grad_white": float(g.kd[meta.material_names.index("White"), 0]),
          "eager": {k: GRAD_FRAMES["grad_c_full_width"][k]
                    for k in ("forward_s_eager", "backward_s_eager")}})
    del g, res
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


def sync(dev: str) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def grad_large_plan(dev: str, large_mode: str, want_plan, path: str,
                    label: str):
    """A gradient of the 2k-triangle interior past lowered table budgets
    (tests/test_torch_large's), MODERN, 32 x 32, spp 2, max_depth 5,
    subtiles of 16 rays, under ``large_mode``, on ``dev`` (captured, held to
    the same gradient under eager(): hold_grad_graphs's ``label``) and on
    the CPU: (plan, {device: gradient}, {device: (forward, backward)
    launches})."""
    from montecarlopathtracing_torch.config import MODERN, RenderOptions
    from montecarlopathtracing_torch.diff import gradients as G
    from montecarlopathtracing_torch.integrator import wavefront as W
    from montecarlopathtracing_torch.kernels import cluster as K
    from montecarlopathtracing_torch.scene.builtin import load_builtin_large

    opts = RenderOptions(spp=2, max_depth=5, seed=11, cluster_width=4,
                         cluster_rays=16, sort_rays=True, compat=MODERN,
                         large_mode=large_mode)
    target = np.random.default_rng(6).uniform(0.1, 0.6, (32, 32, 3)).astype(
        np.float32)
    saved = W._VMEM_TABLE_BUDGET, W._VMEM_CHUNK_BUDGET
    W._VMEM_TABLE_BUDGET, W._VMEM_CHUNK_BUDGET = 64 << 10, 48 << 10
    grads, launches = {}, {}
    try:
        for name in (dev, "cpu"):
            scene, _ = load_builtin_large(n_tris=2000, options=opts, width=32,
                                          height=32, n_textures=1, device=name)
            plan = W.resolve_plan(opts, scene.num_tris_padded)
            check(plan == want_plan,
                  f"{path}: expected the plan {want_plan}, got {plan}")
            if name == dev:
                res = hold_grad_graphs(label, gradient_of(
                    scene, opts, lambda img: torch.mean(
                        (img - torch.as_tensor(target, device=dev)) ** 2), dev))
                grads[name], rays = res["grads"], res["rays"]
                launches[name] = (res["launches_forward"], res["launches_backward"])
                check(rays > 0, f"{path}: the budget truncated the render on "
                                f"{name} (n_rays {rays})")
                continue
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
            check(int(rays) > 0, f"{path}: the budget truncated the render "
                                 f"on {name} (n_rays {int(rays)})")
    finally:
        W._VMEM_TABLE_BUDGET, W._VMEM_CHUNK_BUDGET = saved
    return plan, grads, launches


def check_grad_card_vs_cpu(grads, launches, dev: str, kernels, path: str):
    """The path's kernels launched in the forward pass and no key or
    intersect kernel in the backward pass; finite gradients on the card
    within grad (a)'s tolerance of the CPU's.  Returns the errors."""
    fwd, bwd = launches[dev]
    check_launched(fwd, kernels, f"{path} forward")
    check(all(v == 0 for v in bwd.values()),
          f"{path}: the backward pass launched key or intersect kernels: {bwd}")
    check(grads_finite(grads[dev]), f"{path}: non-finite gradients on the card")
    errs, ok = grad_errors(grads["cpu"], grads[dev])
    check(ok, f"{path}: card gradients differ from the CPU's: {errs}")
    check(float(grads[dev].kd.abs().max()) > 0, f"{path}: zero kd gradient")
    return errs


def phase_grad_chunked(dev, state):
    """Phase grad (e): a gradient through the chunked plan on the card
    against the CPU.  The table budgets are lowered as tests/test_torch_large
    lowers them, so the 2k-triangle interior (2,048 padded triangles) is past
    the single-table budget and cut into 3 chunks; MODERN, 32 x 32, spp 2,
    max_depth 5, subtiles of 16 rays.  Keys and intersect are counted in the
    forward pass (rows 3 and 4, > 0) and in the backward pass (0)."""
    plan, grads, launches = grad_large_plan(dev, "hbm", ("cluster", 128, 1, 3),
                                            "grad (e)", "grad_e_chunked")
    errs = check_grad_card_vs_cpu(grads, launches, dev, PATH_KERNELS["chunked"],
                                  "grad (e)")
    fwd, bwd = launches[dev]
    emit({"phase": "grad_chunked_card_vs_cpu", "width": 32, "height": 32,
          "spp": 2, "max_depth": 5, "plan": list(plan),
          "tolerance": "atol 1e-6 + 1e-4 x field max",
          "max_abs_err_and_scale": errs, "launches_forward": fwd,
          "launches_backward": bwd})


def phase_grad_hbm(dev):
    """Phase grad (g): grad (e)'s scene, budgets and loss under
    large_mode="hbm_always", the supergroup plan: rows 1 and 5 launched in
    the forward pass, none in the backward pass, the card within grad (a)'s
    tolerance of the CPU."""
    t0 = time.perf_counter()
    plan, grads, launches = grad_large_plan(dev, "hbm_always",
                                            ("cluster_hbm", 128, 1, 1), "grad (g)",
                                            "grad_g_hbm")
    errs = check_grad_card_vs_cpu(grads, launches, dev, PATH_KERNELS["hbm"],
                                  "grad (g)")
    fwd, bwd = launches[dev]
    emit({"phase": "grad_hbm_card_vs_cpu", "width": 32, "height": 32,
          "spp": 2, "max_depth": 5, "plan": list(plan),
          "tolerance": "atol 1e-6 + 1e-4 x field max",
          "max_abs_err_and_scale": errs, "launches_forward": fwd,
          "launches_backward": bwd, "seconds": time.perf_counter() - t0})


# The scan renderer's frames (refill=False): the full-width configurations
# and the size of their bit-for-bit checks against eager().
SCAN_BOX = dict(spp=16, max_depth=32, chunk_size=65536, spp_chunk=16)
SCAN_CHECK = 256  # one chunk of 65,536 lanes


def scan_counted(fn, eager: bool = False):
    """counted() with the scan renderer's stats (wavefront.scan_stats) in
    place of the lane pool's."""
    from montecarlopathtracing_torch.integrator import wavefront as W

    return counted(fn, eager)[:4] + (W.scan_stats(),)


def scan_record(st, secs: float, rays) -> dict:
    return {"seconds": secs, "rays": float(rays),
            "rays_per_s": float(rays) / secs,
            **{k: st[k] for k in ("calls", "samples", "bounces", "idle_bounces")},
            **{f"{p}_{k}": st[f"{p}_{k}"] for p in ("fwd", "bwd")
               for k in ("eager_blocks", "graphs", "replays")},
            "fwd_capture_ms": st["fwd_capture_s"] * 1e3,
            "bwd_capture_ms": st["bwd_capture_s"] * 1e3}


def hold_scan(label: str, captured, eager, passes=("fwd",)) -> dict:
    """A scan-renderer render with its blocks replayed as CUDA graphs
    (``captured``) against the same render under wavefront.eager() (each a
    scan_counted() result, or timed_scan_gradient()'s (image, rays,
    seconds, forward launches, stats)): the image bit for bit, the same
    rays, launches, bounces and idle bounces; one set of graphs (one frame)
    that captured every kind of block after its first op-by-op run and
    replayed every later block of each pass."""
    img, rays, secs, launches, st = captured
    img_e, rays_e, secs_e, launches_e, st_e = eager
    equal = bool(torch.equal(img, img_e))
    check(equal, f"{label}: the captured frame differs from the eager one")
    check(float(rays) == float(rays_e),
          f"{label}: rays {float(rays)} captured, {float(rays_e)} eager")
    check(launches == launches_e, f"{label}: launches {launches} captured, "
                                   f"{launches_e} eager")
    for p in passes:
        blocks = st_e[f"{p}_eager_blocks"]
        check(st["frames"] == st_e["frames"] == 1
              and st["bounces"] == st_e["bounces"]
              and st["idle_bounces"] == st_e["idle_bounces"]
              and st_e[f"{p}_graphs"] == 0 and st[f"{p}_graphs"] >= 1
              and st[f"{p}_eager_blocks"] + st[f"{p}_replays"] == blocks
              and st[f"{p}_replays"] > st[f"{p}_graphs"],
              f"{label}: scan stats {st} captured, {st_e} eager")
    return {"seconds_captured": secs, "seconds_eager": secs_e,
            "bit_equal": equal, **scan_record(st, secs, rays)}


def timed_scan_gradient(forward, eager: bool = False):
    """timed_gradient() of a scan-renderer gradient, as hold_scan takes it
    (image, rays, forward + backward seconds, launches of both passes,
    scan_stats), and the whole timed_gradient() result."""
    res = timed_gradient(forward, eager)
    return ((res["img"], res["rays"], res["forward_s"] + res["backward_s"],
             (res["launches_forward"], res["launches_backward"]),
             res["scan_stats"]), res)


def scan_cpu_check(img, scene, opts, n_ids: int, label: str) -> dict:
    """bench_torch.py's check: ``n_ids`` pixel ids chosen from its seed,
    the card's frame there against the port's CPU render of them, at the
    image limit."""
    from bench_torch import check_ids, cpu_pixels

    t0 = time.perf_counter()
    ids = check_ids(scene.camera.height, scene.camera.width, n_ids, 0)
    got = img.reshape(-1, 3)[torch.as_tensor(ids, device=img.device)].cpu()
    res = image_agreement(cpu_pixels(scene, opts, ids), got, label)
    return {**res, "ids": len(ids), "seconds": time.perf_counter() - t0}


# A scan gradient holds one sample's residuals at a time: ~72 MB at 65,536
# lanes with one light, plus the graphs' pool (~0.3 GB on the box).
SCAN_GRAD_PEAK_LIMIT = 1 << 30
# The lane pool's segments a sample budgeted in the interior's gradient: past
# what its paths need (they end within a few bounces), so no sample is dropped.
LARGE400_SEG = 4.0
# How many of bench_torch.py's pixel ids the scan frames and the interior's
# scan gradient are held to the CPU at.  The CPU's plain versions set the
# time: on an H100 machine's host the box frame took 28-34 s at 65,536 ids,
# the interior frame 43-57 s at 8,192 and its gradient 411 s at 8,192 (32
# bounces in both passes).
SCAN_CPU_IDS = {"box": 16384, "400k": 4096, "400k_grad": 512}


def check_scan_backward_launches(launches, kernels, label: str) -> None:
    """A scan gradient's (forward, backward) launches: the path's kernels
    in forward, and backward, which recomputes every sample, launching each
    kernel exactly as often as forward did."""
    fwd, bwd = launches
    check_launched(fwd, kernels, f"{label} forward")
    check(bwd == fwd, f"{label}: backward launches {bwd}, forward {fwd}")


def backward_calls(forward, name: str):
    """The gradient ``forward()`` (a gradient_of() forward) under
    wavefront.eager() (a replay runs no Python), and the intersect calls
    (``name``, as CaptureCall takes it) of its backward pass."""
    from montecarlopathtracing_torch.diff import gradients as G
    from montecarlopathtracing_torch.integrator import wavefront as W

    with W.eager():
        _, _, loss, leaves = forward()
        with CaptureCall(name) as cap:
            grads = G.param_grads(loss, leaves)
    check(len(cap.calls) > 0, f"no {name} call in the backward pass")
    return grads, cap.calls


def scan_grad_memory(dev) -> dict:
    """box-256-scan-grad-memory: the scan gradient of the 256 x 256 box (one
    chunk of 65,536 lanes, SCAN_BOX's options), d mean(image), at spp 2 and
    at spp 16.  The backward pass holds one sample's residual copies at a
    time, so the two peaks over the baseline must differ by less than one
    sample's residual bytes."""
    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.scene.builtin import load_builtin_box

    box, _ = load_builtin_box(width=SCAN_CHECK, height=SCAN_CHECK, device=dev)
    out = {}
    for spp in (2, 16):
        opts = RenderOptions(refill=False, **{**SCAN_BOX, "spp": spp,
                                              "spp_chunk": spp})
        res = timed_gradient(gradient_of(box, opts, torch.mean, dev))
        label = f"scan grad memory spp {spp}"
        check(res["rays"] > 0 and grads_finite(res["grads"]),
              f"{label}: no rays or non-finite gradients")
        check_scan_backward_launches(
            (res["launches_forward"], res["launches_backward"]),
            PATH_KERNELS["single"], label)
        out[f"spp{spp}"] = {
            "forward_s": res["forward_s"], "backward_s": res["backward_s"],
            "peak_bytes_over_baseline": res["peak_over_baseline"],
            "residual_bytes": res["scan_stats"]["residual_bytes"]}
        del res
        torch.cuda.empty_cache()
    one = out["spp16"]["residual_bytes"]
    grew = (out["spp16"]["peak_bytes_over_baseline"]
            - out["spp2"]["peak_bytes_over_baseline"])
    check(one == out["spp2"]["residual_bytes"] > 0 and abs(grew) < one,
          f"scan grad memory: the peak grew by {grew} B from spp 2 to spp 16, "
          f"one sample's residuals are {one} B: {out}")
    out["peak_growth_bytes"] = grew
    return out


def scan_grad_400k(dev, scene, opts) -> dict:
    """interior-400k-720p-spp4-scan-grad and interior-400k-720p-spp4-grad:
    the scan renderer's and the lane pool's gradients of the 400k interior
    at full width, d mean(image) / d SceneParams, each once, captured (see
    the module docstring)."""
    from bench_torch import check_ids

    from montecarlopathtracing_torch.diff import gradients as G
    from montecarlopathtracing_torch.integrator import wavefront as W

    kernels = PATH_KERNELS["chunked"]
    # The scan frame through render_image_stats, which the gradient takes.
    img, rays = scan_counted(lambda: W.render_image_stats(
        scene, None, opts, device=dev))[:2]
    (gimg, grays, _, (lf, lb), gst), res = timed_scan_gradient(
        gradient_of(scene, opts, torch.mean, dev))
    check(bool(torch.equal(gimg, img)) and float(grays) == float(rays),
          "scan grad 400k: the gradient's image or rays differ from the scan "
          "frame")
    check_scan_backward_launches((lf, lb), kernels, "scan grad 400k")
    check(grads_finite(res["grads"]), "scan grad 400k: non-finite gradients")
    scan = {"forward_s": res["forward_s"], "backward_s": res["backward_s"],
            "peak_bytes_over_baseline": res["peak_over_baseline"],
            "residual_bytes": gst["residual_bytes"],
            **scan_record(gst, res["forward_s"] + res["backward_s"], grays),
            "launches_forward": lf, "launches_backward": lb,
            "image_bit_equal_forward": True}
    scan_grads = res["grads"]
    del img, gimg, res
    torch.cuda.empty_cache()

    # The lane pool's gradient of the same scene, options and loss.
    po = opts.replace(refill=True, bwd_seg_per_sample=LARGE400_SEG)
    frame = counted(lambda: W.render_image_stats(scene, None, po, device=dev))[0]
    res = timed_gradient(gradient_of(scene, po, torch.mean, dev))
    lf, lb = res["launches_forward"], res["launches_backward"]
    check(res["rays"] > 0, f"grad 400k: the budget dropped samples (n_rays "
                           f"{res['rays']})")
    check(bool(torch.allclose(res["img"], frame, rtol=1e-4, atol=1e-5)),
          "grad 400k: the gradient's image differs from the lane pool's frame "
          "beyond rtol 1e-4 / atol 1e-5")
    check_launched(lf, kernels, "grad 400k forward")
    check(not any(lb.values()), f"grad 400k: the backward pass launched {lb}")
    check(grads_finite(res["grads"]), "grad 400k: non-finite gradients")
    errs, ok = grad_errors(res["grads"], scan_grads)
    check(ok, f"scan grad 400k: the gradient differs from the lane pool's: "
              f"{errs}")
    st = res["stats"]
    pool = {"forward_s": res["forward_s"], "backward_s": res["backward_s"],
            "peak_bytes_over_baseline": res["peak_over_baseline"],
            "rays": res["rays"], "bwd_seg_per_sample": LARGE400_SEG,
            "blocks": st["blocks"], "launches_forward": lf,
            "launches_backward": lb,
            "image_max_abs_diff_frame": float((res["img"] - frame).abs().max())}
    scan["vs_lane_pool"] = errs
    del frame, res
    torch.cuda.empty_cache()

    # The card (op by op, its backward's calls recorded and held against
    # the plain versions) against the CPU at bench_torch.py's pixel ids.
    ids = check_ids(scene.camera.height, scene.camera.width,
                    SCAN_CPU_IDS["400k_grad"], 0)
    grads, secs = {}, {}
    for name in (dev, "cpu"):
        sc = scene if name == dev else scene.to("cpu")
        pix = torch.as_tensor(np.asarray(ids, np.int32), device=name)

        def forward():
            leaves = G.SceneParams.from_scene(sc).leaves(name)
            rad, n = W.render_pixels(G.apply_params(sc, leaves), None, opts,
                                     pix, differentiable=True)
            return rad, n, rad.mean(), leaves

        t0 = time.perf_counter()
        if name == dev:
            grads[name], calls = backward_calls(forward,
                                                "cluster_intersect_chunked")
        else:
            _, _, loss, leaves = forward()
            grads[name] = G.param_grads(loss, leaves)
        sync(name)
        secs[name] = time.perf_counter() - t0
    check(grads_finite(grads[dev]), "scan grad 400k: non-finite gradients at "
                                    "the check ids")
    errs, ok = grad_errors(grads["cpu"], grads[dev])
    check(ok, f"scan grad 400k: card gradients differ from the CPU's: {errs}")
    ftb_frame_stats(calls, chunked_call, 64, "scan_grad_400k_backward", kernels)
    scan["card_vs_cpu"] = {"ids": len(ids), "max_abs_err_and_scale": errs,
                           "seconds": secs, "backward_calls_held": len(calls)}
    return {"interior-400k-720p-spp4-scan-grad": scan,
            "interior-400k-720p-spp4-grad": pool}


def phase_scan_graphs(dev, state):
    """The scan renderer's frames with CUDA graphs (the scan_graphs line,
    see the module docstring)."""
    from montecarlopathtracing_torch.config import MODERN, RenderOptions
    from montecarlopathtracing_torch.diff import gradients as G
    from montecarlopathtracing_torch.integrator import wavefront as W
    from montecarlopathtracing_torch.scene.builtin import load_builtin_box

    t_phase = time.perf_counter()
    out = {}
    # box-1024-spp16-scan: the check size (render_image, then
    # render_image_host_chunked in two spp steps) captured against eager().
    opts = RenderOptions(refill=False, **SCAN_BOX)
    small, _ = load_builtin_box(width=SCAN_CHECK, height=SCAN_CHECK, device=dev)
    o4 = opts.replace(spp=4, spp_chunk=2)
    box = {"check_render_image": hold_scan("scan box check", *(scan_counted(
        lambda: W.render_image_stats(small, None, o4, device=dev), eager=e)
        for e in (False, True))),
           "check_host_chunked": hold_scan("scan box check chunked", *(
               scan_counted(lambda: W.render_image_host_chunked(
                   small, None, o4, device=dev), eager=e) for e in (False, True)))}
    del small
    # The full-width frame, captured; the lane pool's frame of the same
    # options; the CPU at bench_torch.py's pixel ids.
    big, meta = load_builtin_box(width=1024, height=1024, device=dev)
    img, rays, secs, launches, st = scan_counted(
        lambda: W.render_image_stats(big, None, opts, device=dev))
    check_launched(launches, PATH_KERNELS["single"], "scan box")
    image_checks(img, "scan box")
    pool, pool_rays, pool_secs = counted(lambda: W.render_image_stats(
        big, None, opts.replace(refill=True), device=dev))[:3]
    check(float(rays) == float(pool_rays),
          f"scan box: rays {float(rays)}, lane pool {float(pool_rays)}")
    check(bool(torch.allclose(img, pool, rtol=1e-4, atol=1e-5)),
          "scan box: the frame differs from the lane pool's beyond rtol 1e-4 "
          "/ atol 1e-5")
    box.update(full=scan_record(st, secs, rays), launches=launches,
               lane_pool={"seconds": pool_secs,
                          "max_abs_diff": float((img - pool).abs().max())},
               cpu=scan_cpu_check(img, big, opts, SCAN_CPU_IDS["box"],
                                  "scan box"))
    out["box-1024-spp16-scan"] = box

    # box-1024-spp16-scan-grad.  The check size: d mean((image -
    # target)^2) / d SceneParams (image_loss, what loss_and_grad takes) on
    # the 256 x 256 MODERN spec+glass box, spp 2, captured against eager(),
    # loss_and_grad itself captured against the same, and the card against
    # the CPU (grad (a)'s tolerance).
    go = RenderOptions(refill=False, spp=2, max_depth=32, chunk_size=65536,
                       compat=MODERN, ns_gradient=True)
    target = torch.as_tensor(np.random.default_rng(5).uniform(
        0.1, 0.6, (SCAN_CHECK, SCAN_CHECK, 3)).astype(np.float32))
    grads, grad = {}, {}
    for name in (dev, "cpu"):
        sg, _ = load_builtin_box(width=SCAN_CHECK, height=SCAN_CHECK,
                                 with_specular=True, with_glass=True, device=name)
        W.reset_loop_stats()
        t0 = time.perf_counter()
        _, grads[name] = G.loss_and_grad(G.SceneParams.from_scene(sg), sg, None,
                                         go, target, device=name)
        sync(name)
        grad[f"loss_and_grad_seconds_{name}"] = time.perf_counter() - t0
        if name != dev:
            continue
        st = W.scan_stats()
        check(st["fwd_replays"] > 0 and st["bwd_replays"] > 0,
              f"scan grad: loss_and_grad replayed no graph: {st}")
        forward = gradient_of(sg, go, lambda im: torch.mean(
            (im - target.to(dev)) ** 2), dev)
        (cap, cap_full), (eag, eag_full) = (timed_scan_gradient(forward, e)
                                            for e in (False, True))
        grad["check"] = hold_scan("scan grad check", cap, eag, ("fwd", "bwd"))
        check_scan_backward_launches(cap[3], PATH_KERNELS["single"],
                                     "scan grad check")
        calls = backward_calls(forward, "cluster_intersect")[1]
        frame_kernel_stats(calls, 64, "scan_grad_check_backward")
        grad["check"]["backward_calls_held"] = len(calls)
        del calls
        same = {}
        for f in G.PARAM_FIELDS:
            a, b, c = (getattr(g, f) for g in (cap_full["grads"],
                                               eag_full["grads"], grads[dev]))
            same[f] = bool(torch.equal(a, b)) and bool(torch.equal(a, c))
        check(all(same.values()), f"scan grad check: the captured gradient, "
                                  f"the eager one and loss_and_grad's differ: {same}")
        grad["check"].update(
            forward_s=cap_full["forward_s"], backward_s=cap_full["backward_s"],
            forward_s_eager=eag_full["forward_s"],
            backward_s_eager=eag_full["backward_s"], grad_bit_equal=same)
        del sg, cap, eag, cap_full, eag_full
    check(grads_finite(grads[dev]), "scan grad: non-finite gradients on the card")
    errs, ok = grad_errors(grads["cpu"], grads[dev])
    check(ok, f"scan grad: card gradients differ from the CPU's: {errs}")
    grad["card_vs_cpu"] = errs
    # The full-width gradient, once, captured: d mean(image) / d SceneParams
    # (grad (c)'s loss), its image bit for bit the scan frame above, the
    # gradient within grad (a)'s tolerance of grad (c)'s (the lane pool).
    (gimg, grays, gsecs, (lf, lb), gst), res = timed_scan_gradient(
        gradient_of(big, opts, torch.mean, dev))
    check(bool(torch.equal(gimg, img)) and float(grays) == float(rays),
          "scan grad: the gradient's image or rays differ from the scan frame")
    check_scan_backward_launches((lf, lb), PATH_KERNELS["single"], "scan grad")
    check(res["peak_over_baseline"] < SCAN_GRAD_PEAK_LIMIT,
          f"scan grad: {res['peak_over_baseline']} B over the baseline, not "
          f"under {SCAN_GRAD_PEAK_LIMIT}")
    check(grads_finite(res["grads"]), "scan grad: non-finite gradients")
    errs, ok = grad_errors(state["grad_c"], res["grads"])
    check(ok, f"scan grad: the gradient differs from the lane pool's (grad "
              f"(c)): {errs}")
    grad.update(full={**scan_record(gst, gsecs, grays),
                      "forward_s": res["forward_s"], "backward_s": res["backward_s"],
                      "peak_bytes_over_baseline": res["peak_over_baseline"],
                      "residual_bytes": gst["residual_bytes"],
                      "launches_forward": lf, "launches_backward": lb,
                      "image_bit_equal_forward": True},
                vs_lane_pool_grad_c=errs)
    out["box-1024-spp16-scan-grad"] = grad
    del big, img, pool, gimg, res
    torch.cuda.empty_cache()
    out["box-256-scan-grad-memory"] = scan_grad_memory(dev)

    # interior-400k-720p-spp4-scan (chunked plan): the check size is one
    # chunk of the frame's pixel ids through render_pixels.
    scene = state["large400"]
    lo = RenderOptions(refill=False, spp=4, spp_chunk=4)
    ids = W._frame_ids(scene, lo)[0][:65536]
    large = {"check_render_pixels": hold_scan("scan 400k check", *(scan_counted(
        lambda: W.render_pixels(scene, None, lo, ids), eager=e)
        for e in (False, True)))}
    img, rays, secs, launches, st = scan_counted(
        lambda: W.render_image_host_chunked(scene, None, lo, device=dev))
    check_launched(launches, PATH_KERNELS["chunked"], "scan 400k")
    image_checks(img, "scan 400k")
    large.update(full=scan_record(st, secs, rays), launches=launches,
                 cpu=scan_cpu_check(img, scene, lo, SCAN_CPU_IDS["400k"],
                                    "scan 400k"))
    out["interior-400k-720p-spp4-scan"] = large
    del img
    out.update(scan_grad_400k(dev, scene, lo))
    emit({"phase": "scan_graphs", "block_bounces": W._SCAN_BLOCK,
          "frames": out, "seconds": time.perf_counter() - t_phase})


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
    # Same tolerance as the CPU parity test against the JAX package (paths
    # may diverge at an edge).
    emit({"phase": "parity", "width": 64, "height": 64, "spp": 4,
          "rays_cuda": out["cuda"][1], "rays_cpu": out["cpu"][1],
          **image_agreement(torch.as_tensor(out["cpu"][0]),
                            torch.as_tensor(out["cuda"][0]), "parity")})


# ---------------------------------------------------------------------------
# The LBVH walks, the oracle, the native loader, two ranks, the profiler.
# ---------------------------------------------------------------------------

# f32 operations of one (ray, node) slab test and one (ray, triangle) test
# of ops/intersect.py (walk_common.cuh): 6 subtractions, 6 products, 4 max /
# min and 3 compares; compat 87 (3 dot products of cross products, the plane
# solve, the hit point, sign products), Moller-Trumbore 56.
OPS_SLAB = 19
OPS_TRI_WALK = {False: 87, True: 56}
# Every how-many-th recorded call of a walk frame the plain walk replays on a
# slice of its rays (per-ray walk) or whole packets (packet walk); and how
# many calls of each frame both walks replay whole, timed.
WALK_SAMPLE_CALLS = 16
WALK_FULL_CALLS = 4
WALK_SUBSET_RAYS = 4096
WALK_SUBSET_PACKETS = 4
WALK_KERNELS = {"bvh_perray": "bvh_walk", "bvh": "packet_walk"}


class WalkCapture:
    """Records the inputs of every call the wavefront makes to one walk
    (by its name in the integrator module); calls pass through."""

    def __init__(self, name: str):
        from montecarlopathtracing_torch.integrator import wavefront

        self.module, self.name, self.calls = wavefront, name, []
        self.inner = getattr(wavefront, name)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)

    def __call__(self, bvh, scene, origin, direction, **kw):
        self.calls.append((bvh, scene, origin, direction, kw))
        return self.inner(bvh, scene, origin, direction, **kw)


def walk_fns(kind):
    """(kernel wrapper, plain version) of a walk intersector kind."""
    from montecarlopathtracing_torch.accel import lbvh as L

    if kind == "bvh_perray":
        return L.bvh_intersect, L.bvh_intersect_plain
    return L.packet_intersect, L.packet_intersect_plain


def results_equal(a, b) -> bool:
    """hit, t bits and tri all equal."""
    return (torch.equal(a[0], b[0]) and torch.equal(a[2], b[2])
            and torch.equal(a[1].view(torch.int32), b[1].view(torch.int32)))


def walk_bound(bvh, rays_n: int, counts: dict, mt: bool):
    """(bytes, ops) a walk must move and do on one call: rays, nodes and
    triangles read once, (t, tri) written once; the slab and triangle tests
    that the nearest hit of this call's rays needs, as the per-ray plain walk
    counts them on the same rays (both walks compute the same function; the
    packet walk's own tests, every ray of a packet at every node the packet
    visits, are its algorithm's cost and not the function's)."""
    lc = bvh.num_leaves
    n_bytes = rays_n * 24 + 2 * lc * 24 + lc * 49 + rays_n * 8
    n_ops = (OPS_SLAB * counts["node_tests"]
             + OPS_TRI_WALK[mt] * counts["tri_tests"])
    return n_bytes, n_ops


def walk_frame_stats(calls, kind: str, label: str):
    """Replay a walk frame's recorded calls: every WALK_SAMPLE_CALLS-th call
    with the kernel on the whole call (timed) against the plain walk on a
    slice of it (the per-ray walk on WALK_SUBSET_RAYS rays, the packet walk
    on WALK_SUBSET_PACKETS whole packets: a packet's result depends on its
    mates), and WALK_FULL_CALLS calls whole with both (timed, exact), the
    bound taken from the per-ray plain walk's tests on the same call.  For
    the packet walk its own plain version's tests are kept beside them."""
    from montecarlopathtracing_torch.accel import lbvh as L

    kernel, plain = walk_fns(kind)
    sleep = sleep_ms()
    full_idx = set(np.linspace(0, len(calls) - 1, WALK_FULL_CALLS).astype(int).tolist())
    step = max(1, len(calls) // WALK_SAMPLE_CALLS)
    sampled, full = [], []
    for i, (bvh, scene, o, d, kw) in enumerate(calls):
        if i % step and i not in full_idx:
            continue
        mt = not kw.get("compat", True)
        ms, late, got = timed(lambda: kernel(bvh, scene, o, d, **kw), sleep,
                              warm=True)
        if kind == "bvh":
            p = min(kw.get("packet_size", 1024), o.shape[0])
            sl = slice(0, min(o.shape[0], WALK_SUBSET_PACKETS * p))
        else:
            sl = slice(0, min(o.shape[0], WALK_SUBSET_RAYS))
        part = plain(bvh, scene, o[sl], d[sl], **kw)
        check(results_equal(part, tuple(x[sl] for x in got)),
              f"{label}: {kind} kernel differs from its plain version on "
              f"call {i} (slice of {sl.stop} rays)")
        sampled.append(ms)
        if i in full_idx:
            counts = {}
            pm, _, want = timed(lambda: plain(bvh, scene, o, d, counts=counts, **kw),
                                sleep)
            check(results_equal(got, want),
                  f"{label}: {kind} kernel differs from its plain version on "
                  f"the whole call {i}")
            own = counts
            if kind == "bvh":
                counts = {}
                L.bvh_intersect_plain(bvh, scene, o, d, compat=not mt,
                                      counts=counts)
            n_bytes, n_ops = walk_bound(bvh, o.shape[0], counts, mt)
            _, own_ops = walk_bound(bvh, o.shape[0], own, mt)
            full.append({"ms": ms, "plain_ms": pm, "late": late,
                         "bytes": n_bytes, "ops": n_ops,
                         "bound_own_tests_ms": bound_of(n_bytes, own_ops)[0],
                         "node_tests": counts["node_tests"],
                         "tri_tests": counts["tri_tests"],
                         "own_node_tests": own["node_tests"],
                         "own_tri_tests": own["tri_tests"],
                         "rays": int(o.shape[0])})
    agg = aggregate(full)
    n_rays = sum(r["rays"] for r in full)
    agg.update(ms_sampled_mean=sum(sampled) / len(sampled),
               calls_sampled=len(sampled), calls_recorded=len(calls),
               node_tests_per_ray=sum(r["node_tests"] for r in full) / n_rays,
               tri_tests_per_ray=sum(r["tri_tests"] for r in full) / n_rays)
    if kind == "bvh":
        agg.update(
            own_node_tests_per_ray=sum(r["own_node_tests"] for r in full) / n_rays,
            own_tri_tests_per_ray=sum(r["own_tri_tests"] for r in full) / n_rays,
            bound_own_tests_ms=sum(r["bound_own_tests_ms"] for r in full)
            / len(full))
    emit({"phase": "walk_kernel_time", "case": label, "kernel": WALK_KERNELS[kind],
          "sleep_ms": sleep, **agg})
    return agg


# SceneArrays' fields with one row per triangle slot.
TRI_FIELDS = ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "geom_n",
              "mat_id", "tri_valid")


def doubled_scene(scene):
    """``scene`` with every triangle slot repeated after the first copy
    (its records made anew by SceneArrays.tri_records): each hit ties at
    equal t with its copy in a later fat leaf, and the first in preorder
    (the lower id) must win."""
    import dataclasses

    return dataclasses.replace(scene, **{
        f: torch.cat([getattr(scene, f)] * 2).contiguous() for f in TRI_FIELDS})


def nan_vertex_scene(scene):
    """``scene`` with one valid triangle's vertex NaN (its records made
    anew by SceneArrays.tri_records): NaN boxes from that leaf to the root,
    so a walk kernel must take its NaN-propagating slab test throughout."""
    import dataclasses

    v0 = scene.v0.clone()
    v0[int(torch.nonzero(scene.tri_valid)[3, 0]), 1] = float("nan")
    return dataclasses.replace(scene, v0=v0)


def far_apart_pairs(bvh, scene, rng, n_pairs: int = 16, depth: int = 6):
    """Two-ray packets [b, a] from one origin: b aimed at a triangle inside
    a depth-``depth`` node's subtree, a at a triangle outside it whose ray
    misses that node's box (host slab test), so the packet enters the node
    for b while a's test fails there, and a meets its own fat leaf later."""
    nmin, nmax = bvh.node_min.cpu().numpy(), bvh.node_max.cpu().numpy()
    valid = scene.tri_valid.cpu().numpy()
    cen = ((scene.v0 + scene.v1 + scene.v2) / 3).cpu().numpy()
    lc = bvh.num_leaves
    span = lc >> depth
    o, d = [], []
    origin = np.array([1.5, 1.5, 1.5], np.float32)
    for _ in range(4000):
        if len(o) >= 2 * n_pairs:
            break
        node = int(rng.integers(1 << depth, 2 << depth))
        first = node * span - lc
        tb = first + int(rng.integers(0, span))
        ta = int(rng.integers(0, lc))
        if not (valid[tb] and valid[ta]) or first <= ta < first + span:
            continue
        da = cen[ta] - origin
        da = da / np.linalg.norm(da)
        with np.errstate(divide="ignore", invalid="ignore"):
            t0 = (nmin[node] - origin) / da
            t1 = (nmax[node] - origin) / da
        enter = np.nanmax(np.minimum(t0, t1))
        leave = np.nanmin(np.maximum(t0, t1))
        if enter <= leave and leave >= 0:
            continue  # a would enter the node too
        db = cen[tb] - origin
        o += [origin, origin]
        d += [db / np.linalg.norm(db), da]
    return np.asarray(o, np.float32), np.asarray(d, np.float32)


def packet_adversarial(dev, box, large, rng, build: str):
    """The packet walk kernel against its plain version, compat and MT, on
    the cases a parallel leaf and several rays per thread could break:
    equal-t ties inside one fat leaf (rays straight down onto the box
    floor's diagonal: its two triangles share a leaf) and across fat leaves
    (the same rays with leaf_width 1, and the box with every triangle
    doubled); two-ray packets whose second ray misses a node the first
    enters and then hits its own leaf; a small explicit max_steps; and
    packet_size / leaf_width off their defaults, among them widths of no
    power of two and past 32 (the kernel's other leaf paths); and a tree
    with NaN boxes (one NaN vertex), where no warp may take the fmaxf slab
    test."""
    from montecarlopathtracing_torch.accel import lbvh as L

    t = rng.uniform(1.65, 1.95, (64, 1)).astype(np.float32)
    diag_o = np.concatenate([t, np.full_like(t, 1.5), t], axis=1)
    diag_d = np.tile(np.float32([0.0, -1.0, 0.0]), (64, 1))
    diag_d[32:, 0] = -0.0
    n = 4099
    ro = rng.uniform(0.1, 1.9, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    lo = rng.uniform(0.1, 2.9, (n, 3)).astype(np.float32)
    ld = rng.normal(size=(n, 3)).astype(np.float32)
    ld /= np.linalg.norm(ld, axis=1, keepdims=True)
    dbl = doubled_scene(box)
    nan_box = nan_vertex_scene(box)
    bvh_box, bvh_dbl, bvh_large, bvh_nan = (
        L.build_lbvh(sc) for sc in (box, dbl, large, nan_box))
    check(not bvh_nan.finite, "packet adversarial: the NaN box's tree is finite")
    pair_o, pair_d = far_apart_pairs(bvh_large, large, rng)
    check(len(pair_o) >= 8, f"packet adversarial: only {len(pair_o) // 2} "
                            "far-apart pairs found")
    co, cd = camera_and_shadow_rays(
        large, min(8192, large.camera.width * large.camera.height), seed=43)
    cases = [("tie_in_leaf", bvh_box, box, diag_o, diag_d, {"packet_size": 32}),
             ("tie_across_leaves", bvh_box, box, diag_o, diag_d,
              {"packet_size": 32, "leaf_width": 1}),
             ("doubled_box", bvh_dbl, dbl, ro, rd, {}),
             ("doubled_box_lw4", bvh_dbl, dbl, ro, rd, {"packet_size": 128,
                                                       "leaf_width": 4}),
             ("doubled_box_lw6", bvh_dbl, dbl, ro, rd, {"packet_size": 64,
                                                       "leaf_width": 6}),
             ("box_lw3", bvh_box, box, ro, rd, {"packet_size": 100,
                                               "leaf_width": 3}),
             ("nan_tree", bvh_nan, nan_box, ro, rd, {"packet_size": 128,
                                                     "leaf_width": 1}),
             ("far_apart_pairs", bvh_large, large, pair_o, pair_d, {"packet_size": 2})]
    for steps in (1, 7, 50):
        cases.append((f"max_steps_{steps}", bvh_large, large, co, cd,
                      {"max_steps": steps}))
    for ps, lw in ((16, 1), (48, 2), (64, 8), (100, 3), (1024, 16), (256, 64),
                   (1, 8)):
        cases.append((f"shape_{ps}_{lw}", bvh_large, large, lo, ld,
                      {"packet_size": ps, "leaf_width": lw}))
    out = []
    for name, bvh, sc, o, d, kw in cases:
        o = torch.as_tensor(o, device=dev) if isinstance(o, np.ndarray) else o
        d = torch.as_tensor(d, device=dev) if isinstance(d, np.ndarray) else d
        for mt in (False, True):
            got = L.packet_intersect(bvh, sc, o, d, compat=not mt, **kw)
            want = L.packet_intersect_plain(bvh, sc, o, d, compat=not mt, **kw)
            label = f"packet adversarial {name}" + (" mt" if mt else "")
            check(results_equal(got, want), f"{label}: kernel differs from the "
                                            "plain walk")
            rec = {"case": name, "mt": mt, "rays": int(o.shape[0]),
                   "hits": int(got[0].sum())}
            lw = kw.get("leaf_width", 8)
            if sc is dbl and lw & (lw - 1) == 0:  # fat leaves cover every slot
                hit = got[0]
                check(bool((got[2][hit] < box.num_tris_padded).all()),
                      f"{label}: a tie went to the later copy")
            out.append(rec)
    emit({"phase": "packet_walk_adversarial", "build": build, "ok": True,
          "cases": out})
    return out


def perray_adversarial(dev, box, large, rng, build: str):
    """The per-ray walk kernel against its plain version, compat and MT, on
    the cases its launch shape and record loads could break: ray counts of
    1, 31, 33 and fewer than the card's SMs (partial warps, blocks short of
    rays); equal-t ties across leaves (rays straight down onto the box
    floor's diagonal, whose two triangles sit in two leaves, and the box with
    every triangle doubled: the first copy in preorder must win); a small
    explicit max_steps; and a tree with NaN boxes (one NaN vertex)."""
    from montecarlopathtracing_torch.accel import lbvh as L

    t = rng.uniform(1.65, 1.95, (64, 1)).astype(np.float32)
    diag_o = np.concatenate([t, np.full_like(t, 1.5), t], axis=1)
    diag_d = np.tile(np.float32([0.0, -1.0, 0.0]), (64, 1))
    diag_d[32:, 0] = -0.0
    n = 4099
    ro = rng.uniform(0.1, 1.9, (n, 3)).astype(np.float32)
    rd = rng.normal(size=(n, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    lo = rng.uniform(0.1, 2.9, (n, 3)).astype(np.float32)
    ld = rng.normal(size=(n, 3)).astype(np.float32)
    ld /= np.linalg.norm(ld, axis=1, keepdims=True)
    dbl = doubled_scene(box)
    nan_box = nan_vertex_scene(box)
    bvh_box, bvh_dbl, bvh_large, bvh_nan = (
        L.build_lbvh(sc) for sc in (box, dbl, large, nan_box))
    check(not bvh_nan.finite, "perray adversarial: the NaN box's tree is finite")
    co, cd = camera_and_shadow_rays(
        large, min(8192, large.camera.width * large.camera.height), seed=44)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = [("tie_across_leaves", bvh_box, box, diag_o, diag_d, {}),
             ("doubled_box", bvh_dbl, dbl, ro, rd, {}),
             ("nan_tree", bvh_nan, nan_box, ro, rd, {})]
    for count in (1, 31, 33, sms - 1):
        cases.append((f"rays_{count}", bvh_large, large, lo[:count], ld[:count], {}))
    for steps in (1, 3):
        cases.append((f"max_steps_{steps}", bvh_large, large, co, cd,
                      {"max_steps": steps}))
    floor = torch.nonzero(box.tri_valid & (box.v0[:, 1] == 0) & (box.v1[:, 1] == 0)
                          & (box.v2[:, 1] == 0))[:, 0]
    check(floor.numel() == 2, "perray adversarial: the box floor is not two triangles")
    out = []
    for name, bvh, sc, o, d, kw in cases:
        o, d = torch.as_tensor(o, device=dev), torch.as_tensor(d, device=dev)
        for mt in (False, True):
            got = L.bvh_intersect(bvh, sc, o, d, compat=not mt, **kw)
            want = L.bvh_intersect_plain(bvh, sc, o, d, compat=not mt, **kw)
            label = f"perray adversarial {name}" + (" mt" if mt else "")
            check(results_equal(got, want), f"{label}: kernel differs from the "
                                            "plain walk")
            hit = got[0]
            if sc is dbl:
                check(bool((got[2][hit] < box.num_tris_padded).all()),
                      f"{label}: a tie went to the later copy")
            if name == "tie_across_leaves":
                check(bool(hit.all()) and bool((got[2] == floor.min()).all()),
                      f"{label}: the floor's later triangle won a tie")
            out.append({"case": name, "mt": mt, "rays": int(o.shape[0]),
                        "hits": int(hit.sum())})
    emit({"phase": "bvh_walk_adversarial", "build": build, "ok": True,
          "sms": sms, "cases": out})
    return out


def phase_walk_kernels(dev, state):
    """(a) The walk kernels on the card against their plain versions and
    brute force: the box and the 100k interior, random rays with
    adversarial ones (axis-parallel on node planes, -0.0, parked, misses),
    and the 100k interior's camera and shadow rays, compat and MT."""
    from montecarlopathtracing_torch.accel import lbvh as L
    from montecarlopathtracing_torch.scene.builtin import load_builtin_box

    box, _ = load_builtin_box(width=1024, height=1024, with_specular=True,
                              with_glass=True, device=dev)
    large = state["large"]
    rng = np.random.default_rng(40)
    cases = []
    for name, scene, lo, hi in (("box", box, 0.1, 1.9), ("large", large, 0.1, 2.9)):
        t0 = time.perf_counter()
        bvh = L.build_lbvh(scene)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        host = L.build_lbvh_host(scene)
        check(torch.equal(bvh.node_min, host.node_min)
              and torch.equal(bvh.node_max, host.node_max),
              f"walks {name}: build_lbvh differs from build_lbvh_host")
        n = 8192 + 37
        o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        nmin = bvh.node_min.cpu().numpy()
        for i, k in enumerate(rng.integers(1, nmin.shape[0], 96)):
            ax = i % 3
            o[i, (ax + 1) % 3] = nmin[k, (ax + 1) % 3]  # on a node's plane
            d[i] = 0.0
            d[i, ax] = 1.0 if i % 2 else -1.0
        d[96:160, 0] = -0.0
        o[160:224] = 1e9
        d[160:224] = (1.0, 0.0, 0.0)
        o[224:256] = 50.0
        d[224:256] = (0.0, 0.0, 1.0)
        ray_sets = [("random", torch.as_tensor(o, device=dev),
                     torch.as_tensor(d, device=dev))]
        if name == "large":
            co, cd = camera_and_shadow_rays(large, MAIN_RAYS // 2, seed=41)
            half = co.shape[0] // 2
            m = min(8192, half)
            pick = torch.cat([torch.arange(0, m), torch.arange(half, half + m)])
            ray_sets.append(("camera_shadow", co[pick.to(dev)], cd[pick.to(dev)]))
            ray_sets.append(("camera_shadow_full", co, cd))
        for label, oo, dd in ray_sets:
            for mt in (False, True):
                res = {"case": f"{name}_{label}" + ("_mt" if mt else ""),
                       "rays": int(oo.shape[0]), "bvh_build_s": build_s}
                for kind in ("bvh_perray", "bvh"):
                    kernel, plain = walk_fns(kind)
                    got = kernel(bvh, scene, oo, dd, compat=not mt)
                    if label == "camera_shadow_full":
                        # The main path's full shape only has to launch here;
                        # whole calls are held to the plain walks on the
                        # frames' replays.
                        res[kind] = {"hits": int(got[0].sum())}
                        continue
                    want = plain(bvh, scene, oo, dd, compat=not mt)
                    check(results_equal(got, want),
                          f"walks {res['case']}: {kind} kernel differs from "
                          "its plain version")
                    # An axis-parallel ray on a node's slab plane misses
                    # that node (0 * inf = NaN, as in the JAX package's
                    # walks) where brute force may hit a triangle inside it:
                    # the adversarial rays are left out of the brute-force
                    # contract, and among camera rays (the lattice's centre
                    # ray is axis-parallel) 1 in 1,000 may differ.
                    sub = slice(256, None) if label == "random" else slice(None)
                    res[kind] = brute_contract(
                        scene, tuple(x[sub] for x in got), oo[sub], dd[sub], mt,
                        f"walks {res['case']} {kind}",
                        outliers=1e-3 if label == "camera_shadow" else 0.0)
                    res[kind]["t_max_abs_err"] = max_err(got[1], want[1])
                cases.append(res)
    emit({"phase": "walk_kernels", "ok": True, "cases": cases})
    # The package's build takes the packet walk's thread-per-ray kernel for
    # the box's small tree: the cases run again with the redesign for every
    # call; the per-ray walk's cases run again under its parent design.
    from montecarlopathtracing_torch.kernels import build as B

    packet_adversarial(dev, box, large, np.random.default_rng(42), "package")
    perray_adversarial(dev, box, large, np.random.default_rng(45), "package")
    try:
        B.EXTRA_FLAGS = ("-DMCPT_PACKET_WALK_V2",)
        B.load.cache_clear()
        packet_adversarial(dev, box, large, np.random.default_rng(42), "redesign")
        B.EXTRA_FLAGS = ("-DMCPT_BVH_WALK_V1",)
        B.load.cache_clear()
        perray_adversarial(dev, box, large, np.random.default_rng(45), "parent")
    finally:
        B.EXTRA_FLAGS = ()
        B.load.cache_clear()
    state["max_abs_err_walk"] = {
        k: max(c[k].get("t_max_abs_err", 0.0) for c in cases)
        for k in ("bvh_perray", "bvh")}


def walk_frame(scene, opts, kind: str, label: str, dev):
    """One frame through render_image_host_chunked: timed with the counters
    zeroed, then again under wavefront.eager() with the walk's calls
    recorded and held bit for bit to the timed frame.  Returns (image,
    record, calls)."""
    from montecarlopathtracing_torch.accel import lbvh as L
    from montecarlopathtracing_torch.integrator.wavefront import (
        _tile_swizzled_ids, render_image_host_chunked, resolve_plan, swizzle_tile)

    opts = opts.replace(intersector=kind) if kind != "fallback" else opts
    plan = resolve_plan(opts, scene.num_tris_padded)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bvh = L.build_lbvh_host(scene)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    captured = counted(lambda: render_image_host_chunked(scene, bvh, opts,
                                                         device=dev))
    img, rays, secs, launches = captured[:4]
    name = "bvh_intersect" if plan[0] == "bvh_perray" else "packet_intersect"
    with WalkCapture(name) as cap:
        hold_graphs(label, captured, counted(
            lambda: render_image_host_chunked(scene, bvh, opts, device=dev),
            eager=True))
    walk = WALK_KERNELS[plan[0]]
    check(launches[walk] > 0, f"{label}: the {walk} kernel was not launched")
    check(all(v == 0 for k, v in launches.items() if k not in WALK_KERNELS.values()),
          f"{label}: a cluster kernel was launched on a walk frame: {launches}")
    mean = image_checks(img, label)
    w, h = scene.camera.width, scene.camera.height
    # A walk's swizzle tile is a packet (32 x 32 pixels): a frame whose
    # height is no multiple of 32 renders duplicate slots, counted in
    # ``rays``; primary_rays_per_s counts the frame's own W x H x spp.
    slots = len(_tile_swizzled_ids(h, w, swizzle_tile(opts, scene.num_tris_padded)))
    rec = {"phase": label, "width": w, "height": h, "spp": opts.spp,
           "max_depth": opts.max_depth, "plan": list(plan),
           "tris_padded": scene.num_tris_padded, "seconds": secs,
           "bvh_build_host_s": build_s, "rays": rays, "rays_per_s": rays / secs,
           "slots": slots, "duplicate_slot_share": 1 - w * h / slots,
           "primary_rays_per_s": w * h * opts.spp / secs,
           "iterations": launches[walk], "mean": mean, "launches": launches}
    return img, rec, (plan[0], cap.calls)


def phase_walk_frames(dev, state):
    """(b) Frames at full width under both walks, MODERN, against the
    cluster render of the same options; (c) the chunk-cap fallback frame."""
    from montecarlopathtracing_torch.config import MODERN, RenderOptions
    from montecarlopathtracing_torch.integrator.wavefront import (
        render_image_host_chunked, resolve_plan)
    from montecarlopathtracing_torch.scene.builtin import load_builtin_box

    box, _ = load_builtin_box(width=1024, height=1024, device=dev)
    frames = (("box", box, RenderOptions(spp=16, spp_chunk=16, max_depth=32,
                                         compat=MODERN)),
              ("large", state["large"], RenderOptions(spp=4, spp_chunk=4,
                                                      compat=MODERN)))
    for name, scene, opts in frames:
        t0 = time.perf_counter()
        ref, _ = render_image_host_chunked(scene, None, opts, device=dev)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        for kind in ("bvh", "bvh_perray"):
            label = f"{name}_{kind}"
            img, rec, calls = walk_frame(scene, opts, kind, label, dev)
            rec["against_cluster"] = image_agreement(ref, img, label)
            rec["cluster_seconds"] = ref_s
            rec["cluster_primary_rays_per_s"] = (
                scene.camera.width * scene.camera.height * opts.spp / ref_s)
            emit(rec)
            state[f"walk_frame_{label}"] = rec
            state[f"walk_calls_{label}"] = calls
            del img
        del ref
        torch.cuda.empty_cache()
    # (c) The 400k interior past a chunk cap of 4 (it needs 7 chunks) under
    # large_mode="chunked": the packet walk.
    scene = state["large400"]
    opts = RenderOptions(spp=LARGE400_SPP, spp_chunk=LARGE400_SPP,
                         large_mode="chunked", max_table_chunks=4)
    plan = resolve_plan(opts, scene.num_tris_padded)
    check(plan == ("bvh", None, None, 1), f"fallback: resolve_plan gave {plan}")
    img, rec, calls = walk_frame(scene, opts, "fallback", "large400_fallback", dev)
    emit(rec)
    state["walk_frame_large400_fallback"] = rec
    state["walk_calls_large400_fallback"] = calls
    del img
    torch.cuda.empty_cache()


# Each walk's designs: the package's build and measurement builds, each of
# those also as a -DMCPT_WALK_STATS build when marked: (name, flags, with a
# measurement build).  The packet walk (csrc/packet_walk.cu): the package
# takes the thread-per-ray kernel (the parent design) for the smallest trees
# and the rays-per-thread kernel (the redesign) for the rest, and builds
# that take one of the two for every call.  The per-ray walk
# (csrc/bvh_walk.cu): the package's build is the redesign on every tree (no
# crossover: PERF.md, PR 9), and -DMCPT_BVH_WALK_V1 builds the parent
# design.
WALK_DESIGNS = {
    "bvh": (("package", (), False),
            ("parent", ("-DMCPT_PACKET_WALK_V1",), True),
            ("redesign", ("-DMCPT_PACKET_WALK_V2",), True)),
    "bvh_perray": (("package", (), True),
                   ("parent", ("-DMCPT_BVH_WALK_V1",), True)),
}


def walk_design_stats(calls, label: str, kind: str):
    """Every call of a walk frame replayed under each of WALK_DESIGNS[kind],
    each call timed once (CUDA events, after a warm-up call) and held bit
    for bit to the first design's result; then
    the measurement builds over the same calls, their counters summarised
    (accel/lbvh.py's packet_walk_stats_summary or bvh_walk_stats_summary:
    the step-0 counts).  ms and ms_max are over all calls of the frame.
    Emits one "packet_walk_designs" or "bvh_walk_designs" line."""
    from montecarlopathtracing_torch.accel import lbvh as L
    from montecarlopathtracing_torch.kernels import build as B

    kernel, _ = walk_fns(kind)
    designs = WALK_DESIGNS[kind]
    prefix = "PACKET" if kind == "bvh" else "BVH"
    sleep = sleep_ms()
    out, first = {}, []
    try:
        for name, flags, measured in designs:
            for counting in (False, True)[:1 + measured]:
                B.EXTRA_FLAGS = flags + (("-DMCPT_WALK_STATS",) if counting else ())
                B.load.cache_clear()
                log = B.build([WALK_KERNELS[kind]])[WALK_KERNELS[kind]]["log"]
                if counting:
                    names = getattr(L, prefix + "_WALK_STATS")
                    summary = getattr(L, prefix.lower() + "_walk_stats_summary")
                ms, stats = [], []
                for i, (bvh, scene, o, d, kw) in enumerate(calls):
                    extra = {}
                    if counting:
                        rows = o.shape[0]
                        if kind == "bvh":
                            rows = -(-rows // min(kw.get("packet_size", 1024), rows))
                        extra["stats"] = torch.zeros((rows, len(names)),
                                                     dtype=torch.int64, device=o.device)
                    t, _, got = timed(lambda: kernel(bvh, scene, o, d, **extra, **kw),
                                      sleep, warm=True)
                    if len(first) <= i:
                        first.append(got)
                    else:
                        check(results_equal(got, first[i]),
                              f"{label}: {kind} walk {name} (stats {counting}) "
                              f"differs from the {designs[0][0]} build on "
                              f"call {i}")
                    if counting:
                        stats.append(extra["stats"])
                    else:
                        ms.append(t)
                rec = out.setdefault(name, {})
                ptxas = [ln.strip() for ln in log.splitlines()
                         if "registers" in ln or "spill" in ln]
                if counting:
                    rec.update(step0=summary(stats), ptxas_stats=ptxas)
                else:
                    rec.update(ms=sum(ms) / len(ms), ms_max=max(ms), calls=len(ms),
                               ptxas=ptxas)
                del stats
    finally:
        B.EXTRA_FLAGS = ()
        B.load.cache_clear()
    if "parent" in out and "package" in out:
        out["parent_over_package"] = out["parent"]["ms"] / out["package"]["ms"]
    phase = "packet_walk_designs" if kind == "bvh" else "bvh_walk_designs"
    emit({"phase": phase, "case": label, "sleep_ms": sleep, **out})
    return out


def phase_walk_timing(state):
    """(a) continued: every walk frame's calls replayed against the plain
    walks (walk_frame_stats), and under both designs of their walk
    (walk_design_stats)."""
    out = {}
    for label in ("box_bvh", "box_bvh_perray", "large_bvh", "large_bvh_perray",
                  "large400_fallback"):
        kind, calls = state.pop(f"walk_calls_{label}")
        out[label] = walk_frame_stats(calls, kind, label)
        out[label]["designs"] = walk_design_stats(calls, label, kind)
        del calls
        torch.cuda.empty_cache()
    state["walk_time"] = out


def phase_oracle(dev):
    """(d) A 16 x 16 box rendered on the card against the port's f64 oracle
    with tests/test_oracle.py's limits: direct lighting and the full path in
    compat mode on the pixels whose lattice-corner primary meets a triangle
    interior (an edge-exact primary's f32 hit decision may differ from the
    f64 one; tests/test_oracle.py's compat refill test masks the same), and
    the full path in MODERN mode on every pixel."""
    from montecarlopathtracing_torch.accel.lbvh import brute_force_intersect
    from montecarlopathtracing_torch.config import MODERN, RenderOptions
    from montecarlopathtracing_torch.integrator.camera import primary_rays
    from montecarlopathtracing_torch.integrator.wavefront import render_pixels
    from montecarlopathtracing_torch.ops.intersect import barycentric
    from montecarlopathtracing_torch.oracle.cpu_reference import oracle_render_pixels
    from montecarlopathtracing_torch.scene.builtin import load_builtin_box

    scene, _ = load_builtin_box(width=16, height=16, device=dev)
    ids = np.arange(256, dtype=np.int32)
    ids_t = torch.as_tensor(ids, device=dev)
    o, d = primary_rays(scene.camera, ids_t)
    hit, t, tri = brute_force_intersect(scene, o, d)
    p = o + d * torch.where(hit, t, 0.0)[:, None]
    tc = torch.clamp(tri, min=0).long()
    bary = barycentric(p, scene.v0[tc], scene.v1[tc], scene.v2[tc])
    interior = (hit & (torch.amin(bary, dim=1) > 1e-3)).cpu().numpy()
    out = {"interior_share": float(interior.mean())}
    for label, depth, med, line, share, mask, compat in (
            ("direct", 1, 1e-5, 1e-3, 0.99, interior, {}),
            ("full_path", 6, 1e-4, 1e-2, 0.98, interior, {}),
            ("full_path_modern", 6, 1e-4, 1e-2, 0.98, None, {"compat": MODERN})):
        opts = RenderOptions(spp=4, max_depth=depth, chunk_size=256, refill=False,
                             **compat)
        got, _ = render_pixels(scene, None, opts, ids_t)
        want = oracle_render_pixels(scene, opts, ids)
        rel = (np.abs(got.cpu().numpy().astype(np.float64) - want)
               / np.maximum(np.abs(want), 1e-2))
        frame_within = float((rel.max(axis=1) < line).mean())
        if mask is not None:
            rel = rel[mask]
        within = float((rel.max(axis=1) < line).mean())
        check(np.median(rel) < med and within > share,
              f"oracle {label}: median {np.median(rel):.3e}, {within:.4f} of "
              f"lanes within {line}")
        out[label] = {"median_rel": float(np.median(rel)), "share_within": within,
                      "share_within_whole_frame": frame_within}
    emit({"phase": "oracle", "width": 16, "height": 16, "spp": 4, **out})


def write_obj(scene, meta, d: str, name: str):
    """The scene as OBJ / MTL / .camera text (valid triangles, one v / vt /
    vn per corner, materials without textures)."""
    valid = scene.tri_valid.cpu().numpy()
    f = lambda t: t.cpu().numpy()[valid]
    vs = np.stack([f(scene.v0), f(scene.v1), f(scene.v2)], axis=1).reshape(-1, 3)
    vn = np.stack([f(scene.n0), f(scene.n1), f(scene.n2)], axis=1).reshape(-1, 3)
    vt = np.stack([f(scene.uv0), f(scene.uv1), f(scene.uv2)], axis=1).reshape(-1, 2)
    mat = f(scene.mat_id)
    names = meta.material_names
    lines = [f"v {a:.9g} {b:.9g} {c:.9g}" for a, b, c in vs]
    lines += [f"vt {a:.9g} {b:.9g}" for a, b in vt]
    lines += [f"vn {a:.9g} {b:.9g} {c:.9g}" for a, b, c in vn]
    cur = None
    for i, m in enumerate(mat):
        if m != cur:
            lines.append(f"usemtl {names[m]}")
            cur = m
        a, b, c = 3 * i + 1, 3 * i + 2, 3 * i + 3
        lines.append(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}")
    with open(os.path.join(d, name + ".obj"), "w") as fh:
        fh.write("\n".join(lines) + "\n")
    kd, ks = scene.kd.cpu().numpy(), scene.ks.cpu().numpy()
    ns, ni = scene.ns.cpu().numpy(), scene.ni.cpu().numpy()
    with open(os.path.join(d, name + ".mtl"), "w") as fh:
        for i, n in enumerate(names):
            fh.write(f"newmtl {n}\nKd {kd[i][0]:.9g} {kd[i][1]:.9g} {kd[i][2]:.9g}\n"
                     f"Ks {ks[i][0]:.9g} {ks[i][1]:.9g} {ks[i][2]:.9g}\n"
                     f"Ns {ns[i]:.9g}\nNi {ni[i]:.9g}\n")
    cam = scene.camera
    v3 = lambda t: " ".join(f"{x:.9g}" for x in t.cpu().numpy())
    light = scene.light_radiance.cpu().numpy()
    with open(os.path.join(d, name + ".camera"), "w") as fh:
        fh.write(f"eye {v3(cam.eye)}\nlookat {v3(cam.look_at)}\nup {v3(cam.up)}\n"
                 f"fovy {float(cam.fovy):.9g}\nwidth {cam.width}\n"
                 f"height {cam.height}\n")
        for li, m in enumerate(scene.light_mat.cpu().numpy()):
            fh.write(f"mtlname {names[m]} {light[li][0]:.9g} {light[li][1]:.9g} "
                     f"{light[li][2]:.9g}\n")


def phase_native(dev, state):
    """(e) The box and the 100k interior written to OBJ / MTL and loaded
    with use_native=True: the native parser ran (no fallback) and its fields
    equal the Python parser's."""
    import logging

    from montecarlopathtracing_torch import api
    from montecarlopathtracing_torch.scene.builtin import write_box_scene
    from montecarlopathtracing_torch.scene.types import SCENE_FIELDS

    class Catch(logging.Handler):
        def __init__(self):
            super().__init__()
            self.lines = []

        def emit(self, record):
            self.lines.append(record.getMessage())

    catch = Catch()
    logger = logging.getLogger("montecarlopathtracing_torch.api")
    logger.addHandler(catch)
    old_level = logger.level
    logger.setLevel(logging.INFO)
    out = []
    try:
        with tempfile.TemporaryDirectory() as d:
            write_box_scene(d, "box", width=64, height=64)
            write_obj(state["large"], state["large_meta"], d, "large100k")
            for name in ("box", "large100k"):
                catch.lines.clear()
                t0 = time.perf_counter()
                sn, mn = api.load_scene(d, name, device=dev)
                tn = time.perf_counter() - t0
                check(any("parsed by the native loader" in s for s in catch.lines),
                      f"native {name}: the native parser did not run: {catch.lines}")
                t0 = time.perf_counter()
                sp, mp = api.load_scene(d, name, use_native=False, device=dev)
                tp = time.perf_counter() - t0
                same = [f for f in SCENE_FIELDS
                        if torch.equal(getattr(sn, f), getattr(sp, f))]
                check(len(same) == len(SCENE_FIELDS) and mn.num_faces == mp.num_faces,
                      f"native {name}: fields differ from the python parser: "
                      f"{sorted(set(SCENE_FIELDS) - set(same))}")
                out.append({"scene": name, "faces": mn.num_faces,
                            "native_load_s": tn, "python_load_s": tp})
    finally:
        logger.removeHandler(catch)
        logger.setLevel(old_level)
    emit({"phase": "native", "ok": True, "scenes": out})


RANK_RENDER = dict(spp=8, max_depth=4, chunk_size=256)
RANK_TRAIN = dict(spp=4, max_depth=3, chunk_size=256)


def sharded_grad(scene, mesh, dev: str, label: str):
    """d mean(image) / d SceneParams through render_image_sharded with
    differentiable=True (MODERN, RANK_RENDER's options), both passes
    replayed as CUDA graphs and held to the same gradient under
    wavefront.eager() (hold_grad_graphs's ``label``), and the key and
    intersect launches of its forward pass."""
    from montecarlopathtracing_torch.config import MODERN, RenderOptions
    from montecarlopathtracing_torch.parallel.mesh import render_image_sharded

    opts = RenderOptions(**RANK_RENDER, compat=MODERN)
    res = hold_grad_graphs(label, gradient_of(
        scene, opts, torch.mean, dev, render=lambda sc: (render_image_sharded(
            sc, None, opts, mesh, differentiable=True, device=dev), 0)))
    return res["grads"].to("cpu"), res["launches_forward"]


def rank_worker(rank: int, world: int, address: str, out_dir: str, dev: str):
    """One of two ranks on the card (gloo collectives on CUDA tensors): the
    sharded render (captured, and under wavefront.eager(): bit for bit) and
    its gradient on a 2 x 1 and a 1 x 2 grid, and one distributed step on
    each grid."""
    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.diff.gradients import (
        SceneParams, make_distributed_train_step)
    from montecarlopathtracing_torch.parallel.mesh import (
        _padded_ids, initialize_multihost, make_mesh, render_image_sharded)
    from montecarlopathtracing_torch.scene.builtin import load_builtin_box

    if dev == "cuda":
        torch.cuda.set_device(0)
    initialize_multihost(address, world, rank, backend="gloo")
    res = {}
    for tile, spp in ((2, 1), (1, 2)):
        mesh = make_mesh(tile=tile, spp=spp)
        scene, _ = load_builtin_box(width=64, height=64, device=dev)

        def render():  # render_image_sharded returns no ray count
            return render_image_sharded(scene, None, RenderOptions(**RANK_RENDER),
                                        mesh, device=dev), 0

        label = f"ranks_{tile}x{spp}_rank{rank}"
        captured = counted(render)
        hold_graphs(label, captured, counted(render, eager=True))
        img = captured[0]
        t0 = time.perf_counter()
        grads, grad_launches = sharded_grad(scene, mesh, dev, label + "_grad")
        grad_secs = time.perf_counter() - t0
        small, _ = load_builtin_box(width=32, height=32, device=dev)
        ids, per = _padded_ids(32 * 32, tile)
        step = make_distributed_train_step(small, None, RenderOptions(**RANK_TRAIN),
                                           mesh, lr=0.05, device=dev)
        params, loss = step(SceneParams.from_scene(small),
                            torch.zeros((tile, per, 3), device=dev), ids)
        res[f"{tile}x{spp}"] = {"img": img.cpu(), "loss": float(loss),
                                "kd": params.kd.cpu(), "per": per,
                                "grads": vars(grads), "grad_launches": grad_launches,
                                "grad_seconds": grad_secs,
                                "graphs": GRAPH_FRAMES[label],
                                "grad_graphs": GRAD_FRAMES[label + "_grad"]}
    torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def phase_ranks(dev):
    """(f) Two ranks on the card, spawned here, gloo collectives on CUDA
    tensors (NCCL refuses two ranks on one device): the sharded render
    (each rank's and the one process's captured frame bit for bit its
    frame under wavefront.eager()) and the distributed step against one
    process, at tests/test_parallel.py's
    tolerances; the sharded gradient bit for bit the same on both ranks and
    within grad (a)'s tolerance of one process's, with rows 1 and 2
    launched in every rank."""
    import torch.multiprocessing as mp

    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.diff.gradients import (
        PARAM_FIELDS, SceneParams, train_step)
    from montecarlopathtracing_torch.integrator.wavefront import render_image_stats
    from montecarlopathtracing_torch.parallel.mesh import make_mesh
    from montecarlopathtracing_torch.scene.builtin import load_builtin_box

    scene, _ = load_builtin_box(width=64, height=64, device=dev)
    captured = counted(lambda: render_image_stats(
        scene, None, RenderOptions(**RANK_RENDER), device=dev))
    hold_graphs("ranks_single", captured, counted(lambda: render_image_stats(
        scene, None, RenderOptions(**RANK_RENDER), device=dev), eager=True))
    single = captured[0].cpu()
    single_grad, single_launches = sharded_grad(scene, make_mesh(), dev,
                                                "ranks_single_grad")
    small, _ = load_builtin_box(width=32, height=32, device=dev)
    p1, loss1 = train_step(SceneParams.from_scene(small), small, None,
                           RenderOptions(**RANK_TRAIN),
                           torch.zeros((32, 32, 3), device=dev), lr=0.05, device=dev)
    address = f"localhost:{free_port()}"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(rank_worker, args=(2, address, d, dev), nprocs=2,
                           join=True, start_method="spawn")
        ranks = [torch.load(os.path.join(d, f"rank{r}.pt")) for r in range(2)]
    secs = time.perf_counter() - t0
    for rank, r in enumerate(ranks):
        for grid, res in r.items():
            res["grads"] = SceneParams(**res["grads"])
            GRAPH_FRAMES[f"ranks_{grid}_rank{rank}"] = res.pop("graphs")
            GRAD_FRAMES[f"ranks_{grid}_rank{rank}_grad"] = res.pop("grad_graphs")
    check(grads_finite(single_grad) and float(single_grad.kd.abs().max()) > 0,
          "ranks: the one-process gradient is not finite or is zero")
    out = {}
    for grid, (rtol, atol) in (("2x1", (1e-5, 1e-6)), ("1x2", (1e-4, 1e-5))):
        a, b = ranks[0][grid], ranks[1][grid]
        check(torch.equal(a["img"], b["img"]), f"ranks {grid}: images differ "
                                               "between the ranks")
        check(bool(torch.allclose(a["img"], single, rtol=rtol, atol=atol)),
              f"ranks {grid}: sharded render differs from one process")
        check(a["per"] * int(grid[0]) == 32 * 32, f"ranks {grid}: padded tiles")
        check(abs(a["loss"] - float(loss1)) <= 1e-4 * abs(float(loss1)),
              f"ranks {grid}: loss {a['loss']} against {float(loss1)}")
        check(bool(torch.allclose(a["kd"], p1.kd.cpu(), rtol=1e-3, atol=1e-6))
              and torch.equal(a["kd"], b["kd"]),
              f"ranks {grid}: kd after the step differs from train_step")
        check(all(torch.equal(getattr(a["grads"], f), getattr(b["grads"], f))
                  for f in PARAM_FIELDS),
              f"ranks {grid}: the sharded gradients differ between the ranks")
        errs, ok = grad_errors(single_grad, a["grads"])
        check(ok, f"ranks {grid}: the sharded gradient differs from one "
                  f"process's: {errs}")
        for r in (a, b):
            check_launched(r["grad_launches"], PATH_KERNELS["single"],
                           f"ranks {grid} sharded gradient")
        out[grid] = {"img_max_abs_diff": float((a["img"] - single).abs().max()),
                     "loss": a["loss"], "loss_single": float(loss1),
                     "kd_max_abs_diff": float((a["kd"] - p1.kd.cpu()).abs().max()),
                     "grad_max_abs_err_and_scale": errs,
                     "grad_seconds": [a["grad_seconds"], b["grad_seconds"]],
                     "grad_launches": [a["grad_launches"], b["grad_launches"]]}
    emit({"phase": "ranks", "ranks": 2, "backend": "gloo", "seconds": secs,
          "grad_tolerance": "atol 1e-6 + 1e-4 x field max",
          "grad_launches_single": single_launches, **out})


RECOVERY_OPTS = dict(spp=6, spp_chunk=2, max_depth=6, seed=5)


def phase_recovery(dev):
    """Failure recovery (tests/test_torch_recovery.py) on the card, the 64 x
    64 box, MODERN, test_failure_recovery.py's options: a dispatch that
    raises once under retries=1, and a render_progressive that finds a
    truncated checkpoint and starts over, each film bit for bit the
    uninterrupted card film's (itself bit for bit under wavefront.eager());
    with retries=0 the fault propagates.  Rows 1 and 2 are counted over the
    recovered renders."""
    from montecarlopathtracing_torch import api
    from montecarlopathtracing_torch.config import MODERN, RenderOptions
    from montecarlopathtracing_torch.integrator import wavefront as W
    from montecarlopathtracing_torch.kernels import cluster as K
    from montecarlopathtracing_torch.scene.builtin import load_builtin_box

    opts = RenderOptions(**RECOVERY_OPTS, compat=MODERN)
    scene, _ = load_builtin_box(width=64, height=64, device=dev)
    t0 = time.perf_counter()
    captured = counted(lambda: W.render_image_host_chunked(scene, None, opts,
                                                           device=dev))
    hold_graphs("recovery", captured, counted(
        lambda: W.render_image_host_chunked(scene, None, opts, device=dev),
        eager=True))
    clean, clean_rays = captured[:2]
    clean_film = api.render_progressive(scene, opts, device=dev)
    image_checks(clean, "recovery")

    real = W.render_pixels_refill
    calls = {"n": 0}

    def flaky(*args, **kw):
        calls["n"] += 1
        if calls["n"] == 2:  # fail the second dispatch once
            raise RuntimeError("injected transient device fault")
        return real(*args, **kw)

    K.reset_launch_counts()
    W.render_pixels_refill = flaky
    try:
        img, rays = W.render_image_host_chunked(scene, None, opts, retries=1,
                                                device=dev)
        retried_calls = calls["n"]
        calls["n"] = 0
        try:
            W.render_image_host_chunked(scene, None, opts, device=dev)
            propagated = False
        except RuntimeError as exc:
            propagated = "injected" in str(exc)
    finally:
        W.render_pixels_refill = real
    check(retried_calls == len(W.spp_steps(opts)) + 1,
          f"recovery: {retried_calls} dispatches under retries=1")
    check(torch.equal(img, clean) and rays == clean_rays,
          "recovery: the retried image differs from the uninterrupted one")
    check(propagated, "recovery: with retries=0 the fault did not propagate")
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "film.npz")
        with open(ckpt, "wb") as fh:
            fh.write(b"PK\x03\x04garbage-truncated-npz")
        film = api.render_progressive(scene, opts, checkpoint_path=ckpt,
                                      device=dev)
    launches = K.launch_counts()
    check(float(film.n_samples) == opts.spp
          and torch.equal(film.radiance_sum, clean_film.radiance_sum),
          "recovery: the restarted film differs from the uninterrupted one")
    check_launched(launches, PATH_KERNELS["single"], "recovery")
    emit({"phase": "recovery", "width": 64, "height": 64, **RECOVERY_OPTS,
          "retry_dispatches": retried_calls, "retried_equal": True,
          "fault_propagates_without_retries": True, "restart_equal": True,
          "launches": launches, "seconds": time.perf_counter() - t0})


def free_port() -> int:
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


TORCHRUN_RENDER = ("--spp", "4", "--max-depth", "8")


def phase_torchrun(dev):
    """The CLI under torchrun: two ranks on the one card with --mesh-tile 2
    (cli.py's gloo branch).  Exit code 0, and its PNG byte for byte the
    one-process CLI's, or within the image limit."""
    from montecarlopathtracing_torch import read_png
    from montecarlopathtracing_torch.scene.builtin import write_box_scene

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        write_box_scene(d, "box", width=64, height=64)
        cli = ("-m", "montecarlopathtracing_torch", "render", d, "box",
               *TORCHRUN_RENDER, "--device", dev)
        runs = {
            "one": [sys.executable, *cli, "--out-dir", os.path.join(d, "one")],
            "torchrun": [sys.executable, "-m", "torch.distributed.run",
                         "--nproc-per-node", "2", "--master-addr", "localhost",
                         "--master-port", str(free_port()), *cli, "--out-dir",
                         os.path.join(d, "torchrun"), "--mesh-tile", "2"],
        }
        secs, pngs = {}, {}
        for name, cmd in runs.items():
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                                 timeout=600)
            secs[name] = time.perf_counter() - t0
            check(res.returncode == 0, f"torchrun: the {name} CLI exited "
                                       f"{res.returncode}:\n{res.stderr[-3000:]}")
            path = os.path.join(d, name, "box-SPP4.png")
            check(os.path.isfile(path), f"torchrun: the {name} CLI wrote no PNG")
            with open(path, "rb") as fh:
                pngs[name] = fh.read()
            pngs[name + "_pixels"] = read_png(path)
    same = pngs["one"] == pngs["torchrun"]
    agree = None
    if not same:
        agree = image_agreement(pngs["one_pixels"].astype(np.float32),
                                pngs["torchrun_pixels"].astype(np.float32),
                                "torchrun")
    emit({"phase": "torchrun", "ranks": 2, "width": 64, "height": 64,
          "args": list(TORCHRUN_RENDER) + ["--mesh-tile", "2"],
          "png_bytes_equal": same, "image_agreement": agree,
          "seconds_one": secs["one"], "seconds_torchrun": secs["torchrun"]})


ATLAS_LANES = 65_536


def atlas_grad_case(dev, seed: int = 24):
    """(keys with the sentinel, today's ids and mask, rows) at the
    interior's shapes: 61% of the lanes untextured at texel 0, 9% misses at
    the last texel, 30% on 2,000 texels (runs of ~10)."""
    g = np.random.default_rng(seed)
    n, a = ATLAS_LANES, INTERIOR_TEXELS
    kind = g.uniform(size=n)
    has = kind >= 0.7
    idx = np.where(kind < 0.61, 0, a - 1)
    idx[has] = g.choice(g.integers(0, a, 2_000), size=int(has.sum()))
    keys = np.where(has, idx, a).astype(np.int32)
    rows = g.uniform(-1, 1, (n, 3)).astype(np.float32)
    t = lambda x: torch.as_tensor(x, device=dev)
    return t(keys), t(idx.astype(np.int64)), t(has[:, None]), t(rows)


def phase_atlas_grad(dev):
    from montecarlopathtracing_torch.kernels import atlas as A

    keys, idx, has, rows = atlas_grad_case(dev)
    n, a = keys.shape[0], INTERIOR_TEXELS
    A.reset_stats()
    got = A.atlas_grad(keys, rows, a)
    again = A.atlas_grad(keys, rows, a)
    sync(dev)
    stats = A.stats()
    live = keys < a
    k = keys[live].long()
    z = torch.zeros((a, 3), dtype=torch.float64, device=dev)
    want = z.clone().index_add_(0, k, rows[live].double())
    scale = z.clone().index_add_(0, k, rows[live].double().abs())
    err = torch.abs(got.double() - want)
    check(bool((err <= 1e-6 * scale).all()), "atlas_grad: sums past 1e-6")
    check(torch.equal(got.view(torch.int32), again.view(torch.int32)),
          "atlas_grad: two calls differ")
    longest = int(torch.bincount(k).max())
    check(stats == {"atlas_rows": 2 * n, "atlas_texel_rows": 2 * int(live.sum()),
                    "atlas_longest_run": longest}, f"atlas_grad counters {stats}")
    sleep = sleep_ms()
    masked = torch.where(has, rows, 0.0)

    def library():
        return torch.zeros((a, 3), device=dev).index_put_((idx,), masked,
                                                           accumulate=True)

    def mean_ms(fn, reps: int = 20):
        fn()
        runs = [timed(fn, sleep) for _ in range(reps)]
        return sum(r[0] for r in runs) / reps, sum(r[1] for r in runs)

    ms, late = mean_ms(lambda: A.atlas_grad(keys, rows, a))
    sort_ms_, _ = mean_ms(lambda: torch.sort(keys, stable=True))
    plain_ms, _ = mean_ms(lambda: A.atlas_grad_plain(keys, rows, a), 5)
    library_ms, _ = mean_ms(library, 5)
    lib = library()
    n_bytes = n * (4 + 12) + a * 12
    bound, by = bound_of(n_bytes, 0)
    emit({"phase": "atlas_grad", "lanes": n, "texels": a,
          "texel_rows": int(live.sum()), "longest_texel_run": longest,
          "longest_library_run": int(torch.bincount(idx).max()),
          "max_rel_err": float((err / scale.clamp(min=1e-30)).max()),
          "library_max_abs_diff": float(torch.abs(lib.double() - want).max()),
          "ms": ms, "sort_ms": sort_ms_, "plain_ms": plain_ms,
          "library_ms": library_ms, "bound_ms": bound, "bound_by": by,
          "bytes": n_bytes, "share_of_bound": bound / ms,
          "host_outlasted_sleep": late, "sleep_ms": sleep})


def phase_compat_frame(dev):
    """The built-in box at 256 x 256, spp 4, compat (RenderOptions'
    defaults), rendered whole through render_image_host_chunked on the card
    (captured, and under wavefront.eager(): bit for bit) and on the CPU,
    every pixel held to the image limit; rows 1 and 2 counted on the card's
    frame."""
    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.integrator.wavefront import (
        render_image_host_chunked)
    from montecarlopathtracing_torch.scene.builtin import load_builtin_box

    opts = RenderOptions(spp=4)
    imgs, rays, secs = {}, {}, {}
    scene, _ = load_builtin_box(width=256, height=256, device=dev)
    captured = counted(lambda: render_image_host_chunked(scene, None, opts,
                                                         device=dev))
    hold_graphs("compat_frame", captured, counted(
        lambda: render_image_host_chunked(scene, None, opts, device=dev),
        eager=True))
    img, rays[dev], secs[dev], launches = captured[:4]
    imgs[dev] = img.cpu()
    scene, _ = load_builtin_box(width=256, height=256, device="cpu")
    t0 = time.perf_counter()
    img, rays["cpu"] = render_image_host_chunked(scene, None, opts, device="cpu")
    secs["cpu"] = time.perf_counter() - t0
    imgs["cpu"] = img
    check_launched(launches, PATH_KERNELS["single"], "compat_frame")
    image_checks(imgs[dev], "compat_frame")
    res = image_agreement(imgs["cpu"], imgs[dev], "compat_frame")
    emit({"phase": "compat_frame", "width": 256, "height": 256, "spp": 4,
          "compat": True,
          "pixels_outside": round(res["outside_share"] * res["pixels"]),
          "rays_cuda": rays[dev], "rays_cpu": rays["cpu"], "launches": launches,
          "seconds_cuda": secs[dev], "seconds_cpu": secs["cpu"], **res})


BENCH_ARGS = ("--stages", "fwd,bwd,stats", "--size", "256", "--repeats", "1")


def phase_bench():
    """(h) bench_torch.py, the port's measuring entry point, as a user runs
    it, at a reduced size: the box at 256 x 256 for its fwd, bwd and stats
    stages, one timed run each.  It must exit 0 with correct: true and this
    card's name."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, os.path.join(root, "bench_torch.py"),
                          *BENCH_ARGS], cwd=root, capture_output=True, text=True,
                         timeout=600)
    secs = time.perf_counter() - t0
    check(res.returncode == 0, f"bench: exit code {res.returncode}: "
                               f"{res.stderr[-2000:]}")
    lines = res.stdout.strip().splitlines()
    check(len(lines) == 1, f"bench: {len(lines)} lines on stdout")
    line = json.loads(lines[0])
    check(line.get("correct") is True, "bench: correct is not true")
    check(line.get("device") == torch.cuda.get_device_name(0),
          f"bench: device {line.get('device')!r}")
    keys = ("fwd_rays_per_s", "fwdbwd_rays_per_s", "cand_clusters_per_ray",
            "fwd_check_outside_share", "bwd_peak_memory_bytes",
            "est_f32_peak_share", "bwd_launches_backward")
    check(all(k in line for k in keys), f"bench: keys missing from {sorted(line)}")
    emit({"phase": "bench", "args": list(BENCH_ARGS), "seconds": secs,
          **{k: line[k] for k in ("value", "nvidia_smi", *keys)}})


def phase_profile(dev):
    """(g) The CLI's --profile on a small scene writes a torch.profiler trace
    holding device kernels."""
    from montecarlopathtracing_torch.scene.builtin import write_box_scene

    root = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        write_box_scene(d, "box", width=64, height=64)
        prof = os.path.join(d, "prof")
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "montecarlopathtracing_torch", "render", d,
             "box", "--spp", "2", "--max-depth", "4", "--out-dir",
             os.path.join(d, "out"), "--profile", prof, "--device", dev],
            cwd=root, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        check(res.returncode == 0, f"profile: the CLI failed:\n{res.stderr[-3000:]}")
        path = os.path.join(prof, "trace.json")
        check(os.path.isfile(path) and os.path.getsize(path) > 0,
              "profile: no trace written")
        events = json.load(open(path))["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        check(len(kernels) > 0, "profile: the trace holds no device kernel")
        emit({"phase": "profile", "seconds": secs,
              "trace_bytes": os.path.getsize(path), "events": len(events),
              "kernel_events": len(kernels)})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this check needs a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from montecarlopathtracing_torch.integrator import wavefront as W
    from montecarlopathtracing_torch.kernels import build as B
    from montecarlopathtracing_torch.utils.device import nvidia_smi_line

    dev = "cuda"
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "count": torch.cuda.device_count(),
          "pil": importlib.util.find_spec("PIL") is not None})

    state = {}
    t0 = time.perf_counter()
    built = B.build()
    info = {}
    for name, b in built.items():
        regs = [ln.strip() for ln in b["log"].splitlines() if "registers" in ln]
        info[name] = {"seconds": b["seconds"], "ptxas": regs}
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels": info})
    # Each phase's wall seconds, printed as the "phase_seconds" line: what
    # to cut when the script nears its time limit.
    phase_seconds = {}

    def run(phase, *args):
        t = time.perf_counter()
        phase(*args)
        phase_seconds[phase.__name__[len("phase_"):]] = time.perf_counter() - t

    run(phase_kernels, dev, state)
    run(phase_kernels_large400, dev, state)
    run(phase_box, dev, state)
    run(phase_large, dev, state)
    run(phase_large400, dev, state)
    run(phase_walk_kernels, dev, state)
    run(phase_walk_frames, dev, state)
    run(phase_parity, dev, state)
    run(phase_scan, dev)
    run(phase_grad, dev, state)
    run(phase_grad_chunked, dev, state)
    run(phase_scan_graphs, dev, state)
    run(phase_grad_hbm, dev)
    run(phase_compat_frame, dev)
    run(phase_atlas_grad, dev)
    run(phase_recovery, dev)
    run(phase_oracle, dev)
    run(phase_native, dev, state)
    run(phase_ranks, dev)
    run(phase_torchrun, dev)
    run(phase_profile, dev)
    run(phase_bench)
    emit({"phase": "graphs", "block_iterations": W._CHECK_EVERY,
          "frames": GRAPH_FRAMES})
    emit({"phase": "grad_graphs", "gradients": GRAD_FRAMES})
    run(phase_timing, state)
    run(phase_walk_timing, state)
    emit({"phase": "phase_seconds", **phase_seconds})

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
    # The LBVH walks: counterparts of XLA loops, not of Pallas kernels; their
    # launches and times are from the 100k interior's walk frames.
    walk_frames = ("box_bvh", "box_bvh_perray", "large_bvh", "large_bvh_perray",
                   "large400_fallback")
    for name, src, site, frame, kind in (
            ("bvh_walk", "bvh_walk.cu", "119", "large_bvh_perray", "bvh_perray"),
            ("packet_walk", "packet_walk.cu", "176", "large_bvh", "bvh")):
        t = state["walk_time"][frame]
        by_frame = {f: state[f"walk_frame_{f}"]["launches"][name]
                    for f in walk_frames}
        check(by_frame[frame] > 0, f"{name} was not launched on frame {frame}")
        tb = state["walk_time"]["box_" + kind]
        row = {
            "name": name, "route": "cuda", "source": csrc + src,
            "replaces": "montecarlopathtracing_tpu/accel/lbvh.py:" + site,
            "launches": by_frame[frame],
            "max_abs_err": state["max_abs_err_walk"][kind], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None, "frame": frame,
            "ms_sampled_mean": t["ms_sampled_mean"], "ms_max": t["ms_max"],
            "bound_unfused_ms": t["bound_unfused_ms"],
            "node_tests_per_ray": t["node_tests_per_ray"],
            "tri_tests_per_ray": t["tri_tests_per_ray"],
            "launches_by_frame": by_frame, "ms_box": tb["ms"],
            "plain_ms_box": tb["plain_ms"], "bound_ms_box": tb["bound_ms"],
            "frame_seconds": state[f"walk_frame_{frame}"]["seconds"],
        }
        # Every design over every call of the walk's frames.
        for f, sfx in ((frame, ""), ("box_" + kind, "_box"),
                       ("large400_fallback", "_large400_fallback")):
            if kind == "bvh_perray" and f == "large400_fallback":
                continue  # a packet-walk frame
            des = state["walk_time"][f]["designs"]
            for design, prefix in (("package", ""), ("parent", "parent_"),
                                   ("redesign", "redesign_")):
                if design in des:
                    row.update({
                        prefix + "ms_all_calls" + sfx: des[design]["ms"],
                        prefix + "ms_all_calls_max" + sfx: des[design]["ms_max"]})
        if kind == "bvh":
            tf = state["walk_time"]["large400_fallback"]
            row.update(own_node_tests_per_ray=t["own_node_tests_per_ray"],
                       own_tri_tests_per_ray=t["own_tri_tests_per_ray"],
                       bound_own_tests_ms=t["bound_own_tests_ms"],
                       ms_large400_fallback=tf["ms"],
                       plain_ms_large400_fallback=tf["plain_ms"],
                       bound_ms_large400_fallback=tf["bound_ms"])
        rows.append(row)
    check(len(rows) == 7, f"kernels line: {len(rows)} rows")
    emit({"kernels": rows})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
