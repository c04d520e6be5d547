#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases, always all of them, one JSON line each (any failure raises and
exits non-zero):

1. device   the card's name and power limit (nvidia-smi);
2. build    both CUDA kernels compiled from kernels/csrc (one nvcc each,
            started together);
3. kernels  each kernel against its plain PyTorch version on the same CUDA
            tensors (keys, candidate lists, t and tri exactly equal), and the
            whole intersector against brute force: (a) the box table with
            random rays, a ragged count and one parked subtile, (b) the
            100k-triangle interior's table in compat and Moller-Trumbore
            mode, plus its camera and shadow rays at the main path's shape
            (131,072 rays);
4. box      api.render_scene on the built-in box at 1024 x 1024, spp 16;
5. large    the 100k-triangle interior at 1280 x 720, spp 4, through
            render_image_host_chunked;
            each of 4 and 5 renders its frame twice: once timed, with the
            launch counters, and once with the intersect calls recorded for
            phase 7;
6. parity   a 64 x 64 MODERN render on the card against the same render on
            the CPU (plain versions);
7. timing   every intersect call of the phase 4 and 5 frames replayed: each
            kernel and its plain version on the call's inputs, checked
            exactly equal and timed (CUDA events, device time only), with
            its bound;
8. a "kernels" line per ported kernel, then the card's nvidia-smi line, then
   the last line {"ok": true, "device": {...}}.

Launch counters are zeroed just before the timed render of phases 4 and 5
and read just after; the recording renders and the replays of phase 7 come
after and are not counted.
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

def camera_and_shadow_rays(scene, n_lanes: int, seed: int):
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
    hit, t, _ = intersect_any(scene, None, o, d, RenderOptions())
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


def compare_kernels(scene, accel, origin, direction, mt: bool, tile: int,
                    label: str):
    """exact_match, then the whole intersector vs brute force under the test
    suite's contract (hit mask exact, t within rtol 1e-4, tri equal on at
    least 99% of hits: ids may differ only at equal-t ties)."""
    from montecarlopathtracing_torch.accel.lbvh import brute_force_intersect
    from montecarlopathtracing_torch.kernels import cluster as K

    res = exact_match(accel, origin, direction, mt, tile, label)
    hc, tc, ic = K.cluster_intersect(accel, origin, direction, tile=tile, mt=mt)
    hb, tb, ib = brute_force_intersect(scene, origin, direction, compat=not mt)
    check(torch.equal(hb, hc), f"{label}: hit mask differs from brute force")
    ok = hb
    err = torch.abs(tb[ok] - tc[ok])
    check(bool((err <= 1e-5 + 1e-4 * torch.abs(tc[ok])).all()),
          f"{label}: t differs from brute force beyond rtol 1e-4")
    diff = ok & (ib != ic)
    check(float(diff.sum()) <= 0.01 * max(1, int(ok.sum())),
          f"{label}: tri differs from brute force on more than 1% of hits")
    return {**res, "hits": int(hb.sum()), "tri_ties": int(diff.sum())}


def bounds(rays_n: int, tile: int, c: int, width: int, ray_cols: int,
           live_subtiles: int, cand_pairs: int):
    """Least time (ms) for each kernel's work on these inputs: the larger of
    bytes over HBM bandwidth and f32 operations over the f32 peak."""
    n_sub = rays_n // tile
    key_bytes = 4 * (rays_n * 8 + 8 * c + n_sub * c + n_sub + cand_pairs)
    key_ops = OPS_KEY_PAIR * live_subtiles * tile * c
    isect_bytes = 4 * (rays_n * ray_cols + n_sub + cand_pairs
                       + c * 16 * width + 2 * rays_n)
    isect_ops = OPS_TRI_PAIR * tile * width * cand_pairs
    out = {}
    for name, b, o in (("cluster_keys", key_bytes, key_ops),
                       ("cluster_intersect", isect_bytes, isect_ops)):
        tb, to = b / PEAK_BYTES * 1e3, o / PEAK_F32 * 1e3
        out[name] = {"bound_ms": max(tb, to),
                     "bound_by": "bytes" if tb >= to else "operations",
                     "bytes": b, "ops": o}
    return out


def sleep_ms() -> float:
    """Device time of one torch.cuda._sleep(SLEEP_CYCLES), in ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def timed(fn, sleep: float):
    """(ms, host_outlasted_sleep, result) of one call, by CUDA events around
    it.  The stream sleeps first, so the start event is stamped only after
    the host has enqueued the call, and the window holds device time rather
    than the wrapper's host work.  The flag is set where the host took
    longer than the sleep (``sleep`` ms), so some host time may be inside.
    A call that synchronises inside (the plain versions do) still counts
    its host time after the sync."""
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
    host_late = {"cluster_keys": 0, "cluster_intersect": 0}
    for acc, origin, direction, mt in calls:
        o, d = pad_rays(origin, direction, tile)
        rays = K.pack_rays(o, d)
        caabb = K._caabb(acc.cmin, acc.cmax)
        ms1, late1, (keys, counts, ids) = timed(
            lambda: K.cluster_keys(rays, caabb, tile), sleep)
        pm1, _, (keys_p, counts_p, ids_p) = timed(
            lambda: K.cluster_keys_plain(rays, caabb, tile), sleep)
        used = (torch.arange(ids.shape[1], device=ids.device)[None, :]
                < counts[:, None])
        check(torch.equal(keys, keys_p) and torch.equal(counts, counts_p)
              and torch.equal(torch.where(used, ids, -1),
                              torch.where(used, ids_p, -1)),
              f"{label}: keys differ from the plain version on a frame call")
        rays_i = K.pack_rays(o, d, mt=True) if mt else rays
        ms2, late2, (bt, bi) = timed(lambda: K.cluster_intersect_padded(
            rays_i, counts, ids, acc.tconst, tile, mt), sleep)
        pm2, _, (bt_p, bi_p) = timed(lambda: K.cluster_intersect_padded_plain(
            rays_i, counts, ids, acc.tconst, tile, mt), sleep)
        host_late["cluster_keys"] += late1
        host_late["cluster_intersect"] += late2
        check(torch.equal(bt, bt_p) and torch.equal(bi, bi_p),
              f"{label}: intersect differs from the plain version on a frame call")
        live = int((torch.amin(rays[:, 0].reshape(-1, tile), dim=1) <= 5e8).sum())
        n_pairs = int(counts.sum())
        pairs.append(n_pairs)
        b = bounds(rays.shape[0], tile, acc.num_clusters, acc.width,
                   rays_i.shape[1], live, n_pairs)
        rows["cluster_keys"].append((ms1, pm1, b["cluster_keys"]))
        rows["cluster_intersect"].append((ms2, pm2, b["cluster_intersect"]))
    out = {}
    for name, r in rows.items():
        n = len(r)
        to = sum(x[2]["ops"] for x in r) / PEAK_F32 * 1e3
        tb = sum(x[2]["bytes"] for x in r) / PEAK_BYTES * 1e3
        out[name] = {"ms": sum(x[0] for x in r) / n,
                     "ms_max": max(x[0] for x in r),
                     "plain_ms": sum(x[1] for x in r) / n,
                     "bound_ms": sum(x[2]["bound_ms"] for x in r) / n,
                     "bound_by": "bytes" if tb >= to else "operations",
                     "calls": n, "host_outlasted_sleep": host_late[name]}
    emit({"phase": "kernel_time", "case": label, "calls": len(pairs),
          "rays_per_call_max": max(int(c[1].shape[0]) for c in calls),
          "clusters": calls[0][0].num_clusters, "width": calls[0][0].width,
          "candidate_pairs_mean": sum(pairs) / len(pairs),
          "candidate_pairs_max": max(pairs), "sleep_ms": sleep, **out})
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
    emit({"phase": "kernels", "ok": True, "cases": results})
    state["max_abs_err"] = {
        "cluster_keys": max(r["keys_max_abs_err"] for r in results),
        "cluster_intersect": max(r["t_max_abs_err"] for r in results)}


def phase_timing(state):
    """Each kernel's time per launch and its plain version's, replayed over
    every intersect call of the phase-4 and phase-5 frames."""
    for label in ("box", "large"):
        calls = state.pop(f"calls_{label}")
        state[f"time_{label}"] = frame_kernel_stats(calls, 64, label)
        del calls
        torch.cuda.empty_cache()


def image_checks(img, label: str):
    check(tuple(img.shape[2:]) == (3,), f"{label}: image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), f"{label}: non-finite pixels")
    mean = float(img.mean())
    check(mean > 0.0, f"{label}: black image")
    return mean


class CaptureCall:
    """Wraps the intersector the wavefront calls and keeps the inputs of every
    call (the combined [arrivals; shadow rays] batches), so the kernels can
    be replayed on a real frame.  Calls pass through unchanged.  The
    wavefront builds fresh ray tensors for each call, so references are kept,
    not copies.  Used only on a second, untimed render of a frame."""

    def __init__(self):
        from montecarlopathtracing_torch.integrator import wavefront

        self.module, self.calls = wavefront, []
        self.inner = wavefront.cluster_intersect

    def __enter__(self):
        self.module.cluster_intersect = self
        return self

    def __exit__(self, *exc):
        self.module.cluster_intersect = self.inner

    def __call__(self, accel, origin, direction, **kw):
        self.calls.append((accel, origin, direction, kw.get("mt", False)))
        return self.inner(accel, origin, direction, **kw)


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
        check(all(v > 0 for v in launches.values()),
              f"box: a kernel was not launched on the main path: {launches}")
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
    check(all(v > 0 for v in launches.values()),
          f"large: a kernel was not launched on the main path: {launches}")
    mean = image_checks(img, "large")
    state["launches_large"] = launches
    emit({"phase": "large", "width": 1280, "height": 720, "spp": 4,
          "tris_padded": scene.num_tris_padded, "clusters": 1024,
          "cluster_width": 128, "materials": scene.num_materials,
          "textured": int(scene.atlas.shape[0] > 0), "seconds": secs,
          "load_seconds": state["large_load_s"], "rays": rays,
          "rays_per_s": rays / secs, "mean": mean, "launches": launches})


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
    phase_box(dev, state)
    phase_large(dev, state)
    phase_parity(dev, state)
    phase_timing(state)

    rows = []
    replaces = {
        "cluster_keys": ("montecarlopathtracing_torch/kernels/csrc/cluster_keys.cu",
                         "montecarlopathtracing_tpu/kernels/cluster.py:167"),
        "cluster_intersect": ("montecarlopathtracing_torch/kernels/csrc/cluster_intersect.cu",
                              "montecarlopathtracing_tpu/kernels/cluster.py:351"),
    }
    for name, (src, rep) in replaces.items():
        t = state["time_large"][name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": state["launches_box"][name],
            "launches_large": state["launches_large"][name],
            "max_abs_err": state["max_abs_err"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "ms_max": t["ms_max"],
            "ms_box": state["time_box"][name]["ms"],
            "plain_ms_box": state["time_box"][name]["plain_ms"],
            "bound_ms_box": state["time_box"][name]["bound_ms"],
        })
    emit({"kernels": rows})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
