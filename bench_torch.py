#!/usr/bin/env python3
"""Measure the PyTorch port end to end on one CUDA card: bench.py's stages.

    python3 bench_torch.py                     # every stage at bench.py's sizes
    python3 bench_torch.py --stages fwd,bwd,stats --size 256 --repeats 1
    python3 bench_torch.py --device cpu ...    # the plain versions (tests)

Stages, in this order, each through the port's own entry points with
bench.py's configurations (max_depth 32 throughout):

fwd         render_image_host_chunked on the built-in box at --size (1024)
            square, spp 16 in one dispatch (bench.py:92-103);
stats       kernels.cluster.candidate_stats, spp 2 (bench.py:156-162);
bwd         d mean(render_image_stats(apply_params(scene, params),
            differentiable=True)) / d SceneParams, bwd_seg_per_sample 2.15,
            a warm-up chunk at sample offset 0, timed chunks at offsets
            1 + k * spp_chunk (bench.py:105-154);
modern      render_image_host_chunked, spp 8, compat=MODERN (bench.py:164-183);
large       render_image_host_chunked on load_builtin_large(--large-tris) at
            1280 x 720, spp 4, the default plan (bench.py:216-243);
kernelfrac  one fwd frame under torch.profiler: the key and intersect
            kernels' device time over the device's busy time, and the device
            idle share of the unprofiled frame (bench.py:185-214).  It runs
            last: the frames timed after a profiled frame took 1.43x as long
            on the card (PERF.md section 6, PR 10).

Every forward frame (fwd, modern, large, kernelfrac) replays its lane
pool's blocks as CUDA graphs, captured anew in each dispatch and timed with
it, as every forward frame on the card does (integrator/wavefront.py::
_Blocks); so do both passes of the gradient (bwd): its forward blocks, and
its backward blocks, each a recompute and its VJP
(integrator/wavefront.py::_CheckpointedBlocks), captured anew in each pass.

Every stage starts from the same state: gc.collect() and
torch.cuda.empty_cache() run before it, and each stage's tensors are freed
when it ends.

Each timed stage runs once to warm up, then --repeats times; each run is
closed by torch.cuda.synchronize() at both ends, and each timing is reported
as its median under bench.py's key with ``_min``, ``_max`` and ``_n`` beside
it.  Rays are counted as bench.py counts them (bench.py:23-28: a compat
pixel's reused primary counts).  The headline ``value`` is the bwd stage's
fwd+bwd rays/s.  Scene loading, the kernel build, the checks and the CPU
reference renders stay outside every timed window.

Correctness (``correct``) is checked outside the timed windows: the fwd,
modern and large frames at 65,536, 65,536 and 8,192 pixel ids (every pixel
of a smaller frame) chosen from --seed
against the port's CPU render of exactly those ids (the same options and
sample offsets, the plain kernels); the gradient's fields finite and not all
zero, every chunk's ray count positive, and no key or intersect kernel
launched in the backward pass; the large scene's texture atlas non-empty.
A stage or check that fails prints its name and error on stderr and exits
non-zero without printing the metrics line.  Without a card and without
``--device cpu`` the script raises.  On the CPU no device metric (idle
share, kernel fraction, peak memory, share of the f32 peak) is reported:
they are listed under ``not_measured``.

Prints one JSON line: the metrics and their units, the card's nvidia-smi name
and power limit, and the seed.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import statistics
import sys
import time
import traceback

import numpy as np
import torch

from montecarlopathtracing_torch.config import MODERN, RenderOptions
from montecarlopathtracing_torch.diff.gradients import (
    PARAM_FIELDS, SceneParams, apply_params, param_grads)
from montecarlopathtracing_torch.integrator.wavefront import (
    render_image_host_chunked, render_image_stats, render_pixels,
    resolve_plan, spp_steps)
from montecarlopathtracing_torch.kernels import cluster as K
from montecarlopathtracing_torch.utils.device import nvidia_smi_line, resolve_device
from montecarlopathtracing_torch.utils.image_limit import (
    image_agreement, within_image_limit)

STAGES = ("fwd", "stats", "bwd", "modern", "large", "kernelfrac")

# NVIDIA H100 SXM, f32 outside the tensor cores (data sheet, 700 W): 67
# TFLOP/s counts a fused multiply-add as two operations.  The kernels are
# built with -fmad=false, so each counted operation is an instruction and
# the card does half that at most, as chip_smoke.py's unfused bounds count.
PEAK_F32_UNFUSED = 67e12 / 2
# bench.py:50-53's model: a candidate (cluster, subtile) pair costs 64 rays
# x the cluster's width x 34 f32 ops of the compat plane + sign test, and a
# ray takes cand_clusters_per_ray / 64 pairs: width x 34 ops per candidate.
OPS_PER_TEST = 34

# The key and intersect kernels by name (the chunked and supergroup plans'
# front-to-back kernels are cluster_ftb_*).
KEY_KERNELS = ("cluster_keys",)
TEST_KERNELS = ("cluster_intersect_kernel", "cluster_ftb")

CHECKED_STAGES = ("fwd", "modern", "large")
# Pixels of a frame held to the CPU's render of them: the box stages' CPU
# render of 65,536 pixels takes ~10 s on the card's host, the 400k
# interior's of 8,192 ~15 s (its plain intersector tests ~30 candidate
# clusters of 128 triangles a ray).
CHECK_PIXELS = 65536
LARGE_CHECK_PIXELS = 8192

UNITS = {
    "setup_seconds": "s", "build_seconds": "s",
    "fwd_seconds": "s", "fwd_rays_per_s": "rays/s", "fwd_rays": "rays",
    "fwdbwd_seconds": "s", "fwdbwd_rays_per_s": "rays/s", "fwdbwd_rays": "rays",
    "bwd_chunks": "gradient chunks", "bwd_over_fwd": "ratio",
    "bwd_launches_forward": "key and intersect launches",
    "bwd_launches_backward": "key and intersect launches",
    "bwd_peak_memory_bytes": "bytes", "bwd_peak_over_baseline_bytes": "bytes",
    "modern_seconds": "s", "modern_rays_per_s": "rays/s", "modern_rays": "rays",
    "large_scene_seconds": "s", "large_scene_rays_per_s": "rays/s",
    "large_scene_rays": "rays", "large_scene_tris": "triangles",
    "large_scene_tris_padded": "triangles", "large_scene_texels": "texels",
    "large_scene_load_seconds": "s",
    "cand_clusters_per_ray": "candidate clusters per ray subtile",
    "primary_cand": "candidate clusters per ray subtile",
    "bounce_cand": "candidate clusters per ray subtile",
    "cluster_width": "triangles per cluster",
    "test_kernel_ms": "ms", "key_kernel_ms": "ms", "device_busy_ms": "ms",
    "kernel_fraction": "fraction of device busy time",
    "device_idle_share": "fraction of the frame's wall time",
    "kernelfrac_frame_seconds": "s",
    "est_f32_peak_share": "fraction of 33.5e12 unfused f32 ops/s",
    **{f"{s}_check_{k}": u for s in CHECKED_STAGES for k, u in (
        ("pixels", "pixels"), ("outside_share", "fraction of checked pixels"),
        ("mean_rel_diff", "ratio"), ("channel_mean_rel_diff", "ratio"),
        ("max_abs_diff", "radiance"), ("seconds", "s"))},
}
DEVICE_ONLY = ("device_idle_share", "kernel_fraction", "test_kernel_ms",
               "key_kernel_ms", "device_busy_ms", "bwd_peak_memory_bytes",
               "bwd_peak_over_baseline_bytes", "est_f32_peak_share")


def unit_of(key: str):
    """The unit of a metric key (a spread's _min / _max share its key's)."""
    if key.endswith("_n"):
        return "runs"
    for sfx in ("_min", "_max"):
        if key.endswith(sfx) and key[:-len(sfx)] in UNITS:
            return UNITS[key[:-len(sfx)]]
    return UNITS.get(key)


class CheckFailed(AssertionError):
    """A correctness check of a stage failed."""


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


@dataclasses.dataclass(frozen=True)
class Bench:
    """How every stage runs: its device, timed runs and checks."""

    device: str = "cuda"
    repeats: int = 5
    seed: int = 0
    check_pixels: int = CHECK_PIXELS

    @property
    def cuda(self) -> bool:
        return torch.device(self.device).type == "cuda"

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()


def timed(fn, bench: Bench, warm=None):
    """``warm()`` (default ``fn()``) once, then ``fn()`` bench.repeats times,
    each between two synchronizes: (the last result, [seconds of each])."""
    (warm or fn)()
    out, secs = None, []
    for _ in range(bench.repeats):
        bench.sync()
        t0 = time.perf_counter()
        out = fn()
        bench.sync()
        secs.append(time.perf_counter() - t0)
    return out, secs


def spread(key: str, values) -> dict:
    values = list(values)
    return {key: statistics.median(values), key + "_min": min(values),
            key + "_max": max(values), key + "_n": len(values)}


# ---------------------------------------------------------------------------
# Correctness: the card's frame at chosen pixels against the CPU.

def check_ids(h: int, w: int, n: int, seed: int) -> np.ndarray:
    """``n`` distinct flat pixel ids of an h x w frame (all when n >= h*w),
    chosen from ``seed``, ascending."""
    n = min(n, h * w)
    return np.sort(np.random.default_rng(seed).choice(h * w, size=n,
                                                      replace=False))


def cpu_pixels(scene, opts: RenderOptions, ids) -> torch.Tensor:
    """The values render_image_host_chunked gives flat pixel ids ``ids``,
    rendered on the CPU with the plain kernels: the same dispatches
    (spp_steps) at the same sample offsets, each sample keyed by (pixel,
    absolute sample index), so the subset renders the frame's samples."""
    scene = scene.to("cpu")
    pix = torch.as_tensor(np.asarray(ids, np.int32))
    acc, done = None, 0
    for k in spp_steps(opts):
        rad, _ = render_pixels(scene, None, opts.replace(spp=k), pix,
                               sample_offset=done)
        acc = rad * k if acc is None else acc + rad * k
        done += k
    return acc / opts.spp


def frame_checks(img, scene, name: str) -> None:
    h, w = scene.camera.height, scene.camera.width
    check(tuple(img.shape) == (h, w, 3), f"{name}: image shape {tuple(img.shape)}")
    check(bool(torch.isfinite(img).all()), f"{name}: non-finite pixels")
    check(float(img.mean()) > 0.0, f"{name}: black image")


def pixel_check(img, scene, opts: RenderOptions, bench: Bench, name: str) -> dict:
    """Hold ``img`` (the frame of render_image_host_chunked) to the CPU's
    render of ``bench.check_pixels`` ids chosen from the seed, at PERF.md
    section 2's image limit.  Returns the agreement as ``<name>_check_*``
    keys."""
    t0 = time.perf_counter()
    frame_checks(img, scene, name)
    ids = check_ids(scene.camera.height, scene.camera.width, bench.check_pixels,
                    bench.seed)
    got = img.reshape(-1, 3)[torch.as_tensor(ids, device=img.device)].cpu().numpy()
    agree = image_agreement(got, cpu_pixels(scene, opts, ids))
    res = {f"{name}_check_{k}": v for k, v in agree.items()}
    res[f"{name}_check_seconds"] = time.perf_counter() - t0
    check(within_image_limit(agree),
          f"{name}: the frame disagrees with the CPU render at the checked "
          f"pixels: {res}")
    return res


# ---------------------------------------------------------------------------
# Stages.  Each takes a scene on bench.device and its options, and returns
# its metrics (every key has a unit: unit_of).

def frame_stage(name: str, key: str, scene, opts: RenderOptions,
                bench: Bench) -> dict:
    """A full frame through render_image_host_chunked, timed, then its
    pixel check."""
    (img, rays), secs = timed(
        lambda: render_image_host_chunked(scene, None, opts, device=bench.device),
        bench)
    return {**spread(f"{key}_seconds", secs),
            **spread(f"{key}_rays_per_s", [rays / s for s in secs]),
            f"{key}_rays": rays, **pixel_check(img, scene, opts, bench, name)}


def stage_fwd(scene, opts: RenderOptions, bench: Bench) -> dict:
    return frame_stage("fwd", "fwd", scene, opts, bench)


def stage_modern(scene, opts: RenderOptions, bench: Bench) -> dict:
    return frame_stage("modern", "modern", scene, opts, bench)


def stage_large(scene, opts: RenderOptions, bench: Bench) -> dict:
    texels = int(scene.atlas.shape[0])
    check(texels > 0, "large: the scene's texture atlas is empty")
    return {**frame_stage("large", "large_scene", scene, opts, bench),
            "large_scene_texels": texels,
            "large_scene_tris_padded": scene.num_tris_padded}


def stage_stats(scene, opts: RenderOptions, bench: Bench) -> dict:
    """Candidate clusters per ray subtile (the key kernel counts them on the
    card), and the plan's cluster width for est_f32_peak_share."""
    cand = K.candidate_stats(scene, opts)
    check(all(np.isfinite(v) for v in cand.values())
          and cand.get("primary_cand", 0.0) >= 1.0,
          f"stats: candidate_stats gave {cand}")
    return {"cand_clusters_per_ray": cand["candidates_per_ray"],
            "primary_cand": cand["primary_cand"],
            "bounce_cand": cand["bounce_cand"],
            "cluster_width": resolve_plan(opts, scene.num_tris_padded)[1]}


def stage_kernelfrac(scene, opts: RenderOptions, bench: Bench) -> dict:
    """One frame unprofiled (after a warm-up), then one under torch.profiler
    (device activity): the key and intersect kernels' device time, the
    device's busy time, and the idle share of the unprofiled frame.  On the
    CPU: nothing (no device to measure)."""
    if not bench.cuda:
        return {}
    from torch.profiler import ProfilerActivity, profile

    from profile_torch import kernel_stats

    def frame():
        return render_image_host_chunked(scene, None, opts, device=bench.device)

    _, secs = timed(frame, dataclasses.replace(bench, repeats=1))
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        frame()
        bench.sync()
    busy_us, _, kernels, _ = kernel_stats(prof)
    keys_ms = sum(k[1] for k in kernels if any(n in k[0] for n in KEY_KERNELS)) / 1e3
    test_ms = sum(k[1] for k in kernels if any(n in k[0] for n in TEST_KERNELS)) / 1e3
    check(busy_us > 0 and keys_ms > 0 and test_ms > 0,
          f"kernelfrac: no device time for the kernels ({keys_ms}, {test_ms} "
          f"of {busy_us / 1e3} ms)")
    return {"test_kernel_ms": test_ms, "key_kernel_ms": keys_ms,
            "device_busy_ms": busy_us / 1e3,
            "kernel_fraction": (test_ms + keys_ms) / (busy_us / 1e3),
            "device_idle_share": 1.0 - busy_us / 1e6 / secs[0],
            "kernelfrac_frame_seconds": secs[0]}


def stage_bwd(scene, opts: RenderOptions, bench: Bench) -> dict:
    """The gradient of the frame's mean over SceneParams, accumulated over
    ``opts.spp // opts.spp_chunk`` chunks of ``spp_chunk`` samples: a warm-up
    chunk at sample offset 0, then chunks at offsets 1 + k * spp_chunk
    (bench.py:111-152).  A chunk whose ray count is not positive (the static
    scan budget truncated its samples) raises."""
    dev = bench.device
    spp_chunk = max(1, min(opts.spp_chunk, opts.spp))
    copts = opts.replace(spp=spp_chunk)
    n_chunks = max(1, opts.spp // spp_chunk)
    params = SceneParams.from_scene(scene)
    launches = {}
    peaks = []

    def chunk(offset: int):
        K.reset_launch_counts()
        leaves = params.leaves(dev)
        img, rays = render_image_stats(apply_params(scene, leaves), None, copts,
                                       differentiable=True, sample_offset=offset,
                                       device=dev)
        rays = int(rays)
        check(rays > 0, f"bwd: the scan budget truncated the samples of the "
                        f"chunk at sample offset {offset} (rays {rays}); raise "
                        f"bwd_seg_per_sample ({copts.bwd_seg_per_sample})")
        launches["forward"] = K.launch_counts()
        K.reset_launch_counts()
        g = param_grads(img.mean(), leaves)
        launches["backward"] = K.launch_counts()
        check(not any(launches["backward"].values()),
              f"bwd: the backward pass launched key or intersect kernels: "
              f"{launches['backward']}")
        return g, rays

    def gradient():
        base = 0
        if bench.cuda:
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
        acc, rays = None, 0
        for k in range(n_chunks):
            g, r = chunk(1 + k * spp_chunk)
            acc = g if acc is None else acc.map(torch.add, g)
            rays += r
        if bench.cuda:
            peaks.append((torch.cuda.max_memory_allocated(), base))
        return acc, rays

    (g, rays), secs = timed(gradient, bench, warm=lambda: chunk(0))
    fields = [getattr(g, f) for f in PARAM_FIELDS]
    check(all(bool(torch.isfinite(t).all()) for t in fields),
          "bwd: non-finite gradients")
    check(any(bool((t != 0).any()) for t in fields), "bwd: every gradient is zero")
    n_fwd = sum(launches["forward"].values())
    if bench.cuda:
        check(launches["forward"]["cluster_keys"] > 0
              and launches["forward"]["cluster_intersect"] > 0,
              f"bwd: the forward pass launched no key or intersect kernel: "
              f"{launches['forward']}")
    res = {**spread("fwdbwd_seconds", secs),
           **spread("fwdbwd_rays_per_s", [rays / s for s in secs]),
           "fwdbwd_rays": rays, "bwd_chunks": n_chunks,
           "bwd_launches_forward": n_fwd,
           "bwd_launches_backward": sum(launches["backward"].values())}
    if peaks:
        res["bwd_peak_memory_bytes"] = max(p for p, _ in peaks)
        res["bwd_peak_over_baseline_bytes"] = max(p - b for p, b in peaks)
    return res


STAGE_FNS = {"fwd": stage_fwd, "stats": stage_stats, "bwd": stage_bwd,
             "modern": stage_modern, "large": stage_large,
             "kernelfrac": stage_kernelfrac}


def fresh_start(bench: Bench) -> None:
    """The state every stage starts from: the earlier stages' garbage
    collected and the allocator's cached blocks given back to the card."""
    gc.collect()
    if bench.cuda:
        torch.cuda.empty_cache()
        torch.cuda.synchronize()


def run_large(tris: int, opts: RenderOptions, bench: Bench) -> dict:
    """The large stage on load_builtin_large(tris), its load timed apart;
    the interior is freed on return."""
    from montecarlopathtracing_torch.scene.builtin import load_builtin_large

    t0 = time.perf_counter()
    scene, meta = load_builtin_large(tris, device=bench.device)
    bench.sync()
    load_s = time.perf_counter() - t0
    res = stage_large(scene, opts,
                      dataclasses.replace(bench, check_pixels=LARGE_CHECK_PIXELS))
    return {"large_scene_load_seconds": load_s,
            "large_scene_tris": int(meta.num_faces), **res}


# ---------------------------------------------------------------------------
# The command line.

def stage_options(args) -> dict:
    """Each stage's RenderOptions at bench.py's configurations."""
    base = dict(max_depth=32, chunk_size=args.chunk, seed=args.seed)
    fwd = RenderOptions(spp=args.spp, spp_chunk=args.spp, **base)
    return {
        "fwd": fwd, "kernelfrac": fwd,
        "stats": RenderOptions(spp=2, **base),
        "bwd": RenderOptions(spp=args.spp, spp_chunk=args.spp_chunk,
                             bwd_seg_per_sample=2.15, **base),
        "modern": RenderOptions(spp=8, spp_chunk=8, compat=MODERN, **base),
        "large": RenderOptions(spp=4, spp_chunk=4, **base),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--stages", default=",".join(STAGES),
                    help=f"comma-separated subset of {','.join(STAGES)}")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed runs of each stage after its warm-up (default 5)")
    ap.add_argument("--seed", type=int, default=0,
                    help="RenderOptions.seed and the checked pixels (default 0)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--spp", type=int, default=16, help="fwd and bwd spp (16)")
    ap.add_argument("--chunk", type=int, default=65536, help="lanes (65536)")
    ap.add_argument("--spp-chunk", type=int, default=16,
                    help="samples per gradient chunk (16)")
    ap.add_argument("--large-tris", type=int, default=400_000,
                    help="triangles of the large stage's interior (400000)")
    ap.add_argument("--size", type=int, default=1024,
                    help="width and height of the built-in box (1024)")
    ap.add_argument("--scene-dir", default=None,
                    help="load --scene from this directory instead of the "
                         "built-in box")
    ap.add_argument("--scene", default="cornell-box")
    args = ap.parse_args(argv)
    args.stages = [s for s in args.stages.split(",") if s]
    unknown = sorted(set(args.stages) - set(STAGES))
    if unknown:
        ap.error(f"unknown stages {unknown}; choose from {STAGES}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    dev = resolve_device(args.device)  # raises without a card
    bench = Bench(device=dev.type, repeats=args.repeats, seed=args.seed)
    opts = stage_options(args)
    out = {"spp": args.spp, "max_depth": 32, "seed": args.seed,
           "repeats": args.repeats, "stages": [s for s in STAGES if s in args.stages],
           "stage_start": "gc.collect(), torch.cuda.empty_cache()"}
    if bench.cuda:
        smi = nvidia_smi_line()
        out.update(device=torch.cuda.get_device_name(0), nvidia_smi=smi,
                   power_limit=smi.rsplit(",", 1)[-1].strip(),
                   count=torch.cuda.device_count(), torch=torch.__version__,
                   cuda=torch.version.cuda)
    else:
        out.update(device="cpu", torch=torch.__version__)
    metrics = {}
    stage = "setup"
    try:
        if bench.cuda:
            from montecarlopathtracing_torch.kernels import build as B

            t0 = time.perf_counter()
            B.build()
            metrics["build_seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if args.scene_dir:
            from montecarlopathtracing_torch.api import load_scene

            scene, _ = load_scene(args.scene_dir, args.scene, device=dev)
            out["scene"] = args.scene
        else:
            from montecarlopathtracing_torch.scene.builtin import load_builtin_box

            scene, _ = load_builtin_box(width=args.size, height=args.size,
                                        device=dev)
            out["scene"] = "builtin-box"
        bench.sync()
        metrics["setup_seconds"] = time.perf_counter() - t0
        out.update(width=scene.camera.width, height=scene.camera.height)
        for stage in out["stages"]:
            fresh_start(bench)
            if stage == "large":
                metrics.update(run_large(args.large_tris, opts["large"], bench))
            else:
                metrics.update(STAGE_FNS[stage](scene, opts[stage], bench))
        stage = "report"
        result = report(out, metrics, bench)
    except Exception as e:
        traceback.print_exc()
        print(f"bench_torch: {stage} failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    print(json.dumps(result), flush=True)
    return 0


def report(out: dict, metrics: dict, bench: Bench) -> dict:
    """The metrics line: headline, derived ratios, metrics and units."""
    if "fwdbwd_rays_per_s" in metrics:
        metric = ("box fwd+bwd rays/s (matched spp/depth; fwd-only in "
                  "fwd_rays_per_s)")
        value = metrics["fwdbwd_rays_per_s"]
    elif "fwd_rays_per_s" in metrics:
        metric, value = "box fwd rays/s (bwd stage not run)", metrics["fwd_rays_per_s"]
    else:
        metric, value = "no timed box stage run", None
    if "fwdbwd_rays_per_s" in metrics and "fwd_rays_per_s" in metrics:
        metrics["bwd_over_fwd"] = metrics["fwd_rays_per_s"] / metrics["fwdbwd_rays_per_s"]
    if bench.cuda and "fwd_rays_per_s" in metrics and "cand_clusters_per_ray" in metrics:
        # bench.py:455-460 with the plan's cluster width and the H100's peak.
        metrics["est_f32_peak_share"] = (
            metrics["fwd_rays_per_s"] * metrics["cand_clusters_per_ray"]
            * metrics["cluster_width"] * OPS_PER_TEST / PEAK_F32_UNFUSED)
    units = {k: unit_of(k) for k in metrics}
    missing = sorted(k for k, u in units.items() if u is None)
    check(not missing, f"metrics without a unit: {missing}")
    res = {"metric": metric, "value": value, "unit": "rays/s", **out,
           "correct": True, **metrics, "units": units}
    if not bench.cuda:
        res["not_measured"] = list(DEVICE_ONLY)
    return res


if __name__ == "__main__":
    sys.exit(main())
