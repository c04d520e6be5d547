#!/usr/bin/env python3
"""Profile one frame of the PyTorch port's forward main path on a CUDA card.

    python3 profile_torch.py                  # built-in box, 1024 x 1024
    python3 profile_torch.py --scene large    # 400k-triangle interior, 1280 x 720
    python3 profile_torch.py --scene large --large-mode hbm_always
    python3 profile_torch.py --scene large --tris 100000   # single-table plan
    python3 profile_torch.py --grad           # full-width gradient of the box
    python3 profile_torch.py --grad --scene large   # the 400k interior's gradient
    python3 profile_torch.py --intersector bvh_perray --scene large --tris 100000
    python3 profile_torch.py --eager          # the same frame, op by op
    python3 profile_torch.py --scan [--grad] [--eager] [--spp N]   # the scan renderer

Renders the frame once unprofiled (wall time), then once under
torch.profiler, and prints one JSON line: wall seconds, wavefront
iterations, device busy time (sum of kernel times) and the idle share of
the unprofiled wall time, CUDA kernel launches per iteration, the ported
kernels' device time, the library sort kernels' device time, the
intersector plan, the lane pool's CUDA graphs (captured, replayed, seconds
to capture and instantiate; integrator/wavefront.py::loop_stats), and the
12 top kernels and host ops by time.  The frame replays its blocks as CUDA
graphs, as every forward frame on the card does; ``--eager`` renders it
under ``wavefront.eager()``, one launch per op, to compare the two.  ``--large-mode`` is RenderOptions.large_mode: the default
"hbm" renders the 400k interior under the chunked plan, "hbm_always" under
the supergroup plan.  ``--intersector`` is RenderOptions.intersector: "bvh"
and "bvh_perray" render the frame through the packet walk or the per-ray
walk (iterations then count the walk's launches).

``--grad`` profiles the gradient of mean(image) over SceneParams instead, in
bench.py's backward configuration (the built-in box at 1024 x 1024, spp 16,
max_depth 32, 65,536 lanes, bwd_seg_per_sample 2.15; with ``--scene
large`` the interior at 1280 x 720, spp 4, bwd_seg_per_sample 4): the
forward pass (the differentiable render) and the backward pass (block recomputes and their
VJPs) are timed and profiled apart, each with its ms per wavefront
iteration, CUDA kernels per iteration, device idle share, the device ms of
its matrix-product kernels (``matmul_ms``: in backward the material rows'
one-hot products, _TableRows.backward) and its blocks,
graphs, replays and capture seconds (integrator/wavefront.py::
grad_loop_stats).  Both passes replay CUDA graphs, as every gradient on the
card does; with ``--eager`` both run op by op.

``--scan`` profiles the scan renderer (``refill=False``) on the box at 1024
x 1024, spp 16, max_depth 32, 65,536 lanes, compat: the frame, or with
``--grad`` its gradient of mean(image).  The whole frame (or gradient) is
timed unprofiled; one chunk of its pixel ids (65,536 lanes, the width of
every chunk) at spp 2 is timed unprofiled and then profiled, with device
activity only (the whole frame launches ~4M kernels, its gradient ~20M).
Times and kernels are per segment, a bounce of the wavefront or a sample's
primary block (integrator/wavefront.py::scan_stats: samples + bounces):
the device ms and kernels from the chunk's profile, the wall ms of the
chunk and of the whole frame, and the device idle share of the whole frame
as 1 - device ms / wall ms a segment (the chunk's own wall time holds its
graphs' captures).  The graphs, replays, capture seconds and idle bounces
past the drain are the scan renderer's, and each run's peak of allocated
bytes over the allocation before it; a gradient's backward pass recomputes
each sample and holds one sample's residual copies (``residual_bytes``).
``--spp`` sets the frame's samples (16 by default).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import sys
import time

import torch

TOP = 12
# The lane pool's segments a sample budgeted in the interior's gradient (as
# chip_smoke.py's LARGE400_SEG): no sample is dropped.
LARGE_SEG = 4.0
# The intersect kernels of the cluster plans: one launch an iteration.
ISECT_KERNELS = ("cluster_intersect", "cluster_intersect_ftb",
                 "cluster_intersect_hbm")
# Matrix-product kernels by name (cuBLAS / CUTLASS); in a gradient's
# backward pass the material rows' one-hot products (_TableRows.backward).
MATMUL = re.compile(r"gemm|xmma|cutlass", re.IGNORECASE)


def kernel_stats(prof):
    """(device busy us, CUDA kernel count, [(name, us, count)] by time,
    [(host op, us, count)] by time) of a finished torch.profiler run."""
    events = prof.key_averages()
    dev_attr = ("device_time_total" if hasattr(events[0], "device_time_total")
                else "cuda_time_total")
    kernels, host_ops = [], []
    for e in events:
        dt = getattr(e, dev_attr, 0) or 0
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels.append((e.key, dt, e.count))
        elif e.key.startswith("aten::"):
            host_ops.append((e.key, e.cpu_time_total, e.count))
    kernels.sort(key=lambda k: -k[1])
    host_ops.sort(key=lambda k: -k[1])
    return (sum(k[1] for k in kernels), sum(k[2] for k in kernels), kernels,
            host_ops)


SCAN_WINDOW_SPP = 2


def scan_segments(stats) -> int:
    """The scan renderer's segments in a forward pass: a primary block a
    sample and every bounce."""
    return stats["samples"] + stats["bounces"]


def profile_scan(scene, opts, grad: bool) -> dict:
    """The scan renderer's frame (or, with ``grad``, its gradient) whole and
    unprofiled, then one chunk at spp 2 unprofiled and profiled, each pass
    apart (see the module docstring).  Prints a JSON line after each
    part."""
    from torch.profiler import ProfilerActivity, profile

    from montecarlopathtracing_torch.diff import gradients as G
    from montecarlopathtracing_torch.integrator import wavefront as W

    ids = W._frame_ids(scene, opts)[0][:opts.chunk_size]
    window_opts = opts.replace(spp=SCAN_WINDOW_SPP)

    def forward(window: bool):
        leaves = G.SceneParams.from_scene(scene).leaves("cuda") if grad else None
        sc = G.apply_params(scene, leaves) if grad else scene
        if window:
            img, rays = W.render_pixels(sc, None, window_opts, ids,
                                        differentiable=grad)
        else:
            img, rays = W.render_image_stats(sc, None, opts, differentiable=grad,
                                             device="cuda")
        return img.mean(), int(rays), leaves

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, res

    def run(window: bool) -> dict:
        """Seconds of each pass, rays, the peak of allocated bytes over the
        allocation before the forward pass, scan_stats."""
        W.reset_loop_stats()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        secs, (loss, rays, leaves) = timed(lambda: forward(window))
        out = {"forward_s": secs, "rays": rays}
        if grad:
            out["backward_s"] = timed(lambda: G.param_grads(loss, leaves))[0]
        del loss, leaves
        out["peak_bytes_over_baseline"] = torch.cuda.max_memory_allocated() - base
        return {**out, **W.scan_stats()}

    run(True)  # warm-up: the kernels' build and first loads
    out = {"frame": run(False), "window": run(True)}
    out["frame"]["segments"] = scan_segments(out["frame"])
    segments = out["window"]["segments"] = scan_segments(out["window"])
    print(json.dumps({"part": "unprofiled", **out}), flush=True)
    acts = [ProfilerActivity.CUDA]
    with profile(activities=acts, acc_events=True) as prof:
        loss, _, leaves = forward(True)
        torch.cuda.synchronize()
    parts = [("forward", prof)]
    if grad:
        with profile(activities=acts, acc_events=True) as prof:
            G.param_grads(loss, leaves)
            torch.cuda.synchronize()
        parts.append(("backward", prof))
    for name, prof in parts:
        wall = out["window"][f"{name}_s"]
        busy_us, n_kernels, kernels, _ = kernel_stats(prof)
        out[name] = {
            "ms_per_segment": wall * 1e3 / segments,
            "frame_ms_per_segment": (out["frame"][f"{name}_s"] * 1e3
                                     / out["frame"]["segments"]),
            "device_busy_ms": busy_us / 1e3,
            "device_ms_per_segment": busy_us / 1e3 / segments,
            "window_idle_share": 1.0 - busy_us / 1e6 / wall,
            "cuda_kernels": n_kernels,
            "cuda_kernels_per_segment": n_kernels / segments,
            "top_kernels_ms": [(k[0][:80], k[1] / 1e3, k[2]) for k in kernels[:TOP]],
        }
        out[name]["device_idle_share"] = 1.0 - (
            out[name]["device_ms_per_segment"] / out[name]["frame_ms_per_segment"])
        print(json.dumps({"part": name, **out[name]}), flush=True)
    return out


def profile_grad(scene, opts) -> dict:
    """The full-width gradient: forward and backward, unprofiled, then each
    under torch.profiler with device activity only (with the host ops
    recorded too, the run outlasted a 600 s limit on an H100).  Prints a
    JSON line after each part."""
    from torch.profiler import ProfilerActivity, profile

    from montecarlopathtracing_torch.diff import gradients as G
    from montecarlopathtracing_torch.integrator import wavefront as W
    from montecarlopathtracing_torch.integrator.wavefront import render_image_stats
    from montecarlopathtracing_torch.kernels import cluster as K

    params = G.SceneParams.from_scene(scene)

    def forward():
        leaves = params.leaves("cuda")
        img, rays = render_image_stats(G.apply_params(scene, leaves), None, opts,
                                       differentiable=True, device="cuda")
        return img.mean(), int(rays), leaves

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    # Warm-up, then the same gradient unprofiled for the wall times.
    loss, _, leaves = forward()
    G.param_grads(loss, leaves)
    K.reset_launch_counts()
    W.reset_loop_stats()
    fwd_s, (loss, rays, leaves) = timed(forward)
    # One intersect launch an iteration, less the bootstrap's.
    iters = max(K.launch_counts()[k] for k in ISECT_KERNELS) - 1
    bwd_s, _ = timed(lambda: G.param_grads(loss, leaves))
    loop = W.grad_loop_stats()
    del loss, leaves

    out = {"rays": rays, "iterations": iters, "forward_s": fwd_s,
           "backward_s": bwd_s, "fwd_bwd_rays_per_s": rays / (fwd_s + bwd_s),
           "backward_over_forward": bwd_s / fwd_s, "blocks": loop["blocks"],
           **{f"{p}_{k}": loop[f"{p}_{k}"] for p in ("fwd", "bwd")
              for k in ("eager_blocks", "graphs", "replays", "capture_s")}}
    print(json.dumps({"part": "unprofiled", **out}), flush=True)

    def report(name, prof, wall):
        busy_us, n_kernels, kernels, _ = kernel_stats(prof)
        out[name] = {
            "ms_per_iteration": wall * 1e3 / iters,
            "device_busy_ms": busy_us / 1e3,
            "device_ms_per_iteration": busy_us / 1e3 / iters,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "cuda_kernels": n_kernels,
            "cuda_kernels_per_iteration": n_kernels / iters,
            "matmul_ms": sum(k[1] for k in kernels
                             if MATMUL.search(k[0])) / 1e3,
            "top_kernels_ms": [(k[0][:80], k[1] / 1e3, k[2]) for k in kernels[:TOP]],
        }
        print(json.dumps({"part": name, **out[name]}), flush=True)

    acts = [ProfilerActivity.CUDA]
    with profile(activities=acts, acc_events=True) as prof:
        loss, _, leaves = forward()
        torch.cuda.synchronize()
    report("forward", prof, fwd_s)
    with profile(activities=acts, acc_events=True) as prof:
        G.param_grads(loss, leaves)
        torch.cuda.synchronize()
    report("backward", prof, bwd_s)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=["box", "large"], default="box")
    ap.add_argument("--spp", type=int, default=None,
                    help="samples per pixel (default 16 box, 4 large)")
    ap.add_argument("--tris", type=int, default=400_000,
                    help="triangles of --scene large (default 400000)")
    ap.add_argument("--large-mode", default="hbm",
                    choices=["hbm", "hbm_always", "chunked"],
                    help="RenderOptions.large_mode (default hbm)")
    ap.add_argument("--intersector", default="auto",
                    choices=["auto", "bvh", "bvh_perray"],
                    help="RenderOptions.intersector (default auto)")
    ap.add_argument("--grad", action="store_true",
                    help="profile the full-width gradient of --scene instead")
    ap.add_argument("--eager", action="store_true",
                    help="run the blocks op by op (wavefront.eager()), "
                         "the frame or both passes of --grad")
    ap.add_argument("--scan", action="store_true",
                    help="the scan renderer (refill=False) on the box: the "
                         "frame, or with --grad its gradient")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch.profiler import ProfilerActivity, profile

    from montecarlopathtracing_torch.accel import lbvh as L
    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.integrator import wavefront as W
    from montecarlopathtracing_torch.integrator.wavefront import (
        render_image_host_chunked, resolve_plan)
    from montecarlopathtracing_torch.kernels import cluster as K
    from montecarlopathtracing_torch.scene.builtin import (load_builtin_box,
                                                           load_builtin_large)
    from montecarlopathtracing_torch.utils.device import nvidia_smi_line

    mode = W.eager() if args.eager else contextlib.nullcontext()
    if args.scan:
        scene, _ = load_builtin_box(width=1024, height=1024, device="cuda")
        opts = RenderOptions(spp=args.spp or 16, max_depth=32, refill=False)
        with mode:
            res = profile_scan(scene, opts, args.grad)
        print(json.dumps({"scan": True, "grad": args.grad, "scene": "box",
                          "spp": opts.spp, "eager": args.eager,
                          "device": torch.cuda.get_device_name(0),
                          "nvidia_smi": nvidia_smi_line(), **res}), flush=True)
        return 0
    if args.grad:
        if args.scene == "box":
            scene, _ = load_builtin_box(width=1024, height=1024, device="cuda")
            opts = RenderOptions(spp=args.spp or 16, max_depth=32,
                                 bwd_seg_per_sample=2.15)
        else:
            scene, _ = load_builtin_large(n_tris=args.tris, width=1280,
                                          height=720, device="cuda")
            opts = RenderOptions(spp=args.spp or 4, max_depth=32,
                                 large_mode=args.large_mode,
                                 bwd_seg_per_sample=LARGE_SEG)
        with mode:
            res = profile_grad(scene, opts)
        print(json.dumps({"grad": True, "scene": args.scene, "spp": opts.spp,
                          "eager": args.eager,
                          "device": torch.cuda.get_device_name(0),
                          "nvidia_smi": nvidia_smi_line(), **res}), flush=True)
        return 0
    if args.scene == "box":
        scene, _ = load_builtin_box(width=1024, height=1024, device="cuda")
        spp = args.spp or 16
    else:
        scene, _ = load_builtin_large(n_tris=args.tris, width=1280, height=720,
                                      device="cuda")
        spp = args.spp or 4
    opts = RenderOptions(spp=spp, spp_chunk=spp, large_mode=args.large_mode,
                         intersector=args.intersector)
    plan = resolve_plan(opts, scene.num_tris_padded)
    with mode:
        render_image_host_chunked(scene, None, opts.replace(spp=1, spp_chunk=1),
                                  device="cuda")  # warm-up (kernel build, caches)
        torch.cuda.synchronize()
        W.reset_loop_stats()
        t0 = time.perf_counter()
        render_image_host_chunked(scene, None, opts, device="cuda")
        torch.cuda.synchronize()
        wall_plain = time.perf_counter() - t0  # the same frame, not profiled
        loop = W.loop_stats()

        K.reset_launch_counts()
        L.reset_launch_counts()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            _, rays = render_image_host_chunked(scene, None, opts, device="cuda")
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    iters = loop["iterations"]
    # One intersect launch per iteration, plus the bootstrap.
    launches = max([K.launch_counts()[n] for n in (
        "cluster_intersect", "cluster_intersect_ftb", "cluster_intersect_hbm")]
                   + list(L.launch_counts().values()))
    if launches != iters + 1:
        raise RuntimeError(f"{launches} intersect launches for {iters} iterations")

    busy_us, n_kernels, kernels, host_ops = kernel_stats(prof)
    # By kernel-name prefix: both key kernels, the single-table intersect
    # kernel, both front-to-back kernels, the per-ray walk and the packet
    # walk's two kernels; and every library sort kernel.
    ported = {name: sum(k[1] for k in kernels if name in k[0]) / 1e3
              for name in ("cluster_keys", "cluster_intersect_kernel",
                           "cluster_ftb", "bvh_walk_kernel", "walk_thread_per_ray",
                           "walk_rays_per_thread")}
    sort_ms = sum(k[1] for k in kernels if "sort" in k[0].lower()) / 1e3
    print(json.dumps({
        "scene": args.scene, "spp": spp, "intersector": args.intersector,
        "eager": args.eager, "device": torch.cuda.get_device_name(0),
        "nvidia_smi": nvidia_smi_line(),
        "tris_padded": scene.num_tris_padded, "plan": list(plan),
        "wall_s": wall_plain, "wall_s_profiled": wall, "rays": rays,
        "iterations": iters, "idle_iterations": loop["idle_iterations"],
        "graphs": loop["graphs"], "replays": loop["replays"],
        "capture_s": loop["capture_s"], "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall_plain,
        "cuda_kernels": n_kernels,
        "cuda_kernels_per_iteration": n_kernels / max(iters, 1),
        "ms_per_iteration": wall_plain * 1e3 / max(iters, 1),
        "device_ms_per_iteration": busy_us / 1e3 / max(iters, 1),
        "ported_kernels_ms": ported, "sort_kernels_ms": sort_ms,
        "top_kernels_ms": [(k[0][:80], k[1] / 1e3, k[2]) for k in kernels[:TOP]],
        "top_host_ops_ms": [(k[0], k[1] / 1e3, k[2]) for k in host_ops[:TOP]],
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
