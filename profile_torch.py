#!/usr/bin/env python3
"""Profile one frame of the PyTorch port's forward main path on a CUDA card.

    python3 profile_torch.py                  # built-in box, 1024 x 1024
    python3 profile_torch.py --scene large    # 400k-triangle interior, 1280 x 720
    python3 profile_torch.py --scene large --large-mode hbm_always
    python3 profile_torch.py --scene large --tris 100000   # single-table plan
    python3 profile_torch.py --grad           # full-width gradient of the box

Renders the frame once unprofiled (wall time), then once under
torch.profiler, and prints one JSON line: wall seconds, wavefront
iterations, device busy time (sum of kernel times) and the idle share of
the unprofiled wall time, CUDA kernel launches per iteration, the ported
kernels' device time, the library sort kernels' device time, the
intersector plan, and the 12 top kernels and host
ops by time.  ``--large-mode`` is RenderOptions.large_mode: the default
"hbm" renders the 400k interior under the chunked plan, "hbm_always" under
the supergroup plan.

``--grad`` profiles the gradient of mean(image) over SceneParams instead, in
bench.py's backward configuration (the built-in box at 1024 x 1024, spp 16,
max_depth 32, 65,536 lanes, bwd_seg_per_sample 2.15): the forward pass (the
differentiable render) and the backward pass (block recomputes and autograd)
are timed and profiled apart, each with its ms per wavefront iteration, CUDA
kernels per iteration and device idle share.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

TOP = 12


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


def profile_grad(scene, opts) -> dict:
    """The full-width gradient: forward and backward, unprofiled, then each
    under torch.profiler with device activity only (with the host ops
    recorded too, the run outlasted a 600 s limit on an H100).  Prints a
    JSON line after each part."""
    from torch.profiler import ProfilerActivity, profile

    from montecarlopathtracing_torch.diff import gradients as G
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
    fwd_s, (loss, rays, leaves) = timed(forward)
    iters = K.launch_counts()["cluster_intersect"] - 1  # less the bootstrap
    bwd_s, _ = timed(lambda: G.param_grads(loss, leaves))
    del loss, leaves

    out = {"rays": rays, "iterations": iters, "forward_s": fwd_s,
           "backward_s": bwd_s, "fwd_bwd_rays_per_s": rays / (fwd_s + bwd_s),
           "backward_over_forward": bwd_s / fwd_s}
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
    ap.add_argument("--grad", action="store_true",
                    help="profile the full-width gradient of the box instead")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_torch: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch.profiler import ProfilerActivity, profile

    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.integrator.wavefront import (
        render_image_host_chunked, resolve_plan)
    from montecarlopathtracing_torch.kernels import cluster as K
    from montecarlopathtracing_torch.scene.builtin import (load_builtin_box,
                                                           load_builtin_large)

    if args.grad:
        scene, _ = load_builtin_box(width=1024, height=1024, device="cuda")
        opts = RenderOptions(spp=args.spp or 16, max_depth=32,
                             bwd_seg_per_sample=2.15)
        print(json.dumps({"grad": True, "scene": "box", "spp": opts.spp,
                          "device": torch.cuda.get_device_name(0),
                          **profile_grad(scene, opts)}), flush=True)
        return 0
    if args.scene == "box":
        scene, _ = load_builtin_box(width=1024, height=1024, device="cuda")
        spp = args.spp or 16
    else:
        scene, _ = load_builtin_large(n_tris=args.tris, width=1280, height=720,
                                      device="cuda")
        spp = args.spp or 4
    opts = RenderOptions(spp=spp, spp_chunk=spp, large_mode=args.large_mode)
    plan = resolve_plan(opts, scene.num_tris_padded)
    render_image_host_chunked(scene, None, opts.replace(spp=1, spp_chunk=1),
                              device="cuda")  # warm-up (kernel build, caches)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    render_image_host_chunked(scene, None, opts, device="cuda")
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0  # the same frame, not profiled

    K.reset_launch_counts()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        _, rays = render_image_host_chunked(scene, None, opts, device="cuda")
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # One intersect launch per iteration, plus the bootstrap.
    iters = max(K.launch_counts()[n] for n in (
        "cluster_intersect", "cluster_intersect_ftb", "cluster_intersect_hbm")) - 1

    busy_us, n_kernels, kernels, host_ops = kernel_stats(prof)
    # By kernel-name prefix: both key kernels, the single-table intersect
    # kernel, both front-to-back kernels; and every library sort kernel.
    ported = {name: sum(k[1] for k in kernels if name in k[0]) / 1e3
              for name in ("cluster_keys", "cluster_intersect_kernel",
                           "cluster_ftb")}
    sort_ms = sum(k[1] for k in kernels if "sort" in k[0].lower()) / 1e3
    print(json.dumps({
        "scene": args.scene, "spp": spp, "device": torch.cuda.get_device_name(0),
        "tris_padded": scene.num_tris_padded, "plan": list(plan),
        "wall_s": wall_plain, "wall_s_profiled": wall, "rays": rays,
        "iterations": iters, "device_busy_ms": busy_us / 1e3,
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
