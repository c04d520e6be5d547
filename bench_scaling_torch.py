#!/usr/bin/env python3
"""Scaling of the port's sharded render: seconds against rank count.

    python3 bench_scaling_torch.py                  # 1, 2, 4, ... ranks, one card each
    python3 bench_scaling_torch.py --device cpu     # gloo ranks on the CPU, 64 x 64

Counterpart of bench_scaling.py.  For each rank count n in 1, 2, 4, ... up
to ``torch.cuda.device_count()`` (2 on the CPU), n processes are started,
rank r on ``cuda:r`` with NCCL (gloo on the CPU), and each renders the
built-in box through
``parallel/mesh.py::render_image_sharded`` on an n x 1 (tile, spp) grid:
256 x 256 (64 x 64 on the CPU), spp 8, 16,384 lanes (bench_scaling.py:45-57).
Each rank count renders once to warm up, then --repeats times, each run
between a barrier and a synchronize on every rank; rank 0's seconds are
reported (the all-reduce ends every rank's render together).  Every image
must equal the one-rank image within tests/test_parallel.py:31's tolerance
(rtol 1e-5, atol 1e-6).

Prints one JSON line per rank count, then the summary with each count's
parallel efficiency against one rank (bench_scaling.py:77-86), the card's
nvidia-smi name and power limit, and exits non-zero if a rank or a check
fails.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import sys
import tempfile
import time

import torch

from montecarlopathtracing_torch.utils.device import nvidia_smi_line, resolve_device

RTOL, ATOL = 1e-5, 1e-6  # tests/test_parallel.py:31, the tile axis
SPP = 8
LANES = 16384
CPU_THREADS = 2  # per rank on the CPU
CPU_RANKS = 2  # the largest rank count on the CPU


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def worker(rank: int, world: int, port: int, device: str, size: int,
           repeats: int, out_dir: str) -> None:
    """One rank: warm-up render, then ``repeats`` timed renders; rank 0
    saves the image and its seconds."""
    import torch.distributed as dist

    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.parallel.mesh import (
        initialize_multihost, make_mesh, render_image_sharded)
    from montecarlopathtracing_torch.scene.builtin import load_builtin_box

    if device == "cuda":
        torch.cuda.set_device(rank)
        dev, backend = f"cuda:{rank}", "nccl"
    else:
        dev, backend = "cpu", "gloo"
        torch.set_num_threads(CPU_THREADS)  # ranks share the host's cores
    initialize_multihost(f"localhost:{port}", world, rank, backend=backend)
    multi = world > 1

    def sync():
        if device == "cuda":
            torch.cuda.synchronize(dev)

    scene, _ = load_builtin_box(width=size, height=size, device=dev)
    opts = RenderOptions(spp=SPP, chunk_size=LANES)
    mesh = make_mesh(tile=world, spp=1)
    render_image_sharded(scene, None, opts, mesh, device=dev)  # warm-up
    secs = []
    for _ in range(repeats):
        sync()
        if multi:
            dist.barrier()
        t0 = time.perf_counter()
        img = render_image_sharded(scene, None, opts, mesh, device=dev)
        sync()
        secs.append(time.perf_counter() - t0)
    if rank == 0:
        torch.save({"img": img.cpu(), "seconds": secs},
                   os.path.join(out_dir, "rank0.pt"))
    if multi:
        dist.destroy_process_group()


def run(n: int, device: str, size: int, repeats: int) -> dict:
    """n ranks, spawned here: rank 0's image and seconds."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as d:
        mp.start_processes(worker, args=(n, free_port(), device, size, repeats, d),
                           nprocs=n, join=True, start_method="spawn")
        return torch.load(os.path.join(d, "rank0.pt"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--repeats", type=int, default=3,
                    help="timed renders per rank count (default 3)")
    args = ap.parse_args(argv)
    resolve_device(args.device)  # raises without a card
    if args.device == "cuda":
        cap, size = torch.cuda.device_count(), 256
        info = {"device": torch.cuda.get_device_name(0),
                "nvidia_smi": nvidia_smi_line(), "backend": "nccl"}
    else:
        cap, size = CPU_RANKS, 64
        info = {"device": "cpu", "backend": "gloo"}
    sizes = [n for n in (1, 2, 4, 8, 16, 32, 64) if n <= cap]
    results, base_img = [], None
    for n in sizes:
        out = run(n, args.device, size, args.repeats)
        img, secs = out["img"], out["seconds"]
        if base_img is None:
            base_img = img
        ok = bool(torch.isfinite(img).all()) and bool(
            torch.allclose(img, base_img, rtol=RTOL, atol=ATOL))
        rec = {"ranks": n, "seconds": statistics.median(secs),
               "seconds_min": min(secs), "seconds_max": max(secs),
               "seconds_n": len(secs),
               "max_abs_diff_vs_1": float((img - base_img).abs().max())}
        print(json.dumps(rec), flush=True)
        if not ok:
            print(f"bench_scaling_torch: the {n}-rank image differs from the "
                  f"1-rank image beyond rtol {RTOL} / atol {ATOL}", file=sys.stderr)
            return 1
        results.append(rec)
    base = results[0]["seconds"]
    for r in results:
        r["efficiency"] = base / r["seconds"] / r["ranks"]
    print(json.dumps({"metric": "scaling efficiency vs 1 rank", "results": results,
                      "width": size, "height": size, "spp": SPP, "lanes": LANES,
                      "repeats": args.repeats, **info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
