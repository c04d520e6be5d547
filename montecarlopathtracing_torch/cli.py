"""Command-line entry point.

    python -m montecarlopathtracing_torch render scene/ cornell-box --spp 25
    python -m montecarlopathtracing_torch render scene/ box --device cpu
    python -m montecarlopathtracing_torch render scene/ box --profile trace/
    torchrun --nproc-per-node 2 -m montecarlopathtracing_torch render \
        scene/ box --mesh-tile 2 --mesh-spp 1
    python -m montecarlopathtracing_torch devices

``--mesh-tile`` / ``--mesh-spp`` render over a (tile, spp) grid of ranks
(parallel/mesh.py).  Under a launcher (torchrun) the world size, the rank and
the coordinator come from the environment (WORLD_SIZE, RANK, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT); without one the world is one process and only a
1 x 1 grid is accepted.  With at least one card per rank on the node the
ranks use NCCL, each on its own card; otherwise gloo (ranks sharing one
card, or the CPU).  Rank 0 writes the PNG.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="montecarlopathtracing_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("render", help="render a scene to PNG")
    r.add_argument("scene_dir")
    r.add_argument("name")
    r.add_argument("--spp", type=int, default=25)
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--out-dir", default="result")
    r.add_argument("--max-depth", type=int, default=32)
    r.add_argument("--chunk-size", type=int, default=65536)
    r.add_argument("--spp-chunk", type=int, default=0,
                   help="progressive accumulation chunk (0 = single pass)")
    r.add_argument("--checkpoint", default=None,
                   help="film checkpoint path for resume")
    r.add_argument("--intersector", default="auto",
                   choices=["auto", "cluster", "cluster_interpret", "bvh",
                            "bvh_perray", "brute"])
    r.add_argument("--modern", action="store_true",
                   help="fixed-quirks mode (AA jitter, uniform light sampling, "
                        "single receiver cosine, MT triangle test, ...)")
    r.add_argument("--gamma", action="store_true", help="gamma-2.2 tonemap")
    r.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cuda runs the CUDA kernels; cpu their plain versions")
    r.add_argument("--mesh-tile", type=int, default=0,
                   help="shard the render over a (tile, spp) device mesh")
    r.add_argument("--mesh-spp", type=int, default=1)
    r.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the render to "
                        "DIR/trace.json")

    sub.add_parser("devices", help="list CUDA devices")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "devices":
        import torch

        for i in range(torch.cuda.device_count()):
            print(f"cuda:{i} {torch.cuda.get_device_name(i)}")
        return 0

    import contextlib

    from .api import load_scene, render_progressive, render_scene
    from .config import MODERN, RenderOptions
    from .film.film import output_name, tonemap, write_png
    from .utils.timing import profiler_trace

    opts = RenderOptions(
        spp=args.spp, seed=args.seed, max_depth=args.max_depth,
        chunk_size=args.chunk_size, intersector=args.intersector,
        **({"compat": MODERN} if args.modern else {}),
    )

    base = os.path.join(args.scene_dir, args.name)
    for ext in (".obj", ".mtl", ".camera"):
        if not os.path.exists(base + ext):
            print(f"error: scene asset not found: {base + ext}", file=sys.stderr)
            return 2

    # The profiler covers every render entry point (single device,
    # --mesh-tile, --spp-chunk).
    profile_ctx = (profiler_trace(args.profile) if args.profile
                   else contextlib.nullcontext())

    if args.mesh_tile:
        return _render_mesh(args, opts, profile_ctx)

    if args.spp_chunk:
        opts = opts.replace(spp_chunk=args.spp_chunk)
        scene, _ = load_scene(args.scene_dir, args.name, opts, device=args.device)
        with profile_ctx:
            film = render_progressive(scene, opts, checkpoint_path=args.checkpoint,
                                      device=args.device)
        path = output_name(args.out_dir, args.name, args.spp)
        write_png(path, tonemap(film.mean, gamma=args.gamma))
        print(path)
        return 0

    with profile_ctx:
        _, path = render_scene(args.scene_dir, args.name, spp=args.spp,
                               options=opts, out_dir=args.out_dir,
                               gamma=args.gamma, device=args.device)
    print(path)
    return 0


def _render_mesh(args, opts, profile_ctx) -> int:
    """--mesh-tile: the sharded render on this rank; rank 0 writes the PNG."""
    import torch

    from .api import _walk_bvh, load_scene
    from .film.film import output_name, tonemap, write_png
    from .parallel.mesh import (initialize_multihost, make_mesh,
                                render_image_sharded)

    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    device = args.device
    backend = "gloo"
    if device == "cuda" and world > 1:
        local = int(os.environ.get("LOCAL_RANK", "0"))
        n_local = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        if torch.cuda.device_count() >= n_local:
            device, backend = f"cuda:{local}", "nccl"
        else:
            device = "cuda:0"
    if world > 1:
        initialize_multihost(
            f"{os.environ.get('MASTER_ADDR', 'localhost')}:"
            f"{os.environ.get('MASTER_PORT', '29500')}", world, rank, backend)
    try:
        mesh = make_mesh(tile=args.mesh_tile, spp=args.mesh_spp)
    except ValueError as exc:
        print(f"error: {exc} (launch {args.mesh_tile * args.mesh_spp} ranks, "
              "for example with torchrun)", file=sys.stderr)
        return 2
    scene, _ = load_scene(args.scene_dir, args.name, opts, device=device)
    with profile_ctx:
        img = render_image_sharded(scene, _walk_bvh(scene, opts, None), opts,
                                   mesh, device=device)
    if rank == 0:
        path = output_name(args.out_dir, args.name, args.spp)
        write_png(path, tonemap(img, gamma=args.gamma))
        print(path)
    if world > 1:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
