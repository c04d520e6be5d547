"""Command-line entry point.

    python -m montecarlopathtracing_torch render scene/ cornell-box --spp 25
    python -m montecarlopathtracing_torch render scene/ box --device cpu
    python -m montecarlopathtracing_torch devices
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
                   help="write a device trace of the render")

    sub.add_parser("devices", help="list CUDA devices")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cmd == "devices":
        import torch

        for i in range(torch.cuda.device_count()):
            print(f"cuda:{i} {torch.cuda.get_device_name(i)}")
        return 0

    if args.mesh_tile:
        raise NotImplementedError(
            "--mesh-tile: multi-device rendering is not ported yet "
            "(ROADMAP.md item A14)")
    if args.profile:
        raise NotImplementedError(
            "--profile is not ported yet (ROADMAP.md item A16); "
            "profile_torch.py profiles a frame")

    from .api import load_scene, render_progressive, render_scene
    from .config import MODERN, RenderOptions
    from .film.film import output_name, tonemap, write_png

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

    if args.spp_chunk:
        opts = opts.replace(spp_chunk=args.spp_chunk)
        scene, _ = load_scene(args.scene_dir, args.name, opts, device=args.device)
        film = render_progressive(scene, opts, checkpoint_path=args.checkpoint,
                                  device=args.device)
        path = output_name(args.out_dir, args.name, args.spp)
        write_png(path, tonemap(film.mean, gamma=args.gamma))
        print(path)
        return 0

    _, path = render_scene(args.scene_dir, args.name, spp=args.spp,
                           options=opts, out_dir=args.out_dir, gamma=args.gamma,
                           device=args.device)
    print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
