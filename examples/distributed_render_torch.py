"""Rendering and training over a (tile, spp) grid of processes with the
PyTorch port.

Starts ``--ranks`` processes on this machine, joined by torch.distributed
(parallel/mesh.py): pixel tiles on one axis, samples per pixel on the other,
the film summed over all ranks so every rank holds the whole image.  Then
one distributed training step: each rank's forward render and backward pass
on its tile, the gradients averaged over all ranks, the SGD update on every
rank (diff/gradients.make_distributed_train_step).

On the card, the ranks use NCCL when there is one card per rank and gloo
when they share a card (NCCL refuses two ranks on one device); on the CPU,
gloo.  Under a launcher that sets WORLD_SIZE / RANK / MASTER_ADDR /
MASTER_PORT (torchrun) the script joins that world instead of starting its
own ranks.

    python examples/distributed_render_torch.py [--ranks 2] [--device cpu]
"""

import argparse
import os
import socket
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(rank: int, world: int, address: str, device: str) -> int:
    import torch

    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.diff.gradients import (
        SceneParams, make_distributed_train_step)
    from montecarlopathtracing_torch.parallel.mesh import (
        _padded_ids, initialize_multihost, make_mesh, render_image_sharded)
    from montecarlopathtracing_torch.scene.builtin import load_builtin_box

    backend = "gloo"
    if device == "cuda":
        if torch.cuda.device_count() >= world:
            device, backend = f"cuda:{rank}", "nccl"
        else:
            device = "cuda:0"
    initialize_multihost(address, world, rank, backend=backend)
    spp_axis = 2 if world % 2 == 0 else 1
    mesh = make_mesh(tile=world // spp_axis, spp=spp_axis)
    say = print if rank == 0 else (lambda *a, **k: None)
    say(f"mesh: {mesh.shape} over {world} ranks ({backend}, {device})")

    scene, _ = load_builtin_box(width=32, height=32, device=device)
    opts = RenderOptions(spp=2 * spp_axis, max_depth=5, chunk_size=1024)
    t0 = time.perf_counter()
    img = render_image_sharded(scene, None, opts, mesh, device=device)
    say(f"sharded render: {tuple(img.shape)}, mean {float(img.mean()):.4f} "
        f"({time.perf_counter() - t0:.1f} s)")

    ids, per = _padded_ids(32 * 32, mesh.tile)
    target = torch.full((mesh.tile, per, 3), 0.4, device=device)
    params = SceneParams.from_scene(scene)
    step = make_distributed_train_step(scene, None, opts, mesh, lr=0.1,
                                       device=device)
    t0 = time.perf_counter()
    params2, loss = step(params, target, ids)
    moved = float((params2.kd - params.kd).abs().max())
    say(f"distributed train step: loss {float(loss):.5f} "
        f"({time.perf_counter() - t0:.1f} s); max |kd update| = {moved:.5f}")
    if world > 1:
        torch.distributed.destroy_process_group()
    return 0 if torch.isfinite(loss) and moved > 0 else 1


def _spawned(rank, world, address, device):
    sys.exit(run(rank, world, address, device))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    if "WORLD_SIZE" in os.environ:  # under a launcher
        address = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
        return run(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                   address, args.device)
    import torch.multiprocessing as mp

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    address = f"localhost:{s.getsockname()[1]}"
    s.close()
    mp.spawn(_spawned, args=(args.ranks, address, args.device),
             nprocs=args.ranks, join=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
