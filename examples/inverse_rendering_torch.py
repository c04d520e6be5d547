"""Inverse rendering with the PyTorch port: recover a wall albedo from a
target image.

The port's differentiable renderer (montecarlopathtracing_torch.diff.
gradients) differentiates the path-tracing estimator with respect to the
scene's materials and lights.  This demo

1. renders a target image of the built-in Cornell-style box,
2. starts the red wall's diffuse albedo from grey,
3. runs gradient descent on the image L2 loss until the albedo recovers.

Runs on the card by default; ``--device cpu`` runs the kernels' plain
PyTorch versions on the CPU (about a minute at the default size).

    python examples/inverse_rendering_torch.py [--steps 60] [--device cpu]
"""

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lr", type=float, default=0.9)
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()

    import torch

    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.diff.gradients import (
        SceneParams, image_loss, loss_and_grad, render_with_params)
    from montecarlopathtracing_torch.scene.builtin import load_builtin_box

    dev = args.device
    scene, meta = load_builtin_box(width=args.size, height=args.size, device=dev)
    opts = RenderOptions(spp=4, max_depth=6, chunk_size=args.size * args.size)

    mi = meta.material_names.index("Red")
    truth = SceneParams.from_scene(scene)
    with torch.no_grad():
        target = render_with_params(truth, scene, None, opts, device=dev)
    print(f"target rendered ({args.size}x{args.size}, spp {opts.spp}); true "
          f"red-wall kd = {[round(float(v), 3) for v in truth.kd[mi]]}")

    # Start the optimisation from a grey wall.
    kd = truth.kd.clone()
    kd[mi] = 0.5
    params = dataclasses.replace(truth, kd=kd)

    t0 = time.perf_counter()
    for step in range(args.steps):
        _, g = loss_and_grad(params, scene, None, opts, target, device=dev)
        # Optimise only the perturbed material (the rest are at the truth).
        kd = params.kd.clone()
        kd[mi] = torch.clamp(kd[mi] - args.lr * g.kd[mi], 0.0, 1.0)
        params = dataclasses.replace(params, kd=kd)
        if step % 10 == 0 or step == args.steps - 1:
            with torch.no_grad():
                loss = float(image_loss(params, scene, None, opts, target, device=dev))
            print(f"step {step:3d}  loss {loss:.6f}  kd[Red] = "
                  f"{[round(float(v), 3) for v in params.kd[mi]]}")

    err = float((params.kd[mi] - truth.kd[mi]).abs().max())
    print(f"recovered in {time.perf_counter() - t0:.1f} s; max |kd error| = {err:.4f}")
    return 0 if err < 0.05 else 1


if __name__ == "__main__":
    sys.exit(main())
