"""The two readings that a cell's check limits are set from, in one process:

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,...,12 \
        --control-seeds 21,22,23

For each of ``--seeds`` the program renders the units a run checks (frames
1 .. check_frames, or gradient step 1) with that seed, through the loop's
own functions, and the check's numbers are printed: the lower readings.  For each of ``--control-seeds``
the control takes the program's place: the reference itself with every
float of the scene held in bfloat16 and its arithmetic in float32 (the
step below the configuration's float32 that would tempt a later change:
the scene's tables in bfloat16), compared with the float64 reference as
the program is: the upper readings.  One JSON line per seed, then one with
each number's largest program reading and smallest control reading.
The benchmark's runs do not run this; it needs the card for the cells'
own sizes (``--device cpu`` runs it on the CPU).
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import checks, core, program  # noqa: E402
from benchmark.reference import scene as reference_scene  # noqa: E402
from benchmark.reference import tracer  # noqa: E402

CONTROL_STORAGE = torch.bfloat16
CONTROL_MATH = torch.float32


def control_scene(ref):
    return ref.rounded(CONTROL_STORAGE).to(dtype=CONTROL_MATH)


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control_seeds = [int(s) for s in args.control_seeds.split(",") if s]
    cell = core.Cell(args.workload)
    dev = torch.device(args.device)
    run = core.Run(cell, 0, 0.0, False, args.device)
    opts = program.render_options(cell.options)
    kind = cell.traffic["kind"]
    rows = []
    try:
        scene = program.load_scene(run, opts, dev) if seeds else None
        ref = reference_scene.load(run.workdir or run.write_scene(),
                                   cell.scene_name, device=dev)
        ctl = control_scene(ref)
        for who, group in (("program", seeds), ("control", control_seeds)):
            for seed in group:
                if kind == "frames":
                    numbers = frame_numbers(cell, opts, scene, ref, ctl, who, seed, dev)
                else:
                    numbers = step_numbers(cell, opts, scene, ref, ctl, who, seed, dev)
                detail = numbers.pop("detail", {})
                row = {"who": who, "seed": seed, **numbers}
                rows.append(row)
                print(json.dumps(dict(row, **detail)), flush=True)
    finally:
        run.cleanup()
    summary = {"workload": cell.name}
    for name in sorted({k for r in rows for k in r} - {"who", "seed"}):
        prog = [r[name] for r in rows if r["who"] == "program"]
        ctl_ = [r[name] for r in rows if r["who"] == "control"]
        summary[name] = {"lower": max(prog) if prog else None,
                         "upper": min(ctl_) if ctl_ else None}
    print(json.dumps(summary), flush=True)
    return 0


def frame_numbers(cell, opts, scene, ref, ctl, who, seed, dev):
    """Frames 1 .. check_frames of a run with ``seed``, through the frames
    loop's own ``frame`` and ``kept`` (the program), or the control in the
    program's place at the same pixels."""
    frames = core.load_module("loops", "frames")
    n_check = int(cell.traffic["check_pixels"])
    items = []
    for k in range(1, int(cell.traffic["check_frames"]) + 1):
        if who == "program":
            img, _ = frames.frame(scene, opts, seed, k, dev)
            items.append(frames.kept(img, seed, k, n_check, opts.spp))
            continue
        pix = frames.check_pixels(seed, k, ref.width * ref.height, n_check)
        s = core.unit_seed(seed, k)
        items.append({"seed": s, "pixels": pix, "spp": opts.spp,
                      "values": tracer.render(ctl, cell.options, s, pix.to(dev),
                                              opts.spp).cpu()})
    return checks.frame_numbers(ref, cell.options, items)


def step_numbers(cell, opts, scene, ref, ctl, who, seed, dev):
    """Step 1 of a run with ``seed`` through the gradient loop's own
    ``check_step`` (the program), or the control's supervised loss and
    gradient in the program's place."""
    grad = core.load_module("loops", "grad_steps")
    target = grad.target_image(seed, ref.height, ref.width)
    sup = grad.supervised(seed, ref.width * ref.height,
                          int(cell.traffic["supervised_pixels"]))
    detail = {}
    if who == "program":
        from montecarlopathtracing_torch.diff import gradients as G

        params = G.SceneParams.from_scene(scene)
        item = grad.check_step(scene, params, opts, seed, 1, target, sup, dev)
        # check_step's target is the frame itself outside the supervised
        # pixels: how far two frames of one seed part says how exact that is.
        o = opts.replace(seed=item["seed"])
        a, b = (G.render_with_params(params.leaves(dev), scene, None, o,
                                     device=dev).detach() for _ in range(2))
        detail["frame_repeat_gap"] = float((a - b).abs().max())
        del a, b
    else:
        item = {"seed": core.unit_seed(seed, 1), "pixels": sup, "spp": opts.spp,
                "frame_pixels": ref.width * ref.height,
                "target": target.reshape(-1, 3).index_select(0, sup)}
        pred, loss, grads = checks.reference_step(ctl, cell.options, item,
                                                  dtype=CONTROL_MATH)
        item.update(values=pred, loss=loss, grads=grads)
    numbers = checks.step_numbers(ref, cell.options, [item], detail)
    numbers["detail"] = detail
    return numbers


if __name__ == "__main__":
    sys.exit(main())
