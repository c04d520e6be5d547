"""The two readings that a cell's check limits are set from, in one process:

    python3 benchmark/readings.py --workload <cell> --seeds 1,2,...,12 \
        --control-seeds 21,22,23

For each of ``--seeds`` the program takes the units a run checks (frames
1 .. check_frames, or gradient step 1) with that seed, through the cell's
traffic loop's own ``numbers`` (on what its ``session`` sets up), and the
check's numbers are printed: the lower readings.  For each of
``--control-seeds`` the control (``checks.control_scene``) takes the
program's place: the upper readings.  One JSON line per seed, then one
with each number's largest program reading and smallest control reading.
The benchmark's runs do not run this; it needs the card (or the cards)
for the cells' own sizes (``--device cpu`` runs it on the CPU).
"""

from __future__ import annotations

import contextlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark import checks, core, program  # noqa: E402
from benchmark.reference import scene as reference_scene  # noqa: E402


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
    rows = []
    try:
        with (cell.loop.session(run, opts, dev) if seeds
              else contextlib.nullcontext()) as prog:
            ref = reference_scene.load(run.workdir or run.write_scene(),
                                       cell.scene_name, device=dev)
            ctl = checks.control_scene(ref)
            for who, group in (("program", seeds), ("control", control_seeds)):
                for seed in group:
                    numbers = cell.loop.numbers(cell, opts, prog, ref, ctl, who,
                                                seed, dev)
                    detail = numbers.pop("detail", {})
                    row = {"who": who, "seed": seed, **numbers}
                    rows.append(row)
                    print(json.dumps(dict(row, **detail)), flush=True)
    finally:
        run.cleanup()
    summary = {"workload": cell.name}
    for name in sorted({k for r in rows for k in r} - {"who", "seed"}):
        prog_ = [r[name] for r in rows if r["who"] == "program"]
        ctl_ = [r[name] for r in rows if r["who"] == "control"]
        summary[name] = {"lower": max(prog_) if prog_ else None,
                         "upper": min(ctl_) if ctl_ else None}
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
