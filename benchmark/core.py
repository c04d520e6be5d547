"""The harness: finds a cell's files by name, runs its traffic loop, and
prints the result.

A cell is ``workloads/<cell>.json``: its configuration, its traffic mix,
the chips it needs, why it exists, and the limits of its check.  The
configuration is ``configs/<config>.json`` (the deployment: its
``geometry``, the scene generator, and the generator's parameters at the
top level beside it, the render options, the source and what was reduced
from it); the traffic mix is ``traffic/<mix>.json`` (the loop that drives
it, by kind, and its parameters).  The loop is ``loops/<kind>.py``, the
scene generator ``scenes/<geometry>.py``, and each per-layer metric a
reader ``metrics/<metric>.py``.  A loop names its end-to-end metrics
(``METRICS``), runs a run (``run``), and gives the check's numbers of a
seed for the program or the control (``numbers``, on what its ``session``
sets up), which ``readings.py`` and the tests call.  A later cell, mix,
loop, configuration or metric is a new file: nothing here names one.  A
loop over more than one device starts its other ranks through
``ranks.py``.

A run builds its scene as text in its own directory under ``TMPDIR``,
loads it through the program's ``api.load_scene``, warms up
``WARMUP_UNITS`` units of the cell's own shapes, then measures for
``--seconds`` (``--trace 0``: the end-to-end metrics) or profiles a few units (``--trace 1``: the per-layer
metrics), and checks the outputs against the plain reference once the
window has closed.  The last line of standard output is the result.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
# Top-level module names that no process of a run may hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "montecarlopathtracing_tpu")
# Program build and kernel caches, at fixed paths inside the checkout.
CACHE = os.path.join(ROOT, ".bench_cache")
# Units run in set-up before the window, each with the shapes of the
# window's: the first unit after a single warm-up ran 1-6 s slower than the
# rest on the card.
WARMUP_UNITS = 2


class HarnessError(Exception):
    """A cell, file or name the harness cannot use."""


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise HarnessError(f"not a valid name: {name!r}")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.match(unit):
        raise HarnessError(f"not a valid unit: {unit!r}")
    return unit


def _path(folder: str, name: str, ext: str) -> str:
    path = os.path.join(BENCH, folder, check_name(name) + ext)
    if not os.path.isfile(path):
        raise HarnessError(f"no {folder[:-1] if folder.endswith('s') else folder} "
                           f"named {name!r} ({os.path.relpath(path, ROOT)})")
    return path


def load_json(folder: str, name: str) -> dict:
    with open(_path(folder, name, ".json")) as fh:
        return json.load(fh)


def load_module(folder: str, name: str):
    """benchmark/<folder>/<name>.py as a module of its own."""
    path = _path(folder, name, ".py")
    key = f"benchmark_{folder}_" + re.sub(r"\W", "_", name)
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def names(folder: str, ext: str) -> List[str]:
    """Every file's name in benchmark/<folder> with ``ext`` (helpers, whose
    names start with ``_``, left out)."""
    d = os.path.join(BENCH, folder)
    return sorted(f[:-len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("_"))


def metric_readers() -> Dict[str, object]:
    """{metric name: reader module} of every per-layer metric."""
    return {n: load_module("metrics", n) for n in names("metrics", ".py")}


class Cell:
    """A workload's files, resolved by name.  ``files`` gives the three
    JSON objects (workload, config, traffic) instead of reading them: a
    worker process rebuilds its parent's cell from them."""

    def __init__(self, name: str, files: Optional[tuple] = None):
        self.name = check_name(name)
        if files is None:
            workload = load_json("workloads", name)
            files = (workload, load_json("configs", workload["config"]),
                     load_json("traffic", workload["traffic"]))
        self.workload, self.config, self.traffic = files
        self.chips = int(self.workload["chips"])
        self.loop = load_module("loops", self.traffic["kind"])
        self.generator = load_module("scenes", self.config["geometry"])

    @property
    def files(self) -> tuple:
        return self.workload, self.config, self.traffic

    @property
    def options(self) -> dict:
        """The render options as a plain dict: the configuration's, then
        the traffic mix's (its samples per pixel)."""
        opts = json.loads(json.dumps(self.config["render_options"]))
        opts.update(self.traffic.get("render_options", {}))
        return opts

    @property
    def scene_name(self) -> str:
        """The scene's file name stem (<name>.obj, .mtl, .camera)."""
        return self.config["scene_name"]

    @property
    def limits(self) -> Dict[str, float]:
        return {k: float(v) for k, v in self.workload["limits"].items()}


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def unit_seed(seed: int, k: int) -> int:
    """RenderOptions.seed of a run's unit k (0 is the warm-up)."""
    return int(seed) + int(k)


def sample_generator(seed: int, tag: int):
    """A CPU torch.Generator for the benchmark's own draws (pixels to check,
    targets), from the run's seed and a tag per purpose."""
    import torch

    g = torch.Generator()
    g.manual_seed((int(seed) * 1_000_003 + tag) % (1 << 63))
    return g


class Run:
    """One run of one cell: its arguments, its scene directory and clocks."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str = "cuda", t0: Optional[float] = None,
                 workdir: Optional[str] = None):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace, self.device = bool(trace), device
        self.t0 = time.monotonic() if t0 is None else t0
        self.workdir = workdir
        self.spans: Dict[str, float] = {}
        # "module:function" called with its rank in every process of a
        # run on more than one device, once it has joined the group (the
        # tests plant faults with it); and what those processes held of
        # FORBIDDEN, as "rank <r>: <module>".
        self.rank_hook: Optional[str] = None
        self.loaded_elsewhere: List[str] = []

    def write_scene(self) -> str:
        """The scene's text and textures in a directory of this run's own
        under TMPDIR; returns it."""
        if self.workdir is None:
            self.workdir = tempfile.mkdtemp(prefix="bench-scene-")
        self.cell.generator.write(self.workdir, self.cell.scene_name,
                                  self.cell.config, self.seed)
        return self.workdir

    def cleanup(self) -> None:
        if self.workdir and os.path.isdir(self.workdir):
            shutil.rmtree(self.workdir, ignore_errors=True)

    def span(self, name: str, fn: Callable):
        """fn() timed on the host clock into ``spans[name]`` (seconds)."""
        t = time.monotonic()
        out = fn()
        self.spans[name] = time.monotonic() - t
        return out


def closed_loop(seconds: float, unit: Callable[[int], object], first: int = 1):
    """Units first, first + 1, ... back to back until ``seconds`` have
    passed; each returns once its work is done (synchronised).  Returns
    (window start, window end, [(start, end, record)])."""
    records = []
    start = time.monotonic()
    k = first
    while True:
        a = time.monotonic()
        rec = unit(k)
        b = time.monotonic()
        records.append((a, b, rec))
        k += 1
        if b - start >= seconds:
            return start, b, records


def device_info(dev, chips: int, peak: int) -> dict:
    """The result's ``device``: the card's name, the cards used, the peak
    of allocated bytes on the fullest (``cpu`` when run on the CPU)."""
    import torch

    gpu = torch.device(dev).type == "cuda"
    return {"platform": "gpu" if gpu else "cpu",
            "kind": torch.cuda.get_device_name(0) if gpu else "cpu",
            "count": chips, "memory_peak_bytes": int(peak)}


def nvidia_smi() -> Optional[str]:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            check=True, capture_output=True, text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0].strip() if out.strip() else None


def per_layer(trace: dict) -> Dict[str, dict]:
    """{metric: {"value", "unit"}} of every reader that finds something to
    read in ``trace``."""
    out = {}
    for name, mod in metric_readers().items():
        value = mod.read(trace)
        if value is not None:
            out[name] = {"value": float(value), "unit": check_unit(mod.UNIT)}
    return out


def execute(run: Run) -> dict:
    """Run the cell's loop; returns the result line's fields."""
    res = run.cell.loop.run(run)
    numbers = res.pop("numbers")
    from .checks import judge

    ok, rows = judge(numbers, run.cell.limits)
    if run.trace:
        trace = res.pop("trace")
        trace.update(spans=dict(run.spans), cell=run.cell.name)
        metrics = per_layer(trace)
    else:
        res.pop("trace", None)
        metrics = {k: {"value": v, "unit": u}
                   for k, (v, u) in res.pop("metrics").items()}
        metrics["setup_s"] = {"value": res.pop("setup_s"), "unit": "s"}
    out = {"correct": bool(ok) and res["failed"] == 0,
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": res["device"]}
    if run.trace and res.get("breakdown"):
        out["breakdown"] = res["breakdown"]
    out["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    return out


def main(argv=None, t0: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        cell = Cell(args.workload)
    except (HarnessError, KeyError, OSError, ValueError) as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA device(s), "
              f"found {have}", file=sys.stderr)
        return 2
    return finish(Run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t0))


def finish(run: Run) -> int:
    """Execute the run and print its result: the exit code of ``main``."""
    try:
        out = execute(run)
    finally:
        run.cleanup()
    bad = forbidden_modules() + run.loaded_elsewhere
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    smi = nvidia_smi()
    if smi:
        out["device"]["nvidia_smi"] = smi
    for name, row in out["checks"].items():
        print(f"check {name}: {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
        row.update({k: v if math.isfinite(v) else None for k, v in row.items()})
    sys.stderr.flush()
    print(json.dumps(out, allow_nan=False), flush=True)
    return 0
