"""Traffic loop ``sharded_frames``: whole frames back to back from one
client, each split over the run's devices, one process a device, through
``parallel/mesh.py::render_image_sharded`` on the mix's (tile, spp) grid,
as the CLI renders with ``--mesh-tile`` under torchrun: every rank renders
its band of rows (or its share of the samples), and one sum all-reduce
gives every rank the whole frame.  Frame k renders with RenderOptions.seed
= the run's seed + k; frame 0 is the warm-up, rendered
``core.WARMUP_UNITS`` times in set-up.

This process is rank 0 (``run``); ``ranks.py`` starts the others, each of
which runs ``rank_main``.  Before each batch of frames rank 0 sends every
rank the batch's seeds, and whether to profile it, through the group's
store; ``stop`` ends them.  A frame fails if its image is not finite on
rank 0 or if a rank traced no rays for it.  After the window rank 0 holds
its image, which the all-reduce makes the whole frame's, to the reference
at ``check_pixels`` pixels of ``check_frames`` frames drawn from the seed,
as ``frames`` does (its ``kept`` and ``control_item``).

Mix parameters: ``render_options`` (the frame's spp), ``mesh`` ({"tile",
"spp"}: tile x spp ranks, one a device), ``check_frames``,
``check_pixels``, ``trace_frames`` (frames profiled on every rank with
``--trace 1``).  With ``--trace 1`` rank 0's trace is a frames trace (the
frames readers read rank 0; its ``busy_s`` counts rank 0's own work and
the exchange, not its wait for the other ranks: ``own_work_s``) with
``ranks``: each rank's busy seconds and the device seconds of its
``AllReduce`` kernel in each profiled frame.  The result's ``busy_s`` is
the ranks' mean of their whole busy time.

End-to-end metric: ``samples_per_s`` (W x H x spp of every frame done in
the window over the window's seconds: the whole grid's rate).
"""

from __future__ import annotations

import contextlib
import time

import torch

from benchmark import checks, core, profiling, program, ranks
from benchmark.reference import scene as reference_scene

METRICS = ("samples_per_s",)
TAG_FRAMES = 2
# The collective's kernels, by the part of the name NCCL gives each.
ALLREDUCE = "AllReduce"
TAIL_S = 0.01


def frames_loop():
    """The ``frames`` loop, whose check items this loop takes."""
    return core.load_module("loops", "frames")


def grid_of(cell) -> tuple:
    m = cell.traffic["mesh"]
    return int(m["tile"]), int(m["spp"])


class Renderer:
    """One rank's frames: its scene, the walk's tables (none for the
    cluster plans), the grid, and the ranks' ``barrier``."""

    def __init__(self, scene, opts, cell, dev, barrier):
        from montecarlopathtracing_torch import api
        from montecarlopathtracing_torch.parallel import mesh as M

        self.scene, self.opts, self.dev, self.barrier = scene, opts, dev, barrier
        self.bvh = api._walk_bvh(scene, opts, None)
        self.grid = M.make_mesh(*grid_of(cell))

    def frame(self, seed: int):
        """(the whole frame (H, W, 3), whether this rank traced rays),
        synchronised."""
        from montecarlopathtracing_torch.integrator import wavefront as W
        from montecarlopathtracing_torch.parallel import mesh as M

        before = W.loop_stats()["rays"]
        img = M.render_image_sharded(self.scene, self.bvh,
                                     self.opts.replace(seed=seed), self.grid,
                                     device=self.dev)
        program.sync(self.dev)
        return img, W.loop_stats()["rays"] > before

    def batch(self, seeds, profile: bool):
        """([(image, rays traced)] of the frames ``seeds``, back to back;
        with ``profile`` the device's summary of them (of no activity off a
        card), None otherwise).  A profiled frame is a profiler session of
        its own, so that its all-reduce kernels are its own, and it starts
        on every rank at once, after a barrier: the ranks' profilers start
        at different times, and a rank's all-reduce would wait for that."""
        if not profile:
            return [self.frame(s) for s in seeds], None
        out, sessions, window = [], [], 0.0
        for s in seeds:
            with profiling.device_profile(self.dev.type == "cuda") as prof:
                self.barrier()
                a = time.monotonic()
                out.append(self.frame(s))
                window += time.monotonic() - a
                tail(self.dev)
            sessions.append(profiling.device_events(prof))
        summary = rank_summary(sessions)
        summary["window_s"] = window
        return out, summary


def tail(dev) -> None:
    """A small kernel after a profiled frame's last, and a pause, before
    its session stops: a rank's session has been seen to lack the frame's
    all-reduce, which is the last kernel of a frame."""
    if dev.type == "cuda":
        torch.ones(1, device=dev).add_(1)
        program.sync(dev)
        time.sleep(TAIL_S)


def rank_summary(sessions) -> dict:
    """One rank's profiled frames, each a list of device events: busy
    seconds, kernels and idle gaps within the frames (``profiling``'s
    summary), and for each frame the device seconds of its ``AllReduce``
    kernels (None where it has none) and their number."""
    parts = [profiling.summarize(events) for events in sessions]
    out = profiling.summarize([e for events in sessions for e in events])
    out["busy_s"] = sum(p["busy_s"] for p in parts)
    out["idle_gaps"] = sorted((g for p in parts for g in p["idle_gaps"]),
                              key=lambda g: -g[1])[:10]
    times = [[b - a for name, a, b in events if ALLREDUCE in name]
             for events in sessions]
    out["allreduce_s"] = [sum(t) if t else None for t in times]
    out["allreduce_n"] = [len(t) for t in times]
    return out


def own_work_s(summaries) -> float:
    """Rank 0's busy seconds in the profiled frames with each all-reduce
    counted as the least of the ranks' (the exchange itself): the rest of
    it spins while rank 0 waits for the slowest band, and lasts as long as
    that rank's profiled frame, which the profiler slows on the host.  The
    least is over the ranks whose profiler recorded the frame's
    all-reduce."""
    own = summaries[0]
    wait = 0.0
    for f, mine in enumerate(own["allreduce_s"]):
        times = [t for t in (s["allreduce_s"][f] for s in summaries) if t is not None]
        if mine is not None:
            wait += mine - min(times)
    return own["busy_s"] - wait


class Shard:
    """Rank 0's side of the grid: the other ranks (``ranks.Group``) and
    rank 0's own renderer.  ``batch`` renders frames on every rank."""

    def __init__(self, run: core.Run, opts):
        tile, spp = grid_of(run.cell)
        self.group = ranks.Group(run, tile * spp)
        self.run, self.opts, self.dev = run, opts, self.group.dev
        self.renderer = None
        self.summaries = None

    def start(self) -> None:
        """Write the scene, start the ranks, load rank 0's scene (span
        ``scene_load_s``) while they load theirs, and join them."""
        self.run.span("scene_write_s", self.run.write_scene)
        self.group.start()
        scene = program.load_written(self.run, self.opts, self.dev)
        self.group.join()
        self.renderer = Renderer(scene, self.opts, self.run.cell, self.dev,
                                 self.group.barrier)

    def batch(self, seeds, profile: bool = False):
        self.group.send({"seeds": list(seeds), "profile": bool(profile)})
        return self.renderer.batch(seeds, profile)

    def close(self) -> None:
        """Stop the ranks and keep their summaries; drop rank 0's scene."""
        self.renderer = None
        self.summaries = self.group.close()


@contextlib.contextmanager
def session(run: core.Run, opts, dev=None):
    """A started ``Shard``, closed at the end (its ranks stopped at once
    after a failure): what ``numbers`` renders the program's frames with.
    Rank 0 takes device 0 of the run's kind, whatever ``dev`` says."""
    shard = Shard(run, opts)
    try:
        shard.start()
        yield shard
    except BaseException:
        shard.renderer = None
        shard.group.abort()
        raise
    shard.close()


def numbers(cell, opts, shard, ref, ctl, who: str, seed: int, dev) -> dict:
    """The check's numbers of frames 1 .. check_frames of a run with
    ``seed``: the program's (``who`` "program", rendered on the grid and
    kept as a run keeps them), or the control's in the program's place at
    the same pixels."""
    fl = frames_loop()
    n_check = int(cell.traffic["check_pixels"])
    ks = range(1, int(cell.traffic["check_frames"]) + 1)
    if who == "program":
        out, _ = shard.batch([core.unit_seed(seed, k) for k in ks])
        items = [fl.kept(img, seed, k, n_check, opts.spp)
                 for k, (img, _) in zip(ks, out)]
    else:
        items = [fl.control_item(ctl, cell, seed, k, n_check, dev) for k in ks]
    return checks.frame_numbers(ref, cell.options, items)


def rank_main(rank: ranks.Rank) -> dict:
    """Ranks 1 ..: load the scene the run wrote, render the batches rank 0
    sends until it says stop.  Returns the seeds of the frames for which
    this rank traced no rays, the summary of the last profiled batch, and
    the peak of allocated bytes."""
    from montecarlopathtracing_torch import api

    opts = program.render_options(rank.cell.options)
    scene, _ = api.load_scene(rank.workdir, rank.cell.scene_name, opts,
                              device=rank.dev)
    renderer = Renderer(scene, opts, rank.cell, rank.dev, rank.barrier)
    unsound, trace = [], None
    while True:
        unit = rank.receive()
        if unit.get("stop"):
            break
        out, summary = renderer.batch(unit["seeds"], unit["profile"])
        unsound += [s for s, (_, rays) in zip(unit["seeds"], out) if not rays]
        trace = summary or trace
        del out
    return {"unsound": unsound, "trace": trace,
            "peak": program.memory_peak(rank.dev)}


def run(run: core.Run) -> dict:
    from montecarlopathtracing_torch.integrator import wavefront as W

    cell, tr = run.cell, run.cell.traffic
    fl = frames_loop()
    opts = program.render_options(cell.options)
    spp, n_check = opts.spp, int(tr["check_pixels"])
    items, seeds = {}, {}
    trace, breakdown, extra, own = None, None, {}, None
    with session(run, opts) as shard:
        dev = shard.dev
        scene = shard.renderer.scene
        n_pix = scene.camera.height * scene.camera.width
        del scene

        def sound(k: int, img, rays: bool) -> bool:
            items[k] = fl.kept(img, run.seed, k, n_check, spp)
            seeds[k] = core.unit_seed(run.seed, k)
            return bool(torch.isfinite(img).all()) and rays

        def unit(k: int) -> bool:
            (img, rays), = shard.batch([core.unit_seed(run.seed, k)])[0]
            return sound(k, img, rays)

        shard.batch([core.unit_seed(run.seed, 0)] * core.WARMUP_UNITS)
        setup_peak = program.memory_peak(dev)
        W.reset_loop_stats()
        if run.trace:
            n_trace = int(tr["trace_frames"])
            ks = list(range(1, n_trace + 1))
            # The same frames unprofiled first: their wall time is what the
            # device's busy time is set against.
            a = time.monotonic()
            shard.batch([core.unit_seed(run.seed, k) for k in ks])
            wall = time.monotonic() - a
            W.reset_loop_stats()
            start = time.monotonic()
            out, own = shard.batch([core.unit_seed(run.seed, k) for k in ks],
                                   profile=True)
            end = time.monotonic()
            records = [(0.0, 0.0, sound(k, img, rays))
                       for k, (img, rays) in zip(ks, out)]
            del out
            stats = W.loop_stats()
            chosen = ks
        else:
            start, end, records = core.closed_loop(run.seconds, unit)
            g = core.sample_generator(run.seed, TAG_FRAMES)
            order = torch.randperm(len(records), generator=g).tolist()
            chosen = [i + 1 for i in order[:int(tr["check_frames"])]]
        peak = max(setup_peak, program.memory_peak(dev))
    others = shard.summaries
    run.loaded_elsewhere += [f"rank {s['rank']}: {m}" for s in others
                             for m in s["loaded"]]
    peak = max([peak] + [s["peak"] for s in others])
    unsound = {u for s in others for u in s["unsound"]}
    n = len(records)
    failed = sum(1 for k, (_, _, ok) in enumerate(records, 1)
                 if not ok or seeds[k] in unsound)
    if own is not None:
        summaries = [own] + [s["trace"] for s in others]
        per_rank = [{"rank": r, "busy_s": s["busy_s"], "allreduce_s": s["allreduce_s"],
                     "allreduce_n": s["allreduce_n"]} for r, s in enumerate(summaries)]
        trace = {"kind": "frames", "units": len(records), "window_s": own["window_s"],
                 "wall_s": wall, "busy_s": own_work_s(summaries),
                 "loop_stats": stats, "pixels": n_pix, "ranks": per_rank}
        breakdown = {k: own[k] for k in ("device_ops", "idle_gaps")}
        extra = {"busy_s": sum(s["busy_s"] for s in summaries) / len(summaries),
                 "window_s": own["window_s"]}

    checked = [items[k] for k in chosen]
    del items
    program.release(dev)
    ref = reference_scene.load(run.workdir, cell.scene_name, device=dev)
    numbers_ = checks.frame_numbers(ref, cell.options, checked)
    device = core.device_info(dev, cell.chips, peak)
    device.update(extra)
    return {
        "metrics": {"samples_per_s": (n * n_pix * spp / (end - start), "samples/s")},
        "setup_s": start - run.t0,
        "attempted": n, "failed": failed, "numbers": numbers_,
        "device": device, "trace": trace, "breakdown": breakdown,
    }
