"""Traffic loop ``frames``: whole frames back to back from one client, each
through ``integrator/wavefront.py::render_image_host_chunked`` (one
dispatch per spp step, ``spp_steps``), as a render node works through a
sequence.  Frame k renders with RenderOptions.seed = the run's seed + k;
frame 0 is the warm-up.

Mix parameters: ``metrics`` (the end-to-end metrics the cell reports, of
the two below), ``render_options`` (the frame's spp), ``check_frames`` and
``check_pixels`` (frames and pixels of each held to the reference, drawn
from the seed), ``trace_frames`` (frames profiled with ``--trace 1``).
Frame 0 is rendered ``core.WARMUP_UNITS`` times in set-up.

``frame`` and ``kept`` are the unit's two halves; ``numbers``, which
``readings.py`` calls, renders through them too, so the readings that set
the check's limits come from this path.

End-to-end metric: ``samples_per_s`` (W x H x spp of every frame done in
the window over the window's seconds).
"""

from __future__ import annotations

import time

import torch

from benchmark import checks, core, profiling, program
from benchmark.reference import scene as reference_scene
from benchmark.reference import tracer

TAG_PIXELS, TAG_FRAMES = 1, 2
METRICS = ("samples_per_s",)


def check_pixels(seed: int, k: int, n_pix: int, count: int):
    """The pixel ids of frame k held to the reference (with repeats)."""
    g = core.sample_generator(seed * 7919 + k, TAG_PIXELS)
    return torch.randint(0, n_pix, (count,), generator=g)


def queries_per_pixel(counts: dict, pixels: int) -> float:
    return (counts["primary"] + counts["shadow"] + counts["bounce"]) / pixels


def frame(scene, opts, seed: int, k: int, dev):
    """Frame k of a run with ``seed``: (image, rays), synchronised."""
    from montecarlopathtracing_torch.integrator import wavefront as W

    img, rays = W.render_image_host_chunked(
        scene, None, opts.replace(seed=core.unit_seed(seed, k)), device=dev)
    program.sync(dev)
    return img, rays


def kept(img, seed: int, k: int, n_check: int, spp: int) -> dict:
    """The check's item of frame k: its pixels drawn from the seed and the
    image's values there."""
    pix = check_pixels(seed, k, img.shape[0] * img.shape[1], n_check)
    return {"seed": core.unit_seed(seed, k), "pixels": pix, "spp": spp,
            "values": img.reshape(-1, 3).index_select(0, pix.to(img.device)).cpu()}


def control_item(ctl, cell, seed: int, k: int, n_check: int, dev) -> dict:
    """Frame k's check item with the control in the program's place: the
    same pixels as ``kept`` draws, rendered by the control scene."""
    spp = int(cell.options["spp"])
    pix = check_pixels(seed, k, ctl.width * ctl.height, n_check)
    s = core.unit_seed(seed, k)
    return {"seed": s, "pixels": pix, "spp": spp,
            "values": tracer.render(ctl, cell.options, s, pix.to(dev), spp).cpu()}


session = program.session


def numbers(cell, opts, scene, ref, ctl, who: str, seed: int, dev) -> dict:
    """The check's numbers of frames 1 .. check_frames of a run with
    ``seed``: the program's (``who`` "program", through ``frame`` and
    ``kept``), or the control's in the program's place at the same pixels."""
    n_check = int(cell.traffic["check_pixels"])
    ks = range(1, int(cell.traffic["check_frames"]) + 1)
    if who == "program":
        items = [kept(frame(scene, opts, seed, k, dev)[0], seed, k, n_check, opts.spp)
                 for k in ks]
    else:
        items = [control_item(ctl, cell, seed, k, n_check, dev) for k in ks]
    return checks.frame_numbers(ref, cell.options, items)


def run(run: core.Run) -> dict:
    from montecarlopathtracing_torch.integrator import wavefront as W

    cell, tr = run.cell, run.cell.traffic
    dev = torch.device(run.device)
    opts = program.render_options(cell.options)
    scene = program.load_scene(run, opts, dev)
    n_pix = scene.camera.height * scene.camera.width
    spp, n_check = opts.spp, int(tr["check_pixels"])
    items = {}

    def unit(k: int):
        img, rays = frame(scene, opts, run.seed, k, dev)
        items[k] = kept(img, run.seed, k, n_check, spp)
        return bool(torch.isfinite(img).all()) and rays > 0

    for _ in range(core.WARMUP_UNITS):
        frame(scene, opts, run.seed, 0, dev)
    setup_peak = program.memory_peak(dev)
    W.reset_loop_stats()
    trace, breakdown, extra = None, None, {}
    if run.trace:
        n_trace = int(tr["trace_frames"])
        # The same frames unprofiled first: their wall time is what the
        # device's busy time is set against.
        a = time.monotonic()
        for k in range(1, n_trace + 1):
            unit(k)
        wall = time.monotonic() - a
        W.reset_loop_stats()
        start = time.monotonic()
        with profiling.device_profile(dev.type == "cuda") as prof:
            records = [(0.0, 0.0, unit(k)) for k in range(1, n_trace + 1)]
            end = time.monotonic()
        summary = profiling.summarize(profiling.device_events(prof))
        stats = W.loop_stats()
        trace = {"kind": "frames", "units": n_trace, "window_s": end - start,
                 "wall_s": wall,
                 "busy_s": summary["busy_s"], "kernels": summary["kernels"],
                 "kernel_count": summary["kernel_count"],
                 "iterations": stats["iterations"], "loop_stats": stats,
                 "pixels": n_pix}
        breakdown = {k: summary[k] for k in ("device_ops", "idle_gaps")}
        extra = {"busy_s": summary["busy_s"], "window_s": end - start}
        chosen = list(range(1, n_trace + 1))
    else:
        start, end, records = core.closed_loop(run.seconds, unit)
        g = core.sample_generator(run.seed, TAG_FRAMES)
        order = torch.randperm(len(records), generator=g).tolist()
        chosen = [i + 1 for i in order[:int(tr["check_frames"])]]
    peak = max(setup_peak, program.memory_peak(dev))
    n = len(records)
    failed = sum(1 for _, _, sound in records if not sound)

    checked = [items[k] for k in chosen]
    del scene, items
    program.release(dev)
    ref = reference_scene.load(run.workdir, cell.scene_name, device=dev)
    counts = {}
    numbers = checks.frame_numbers(ref, cell.options, checked, counts)
    if trace is not None:
        trace.update(queries_per_frame=queries_per_pixel(
            counts, len(checked) * n_check) * n_pix, triangles=ref.num_tris)
    device = core.device_info(dev, cell.chips, peak)
    device.update(extra)
    return {
        "metrics": {"samples_per_s": (n * n_pix * spp / (end - start), "samples/s")},
        "setup_s": start - run.t0,
        "attempted": n, "failed": failed, "numbers": numbers,
        "device": device, "trace": trace, "breakdown": breakdown,
    }
