"""Traffic loop ``grad_steps``: inverse-rendering gradient steps back to
back from one client, at the scene's own parameters (the update is left
out, so every step's inputs are the benchmark's own).

A step is the users' call, ``diff/gradients.py::loss_and_grad``: the
differentiable frame at the mix's spp and its mean squared error against
a whole-frame target image drawn from the seed, then the gradient of every
field.  Step k renders with RenderOptions.seed = the run's seed + k; step
0 is the warm-up, run ``core.WARMUP_UNITS`` times in set-up.

The check (``check_step``), after the window: a step of the window drawn
from the seed is taken again through ``loss_and_grad``, with its own
options, against a target that is the step's own frame everywhere but at
``supervised_pixels`` pixels drawn from the seed, where it is the run's
target.  Its loss and gradient are then those of the supervised pixels
alone, which the float64 reference can differentiate in a run's time (a
whole frame it cannot), normalised by the whole frame as the program's
mean is.  ``numbers``, which ``readings.py`` calls, takes ``check_step``
too.

Mix parameters: ``render_options`` (spp), ``supervised_pixels``,
``check_steps`` (steps held to the reference, drawn from the seed) and
``trace_steps`` (steps profiled with ``--trace 1``, each in its two
halves, ``image_loss`` and ``param_grads``, with a synchronise between).

End-to-end metrics: ``grad_step_s`` (the window's seconds over the steps
done in it) and ``grad_peak_gb`` (allocated bytes at their peak in the
window, from ``reset_peak_memory_stats`` at its start, in 1e9 bytes).
"""

from __future__ import annotations

import time

import torch

from benchmark import checks, core, profiling, program
from benchmark.reference import scene as reference_scene

TAG_SUPERVISED, TAG_STEPS, TAG_TARGET = 3, 4, 5
METRICS = ("grad_step_s", "grad_peak_gb")


def target_image(seed: int, height: int, width: int):
    """The run's whole-frame target, (H, W, 3) uniform in [0, 1)."""
    g = core.sample_generator(seed, TAG_TARGET)
    return torch.rand((height, width, 3), generator=g)


def supervised(seed: int, n_pix: int, count: int):
    """The check's pixel ids, distinct, drawn from the seed."""
    g = core.sample_generator(seed, TAG_SUPERVISED)
    return torch.randperm(n_pix, generator=g)[:min(count, n_pix)]


def check_step(scene, params, opts, seed: int, k: int, target, sup, dev) -> dict:
    """Step k taken again through ``loss_and_grad`` against the step's own
    frame with ``target`` put in at the pixels ``sup``; the check's item:
    the frame's values at ``sup``, the loss, the gradient of each field."""
    from montecarlopathtracing_torch.diff import gradients as G

    o = opts.replace(seed=core.unit_seed(seed, k))
    sup_d = sup.to(dev)
    img = G.render_with_params(params.leaves(dev), scene, None, o,
                               device=dev).detach()
    flat = img.reshape(-1, 3)
    values = flat.index_select(0, sup_d)
    mixed = flat.index_copy(0, sup_d, target.reshape(-1, 3).to(dev)
                            .index_select(0, sup_d)).reshape(img.shape)
    del img, flat
    loss, grads = G.loss_and_grad(params, scene, None, o, mixed, device=dev)
    return {"seed": o.seed, "pixels": sup, "spp": o.spp,
            "frame_pixels": mixed.shape[0] * mixed.shape[1],
            "target": target.reshape(-1, 3).index_select(0, sup).clone(),
            "values": values.cpu(), "loss": float(loss),
            "grads": {f: getattr(grads, f).cpu() for f in G.PARAM_FIELDS}}


session = program.session


def numbers(cell, opts, scene, ref, ctl, who: str, seed: int, dev) -> dict:
    """The check's numbers of step 1 of a run with ``seed``: the program's
    (``who`` "program", through ``check_step``), or the control's
    supervised loss and gradient in the program's place.  Also ``detail``:
    each field's gap and norms, and for the program how far two frames of
    one seed part (``check_step``'s target is the frame itself outside the
    supervised pixels: that gap says how exact that is)."""
    target = target_image(seed, ref.height, ref.width)
    sup = supervised(seed, ref.width * ref.height,
                     int(cell.traffic["supervised_pixels"]))
    detail = {}
    if who == "program":
        from montecarlopathtracing_torch.diff import gradients as G

        params = G.SceneParams.from_scene(scene)
        item = check_step(scene, params, opts, seed, 1, target, sup, dev)
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
                                                  dtype=checks.CONTROL_MATH)
        item.update(values=pred, loss=loss, grads=grads)
    out = checks.step_numbers(ref, cell.options, [item], detail)
    out["detail"] = detail
    return out


def finite(loss, grads, fields) -> bool:
    """Every number of the loss and the gradient finite (one read back)."""
    flags = [torch.isfinite(loss).all()]
    flags += [torch.isfinite(getattr(grads, f)).all() for f in fields]
    return bool(torch.stack(flags).all())


def run(run: core.Run) -> dict:
    from montecarlopathtracing_torch.diff import gradients as G
    from montecarlopathtracing_torch.integrator import wavefront as W

    cell, tr = run.cell, run.cell.traffic
    dev = torch.device(run.device)
    opts = program.render_options(cell.options)
    scene = program.load_scene(run, opts, dev)
    h, w = scene.camera.height, scene.camera.width
    params = G.SceneParams.from_scene(scene)
    target = target_image(run.seed, h, w)
    target_d = target.to(dev)

    def options(k: int):
        return opts.replace(seed=core.unit_seed(run.seed, k))

    def unit(k: int):
        loss, grads = G.loss_and_grad(params, scene, None, options(k), target_d,
                                      device=dev)
        return finite(loss, grads, G.PARAM_FIELDS)

    for _ in range(core.WARMUP_UNITS):
        unit(0)
    setup_peak = program.memory_peak(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    W.reset_loop_stats()
    trace, breakdown, extra = None, None, {}
    if run.trace:
        n_trace = int(tr["trace_steps"])
        # The same steps unprofiled first: their wall time is what the
        # device's busy time is set against.
        a = time.monotonic()
        for k in range(1, n_trace + 1):
            unit(k)
        wall = time.monotonic() - a
        W.reset_loop_stats()
        fwd_events, bwd_events, walls, records = [], [], 0.0, []
        for k in range(1, n_trace + 1):
            leaves = params.leaves(dev)
            with profiling.device_profile(dev.type == "cuda") as prof:
                a = time.monotonic()
                loss = G.image_loss(leaves, scene, None, options(k), target_d,
                                    device=dev)
                program.sync(dev)
                walls += time.monotonic() - a
            fwd_events += profiling.device_events(prof)
            with profiling.device_profile(dev.type == "cuda") as prof:
                a = time.monotonic()
                grads = G.param_grads(loss, leaves)
                program.sync(dev)
                walls += time.monotonic() - a
            bwd_events += profiling.device_events(prof)
            records.append((0.0, 0.0, finite(loss.detach(), grads, G.PARAM_FIELDS)))
            del leaves, loss, grads
        fwd = profiling.summarize(fwd_events)
        bwd = profiling.summarize(bwd_events)
        both = profiling.summarize(sorted(fwd_events + bwd_events,
                                          key=lambda e: e[1]))
        stats = W.grad_loop_stats()
        trace = {"kind": "grad_steps", "units": n_trace, "window_s": walls,
                 "wall_s": wall,
                 "busy_s": fwd["busy_s"] + bwd["busy_s"],
                 "fwd_busy_s": fwd["busy_s"], "bwd_busy_s": bwd["busy_s"],
                 "kernels": both["kernels"],
                 "kernel_count": fwd["kernel_count"] + bwd["kernel_count"],
                 "iterations": stats["blocks"] * opts.spp,
                 "grad_loop_stats": stats, "pixels": h * w}
        breakdown = {"device_ops": both["device_ops"],
                     "idle_gaps": sorted(fwd["idle_gaps"] + bwd["idle_gaps"],
                                         key=lambda x: -x[1])[:10]}
        extra = {"busy_s": trace["busy_s"], "window_s": walls}
        chosen = list(range(1, int(tr["check_steps"]) + 1))
        start = end = 0.0
    else:
        start, end, records = core.closed_loop(run.seconds, unit)
        order = torch.randperm(len(records),
                               generator=core.sample_generator(run.seed, TAG_STEPS))
        chosen = [i + 1 for i in order[:int(tr["check_steps"])].tolist()]
    window_peak = program.memory_peak(dev)
    n = len(records)
    failed = sum(1 for _, _, sound in records if not sound)
    del target_d

    sup = supervised(run.seed, h * w, int(tr["supervised_pixels"]))
    items = [check_step(scene, params, opts, run.seed, k, target, sup, dev)
             for k in chosen]
    del scene, params
    program.release(dev)
    ref = reference_scene.load(run.workdir, cell.scene_name, device=dev)
    numbers = checks.step_numbers(ref, cell.options, items)
    device = core.device_info(dev, cell.chips, max(setup_peak, window_peak))
    device.update(extra)
    metrics = {}
    if not run.trace:
        metrics = {"grad_step_s": ((end - start) / n, "s"),
                   "grad_peak_gb": (window_peak / 1e9, "GB")}
    return {"metrics": metrics, "setup_s": start - run.t0, "attempted": n,
            "failed": failed, "numbers": numbers, "device": device,
            "trace": trace, "breakdown": breakdown}
