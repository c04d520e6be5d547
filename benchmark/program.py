"""What the loops take from the program (montecarlopathtracing_torch): its
options, its scene loader, and a synchronise.  The loops call the
program's entry points themselves; the reference imports none of this."""

from __future__ import annotations

import contextlib
import gc

import torch


def render_options(options: dict):
    """RenderOptions from the cell's plain dict (``compat`` a dict of its
    flags)."""
    from montecarlopathtracing_torch.config import CompatOptions, RenderOptions

    options = dict(options)
    compat = CompatOptions(**options.pop("compat", {}))
    return RenderOptions(compat=compat, **options)


def sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def load_scene(run, opts, dev):
    """Write the cell's scene text (span ``scene_write_s``) and load it
    through ``api.load_scene`` (span ``scene_load_s``)."""
    run.span("scene_write_s", run.write_scene)
    return load_written(run, opts, dev)


def session(run, opts, dev):
    """A one-device loop's ``session``: what its ``numbers`` renders the
    program with, the scene written and loaded as a run loads it."""
    return contextlib.nullcontext(load_scene(run, opts, dev))


def load_written(run, opts, dev):
    """The scene the run wrote, loaded through ``api.load_scene`` (span
    ``scene_load_s``)."""
    from montecarlopathtracing_torch import api

    def load():
        scene, _ = api.load_scene(run.workdir, run.cell.scene_name, opts, device=dev)
        sync(dev)
        return scene

    return run.span("scene_load_s", load)


def release(dev) -> None:
    """Free what the program left allocated once its objects are dropped,
    so the reference runs in the memory the program held."""
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if torch.device(dev).type == "cuda" else 0
