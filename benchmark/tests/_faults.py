"""Faults planted in every rank of a run on more than one device, through
``core.Run.rank_hook`` ("benchmark.tests._faults:<name>"): each is called
with the rank once it has joined the group."""

import sys
import types


def _mesh():
    from montecarlopathtracing_torch.parallel import mesh

    return mesh


def no_exchange(rank: int) -> None:
    """The exchange between the devices left out: every rank keeps its own
    band of the frame."""
    _mesh()._all_reduce = lambda t: t


def half_samples(rank: int) -> None:
    """Half of each pixel's samples left out, the mean taken over the rest."""
    mesh = _mesh()
    real = mesh.render_image_sharded

    def half(scene, bvh, opts, grid, **kw):
        return real(scene, bvh, opts.replace(spp=max(1, opts.spp // 2)), grid, **kw)

    mesh.render_image_sharded = half


def _raise_on_call(n: int) -> None:
    mesh = _mesh()
    real, calls = mesh.render_image_sharded, []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == n:
            raise RuntimeError("a planted failure of this rank")
        return real(*a, **kw)

    mesh.render_image_sharded = failing


def rank2_raises_in_the_window(rank: int) -> None:
    """Rank 2 raises in its fourth frame (two warm-ups, then the window)."""
    if rank == 2:
        _raise_on_call(4)


def rank1_raises_at_once(rank: int) -> None:
    """Rank 1 raises before it renders anything."""
    if rank == 1:
        raise RuntimeError("a planted failure of this rank")


def rank3_holds_jax(rank: int) -> None:
    """Rank 3 holds a module named ``jax``."""
    if rank == 3:
        sys.modules["jax"] = types.ModuleType("jax")


def rank0_raises_in_the_window(rank: int) -> None:
    """Rank 0 raises in its fourth frame, the others wait for it."""
    if rank == 0:
        _raise_on_call(4)
