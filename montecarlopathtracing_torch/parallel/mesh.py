"""Rendering over a (tile, spp) grid of processes.

Counterpart of ``montecarlopathtracing_tpu/parallel/mesh.py``.  The JAX
package runs one SPMD program over a ``jax.sharding.Mesh`` in one process;
here every rank is a process of ``torch.distributed``, and the grid maps the
ranks onto two axes:

* ``tile``: the film's pixels are cut into ``tile`` padded tiles, one per
  tile index;
* ``spp``: the samples of a pixel are split ``spp`` ways; the rank at spp
  index ``s`` renders absolute sample indices ``[s * spp_local, (s+1) *
  spp_local)`` of the same per-pixel RNG streams, so any grid averages
  exactly the sample set of a one-process render.

Rank ``r`` sits at (r // spp, r % spp), the row-major order of the JAX
package's ``devices.reshape(tile, spp)``.  Every rank holds the scene and the
LBVH.  One sum all-reduce over all ranks both averages the spp shards and
gathers the tiles, so every rank ends with the full (H, W, 3) image, as the
JAX package's replicated output; in a differentiable render the backward
pass sums the scene tensors' cotangents over all ranks, the transpose of the
JAX package's replicated scene input.  Only sum all-reduces are used: gloo takes
them on CUDA tensors, which is how two ranks share one card (NCCL refuses
two ranks on one device); with one card per rank, NCCL.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..config import RenderOptions
from ..integrator.wavefront import render_pixels, render_pixels_refill
from ..scene.types import SCENE_FIELDS, SceneArrays
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on a (tile, spp) grid of ``tile * spp`` ranks."""

    tile: int
    spp: int
    rank: int

    @property
    def shape(self) -> dict:
        return {"tile": self.tile, "spp": self.spp}

    @property
    def size(self) -> int:
        return self.tile * self.spp

    @property
    def tile_index(self) -> int:
        return self.rank // self.spp

    @property
    def spp_index(self) -> int:
        return self.rank % self.spp


def _world() -> tuple:
    """(world size, rank): (1, 0) without an initialised process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def make_mesh(tile: Optional[int] = None, spp: int = 1) -> Mesh:
    """The (tile, spp) grid over all ranks.  Default: all ranks on the tile
    axis.  ``tile * spp`` must equal the world size (1 without a process
    group)."""
    n, rank = _world()
    if tile is None:
        tile = n // spp
    if tile < 1 or spp < 1 or tile * spp != n:
        raise ValueError(f"mesh {tile}x{spp} != {n} ranks")
    return Mesh(tile=tile, spp=spp, rank=rank)


def _padded_ids(n_pixels: int, n_tiles: int, lanes_multiple: int = 8):
    """(n_tiles, per) pixel ids, each tile padded to a multiple of
    ``lanes_multiple`` with the last pixel; and ``per``."""
    per = -(-n_pixels // n_tiles)
    per = -(-per // lanes_multiple) * lanes_multiple
    ids = np.minimum(np.arange(n_tiles * per, dtype=np.int32), n_pixels - 1)
    return ids.reshape(n_tiles, per), per


def _local_opts(opts: RenderOptions, mesh: Mesh):
    if opts.spp % mesh.spp:
        raise ValueError(f"spp {opts.spp} must divide over the spp axis ({mesh.spp})")
    spp_local = opts.spp // mesh.spp
    return opts.replace(spp=spp_local), mesh.spp_index * spp_local


def _render_tile(scene, bvh, opts: RenderOptions, ids, differentiable: bool,
                 sample_offset: int):
    """Mean radiance (per, 3) of one tile's pixels: the lane pool at
    ``opts.chunk_size`` lanes, or the scan over samples chunk by chunk."""
    if opts.refill:
        return render_pixels_refill(
            scene, bvh, opts, ids, sample_offset,
            lanes=min(opts.chunk_size, ids.shape[0]),
            differentiable=differentiable)[0]
    return torch.cat([render_pixels(scene, bvh, opts, pix, differentiable,
                                    sample_offset=sample_offset)[0]
                      for pix in ids.split(opts.chunk_size)])


def _all_reduce(t):
    """Sum over all ranks, in place; a no-op for one process."""
    if _world()[0] > 1:
        dist.all_reduce(t)
    return t


class _Replicated(torch.autograd.Function):
    """The scene's tensors as a replicated input of the rank's render: the
    identity forward; backward sums every cotangent over all ranks (the
    transpose of the JAX package's ``P()`` input to its ``shard_map``).  One
    node for all the tensors, so every rank runs the same all-reduces in the
    same order."""

    @staticmethod
    def forward(ctx, *tensors):
        return tuple(t.clone() for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        return tuple(_all_reduce(g.clone(memory_format=torch.contiguous_format))
                     for g in grads)


class _SumOverRanks(torch.autograd.Function):
    """``full`` summed over all ranks.  Every rank computes its loss of the
    same replicated image, so the cotangent is already the same on every
    rank and passes through unchanged.  The replicated scene tensors are
    inputs too (with no gradient) so that their node's backward runs on
    every rank, whichever of them this rank's samples reach."""

    @staticmethod
    def forward(ctx, full, *replicated):
        ctx.n_replicated = len(replicated)
        return _all_reduce(full.clone())

    @staticmethod
    def backward(ctx, grad):
        return (grad,) + (None,) * ctx.n_replicated


def _replicate_scene(scene: SceneArrays):
    """(scene, replicated tensors): the scene's tensors that need a gradient
    passed through ``_Replicated``."""
    names = [f for f in SCENE_FIELDS if getattr(scene, f).requires_grad]
    if not names:
        return scene, ()
    outs = _Replicated.apply(*(getattr(scene, f) for f in names))
    return dataclasses.replace(scene, **dict(zip(names, outs))), outs


def render_image_sharded(scene: SceneArrays, bvh, opts: RenderOptions,
                         mesh: Mesh, differentiable: bool = False, device=None):
    """Distributed full-frame render -> (H, W, 3) f32, the same on every rank.

    ``opts.spp`` is split evenly over the spp axis (it must divide).  With
    ``differentiable`` the image is a function of the scene's tensors that
    require a gradient, with the JAX package's contract: when every rank
    computes the same loss of the image, ``torch.autograd.grad`` gives every
    rank the whole image's gradient, the same on all ranks and equal to one
    process's.  The rank's own samples give its share, and the shares are
    summed over the ranks in backward."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    h, w = scene.camera.height, scene.camera.width
    n = h * w
    local_opts, offset = _local_opts(opts, mesh)
    ids, per = _padded_ids(n, mesh.tile)
    multi = _world()[0] > 1
    replicated = ()
    if multi and differentiable:
        scene, replicated = _replicate_scene(scene)
    rad = _render_tile(scene, bvh, local_opts,
                       torch.as_tensor(ids[mesh.tile_index], device=dev),
                       differentiable, offset)
    full = torch.zeros((mesh.tile, per, 3), dtype=torch.float32, device=dev)
    full = full.index_copy(0, torch.tensor([mesh.tile_index], device=dev),
                           (rad / mesh.spp)[None])
    if multi:
        full = _SumOverRanks.apply(full, *replicated)
    return full.reshape(mesh.tile * per, 3)[:n].reshape(h, w, 3)


# PyTorch runs eagerly: there is no compiled executable to cache, so the JAX
# package's jitted entry point is the same function here.
render_image_sharded_jit = render_image_sharded


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: str = "gloo") -> None:
    """Join ``num_processes`` ranks into one process group
    (``torch.distributed.init_process_group`` at ``tcp://coordinator_address``,
    a "host:port").  A no-op for one process.  The caller names the backend:
    "nccl" for one card per rank, "gloo" otherwise (two ranks on one card, or
    the CPU)."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(backend=backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
