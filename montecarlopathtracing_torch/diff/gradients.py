"""Differentiable rendering: image gradients with respect to scene parameters.

Counterpart of ``montecarlopathtracing_tpu/diff/gradients.py``, the inverse-
rendering surface.  The estimator is the JAX package's detached-sampling
pathwise gradient: traversal, visibility, Russian roulette, the lobe choice
and the sampled directions are detached inside the integrator, and the
radiance estimate stays a smooth function of

* ``kd`` / ``ks`` material albedos (throughput and NEE products),
* the emitter radiance (NEE and emitter-hit terms),
* the texture atlas (a texel's gradient scatters back into the atlas),
* ``ns``, the Phong exponents, with ``RenderOptions(ns_gradient=True)``: a
  score-function surrogate in the specular bounce weight
  (``integrator.wavefront._next_ray``); without it their gradient is zero.

Every entry point takes ``device`` like the renderers: None is the card, and
a machine without one raises unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..config import RenderOptions
from ..integrator.wavefront import render_image_stats, render_pixels
from ..scene.types import SceneArrays
from ..utils.device import resolve_device
from ..utils.timing import span

PARAM_FIELDS = ("kd", "ks", "ns", "light_radiance", "atlas")


@dataclasses.dataclass(frozen=True)
class SceneParams:
    """The differentiable subset of SceneArrays."""

    kd: Any  # (M,3)
    ks: Any  # (M,3)
    ns: Any  # (M,)
    light_radiance: Any  # (L,3)
    atlas: Any  # (A,3)

    @staticmethod
    def from_scene(scene: SceneArrays) -> "SceneParams":
        return SceneParams(**{f: getattr(scene, f) for f in PARAM_FIELDS})

    def to(self, device) -> "SceneParams":
        return SceneParams(**{f: getattr(self, f).to(device) for f in PARAM_FIELDS})

    def map(self, fn, *others: "SceneParams") -> "SceneParams":
        """fn applied field by field to this and ``others``."""
        return SceneParams(**{f: fn(getattr(self, f), *(getattr(o, f) for o in others))
                              for f in PARAM_FIELDS})

    def leaves(self, device=None) -> "SceneParams":
        """Detached copies on ``device`` that require a gradient."""
        return self.map(lambda t: t.detach().to(device).requires_grad_(True))


def param_grads(value, leaves: SceneParams) -> SceneParams:
    """d value / d leaves (a SceneParams from ``leaves()``), zeros for a
    field that ``value`` does not reach."""
    tensors = [getattr(leaves, f) for f in PARAM_FIELDS]
    grads = torch.autograd.grad(value, tensors, allow_unused=True)
    return SceneParams(**{f: torch.zeros_like(t) if g is None else g
                          for f, t, g in zip(PARAM_FIELDS, tensors, grads)})


def apply_params(scene: SceneArrays, params: SceneParams) -> SceneArrays:
    """Graft parameters back into the scene.  The emission table is rebuilt
    out of place from ``light_radiance`` at the lights' materials, so the
    emitter-hit and the NEE paths share one tensor and its gradient sums
    both."""
    emission = torch.zeros_like(scene.emission)
    if scene.num_lights:
        emission = emission.index_put((scene.light_mat.long(),),
                                      params.light_radiance.to(emission.dtype))
    return dataclasses.replace(
        scene, kd=params.kd, ks=params.ks, ns=params.ns, atlas=params.atlas,
        light_radiance=params.light_radiance, emission=emission)


def render_with_params(params: SceneParams, scene: SceneArrays, bvh,
                       opts: RenderOptions, device=None):
    """The (H, W, 3) image as a differentiable function of ``params``."""
    dev = resolve_device(device)
    img, _ = render_image_stats(apply_params(scene.to(dev), params.to(dev)),
                                bvh, opts, differentiable=True, device=dev)
    return img


def image_loss(params: SceneParams, scene: SceneArrays, bvh,
               opts: RenderOptions, target, device=None):
    """Mean squared error against a target image (inverse rendering)."""
    img = render_with_params(params, scene, bvh, opts, device=device)
    return torch.mean((img - target.to(img.device)) ** 2)


def loss_and_grad(params: SceneParams, scene: SceneArrays, bvh,
                  opts: RenderOptions, target, device=None):
    """(loss, gradient of image_loss as a SceneParams), both detached.  The
    step is one span, ``grad_step`` (its request the seed), over its two
    passes, ``forward`` and ``backward``."""
    with span("grad_step", request=opts.seed):
        dev = resolve_device(device)
        leaves = params.leaves(dev)
        with span("forward"):
            loss = image_loss(leaves, scene, bvh, opts, target, device=dev)
        with span("backward"):
            grads = param_grads(loss, leaves)
        return loss.detach(), grads


def train_step(params: SceneParams, scene: SceneArrays, bvh,
               opts: RenderOptions, target, lr: float = 0.1, device=None):
    """One SGD step of inverse rendering.  Returns (new params, loss)."""
    loss, grads = loss_and_grad(params, scene, bvh, opts, target, device=device)
    new = params.to(loss.device).map(lambda p, g: p.detach() - lr * g, grads)
    return new, loss


def pixel_gradient(scene: SceneArrays, bvh, opts: RenderOptions, pixel_ids,
                   select=None, device=None):
    """d(sum of the selected pixels' radiance) / d(params) at the scene's own
    parameters.  ``pixel_ids`` (R,) flat pixel ids; ``select`` an optional
    (R,3) weighting."""
    dev = resolve_device(device)
    scene = scene.to(dev)
    leaves = SceneParams.from_scene(scene).leaves(dev)
    rad, _ = render_pixels(apply_params(scene, leaves), bvh, opts,
                           torch.as_tensor(pixel_ids, device=dev),
                           differentiable=True)
    if select is not None:
        rad = rad * select.to(dev)
    return param_grads(torch.sum(rad), leaves)


def make_distributed_train_step(scene, bvh, opts: RenderOptions, mesh,
                                lr: float = 0.1, device=None):
    """One SGD step of inverse rendering over a (tile, spp) grid of ranks
    (``parallel.mesh.make_mesh``): each rank renders its pixel tile at its
    sample offset, the radiance is averaged over the tile's spp ranks, and
    the parameter gradients and the loss are averaged over all ranks before
    the update, so every rank holds the same new parameters.

    Returns ``step(params, target_tiles, ids_tiles) -> (new params, loss)``;
    ``target_tiles`` (n_tiles, per, 3) and ``ids_tiles`` (n_tiles, per) are
    the whole grid's arrays (``parallel.mesh._padded_ids``), of which each
    rank reads its own tile.  With equal tiles (no padding) the step equals
    ``train_step`` on the whole frame.

    The spp mean is taken on detached radiance and the loss's gradient with
    respect to it is pushed back through this rank's own samples, each rank
    with the full cotangent, the gradients then averaged over all ranks: the
    same gradient as the JAX package's pmean inside its shard_map, with only
    sum all-reduces (gloo takes them on CUDA tensors).
    """
    from ..parallel.mesh import _all_reduce, _local_opts, _render_tile

    dev = resolve_device(device)
    scene = scene.to(dev)
    local_opts, offset = _local_opts(opts, mesh)
    n_ranks = mesh.size
    tile = torch.tensor([mesh.tile_index], device=dev)

    def step(params: SceneParams, target_tiles, ids_tiles):
        ids = torch.as_tensor(ids_tiles, device=dev)[mesh.tile_index]
        target = torch.as_tensor(target_tiles, device=dev)[mesh.tile_index]
        leaves = params.leaves(dev)
        rad = _render_tile(apply_params(scene, leaves), bvh, local_opts, ids,
                           True, offset)
        with torch.no_grad():
            full = torch.zeros((ids_tiles.shape[0],) + tuple(rad.shape),
                               dtype=torch.float32, device=dev)
            full = _all_reduce(full.index_copy(0, tile, (rad / mesh.spp)[None]))
            mean = full[mesh.tile_index]
            diff = mean - target
            loss = _all_reduce(torch.mean(diff ** 2)[None])[0] / n_ranks
            cotangent = 2.0 * diff / diff.numel()
        tensors = [getattr(leaves, f) for f in PARAM_FIELDS]
        grads = torch.autograd.grad(rad, tensors, grad_outputs=cotangent,
                                    allow_unused=True)
        new = {}
        for f, t, g in zip(PARAM_FIELDS, tensors, grads):
            g = torch.zeros_like(t) if g is None else g
            new[f] = t.detach() - lr * (_all_reduce(g.contiguous()) / n_ranks)
        return SceneParams(**new), loss

    return step
