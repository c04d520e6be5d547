"""montecarlopathtracing_torch: the Monte Carlo path tracer in PyTorch, with
its intersection kernels written by hand in CUDA for Hopper (H100).

A port of ``montecarlopathtracing_tpu`` (the JAX reference, left unchanged
beside it) that mirrors its layout and names.  Entry points run on the card
unless the caller passes ``device="cpu"``, where the kernels' plain PyTorch
versions run instead.

Quick start:

    from montecarlopathtracing_torch import render_scene, RenderOptions
    img, path = render_scene("scene", "cornell-box", spp=25)

Gradients of an image with respect to the materials and lights:
``montecarlopathtracing_torch.diff.gradients`` (``loss_and_grad``,
``train_step``, ``pixel_gradient``).
"""

from .api import load_scene, render, render_progressive, render_scene
from .config import MODERN, CompatOptions, RenderOptions
from .film.film import Film, read_png, tonemap, write_png
from .integrator.wavefront import (render_image, render_image_host_chunked,
                                   render_image_stats, render_pixels,
                                   trace_paths)
from .scene.types import (CameraArrays, SceneArrays, SceneMeta,
                          scene_from_numpy, scene_params_from_numpy)

__version__ = "0.1.0"

__all__ = [
    "CameraArrays", "CompatOptions", "Film", "MODERN", "RenderOptions",
    "SceneArrays", "SceneMeta", "load_scene", "read_png", "render",
    "render_image", "render_image_host_chunked", "render_image_stats",
    "render_pixels", "render_progressive", "render_scene", "scene_from_numpy",
    "scene_params_from_numpy", "tonemap", "trace_paths", "write_png",
]
