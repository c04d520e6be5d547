"""Top-level user API.

Counterpart of ``montecarlopathtracing_tpu/api.py``; parity surface with the
reference's main program (``render_scene(path, filename, SPP)``,
``MTPC/MTPC.cpp:35-68``): parse -> cluster order -> render -> PNG, with the
two phase timings logged.  Every entry point takes ``device`` (None = the
card) and raises when CUDA is requested on a machine without one.
"""

from __future__ import annotations

import os
import time
from typing import Optional, Tuple

import torch

from .config import RenderOptions
from .film.film import (Film, load_checkpoint, output_name, save_checkpoint,
                        tonemap, write_png)
from .integrator.wavefront import render_image, render_image_host_chunked
from .scene.types import SceneArrays, SceneMeta
from .utils.device import resolve_device
from .utils.logging import get_logger

log = get_logger(__name__)


def load_scene(scene_dir: str, name: str, options: Optional[RenderOptions] = None,
               device=None) -> Tuple[SceneArrays, SceneMeta]:
    """Parse <dir>/<name>.{obj,mtl,camera} into tensors on ``device`` with the
    Python parser (the C++ loader of scene/native.py is not ported yet)."""
    from .scene.loader import build_scene

    return build_scene(scene_dir, name, options or RenderOptions(), device=device)


def render(scene: SceneArrays, options: Optional[RenderOptions] = None,
           bvh=None, device=None):
    """Render to a (H,W,3) float32 radiance tensor (pre-tonemap)."""
    return render_image(scene, bvh, options or RenderOptions(), device=device)


def render_progressive(scene: SceneArrays, options: RenderOptions, bvh=None,
                       film: Optional[Film] = None,
                       checkpoint_path: Optional[str] = None, device=None):
    """Render options.spp samples in chunks of options.spp_chunk, folding each
    chunk into a Film.  Resumable: pass the previous Film, or a
    checkpoint_path to load from and save to.  Chunk k renders absolute
    sample indices [k*c, (k+1)*c) of the same per-pixel RNG streams a
    one-shot render consumes."""
    device = resolve_device(device)
    scene = scene.to(device)
    h, w = scene.camera.height, scene.camera.width
    if film is None:
        if checkpoint_path and os.path.exists(checkpoint_path):
            try:
                film = load_checkpoint(checkpoint_path, device)
                log.info("resumed film at %s samples", float(film.n_samples))
            except Exception as exc:
                # A corrupt or truncated checkpoint must not wedge the render:
                # sample-offset keying makes starting over idempotent.
                log.warning("checkpoint %s unreadable (%s); restarting render",
                            checkpoint_path, exc)
                film = Film.zeros(h, w, device)
        else:
            film = Film.zeros(h, w, device)
    film = film.to(device)
    done = int(film.n_samples)
    while done < options.spp:
        n = min(options.spp_chunk, options.spp - done)
        img = render_image(scene, bvh, options.replace(spp=n), sample_offset=done,
                           device=device)
        film = film.add(img, float(n))
        done += n
        if checkpoint_path:
            save_checkpoint(checkpoint_path, film)
    return film


def render_scene(scene_dir: str, name: str, spp: int = 25,
                 options: Optional[RenderOptions] = None,
                 out_dir: str = "result", write: bool = True,
                 gamma: bool = False, device=None, stats: Optional[dict] = None):
    """Reference-parity render: returns (image (H,W,3) f32 tensor, PNG path).

    Logs the two phase timings ("Phase 1 read scene", "Phase 2 ray
    tracing").  A ``stats`` dict, if given, receives the phase seconds and
    the rays traced.
    """
    device = resolve_device(device)
    options = (options or RenderOptions()).replace(spp=spp)

    t0 = time.perf_counter()
    scene, meta = load_scene(scene_dir, name, options, device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    log.info("Phase 1 (read scene) time cost = %.1f ms", (t1 - t0) * 1e3)
    log.info("scene '%s': %d verts, %d faces (%d padded), %d materials, %d lights",
             name, meta.num_vertices, meta.num_faces, scene.num_tris_padded,
             scene.num_materials, scene.num_lights)

    t2 = time.perf_counter()
    img, n_rays = render_image_host_chunked(
        scene, None, options, device=device,
        progress=lambda i, n: log.info("chunk %d/%d", i, n))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t3 = time.perf_counter()
    log.info("Phase 2 (ray tracing) = %.1f ms  (%.2e rays/s)",
             (t3 - t2) * 1e3, n_rays / (t3 - t2))

    path = None
    if write:
        path = output_name(out_dir, name, spp)
        write_png(path, tonemap(img, gamma=gamma))
        log.info("wrote %s", path)
    if stats is not None:
        stats.update(phase1_s=t1 - t0, phase2_s=t3 - t2, rays=n_rays)
    return img, path
