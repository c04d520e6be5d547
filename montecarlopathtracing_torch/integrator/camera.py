"""Primary ray generation.

Counterpart of ``montecarlopathtracing_tpu/integrator/camera.py`` (reference
``generateImg``, ``MTPC/pathTracing.cpp:276-309``): the screen plane passes
through ``look_at``; ``up`` is normalized but not re-orthogonalized (quirk
#2); pixel (i, j) maps to its top-left lattice corner, and in compat mode
every sample shoots that identical ray (quirk #1).  Modern mode jitters over
the pixel footprint.
"""

from __future__ import annotations

import math

import torch

from ..ops.sampling import cross, normalize
from ..scene.types import CameraArrays


def screen_basis(cam: CameraArrays):
    """Returns (eye, start_point, x_step, y_step) where pixel (i,j) corner =
    start_point + x_step*j - y_step*i."""
    up = normalize(cam.up)
    view = cam.look_at - cam.eye
    l = torch.linalg.vector_norm(view)
    dy = torch.tan(cam.fovy / 2.0 / 180.0 * math.pi) * l
    dx = dy / cam.height * cam.width
    pdx = 2.0 * dx / cam.width
    pdy = 2.0 * dy / cam.height
    x_dir = normalize(cross(view, up))
    start = cam.look_at - x_dir * dx + up * dy
    return cam.eye, start, x_dir * pdx, up * pdy


def primary_rays(cam: CameraArrays, pixel_ids, jitter=None):
    """Rays for flat pixel ids (R,) (row-major, id = i*W + j).

    jitter: optional (R,2) uniforms in [0,1) over the pixel footprint; None
    reproduces the corner-ray quirk.  Returns (origin (R,3), direction (R,3)).
    """
    eye, start, x_step, y_step = screen_basis(cam)
    w = cam.width
    i = torch.div(pixel_ids, w, rounding_mode="floor").to(torch.float32)
    j = torch.remainder(pixel_ids, w).to(torch.float32)
    if jitter is not None:
        j = j + jitter[:, 0]
        i = i + jitter[:, 1]
    pos = start[None, :] + x_step[None, :] * j[:, None] - y_step[None, :] * i[:, None]
    direction = normalize(pos - eye[None, :])
    origin = eye.expand(direction.shape)
    return origin, direction
