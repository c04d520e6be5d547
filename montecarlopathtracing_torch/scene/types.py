"""Device-side scene representation: structure-of-arrays tensors.

Counterpart of ``montecarlopathtracing_tpu/scene/types.py``.  T = padded
triangle count (a power of two; padding rows are +inf, material 0,
``tri_valid`` False), M = materials, L = lights, F = max faces per light.
A scene is this system's counterpart of a model's weights, and
``scene_from_numpy`` builds one from another package's arrays so both
packages can be fed bit-identical inputs.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Mapping

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class CameraArrays:
    """Pinhole camera: eye, look_at, up (3,) f32, fovy () f32 in degrees, and
    the film resolution."""

    eye: Any
    look_at: Any
    up: Any
    fovy: Any
    width: int
    height: int

    def to(self, device) -> "CameraArrays":
        return dataclasses.replace(
            self, eye=self.eye.to(device), look_at=self.look_at.to(device),
            up=self.up.to(device), fovy=self.fovy.to(device))


# Tensor fields of SceneArrays, in declaration order (camera excluded).
SCENE_FIELDS = (
    "v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2", "geom_n",
    "mat_id", "tri_valid",
    "kd", "ks", "ns", "ni", "emission", "is_emitter", "has_texture",
    "tex_offset", "tex_h", "tex_w", "atlas",
    "light_mat", "light_radiance", "light_face_tri", "light_face_cum_area",
    "light_total_area",
)


@dataclasses.dataclass(frozen=True)
class SceneArrays:
    """SoA scene tensors."""

    # Triangles (cluster order, see scene/loader.py).  Padding rows are +inf.
    v0: Any  # (T,3) f32 vertex positions
    v1: Any
    v2: Any
    n0: Any  # (T,3) f32 per-corner shading normals
    n1: Any
    n2: Any
    uv0: Any  # (T,2) f32 texture coords
    uv1: Any
    uv2: Any
    geom_n: Any  # (T,3) f32 unit geometric normal
    mat_id: Any  # (T,) i32
    tri_valid: Any  # (T,) bool

    # Materials.
    kd: Any  # (M,3)
    ks: Any  # (M,3)
    ns: Any  # (M,)
    ni: Any  # (M,)
    emission: Any  # (M,3)
    is_emitter: Any  # (M,) bool
    has_texture: Any  # (M,) bool
    tex_offset: Any  # (M,) i32 into the atlas
    tex_h: Any  # (M,) i32
    tex_w: Any  # (M,) i32

    # Texture atlas (sum(h*w), 3) f32; untextured scenes carry shape (0, 3).
    atlas: Any

    # Lights.
    light_mat: Any  # (L,) i32
    light_radiance: Any  # (L,3)
    light_face_tri: Any  # (L,F) i32
    light_face_cum_area: Any  # (L,F)
    light_total_area: Any  # (L,)

    camera: CameraArrays

    @property
    def num_tris_padded(self) -> int:
        return self.v0.shape[0]

    @property
    def num_materials(self) -> int:
        return self.kd.shape[0]

    @property
    def num_lights(self) -> int:
        return self.light_mat.shape[0]

    @property
    def device(self) -> torch.device:
        return self.v0.device

    @functools.cached_property
    def tri_records(self):
        """(T, 12) f32, one 48-byte row per triangle slot: v0, v1, v2,
        geom_n, and NaN throughout where ``tri_valid`` is False (a NaN
        triangle's test fails, so the validity flag needs no read of its
        own).  The walk kernels' layout (a triangle in three 16-byte loads),
        made once per SceneArrays on first use."""
        rec = torch.cat([self.v0, self.v1, self.v2, self.geom_n], dim=1).detach()
        return torch.where(self.tri_valid[:, None], rec,
                           torch.full_like(rec, float("nan"))).contiguous()

    def to(self, device) -> "SceneArrays":
        """The same scene with every tensor on ``device`` (tensors already
        there are shared, not copied)."""
        moved = {f: getattr(self, f).to(device) for f in SCENE_FIELDS}
        return SceneArrays(**moved, camera=self.camera.to(device))


@dataclasses.dataclass
class SceneMeta:
    """Host-side metadata kept next to a SceneArrays."""

    name: str
    material_names: list
    light_names: list
    num_vertices: int
    num_faces: int  # un-padded triangle count
    obj_path: str = ""


def pad_pow2(n: int) -> int:
    """Smallest power of two >= n."""
    return 1 if n <= 1 else int(2 ** int(np.ceil(np.log2(n))))


_CAMERA_KEYS = ("eye", "look_at", "up", "fovy")


def scene_from_numpy(fields: Mapping[str, np.ndarray], camera: Mapping[str, Any],
                     device) -> SceneArrays:
    """Build a SceneArrays from numpy arrays (e.g. another package's scene
    pulled to the host with ``np.asarray``), keeping every dtype and value.

    ``fields`` maps each name in SCENE_FIELDS to an array; ``camera`` maps
    eye / look_at / up / fovy to arrays and width / height to ints.
    """
    device = torch.device(device)
    tensors = {f: torch.tensor(np.asarray(fields[f]), device=device)
               for f in SCENE_FIELDS}
    cam = CameraArrays(
        **{k: torch.tensor(np.asarray(camera[k], np.float32), device=device)
           for k in _CAMERA_KEYS},
        width=int(camera["width"]), height=int(camera["height"]))
    return SceneArrays(**tensors, camera=cam)


def scene_params_from_numpy(fields: Mapping[str, np.ndarray], device):
    """Build a ``diff.gradients.SceneParams`` from numpy arrays (another
    package's parameters pulled to the host, perturbed or not), keeping
    every dtype and value.  ``fields`` maps kd, ks, ns, light_radiance and
    atlas to arrays."""
    from ..diff.gradients import PARAM_FIELDS, SceneParams

    device = torch.device(device)
    return SceneParams(**{f: torch.tensor(np.asarray(fields[f]), device=device)
                          for f in PARAM_FIELDS})
