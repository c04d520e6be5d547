"""Parse a scene's OBJ / MTL / .camera text and PNG textures into the
reference's float64 tables, in parse order.

The parsers and the PNG decoder are frozen copies of
``montecarlopathtracing_torch/scene/loader.py`` (``parse_mtl``,
``parse_obj``, ``parse_camera``) and ``film/film.py`` (``read_png``) at
commit 8674dbe, kept to the upstream's file semantics (MTPC/
sceneManagement.cpp).  What the program derives from them (its triangle
order, padding, cluster tables, float32 storage) is not rebuilt: the
reference tests every triangle of the scene in the order the file gives
them.  The light CDFs are over each light's faces in parse order, as the
upstream walks ``material_map[name]->f``.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch


class _Material:
    __slots__ = ("name", "kd", "ks", "ns", "ni", "map_kd")

    def __init__(self, name: str):
        self.name = name
        self.kd = np.zeros(3)
        self.ks = np.zeros(3)
        self.ns = 1.0
        self.ni = 1.0
        self.map_kd: Optional[str] = None


def parse_mtl(path: str) -> List[_Material]:
    materials: List[_Material] = []
    cur: Optional[_Material] = None
    with open(path, "r", errors="replace") as fh:
        for raw in fh:
            tok = raw.split()
            if not tok:
                continue
            key = tok[0]
            if key == "newmtl":
                cur = _Material(raw.split(None, 1)[1].strip())
                materials.append(cur)
            elif cur is None:
                continue
            elif key == "Kd":
                cur.kd = np.array([float(x) for x in tok[1:4]])
            elif key == "Ks":
                cur.ks = np.array([float(x) for x in tok[1:4]])
            elif key == "Ns":
                cur.ns = float(tok[1])
            elif key == "Ni":
                cur.ni = float(tok[1])
            elif key == "map_Kd":
                cur.map_kd = raw.split(None, 1)[1].strip()
    return materials


def parse_obj(path: str, material_index: Dict[str, int]):
    """v / vn / vt / usemtl / f (corners v/vt/vn, fan triangulation)."""
    vs, vns, vts = [], [], []
    face_v, face_vt, face_vn, face_mat = [], [], [], []
    cur_mat = 0

    def corner(tok: str):
        parts = tok.split("/")
        vi = int(parts[0])
        ti = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        ni = int(parts[2]) if len(parts) > 2 and parts[2] else 0
        vi = vi - 1 if vi > 0 else len(vs) + vi
        ti = ti - 1 if ti > 0 else (len(vts) + ti if ti < 0 else -1)
        ni = ni - 1 if ni > 0 else (len(vns) + ni if ni < 0 else -1)
        return vi, ti, ni

    with open(path, "r", errors="replace") as fh:
        for raw in fh:
            tok = raw.split()
            if not tok:
                continue
            key = tok[0]
            if key == "v":
                vs.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif key == "vn":
                vns.append((float(tok[1]), float(tok[2]), float(tok[3])))
            elif key == "vt":
                vts.append((float(tok[1]), float(tok[2])))
            elif key == "usemtl":
                cur_mat = material_index.get(raw.split(None, 1)[1].strip(), 0)
            elif key == "f":
                corners = [corner(t) for t in tok[1:]]
                for k in range(1, len(corners) - 1):
                    tri = (corners[0], corners[k], corners[k + 1])
                    face_v.append(tuple(c[0] for c in tri))
                    face_vt.append(tuple(c[1] for c in tri))
                    face_vn.append(tuple(c[2] for c in tri))
                    face_mat.append(cur_mat)
    return (np.asarray(vs, np.float64).reshape(-1, 3),
            np.asarray(vns, np.float64).reshape(-1, 3),
            np.asarray(vts, np.float64).reshape(-1, 2),
            np.asarray(face_v, np.int64).reshape(-1, 3),
            np.asarray(face_vt, np.int64).reshape(-1, 3),
            np.asarray(face_vn, np.int64).reshape(-1, 3),
            np.asarray(face_mat, np.int64).reshape(-1))


def parse_camera(path: str):
    cam = dict(eye=(0, 0, 0), lookat=(0, 0, 1), up=(0, 1, 0), fovy=45.0,
               width=64, height=64)
    lights = []
    with open(path, "r", errors="replace") as fh:
        for raw in fh:
            tok = raw.split()
            if not tok:
                continue
            key = tok[0]
            if key in ("eye", "lookat", "up"):
                cam[key] = tuple(float(x) for x in tok[1:4])
            elif key == "fovy":
                cam["fovy"] = float(tok[1])
            elif key in ("width", "height"):
                cam[key] = int(tok[1])
            elif key == "mtlname":
                lights.append((tok[1], tuple(float(x) for x in tok[2:5])))
    return cam, lights


def _unfilter(ftype: int, line: np.ndarray, prev: np.ndarray, bpp: int):
    out = line.astype(np.int32)
    prev = prev.astype(np.int32)
    if ftype == 0:
        return out
    if ftype == 2:
        return (out + prev) & 0xFF
    for i in range(out.shape[0]):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if ftype == 1:
            pred = a
        elif ftype == 3:
            pred = (a + b) // 2
        elif ftype == 4:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[i] = (out[i] + pred) & 0xFF
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit RGB or RGBA non-interlaced PNG as (H, W, 3) uint8."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(f"{path}: only 8-bit RGB/RGBA non-interlaced PNGs")
    bpp = 3 if ctype == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * bpp)
    rows, prev = [], np.zeros(w * bpp, np.uint8)
    for y in range(h):
        prev = _unfilter(int(raw[y, 0]), raw[y, 1:], prev, bpp).astype(np.uint8)
        rows.append(prev)
    return np.stack(rows).reshape(h, w, bpp)[..., :3]


# Fields that are floating point (rounded by ``RefScene.rounded``).
_FLOAT_FIELDS = ("v0", "v1", "v2", "n0", "n1", "n2", "uv0", "uv1", "uv2",
                 "geom_n", "kd", "ks", "ns", "ni", "atlas", "light_radiance",
                 "light_cum", "light_total", "eye", "look_at", "up")


@dataclasses.dataclass
class RefScene:
    """Every triangle in parse order; floats in ``dtype`` on ``device``.

    ``light_faces[li]`` / ``light_cum[li]`` are light li's triangle ids and
    cumulative areas (padded with the last id and the total to the longest
    list), ``light_total[li]`` its area."""

    v0: torch.Tensor
    v1: torch.Tensor
    v2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    uv0: torch.Tensor
    uv1: torch.Tensor
    uv2: torch.Tensor
    geom_n: torch.Tensor
    mat_id: torch.Tensor
    kd: torch.Tensor
    ks: torch.Tensor
    ns: torch.Tensor
    ni: torch.Tensor
    has_texture: torch.Tensor
    tex_offset: torch.Tensor
    tex_h: torch.Tensor
    tex_w: torch.Tensor
    atlas: torch.Tensor
    light_mat: torch.Tensor
    light_radiance: torch.Tensor
    light_faces: torch.Tensor
    light_cum: torch.Tensor
    light_count: torch.Tensor
    light_total: torch.Tensor
    eye: torch.Tensor
    look_at: torch.Tensor
    up: torch.Tensor
    fovy: float
    width: int
    height: int

    @property
    def num_tris(self) -> int:
        return int(self.v0.shape[0])

    @property
    def num_lights(self) -> int:
        return int(self.light_mat.shape[0])

    def to(self, device=None, dtype=None) -> "RefScene":
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, torch.Tensor):
                if dtype is not None and f.name in _FLOAT_FIELDS:
                    v = v.to(dtype)
                v = v.to(device) if device is not None else v
            kw[f.name] = v
        return RefScene(**kw)

    def rounded(self, dtype) -> "RefScene":
        """The scene as stored in ``dtype``: every float read from the files
        rounded to it and back, and what is derived from them (geometric
        normals, the lights' area CDFs) worked out again from the rounded
        vertices."""
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if f.name in _FLOAT_FIELDS:
                v = v.to(dtype).to(v.dtype)
            elif f.name == "fovy":
                v = float(torch.tensor(v).to(dtype))
            kw[f.name] = v
        p0, p1, p2 = kw["v0"], kw["v1"], kw["v2"]
        gn = torch.linalg.cross(p0 - p1, p2 - p0)
        kw["geom_n"] = gn / torch.clamp(torch.linalg.vector_norm(
            gn, dim=-1, keepdim=True), min=1e-30)
        areas = 0.5 * torch.linalg.vector_norm(torch.linalg.cross(p1 - p0, p2 - p0),
                                               dim=-1)
        slot = torch.arange(self.light_faces.shape[1], device=p0.device)
        valid = slot[None] < self.light_count[:, None]
        cum = torch.cumsum(torch.where(valid, areas[self.light_faces], 0.0), dim=1)
        kw["light_cum"] = torch.where(self.light_count[:, None] > 0, cum,
                                      torch.ones_like(cum))
        kw["light_total"] = kw["light_cum"][:, -1].clone()
        return RefScene(**kw)


def load(scene_dir: str, name: str, device="cpu",
         dtype=torch.float64) -> RefScene:
    """<scene_dir>/<name>.{obj,mtl,camera} and their textures."""
    base = os.path.join(scene_dir, name)
    materials = parse_mtl(base + ".mtl")
    if not materials:
        materials = [_Material("default")]
        materials[0].kd = np.array([0.8, 0.8, 0.8])
    mat_index = {m.name: i for i, m in enumerate(materials)}
    vs, vns, vts, f_v, f_vt, f_vn, f_mat = parse_obj(base + ".obj", mat_index)
    cam, light_list = parse_camera(base + ".camera")
    n = len(f_mat)
    if n == 0:
        raise ValueError(f"scene '{name}' has no faces")

    p0, p1, p2 = vs[f_v[:, 0]], vs[f_v[:, 1]], vs[f_v[:, 2]]
    gn = np.cross(p0 - p1, p2 - p0)
    gn = gn / np.maximum(np.linalg.norm(gn, axis=-1, keepdims=True), 1e-30)
    corners_n = []
    for k in range(3):
        if len(vns):
            nk = np.where(f_vn[:, [k]] >= 0, vns[np.maximum(f_vn[:, k], 0)], 0.0)
            missing = f_vn[:, k] < 0
        else:
            nk = np.zeros_like(p0)
            missing = np.ones(n, bool)
        nk[missing] = gn[missing]
        corners_n.append(nk)
    if len(vts):
        corners_t = [np.where(f_vt[:, [k]] >= 0, vts[np.maximum(f_vt[:, k], 0)],
                              0.0) for k in range(3)]
    else:
        corners_t = [np.zeros((n, 2))] * 3

    num_mat = len(materials)
    has_tex = np.zeros(num_mat, bool)
    tex_off = np.zeros(num_mat, np.int64)
    tex_h = np.ones(num_mat, np.int64)
    tex_w = np.ones(num_mat, np.int64)
    blocks, offset = [], 0
    for i, m in enumerate(materials):
        if m.map_kd is None:
            continue
        path = os.path.join(scene_dir, m.map_kd)
        if not (os.path.exists(path) and path.lower().endswith(".png")):
            continue
        img = read_png(path).astype(np.float64) / 255.0
        has_tex[i] = True
        tex_off[i] = offset
        tex_h[i], tex_w[i] = img.shape[0], img.shape[1]
        blocks.append(img.reshape(-1, 3))
        offset += img.shape[0] * img.shape[1]
    atlas = np.concatenate(blocks) if blocks else np.zeros((0, 3))

    lights = [(mat_index[ln], rad) for ln, rad in light_list if ln in mat_index]
    light_mat = np.array([m for m, _ in lights], np.int64)
    light_rad = np.array([r for _, r in lights], np.float64).reshape(-1, 3)
    areas = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
    faces = [np.nonzero(f_mat == m)[0] for m in light_mat]
    fmax = max([1] + [len(f) for f in faces])
    light_faces = np.zeros((len(faces), fmax), np.int64)
    light_cum = np.ones((len(faces), fmax))
    light_total = np.ones(len(faces))
    for li, idx in enumerate(faces):
        if len(idx) == 0:
            continue
        cum = np.cumsum(areas[idx])
        light_faces[li, :len(idx)] = idx
        light_faces[li, len(idx):] = idx[-1]
        light_cum[li, :len(idx)] = cum
        light_cum[li, len(idx):] = cum[-1]
        light_total[li] = cum[-1]
    light_count = np.array([len(f) for f in faces], np.int64)

    def f(a):
        return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                               device=device)

    def i(a):
        return torch.as_tensor(np.asarray(a), device=device)

    return RefScene(
        v0=f(p0), v1=f(p1), v2=f(p2),
        n0=f(corners_n[0]), n1=f(corners_n[1]), n2=f(corners_n[2]),
        uv0=f(corners_t[0]), uv1=f(corners_t[1]), uv2=f(corners_t[2]),
        geom_n=f(gn), mat_id=i(f_mat),
        kd=f([m.kd for m in materials]), ks=f([m.ks for m in materials]),
        ns=f([m.ns for m in materials]), ni=f([m.ni for m in materials]),
        has_texture=i(has_tex), tex_offset=i(tex_off), tex_h=i(tex_h),
        tex_w=i(tex_w), atlas=f(atlas),
        light_mat=i(light_mat), light_radiance=f(light_rad),
        light_faces=i(light_faces), light_cum=f(light_cum),
        light_count=i(light_count), light_total=f(light_total),
        eye=f(cam["eye"]), look_at=f(cam["lookat"]), up=f(cam["up"]),
        fovy=float(cam["fovy"]), width=int(cam["width"]),
        height=int(cam["height"]))
