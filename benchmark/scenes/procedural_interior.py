"""Scene generator ``procedural_interior``: a textured room of ~400k
triangles, one area light, 96 materials and an 8-image texture atlas.

Frozen copy of the geometry, materials, textures and camera of
``montecarlopathtracing_torch/scene/builtin.py::load_builtin_large`` at
commit 8674dbe (a room [0, 3]^3 open at the front, a grid of UV-sphere
props on a textured floor), written as OBJ / MTL / .camera text with PNG
textures.  The floor is a copy of the port's cherry-wood texture, kept in
``assets/``; the seven prop textures are drawn as that function draws them.
The layout and the materials come from the configuration's ``scene_seed``
(0: the port's built-in interior), not from the run's seed, which keys the
samples: every run renders the same deployment.
"""

from __future__ import annotations

import os
import shutil
import struct
import zlib

import numpy as np

FLOOR_TEXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "assets", "cherry-wood-texture.png")


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """(H, W, 3) uint8 as an 8-bit RGB PNG, filter 0 on every row."""
    h, w, _ = arr.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)],
                         axis=1).tobytes()
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                 + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def _geometry(n_tris: int, n_materials: int, rng):
    verts, vnorms, face_v, face_mat = [], [], [], []

    def add_quad(p, m):
        b = len(verts)
        verts.extend(p)
        n = np.cross(np.subtract(p[1], p[0]), np.subtract(p[2], p[0]))
        n = n / max(np.linalg.norm(n), 1e-12)
        vnorms.extend([n] * 4)
        face_v.extend([(b, b + 1, b + 2), (b, b + 2, b + 3)])
        face_mat.extend([m, m])

    add_quad([(0, 0, 0), (3, 0, 0), (3, 0, 3), (0, 0, 3)], 0)          # floor
    add_quad([(0, 3, 0), (0, 3, 3), (3, 3, 3), (3, 3, 0)], 1)          # ceiling
    add_quad([(0, 0, 0), (0, 3, 0), (3, 3, 0), (3, 0, 0)], 1)          # back
    add_quad([(0, 0, 0), (0, 0, 3), (0, 3, 3), (0, 3, 0)], 1)          # left
    add_quad([(3, 0, 0), (3, 3, 0), (3, 3, 3), (3, 0, 3)], 1)          # right
    add_quad([(1.2, 2.98, 1.2), (1.8, 2.98, 1.2), (1.8, 2.98, 1.8),
              (1.2, 2.98, 1.8)], 2)                                    # light

    n_prop_mats = max(4, n_materials - 3)
    s = 12
    per = 2 * s * s
    n_spheres = max(1, (n_tris - len(face_mat)) // per)
    g = int(np.ceil(np.sqrt(n_spheres)))
    th = np.linspace(0, np.pi, s + 1)
    ph = np.linspace(0, 2 * np.pi, s + 1)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    unit = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                     np.sin(tt) * np.sin(pp)], axis=-1)
    idx = np.arange((s + 1) * (s + 1)).reshape(s + 1, s + 1)
    a_, b_ = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    c_, d_ = idx[1:, 1:].ravel(), idx[1:, :-1].ravel()
    placed = 0
    for gy in range(g):
        for gx in range(g):
            if placed >= n_spheres:
                break
            cx = 0.25 + 2.5 * (gx + 0.5) / g
            cz = 0.25 + 2.5 * (gy + 0.5) / g
            rad = min(1.0 / g, 0.12) * rng.uniform(0.6, 1.0)
            cy = rad + rng.uniform(0.0, 1.2)
            pts = unit * rad + np.array([cx, cy, cz])
            b = len(verts)
            verts.extend(pts.reshape(-1, 3))
            vnorms.extend(unit.reshape(-1, 3))
            for t1, t2, t3 in ((a_, b_, c_), (a_, c_, d_)):
                face_v.extend(zip(b + t1, b + t2, b + t3))
            face_mat.extend([3 + (placed % n_prop_mats)] * per)
            placed += 1
    return (np.asarray(verts, np.float64), np.asarray(vnorms, np.float64),
            np.asarray(face_v, np.int64), np.asarray(face_mat, np.int64),
            n_prop_mats)


def _materials(n_prop_mats: int, n_textures: int, seed: int) -> str:
    out = ["newmtl Floor", "Kd 1.0 1.0 1.0", "Ks 0 0 0", "Ns 1.0", "Ni 1.0",
           "map_Kd cherry-wood-texture.png",
           "newmtl Wall", "Kd 0.7 0.7 0.72", "Ks 0 0 0", "Ns 1.0", "Ni 1.0",
           "newmtl Light", "Kd 0 0 0", "Ks 0 0 0", "Ns 1.0", "Ni 1.0"]
    n_extra_tex = max(0, n_textures - 1)
    mat_rng = np.random.default_rng(seed + 1)
    tex_stride = max(1, n_prop_mats // n_extra_tex) if n_extra_tex else 0
    for i in range(n_prop_mats):
        hue = mat_rng.uniform(size=3)
        kd = 0.15 + 0.7 * hue / max(hue.sum(), 1e-6)
        ks, ns = (0.0, 0.0, 0.0), 1.0
        if i % 5 == 4:
            ks = (0.3, 0.3, 0.3)
            ns = float(mat_rng.choice([50.0, 200.0, 800.0]))
        out += [f"newmtl Prop{i}", "Kd {!r} {!r} {!r}".format(*kd.tolist()),
                "Ks {} {} {}".format(*ks), f"Ns {ns!r}", "Ni 1.0"]
        if n_extra_tex and i % tex_stride == 0 and i // tex_stride < n_extra_tex:
            out.append(f"map_Kd prop-tex-{i // tex_stride}.png")
    return "\n".join(out) + "\n"


def _prop_texture(k: int) -> np.ndarray:
    side = 128 if k % 2 == 0 else 256
    yy, xx = np.mgrid[0:side, 0:side]
    img = np.zeros((side, side, 3), np.uint8)
    img[..., 0] = (127 + 120 * np.sin((xx + 7 * k) * 0.21)).astype(np.uint8)
    img[..., 1] = (((yy >> (3 + k % 3)) + (xx >> (3 + k % 3))) % 2) * 180 + 40
    img[..., 2] = (40 + 25 * k) % 256
    return img


def write(directory: str, name: str, params: dict, seed: int) -> None:
    """<directory>/<name>.{obj,mtl,camera} and the textures beside them."""
    del seed  # the layout is the configuration's (scene_seed)
    scene_seed = int(params["scene_seed"])
    vs, vn, f_v, f_mat, n_prop = _geometry(
        int(params["n_tris"]), int(params["n_materials"]),
        np.random.default_rng(scene_seed))
    mat_names = ["Floor", "Wall", "Light"] + [f"Prop{i}" for i in range(n_prop)]
    vt = np.stack([vs[:, 0] / 3.0, vs[:, 2] / 3.0], axis=1)
    lines = ["v {!r} {!r} {!r}".format(*p) for p in vs.tolist()]
    lines += ["vn {!r} {!r} {!r}".format(*p) for p in vn.tolist()]
    lines += ["vt {!r} {!r}".format(*p) for p in vt.tolist()]
    cur = None
    one = f_v + 1
    for (a, b, c), m in zip(one.tolist(), f_mat.tolist()):
        if m != cur:
            lines.append(f"usemtl {mat_names[m]}")
            cur = m
        lines.append(f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}")
    os.makedirs(directory, exist_ok=True)
    r, g, b = params["light_radiance"]
    cam = (f"eye 1.5 1.5 8.2\nlookat 1.5 1.5 1.5\nup 0 1 0\nfovy 25.0\n"
           f"width {params['width']}\nheight {params['height']}\n"
           f"mtlname Light {r} {g} {b}\n")
    mtl = _materials(n_prop, int(params["n_textures"]), scene_seed)
    for ext, text in (("obj", "\n".join(lines) + "\n"), ("mtl", mtl),
                      ("camera", cam)):
        with open(os.path.join(directory, f"{name}.{ext}"), "w") as fh:
            fh.write(text)
    shutil.copyfile(FLOOR_TEXTURE,
                    os.path.join(directory, "cherry-wood-texture.png"))
    for k in range(max(0, int(params["n_textures"]) - 1)):
        write_png(os.path.join(directory, f"prop-tex-{k}.png"), _prop_texture(k))
