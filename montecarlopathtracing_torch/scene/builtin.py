"""Built-in procedural test scenes, emitted as OBJ/MTL/.camera text (or parsed
buffers) so demos and tests exercise the real parsers without external
assets.  Counterpart of ``montecarlopathtracing_tpu/scene/builtin.py``: the
same geometry, materials and cameras, so both packages build identical
scenes."""

from __future__ import annotations

import os
import tempfile
from typing import Optional

from ..config import RenderOptions


def box_scene_text(light_radiance=(30.0, 30.0, 30.0), with_specular=False,
                   with_glass=False, with_texture=False, width=32, height=32):
    """A cornell-like box: 5 diffuse walls + area light; optional glossy floor
    panel, glass panel, and checker-textured back wall (``with_texture``
    references ``checker.png`` via map_Kd, exercising the reference's
    nearest-neighbor frac-wrap texel fetch, quirk #8).  Geometry stays inside
    the compat Morton bounds [-1, 4]. Returns (obj_text, mtl_text, camera_text)."""
    mtl = """newmtl White
Kd 0.75 0.75 0.75
Ks 0 0 0
Ns 1
Ni 1
newmtl Red
Kd 0.63 0.065 0.05
Ks 0 0 0
Ns 1
Ni 1
newmtl Green
Kd 0.14 0.45 0.091
Ks 0 0 0
Ns 1
Ni 1
newmtl Light
Kd 0 0 0
Ks 0 0 0
Ns 1
Ni 1
"""
    if with_specular:
        mtl += """newmtl Mirror
Kd 0.05 0.05 0.05
Ks 0.9 0.9 0.9
Ns 500
Ni 1
"""
    if with_glass:
        mtl += """newmtl Glass
Kd 0 0 0
Ks 0.9 0.9 0.9
Ns 1000
Ni 1.5
"""
    if with_texture:
        mtl += """newmtl Checker
Kd 1 1 1
Ks 0 0 0
Ns 1
Ni 1
map_Kd checker.png
"""

    verts = []
    uvs = []
    faces = []

    def add_quad(p, mtlname, uv=None):
        base = len(verts) + 1
        verts.extend(p)
        if uv is None:
            faces.append(((base, base + 1, base + 2), None, mtlname))
            faces.append(((base, base + 2, base + 3), None, mtlname))
        else:
            tbase = len(uvs) + 1
            uvs.extend(uv)
            faces.append(((base, base + 1, base + 2),
                          (tbase, tbase + 1, tbase + 2), mtlname))
            faces.append(((base, base + 2, base + 3),
                          (tbase, tbase + 2, tbase + 3), mtlname))

    add_quad([(0, 0, 0), (2, 0, 0), (2, 0, 2), (0, 0, 2)], "White")      # floor
    add_quad([(0, 2, 0), (0, 2, 2), (2, 2, 2), (2, 2, 0)], "White")      # ceiling
    add_quad([(0, 0, 0), (0, 2, 0), (2, 2, 0), (2, 0, 0)],
             "Checker" if with_texture else "White",
             uv=[(0, 0), (1, 0), (1, 1), (0, 1)] if with_texture else None)  # back
    add_quad([(0, 0, 0), (0, 0, 2), (0, 2, 2), (0, 2, 0)], "Red")        # left
    add_quad([(2, 0, 0), (2, 2, 0), (2, 2, 2), (2, 0, 2)], "Green")      # right
    add_quad([(0.7, 1.98, 0.7), (1.3, 1.98, 0.7), (1.3, 1.98, 1.3), (0.7, 1.98, 1.3)], "Light")
    if with_specular:
        add_quad([(0.4, 0.01, 0.4), (1.6, 0.01, 0.4), (1.6, 0.01, 1.6), (0.4, 0.01, 1.6)], "Mirror")
    if with_glass:
        add_quad([(0.5, 0.4, 1.7), (1.5, 0.4, 1.7), (1.5, 1.4, 1.7), (0.5, 1.4, 1.7)], "Glass")

    lines = [f"v {v[0]} {v[1]} {v[2]}" for v in verts]
    lines += [f"vt {t[0]} {t[1]}" for t in uvs]
    cur = None
    for tri, tuv, mtlname in faces:
        if mtlname != cur:
            lines.append(f"usemtl {mtlname}")
            cur = mtlname
        if tuv is None:
            lines.append("f {0} {1} {2}".format(*tri))
        else:
            lines.append("f {0}/{3} {1}/{4} {2}/{5}".format(*tri, *tuv))
    obj = "\n".join(lines) + "\n"

    cam = (
        f"eye 1 1 4.5\nlookat 1 1 0\nup 0 1 0\nfovy 39\n"
        f"width {width}\nheight {height}\n"
        f"mtlname Light {light_radiance[0]} {light_radiance[1]} {light_radiance[2]}\n"
    )
    return obj, mtl, cam


def write_box_scene(directory: str, name: str = "box", **kw) -> str:
    obj, mtl, cam = box_scene_text(**kw)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, name + ".obj"), "w") as f:
        f.write(obj)
    with open(os.path.join(directory, name + ".mtl"), "w") as f:
        f.write(mtl)
    with open(os.path.join(directory, name + ".camera"), "w") as f:
        f.write(cam)
    if kw.get("with_texture"):
        import numpy as np

        from ..film.film import write_png

        # 8x8 red/blue checkerboard (distinct channels so tests can assert
        # which texel a uv hit).  Written by the port's own PNG encoder, so
        # writing needs no imaging library (reading it back at load time
        # does, as in the loader's texture path).
        yy, xx = np.mgrid[0:8, 0:8]
        check = ((yy + xx) % 2).astype(np.uint8)
        img = np.zeros((8, 8, 3), np.uint8)
        img[..., 0] = np.where(check == 0, 255, 16)
        img[..., 2] = np.where(check == 1, 255, 16)
        write_png(os.path.join(directory, "checker.png"), img)
    return directory


def load_builtin_box(options: Optional[RenderOptions] = None, name: str = "box",
                     device=None, **kw):
    """Build the box scene in a temp dir and load it onto ``device`` (None =
    the card). Returns (scene, meta)."""
    from .loader import build_scene

    with tempfile.TemporaryDirectory() as d:
        write_box_scene(d, name, **kw)
        return build_scene(d, name, options or RenderOptions(), device=device)


def load_builtin_large(n_tris: int = 400_000,
                       options: Optional[RenderOptions] = None,
                       width: int = 1280, height: int = 720, seed: int = 0,
                       n_materials: int = 96, n_textures: int = 8,
                       device=None):
    """Procedural bedroom-class workload: a closed room filled with a grid of
    UV-sphere 'props' on a textured floor, one area light — ~``n_tris``
    triangles (the reference's largest artifact is the unshipped 1280x720
    bedroom, result/bedroom-SPP256.png and README.md:20-21; same resolution
    and non-square aspect here by default).  Exercises the full workload
    envelope the small scenes miss: ``n_materials`` >= 96 materials (past the
    64-material one-hot-matmul cutoff in wavefront._material_rows, forcing
    the gather path) and a multi-texture atlas of ``n_textures`` images of
    mixed extents.  Geometry sits inside the compat Morton bounds [-1, 4].
    Built directly as parsed buffers (no OBJ text round-trip) and fed through
    the normal build_scene pipeline (Morton sort, gap clustering, light CDFs).

    The prop textures are written with PIL; where PIL is missing they are
    skipped, as the loader itself drops textures it cannot decode.

    Returns (scene, meta) on ``device`` (None = the card).
    """
    import numpy as np

    from .loader import MaterialRecord, build_scene

    rng = np.random.default_rng(seed)

    verts = []
    vnorms = []
    face_v = []
    face_vn = []
    face_mat = []

    def add_quad(p, m):
        b = len(verts)
        verts.extend(p)
        n = np.cross(np.subtract(p[1], p[0]), np.subtract(p[2], p[0]))
        n = n / max(np.linalg.norm(n), 1e-12)
        vnorms.extend([n] * 4)
        face_v.extend([(b, b + 1, b + 2), (b, b + 2, b + 3)])
        face_vn.extend([(b, b + 1, b + 2), (b, b + 2, b + 3)])
        face_mat.extend([m, m])

    # Room [0, 3]^3: floor(textured)=0, walls=1, ceiling=1, light=2.
    add_quad([(0, 0, 0), (3, 0, 0), (3, 0, 3), (0, 0, 3)], 0)          # floor
    add_quad([(0, 3, 0), (0, 3, 3), (3, 3, 3), (3, 3, 0)], 1)          # ceiling
    add_quad([(0, 0, 0), (0, 3, 0), (3, 3, 0), (3, 0, 0)], 1)          # back
    add_quad([(0, 0, 0), (0, 0, 3), (0, 3, 3), (0, 3, 0)], 1)          # left
    add_quad([(3, 0, 0), (3, 3, 0), (3, 3, 3), (3, 0, 3)], 1)          # right
    add_quad([(1.2, 2.98, 1.2), (1.8, 2.98, 1.2), (1.8, 2.98, 1.8),
              (1.2, 2.98, 1.8)], 2)                                    # light

    # Sphere props: grid sized so total triangles ~ n_tris.
    # One UV sphere with S stacks: 2*S*S triangles.
    n_prop_mats = max(4, n_materials - 3)
    S = 12
    per = 2 * S * S
    n_spheres = max(1, (n_tris - len(face_mat)) // per)
    g = int(np.ceil(np.sqrt(n_spheres)))
    th = np.linspace(0, np.pi, S + 1)
    ph = np.linspace(0, 2 * np.pi, S + 1)
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    unit = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                     np.sin(tt) * np.sin(pp)], axis=-1)  # (S+1, S+1, 3)

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
            idx = np.arange((S + 1) * (S + 1)).reshape(S + 1, S + 1)
            a_, b_ = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
            c_, d_ = idx[1:, 1:].ravel(), idx[1:, :-1].ravel()
            for t1, t2, t3 in ((a_, b_, c_), (a_, c_, d_)):
                face_v.extend(zip(b + t1, b + t2, b + t3))
                face_vn.extend(zip(b + t1, b + t2, b + t3))
            face_mat.extend([3 + (placed % n_prop_mats)] * (2 * S * S))
            placed += 1

    mats = []
    floor = MaterialRecord("Floor")
    floor.kd = np.array([1.0, 1.0, 1.0])
    floor.map_kd = "cherry-wood-texture.jpg"
    mats.append(floor)
    wall = MaterialRecord("Wall")
    wall.kd = np.array([0.7, 0.7, 0.72])
    mats.append(wall)
    light = MaterialRecord("Light")
    mats.append(light)
    # Prop materials: a deterministic spread of diffuse albedos, every 5th
    # glossy (Phong Ns 50..800), every (n_prop_mats // max(n_extra_tex, 1))-th
    # textured — so a bedroom-class instance exercises the >64-material
    # gather path AND a multi-texture atlas of mixed extents.
    n_extra_tex = max(0, n_textures - 1)  # beyond the cherry-wood floor
    mat_rng = np.random.default_rng(seed + 1)
    tex_stride = max(1, n_prop_mats // n_extra_tex) if n_extra_tex else 0
    for i in range(n_prop_mats):
        mrec = MaterialRecord(f"Prop{i}")
        hue = mat_rng.uniform(size=3)
        mrec.kd = np.asarray(0.15 + 0.7 * hue / max(hue.sum(), 1e-6))
        if i % 5 == 4:
            mrec.ks = np.array([0.3, 0.3, 0.3])
            mrec.ns = float(mat_rng.choice([50.0, 200.0, 800.0]))
        if n_extra_tex and i % tex_stride == 0 and i // tex_stride < n_extra_tex:
            mrec.map_kd = f"prop-tex-{i // tex_stride}.png"
        mats.append(mrec)

    vs = np.asarray(verts, np.float64)
    vns_arr = np.asarray(vnorms, np.float64)
    # Planar floor uvs derived from vertex position (u, v) = (x, z)/3.
    vts_arr = np.stack([vs[:, 0] / 3.0, vs[:, 2] / 3.0], axis=1)
    f_v = np.asarray(face_v, np.int64)
    obj = (vs, vns_arr, vts_arr, f_v, f_v.copy(), np.asarray(face_vn, np.int64),
           np.asarray(face_mat, np.int64))
    cam = dict(eye=(1.5, 1.5, 8.2), lookat=(1.5, 1.5, 1.5), up=(0, 1, 0),
               fovy=25.0, width=width, height=height)
    lights = [("Light", (40.0, 40.0, 40.0))]
    mat_index = {m.name: i for i, m in enumerate(mats)}

    with tempfile.TemporaryDirectory() as d:
        import shutil

        tex = os.path.join(os.path.dirname(__file__), "..", "..", "tests",
                           "golden", "cherry-wood-texture.jpg")
        if os.path.exists(tex):
            shutil.copy(tex, d)
        else:
            floor.map_kd = None
        # Deterministic procedural prop textures at mixed extents (128/256):
        # distinct per-texture stripes/checker phases so atlas offsets are
        # testable, non-uniform sizes so per-material (offset, h, w) rows are
        # actually exercised.
        for k in range(n_extra_tex):
            try:
                from PIL import Image
            except ImportError:
                break  # _load_texture cannot decode them without PIL either
            side = 128 if k % 2 == 0 else 256
            yy, xx = np.mgrid[0:side, 0:side]
            img = np.zeros((side, side, 3), np.uint8)
            img[..., 0] = (127 + 120 * np.sin((xx + 7 * k) * 0.21)).astype(np.uint8)
            img[..., 1] = (((yy >> (3 + k % 3)) + (xx >> (3 + k % 3))) % 2) * 180 + 40
            img[..., 2] = (40 + 25 * k) % 256
            Image.fromarray(img).save(os.path.join(d, f"prop-tex-{k}.png"))
        return build_scene(d, "large", options or RenderOptions(),
                           parsed=(mats, mat_index, obj, cam, lights),
                           device=device)
