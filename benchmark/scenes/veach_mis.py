"""Scene generator ``veach_mis``: a stand-in for the upstream's multiple
importance sampling test scene (scene/veach-mis.{obj,mtl,camera}), laid out
after Veach's figure (thesis, 1997, Fig. 9.2).

Four glossy plates stepped toward the camera, five spherical area lights
above and behind them, a diffuse floor that curves up into a backdrop.  It
keeps what the repository records of the upstream's scene: 3,812 triangles,
five lights of their own materials with 760 faces in all, radiance 901.8,
100, 11.1, 1.23 and 800 in that order (the .camera file's), light areas from
0.011 to 10.06, plates of Phong exponent 100000, 10000, 1000 and 300, a
1200 x 900 camera of fovy 27.39.  What the repository does not record (the
positions, the tessellation, the plates' and the floor's Kd and Ks) is this
file's, and the configuration lists it under ``assumed``.

With the frozen light pick (compat quirk #4) the first light's area, the
smallest, sets the draw's range for all five: the larger lights are sampled
in their first faces only, as the upstream renders them.  The geometry does
not depend on the seed: the run's seed keys the samples.
"""

from __future__ import annotations

import math
import os

import numpy as np

# (material, radiance, centre, target area, longitudes, latitude bands) in
# the .camera file's order; a sphere of n_lon x n_lat has 2 n_lon (n_lat - 1)
# faces, and its radius is scaled so that its faces' area is the target.
LIGHTS = (
    ("Light1", 901.8, (-3.75, 0.0, 0.0), 0.011, 12, 6),
    ("Light2", 100.0, (-1.25, 0.0, 0.0), 0.1067, 16, 6),
    ("Light3", 11.1, (1.25, 0.0, 0.0), 1.036, 16, 6),
    ("Light4", 1.23, (3.75, 0.0, 0.0), 10.06, 16, 6),
    ("Light5", 800.0, (10.0, 10.0, 4.0), 3.0, 16, 6),
)
# (material, Ns, centre (y, z)) from the back (under the lights) to the
# front; each plate spans x in [-PLATE_HALF_WIDTH, PLATE_HALF_WIDTH] and
# PLATE_DEPTH along its slope, tilted so that it mirrors the row of lights
# at (y, z) = (0, 0) into the camera.
PLATES = (
    ("Plate1", 100000.0, (-0.976, 1.0)),
    ("Plate2", 10000.0, (-1.762, 2.3)),
    ("Plate3", 1000.0, (-2.376, 3.6)),
    ("Plate4", 300.0, (-2.818, 4.9)),
)
PLATE_HALF_WIDTH, PLATE_DEPTH = 4.0, 1.0
PLATE_QUADS = (20, 10)            # along x, along the slope
PLATE_KD, PLATE_KS = 0.07, 0.6
FLOOR_KD = 0.4
# The floor (y = -4, z from 12 to -2), a quarter circle of radius 4 up to
# the backdrop (z = -6, y up to 10), x in [-10, 10]: quads along the
# profile (floor, arc, wall) and along x.
FLOOR_QUADS = ((8, 15, 10), 22)
EYE, LOOKAT, FOVY = (0.0, 2.0, 15.0), (0.0, -2.0, 2.5), 27.39


def _unit_sphere(n_lon: int, n_lat: int):
    """(vertices (V, 3) on the unit sphere, faces (F, 3)): pole fans and
    quads split in two, top cap first."""
    verts = [(0.0, 1.0, 0.0)]
    for i in range(1, n_lat):
        th = math.pi * i / n_lat
        for j in range(n_lon):
            ph = 2.0 * math.pi * j / n_lon
            verts.append((math.sin(th) * math.cos(ph), math.cos(th),
                          math.sin(th) * math.sin(ph)))
    verts.append((0.0, -1.0, 0.0))
    bottom = len(verts) - 1

    def ring(i, j):
        return 1 + (i - 1) * n_lon + j % n_lon

    faces = [(0, ring(1, j + 1), ring(1, j)) for j in range(n_lon)]
    for i in range(1, n_lat - 1):
        for j in range(n_lon):
            a, b = ring(i, j), ring(i, j + 1)
            c, d = ring(i + 1, j + 1), ring(i + 1, j)
            faces += [(a, b, c), (a, c, d)]
    faces += [(bottom, ring(n_lat - 1, j), ring(n_lat - 1, j + 1))
              for j in range(n_lon)]
    return np.asarray(verts), np.asarray(faces)


def triangle_areas(v, f):
    e1, e2 = v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]]
    return 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)


def _grid(corner, du, dv, nu: int, nv: int, normal_fn):
    """A patch of nu x nv quads over corner + a du + b dv (a, b in [0, 1]),
    its vertex normals from normal_fn(a, b)."""
    vs, ns, fs = [], [], []
    for b in range(nv + 1):
        for a in range(nu + 1):
            vs.append(corner(a / nu, b / nv) if du is None
                      else np.asarray(corner) + du * (a / nu) + dv * (b / nv))
            ns.append(normal_fn(a / nu, b / nv))
    for b in range(nv):
        for a in range(nu):
            i = b * (nu + 1) + a
            fs += [(i, i + 1, i + nu + 2), (i, i + nu + 2, i + nu + 1)]
    return np.asarray(vs, float), np.asarray(ns, float), np.asarray(fs)


def _plate(y: float, z: float):
    c = np.array([0.0, y, z])
    to_eye = np.subtract(EYE, c)
    to_light = -c
    n = to_eye / np.linalg.norm(to_eye) + to_light / np.linalg.norm(to_light)
    n /= np.linalg.norm(n)
    slope = np.cross(n, [1.0, 0.0, 0.0])    # in the plate, across x
    slope /= np.linalg.norm(slope)
    du = np.array([2 * PLATE_HALF_WIDTH, 0.0, 0.0])
    dv = slope * PLATE_DEPTH
    corner = c - du / 2 - dv / 2
    return _grid(corner, du, dv, *PLATE_QUADS, lambda a, b: n)


def _floor_profile(s: float):
    """(y, z, inward normal (y, z)) at arclength share s of the profile."""
    n_floor, n_arc, n_wall = FLOOR_QUADS[0]
    total = n_floor + n_arc + n_wall
    k = s * total
    if k <= n_floor:
        return -4.0, 12.0 - 14.0 * k / n_floor, (1.0, 0.0)
    if k <= n_floor + n_arc:
        th = 0.5 * math.pi * (k - n_floor) / n_arc
        return -4.0 * math.cos(th), -2.0 - 4.0 * math.sin(th), \
            (math.cos(th), math.sin(th))
    return 10.0 * (k - n_floor - n_arc) / n_wall, -6.0, (0.0, 1.0)


def _floor():
    def corner(a, b):
        y, z, _ = _floor_profile(b)
        return np.array([-10.0 + 20.0 * a, y, z])

    def normal(a, b):
        _, _, (ny, nz) = _floor_profile(b)
        return (0.0, ny, nz)

    return _grid(corner, None, None, FLOOR_QUADS[1], sum(FLOOR_QUADS[0]), normal)


def parts():
    """[(material, vertices (V, 3), vertex normals (V, 3), faces (F, 3))]
    in the order the file writes them: the lights, the plates, the floor."""
    out = []
    for name, _, centre, area, n_lon, n_lat in LIGHTS:
        v, f = _unit_sphere(n_lon, n_lat)
        radius = math.sqrt(area / triangle_areas(v, f).sum())
        out.append((name, v * radius + np.asarray(centre), v, f))
    for name, _, (y, z) in PLATES:
        v, n, f = _plate(y, z)
        out.append((name, v, n, f))
    v, n, f = _floor()
    out.append(("Floor", v, n, f))
    return out


def mtl_text() -> str:
    out = []
    for name, *_ in LIGHTS:
        out += [f"newmtl {name}", "Kd 0 0 0", "Ks 0 0 0", "Ns 1", "Ni 1"]
    for name, ns, _ in PLATES:
        out += [f"newmtl {name}", f"Kd {PLATE_KD} {PLATE_KD} {PLATE_KD}",
                f"Ks {PLATE_KS} {PLATE_KS} {PLATE_KS}", f"Ns {ns:g}", "Ni 1"]
    out += ["newmtl Floor", f"Kd {FLOOR_KD} {FLOOR_KD} {FLOOR_KD}", "Ks 0 0 0",
            "Ns 1", "Ni 1"]
    return "\n".join(out) + "\n"


def obj_text() -> str:
    lines, faces, base = [], [], 1
    for name, v, n, f in parts():
        lines += ["v {!r} {!r} {!r}".format(*p) for p in v.tolist()]
        lines += ["vn {!r} {!r} {!r}".format(*p) for p in n.tolist()]
        lines += ["vt 0 0"] * len(v)
        faces.append(f"usemtl {name}")
        faces += [f"f {a}/{a}/{a} {b}/{b}/{b} {c}/{c}/{c}"
                  for a, b, c in (f + base).tolist()]
        base += len(v)
    return "\n".join(lines + faces) + "\n"


def camera_text(width: int, height: int) -> str:
    cam = ("eye {} {} {}\nlookat {} {} {}\nup 0 1 0\n".format(*EYE, *LOOKAT)
           + f"fovy {FOVY}\nwidth {width}\nheight {height}\n")
    return cam + "".join(f"mtlname {name} {r} {r} {r}\n"
                         for name, r, *_ in LIGHTS)


def write(directory: str, name: str, params: dict, seed: int) -> None:
    """<directory>/<name>.{obj,mtl,camera}."""
    del seed  # the geometry is the deployment's, the same for every seed
    os.makedirs(directory, exist_ok=True)
    for ext, text in (("obj", obj_text()), ("mtl", mtl_text()),
                      ("camera", camera_text(int(params["width"]),
                                             int(params["height"])))):
        with open(os.path.join(directory, f"{name}.{ext}"), "w") as fh:
            fh.write(text)
