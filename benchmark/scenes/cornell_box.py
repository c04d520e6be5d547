"""Scene generator ``cornell_box``: a Cornell-like box of 12 triangles.

Frozen copy of the geometry, materials and camera of
``montecarlopathtracing_torch/scene/builtin.py::box_scene_text`` at commit
8674dbe (five diffuse walls and an area light, inside the compat Morton
bounds [-1, 4]), written as OBJ / MTL / .camera text.  The configuration
sets the resolution and the light's radiance.  The geometry does not depend
on the seed: the run's seed keys the samples.
"""

from __future__ import annotations

import os

MTL = """newmtl White
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

QUADS = (
    ([(0, 0, 0), (2, 0, 0), (2, 0, 2), (0, 0, 2)], "White"),      # floor
    ([(0, 2, 0), (0, 2, 2), (2, 2, 2), (2, 2, 0)], "White"),      # ceiling
    ([(0, 0, 0), (0, 2, 0), (2, 2, 0), (2, 0, 0)], "White"),      # back
    ([(0, 0, 0), (0, 0, 2), (0, 2, 2), (0, 2, 0)], "Red"),        # left
    ([(2, 0, 0), (2, 2, 0), (2, 2, 2), (2, 0, 2)], "Green"),      # right
    ([(0.7, 1.98, 0.7), (1.3, 1.98, 0.7), (1.3, 1.98, 1.3), (0.7, 1.98, 1.3)],
     "Light"),
)


def write(directory: str, name: str, params: dict, seed: int) -> None:
    """<directory>/<name>.{obj,mtl,camera}."""
    del seed  # the geometry is the deployment's, the same for every seed
    lines, cur = [], None
    for q, (pts, mtl) in enumerate(QUADS):
        lines += [f"v {x} {y} {z}" for x, y, z in pts]
    for q, (pts, mtl) in enumerate(QUADS):
        if mtl != cur:
            lines.append(f"usemtl {mtl}")
            cur = mtl
        b = 4 * q + 1
        lines.append(f"f {b} {b + 1} {b + 2}")
        lines.append(f"f {b} {b + 2} {b + 3}")
    r, g, b = params["light_radiance"]
    cam = (f"eye 1 1 4.5\nlookat 1 1 0\nup 0 1 0\nfovy 39\n"
           f"width {params['width']}\nheight {params['height']}\n"
           f"mtlname Light {r} {g} {b}\n")
    os.makedirs(directory, exist_ok=True)
    for ext, text in (("obj", "\n".join(lines) + "\n"), ("mtl", MTL),
                      ("camera", cam)):
        with open(os.path.join(directory, f"{name}.{ext}"), "w") as fh:
            fh.write(text)
