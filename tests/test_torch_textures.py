"""The port's textures load the same texels with PIL and without it.

A machine may have no PIL (the CUDA machines the port targets need none).
The port decodes PNG textures with its own ``film.read_png``, writes the
built-in interior's prop textures with ``film.write_png``, and ships the
interior's floor as ``scene/assets/cherry-wood-texture.png``, PIL's decode
of ``tests/golden/cherry-wood-texture.jpg``.  So the built-in scenes must
load bit for bit the same atlas with PIL hidden as with PIL, and the same
as the JAX package's (which decodes every texture with PIL).  A texture in
another format still needs PIL; without it the loader warns and drops it.
"""

import logging
import os
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from montecarlopathtracing_tpu.scene import builtin as jbuiltin
from montecarlopathtracing_torch.film.film import read_png
from montecarlopathtracing_torch.scene import builtin as tbuiltin
from montecarlopathtracing_torch.scene.loader import build_scene

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEG = os.path.join(ROOT, "tests", "golden", "cherry-wood-texture.jpg")
TEX_FIELDS = ("has_texture", "tex_offset", "tex_h", "tex_w", "atlas")

# name -> (the port's loader, the JAX package's, texels in the atlas):
# the interior's floor at 256 x 256 plus seven props (four at 128, three at
# 256), and the box's 8 x 8 checker.
SCENES = {
    "interior": (lambda **kw: tbuiltin.load_builtin_large(2000, width=32, height=32, **kw),
                 lambda: jbuiltin.load_builtin_large(2000, width=32, height=32),
                 327_680),
    "checker_box": (lambda **kw: tbuiltin.load_builtin_box(with_texture=True, **kw),
                    lambda: jbuiltin.load_builtin_box(with_texture=True),
                    64),
}


def _tex(scene):
    return {f: np.asarray(getattr(scene, f)) for f in TEX_FIELDS}


@pytest.mark.parametrize("name", sorted(SCENES))
def test_builtin_atlas_same_without_pil(name, monkeypatch):
    load, jload, texels = SCENES[name]
    with_pil = _tex(load(device="cpu")[0])
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        from PIL import Image  # noqa: F401  (hidden)
    without = _tex(load(device="cpu")[0])
    monkeypatch.undo()
    reference = _tex(jload()[0])
    assert with_pil["atlas"].shape == (texels, 3)
    for f in TEX_FIELDS:
        for other in (without, reference):
            assert other[f].dtype == with_pil[f].dtype, f
            np.testing.assert_array_equal(other[f], with_pil[f], err_msg=f)


def test_floor_asset_is_pil_decode_of_the_jpeg():
    jpeg = np.asarray(Image.open(JPEG).convert("RGB"))
    png = read_png(tbuiltin.FLOOR_TEXTURE)
    assert jpeg.shape == png.shape == (256, 256, 3)
    assert png.dtype == np.uint8
    np.testing.assert_array_equal(png, jpeg)


def _user_scene(d, map_kd):
    """A one-quad scene whose material has ``map_kd``."""
    with open(os.path.join(d, "s.obj"), "w") as fh:
        fh.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nvt 0 0\nvt 1 0\nvt 1 1\n"
                 "vt 0 1\nusemtl Tex\nf 1/1 2/2 3/3\nf 1/1 3/3 4/4\n")
    with open(os.path.join(d, "s.mtl"), "w") as fh:
        fh.write(f"newmtl Tex\nKd 1 1 1\nmap_Kd {map_kd}\n")
    with open(os.path.join(d, "s.camera"), "w") as fh:
        fh.write("eye 0.5 0.5 2\nlookat 0.5 0.5 0\nup 0 1 0\nfovy 45\n"
                 "width 8\nheight 8\n")


def test_jpeg_texture_without_pil_warns_and_drops(tmp_path, monkeypatch, caplog):
    d = str(tmp_path)
    Image.open(JPEG).save(os.path.join(d, "wood.jpg"))
    _user_scene(d, "wood.jpg")
    with_pil, _ = build_scene(d, "s", device="cpu")
    assert with_pil.atlas.shape == (256 * 256, 3)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with caplog.at_level(logging.WARNING):
        scene, _ = build_scene(d, "s", device="cpu")
    assert scene.atlas.shape == (0, 3)
    assert not bool(scene.has_texture.any())
    warned = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert any("wood.jpg" in r.getMessage() and "PIL" in r.getMessage()
               for r in warned), [r.getMessage() for r in warned]


def test_png_texture_without_pil_loads(tmp_path, monkeypatch, caplog):
    """A user scene's PNG texture loads without PIL and without a warning,
    with PIL's values."""
    d = str(tmp_path)
    rgb = np.random.default_rng(5).integers(0, 256, (6, 10, 3), dtype=np.uint8)
    Image.fromarray(rgb).save(os.path.join(d, "t.png"))  # PIL's own filters
    _user_scene(d, "t.png")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with caplog.at_level(logging.WARNING):
        scene, _ = build_scene(d, "s", device="cpu")
    assert not [r for r in caplog.records if r.levelno == logging.WARNING]
    np.testing.assert_array_equal(scene.atlas.numpy(),
                                  rgb.reshape(-1, 3).astype(np.float32) / 255.0)
