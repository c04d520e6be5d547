"""The port's ctypes binding to the C++ parser (scene/native.py): fields
exactly equal to the port's Python parser and to the JAX package's own
binding (montecarlopathtracing_tpu/scene/native.py) on the same OBJ files,
and api.load_scene's choice of parser.  Skipped when there is no g++, as
tests/test_native_loader.py."""

import logging
import os
import shutil

import numpy as np
import pytest
import torch

from montecarlopathtracing_torch import api
from montecarlopathtracing_torch.config import RenderOptions
from montecarlopathtracing_torch.scene import native
from montecarlopathtracing_torch.scene.builtin import write_box_scene
from montecarlopathtracing_torch.scene.loader import build_scene
from montecarlopathtracing_torch.scene.types import SCENE_FIELDS

needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")

# A quad and a pentagon (fan-triangulated), v/vt/vn corners, negative
# (relative) indices, a usemtl naming an unknown material, comments.
POLY_OBJ = """# polygons
v 0 0 0
v 2 0 0
v 2 0 2
v 0 0 2
v 1 2 1
vt 0 0
vt 1 0
vt 1 1
vn 0 1 0
usemtl White
f 1/1/1 2/2/1 3/3/1 4/1/1
usemtl Nope
f -5 -4 -1
usemtl Light
f 1//1 2//1 5//1 4//1 3//1
"""
POLY_MTL = """newmtl White
Kd 0.7 0.7 0.7
newmtl Light
Kd 0 0 0
"""
POLY_CAM = """eye 1 1 5
lookat 1 1 0
up 0 1 0
fovy 40
width 8
height 8
mtlname Light 5 5 5
"""


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_native"))
    write_box_scene(d, "box", width=16, height=16)
    write_box_scene(d, "spec_glass", width=16, height=16, with_specular=True,
                    with_glass=True)
    write_box_scene(d, "textured", width=16, height=16, with_texture=True)
    for ext, text in ((".obj", POLY_OBJ), (".mtl", POLY_MTL), (".camera", POLY_CAM)):
        with open(os.path.join(d, "poly" + ext), "w") as fh:
            fh.write(text)
    return d


@needs_gxx
@pytest.mark.parametrize("name", ["box", "spec_glass", "textured", "poly"])
def test_native_matches_python(scene_dir, name):
    opts = RenderOptions()
    sn, mn = native.build_scene_native(scene_dir, name, opts, device="cpu")
    sp, mp = build_scene(scene_dir, name, opts, device="cpu")
    assert (mn.num_faces, mn.num_vertices) == (mp.num_faces, mp.num_vertices)
    for field in SCENE_FIELDS:
        a, b = getattr(sn, field), getattr(sp, field)
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert torch.equal(a, b), field
    assert sn.camera.width == sp.camera.width
    assert os.path.isfile(os.path.join(native.BUILD_DIR, "libsceneloader.so"))
    assert native.BUILD_DIR.startswith(os.path.dirname(native.__file__))


@needs_gxx
@pytest.mark.parametrize("name", ["box", "spec_glass", "textured", "poly"])
def test_native_matches_jax_native(scene_dir, name):
    from montecarlopathtracing_tpu.config import RenderOptions as JOpts
    from montecarlopathtracing_tpu.scene import native as jnative

    sn, mn = native.build_scene_native(scene_dir, name, RenderOptions(), device="cpu")
    sj, mj = jnative.build_scene_native(scene_dir, name, JOpts())
    assert (mn.num_faces, mn.num_vertices, mn.material_names, mn.light_names) == (
        mj.num_faces, mj.num_vertices, mj.material_names, mj.light_names)
    for field in SCENE_FIELDS:
        a, b = getattr(sn, field).numpy(), np.asarray(getattr(sj, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert np.array_equal(a, b), field
    for field in ("eye", "look_at", "up", "fovy"):
        assert np.array_equal(getattr(sn.camera, field).numpy(),
                              np.asarray(getattr(sj.camera, field))), field
    assert (sn.camera.width, sn.camera.height) == (sj.camera.width, sj.camera.height)


@needs_gxx
def test_parse_obj_native_matches_python_parser(scene_dir):
    from montecarlopathtracing_torch.scene.loader import parse_mtl, parse_obj

    mats = parse_mtl(os.path.join(scene_dir, "poly.mtl"))
    index = {m.name: i for i, m in enumerate(mats)}
    got = native.parse_obj_native(os.path.join(scene_dir, "poly.obj"), index)
    want = parse_obj(os.path.join(scene_dir, "poly.obj"), index)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    from montecarlopathtracing_tpu.scene.native import parse_obj_native as jparse

    ref = jparse(os.path.join(scene_dir, "poly.obj"), index)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert np.array_equal(np.asarray(a), np.asarray(b))


@needs_gxx
def test_load_scene_tries_native_first(scene_dir, caplog):
    with caplog.at_level(logging.INFO, logger="montecarlopathtracing_torch.api"):
        sn, _ = api.load_scene(scene_dir, "box", device="cpu")
    assert "parsed by the native loader" in caplog.text
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="montecarlopathtracing_torch.api"):
        sp, _ = api.load_scene(scene_dir, "box", use_native=False, device="cpu")
    assert "parsed by the python loader" in caplog.text
    assert torch.equal(sn.v0, sp.v0) and torch.equal(sn.mat_id, sp.mat_id)


def test_load_scene_falls_back_to_python(scene_dir, monkeypatch, caplog):
    """Without a toolchain (no g++ on PATH, nothing built) the Python parser
    runs, and the log says so."""
    monkeypatch.setattr(native, "BUILD_DIR", os.path.join(scene_dir, "nobuild"))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("PATH", os.path.join(scene_dir, "nobin"))
    with caplog.at_level(logging.INFO, logger="montecarlopathtracing_torch.api"):
        scene, _ = api.load_scene(scene_dir, "box", device="cpu")
    assert "native loader unavailable" in caplog.text
    assert "parsed by the python loader" in caplog.text
    assert scene.num_tris_padded >= 12
