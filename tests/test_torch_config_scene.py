"""Port parity: configuration and scene construction.

The PyTorch port (montecarlopathtracing_torch) keeps its own copies of the
configuration and the loader; both must match the JAX package field for
field.  Scenes are compared EXACTLY (dtype, shape, every value): the
triangle order becomes the cluster ids, so any drift would change hit ids.
"""

import dataclasses

import numpy as np
import pytest
import torch

from montecarlopathtracing_tpu import config as jconfig
from montecarlopathtracing_tpu.scene import builtin as jbuiltin
from montecarlopathtracing_torch import config as tconfig
from montecarlopathtracing_torch.scene import builtin as tbuiltin
from montecarlopathtracing_torch.scene.types import SCENE_FIELDS, scene_from_numpy

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["CompatOptions", "RenderOptions"])
def test_config_fields_and_defaults(name):
    jcls, tcls = getattr(jconfig, name), getattr(tconfig, name)
    jf, tf = dataclasses.fields(jcls), dataclasses.fields(tcls)
    assert [f.name for f in jf] == [f.name for f in tf]
    ji, ti = jcls(), tcls()
    for f in jf:
        jv, tv = getattr(ji, f.name), getattr(ti, f.name)
        if dataclasses.is_dataclass(jv):
            assert dataclasses.asdict(jv) == dataclasses.asdict(tv), f.name
        else:
            assert jv == tv and type(jv) is type(tv), f.name


def test_modern_preset_matches():
    assert dataclasses.asdict(jconfig.MODERN) == dataclasses.asdict(tconfig.MODERN)


def _assert_scene_equal(js, ts):
    for f in SCENE_FIELDS:
        a = np.asarray(getattr(js, f))
        b = getattr(ts, f).numpy()
        assert a.dtype == b.dtype, (f, a.dtype, b.dtype)
        assert a.shape == b.shape, (f, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("eye", "look_at", "up", "fovy"):
        a = np.asarray(getattr(js.camera, f))
        b = getattr(ts.camera, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert (js.camera.width, js.camera.height) == (ts.camera.width, ts.camera.height)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(with_specular=True, with_glass=True, with_texture=True),
], ids=["plain", "spec_glass_texture"])
def test_build_scene_box_exact(kw):
    js, jm = jbuiltin.load_builtin_box(width=24, height=16, **kw)
    ts, tm = tbuiltin.load_builtin_box(width=24, height=16, device="cpu", **kw)
    _assert_scene_equal(js, ts)
    assert dataclasses.asdict(jm) | {"obj_path": ""} == \
        dataclasses.asdict(tm) | {"obj_path": ""}
    if kw.get("with_texture"):
        assert ts.atlas.shape[0] == 64  # the 8x8 checker loaded


def test_build_scene_large_exact():
    js, _ = jbuiltin.load_builtin_large(n_tris=2000, width=32, height=32)
    ts, _ = tbuiltin.load_builtin_large(n_tris=2000, width=32, height=32,
                                        device="cpu")
    _assert_scene_equal(js, ts)
    assert ts.num_materials > 64 and ts.atlas.shape[0] > 0


@pytest.mark.parametrize("opts_kw", [dict(cluster_order="morton_gap"),
                                     dict(compat=jconfig.MODERN)],
                         ids=["morton_gap", "modern_bounds"])
def test_build_scene_options_exact(opts_kw):
    """The other triangle orderings (Morton + gap padding, scene-AABB Morton
    bounds) give the same order in both packages."""
    jopts = jconfig.RenderOptions(**opts_kw)
    tkw = dict(opts_kw)
    if "compat" in tkw:
        tkw["compat"] = tconfig.MODERN
    js, _ = jbuiltin.load_builtin_large(n_tris=1500, width=16, height=16,
                                        options=jopts, n_textures=1)
    ts, _ = tbuiltin.load_builtin_large(n_tris=1500, width=16, height=16,
                                        options=tconfig.RenderOptions(**tkw),
                                        n_textures=1, device="cpu")
    _assert_scene_equal(js, ts)


def test_scene_from_numpy_round_trip():
    js, _ = jbuiltin.load_builtin_box(width=16, height=16, with_specular=True)
    fields = {f: np.asarray(getattr(js, f)) for f in SCENE_FIELDS}
    cam = dict(eye=np.asarray(js.camera.eye), look_at=np.asarray(js.camera.look_at),
               up=np.asarray(js.camera.up), fovy=np.asarray(js.camera.fovy),
               width=js.camera.width, height=js.camera.height)
    ts = scene_from_numpy(fields, cam, "cpu")
    _assert_scene_equal(js, ts)
    back = {f: getattr(ts, f).numpy() for f in SCENE_FIELDS}
    ts2 = scene_from_numpy(back, cam, torch.device("cpu")).to("cpu")
    _assert_scene_equal(js, ts2)
    assert ts2.num_tris_padded == js.num_tris_padded
    assert ts2.num_lights == js.num_lights == 1
