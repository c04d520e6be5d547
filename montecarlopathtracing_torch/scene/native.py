"""ctypes binding to the C++ fast scene parser (csrc/scene_loader.cpp).

Counterpart of ``montecarlopathtracing_tpu/scene/native.py``: the host-side
hot loop of a scene load, OBJ tokenization over hundreds of thousands of
lines, runs in native code; MTL and .camera files stay in Python.  The
shared source ``csrc/scene_loader.cpp`` at the repository root is used as it
is.  The library is compiled with g++ on first use and cached in this
package's own ``scene/build/`` (rebuilt when the source is newer); without
a toolchain ``api.load_scene`` falls back to the Python parser
(scene/loader.py), whose fields this parser's equal exactly.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..utils.timing import span

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "csrc",
                      "scene_loader.cpp")
BUILD_DIR = os.path.join(_HERE, "build")


def _build_library() -> str:
    if not os.path.exists(SOURCE):
        raise FileNotFoundError(SOURCE)
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib_path = os.path.join(BUILD_DIR, "libsceneloader.so")
    if os.path.exists(lib_path) and os.path.getmtime(lib_path) >= os.path.getmtime(SOURCE):
        return lib_path
    # Build beside the target and rename, so a concurrent loader never maps
    # a half-written library.
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", SOURCE, "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True)
    os.replace(tmp, lib_path)
    return lib_path


def _get_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(_build_library())
            lib.mcpt_parse_obj.restype = ctypes.c_void_p
            lib.mcpt_parse_obj.argtypes = [ctypes.c_char_p]
            lib.mcpt_result_counts.restype = None
            lib.mcpt_result_counts.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_long)]
            lib.mcpt_result_copy.restype = None
            lib.mcpt_result_copy.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_double),  # v
                ctypes.POINTER(ctypes.c_double),  # vn
                ctypes.POINTER(ctypes.c_double),  # vt
                ctypes.POINTER(ctypes.c_long),    # f_v
                ctypes.POINTER(ctypes.c_long),    # f_vt
                ctypes.POINTER(ctypes.c_long),    # f_vn
                ctypes.POINTER(ctypes.c_long),    # f_mat_slot (index into usemtl order)
            ]
            lib.mcpt_result_material_names.restype = ctypes.c_char_p
            lib.mcpt_result_material_names.argtypes = [ctypes.c_void_p]
            lib.mcpt_result_free.restype = None
            lib.mcpt_result_free.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


def parse_obj_native(path: str, material_index):
    """Drop-in replacement for scene.loader.parse_obj using the C++ parser."""
    lib = _get_lib()
    handle = lib.mcpt_parse_obj(path.encode())
    if not handle:
        raise RuntimeError(f"native parser failed on {path}")
    try:
        counts = (ctypes.c_long * 5)()
        lib.mcpt_result_counts(handle, counts)
        nv, nvn, nvt, nf, _nm = (int(c) for c in counts)
        v = np.empty((nv, 3), np.float64)
        vn = np.empty((max(nvn, 1), 3), np.float64)
        vt = np.empty((max(nvt, 1), 2), np.float64)
        f_v = np.empty((nf, 3), np.int64)
        f_vt = np.empty((nf, 3), np.int64)
        f_vn = np.empty((nf, 3), np.int64)
        f_slot = np.empty(nf, np.int64)

        def p(a, t):
            return a.ctypes.data_as(ctypes.POINTER(t))

        lib.mcpt_result_copy(handle, p(v, ctypes.c_double), p(vn, ctypes.c_double),
                             p(vt, ctypes.c_double), p(f_v, ctypes.c_long),
                             p(f_vt, ctypes.c_long), p(f_vn, ctypes.c_long),
                             p(f_slot, ctypes.c_long))
        names = lib.mcpt_result_material_names(handle).decode()
        usemtl_names = names.split("\n") if names else []
    finally:
        lib.mcpt_result_free(handle)

    # Map usemtl slot -> material table index (unknown names -> 0, like loader).
    slot_to_mat = np.array(
        [material_index.get(n, 0) for n in usemtl_names] or [0], np.int64
    )
    f_mat = slot_to_mat[np.clip(f_slot, 0, len(slot_to_mat) - 1)]
    if nvn == 0:
        vn = np.zeros((0, 3), np.float64)
    if nvt == 0:
        vt = np.zeros((0, 2), np.float64)
    return v, vn, vt, f_v, f_vt, f_vn, f_mat


def build_scene_native(scene_dir: str, name: str, options, device=None):
    """build_scene with the OBJ stage parsed natively; MTL/.camera stay in
    Python (tiny files).  Tensors land on ``device`` (None = the card)."""
    from .loader import build_scene, parse_camera, parse_mtl

    base = os.path.join(scene_dir, name)
    with span("parse") as sp:
        materials = parse_mtl(base + ".mtl")
        mat_index = {m.name: i for i, m in enumerate(materials)}
        obj = parse_obj_native(base + ".obj", mat_index)
        cam, light_list = parse_camera(base + ".camera")
        sp.note(faces=len(obj[-1]))
    return build_scene(scene_dir, name, options,
                       parsed=(materials, mat_index, obj, cam, light_list),
                       device=device)
