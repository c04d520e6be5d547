"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into a shared library with a
plain C interface and loaded through ``ctypes`` (no PyTorch headers, so a
build takes seconds).  Shared device code sits in ``csrc/*.cuh``; a source
may export more than one entry point.  Libraries are built at first use into
``kernels/build/``, named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused.  A missing ``nvcc`` or a
failed build raises with the compiler's output: nothing falls back to the
plain PyTorch versions.

The flags keep IEEE rounding: ``-fmad=false`` (no contraction of a*b+c) and
no ``--use_fast_math`` (IEEE division), so each kernel rounds exactly as its
plain PyTorch version does, operation for operation.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "build")

# The sources, one library each.
KERNELS = ("cluster_keys", "cluster_intersect", "cluster_intersect_ftb",
           "cluster_intersect_hbm", "bvh_walk", "packet_walk", "atlas_grad")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v",
)
# Further flags for a measurement build (say "-DMCPT_SKIP_TESTS", or for the
# walks "-DMCPT_WALK_STATS", "-DMCPT_PACKET_WALK_V1" and "-DMCPT_BVH_WALK_V1");
# part of a library's hash.  After changing them call ``load.cache_clear()``.
EXTRA_FLAGS: tuple = ()

_P = ctypes.c_void_p
_I = ctypes.c_int
# Entry points: name -> (source, C symbol, argtypes); every one returns the
# CUDA error of its launch as an int.
_SIGNATURES = {
    "cluster_keys": ("cluster_keys", "mcpt_cluster_keys",
                     [_P, _I, _I, _I, _P, _I, _P, _P, _P, _P, _P, _P, _P, _P]),
    "cluster_keys_chunked": ("cluster_keys", "mcpt_cluster_keys_chunked",
                             [_P, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P,
                              _P, _P, _P]),
    "cluster_intersect": ("cluster_intersect", "mcpt_cluster_intersect",
                          [_P, _I, _I, _I, _P, _P, _I, _P, _I, _I, _I, _P,
                           _P, _P, _P]),
    "cluster_intersect_ftb": ("cluster_intersect_ftb",
                              "mcpt_cluster_intersect_ftb",
                              [_P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
                               _I, _P, _I, _I, _P, _P, _P]),
    "cluster_intersect_hbm": ("cluster_intersect_hbm",
                              "mcpt_cluster_intersect_hbm",
                              [_P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _P, _I,
                               _I, _I, _P, _P, _P, _P, _P]),
    "bvh_walk": ("bvh_walk", "mcpt_bvh_walk",
                 [_P, _P, _I, _P, _I, _P, _I, _I, _I, _P, _P, _P, _P]),
    "packet_walk": ("packet_walk", "mcpt_packet_walk",
                    [_P, _P, _I, _I, _P, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P]),
    "atlas_grad": ("atlas_grad", "mcpt_atlas_grad",
                   [_P, _P, _P, _I, _I, _P, _P, _P, _I, _P, _P]),
}


def find_nvcc() -> str:
    """Path of nvcc: $NVCC, then PATH, then $CUDA_HOME/bin (default
    /usr/local/cuda).  Raises RuntimeError when there is none."""
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and $CUDA_HOME/bin): the CUDA "
        "kernels of montecarlopathtracing_torch are built from source at "
        "first use and need the CUDA toolkit")


def _library_path(name: str) -> str:
    h = hashlib.sha256()
    for fname in sorted(os.listdir(CSRC_DIR)):
        if fname == name + ".cu" or fname.endswith(".cuh"):
            with open(os.path.join(CSRC_DIR, fname), "rb") as fh:
                h.update(fname.encode() + b"\0" + fh.read())
    h.update(" ".join(NVCC_FLAGS + tuple(EXTRA_FLAGS)).encode())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def build(names: Iterable[str] = KERNELS) -> Dict[str, dict]:
    """Compile every named kernel that has no up-to-date library, one nvcc
    process per source, all started together.  Returns {name: {"path",
    "seconds", "log"}} ("seconds" 0 and "log" the saved compiler output for a
    cached library).  Raises RuntimeError with the compiler output if any
    build fails."""
    names = list(names)
    out, procs = {}, {}
    nvcc = None
    os.makedirs(BUILD_DIR, exist_ok=True)
    for name in names:
        path = _library_path(name)
        if os.path.exists(path):
            log_path = path + ".log"
            log = open(log_path).read() if os.path.exists(log_path) else ""
            out[name] = {"path": path, "seconds": 0.0, "log": log}
            continue
        nvcc = nvcc or find_nvcc()
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *EXTRA_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, name + ".cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       path, tmp, time.perf_counter())
    failures = []
    for name, (proc, path, tmp, t0) in procs.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"--- {name} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        with open(path + ".log", "w") as fh:
            fh.write(log)
        os.replace(tmp, path)
        out[name] = {"path": path, "seconds": seconds, "log": log}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str):
    """The C entry point ``name``, its source built first if needed."""
    source, symbol, argtypes = _SIGNATURES[name]
    path = build([source])[source]["path"]
    fn = getattr(ctypes.CDLL(path), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn
