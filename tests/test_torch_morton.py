"""Port parity: 30-bit Morton codes (ops/morton.py) against the JAX
package's ops/morton.py, the reference's scalar bit twiddling, and the
port loader's NumPy twin (scene/loader.py::morton_codes_np).  All exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopathtracing_tpu.ops import morton as jm
from montecarlopathtracing_torch.ops import morton as tm
from montecarlopathtracing_torch.scene.loader import morton_codes_np


def _reference_expand_bits(v: int) -> int:
    """expandBits (MTPC/morton code.cpp:3-10) in scalar Python."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v & 0xFFFFFFFF


def _points(seed, n=512, lo=-1.0, hi=4.0):
    pts = np.random.default_rng(seed).uniform(lo, hi, (n, 3)).astype(np.float32)
    pts[:8] = [[-1, -1, -1], [4, 4, 4], [-2, 5, 0], [0, 0, 0],
               [1.5, 1.5, 1.5], [3.999, -0.999, 2], [-1, 4, -1], [4, -1, 4]]
    return pts


def test_expand_bits_matches_reference_and_jax():
    vals = np.arange(1024, dtype=np.uint32)
    got = tm.expand_bits(torch.as_tensor(vals.astype(np.int64))).numpy()
    want = np.array([_reference_expand_bits(int(v)) for v in vals])
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jm.expand_bits(vals)).astype(np.int64))
    assert np.all((got & ~0x49249249) == 0)


@pytest.mark.parametrize("compat_bounds", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_morton_codes_match_jax_and_loader(seed, compat_bounds):
    pts = _points(seed)
    got = tm.morton_codes(torch.as_tensor(pts), compat_bounds=compat_bounds).numpy()
    want = np.asarray(jm.morton_codes(pts, compat_bounds=compat_bounds))
    assert np.array_equal(got, want.astype(np.int64))
    assert np.array_equal(got, morton_codes_np(pts, compat_bounds).astype(np.int64))


def test_morton_codes_explicit_bounds_match_jax():
    pts = _points(4, lo=0.0, hi=2.0)
    lo, hi = np.float32([0.1, 0.0, -0.5]), np.float32([1.9, 2.5, 2.0])
    got = tm.morton_codes(torch.as_tensor(pts), lo=lo, hi=hi,
                          compat_bounds=False).numpy()
    want = np.asarray(jm.morton_codes(pts, lo=lo, hi=hi, compat_bounds=False))
    assert np.array_equal(got, want.astype(np.int64))


def test_morton3d_corners_and_argsort_match_jax():
    assert int(tm.morton3d(torch.zeros((1, 3)))[0]) == 0
    assert int(tm.morton3d(torch.ones((1, 3)))[0]) == 2 ** 30 - 1
    pts = _points(2)
    pts[100:140] = pts[:40]  # equal codes: the sort must be stable
    order, codes = tm.morton_argsort(torch.as_tensor(pts))
    jorder, jcodes = jm.morton_argsort(jnp.asarray(pts))
    assert np.array_equal(codes.numpy(), np.asarray(jcodes).astype(np.int64))
    assert np.array_equal(order.numpy(), np.asarray(jorder))
