"""Port parity: RNG, sampling, intersection and camera ops.

The RNG must be BITWISE equal to montecarlopathtracing_tpu/integrator/rng.py
(renders compare pixel by pixel only because both packages draw the same
uniforms).  The floating-point ops are held to rtol 1e-5 / atol 1e-6: the
two frameworks may contract or order f32 arithmetic differently, a few ULPs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopathtracing_tpu.integrator import camera as jcam
from montecarlopathtracing_tpu.integrator import rng as jrng
from montecarlopathtracing_tpu.ops import intersect as jint
from montecarlopathtracing_tpu.ops import sampling as jsamp
from montecarlopathtracing_tpu.scene.builtin import load_builtin_box as jbox
from montecarlopathtracing_torch.integrator import camera as tcam
from montecarlopathtracing_torch.integrator import rng as trng
from montecarlopathtracing_torch.ops import intersect as tint
from montecarlopathtracing_torch.ops import sampling as tsamp
from montecarlopathtracing_torch.scene.builtin import load_builtin_box as tbox

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6
U32_EDGES = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0x9E3779B9,
                      0xFFFFFFFE, 0xFFFFFFFF], np.uint32)


def _close(j, t):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=RTOL, atol=ATOL)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2 ** 31 - 1, 2 ** 32 - 1])
def test_lane_keys_bitwise(seed):
    rs = np.random.default_rng(seed % 1000)
    pix = np.concatenate([U32_EDGES, rs.integers(0, 2 ** 32, 56, dtype=np.uint64
                                                 ).astype(np.uint32)])
    samp = np.roll(pix, 3)
    jk = np.asarray(jrng.lane_keys(seed, jnp.asarray(pix), jnp.asarray(samp)))
    tk = trng.lane_keys(seed, torch.as_tensor(pix.astype(np.int64)),
                        torch.as_tensor(samp.astype(np.int64)))
    np.testing.assert_array_equal(jk.astype(np.int64), tk.numpy())
    # Scalar sample index, as at the start of a dispatch.
    jk = np.asarray(jrng.lane_keys(seed, jnp.asarray(pix), 7))
    tk = trng.lane_keys(seed, torch.as_tensor(pix.astype(np.int64)), 7)
    np.testing.assert_array_equal(jk.astype(np.int64), tk.numpy())


@pytest.mark.parametrize("n_slots", [5, 9, 17])
def test_bounce_and_primary_uniforms_bitwise(n_slots):
    rs = np.random.default_rng(n_slots)
    keys = rs.integers(0, 2 ** 32, (64, 2), dtype=np.uint64).astype(np.uint32)
    keys[:8, 0] = U32_EDGES
    keys[:8, 1] = U32_EDGES[::-1]
    depth = rs.integers(0, 40, 64).astype(np.int32)
    tkeys = torch.as_tensor(keys.astype(np.int64))
    for d_j, d_t in ((jnp.asarray(depth), torch.as_tensor(depth)), (3, 3)):
        ju = np.asarray(jrng.bounce_uniforms(jnp.asarray(keys), d_j, n_slots))
        tu = trng.bounce_uniforms(tkeys, d_t, n_slots)
        assert tu.dtype == torch.float32
        np.testing.assert_array_equal(ju, tu.numpy())
    np.testing.assert_array_equal(np.asarray(jrng.primary_uniforms(jnp.asarray(keys))),
                                  trng.primary_uniforms(tkeys).numpy())


def _rand(n, seed, k=3, lo=-1.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, (n, k)).astype(np.float32)


def _unit(n, seed):
    v = np.random.default_rng(seed).normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def test_sampling_ops():
    n = 256
    axis = _rand(n, 1) * 1.3
    u = _rand(n, 2, k=5, lo=0.0, hi=1.0)
    ns = np.random.default_rng(3).choice([1.0, 50.0, 500.0], n).astype(np.float32)
    diff = np.arange(n) % 2 == 0
    _close(jsamp.sample_lobe(axis, u[:, 0], u[:, 1], diff, ns),
           tsamp.sample_lobe(_t(axis), _t(u[:, 0]), _t(u[:, 1]), _t(diff), _t(ns)))
    for j, t in zip(jsamp.lobe_frame(axis), tsamp.lobe_frame(_t(axis))):
        _close(j, t)
    inc, nrm = _unit(n, 4), _rand(n, 5)
    _close(jsamp.reflect(inc, nrm), tsamp.reflect(_t(inc), _t(nrm)))
    n1 = np.where(diff, 1.0, 1.5).astype(np.float32)
    n2 = np.where(diff, 1.5, 1.0).astype(np.float32)
    cosv = u[:, 2] * 2 - 1
    _close(jsamp.schlick_fresnel(n1, n2, cosv),
           tsamp.schlick_fresnel(_t(n1), _t(n2), _t(cosv)))
    nn = _unit(n, 6)
    ok_j, d_j = jsamp.refract_dir(inc, nn, n1 / n2)
    ok_t, d_t = tsamp.refract_dir(_t(inc), _t(nn), _t(n1 / n2))
    np.testing.assert_array_equal(np.asarray(ok_j), ok_t.numpy())
    _close(d_j, d_t)
    _close(jsamp.normalize(axis), tsamp.normalize(_t(axis)))
    v = [_rand(n, s) for s in range(10, 16)]
    for simplex in (True, False):
        for j, t in zip(
                jsamp.sample_triangle_point(*v, u[:, 0], u[:, 1], u[:, 2], simplex),
                tsamp.sample_triangle_point(*map(_t, v), _t(u[:, 0]), _t(u[:, 1]),
                                            _t(u[:, 2]), simplex)):
            _close(j, t)


@pytest.mark.parametrize("pick_total", [None, 0.5, 3.0])
def test_pick_light_face(pick_total):
    cum = np.cumsum(np.array([0.2, 0.0, 0.5, 0.3, 0.7], np.float32)).astype(np.float32)
    total = cum[-1]
    u = np.concatenate([np.linspace(0, 1, 97, endpoint=False),
                        [0.0, 0.2 / total, 0.7 / total]]).astype(np.float32)
    jj, jf = jsamp.pick_light_face(jnp.asarray(cum), total, jnp.asarray(u), pick_total)
    tj, tf = tsamp.pick_light_face(_t(cum), torch.tensor(total), _t(u),
                                   None if pick_total is None
                                   else torch.tensor(np.float32(pick_total)))
    np.testing.assert_array_equal(np.asarray(jj), tj.numpy())
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())


def test_intersect_ops():
    n = 200
    o, d = _rand(n, 20, lo=-0.5, hi=1.5), _unit(n, 21)
    p0, p1, p2 = (_rand(n, s, lo=0.0, hi=1.0) for s in (22, 23, 24))
    gn = np.cross(p0 - p1, p2 - p0)
    gn = (gn / np.linalg.norm(gn, axis=1, keepdims=True)).astype(np.float32)
    for compat in (True, False):
        hj, tj, bj = jint.ray_triangle(o, d, p0, p1, p2, gn, compat)
        ht, tt, bt = tint.ray_triangle(*map(_t, (o, d, p0, p1, p2, gn)), compat)
        np.testing.assert_array_equal(np.asarray(hj), ht.numpy())
        h = np.asarray(hj)
        np.testing.assert_allclose(np.asarray(tj)[h], tt.numpy()[h], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(np.asarray(bj)[h], bt.numpy()[h], rtol=RTOL,
                                   atol=10 * ATOL)
    # Barycentrics of points on each triangle's plane (as at a hit).
    w = _rand(n, 25, lo=0.0, hi=1.0)
    w /= w.sum(axis=1, keepdims=True)
    p = (w[:, 0:1] * p0 + w[:, 1:2] * p1 + w[:, 2:3] * p2).astype(np.float32)
    _close(jint.barycentric(p, p0, p1, p2), tint.barycentric(*map(_t, (p, p0, p1, p2))))


@pytest.mark.parametrize("jitter", [False, True])
def test_camera_primary_rays(jitter):
    js, _ = jbox(width=24, height=16)
    ts, _ = tbox(width=24, height=16, device="cpu")
    for j, t in zip(jcam.screen_basis(js.camera), tcam.screen_basis(ts.camera)):
        _close(j, t)
    ids = np.arange(24 * 16, dtype=np.int32)
    jit = _rand(ids.shape[0], 30, k=2, lo=0.0, hi=1.0) if jitter else None
    jo, jd = jcam.primary_rays(js.camera, jnp.asarray(ids),
                               None if jit is None else jnp.asarray(jit))
    to, td = tcam.primary_rays(ts.camera, torch.as_tensor(ids),
                               None if jit is None else _t(jit))
    _close(jo, to)
    _close(jd, td)
