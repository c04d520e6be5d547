"""Port parity: the cluster intersector's plain PyTorch versions against the
JAX package's Pallas kernels (interpret mode) and the brute-force oracle.

On the CPU the port's kernel wrappers run their plain versions (the CUDA
kernels are held to those bit for bit on the card by chip_smoke.py).
Contract, as tests/test_cluster_kernel.py: the hit mask matches exactly, t
within rtol 1e-4 / atol 1e-5, and triangle ids agree except where two
triangles tie at equal t (>= 99% of hits).  Candidate keys and candidate
sets against the JAX key kernel are exact, on adversarial rays too (zero,
negative-zero and denormal direction components, origins on a box face,
parked rays), and so is the compact front-to-back list against the JAX
package's packed sort (integer work).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopathtracing_tpu.accel.lbvh import brute_force_intersect as jbrute
from montecarlopathtracing_tpu.kernels import cluster as jcl
from montecarlopathtracing_tpu.scene.builtin import load_builtin_box as jbox
from montecarlopathtracing_tpu.scene.builtin import load_builtin_large as jlarge
from montecarlopathtracing_torch.accel.lbvh import brute_force_intersect as tbrute
from montecarlopathtracing_torch.kernels import cluster as tcl
from montecarlopathtracing_torch.scene.builtin import load_builtin_box as tbox
from montecarlopathtracing_torch.scene.builtin import load_builtin_large as tlarge

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scenes():
    js, _ = jbox(width=16, height=16, with_specular=True, with_glass=True)
    ts, _ = tbox(width=16, height=16, with_specular=True, with_glass=True,
                 device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def large_scenes():
    js, _ = jlarge(n_tris=1500, width=16, height=16, n_textures=1)
    ts, _ = tlarge(n_tris=1500, width=16, height=16, n_textures=1, device="cpu")
    return js, ts


def _random_rays(n, seed=0, lo=-0.5, hi=1.5):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


@pytest.mark.parametrize("mt", [False, True], ids=["compat", "mt"])
@pytest.mark.parametrize("width", [4, 8])
def test_build_cluster_accel_matches(scenes, mt, width):
    js, ts = scenes
    ja = jcl.build_cluster_accel(js, width=width, mt=mt)
    ta = tcl.build_cluster_accel(ts, width=width, mt=mt)
    assert ta.tconst.shape == ja.tconst.shape and ta.width == ja.width
    np.testing.assert_allclose(np.asarray(ja.tconst), ta.tconst.numpy(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(ja.cmin), ta.cmin.numpy())
    np.testing.assert_array_equal(np.asarray(ja.cmax), ta.cmax.numpy())


@pytest.mark.parametrize("case", ["random", "parked_subtile", "large"])
def test_candidate_keys_match_jax_key_kernel(scenes, large_scenes, case):
    """Plain key function == JAX _candidate_keys (Pallas, interpret mode):
    the same keys and the same ascending candidate sets."""
    js, ts = large_scenes if case == "large" else scenes
    width = 32 if case == "large" else 4
    tile, mega = 16, 2
    o, d = _random_rays(128, seed=5, hi=3.0 if case == "large" else 1.5)
    if case == "parked_subtile":
        o[16:32] = 1e9  # one whole subtile parked
        o[40] = 1e9     # one parked ray in a live subtile
    rays = np.concatenate([o, d, np.full((128, 1), 1e30, np.float32),
                           np.zeros((128, 1), np.float32)], axis=1)
    ja = jcl.build_cluster_accel(js, width=width)
    caabb = np.concatenate([np.asarray(ja.cmin).T, np.asarray(ja.cmax).T,
                            np.zeros((2, ja.num_clusters), np.float32)])
    jkeys = np.asarray(jcl._candidate_keys(jnp.asarray(rays), jnp.asarray(caabb),
                                           tile, mega, True))
    tkeys, counts, ids = tcl.cluster_keys(torch.as_tensor(rays),
                                          torch.as_tensor(caabb), tile)
    np.testing.assert_array_equal(jkeys, tkeys.numpy())
    jcand, _ = jcl._candidates(jnp.asarray(rays), ja.cmin, ja.cmax, tile, mega,
                               True)
    jcand = np.asarray(jcand).reshape(-1, ja.num_clusters + 8)
    np.testing.assert_array_equal(jcand[:, 0], counts.numpy())
    np.testing.assert_array_equal(jcand[:, 8:], ids.numpy())
    if case == "parked_subtile":
        assert counts[1] == 0 and bool((tkeys[1] == 1e30).all())


def _check_contract(hb, tb, ib, hc, tc, ic):
    hb, hc = np.asarray(hb), np.asarray(hc)
    np.testing.assert_array_equal(hb, hc)
    np.testing.assert_allclose(np.asarray(tb)[hb], np.asarray(tc)[hb],
                               rtol=1e-4, atol=1e-5)
    same = np.asarray(ib)[hb] == np.asarray(ic)[hb]
    assert same.mean() > 0.99 if hb.any() else True
    assert (np.asarray(ic)[~hc] == -1).all()
    assert (np.asarray(tc)[~hc] == 1e30).all()


@pytest.mark.parametrize("mt", [False, True], ids=["compat", "mt"])
@pytest.mark.parametrize("n,seed", [(128, 0), (53, 3), (300, 7)],
                         ids=["n128", "ragged53", "ragged300"])
def test_cluster_intersect_matches_jax_and_brute(scenes, mt, n, seed):
    js, ts = scenes
    o, d = _random_rays(n, seed)
    o[5:9] = 1e9  # parked rays inside a live subtile
    ja = jcl.build_cluster_accel(js, width=4, mt=mt)
    ta = tcl.build_cluster_accel(ts, width=4, mt=mt)
    jres = jcl.cluster_intersect(ja, jnp.asarray(o), jnp.asarray(d), tile=16,
                                 mega=2, interpret=True, mt=mt)
    tres = tcl.cluster_intersect(ta, torch.as_tensor(o), torch.as_tensor(d),
                                 tile=16, mega=2, mt=mt)
    _check_contract(*jres, *tres)
    np.testing.assert_array_equal(np.asarray(jres[2]), tres[2].numpy())
    bres = tbrute(ts, torch.as_tensor(o), torch.as_tensor(d), compat=not mt)
    _check_contract(*bres, *tres)
    assert not bool(tres[0][5:9].any())


@pytest.mark.parametrize("mt", [False, True], ids=["compat", "mt"])
def test_cluster_intersect_large_scene(large_scenes, mt):
    """Many clusters (width 32 over ~1.5k triangles): real culling."""
    js, ts = large_scenes
    o, d = _random_rays(256, seed=11, lo=0.1, hi=2.9)
    ta = tcl.build_cluster_accel(ts, width=32, mt=mt)
    assert ta.num_clusters >= 32
    tres = tcl.cluster_intersect(ta, torch.as_tensor(o), torch.as_tensor(d),
                                 tile=16, mega=2, mt=mt)
    bres = tbrute(ts, torch.as_tensor(o), torch.as_tensor(d), compat=not mt)
    _check_contract(*bres, *tres)
    jb = jbrute(js, jnp.asarray(o), jnp.asarray(d), compat=not mt)
    _check_contract(*jb, *tres)


def test_all_miss_rays(scenes):
    _, ts = scenes
    ta = tcl.build_cluster_accel(ts, width=4)
    o = torch.full((32, 3), 50.0)
    d = torch.tensor([[1.0, 0.0, 0.0]]).expand(32, 3)
    hit, t, tri = tcl.cluster_intersect(ta, o, d, tile=16, mega=2)
    assert not bool(hit.any()) and bool((tri == -1).all()) and bool((t == 1e30).all())


@pytest.mark.parametrize("compat", [True, False])
def test_brute_force_matches_jax(scenes, compat):
    js, ts = scenes
    o, d = _random_rays(200, seed=9)
    jr = jbrute(js, jnp.asarray(o), jnp.asarray(d), compat=compat)
    tr = tbrute(ts, torch.as_tensor(o), torch.as_tensor(d), compat=compat)
    _check_contract(*jr, *tr)



# --------------------------------------------------------------------------
# What the key kernel fuses in for the front-to-back paths.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("c", [1, 24, 592, 1024])
def test_compact_list_matches_jax_ftb_order(c):
    """Exact: each row's first ``count`` entries of ftb_compact_plain equal
    the JAX _ftb_order (ids and quantised keys), with an all-miss row, a full
    row and equal quantised keys."""
    rng = np.random.default_rng(100 + c)
    key = rng.uniform(0.0, 40.0, (6, c)).astype(np.float32)
    key[rng.uniform(size=key.shape) < 0.5] = 1e30
    key[0] = 1e30
    key[1] = rng.uniform(0.0, 40.0, c)
    key[2] = 5.5
    key[3] = np.float32(9.0) + np.arange(c, dtype=np.float32) * np.float32(1e-7)
    jorder, jq = jcl._ftb_order(jnp.asarray(key), c, 1, 1)
    jorder, jq = np.asarray(jorder), np.asarray(jq).reshape(-1, c)
    order, qkeys = tcl.ftb_compact_plain(torch.as_tensor(key))
    counts = (key < 1e30).sum(axis=1)
    assert counts[0] == 0 and counts[1] == c
    used = np.arange(c)[None, :] < counts[:, None]
    np.testing.assert_array_equal(order.numpy()[used], jorder[used])
    np.testing.assert_array_equal(qkeys.numpy()[used].view(np.int32),
                                  jq[used].view(np.int32))


def _adversarial_rays(case, lo, hi, n=128, tile=16):
    rng = np.random.default_rng(17)
    o = rng.uniform(lo - 0.3, hi + 0.3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if case == "zero_dir":
        d[0::3, 0] = 0.0
        d[1::5, 1] = 0.0
        d[2::7] = [0.0, 0.0, 1.0]
    elif case == "neg_zero_dir":
        d[0::3, 0] = -0.0
        d[1::5, 2] = -0.0
        d[2::7] = [-0.0, 0.0, -1.0]
    elif case == "denormal_dir":  # 1 / d overflows to +-inf
        d[0::3, 0] = np.float32(1e-40)
        d[1::5, 1] = np.float32(-1e-41)
    elif case == "on_face":  # 0 * inf: origin on a box plane, d = 0 there
        o[0::2, 0] = lo[0]
        o[1::2, 1] = hi[1]
        d[0::4, 0] = 0.0
        d[1::4, 1] = -0.0
    elif case == "parked":
        o[5:9] = 1e9            # parked rays in a live subtile
        o[tile:2 * tile] = 1e9  # an all-parked subtile
        d[6] = [-1.0, -1.0, -1.0] / np.sqrt(np.float32(3.0))
    return o, d


@pytest.mark.parametrize("case", ["zero_dir", "neg_zero_dir", "denormal_dir",
                                  "on_face", "parked"])
def test_candidate_keys_match_jax_on_adversarial_rays(large_scenes, case):
    """Exact (bit patterns): cluster_keys_plain == the JAX key kernel in
    interpret mode where the slab test meets 0 * inf, -inf and parked rays."""
    js, _ = large_scenes
    tile, mega = 16, 2
    ja = jcl.build_cluster_accel(js, width=32)
    cmin, cmax = np.asarray(ja.cmin), np.asarray(ja.cmax)
    real = cmin[:, 0] < 1e29
    o, d = _adversarial_rays(case, cmin[real].min(axis=0), cmax[real].max(axis=0),
                             tile=tile)
    n = o.shape[0]
    rays = np.concatenate([o, d, np.full((n, 1), 1e30, np.float32),
                           np.zeros((n, 1), np.float32)], axis=1)
    caabb = np.concatenate([cmin.T, cmax.T,
                            np.zeros((2, ja.num_clusters), np.float32)])
    with np.errstate(divide="ignore"):
        jkeys = np.asarray(jcl._candidate_keys(jnp.asarray(rays),
                                               jnp.asarray(caabb), tile, mega,
                                               True))
    tkeys, counts, ids = tcl.cluster_keys_plain(torch.as_tensor(rays),
                                                torch.as_tensor(caabb), tile)
    np.testing.assert_array_equal(jkeys.view(np.int32),
                                  tkeys.numpy().view(np.int32))
    assert int(counts.sum()) > 0
    if case == "parked":
        assert counts[1] == 0 and bool((tkeys[1] == 1e30).all())
    # The fused list of these keys is the sorted list's prefix.
    keys_f, counts_f, cand = tcl.cluster_keys_ftb(torch.as_tensor(rays),
                                                  torch.as_tensor(caabb), tile,
                                                  with_keys=True)
    assert torch.equal(keys_f, tkeys) and torch.equal(counts_f, counts)
    jorder, _ = jcl._ftb_order(jnp.asarray(jkeys), ja.num_clusters, 1, 1)
    used = np.arange(ja.num_clusters)[None, :] < counts.numpy()[:, None]
    np.testing.assert_array_equal(cand.order.numpy()[used],
                                  np.asarray(jorder)[used])
    listed = tcl.listed_rows(*cand.row_list)
    assert sorted(listed.tolist()) == np.nonzero(counts.numpy() > 0)[0].tolist()
