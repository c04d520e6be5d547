"""Port parity: the large-scene path (chunked and supergroup cluster
intersectors, front-to-back candidates with the early exit).

The same numpy-seeded inputs go through the JAX package (Pallas kernels in
interpret mode) and through the port on the CPU, where the kernel wrappers
run their plain PyTorch versions (the CUDA kernels are held to those bit for
bit on the card by chip_smoke.py).

Tolerances.  Integer work (the packed front-to-back sort, the plans) and the
slab keys are exact.  Intersections follow tests/test_cluster_kernel.py: the
hit mask matches exactly, t within rtol 1e-4 / atol 1e-5, triangle ids agree
on >= 99% of hits (they may differ only where two triangles tie at equal t),
a miss is (1e30, -1).  Whole MODERN renders: rtol 1e-4 / atol 1e-5 per value
with at most 0.5% of pixels outside (a path can diverge at a triangle edge),
image mean within 1e-4 relative.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from montecarlopathtracing_tpu.config import MODERN as JMODERN
from montecarlopathtracing_tpu.config import RenderOptions as JOpts
from montecarlopathtracing_tpu.integrator import wavefront as jwf
from montecarlopathtracing_tpu.kernels import cluster as jcl
from montecarlopathtracing_tpu.scene.builtin import load_builtin_box as jbox
from montecarlopathtracing_tpu.scene.builtin import load_builtin_large as jlarge
from montecarlopathtracing_torch.accel.lbvh import brute_force_intersect as tbrute
from montecarlopathtracing_torch.config import MODERN, RenderOptions
from montecarlopathtracing_torch.integrator import wavefront as twf
from montecarlopathtracing_torch.kernels import cluster as tcl
from montecarlopathtracing_torch.scene.builtin import load_builtin_box as tbox
from montecarlopathtracing_torch.scene.builtin import load_builtin_large as tlarge

torch.set_num_threads(2)

TILE, MEGA = 16, 2


@pytest.fixture(scope="module")
def box():
    js, _ = jbox(width=16, height=16, with_specular=True, with_glass=True)
    ts, _ = tbox(width=16, height=16, with_specular=True, with_glass=True,
                 device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def interior():
    js, _ = jlarge(n_tris=2000, width=16, height=16, n_textures=1)
    ts, _ = tlarge(n_tris=2000, width=16, height=16, n_textures=1, device="cpu")
    return js, ts


def _scene(box, interior, name):
    """(jax scene, torch scene, cluster width, chunks, ray origin range)."""
    if name == "box":
        return (*box, 4, 3, (-0.5, 1.5))
    return (*interior, 32, 3, (0.1, 2.9))


def _random_rays(n, seed, lo, hi):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _check_contract(ref, got):
    hb, tb, ib = (np.asarray(x) for x in ref)
    hc, tc, ic = (np.asarray(x) for x in got)
    np.testing.assert_array_equal(hb, hc)
    np.testing.assert_allclose(tb[hb], tc[hb], rtol=1e-4, atol=1e-5)
    if hb.any():
        assert (ib[hb] == ic[hb]).mean() >= 0.99
    assert (ic[~hc] == -1).all() and (tc[~hc] == 1e30).all()


def _exact(a, b):
    assert all(torch.equal(x, y) for x, y in zip(a, b))


# --------------------------------------------------------------------------
# The packed front-to-back sort.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("group", [1, 2, 4])
def test_ftb_order_matches_jax(group):
    """order and gkeys exactly equal, C = 24 (not a power of two), with
    non-candidates (1e30), zeros and equal keys among the rows."""
    rng = np.random.default_rng(3)
    c, rows, mega = 24, 8, 2
    key = rng.uniform(0.0, 40.0, (rows, c)).astype(np.float32)
    key[rng.uniform(size=key.shape) < 0.3] = 1e30
    key[0, :5] = 0.0
    key[1, 3:9] = key[1, 3]
    key[2] = 1e30
    jorder, jg = jcl._ftb_order(jnp.asarray(key), c, group, mega)
    torder, tg = tcl._ftb_order(torch.as_tensor(key), c, group, mega)
    np.testing.assert_array_equal(np.asarray(jorder), torder.numpy())
    assert tg.shape == (rows // mega, mega, c // group)
    np.testing.assert_array_equal(np.asarray(jg), tg.numpy())
    order, qkeys = tcl._ftb_candidates(torch.as_tensor(key))
    assert torch.equal(order, torder)
    # Keys come out ascending and quantised down, never up.
    q = qkeys.numpy()
    assert (np.diff(q, axis=1) >= 0).all()
    assert (q <= np.sort(key, axis=1)).all()


def test_ftb_needed_counts_the_unskippable_prefix():
    qkeys = torch.tensor([[0.0, 1.0, 2.0, 5.0], [0.5, 3.0, 1e30, 1e30]])
    counts = torch.tensor([4, 2], dtype=torch.int32)
    bt = torch.tensor([1.5, 2.5, 1e30, 0.2])   # two rays per row
    cap = torch.tensor([1e30, 1e30, 4.0, -1.0])
    need = tcl.ftb_needed(bt, cap, counts, qkeys, tile=2)
    # row 0: bound max(1.5, 2.5) = 2.5 -> keys 0, 1, 2; row 1: bound
    # max(min(1e30, 4), min(0.2, -1)) = 4 -> keys 0.5, 3.
    assert need.tolist() == [3, 2]
    blocks = list(tcl._plain_blocks([0, 0, 1, 2, 2, 9], per_candidate=1 << 19))
    assert blocks == [(2, 4, 2), (4, 5, 2), (5, 6, 9)]


# --------------------------------------------------------------------------
# Chunked tables.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mt", [False, True], ids=["compat", "mt"])
@pytest.mark.parametrize("name", ["box", "interior"])
def test_build_chunked_accel_matches_jax(box, interior, name, mt):
    js, ts, width, n_chunks, _ = _scene(box, interior, name)
    ja, joffs = jcl.build_cluster_accel_chunked(js, width=width,
                                                n_chunks=n_chunks, mt=mt)
    ta, toffs = tcl.build_cluster_accel_chunked(ts, width=width,
                                                n_chunks=n_chunks, mt=mt)
    assert toffs == joffs and ta.num_chunks == ja.num_chunks >= 2
    assert ta.clusters_per_chunk == ja.clusters_per_chunk
    assert ta.clusters_per_chunk % 8 == 0 and ta.width == ja.width
    for field in ("tconst", "cmin", "cmax", "kmin", "kmax", "offsets"):
        j, t = np.asarray(getattr(ja, field)), getattr(ta, field).numpy()
        assert j.shape == t.shape and j.dtype == t.dtype, field
        if field == "tconst":
            # Products of vertex coordinates: XLA may contract a*b - c*d.
            np.testing.assert_allclose(j, t, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(j, t, err_msg=field)
    c = ta.clusters_per_chunk
    assert ta.caabb.shape == (ta.num_chunks, 8, c)
    assert torch.equal(ta.caabb[:, 0:3], ta.cmin.transpose(1, 2))
    assert torch.equal(ta.caabb[:, 3:6], ta.cmax.transpose(1, 2))


def _jax_chunk_rays(ja, o, d, mt):
    """The JAX package's routing pass and its K copies of the ray rows
    (cluster_intersect_chunked, before its first pallas_call)."""
    origin, direction = jnp.asarray(o), jnp.asarray(d)
    k_n, rp = ja.num_chunks, o.shape[0]
    inv = 1.0 / direction
    lo = (ja.kmin[None] - origin[:, None]) * inv[:, None]
    hi = (ja.kmax[None] - origin[:, None]) * inv[:, None]
    tn, tf = jnp.minimum(lo, hi), jnp.maximum(lo, hi)
    tn = jnp.where(jnp.isnan(tn), -jnp.inf, tn)
    tf = jnp.where(jnp.isnan(tf), jnp.inf, tf)
    enter, exit_ = jnp.max(tn, axis=2), jnp.min(tf, axis=2)
    touch = (enter <= exit_) & (exit_ >= 0)
    o_k = jnp.where(touch.T[:, :, None], origin[None], 1e9)
    cap_k = jnp.where(touch.T, exit_.T, -1.0)
    d_b = jnp.broadcast_to(direction[None], (k_n, rp, 3))
    if mt:
        rays = jnp.concatenate([o_k, d_b, jnp.cross(o_k, d_b), cap_k[:, :, None],
                                jnp.zeros((k_n, rp, 6), jnp.float32)], axis=2)
    else:
        rays = jnp.concatenate([o_k, d_b, cap_k[:, :, None],
                                jnp.zeros((k_n, rp, 1), jnp.float32)], axis=2)
    return rays.reshape(k_n * rp, -1), cap_k


def _jax_chunked_keys(ja, rays, tile, mega):
    """The JAX package's key kernel over its (K, n_steps) grid, as
    cluster_intersect_chunked dispatches it (interpret mode)."""
    k_n, c = ja.num_chunks, ja.clusters_per_chunk
    step = tile * mega
    n_steps = rays.shape[0] // k_n // step
    caabb = jnp.concatenate(
        [ja.cmin.transpose(0, 2, 1), ja.cmax.transpose(0, 2, 1),
         jnp.zeros((k_n, 2, c), jnp.float32)], axis=1).reshape(k_n * 8, c)
    sub_parked = (jnp.min(rays[:, 0].reshape(k_n * n_steps, mega, tile),
                          axis=2) > 5e8).astype(jnp.int32)
    step_parked = jnp.min(sub_parked, axis=1, keepdims=True)
    flags = jnp.concatenate([step_parked, sub_parked], axis=1).reshape(
        k_n * n_steps, 1, mega + 1)
    return pl.pallas_call(
        functools.partial(jcl._key_kernel, tile=tile, mega=mega),
        grid=(k_n, n_steps),
        in_specs=[
            pl.BlockSpec((1, 1, mega + 1), lambda k, i: (k * n_steps + i, 0, 0),
                         memory_space=pltpu.SMEM),
            pl.BlockSpec((step, rays.shape[1]),
                         lambda k, i: (k * n_steps + i, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((8, c), lambda k, i: (k, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((1, mega, c),
                               lambda k, i: (k * n_steps + i, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((k_n * n_steps, mega, c), jnp.float32),
        interpret=True,
    )(flags, rays, caabb).reshape(-1, c)


@pytest.mark.parametrize("mt", [False, True], ids=["compat", "mt"])
@pytest.mark.parametrize("name", ["box", "interior"])
def test_chunked_keys_match_jax_key_kernel(box, interior, name, mt):
    """Routing caps and the chunk-axis keys, exactly equal; the rays all sit
    near one corner, so some chunk has every ray parked."""
    js, ts, width, n_chunks, _ = _scene(box, interior, name)
    ja, _ = jcl.build_cluster_accel_chunked(js, width=width, n_chunks=n_chunks,
                                            mt=mt)
    ta, _ = tcl.build_cluster_accel_chunked(ts, width=width, n_chunks=n_chunks,
                                            mt=mt)
    n = 4 * TILE * MEGA
    o, d = _random_rays(n, seed=5, lo=-0.5, hi=1.5 if name == "box" else 2.9)
    o[TILE:2 * TILE] = 1e9  # a subtile parked for every chunk
    o[40] = 1e9
    d[7] = [0.0, 1.0, 0.0]  # zero components: 0 * inf on a slab plane
    o[7] = np.asarray(ta.kmin[0])
    if name == "interior":
        # Rays leaving the room through the near corner: they miss the boxes
        # of the prop chunks altogether.
        o[:] = np.where(o > 5e8, o, 0.02 + 0.01 * (o - 0.1))
        d[:] = -np.abs(d)
    jrays, jcap = _jax_chunk_rays(ja, o, d, mt)
    cap = tcl.chunk_caps(ta, torch.as_tensor(o), torch.as_tensor(d))
    np.testing.assert_array_equal(np.asarray(jcap), cap.numpy())
    if name == "interior":
        assert bool((cap < 0).all(dim=1).any()), "no chunk has every ray parked"
    jkeys = np.asarray(_jax_chunked_keys(ja, jrays, TILE, MEGA))
    rays = tcl.pack_rays(torch.as_tensor(o), torch.as_tensor(d), mt=mt)
    tkeys, counts = tcl.cluster_keys_chunked(rays, cap, ta.caabb, TILE)
    np.testing.assert_array_equal(jkeys, tkeys.numpy())
    np.testing.assert_array_equal((jkeys < 1e30).sum(1), counts.numpy())
    rows = n // TILE
    parked_chunks = (cap < 0).all(dim=1).nonzero().flatten().tolist()
    for k in parked_chunks:
        assert bool((tkeys[k * rows:(k + 1) * rows] == 1e30).all())
    assert bool((tkeys.reshape(-1, rows, tkeys.shape[1])[:, 1] == 1e30).all())


@pytest.mark.parametrize("mt", [False, True], ids=["compat", "mt"])
@pytest.mark.parametrize("name,n,seed", [("box", 128, 0), ("box", 53, 3),
                                         ("interior", 300, 7)],
                         ids=["box128", "box_ragged53", "interior_ragged300"])
def test_chunked_intersect_matches_jax_and_brute(box, interior, name, n, seed, mt):
    js, ts, width, n_chunks, (lo, hi) = _scene(box, interior, name)
    o, d = _random_rays(n, seed, lo, hi)
    o[5:9] = 1e9  # parked rays inside a live subtile
    ja, joffs = jcl.build_cluster_accel_chunked(js, width=width,
                                                n_chunks=n_chunks, mt=mt)
    ta, toffs = tcl.build_cluster_accel_chunked(ts, width=width,
                                                n_chunks=n_chunks, mt=mt)
    jres = jcl.cluster_intersect_chunked(ja, joffs, jnp.asarray(o), jnp.asarray(d),
                                         tile=TILE, mega=MEGA, interpret=True,
                                         mt=mt)
    tres = tcl.cluster_intersect_chunked(ta, toffs, torch.as_tensor(o),
                                         torch.as_tensor(d), tile=TILE,
                                         mega=MEGA, mt=mt)
    _check_contract(jres, tres)
    _check_contract(tbrute(ts, torch.as_tensor(o), torch.as_tensor(d),
                           compat=not mt), tres)
    assert not bool(tres[0][5:9].any())
    # The chunks' merge gives what one table over the whole scene gives.
    single = tcl.cluster_intersect(tcl.build_cluster_accel(ts, width=width, mt=mt),
                                   torch.as_tensor(o), torch.as_tensor(d),
                                   tile=TILE, mega=MEGA, mt=mt)
    _exact(single, tres)


# --------------------------------------------------------------------------
# The single-table front-to-back entry and the supergroup intersector.
# --------------------------------------------------------------------------

def _scene_exit(o, d, lo, hi):
    """Each ray's exit distance from the box [lo, hi]^3 (numpy), -1 for a ray
    that misses it."""
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / d
        a, b = (lo - o) * inv, (hi - o) * inv
    tn, tf = np.fmin(a, b).max(1), np.fmax(a, b).min(1)
    return np.where((tn <= tf) & (tf >= 0), tf, -1.0).astype(np.float32)


@pytest.mark.parametrize("capped", [False, True], ids=["uncapped", "t_cap"])
@pytest.mark.parametrize("mt", [False, True], ids=["compat", "mt"])
@pytest.mark.parametrize("name", ["box", "interior"])
def test_ftb_single_table_matches_jax_and_is_exit_independent(
        box, interior, name, mt, capped):
    js, ts, width, _, (lo, hi) = _scene(box, interior, name)
    o, d = _random_rays(150, seed=17, lo=lo, hi=hi)
    cap = _scene_exit(o, d, -0.05, 3.05) if capped else None
    ja = jcl.build_cluster_accel(js, width=width, mt=mt)
    ta = tcl.build_cluster_accel(ts, width=width, mt=mt)
    jres = jcl.cluster_intersect(
        ja, jnp.asarray(o), jnp.asarray(d), tile=TILE, mega=MEGA, interpret=True,
        mt=mt, ftb=True, t_cap=None if cap is None else jnp.asarray(cap))
    kw = dict(tile=TILE, mega=MEGA, mt=mt)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    on = tcl.cluster_intersect(ta, ot, dt, ftb=True,
                               t_cap=None if cap is None else torch.as_tensor(cap),
                               **kw)
    off = tcl.cluster_intersect(ta, ot, dt, ftb=False, **kw)
    _check_contract(jres, on)
    _check_contract(tbrute(ts, ot, dt, compat=not mt), on)
    _exact(off, on)  # the exit and the candidate order change nothing


@pytest.mark.parametrize("sgroup", [2, 4])
@pytest.mark.parametrize("mt", [False, True], ids=["compat", "mt"])
@pytest.mark.parametrize("name,n", [("box", 128), ("interior", 205)],
                         ids=["box128", "interior_ragged205"])
def test_hbm_intersect_matches_jax_and_brute(box, interior, name, n, mt, sgroup):
    js, ts, width, _, (lo, hi) = _scene(box, interior, name)
    o, d = _random_rays(n, seed=13, lo=lo, hi=hi)
    ja = jcl.build_cluster_accel(js, width=width, mt=mt)
    ta = tcl.build_cluster_accel(ts, width=width, mt=mt)
    jres = jcl.cluster_intersect_hbm(ja, jnp.asarray(o), jnp.asarray(d), tile=TILE,
                                     mega=MEGA, sgroup=sgroup, interpret=True,
                                     mt=mt)
    ot, dt = torch.as_tensor(o), torch.as_tensor(d)
    tres = tcl.cluster_intersect_hbm(ta, ot, dt, tile=TILE, mega=MEGA,
                                     sgroup=sgroup, mt=mt)
    _check_contract(jres, tres)
    _check_contract(tbrute(ts, ot, dt, compat=not mt), tres)
    _exact(tcl.cluster_intersect(ta, ot, dt, tile=TILE, mega=MEGA, mt=mt), tres)
    # Tables built once give the same answer as tables built in the call.
    built = tcl.build_hbm_accel(ta, sgroup)
    s_n = -(-ta.num_clusters // sgroup)
    assert built.tconst.shape == (s_n, 16, sgroup * ta.width)
    assert built.caabb.shape == (8, s_n)
    _exact(tres, tcl.cluster_intersect_hbm(built, ot, dt, tile=TILE, mega=MEGA,
                                           mt=mt))


def test_supergroup_size_matches_jax():
    for c in (1, 8, 1024, 4096, 8192, 8193, 40960, 1 << 17):
        assert tcl.supergroup_size(c) == jcl.supergroup_size(c)


@pytest.mark.parametrize("path", ["chunked", "ftb", "hbm"])
def test_all_miss_rays(box, path):
    _, ts = box
    o = torch.full((40, 3), 50.0)
    d = torch.tensor([[1.0, 0.0, 0.0]]).expand(40, 3)
    if path == "chunked":
        acc, offs = tcl.build_cluster_accel_chunked(ts, width=4, n_chunks=3)
        hit, t, tri = tcl.cluster_intersect_chunked(acc, offs, o, d, tile=TILE,
                                                    mega=MEGA)
    else:
        acc = tcl.build_cluster_accel(ts, width=4)
        fn = (functools.partial(tcl.cluster_intersect, ftb=True)
              if path == "ftb" else tcl.cluster_intersect_hbm)
        hit, t, tri = fn(acc, o, d, tile=TILE, mega=MEGA)
    assert hit.shape == (40,) and not bool(hit.any())
    assert bool((tri == -1).all()) and bool((t == 1e30).all())


# --------------------------------------------------------------------------
# The plan, and whole renders through each plan.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("large_mode", ["hbm", "hbm_always", "chunked"])
@pytest.mark.parametrize("num_tris", [1 << 17, 1 << 19, 1 << 24])
def test_resolve_plan_matches_jax(num_tris, large_mode):
    jopts = JOpts(intersector="cluster", large_mode=large_mode)
    topts = RenderOptions(large_mode=large_mode)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jplan = jwf.resolve_plan(jopts, num_tris)
    if jplan[0] == "bvh":
        # Past the chunk cap, "chunked" means the LBVH packet walk.
        assert (num_tris, large_mode) == (1 << 24, "chunked")
        with pytest.raises(NotImplementedError, match="A11"):
            twf.resolve_plan(topts, num_tris)
        return
    assert twf.resolve_plan(topts, num_tris) == jplan
    assert twf.swizzle_tile(topts, num_tris) == jwf.swizzle_tile(jopts, num_tris)
    assert twf._should_sort(topts, num_tris)


def test_default_plans_at_bench_size():
    """The 400k-triangle interior pads to 1 << 19: chunked by default (7
    chunks of width 128), the supergroup intersector on request."""
    assert twf.resolve_plan(RenderOptions(), 1 << 19) == ("cluster", 128, 2, 7)
    assert twf.resolve_plan(RenderOptions(large_mode="hbm_always"),
                            1 << 19) == ("cluster_hbm", 128, 2, 1)


def _outside(a, b):
    return np.abs(a - b) > 1e-5 + 1e-4 * np.abs(a)


@pytest.mark.parametrize("large_mode", ["hbm", "hbm_always"],
                         ids=["chunked_plan", "hbm_plan"])
def test_large_scene_render_matches_jax(monkeypatch, large_mode):
    """A whole MODERN render per plan.  Both packages' table budgets are
    lowered so that the 2k-triangle interior (2,048 padded, 128 KB of table
    at width 128) is past the single-table budget and cuts into 3 chunks.
    The options are not used by any other test of this process, so no
    compiled render from before the budgets changed can be reused."""
    for mod in (jwf, twf):
        monkeypatch.setattr(mod, "_VMEM_TABLE_BUDGET", 64 << 10)
        monkeypatch.setattr(mod, "_VMEM_CHUNK_BUDGET", 48 << 10)
    base = dict(spp=2, max_depth=5, seed=11, cluster_width=4, cluster_rays=16,
                sort_rays=True, large_mode=large_mode)
    jopts = JOpts(intersector="cluster_interpret", compat=JMODERN, **base)
    topts = RenderOptions(compat=MODERN, **base)
    js, _ = jlarge(n_tris=2000, options=jopts, width=16, height=16, n_textures=1)
    ts, _ = tlarge(n_tris=2000, options=topts, width=16, height=16, n_textures=1,
                   device="cpu")
    jplan = jwf.resolve_plan(jopts, js.num_tris_padded)
    tplan = twf.resolve_plan(topts, ts.num_tris_padded)
    want = ("cluster", 128, 1, 3) if large_mode == "hbm" else ("cluster_hbm", 128, 1, 1)
    assert tplan == want
    assert jplan == (want[0].replace("cluster", "cluster_interpret"), *want[1:])
    tables = twf.intersector_tables(ts, topts)
    assert isinstance(tables, tcl.ChunkedClusterAccel if large_mode == "hbm"
                      else tcl.HbmClusterAccel)
    ji, jr = jwf.render_image_stats(js, None, jopts)
    ti, tr = twf.render_image_stats(ts, None, topts, device="cpu")
    ji, ti = np.asarray(ji), ti.numpy()
    assert ti.shape == ji.shape == (16, 16, 3)
    assert np.isfinite(ti).all() and ti.mean() > 0
    frac = _outside(ji, ti).any(axis=2).mean()
    assert frac <= 0.005, f"{frac:.2%} of pixels outside rtol 1e-4 / atol 1e-5"
    assert abs(ti.mean() - ji.mean()) <= 1e-4 * abs(ji.mean())
    assert abs(int(tr) - float(jr)) <= 0.005 * float(jr)
