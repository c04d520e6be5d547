"""Port parity: the LBVH build, its two walks, ray_aabb, and the renders and
the plan that run through the walks.

The walks' plain PyTorch versions (the CPU side of bvh_intersect and
packet_intersect) against the JAX package's XLA walks, on the same scenes
built by each package's own loader:

* the box scenes (axis-aligned walls) with adversarial rays: axis-parallel
  directions whose origins lie on node planes (the slab test's 0 * inf =
  NaN), -0.0 direction components, parked rays, misses, and equal-t ties
  between the two triangles of a quad (different leaves): hit, t bits and
  tri exactly equal, in compat and Moller-Trumbore mode;
* the 2k-triangle interior with random rays: hit and tri exactly equal, t
  within rtol 1e-6.  Its triangles are not axis-aligned, and XLA fuses the
  JAX walk's loop body and may contract a * b + c there, so a few t values
  of a few hundred hits differ in the last bit;
* both walks against brute_force_intersect under the intersector contract.

Renders: 16 x 16 MODERN frames with intersector="bvh" and "bvh_perray"
against the JAX renders at tests/test_torch_render.py's tolerance.
"""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopathtracing_tpu.accel import lbvh as JL
from montecarlopathtracing_tpu.config import MODERN as JMODERN
from montecarlopathtracing_tpu.config import RenderOptions as JOpts
from montecarlopathtracing_tpu.integrator.wavefront import render_image_stats as jstats
from montecarlopathtracing_tpu.ops import intersect as jint
from montecarlopathtracing_tpu.scene.builtin import box_scene_text
from montecarlopathtracing_tpu.scene.builtin import load_builtin_large as jlarge
from montecarlopathtracing_tpu.scene.loader import build_scene as jbuild
from montecarlopathtracing_torch import build_lbvh, build_lbvh_host
from montecarlopathtracing_torch.accel import lbvh as TL
from montecarlopathtracing_torch.config import MODERN, RenderOptions
from montecarlopathtracing_torch.integrator import wavefront as twf
from montecarlopathtracing_torch.ops import intersect as tint
from montecarlopathtracing_torch.scene.builtin import load_builtin_large as tlarge
from montecarlopathtracing_torch.scene.loader import build_scene as tbuild

torch.set_num_threads(2)


def _write(d, name, obj, mtl, cam):
    for ext, text in ((".obj", obj), (".mtl", mtl), (".camera", cam)):
        with open(os.path.join(d, name + ext), "w") as fh:
            fh.write(text)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory, box_scene_dir):
    d = str(tmp_path_factory.mktemp("torch_lbvh"))
    _write(d, "spec_glass", *box_scene_text(with_specular=True, with_glass=True,
                                            width=16, height=16))
    for name in ("box", "boxspec"):  # tests/conftest.py's boxes
        for ext in (".obj", ".mtl", ".camera"):
            with open(os.path.join(box_scene_dir, name + ext)) as fh:
                text = fh.read()
            with open(os.path.join(d, name + ext), "w") as fh:
                fh.write(text)
    return d


@pytest.fixture(scope="module")
def scenes(scene_dir):
    """name -> (JAX scene, port scene, JAX LBVH, port LBVH)."""
    out = {}
    for name in ("box", "boxspec", "spec_glass"):
        js, _ = jbuild(scene_dir, name, JOpts())
        ts, _ = tbuild(scene_dir, name, RenderOptions(), device="cpu")
        out[name] = (js, ts, JL.build_lbvh(js), build_lbvh(ts))
    js, _ = jlarge(n_tris=2000, width=16, height=16, n_textures=1)
    ts, _ = tlarge(n_tris=2000, width=16, height=16, n_textures=1, device="cpu")
    out["large"] = (js, ts, JL.build_lbvh_host(js), build_lbvh(ts))
    return out


# --------------------------------------------------------------------------
# The build.
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["box", "boxspec", "spec_glass", "large"])
def test_build_matches_host_build_and_jax(scenes, name):
    js, ts, jb, tb = scenes[name]
    host = build_lbvh_host(ts)
    for field in ("node_min", "node_max"):
        want = np.asarray(getattr(jb, field))
        assert np.array_equal(getattr(tb, field).numpy(), want), field
        assert np.array_equal(getattr(host, field).numpy(), want), field
    assert tb.num_leaves == ts.num_tris_padded == jb.num_leaves


@pytest.mark.parametrize("name", ["boxspec", "large"])
def test_heap_invariants(scenes, name):
    """Heap shape, slot 0 empty, parents containing their children, leaves
    bounding their triangles, padding leaves empty."""
    _, ts, _, tb = scenes[name]
    lc = ts.num_tris_padded
    nmin, nmax = tb.node_min.numpy(), tb.node_max.numpy()
    assert nmin.shape == nmax.shape == (2 * lc, 3)
    assert (nmin[0] > nmax[0]).all()
    kids_min = np.minimum(nmin[2:2 * lc:2], nmin[3:2 * lc:2])
    kids_max = np.maximum(nmax[2:2 * lc:2], nmax[3:2 * lc:2])
    assert np.array_equal(nmin[1:lc], kids_min)
    assert np.array_equal(nmax[1:lc], kids_max)
    valid = ts.tri_valid.numpy()
    for v in (ts.v0, ts.v1, ts.v2):
        v = v.numpy()
        assert (v[valid] >= nmin[lc:][valid]).all()
        assert (v[valid] <= nmax[lc:][valid]).all()
    assert (nmin[lc:][~valid] > nmax[lc:][~valid]).all()


@pytest.mark.parametrize("name", ["spec_glass", "large"])
def test_kernel_records_hold_the_rows_they_are_made_from(scenes, name):
    """The walk kernels' records: ``node_records`` is node_min and node_max
    per node; ``tri_records`` is v0, v1, v2, geom_n per valid slot and NaN
    throughout every other slot, whose test must then fail.  ``finite``
    reads the node records: True here, False with one NaN or infinity."""
    _, ts, _, tb = scenes[name]
    nodes = tb.node_records
    assert nodes.shape == (2 * ts.num_tris_padded, 6) and nodes.is_contiguous()
    assert torch.equal(nodes, torch.cat([tb.node_min, tb.node_max], dim=1))
    assert tb.finite
    for value in (float("nan"), float("inf")):
        bad = tb.node_min.clone()
        bad[3, 1] = value
        assert not TL.BVHArrays(node_min=bad, node_max=tb.node_max).finite
    rec = ts.tri_records
    assert rec.shape == (ts.num_tris_padded, 12) and rec.is_contiguous()
    assert rec.dtype == torch.float32 and rec is ts.tri_records  # made once
    valid = ts.tri_valid
    for j, field in enumerate(("v0", "v1", "v2", "geom_n")):
        assert torch.equal(rec[valid, 3 * j:3 * j + 3], getattr(ts, field)[valid])
    assert bool(torch.isnan(rec[~valid]).all())
    assert (int((~valid).sum()) > 0) == (name == "large")  # its padded slots
    # A NaN record never hits, in either test.
    o = torch.tensor([[0.5, 0.5, 0.5]]).expand(4, 3)
    d = torch.tensor([[0.0, -1.0, 0.0]]).expand(4, 3)
    r = torch.full((4, 12), float("nan"))
    for compat in (True, False):
        hit, t, _ = tint.ray_triangle(o, d, r[:, 0:3], r[:, 3:6], r[:, 6:9],
                                      r[:, 9:12], compat)
        assert not bool(hit.any()) and bool(torch.isnan(t).all())


def test_advance_walks_preorder():
    """_advance gives the preorder successor of every subtree of a depth-3
    perfect tree (against a recursive walk), and equals the JAX _advance."""
    order = []

    def walk(k):
        order.append(k)
        if k < 8:
            walk(2 * k)
            walk(2 * k + 1)

    def subtree(k):
        return {k} | (subtree(2 * k) | subtree(2 * k + 1) if k < 8 else set())

    walk(1)
    got = TL._advance(torch.arange(1, 16)).numpy()
    for k in range(1, 16):
        after = [n for n in order[order.index(k):] if n not in subtree(k)]
        assert got[k - 1] == (after[0] if after else 0), k
    keys = np.arange(1, 1 << 12, dtype=np.int32)
    assert np.array_equal(np.asarray(JL._advance(jnp.asarray(keys))),
                          TL._advance(torch.as_tensor(keys)).numpy())


# --------------------------------------------------------------------------
# The walks.
# --------------------------------------------------------------------------

def _adversarial_rays(nmin, nmax, seed):
    """Rays for a box in [0, 2]^3: random, then axis-parallel rays whose
    origin sits on a node's slab plane (the 0 * inf case), -0.0 direction
    components, parked rays, misses, and rays straight down onto a quad's
    diagonal, where the quad's two triangles tie at equal t."""
    rs = np.random.default_rng(seed)
    n = 160
    o = rs.uniform(0.1, 1.9, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    nodes = rs.integers(1, nmin.shape[0], 48)
    for i, k in enumerate(nodes):  # 48 axis-parallel rays on node planes
        ax = i % 3
        o[i] = rs.uniform(0.1, 1.9, 3)
        o[i, (ax + 1) % 3] = (nmin if i % 2 else nmax)[k, (ax + 1) % 3]
        d[i] = 0.0
        d[i, ax] = 1.0 if i % 4 < 2 else -1.0
    d[48:64, 0] = -0.0                       # -0.0 components
    d[56:64, 2] = -0.0
    d[48:64] /= np.maximum(np.linalg.norm(d[48:64], axis=1, keepdims=True), 1e-6)
    o[64:72] = 1e9                           # parked
    d[64:72] = (1.0, 0.0, 0.0)
    o[72:80] = (5.0, 5.0, 5.0)               # outside, pointing away: misses
    d[72:80] = (0.0, 0.0, 1.0)
    # Onto the floor's diagonal x = z, beside the mirror panel of the
    # specular boxes (x, z in [0.4, 1.6]), whose own diagonal is on the same
    # line: there the shared edge's compat test is exactly 0 in the port
    # (hit), and XLA's contraction inside the JAX walk's compiled loop body
    # can push it to either side, so the JAX walk may pass between the two
    # triangles (the compat edge caveat of CLAUDE.md).
    t = rs.uniform(1.65, 1.95, (16, 1)).astype(np.float32)
    o[80:96] = np.concatenate([t, np.full_like(t, 1.5), t], axis=1)
    d[80:96] = (0.0, -1.0, 0.0)
    d[88:96, 0] = -0.0
    return o, d


def _exact(a, b):
    assert np.array_equal(np.asarray(a[0]), b[0].numpy())
    assert np.array_equal(np.asarray(a[2]), b[2].numpy())
    assert np.array_equal(np.asarray(a[1]).view(np.int32), b[1].numpy().view(np.int32))


def _walks(jb, js, tb, ts, o, d, compat, walk, **kw):
    jo, jd = jnp.asarray(o), jnp.asarray(d)
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    if walk == "perray":
        return (JL.bvh_intersect(jb, js, jo, jd, compat=compat),
                TL.bvh_intersect(tb, ts, to, td, compat=compat))
    return (JL.packet_intersect(jb, js, jo, jd, compat=compat, **kw),
            TL.packet_intersect(tb, ts, to, td, compat=compat, **kw))


@pytest.mark.parametrize("walk", ["perray", "packet"])
@pytest.mark.parametrize("mode", ["compat", "mt"])
@pytest.mark.parametrize("name", ["box", "spec_glass"])
def test_walk_matches_jax_on_adversarial_rays(scenes, name, mode, walk):
    js, ts, jb, tb = scenes[name]
    o, d = _adversarial_rays(tb.node_min.numpy(), tb.node_max.numpy(), seed=3)
    jr, tr = _walks(jb, js, tb, ts, o, d, mode == "compat", walk,
                    **({"packet_size": 32, "leaf_width": 4} if walk == "packet" else {}))
    _exact(jr, tr)
    hit, t, tri = tr
    assert not bool(hit[64:80].any())
    assert bool((tri[~hit] == -1).all()) and bool((t[~hit] == 1e30).all())
    if name == "box":
        # Rays onto the floor's diagonal hit both of its triangles at equal
        # t (the shared edge's test is exactly 0): the lower id wins, as in
        # brute force.
        to, td = torch.as_tensor(o[80:96]), torch.as_tensor(d[80:96])
        assert bool(hit[80:96].all())
        assert torch.equal(tri[80:96], TL.brute_force_intersect(
            ts, to, td, compat=mode == "compat")[2])
        f = ts.tri_valid.numpy()
        floor = np.nonzero(f & (ts.v0.numpy()[:, 1] == 0) & (ts.v1.numpy()[:, 1] == 0)
                           & (ts.v2.numpy()[:, 1] == 0))[0]
        assert len(floor) == 2 and int(tri[80]) == floor.min()
    # The per-ray walk and the packet walk agree with each other.
    other = TL.packet_intersect if walk == "perray" else TL.bvh_intersect
    _exact((hit.numpy(), t.numpy(), tri.numpy()), other(tb, ts, torch.as_tensor(o),
                                                       torch.as_tensor(d),
                                                       compat=mode == "compat"))


@pytest.mark.parametrize("packet_size,leaf_width", [(16, 1), (48, 2), (64, 8),
                                                    (100, 3), (1, 8), (150, 16)])
def test_packet_shapes_match_jax(scenes, packet_size, leaf_width):
    """Packet sizes that do not divide R (parked padding), one-ray packets,
    one packet for all rays, and several fat leaf widths, one of no power
    of two."""
    js, ts, jb, tb = scenes["boxspec"]
    o, d = _adversarial_rays(tb.node_min.numpy(), tb.node_max.numpy(), seed=5)
    o, d = o[:150], d[:150]
    jr, tr = _walks(jb, js, tb, ts, o, d, True, "packet",
                    packet_size=packet_size, leaf_width=leaf_width)
    _exact(jr, tr)


@pytest.mark.parametrize("walk", ["perray", "packet"])
@pytest.mark.parametrize("mode", ["compat", "mt"])
def test_walk_matches_jax_and_brute_on_interior(scenes, mode, walk):
    """Hit and tri exact, t within rtol 1e-6 of the JAX walk (see the module
    note); against brute force, the intersector contract."""
    js, ts, jb, tb = scenes["large"]
    rs = np.random.default_rng(7)
    o = rs.uniform(0.1, 2.9, (384, 3)).astype(np.float32)
    d = rs.normal(size=(384, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jr, tr = _walks(jb, js, tb, ts, o, d, mode == "compat", walk,
                    **({"packet_size": 64} if walk == "packet" else {}))
    assert np.array_equal(np.asarray(jr[0]), tr[0].numpy())
    assert np.array_equal(np.asarray(jr[2]), tr[2].numpy())
    np.testing.assert_allclose(np.asarray(jr[1]), tr[1].numpy(), rtol=1e-6, atol=0)
    hb, tb_, ib = TL.brute_force_intersect(ts, torch.as_tensor(o), torch.as_tensor(d),
                                           compat=mode == "compat")
    hc, tc, ic = tr
    assert torch.equal(hb, hc)
    np.testing.assert_allclose(tb_[hb].numpy(), tc[hb].numpy(), rtol=1e-4, atol=1e-5)
    assert float((ib[hb] == ic[hb]).float().mean()) > 0.99


# --------------------------------------------------------------------------
# Packets that a parallel leaf test or several rays per thread could break.
# --------------------------------------------------------------------------

def _floor_diagonal_rays(seed):
    """Rays straight down onto the box floor's diagonal x = z: the floor's
    two triangles tie at equal t there."""
    t = np.random.default_rng(seed).uniform(1.65, 1.95, (40, 1)).astype(np.float32)
    o = np.concatenate([t, np.full_like(t, 1.5), t], axis=1)
    d = np.tile(np.float32([0.0, -1.0, 0.0]), (40, 1))
    d[20:, 0] = -0.0
    return o, d


def _floor_ids(ts):
    v0, v1, v2 = (getattr(ts, f).numpy() for f in ("v0", "v1", "v2"))
    on = ts.tri_valid.numpy() & (v0[:, 1] == 0) & (v1[:, 1] == 0) & (v2[:, 1] == 0)
    return np.nonzero(on)[0]


@pytest.mark.parametrize("mode", ["compat", "mt"])
@pytest.mark.parametrize("leaf_width", [8, 1], ids=["in_one_leaf", "across_leaves"])
def test_packet_ties_go_to_the_lowest_id(scenes, mode, leaf_width):
    """Equal-t ties inside one fat leaf (width 8: the box's 12 triangles sit
    in two leaves, the floor's pair in one) and across fat leaves (width 1:
    every triangle its own leaf, the first in preorder wins): exact against
    the JAX walk, and the floor's lower id wins."""
    js, ts, jb, tb = scenes["box"]
    o, d = _floor_diagonal_rays(11)
    jr, tr = _walks(jb, js, tb, ts, o, d, mode == "compat", "packet",
                    packet_size=16, leaf_width=leaf_width)
    _exact(jr, tr)
    floor = _floor_ids(ts)
    assert len(floor) == 2 and floor[1] // 8 == floor[0] // 8
    assert bool(tr[0].all()) and bool((tr[2] == int(floor.min())).all())


def _doubled(scene, xp):
    """The walk's view of a scene with every triangle slot repeated after
    the first copy."""
    import types

    cat = (lambda a: xp.concatenate([a, a])) if xp is jnp else (
        lambda a: torch.cat([a, a]))
    return types.SimpleNamespace(
        v0=cat(scene.v0), v1=cat(scene.v1), v2=cat(scene.v2),
        geom_n=cat(scene.geom_n), tri_valid=cat(scene.tri_valid),
        num_tris_padded=2 * scene.num_tris_padded)


@pytest.mark.parametrize("mode", ["compat", "mt"])
@pytest.mark.parametrize("shape", [(32, 8), (16, 4), (64, 6)])
def test_packet_ties_across_leaves_on_a_doubled_box(scenes, mode, shape):
    """Every triangle of the box repeated in a later fat leaf: every hit
    ties with its copy, and the first copy must win (leaf widths 8 and 4).
    Width 6 is no power of two: its fat leaves (tri0 = (k - fat_start) 6)
    do not cover every triangle, so there only the JAX walk is the
    reference."""
    js, ts, _, _ = scenes["boxspec"]
    jd, td = _doubled(js, jnp), _doubled(ts, torch)
    jb, tb = JL.build_lbvh_host(jd), build_lbvh(td)
    rs = np.random.default_rng(12)
    o = rs.uniform(0.1, 1.9, (300, 3)).astype(np.float32)
    d = rs.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jr, tr = _walks(jb, jd, tb, td, o, d, mode == "compat", "packet",
                    packet_size=shape[0], leaf_width=shape[1])
    _exact(jr, tr)
    hit = tr[0]
    assert int(hit.sum()) > 100
    if shape[1] & (shape[1] - 1) == 0:
        assert bool((tr[2][hit] < ts.num_tris_padded).all())


def _far_apart_pairs(tb, ts, seed, n_pairs=12, depth=4):
    """Two-ray packets [b, a] from one origin: b aimed into a depth-4
    node's subtree, a at a triangle outside it whose ray misses that node's
    box, so a's slab test fails where its packet descends, and a meets its
    own fat leaf later in the trail."""
    rs = np.random.default_rng(seed)
    nmin, nmax = tb.node_min.numpy(), tb.node_max.numpy()
    valid = ts.tri_valid.numpy()
    cen = ((ts.v0 + ts.v1 + ts.v2) / 3).numpy()
    lc = tb.num_leaves
    span = lc >> depth
    origin = np.float32([1.5, 1.5, 1.5])
    o, d = [], []
    while len(o) < 2 * n_pairs:
        node = int(rs.integers(1 << depth, 2 << depth))
        first = node * span - lc
        tb_, ta = first + int(rs.integers(0, span)), int(rs.integers(0, lc))
        if not (valid[tb_] and valid[ta]) or first <= ta < first + span:
            continue
        da = (cen[ta] - origin) / np.linalg.norm(cen[ta] - origin)
        with np.errstate(divide="ignore", invalid="ignore"):
            t0, t1 = (nmin[node] - origin) / da, (nmax[node] - origin) / da
        if np.nanmax(np.minimum(t0, t1)) <= np.nanmin(np.maximum(t0, t1)):
            continue
        db = cen[tb_] - origin
        o += [origin, origin]
        d += [db / np.linalg.norm(db), da]
    return np.asarray(o, np.float32), np.asarray(d, np.float32)


@pytest.mark.parametrize("mode", ["compat", "mt"])
def test_packet_mate_misses_a_node_then_meets_its_leaf(scenes, mode):
    """Packets of two rays on the 2k interior: the second misses a node the
    first makes its packet enter, then hits its own triangle later: hit and
    tri exact against the JAX walk, t within the interior's rtol (module
    note)."""
    js, ts, jb, tb = scenes["large"]
    o, d = _far_apart_pairs(tb, ts, seed=13)
    jr, tr = _walks(jb, js, tb, ts, o, d, mode == "compat", "packet",
                    packet_size=2)
    assert np.array_equal(np.asarray(jr[0]), tr[0].numpy())
    assert np.array_equal(np.asarray(jr[2]), tr[2].numpy())
    np.testing.assert_allclose(np.asarray(jr[1]), tr[1].numpy(), rtol=1e-6, atol=0)
    assert int(tr[0][1::2].sum()) >= len(o) // 4


@pytest.mark.parametrize("max_steps", [1, 3, 6, 9])
def test_packet_max_steps_matches_jax(scenes, max_steps):
    """A packet stopped by a small explicit max_steps keeps the hits found
    so far, as the JAX walk does."""
    js, ts, jb, tb = scenes["boxspec"]
    o, d = _adversarial_rays(tb.node_min.numpy(), tb.node_max.numpy(), seed=14)
    for compat in (True, False):
        jr, tr = _walks(jb, js, tb, ts, o, d, compat, "packet", packet_size=32,
                        leaf_width=2, max_steps=max_steps)
        _exact(jr, tr)


@pytest.mark.parametrize("max_steps", [1, 3, 6, 9])
def test_perray_max_steps_matches_jax(scenes, max_steps):
    """A ray stopped by a small explicit max_steps keeps the hits found so
    far, as the JAX walk does, compat and MT."""
    js, ts, jb, tb = scenes["boxspec"]
    o, d = _adversarial_rays(tb.node_min.numpy(), tb.node_max.numpy(), seed=15)
    for compat in (True, False):
        jo, jd = jnp.asarray(o), jnp.asarray(d)
        jr = JL.bvh_intersect(jb, js, jo, jd, compat=compat, max_steps=max_steps)
        tr = TL.bvh_intersect(tb, ts, torch.as_tensor(o), torch.as_tensor(d),
                              compat=compat, max_steps=max_steps)
        _exact(jr, tr)
        if max_steps < 4:  # the box's leaves lie 4 levels down
            assert not bool(tr[0].any())


@pytest.mark.parametrize("mode", ["compat", "mt"])
def test_perray_ties_across_leaves_on_a_doubled_box(scenes, mode):
    """Every triangle of the box repeated in a later leaf: every hit ties at
    equal t with its copy, and the first in preorder (the lower id) must win,
    exact against the JAX walk."""
    js, ts, _, _ = scenes["boxspec"]
    jd, td = _doubled(js, jnp), _doubled(ts, torch)
    jb, tb = JL.build_lbvh_host(jd), build_lbvh(td)
    rs = np.random.default_rng(16)
    o = rs.uniform(0.1, 1.9, (300, 3)).astype(np.float32)
    d = rs.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    jr = JL.bvh_intersect(jb, jd, jnp.asarray(o), jnp.asarray(d), compat=mode == "compat")
    tr = TL.bvh_intersect(tb, td, torch.as_tensor(o), torch.as_tensor(d),
                          compat=mode == "compat")
    _exact(jr, tr)
    hit = tr[0]
    assert int(hit.sum()) > 100
    assert bool((tr[2][hit] < ts.num_tris_padded).all())


def test_bvh_walk_stats_summary_reads_the_counters():
    """The summary of the per-ray walk's counters, on made-up counts over
    two calls: means and p99 per ray, SIMT efficiency and lone iterations
    from the rays' shares of warp iterations, cycles per step and their
    split, and the blocks' times."""
    names = TL.BVH_WALK_STATS
    c = {n: j for j, n in enumerate(names)}
    one = 2 ** 20
    a = torch.zeros((64, len(names)), dtype=torch.int64)
    a[:, c["steps"]] = 10
    a[0, c["steps"]] = 40                 # ray 0: 10 steps in a full warp,
    a[:, c["warp_share"]] = 10 * one // 32
    a[0, c["warp_share"]] = 10 * one // 32 + 30 * one  # then 30 alone
    a[0, c["lone_steps"]] = 30
    a[:, c["leaf_tests"]] = 1
    a[:, c["cycles"]] = 100 * a[:, c["steps"]]
    a[:, c["cycles_node"]] = 30 * a[:, c["steps"]]
    a[:, c["cycles_slab"]] = 20 * a[:, c["steps"]]
    a[:, c["cycles_leaf_load"]] = 10
    a[:, c["cycles_leaf_test"]] = 5
    a[:, c["top_steps"]] = 5
    a[:, c["thread"]] = torch.arange(64)
    a[:, c["block"]] = torch.arange(64) // 32
    a[:, c["start_ns"]] = 1000
    a[:, c["end_ns"]] = 2000
    a[32:, c["end_ns"]] = 5000            # block 1 ends last
    b = a.clone()
    b[0, c["steps"]], b[0, c["warp_share"]], b[0, c["lone_steps"]] = 10, 10 * one // 32, 0
    b[0, c["cycles"]], b[0, c["cycles_node"]], b[0, c["cycles_slab"]] = 1000, 300, 200
    out = TL.bvh_walk_stats_summary([a, b])
    assert out["calls"] == 2 and out["rays"] == 128
    steps = 64 * 10 + 30 + 64 * 10
    assert out["steps_per_ray_mean"] == steps / 128
    assert out["steps_per_ray_max"] == 40 and out["steps_per_ray_p99"] == 10
    assert out["leaf_tests_per_ray"] == 1
    # Warp iterations: 10 for each of the 4 warps, 30 more of ray 0's alone.
    assert out["simt_efficiency"] == steps / (32 * (4 * 10 + 30))
    assert out["lone_share_of_warp_steps"] == 30 / (4 * 10 + 30)
    assert out["top_share_of_steps"] == 5 * 128 / steps
    assert out["cycles_per_step"] == 100
    assert out["cycles_per_step_node"] == 30 and out["cycles_per_step_slab"] == 20
    assert out["cycles_per_step_leaf_load"] == 10 * 128 / steps
    parts = sum(out["cycles_per_step_" + p] for p in
                ("node", "slab", "leaf_load", "leaf_test", "rest"))
    assert abs(parts - out["cycles_per_step"]) < 1e-9
    assert out["span_ns"] == 4000 and out["block_max_ns"] == 4000
    assert out["block_mean_ns"] == 2500
    assert out["blocks_half_done_ns"] == 1000 and out["blocks_90_done_ns"] == 4000


def test_packet_walk_stats_summary_reads_the_counters():
    """The summary of a measurement build's counters, on made-up counts:
    means per packet, per visit and per step, and each call's longest
    trail."""
    names = TL.PACKET_WALK_STATS
    a = torch.zeros((2, len(names)), dtype=torch.int64)
    b = torch.zeros((1, len(names)), dtype=torch.int64)
    for row, vals in ((a[0], (10, 2, 6, 2, 1000, 100, 200, 300, 40, 60)),
                      (a[1], (30, 4, 2, 2, 3000, 300, 600, 900, 120, 180)),
                      (b[0], (20, 0, 0, 0, 4000, 1000, 1000, 1000, 0, 0))):
        row[:] = torch.tensor(vals)
    out = TL.packet_walk_stats_summary([a, b])
    assert out["calls"] == 2 and out["packets"] == 3
    assert out["steps_per_packet_mean"] == 20 and out["steps_per_packet_max"] == 30
    assert out["leaf_visits_per_packet"] == 2
    assert out["rays_per_leaf_visit"] == 8 / 6 and out["warps_per_leaf_visit"] == 4 / 6
    assert out["cycles_per_step"] == 8000 / 60
    assert out["cycles_per_step_node"] == 1400 / 60
    parts = sum(out["cycles_per_step_" + p] for p in
                ("node", "slab", "barrier", "leaf_stage", "leaf_test", "rest"))
    assert abs(parts - out["cycles_per_step"]) < 1e-9
    assert out["longest_steps_mean"] == 25 and out["longest_cycles_mean"] == 3500
    assert out["longest_cycles_per_step"] == 140


def test_packet_stats_need_the_card(scenes):
    """The counters come from a measurement build of the CUDA kernel: on
    the CPU, asking for them raises instead of returning zeros."""
    _, ts, _, tb = scenes["box"]
    o = torch.zeros((4, 3))
    d = torch.tensor([[1.0, 0.0, 0.0]]).expand(4, 3).contiguous()
    with pytest.raises(ValueError, match="measurement build"):
        TL.packet_intersect(tb, ts, o, d, stats=torch.zeros((1, 10), dtype=torch.int64))


def test_perray_stats_need_the_card(scenes):
    """As test_packet_stats_need_the_card, for the per-ray walk."""
    _, ts, _, tb = scenes["box"]
    o = torch.zeros((4, 3))
    d = torch.tensor([[1.0, 0.0, 0.0]]).expand(4, 3).contiguous()
    stats = torch.zeros((4, len(TL.BVH_WALK_STATS)), dtype=torch.int64)
    with pytest.raises(ValueError, match="measurement build"):
        TL.bvh_intersect(tb, ts, o, d, stats=stats)


def test_ray_aabb_matches_jax_with_nan():
    """NaN of 0 * inf propagates through the max and min as in jnp.max: a
    ray along an axis whose origin lies on the box's plane misses."""
    rs = np.random.default_rng(1)
    n = 256
    o = rs.uniform(-1, 2, (n, 3)).astype(np.float32)
    d = rs.normal(size=(n, 3)).astype(np.float32)
    d[:64, 1:] = 0.0
    d[64:96, 0] = -0.0
    bmin = rs.uniform(-0.5, 0.5, (n, 3)).astype(np.float32)
    bmax = bmin + rs.uniform(0.1, 1.0, (n, 3)).astype(np.float32)
    o[:64, 1] = bmin[:64, 1]  # on the slab plane: (bmin - o) * inf = 0 * inf
    bmin[-8:], bmax[-8:] = 1e30, -1e30  # empty padding boxes
    tmax = rs.uniform(0.0, 3.0, n).astype(np.float32)
    inv_j = 1.0 / jnp.asarray(d)
    inv_t = 1.0 / torch.as_tensor(d)
    for t_max in (None, tmax):
        want = np.asarray(jint.ray_aabb(jnp.asarray(o), inv_j, jnp.asarray(bmin),
                                        jnp.asarray(bmax),
                                        None if t_max is None else jnp.asarray(t_max)))
        got = tint.ray_aabb(torch.as_tensor(o), inv_t, torch.as_tensor(bmin),
                            torch.as_tensor(bmax),
                            None if t_max is None else torch.as_tensor(t_max))
        assert np.array_equal(want, got.numpy())
    assert not bool(got[:64].any()) and not bool(got[-8:].any())


def test_wrappers_never_fall_back_off_cpu(scenes):
    """A tensor that is not on the CPU never reaches the plain walk: the
    wrapper launches the kernel or raises (here: not a CUDA tensor)."""
    _, ts, _, tb = scenes["box"]
    meta = ts.__class__(**{f.name: (getattr(ts, f.name).to("meta")
                                    if isinstance(getattr(ts, f.name), torch.Tensor)
                                    else getattr(ts, f.name))
                           for f in ts.__dataclass_fields__.values()})
    bvh = tb.to("meta")
    o = torch.zeros((64, 3), device="meta")
    before = TL.launch_counts()
    for fn in (TL.bvh_intersect, TL.packet_intersect):
        with pytest.raises(ValueError, match="CUDA"):
            fn(bvh, meta, o, o)
    TL.bvh_intersect(tb, ts, torch.zeros((4, 3)), torch.ones((4, 3)))
    assert TL.launch_counts() == before


# --------------------------------------------------------------------------
# Renders and the plan.
# --------------------------------------------------------------------------

def _image_close(a, b):
    """tests/test_torch_render.py's MODERN tolerance."""
    outside = np.abs(a - b) > 1e-5 + 1e-4 * np.abs(a)
    assert outside.any(axis=2).mean() <= 0.005
    assert abs(a.mean() - b.mean()) <= 1e-4 * abs(a.mean())


@pytest.mark.parametrize("kind", ["bvh", "bvh_perray"])
def test_walk_render_matches_jax(scenes, kind):
    js, ts, jb, _ = scenes["spec_glass"]
    kw = dict(spp=4, max_depth=8, intersector=kind, packet_size=64, seed=5)
    jimg, jrays = jstats(js, jb, JOpts(compat=JMODERN, **kw))
    timg, trays = twf.render_image_stats(ts, None, RenderOptions(compat=MODERN, **kw),
                                         device="cpu")
    assert int(jrays) == int(trays)
    _image_close(np.asarray(jimg), timg.numpy())


def test_chunk_cap_falls_back_to_packet_walk(scenes, monkeypatch):
    """Past the chunk cap with large_mode="chunked" the plan is the packet
    walk, with the JAX package's warning when the cluster intersector was
    asked for by name and none under "auto"; the frame then equals the JAX
    package's packet-walk render."""
    js, ts, jb, _ = scenes["spec_glass"]
    monkeypatch.setattr(twf, "_VMEM_TABLE_BUDGET", 0)
    base = dict(spp=2, max_depth=6, large_mode="chunked", max_table_chunks=0,
                packet_size=64, seed=9)
    with pytest.warns(UserWarning, match="packet walk"):
        plan = twf.resolve_plan(RenderOptions(intersector="cluster", **base),
                                ts.num_tris_padded)
    assert plan == ("bvh", None, None, 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        opts = RenderOptions(compat=MODERN, **base)
        assert twf.resolve_plan(opts, ts.num_tris_padded)[0] == "bvh"
        assert twf.swizzle_tile(opts, ts.num_tris_padded) == 64
        timg, _ = twf.render_image_stats(ts, None, opts, device="cpu")
    jimg, _ = jstats(js, jb, JOpts(compat=JMODERN, intersector="bvh", **base))
    _image_close(np.asarray(jimg), timg.numpy())


def test_intersect_any_dispatches_walks(scenes):
    """intersect_any sends "bvh_perray" to bvh_intersect and "bvh" to
    packet_intersect with opts.packet_size / opts.leaf_width, using the LBVH
    passed as ``bvh`` or building it."""
    _, ts, _, tb = scenes["boxspec"]
    o, d = _adversarial_rays(tb.node_min.numpy(), tb.node_max.numpy(), seed=11)
    o, d = torch.as_tensor(o), torch.as_tensor(d)
    for kind, fn, kw in (("bvh_perray", TL.bvh_intersect, {}),
                         ("bvh", TL.packet_intersect,
                          dict(packet_size=32, leaf_width=2))):
        opts = RenderOptions(intersector=kind, **kw)
        want = fn(tb, ts, o, d, **kw)
        for bvh in (tb, None):
            got = twf.intersect_any(ts, bvh, o, d, opts)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
        assert isinstance(twf.intersector_tables(ts, opts), TL.BVHArrays)
