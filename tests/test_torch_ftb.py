"""Port parity: the chunked front-to-back intersect's contract, where the K
chunks meet in one result per ray.

* ``cluster_intersect_ftb_plain`` returns the (R,) lexicographic (t, global
  triangle id) minimum over the chunks.  It is held to the JAX package's
  ``cluster_intersect_chunked`` (Pallas in interpret mode), which merges the
  K kernel results after its pallas_call, on tables whose second chunk is a
  copy of the first: every hit ties at equal t across two chunks and must
  go to the lower global id.
* An exact reject by the plane distance, !(t > 0 && t < 1e30 && t <= the
  ray's best t), written out in plain PyTorch over each subtile's candidate
  triangles one at a time, gives ``cluster_intersect_padded_plain``'s result
  bit for bit on rays parallel to a plane (t = +-inf and NaN), rays that
  start on a plane (t = 0), parked rays (origin 1e9) and equal-t ties.  The
  CUDA kernel counts what this reject would decide (a -DMCPT_COUNT_STATS
  build); PERF.md says why it does not skip those pairs.

Tolerances: as tests/test_torch_large.py (hit mask exact, t within rtol
1e-4 / atol 1e-5, ids on >= 99% of hits) against JAX; exact within the port.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlopathtracing_tpu.kernels import cluster as jcl
from montecarlopathtracing_tpu.scene.builtin import load_builtin_box as jbox
from montecarlopathtracing_tpu.scene.builtin import load_builtin_large as jlarge
from montecarlopathtracing_torch.kernels import cluster as tcl
from montecarlopathtracing_torch.scene.builtin import load_builtin_box as tbox
from montecarlopathtracing_torch.scene.builtin import load_builtin_large as tlarge

torch.set_num_threads(2)

TILE, MEGA = 16, 2
_FIELDS = ("v0", "v1", "v2", "geom_n", "tri_valid")


def _doubled(scene, cat):
    """The scene's triangles followed by a copy of them: triangle i + T is
    triangle i."""
    return dataclasses.replace(
        scene, **{f: cat([getattr(scene, f), getattr(scene, f)]) for f in _FIELDS})


@pytest.fixture(scope="module")
def scenes():
    box = (jbox(width=16, height=16)[0], tbox(width=16, height=16, device="cpu")[0])
    interior = (jlarge(n_tris=2000, width=16, height=16, n_textures=1)[0],
                tlarge(n_tris=2000, width=16, height=16, n_textures=1,
                       device="cpu")[0])
    return {"box": (box, 4, (0.1, 1.9)), "interior": (interior, 32, (0.1, 2.9))}


def _random_rays(n, seed, lo, hi):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[3:6] = 1e9  # parked rays inside a live subtile
    return o, d


@pytest.mark.parametrize("mt", [False, True], ids=["compat", "mt"])
@pytest.mark.parametrize("name", ["box", "interior"])
def test_chunk_merge_matches_jax_and_ties_go_to_the_lower_id(scenes, name, mt):
    (js, ts), width, (lo, hi) = scenes[name]
    jd = _doubled(js, jnp.concatenate)
    td = _doubled(ts, torch.cat)
    ja, joffs = jcl.build_cluster_accel_chunked(jd, width=width, n_chunks=2, mt=mt)
    ta, toffs = tcl.build_cluster_accel_chunked(td, width=width, n_chunks=2, mt=mt)
    t_n = ts.num_tris_padded
    assert toffs == joffs == [0, t_n]  # chunk 1 is the copy of chunk 0
    o, d = _random_rays(6 * TILE + 5, seed=21, lo=lo, hi=hi)
    jres = jcl.cluster_intersect_chunked(ja, joffs, jnp.asarray(o), jnp.asarray(d),
                                         tile=TILE, mega=MEGA, interpret=True,
                                         mt=mt)
    # The plain version's own contract, on the chunked path's inputs.
    ot, dt, _, tile = tcl._shape_and_pad(torch.as_tensor(o), torch.as_tensor(d),
                                         TILE, MEGA)
    cap = tcl.chunk_caps(ta, ot, dt)
    rays = tcl.pack_rays(ot, dt, mt=mt)
    keys, counts = tcl.cluster_keys_chunked_plain(rays, cap, ta.caabb, tile)
    order, qkeys = tcl._ftb_candidates(keys)
    bt, bi = tcl.cluster_intersect_ftb_plain(rays, counts, order, qkeys,
                                             ta.tconst, tile, mt, chunk_cap=cap,
                                             offsets=ta.offsets)
    r = o.shape[0]
    assert bt.shape == bi.shape == (rays.shape[0],)
    assert bt.dtype == torch.float32 and bi.dtype == torch.int32
    hit = bi[:r] >= 0
    got = (hit.numpy(), bt[:r].numpy(), bi[:r].numpy())
    hb, tb, ib = (np.asarray(x) for x in jres)
    np.testing.assert_array_equal(hb, got[0])
    np.testing.assert_allclose(tb[hb], got[1][hb], rtol=1e-4, atol=1e-5)
    assert (ib[hb] == got[2][hb]).mean() >= 0.99
    assert hb.any() and not hb[3:6].any()
    # Every hit tied across the two chunks; both packages keep chunk 0's id.
    assert (got[2][got[0]] < t_n).all() and (ib[hb] < t_n).all()
    assert (got[2][~got[0]] == -1).all() and (got[1][~got[0]] == 1e30).all()
    # The whole chunked intersector gives the same, and the single table of
    # the undoubled scene too.
    whole = tcl.cluster_intersect_chunked(ta, toffs, torch.as_tensor(o),
                                          torch.as_tensor(d), tile=TILE,
                                          mega=MEGA, mt=mt)
    assert torch.equal(whole[2], bi[:r]) and torch.equal(whole[1], bt[:r])
    single = tcl.cluster_intersect(tcl.build_cluster_accel(ts, width=width, mt=mt),
                                   torch.as_tensor(o), torch.as_tensor(d),
                                   tile=TILE, mega=MEGA, mt=mt)
    assert all(torch.equal(a, b) for a, b in zip(single, whole))


# --------------------------------------------------------------------------
# The plane-distance reject.
# --------------------------------------------------------------------------

def _plane_t(ray, col, mt):
    """t of every ray of ``ray`` (n, 16) against one table column (16,), by
    the plain version's expressions."""
    def dot(r, ax, ay, az):
        return ax * col[r] + ay * col[r + 1] + az * col[r + 2]

    ox, oy, oz, dx, dy, dz = (ray[:, i] for i in range(6))
    if mt:
        det = -dot(tcl._M_N, dx, dy, dz)
        return (dot(tcl._M_N, ox, oy, oz) - col[tcl._M_KN]) / det, det
    return (col[tcl._R_KN] - dot(tcl._R_N, ox, oy, oz)) / dot(tcl._R_N, dx, dy, dz), None


def _inside(ray, col, t, det, mt):
    def dot(r, ax, ay, az):
        return ax * col[r] + ay * col[r + 1] + az * col[r + 2]

    ox, oy, oz, dx, dy, dz = (ray[:, i] for i in range(6))
    if mt:
        wx, wy, wz = ray[:, 6], ray[:, 7], ray[:, 8]
        au = dot(tcl._M_E2, wx, wy, wz) + dot(tcl._M_KU, dx, dy, dz)
        av = -dot(tcl._M_E1, wx, wy, wz) + dot(tcl._M_KV, dx, dy, dz)
        return (au * det >= 0) & (av * det >= 0) & ((det - au - av) * det >= 0)
    c = [dot(m, ox, oy, oz) + t * dot(m, dx, dy, dz) - col[m + 3]
         for m in (tcl._R_M1, tcl._R_M2, tcl._R_M3)]
    return (c[0] * c[1] >= 0) & (c[0] * c[2] >= 0) & (c[1] * c[2] >= 0)


def _rejecting_intersect(rays, counts, ids, tconst, tile, mt):
    """Nearest hit with the plane-distance reject: each subtile's candidate
    triangles one at a time, the edge tests only for the pairs the reject
    keeps.  Returns (t, tri) and how many pairs of each kind it decided."""
    r = rays.shape[0]
    width = tconst.shape[2]
    bt = torch.full((r,), tcl.BIG, dtype=torch.float32)
    bi = torch.full((r,), tcl._INT_MAX, dtype=torch.int32)
    seen = dict(inf=0, nan=0, zero=0, behind=0, beyond=0, tie=0, kept=0)
    for s in range(counts.shape[0]):
        rows = slice(s * tile, (s + 1) * tile)
        ray = rays[rows]
        for j in range(int(counts[s])):
            cl = int(ids[s, j])
            for c in range(width):
                col = tconst[cl, :, c]
                t, det = _plane_t(ray, col, mt)
                best = bt[rows]
                keep = (t > 0) & (t < tcl.BIG) & (t <= best)
                seen["inf"] += int(torch.isinf(t).sum())
                seen["nan"] += int(torch.isnan(t).sum())
                seen["zero"] += int((t == 0).sum())
                seen["behind"] += int((t < 0).sum())
                seen["beyond"] += int((torch.isfinite(t) & (t > best)).sum())
                seen["kept"] += int(keep.sum())
                acc = keep & _inside(ray, col, t, det, mt)
                tri = torch.tensor(cl * width + c, dtype=torch.int32)
                seen["tie"] += int((acc & (t == best)).sum())
                better = acc & ((t < best) | ((t == best) & (tri < bi[rows])))
                bt[rows] = torch.where(better, t, best)
                bi[rows] = torch.where(better, tri, bi[rows])
    return bt, torch.where(bt < tcl.BIG, bi, -1), seen


def _edge_case_rays():
    """Rays in the built-in box ([0, 2]^3, walls on the axis planes): along
    an axis (parallel to four walls: t = +-inf), on the floor and along it
    (0 / 0 = NaN), from a wall outwards into the room (t = 0), parked, and
    random ones."""
    rng = np.random.default_rng(4)
    o = rng.uniform(0.1, 1.9, (4 * TILE, 3)).astype(np.float32)
    d = rng.normal(size=(4 * TILE, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[0:4], d[0:4] = [1.0, 1.0, 1.0], np.eye(3, dtype=np.float32)[[0, 1, 2, 0]]
    o[4:8], d[4:8] = [[1.0, 0.0, 1.0], [0.5, 0.0, 0.5], [1.0, 2.0, 1.5],
                      [0.3, 0.0, 0.3]], [[1, 0, 0], [0, 0, -1], [-1, 0, 0],
                                         [0.6, 0, -0.8]]
    o[8:12] = [[0.0, 1.0, 1.0], [2.0, 0.5, 0.5], [1.0, 1.0, 0.0],
               [0.0, 0.3, 1.2]]
    d[8:12] = [[1.0, 0.1, -0.2], [-0.6, 0.8, 0.0], [0.0, 0.0, 1.0],
               [0.8, 0.6, 0.0]]
    o[12:16] = 1e9  # parked
    o[TILE:2 * TILE] = 1e9  # a parked subtile: no candidate
    return torch.as_tensor(o), torch.as_tensor(d / np.linalg.norm(
        d, axis=1, keepdims=True).astype(np.float32))


@pytest.mark.parametrize("mt", [False, True], ids=["compat", "mt"])
@pytest.mark.parametrize("doubled", [False, True], ids=["box", "box_doubled"])
def test_plane_distance_reject_changes_nothing(mt, doubled):
    ts, _ = tbox(width=16, height=16, device="cpu")
    if doubled:
        ts = _doubled(ts, torch.cat)
    acc = tcl.build_cluster_accel(ts, width=4, mt=mt)
    o, d = _edge_case_rays()
    rays8 = tcl.pack_rays(o, d)
    _, counts, ids = tcl.cluster_keys_plain(rays8, tcl._caabb(acc.cmin, acc.cmax),
                                            TILE)
    rays = tcl.pack_rays(o, d, mt=True) if mt else rays8
    want = tcl.cluster_intersect_padded_plain(rays, counts, ids, acc.tconst,
                                              TILE, mt)
    got_t, got_i, seen = _rejecting_intersect(rays, counts, ids, acc.tconst,
                                              TILE, mt)
    assert torch.equal(got_t.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got_i, want[1])
    # The inputs hold what the cases are about.
    assert int(counts[1]) == 0 and bool((want[1][12:16] == -1).all())
    assert seen["inf"] > 0 and seen["nan"] > 0 and seen["zero"] > 0
    assert seen["behind"] > 0 and seen["beyond"] > 0
    assert 0 < seen["kept"] < sum(seen[k] for k in ("inf", "nan", "zero",
                                                    "behind", "beyond")) + seen["kept"]
    if doubled:  # every hit met its copy at equal t, and the lower id won
        assert seen["tie"] > 0
        hit = want[1] >= 0
        assert bool((want[1][hit] < ts.num_tris_padded // 2).all())
