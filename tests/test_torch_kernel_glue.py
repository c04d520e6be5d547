"""The glue between the port's Python wrappers and its CUDA sources.

Nothing here can compile CUDA, so these tests hold what the CPU can see:

* every ``extern "C"`` prototype in ``kernels/csrc/*.cu``, parsed from the
  source, against the ctypes signature ``kernels/build.py`` declares for it
  (argument count, pointer or int per argument);
* the 64-bit join word of the single-table intersect kernel: a subtile's
  candidate list cut into runs as the kernel cuts it, each run's plain
  result packed as (float bits of t) << 32 | triangle id, the runs joined by
  an integer minimum and unpacked by the wrapper's ``_unpack_hits``, must
  equal the plain version over the whole list exactly, with a subtile that
  has no candidate, rays that miss everything, and ties at equal t;
* the chunked kernel's result: each chunk's bests packed with the chunk's
  offset and joined by an integer minimum, against the plain version's
  lexicographic merge of the chunks;
* the order in which the front-to-back kernels start their rows;
* the plain versions of what the key kernel fuses in for the front-to-back
  paths: the compact list (only a row's hits sorted) against the first
  ``count`` entries of the full-width sort, and the row list against the
  counts; and whole chunked and supergroup intersects fed by them against
  the same intersects fed by the full-width sort;
* the note at the head of every kernel source.

All comparisons are exact (integer work and bit patterns).
"""

import ctypes
import os
import re

import numpy as np
import pytest
import torch

from montecarlopathtracing_torch.accel import lbvh as L
from montecarlopathtracing_torch.kernels import build as B
from montecarlopathtracing_torch.kernels import cluster as K
from montecarlopathtracing_torch.scene.builtin import load_builtin_large

torch.set_num_threads(2)

TILE = 64


# --------------------------------------------------------------------------
# C prototypes against the ctypes signatures.
# --------------------------------------------------------------------------

def _prototype(source: str, symbol: str):
    """Kinds ('p' pointer, 'i' int) of the arguments of ``extern "C" int
    symbol(...)`` in csrc/<source>.cu."""
    text = open(os.path.join(B.CSRC_DIR, source + ".cu")).read()
    m = re.search(r'extern\s+"C"\s+int\s+' + re.escape(symbol)
                  + r"\s*\(([^)]*)\)\s*\{", text)
    assert m, f"{symbol} not found in {source}.cu"
    kinds = []
    for arg in m.group(1).split(","):
        arg = " ".join(arg.split())
        if "*" in arg:
            kinds.append("p")
        else:
            assert re.fullmatch(r"int \w+", arg), f"{symbol}: argument {arg!r}"
            kinds.append("i")
    return kinds


@pytest.mark.parametrize("name", sorted(B._SIGNATURES))
def test_c_prototype_matches_ctypes_signature(name):
    source, symbol, argtypes = B._SIGNATURES[name]
    assert source in B.KERNELS
    declared = ["p" if t is ctypes.c_void_p else "i" for t in argtypes]
    assert all(t in (ctypes.c_void_p, ctypes.c_int) for t in argtypes)
    assert _prototype(source, symbol) == declared
    assert declared[-1] == "p"  # the stream


def test_every_entry_point_has_a_signature():
    found = set()
    for fname in os.listdir(B.CSRC_DIR):
        if fname.endswith(".cu"):
            text = open(os.path.join(B.CSRC_DIR, fname)).read()
            for sym in re.findall(r'extern\s+"C"\s+int\s+(\w+)\s*\(', text):
                found.add((fname[:-3], sym))
    assert found == {(src, sym) for src, sym, _ in B._SIGNATURES.values()}
    # One wrapper each: the cluster kernels' and the LBVH walks'.
    assert set(K._WRAPPERS) | set(L._WRAPPERS) == set(B._SIGNATURES)


@pytest.mark.parametrize("fname", sorted(
    f for f in os.listdir(B.CSRC_DIR) if f.endswith((".cu", ".cuh"))))
def test_source_note_names_what_it_replaces_and_its_bound(fname):
    head = open(os.path.join(B.CSRC_DIR, fname)).read().split("#include")[0]
    assert "montecarlopathtracing_tpu/kernels/cluster.py" in head
    assert "ound" in head  # what bounds it on the card
    assert "no cp.async" not in head


# --------------------------------------------------------------------------
# The join word.
# --------------------------------------------------------------------------

def _pack_hits(t, tri):
    """The kernel's word for an accepted hit, the preset miss otherwise."""
    word = (t.contiguous().view(torch.int32).to(torch.int64) << 32) | (
        tri.to(torch.int64) & 0xFFFFFFFF)
    return torch.where(tri >= 0, word, K._PACKED_MISS)


MIN_PER = 2  # kMinPer of cluster_intersect.cu


def _runs(counts, n_split: int):
    """(start, length) per subtile of each of the n_split runs the kernel
    cuts a candidate list into: per = max(MIN_PER, ceil(count / n_split))."""
    per = torch.clamp((counts + n_split - 1) // n_split, min=MIN_PER)
    for y in range(n_split):
        lo = y * per
        yield lo, torch.clamp(counts - lo, min=0, max=None).minimum(per)


@pytest.fixture(scope="module")
def doubled_interior():
    """The 2k-triangle interior's single table followed by a copy of itself:
    cluster c + C repeats cluster c, so every hit ties at equal t with
    triangle id + T, and the lower id must win."""
    scene, _ = load_builtin_large(n_tris=2000, width=16, height=16,
                                  n_textures=1, device="cpu")
    out = {}
    for mt in (False, True):
        acc = K.build_cluster_accel(scene, width=32, mt=mt)
        out[mt] = K.ClusterAccel(tconst=torch.cat([acc.tconst, acc.tconst]),
                                 cmin=torch.cat([acc.cmin, acc.cmin]),
                                 cmax=torch.cat([acc.cmax, acc.cmax]))
    return scene, out


def _rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.1, 2.9, (n, 3)).astype(np.float32)
    # Aimed at the props in the middle of the room, whose clusters are small,
    # so that a subtile meets many of them.
    target = rng.uniform([0.6, 0.0, 0.6], [2.4, 1.3, 1.6], (n, 3))
    d = (target - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[TILE:2 * TILE] = 1e9          # a parked subtile: no candidate
    o[2 * TILE:2 * TILE + 4] = 50.0  # outside the room, pointing away:
    d[2 * TILE:2 * TILE + 4] = [1.0, 0.0, 0.0]  # rays that miss everything
    return torch.as_tensor(o), torch.as_tensor(d)


def test_packed_miss_is_the_largest_word_and_unpacks_to_the_miss():
    miss = torch.tensor([K._PACKED_MISS], dtype=torch.int64)
    t, tri = K._unpack_hits(miss)
    assert t.dtype == torch.float32 and tri.dtype == torch.int32
    assert t.item() == np.float32(1e30) and tri.item() == -1
    # Any accepted hit (0 < t < 1e30, id >= 0) packs below it, and words
    # order as (t, id) does.
    ts = torch.tensor([1e-30, 0.5, 0.5, 0.5, 2.0, 9.9e29], dtype=torch.float32)
    ids = torch.tensor([7, 3, 4, 2 ** 31 - 1, 0, 5], dtype=torch.int32)
    words = _pack_hits(ts, ids)
    assert bool((words < K._PACKED_MISS).all())
    assert words.tolist() == sorted(words.tolist())
    back_t, back_i = K._unpack_hits(words)
    assert torch.equal(back_t, ts) and torch.equal(back_i, ids)


@pytest.mark.parametrize("n_split", [1, 2, 3, 8])
@pytest.mark.parametrize("mt", [False, True], ids=["compat", "mt"])
def test_joined_runs_equal_the_plain_version(doubled_interior, mt, n_split):
    _, accels = doubled_interior
    acc = accels[mt]
    o, d = _rays(6 * TILE + 5, seed=5)
    o, d, _, tile = K._shape_and_pad(o, d, TILE, 2)
    rays8 = K.pack_rays(o, d)
    _, counts, ids = K.cluster_keys_plain(rays8, K._caabb(acc.cmin, acc.cmax),
                                          tile)
    rays = K.pack_rays(o, d, mt=True) if mt else rays8
    want_t, want_i = K.cluster_intersect_padded_plain(rays, counts, ids,
                                                      acc.tconst, tile, mt)
    # The inputs hold what the cases are about.
    assert int(counts[1]) == 0
    assert n_split == 1 or int(counts.max()) > 2 * MIN_PER  # lists are cut
    hit = want_i >= 0
    assert bool(hit.any()) and bool((~hit[2 * TILE:2 * TILE + 4]).all())
    assert bool((want_i[hit] < acc.tconst.shape[0] // 2 * acc.width).all())

    joined = torch.full((rays.shape[0],), K._PACKED_MISS, dtype=torch.int64)
    c = ids.shape[1]
    col = torch.arange(c)[None, :]
    covered = torch.zeros_like(counts)
    for lo, length in _runs(counts, n_split):
        # The run's candidates moved to the front of each row.
        run_ids = torch.gather(ids, 1, (col + lo[:, None].long()) % c)
        t, tri = K.cluster_intersect_padded_plain(
            rays, length.to(torch.int32), run_ids, acc.tconst, tile, mt)
        joined = torch.minimum(joined, _pack_hits(t, tri))
        covered += length
    assert torch.equal(covered, counts)  # the runs cover every candidate once
    got_t, got_i = K._unpack_hits(joined)
    assert torch.equal(got_t, want_t) and torch.equal(got_i, want_i)


@pytest.mark.parametrize("mt", [False, True], ids=["compat", "mt"])
def test_chunks_joined_by_word_equal_the_plain_merge(doubled_interior, mt):
    """The chunked kernel's result: each (chunk, ray)'s best packed with the
    chunk's offset (a global id) and joined by an integer minimum, as the
    rows' atomicMin into one word per ray does, equals the plain version's
    lexicographic merge of the K chunks, exactly."""
    scene, _ = doubled_interior
    acc, offsets = K.build_cluster_accel_chunked(scene, width=32, n_chunks=3,
                                                 mt=mt)
    assert len(offsets) == 3 and offsets[0] == 0
    o, d = _rays(5 * TILE + 7, seed=12)
    o, d, _, tile = K._shape_and_pad(o, d, TILE, 2)
    cap = K.chunk_caps(acc, o, d)
    rays = K.pack_rays(o, d, mt=mt)
    keys, counts = K.cluster_keys_chunked_plain(rays, cap, acc.caabb, tile)
    order, qkeys = K._ftb_candidates(keys)
    want = K.cluster_intersect_ftb_plain(rays, counts, order, qkeys, acc.tconst,
                                         tile, mt, chunk_cap=cap,
                                         offsets=acc.offsets)
    n_sub, c = rays.shape[0] // tile, acc.clusters_per_chunk
    joined = torch.full((rays.shape[0],), K._PACKED_MISS, dtype=torch.int64)
    hits_per_chunk = []
    for k in range(3):
        rows = slice(k * n_sub, (k + 1) * n_sub)
        t, tri = K._ftb_plain(K._park_rays(rays, cap[k], mt), cap[k],
                              counts[rows], order[rows], qkeys[rows],
                              acc.tconst[k * c:(k + 1) * c], tile, mt)
        hits_per_chunk.append(int((tri >= 0).sum()))
        glob = torch.where(tri >= 0, tri + offsets[k], -1)
        joined = torch.minimum(joined, _pack_hits(t, glob))
    got_t, got_i = K._unpack_hits(joined)
    assert torch.equal(got_t.view(torch.int32), want[0].view(torch.int32))
    assert torch.equal(got_i, want[1])
    assert sum(h > 0 for h in hits_per_chunk) >= 2  # rays hit in several chunks


def test_rows_longest_first_is_a_stable_descending_permutation():
    """The order in which the front-to-back kernels start their rows (the
    row list, bucket by bucket): the rows with candidates, each once, by
    falling power of two of the count, rows of one bucket ascending."""
    rng = np.random.default_rng(9)
    counts = torch.as_tensor(rng.integers(0, 300, 200).astype(np.int32))
    counts[rng.uniform(size=200) < 0.4] = 0
    perm = K.listed_rows(*K.ftb_row_list_plain(counts))
    assert perm.dtype == torch.int64
    assert sorted(perm.tolist()) == torch.nonzero(counts > 0)[:, 0].tolist()
    by = torch.clamp(counts[perm], max=128).float().log2().floor()
    assert bool((by[:-1] >= by[1:]).all())
    same = by[:-1] == by[1:]
    assert bool((perm[1:][same] > perm[:-1][same]).all())


def test_front_to_back_ties_go_to_the_lowest_id(doubled_interior):
    """On the doubled table every hit ties with its copy: the front-to-back
    entry and the plain scan both keep the lower triangle id."""
    _, accels = doubled_interior
    acc = accels[False]
    o, d = _rays(4 * TILE, seed=6)
    ftb = K.cluster_intersect(acc, o, d, tile=TILE, mega=2, ftb=True)
    ref = K.cluster_intersect(acc, o, d, tile=TILE, mega=2)
    assert all(torch.equal(a, b) for a, b in zip(ftb, ref))
    hit, _, tri = ftb
    assert bool(hit.any())
    assert bool((tri[hit] < acc.tconst.shape[0] // 2 * acc.width).all())


# --------------------------------------------------------------------------
# The front-to-back list and the row list that the key kernel fuses in.
# --------------------------------------------------------------------------

def _seeded_keys(c: int, seed: int):
    """(rows, c) keys: random hits and misses, an all-miss row, a full row,
    a row of equal keys, a row of keys that differ only below the id bits
    (equal once quantised), zeros."""
    rng = np.random.default_rng(seed)
    key = rng.uniform(0.0, 40.0, (9, c)).astype(np.float32)
    key[rng.uniform(size=key.shape) < 0.6] = 1e30
    key[0] = 1e30                                    # all miss
    key[1] = rng.uniform(0.0, 40.0, c)               # full
    key[2] = 3.25                                    # all equal
    key[3] = np.float32(7.0) + np.arange(c, dtype=np.float32) * np.float32(1e-7)
    key[4, : max(1, c // 3)] = 0.0
    return torch.as_tensor(key)


@pytest.mark.parametrize("c", [1, 24, 592, 1024])
def test_compact_list_equals_the_sorted_prefix(c):
    """Exact: ftb_compact_plain == _ftb_candidates on each row's first count
    entries, ties (equal quantised keys) included; past the count 0 / 1e30."""
    keys = _seeded_keys(c, seed=c)
    counts = (keys < 1e30).sum(dim=1)
    assert int(counts[0]) == 0 and int(counts[1]) == c
    order, qkeys = K.ftb_compact_plain(keys)
    order_s, qkeys_s = K._ftb_candidates(keys)
    assert order.dtype == torch.int32 and qkeys.dtype == torch.float32
    used = torch.arange(c)[None, :] < counts[:, None]
    assert torch.equal(order[used], order_s[used])
    assert torch.equal(qkeys[used].view(torch.int32),
                       qkeys_s[used].view(torch.int32))
    assert bool((order[~used] == 0).all()) and bool((qkeys[~used] == 1e30).all())
    if c > 1:  # the equal keys of row 2 come out in id order
        assert order[2].tolist() == list(range(c))


@pytest.mark.parametrize("n", [1, 200, 4096])
def test_row_list_plain_is_the_rows_with_candidates(n):
    rng = np.random.default_rng(n)
    counts = torch.as_tensor(rng.integers(0, 300, n).astype(np.int32))
    counts[rng.uniform(size=n) < 0.5] = 0
    counts[rng.uniform(size=n) < 0.3] = 1
    heads, rows = K.ftb_row_list_plain(counts)
    assert heads.dtype == torch.int32 and heads.shape == (K.FTB_BUCKETS,)
    assert rows.dtype == torch.int32 and rows.shape == (K.FTB_BUCKETS, n)
    listed = K.listed_rows(heads, rows)
    assert sorted(listed.tolist()) == torch.nonzero(counts > 0)[:, 0].tolist()
    # Longest buckets first, by powers of two: 128 and more, 64-127, ..., 1.
    assert K._BUCKET_MIN == (128, 64, 32, 16, 8, 4, 2, 1)
    for b, least in enumerate(K._BUCKET_MIN):
        got = counts[rows[b, :int(heads[b])].long()]
        assert bool((got >= least).all())
        assert b == 0 or bool((got < K._BUCKET_MIN[b - 1]).all())


def test_row_list_check_holds_the_layout_of_the_device_code():
    """The intersect wrappers take (heads (buckets,), rows (buckets, n_rows))
    int32 and nothing else: what cluster_rows.cuh indexes."""
    cpu = torch.device("cpu")
    good = K.ftb_row_list_plain(torch.tensor([0, 3, 200], dtype=torch.int32))
    assert K._check_row_list("x", good, 3, cpu) == good
    heads, rows = good
    for bad in ((heads[:-1], rows), (heads, rows[:, :2]), (heads.long(), rows),
                (heads, rows.T.contiguous().T), (torch.cat([heads, heads]), rows)):
        with pytest.raises(ValueError, match="row_list"):
            K._check_row_list("x", bad, 3, cpu)


@pytest.mark.parametrize("fn", [K.cluster_intersect_ftb,
                                K.cluster_intersect_hbm_padded],
                         ids=["chunked", "hbm"])
def test_front_to_back_wrappers_need_the_row_list(fn):
    """There is one launch order, the key kernel's list: a call without it is
    an error on any device, not a sort of the rows."""
    empty = torch.zeros(0)
    with pytest.raises(TypeError, match="row_list"):
        fn(empty, empty, empty, empty, empty, TILE)


def test_fused_sort_limit_is_a_rule_on_the_table_size():
    assert K.FUSED_SORT_MAX_CLUSTERS == 2048
    text = open(os.path.join(B.CSRC_DIR, "cluster_keys.cu")).read()
    assert re.search(r"kSortMax\s*=\s*2048\b", text)
    rows = open(os.path.join(B.CSRC_DIR, "cluster_rows.cuh")).read()
    assert re.search(r"kBuckets\s*=\s*%d\b" % K.FTB_BUCKETS, rows)
    # The largest supergroup table the plans make stays inside the limit.
    assert -(-(1 << 24) // 128 // K.supergroup_size((1 << 24) // 128)) <= 2048


@pytest.mark.parametrize("mt", [False, True], ids=["compat", "mt"])
@pytest.mark.parametrize("path", ["chunked", "hbm", "single"])
def test_fused_list_route_equals_the_sorted_route(doubled_interior, path, mt):
    """Whole front-to-back intersects, exact: the key wrapper's candidates
    (compact list, row list) against keys -> _ftb_candidates -> the same
    plain intersect."""
    scene, accels = doubled_interior
    o, d = _rays(5 * TILE + 3, seed=8)
    o, d, _, tile = K._shape_and_pad(o, d, TILE, 2)
    if path == "chunked":
        acc, _ = K.build_cluster_accel_chunked(scene, width=32, n_chunks=3, mt=mt)
        cap = K.chunk_caps(acc, o, d)
        rays = K.pack_rays(o, d, mt=mt)
        keys, counts = K.cluster_keys_chunked(rays, cap, acc.caabb, tile)
        none, counts_f, cand = K.cluster_keys_chunked_ftb(rays, cap, acc.caabb, tile)
        run = lambda order, qkeys: K.cluster_intersect_ftb(
            rays, counts, order, qkeys, acc.tconst, tile, mt, chunk_cap=cap,
            row_list=cand.row_list)
    else:
        single = accels[mt]
        rays8 = K.pack_rays(o, d)
        rays = K.pack_rays(o, d, mt=True) if mt else rays8
        if path == "hbm":
            acc = K.build_hbm_accel(single, 4)
            caabb, table, fn = acc.caabb, acc.tconst, K.cluster_intersect_hbm_padded
        else:
            caabb = K._caabb(single.cmin, single.cmax)
            table, fn = single.tconst, K.cluster_intersect_ftb
        keys, counts, _ = K.cluster_keys(rays8, caabb, tile)
        none, counts_f, cand = K.cluster_keys_ftb(rays8, caabb, tile)
        run = lambda order, qkeys: fn(rays, counts, order, qkeys, table, tile,
                                      mt, row_list=cand.row_list)
    assert none is None and torch.equal(counts_f, counts)
    assert int(counts.max()) > 2 and int(counts.min()) == 0
    want = run(*K._ftb_candidates(keys))
    got = run(cand.order, cand.qkeys)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool((want[1] >= 0).any())
