"""The atlas gather's backward (kernels/atlas.py, integrator/wavefront.py::
_AtlasTexels): on the CPU, the texture fetch through _AtlasTexels against
the two ops it stands for (``atlas[idx]`` and ``torch.where``), bit for
bit, and the plain version's sums and counters; on the card, the kernel
against a float64 ``index_add_`` at the interior's shapes, run to run and
under graph replay.

The file imports no JAX, so on the card its tests run alone:

    python -m pytest tests/test_torch_atlas_grad.py --noconftest -p no:cacheprovider -q
"""

import numpy as np
import pytest
import torch

from montecarlopathtracing_torch.integrator import wavefront as twf
from montecarlopathtracing_torch.kernels import atlas as A

# The interior's shapes: lanes of a lane-pool call and texels of its atlas.
LANES = 65_536
TEXELS = 327_680


def _bits(t):
    return t.contiguous().view(torch.int32)


def _case(kind: str, r: int = 4_096, n_texels: int = 640, seed: int = 0):
    """(atlas, raw texel ids, has_tex (R, 1), kd) as _gather_hit makes them:
    untextured lanes at texel 0, miss lanes' ids out of range on both sides
    (clamped by the caller), textured lanes anywhere."""
    g = np.random.default_rng(seed)
    idx = g.integers(0, n_texels, r)
    has = g.uniform(size=r) < 0.4
    if kind == "heavy_row0":
        idx[~has] = 0
        idx[: r // 8] = 0  # textured lanes at texel 0 too
    elif kind == "miss_clamp":
        miss = g.uniform(size=r) < 0.3
        idx[miss] = np.where(g.uniform(size=miss.sum()) < 0.5, -2 ** 31, 2 ** 31 - 1)
        has[miss] = False
    elif kind == "untextured":
        has[:] = False
        idx[:] = 0
    atlas = torch.as_tensor(g.uniform(0, 1, (n_texels, 3)).astype(np.float32))
    kd = torch.as_tensor(g.uniform(0, 1, (r, 3)).astype(np.float32))
    return (atlas, torch.as_tensor(idx.astype(np.int32)),
            torch.as_tensor(has[:, None]), kd)


def _through(fn, atlas, idx, has, kd, ct):
    """(output, d atlas, d kd) of fn(atlas leaf, idx, has, kd leaf)."""
    a = atlas.clone().requires_grad_()
    k = kd.clone().requires_grad_()
    out = fn(a, idx, has, k)
    ga, gk = torch.autograd.grad(out, (a, k), ct)
    return out.detach(), ga, gk


def _todays_ops(a, idx, has, k):
    return torch.where(has, a[idx.long()], k)


@pytest.mark.parametrize("kind", ["heavy_row0", "miss_clamp", "untextured",
                                  "mixed"])
def test_atlas_texels_equals_todays_ops_bit_for_bit(kind):
    atlas, raw, has, kd = _case(kind)
    idx = torch.clamp(raw, 0, atlas.shape[0] - 1)
    ct = torch.as_tensor(np.random.default_rng(1).normal(
        size=(raw.shape[0], 3)).astype(np.float32))
    got = _through(twf._AtlasTexels.apply, atlas, idx, has, kd, ct)
    want = _through(_todays_ops, atlas, idx, has, kd, ct)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(w))


def test_kd_gradient_unchanged_and_sentinel_lanes_add_nothing():
    atlas, raw, has, kd = _case("heavy_row0", seed=3)
    idx = torch.clamp(raw, 0, atlas.shape[0] - 1)
    ct = torch.as_tensor(np.random.default_rng(2).normal(
        size=(raw.shape[0], 3)).astype(np.float32))
    _, ga, gk = _through(twf._AtlasTexels.apply, atlas, idx, has, kd, ct)
    assert torch.equal(_bits(gk), _bits(torch.where(has, 0.0, ct)))
    # The lanes whose texel does not reach the output: their rows, however
    # large, move no texel.
    loud = torch.where(has, ct, 1e30)
    _, ga_loud, _ = _through(twf._AtlasTexels.apply, atlas, idx, has, kd, loud)
    assert torch.equal(_bits(ga), _bits(ga_loud))
    keys = torch.where(has[:, 0], idx, atlas.shape[0])
    assert torch.equal(_bits(A.atlas_grad(keys, loud, atlas.shape[0])), _bits(ga))


def test_plain_sums_by_key_and_counts():
    g = np.random.default_rng(5)
    n_texels = 100
    keys = torch.as_tensor(np.concatenate([
        np.full(37, 4), g.integers(0, n_texels + 1, 500), np.full(60, n_texels)
    ]).astype(np.int32))
    keys = keys[torch.as_tensor(g.permutation(keys.shape[0]))]
    ct = torch.as_tensor(g.normal(size=(keys.shape[0], 3)).astype(np.float32))
    A.reset_stats()
    got = A.atlas_grad(keys, ct, n_texels)
    live = keys < n_texels
    want = torch.zeros((n_texels, 3), dtype=torch.float64).index_add_(
        0, keys[live].long(), ct[live].double())
    assert got.shape == (n_texels, 3)
    assert torch.allclose(got.double(), want, rtol=1e-6, atol=1e-5)
    runs = torch.bincount(keys[live].long())
    st = A.stats()
    assert st == {"atlas_rows": keys.shape[0],
                  "atlas_texel_rows": int(live.sum()),
                  "atlas_longest_run": int(runs.max())}
    A.atlas_grad(keys[:10], ct[:10], n_texels)
    assert A.stats()["atlas_rows"] == keys.shape[0] + 10
    assert A.stats()["atlas_longest_run"] == int(runs.max())
    twf.reset_loop_stats()
    st = twf.grad_loop_stats()
    assert st["atlas_rows"] == st["atlas_texel_rows"] == st["atlas_longest_run"] == 0


def test_the_fetch_takes_the_kernel_only_for_an_atlas_on_the_card():
    """On the CPU, and under no_grad, the fetch is the two plain ops: its
    backward is today's, and the kernel's counters do not move."""
    atlas, raw, has, kd = _case("mixed", r=64)
    idx = torch.clamp(raw, 0, atlas.shape[0] - 1)
    a = atlas.clone().requires_grad_()
    A.reset_stats()
    out = twf._texels(a, idx, has, kd)
    assert type(out.grad_fn).__name__ == "WhereBackward0"
    with torch.no_grad():
        assert twf._texels(a, idx, has, kd).grad_fn is None
    out.sum().backward()
    assert A.stats()["atlas_rows"] == 0


@pytest.mark.parametrize("bad", ["keys_dtype", "ct_shape"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    keys = torch.zeros(8, dtype=torch.int32)
    ct = torch.zeros(8, 3)
    if bad == "keys_dtype":
        keys = keys.long()
    else:
        ct = ct[:, :2]
    with pytest.raises(TypeError):
        A.atlas_grad(keys, ct, 4)


# --------------------------------------------------------------------------
# On the card.
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU version to run "
                    "its tiles")
    return torch.device("cuda")


def _interior_keys(seed: int, dev):
    """LANES keys at the interior's scale: 40,000 lanes at one texel, the
    rest random over the texels and the sentinel, in random order."""
    g = np.random.default_rng(seed)
    keys = g.integers(0, TEXELS + 1, LANES)
    keys[:40_000] = int(g.integers(0, TEXELS))
    keys = g.permutation(keys).astype(np.int32)
    ct = g.uniform(-1, 1, (LANES, 3)).astype(np.float32)
    return torch.as_tensor(keys, device=dev), torch.as_tensor(ct, device=dev)


def _reference(keys, ct, n_texels: int):
    """(float64 sums, float64 sums of |ct|) by key, the sentinel left out."""
    live = keys < n_texels
    k = keys[live].long()
    z = torch.zeros((n_texels, 3), dtype=torch.float64, device=keys.device)
    return (z.clone().index_add_(0, k, ct[live].double()),
            z.clone().index_add_(0, k, ct[live].double().abs()))


@pytest.mark.card
def test_kernel_matches_float64_at_the_interiors_scale(cuda):
    keys, ct = _interior_keys(11, cuda)
    A.reset_stats()
    got = A.atlas_grad(keys, ct, TEXELS)
    torch.cuda.synchronize()
    want, scale = _reference(keys, ct, TEXELS)
    assert (torch.abs(got.double() - want) <= 1e-6 * scale).all()
    live = keys < TEXELS
    assert A.stats() == {
        "atlas_rows": LANES, "atlas_texel_rows": int(live.sum()),
        "atlas_longest_run": int(torch.bincount(keys[live].long()).max())}


@pytest.mark.card
def test_kernel_is_bit_identical_over_two_calls(cuda):
    keys, ct = _interior_keys(12, cuda)
    first = A.atlas_grad(keys, ct, TEXELS)
    second = A.atlas_grad(keys, ct, TEXELS)
    assert torch.equal(_bits(first), _bits(second))


@pytest.mark.card
def test_kernel_under_graph_replay_equals_eager(cuda):
    keys, ct = _interior_keys(13, cuda)
    out = torch.empty((TEXELS, 3), device=cuda)
    stats = dict.fromkeys(("eager_blocks", "graphs", "replays", "capture_s"), 0)
    blocks = twf._Blocks(lambda i0: out.copy_(A.atlas_grad(keys, ct, TEXELS)),
                         cuda, 1, stats)
    A.reset_stats()
    before = A.atlas_grad.launches
    got = []
    for i0 in range(3):
        blocks.run(i0)
        torch.cuda.synchronize()
        got.append(out.clone())
    assert stats["eager_blocks"] == stats["graphs"] == 1 and stats["replays"] == 2
    assert A.atlas_grad.launches - before == 3
    assert A.stats()["atlas_rows"] == 3 * LANES
    for g in got[1:]:
        assert torch.equal(_bits(g), _bits(got[0]))


@pytest.mark.card
def test_runs_longer_than_a_tile_and_across_tile_boundaries(cuda):
    """Sorted keys laid out so that one run fills more than two tiles (whole
    tiles inside it), one crosses a tile boundary by a few lanes, one ends
    on a tile's last position and one starts on a tile's first; integer
    rows, so every sum is exact."""
    t, n_texels = A.TILE, 50
    runs = [(0, t - 5), (5, 10), (9, 2 * t + 50), (11, t - 55),
            (12, 3), (20, 1), (n_texels, 40)]
    sorted_keys = np.concatenate([np.full(n, k) for k, n in runs]).astype(np.int32)
    g = np.random.default_rng(7)
    perm = g.permutation(sorted_keys.shape[0])
    keys = torch.as_tensor(sorted_keys[perm], device=cuda)
    ct = torch.as_tensor(g.integers(-8, 9, (keys.shape[0], 3)).astype(np.float32),
                         device=cuda)
    A.reset_stats()
    got = A.atlas_grad(keys, ct, n_texels)
    want, _ = _reference(keys, ct, n_texels)
    assert torch.equal(got.double(), want)
    assert A.stats() == {"atlas_rows": keys.shape[0],
                         "atlas_texel_rows": keys.shape[0] - 40,
                         "atlas_longest_run": 2 * t + 50}


@pytest.mark.card
def test_the_fetch_takes_the_kernel_for_an_atlas_on_the_card(cuda):
    atlas, raw, has, kd = _case("mixed")
    atlas, raw, has, kd = (x.to(cuda) for x in (atlas, raw, has, kd))
    idx = torch.clamp(raw, 0, atlas.shape[0] - 1)
    ct = torch.randn((raw.shape[0], 3), device=cuda,
                     generator=torch.Generator(cuda).manual_seed(3))
    got = _through(twf._texels, atlas, idx, has, kd, ct)
    want = _through(_todays_ops, atlas, idx, has, kd, ct)
    a = atlas.clone().requires_grad_()
    assert type(twf._texels(a, idx, has, kd).grad_fn).__name__ == "_AtlasTexelsBackward"
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    assert torch.equal(_bits(got[2]), _bits(want[2]))
    assert torch.allclose(got[1], want[1], rtol=1e-6, atol=1e-6)
