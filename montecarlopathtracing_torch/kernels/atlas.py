"""The texture atlas gather's backward: a deterministic segmented sum.

``atlas_grad(keys, ct, n_texels)`` sums the cotangent rows ``ct`` of the
lanes by texel: row k of the (n_texels, 3) result is the sum of the rows
whose key is k, and a key of ``n_texels`` (the sentinel: a lane whose texel
does not reach its output, since it hit no texture) adds nothing.  On a
CUDA tensor the wrapper sorts (key, lane) with ``torch.sort`` (stable) and
launches ``csrc/atlas_grad.cu``, which sums each run of one key in a fixed
tree, one writer per texel and no float atomics: the same bits from run to
run and under graph replay.  On the CPU it runs the plain version,
``atlas_grad_plain``: PyTorch's ``index_add_``, which adds each texel's
rows there serially in lane order, as the autograd of ``atlas[idx]``
(``index_put_`` with accumulate) does below its parallel sizes.

Both count into per-device int64 counters (``stats()``: the lanes summed,
those with a texel, and the longest run of one texel), kept on the device
and read only when ``stats()`` is called; ``reset_stats()`` zeroes them.
The wrapper counts its launches in a ``launches`` attribute.
"""

from __future__ import annotations

import torch

from .cluster import _ptr, _stream

# Sorted positions a block of the kernel sums (kTile of csrc/atlas_grad.cu).
TILE = 512

# device -> int64 (3,): lanes summed, lanes with a texel, the longest run.
_STATS = {}


def _stats_buffer(dev) -> torch.Tensor:
    """The counters of ``dev``, made at their device's first call (which
    must not be inside a CUDA graph capture: a graph's pool would own them)."""
    key = str(dev)
    if key not in _STATS:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("atlas_grad: the first call on a device must "
                               "run outside a CUDA graph capture")
        _STATS[key] = torch.zeros(3, dtype=torch.int64, device=dev)
    return _STATS[key]


def stats() -> dict:
    """Totals since the last reset over every device: ``atlas_rows``, the
    lanes summed; ``atlas_texel_rows``, those whose key was a texel (not
    the sentinel); ``atlas_longest_run``, the most lanes one texel took in
    one call.  Reads the device counters (a synchronisation)."""
    rows = [buf.tolist() for buf in _STATS.values()]
    return {"atlas_rows": sum(r[0] for r in rows),
            "atlas_texel_rows": sum(r[1] for r in rows),
            "atlas_longest_run": max((r[2] for r in rows), default=0)}


def reset_stats() -> None:
    for buf in _STATS.values():
        buf.zero_()


def _check(keys, ct, n_texels: int) -> None:
    if keys.dtype != torch.int32 or keys.dim() != 1:
        raise TypeError("atlas_grad: keys must be (lanes,) int32")
    if ct.dtype != torch.float32 or ct.shape != (keys.shape[0], 3):
        raise TypeError("atlas_grad: ct must be (lanes, 3) float32")
    if keys.device != ct.device:
        raise ValueError(f"atlas_grad: inputs span {keys.device} and {ct.device}")
    if not 0 <= n_texels < 2 ** 31 - 1:
        raise ValueError("atlas_grad: n_texels must fit an int32 key")


def atlas_grad_plain(keys, ct, n_texels: int):
    """Plain PyTorch version of atlas_grad: ``index_add_`` into n_texels + 1
    rows, the last the sentinel's, dropped."""
    _check(keys, ct, n_texels)
    out = ct.new_zeros((n_texels + 1, 3))
    out.index_add_(0, keys.long(), ct)
    runs = torch.bincount(keys.long(), minlength=n_texels + 1)
    runs[n_texels] = 0
    buf = _stats_buffer(keys.device)
    buf[0] += keys.shape[0]
    buf[1] += (keys < n_texels).sum()
    buf[2] = torch.maximum(buf[2], runs.max())
    return out[:n_texels]


def atlas_grad(keys, ct, n_texels: int):
    """(n_texels, 3) f32: per texel k, the sum of the rows of ``ct`` ((lanes,
    3) f32) whose ``keys`` ((lanes,) int32, each in [0, n_texels]) are k;
    key n_texels adds nothing.  See atlas_grad_plain for the CPU."""
    if keys.device.type == "cpu":
        return atlas_grad_plain(keys, ct, n_texels)
    from .build import load

    _check(keys, ct, n_texels)
    dev = keys.device
    ct = ct.contiguous()
    n = keys.shape[0]
    tiles = -(-n // TILE)
    sorted_keys, order = torch.sort(keys, stable=True)
    out = torch.zeros((n_texels, 3), dtype=torch.float32, device=dev)
    parts = torch.empty((tiles, 2, 3), dtype=torch.float32, device=dev)
    flags = torch.empty((tiles,), dtype=torch.int32, device=dev)
    counters = _stats_buffer(dev)
    fn = load("atlas_grad")
    with torch.cuda.device(dev):
        err = fn(_ptr(sorted_keys), _ptr(order), _ptr(ct), n, n_texels,
                 _ptr(out), _ptr(parts), _ptr(flags), tiles, _ptr(counters),
                 _stream(dev))
    if err != 0:
        raise RuntimeError(f"atlas_grad launch failed: CUDA error {err}")
    atlas_grad.launches += 1
    return out


atlas_grad.launches = 0

_WRAPPERS = {"atlas_grad": atlas_grad}
