"""Counter-based RNG keyed (pixel, sample, bounce, purpose).

Frozen copy of ``montecarlopathtracing_torch/integrator/rng.py`` at commit
8674dbe (the upstream renderer's streams are its own; the reference has to
draw the same uniforms to follow each path).  Every 32-bit word is carried
in an int64 and masked after each operation.

Per-bounce uniform slots: 0 russian roulette, 1 fresnel lobe choice,
2 diffuse/specular ratio, 3 phi, 4 theta, 5 + 4 * li + {0, 1, 2, 3}:
light li's (cdf pick, r1, r2, r3).
"""

from __future__ import annotations

import numbers

import torch

N_BASE_SLOTS = 5

_MASK = 0xFFFFFFFF
_GOLD = 0x9E3779B9
_GOLD2 = 0x85EBCA6B
_PRIMARY_STREAM = 0x7FFFFFFF


def _u32(x):
    if isinstance(x, numbers.Integral):
        return int(x) & _MASK
    return torch.as_tensor(x).to(torch.int64) & _MASK


def _mulc(x, c: int):
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def _mix(x):
    x = _mulc(x ^ (x >> 16), 0x7FEB352D)
    x = _mulc(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _to_unit(bits):
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def n_bounce_slots(num_lights: int) -> int:
    return N_BASE_SLOTS + 4 * num_lights


def lane_keys(seed: int, pixel_ids, sample_idx):
    """(R, 2) int64 stream keys; ``sample_idx`` an int or an (R,) tensor."""
    pix = _u32(pixel_ids)
    samp = _u32(sample_idx)
    if isinstance(samp, torch.Tensor):
        samp = samp.to(pix.device)
    k = _mix((_u32(seed) + _GOLD) & _MASK)
    k1 = _mix((_mix(k ^ pix) + _mulc((samp + 1) & _MASK, _GOLD2)) & _MASK)
    k2 = _mix(_mix((k + _mulc((pix + 1) & _MASK, _GOLD2)) & _MASK)
              ^ ((_mulc(samp, _GOLD) + 0x6A09E667) & _MASK))
    k1, k2 = torch.broadcast_tensors(k1, k2)
    return torch.stack([k1, k2], dim=-1)


def _stream(keys, stream_id):
    sid = _u32(stream_id)
    if isinstance(sid, torch.Tensor):
        sid = sid.to(keys.device)
    b = _mix(keys[..., 0] ^ _mulc((sid + 1) & _MASK, _GOLD))
    return _mix((b + keys[..., 1]) & _MASK)


def _slot_uniforms(b, n_slots: int):
    slots = _mulc(torch.arange(1, n_slots + 1, dtype=torch.int64,
                               device=b.device), _GOLD2)
    return _to_unit(_mix((b[:, None] + slots[None, :]) & _MASK))


def bounce_uniforms(keys, depth, n_slots: int):
    """(R, n_slots) float32 uniforms in [0, 1) for bounce ``depth``."""
    return _slot_uniforms(_stream(keys, depth), n_slots)


def primary_uniforms(keys):
    """(R, 2) sub-pixel jitter uniforms (jittered primaries only)."""
    return _slot_uniforms(_stream(keys, _PRIMARY_STREAM), 2)
