"""Counter-based RNG keyed (pixel, sample, bounce, purpose), bitwise equal to
``montecarlopathtracing_tpu/integrator/rng.py``.

The stream is a lowbias32 avalanche hash over 32-bit words.  PyTorch has no
usable uint32 arithmetic on the CPU (no ``>>`` for uint32, and ``>>`` on
int32 is arithmetic), so every word is carried as an int64 holding a value
in [0, 2^32) and masked after each operation.  Products never rely on int64
wrap-around: a 32-bit constant is split into 16-bit halves so that every
partial product stays below 2^48.

Per-bounce uniform slot layout:

    0: russian roulette
    1: fresnel lobe choice
    2: diffuse/specular ratio
    3: phi
    4: theta
    5 + 4*li + {0,1,2,3}: light li's (cdf pick, r1, r2, r3)
"""

from __future__ import annotations

import torch

N_BASE_SLOTS = 5

_MASK = 0xFFFFFFFF
_GOLD = 0x9E3779B9   # 2^32 / phi, Weyl increment
_GOLD2 = 0x85EBCA6B  # murmur3 c1
_PRIMARY_STREAM = 0x7FFFFFFF


def _u32(x):
    """An int64 tensor of 32-bit words from any integer tensor or int."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=torch.int64)
    return x.to(torch.int64) & _MASK


def _mulc(x, c: int):
    """(x * c) mod 2^32 for a word tensor x and a constant c < 2^32."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK


def _mix(x):
    """lowbias32 avalanche finalizer."""
    x = _mulc(x ^ (x >> 16), 0x7FEB352D)
    x = _mulc(x ^ (x >> 15), 0x846CA68B)
    return x ^ (x >> 16)


def _to_unit(bits):
    """32-bit words -> f32 in [0, 1) from the top 24 bits."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def n_bounce_slots(num_lights: int) -> int:
    return N_BASE_SLOTS + 4 * num_lights


def lane_keys(seed: int, pixel_ids, sample_idx):
    """One 64-bit stream key per lane as two words, (R, 2) int64.  pixel_ids
    (R,) integer; sample_idx an int or (R,) integer tensor."""
    pix = _u32(pixel_ids)
    samp = _u32(sample_idx).to(pix.device)
    k = _mix((_u32(seed).to(pix.device) + _GOLD) & _MASK)
    k1 = _mix((_mix(k ^ pix) + _mulc((samp + 1) & _MASK, _GOLD2)) & _MASK)
    k2 = _mix(_mix((k + _mulc((pix + 1) & _MASK, _GOLD2)) & _MASK)
              ^ ((_mulc(samp, _GOLD) + 0x6A09E667) & _MASK))
    k1, k2 = torch.broadcast_tensors(k1, k2)
    return torch.stack([k1, k2], dim=-1)


def _stream(keys, stream_id):
    b = _mix(keys[..., 0] ^ _mulc((_u32(stream_id).to(keys.device) + 1) & _MASK,
                                  _GOLD))
    return _mix((b + keys[..., 1]) & _MASK)


def _slot_uniforms(b, n_slots: int):
    slots = _mulc(torch.arange(1, n_slots + 1, dtype=torch.int64,
                               device=b.device), _GOLD2)
    return _to_unit(_mix((b[:, None] + slots[None, :]) & _MASK))


def bounce_uniforms(keys, depth, n_slots: int):
    """(R, n_slots) uniforms in [0,1) for bounce ``depth`` (int or (R,))."""
    return _slot_uniforms(_stream(keys, depth), n_slots)


def primary_uniforms(keys):
    """(R, 2) sub-pixel jitter uniforms (modern mode only)."""
    return _slot_uniforms(_stream(keys, _PRIMARY_STREAM), 2)
