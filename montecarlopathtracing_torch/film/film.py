"""Film: accumulation state, tone map, PNG I/O, checkpoints.

Counterpart of ``montecarlopathtracing_tpu/film/film.py``.  The tone map is
the reference's ``clamp(c*255, 0, 255)`` per channel with no gamma (quirk
#11); output names are ``<scene>-SPP<k>.png``.  PNGs are written and read by
a small encoder on ``zlib`` and ``struct`` (the reference vendored svpng for
the same job), so no imaging library is needed.

The accumulation state is (radiance_sum, n_samples): progressive SPP,
checkpoint/resume and merging are all the same addition.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import Any

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Film:
    """Progressive accumulation state; radiance_sum is a SUM over samples so
    two Films merge by addition."""

    radiance_sum: Any  # (H,W,3) f32 tensor
    n_samples: Any  # () f32 tensor

    @staticmethod
    def zeros(height: int, width: int, device="cpu") -> "Film":
        return Film(torch.zeros((height, width, 3), dtype=torch.float32,
                                device=device),
                    torch.zeros((), dtype=torch.float32, device=device))

    def add(self, radiance_mean, n: float) -> "Film":
        """Fold in a render that averaged ``n`` samples."""
        return Film(self.radiance_sum + radiance_mean * n, self.n_samples + n)

    def merge(self, other: "Film") -> "Film":
        return Film(self.radiance_sum + other.radiance_sum,
                    self.n_samples + other.n_samples)

    @property
    def mean(self):
        return self.radiance_sum / torch.clamp(self.n_samples, min=1.0)

    def to(self, device) -> "Film":
        return Film(self.radiance_sum.to(device), self.n_samples.to(device))


def tonemap(radiance, gamma: bool = False):
    """Radiance -> uint8 tensor. Compat default: clamp(c*255), no gamma."""
    c = torch.as_tensor(radiance)
    if gamma:
        c = torch.pow(torch.clamp(c, 0.0, 1.0), 1.0 / 2.2)
    return torch.clamp(c * 255.0, 0.0, 255.0).to(torch.uint8)


def _to_numpy_u8(rgb_u8) -> np.ndarray:
    if isinstance(rgb_u8, torch.Tensor):
        rgb_u8 = rgb_u8.detach().cpu().numpy()
    arr = np.asarray(rgb_u8)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8, got {arr.shape} {arr.dtype}")
    return arr


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def write_png(path: str, rgb_u8) -> str:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG (filter 0 rows)."""
    arr = _to_numpy_u8(rgb_u8)
    h, w, _ = arr.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)],
                         axis=1).tobytes()
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(raw, 6))
           + _chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(png)
    return path


def _unfilter(ftype: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    out = line.astype(np.int32)
    prev = prev.astype(np.int32)
    if ftype == 0:
        return out
    if ftype == 2:
        return (out + prev) & 0xFF
    for i in range(out.shape[0]):  # Sub, Average, Paeth depend on the left
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        if ftype == 1:
            pred = a
        elif ftype == 3:
            pred = (a + b) // 2
        elif ftype == 4:
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[i] = (out[i] + pred) & 0xFF
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB or RGBA non-interlaced PNG as (H, W, 3) uint8."""
    with open(path, "rb") as fh:
        data = fh.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    w, h, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(f"{path}: only 8-bit RGB/RGBA non-interlaced PNGs")
    bpp = 3 if ctype == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    raw = raw.reshape(h, 1 + w * bpp)
    rows, prev = [], np.zeros(w * bpp, np.uint8)
    for y in range(h):
        prev = _unfilter(int(raw[y, 0]), raw[y, 1:], prev, bpp).astype(np.uint8)
        rows.append(prev)
    return np.stack(rows).reshape(h, w, bpp)[..., :3]


def output_name(out_dir: str, scene_name: str, spp: int) -> str:
    """`<scene>-SPP<k>.png` (imshow, MTPC/MTPC.cpp:20)."""
    return os.path.join(out_dir, f"{scene_name}-SPP{spp}.png")


def save_checkpoint(path: str, film: Film) -> None:
    np.savez(path, radiance_sum=film.radiance_sum.detach().cpu().numpy(),
             n_samples=film.n_samples.detach().cpu().numpy())


def load_checkpoint(path: str, device="cpu") -> Film:
    z = np.load(path)
    return Film(torch.as_tensor(z["radiance_sum"], device=device),
                torch.as_tensor(z["n_samples"], device=device))
