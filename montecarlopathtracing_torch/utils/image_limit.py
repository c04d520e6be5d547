"""The image limit a frame rendered on the card is held to against a
reference render of the same pixels (PERF.md section 2).

At most 0.5% of the pixels may have a channel outside rtol 1e-4 / atol 1e-5
of the reference (the relative part scales with the reference's value), and
the image means must agree within 1e-4 relative.
"""

from __future__ import annotations

import numpy as np
import torch

RTOL, ATOL = 1e-4, 1e-5
MAX_OUTSIDE_SHARE = 0.005
MAX_MEAN_REL = 1e-4


def _pixels(x) -> np.ndarray:
    return torch.as_tensor(x).detach().cpu().numpy().reshape(-1, 3)


def image_agreement(got, ref) -> dict:
    """``got`` against ``ref`` (tensors or arrays of one shape, RGB last):
    the pixel count, the share of pixels with a channel outside the
    tolerance, the relative difference of the means (overall, and the
    largest over the channels) and the largest absolute difference."""
    got, ref = _pixels(got), _pixels(ref)
    outside = (np.abs(got - ref) > ATOL + RTOL * np.abs(ref)).any(axis=1)
    gm, rm = got.mean(axis=0, dtype=np.float64), ref.mean(axis=0, dtype=np.float64)
    return {
        "pixels": int(ref.shape[0]),
        "outside_share": float(outside.mean()),
        "mean_rel_diff": float(abs(gm.mean() - rm.mean()) / max(abs(rm.mean()), 1e-30)),
        "channel_mean_rel_diff":
            float((np.abs(gm - rm) / np.maximum(np.abs(rm), 1e-30)).max()),
        "max_abs_diff": float(np.abs(got - ref).max()),
    }


def within_image_limit(agreement: dict) -> bool:
    """Whether an ``image_agreement`` result is inside the image limit."""
    return (agreement["outside_share"] <= MAX_OUTSIDE_SHARE
            and agreement["mean_rel_diff"] <= MAX_MEAN_REL)
