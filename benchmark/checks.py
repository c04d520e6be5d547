"""The comparison that decides ``correct``: the program's outputs against
the plain reference's, number by number, each against a limit of its own.

Frames: the kept pixels of chosen frames, the reference rendering the same
pixels with the same RNG streams in float64.  Two numbers: the median over
the lit pixels (the reference's radiance not zero) of ``pixel_gap`` (the
largest channel's absolute gap over the reference's largest channel), and
the share of all the pixels whose gap passes ``BAD_PIXEL_GAP``.  A path
whose float32 and float64 versions part ways (a hit on a shared edge, a
light face picked across a CDF step) moves one pixel far, so the median and
the share, not the largest gap, are held.

Gradient steps: the same two numbers over the supervised pixels of the
step's image, and the worst field's gap between the gradients,
``|g - g_ref|`` over the larger of the field's reference norm and the
median field's.  The loss's gap is not compared apart: it swings with the
few pixels whose paths part, and a wrong loss shows in the gradient.

``frame_numbers`` and ``step_numbers`` return {name: value}; ``judge``
pairs them with the cell's limits.  A number that is not finite fails.

The control (``control_scene``), which has to fail the check: the
reference itself with every float of the scene held in bfloat16 and its
arithmetic in float32 (the step below the configuration's float32 that
would tempt a later change: the scene's tables in bfloat16), compared with
the float64 reference as the program is.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .reference import tracer

# A pixel whose gap passes this is counted as parted from the reference.
BAD_PIXEL_GAP = 1e-3
# Floor of the per-pixel denominator: black pixels compare in absolute terms.
PIXEL_FLOOR = 1e-6
GRAD_FIELDS = ("kd", "ks", "ns", "light_radiance", "atlas")
CONTROL_STORAGE = torch.bfloat16
CONTROL_MATH = torch.float32


def control_scene(ref):
    return ref.rounded(CONTROL_STORAGE).to(dtype=CONTROL_MATH)


def pixel_gap(prog, ref):
    """(P,) largest channel's |prog - ref| over (largest |ref| + floor); a
    pixel that is not finite reads inf."""
    prog = prog.to(torch.float64)
    ref = ref.to(torch.float64)
    gap = (prog - ref).abs().amax(-1) / (ref.abs().amax(-1) + PIXEL_FLOOR)
    return torch.where(torch.isfinite(prog).all(-1), gap,
                       torch.full_like(gap, math.inf))


def pixel_numbers(gaps, lit) -> Dict[str, float]:
    """The median gap over the pixels the reference sees lit (over all of
    them when none is), and the share of all pixels parted."""
    gaps = torch.cat([g.reshape(-1).cpu() for g in gaps])
    lit = torch.cat([m.reshape(-1).cpu() for m in lit])
    return {"pixel_gap_median": float((gaps[lit] if lit.any() else gaps).median()),
            "pixel_bad_share": float((gaps > BAD_PIXEL_GAP).double().mean())}


def is_lit(ref):
    return ref.abs().amax(-1) > 0


def field_gaps(prog: dict, ref: dict) -> Dict[str, float]:
    """Each field's |g - g_ref| over max(|g_ref|, median field |g_ref|).
    The median is over the fields the reference moves (its norm not 0):
    a field the scene leaves at zero (``ns`` without its gradient, ``ks``
    with no specular material, the atlas where no compared path reaches a
    lit texel) would otherwise pull it to 0, and a field's rounding against
    that to infinity."""
    norms = {f: float(torch.linalg.vector_norm(ref[f].double())) for f in GRAD_FIELDS}
    moved = sorted(v for v in norms.values() if v > 0)
    med = moved[len(moved) // 2] if moved else 0.0
    out = {}
    for f in GRAD_FIELDS:
        diff = float(torch.linalg.vector_norm(prog[f].double().cpu()
                                              - ref[f].double().cpu()))
        denom = max(norms[f], med)
        out[f] = diff / denom if denom > 0 else (0.0 if diff == 0 else math.inf)
    return out


def field_gap(prog: dict, ref: dict) -> float:
    """The worst field's gap (``field_gaps``)."""
    return max(field_gaps(prog, ref).values())


def frame_numbers(ref_scene, opts: dict, items: List[dict],
                  counts: Optional[dict] = None) -> Dict[str, float]:
    """items: {"seed", "pixels" (P,), "spp", "values" (P, 3) the program's};
    ``counts`` receives the reference's ray queries."""
    refs = [tracer.render(ref_scene, opts, it["seed"],
                          it["pixels"].to(ref_scene.v0.device), it["spp"],
                          counts=counts).cpu() for it in items]
    return pixel_numbers([pixel_gap(it["values"].cpu(), r)
                          for it, r in zip(items, refs)], [is_lit(r) for r in refs])


def reference_step(ref_scene, opts: dict, item: dict, dtype=torch.float64):
    """(pixels (P, 3), loss, {field: gradient}) of one step's supervised
    loss, differentiated through the reference's own render: the squares
    at the supervised pixels summed over the whole frame's
    ``frame_pixels`` x 3 values, the mean the program takes over a frame
    whose other pixels match their target."""
    dev = ref_scene.v0.device
    leaves = {f: getattr(ref_scene, f).detach().clone().to(dtype).requires_grad_(True)
              for f in ("kd", "ks", "light_radiance", "atlas")}
    pred = tracer.render(ref_scene, opts, item["seed"], item["pixels"].to(dev),
                         item["spp"], params=leaves)
    loss = torch.sum((pred - item["target"].to(dev, pred.dtype)) ** 2) / (
        3 * item["frame_pixels"])
    names = [f for f in leaves if leaves[f].numel()]
    grads = torch.autograd.grad(loss, [leaves[f] for f in names], allow_unused=True)
    out = {f: torch.zeros_like(leaves[f]).detach() for f in leaves}
    out.update({f: (torch.zeros_like(leaves[f]) if g is None else g).detach()
                for f, g in zip(names, grads)})
    out["ns"] = torch.zeros_like(ref_scene.ns)
    return pred.detach().cpu(), float(loss.detach()), {f: v.cpu() for f, v in out.items()}


def step_numbers(ref_scene, opts: dict, items: List[dict],
                 detail: Optional[dict] = None) -> Dict[str, float]:
    """items: {"seed", "pixels", "spp", "frame_pixels", "target" (P, 3),
    "values" (P, 3), "loss", "grads" {field: tensor}} of the program's
    steps.  ``detail``
    (a dict) receives each field's gap and norms, for a look at them."""
    gaps, lit, grad_gap = [], [], 0.0
    for it in items:
        pred, loss, grads = reference_step(ref_scene, opts, it)
        gaps.append(pixel_gap(it["values"].cpu(), pred))
        lit.append(is_lit(pred))
        if detail is not None:
            detail["loss_gap"] = max(detail.get("loss_gap", 0.0),
                                     abs(float(it["loss"]) - loss) / abs(loss))
        grad_gap = max(grad_gap, field_gap(it["grads"], grads))
        if detail is not None:
            for f, v in field_gaps(it["grads"], grads).items():
                detail[f"gap.{f}"] = max(detail.get(f"gap.{f}", 0.0), v)
                detail[f"norm.{f}"] = float(torch.linalg.vector_norm(grads[f].double()))
    out = pixel_numbers(gaps, lit)
    out["grad_gap"] = grad_gap
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every number at or under its
    limit and finite; a number without a limit, or a limit without a
    number, fails."""
    rows, ok = [], True
    for name in sorted(set(numbers) | set(limits)):
        value = numbers.get(name, math.nan)
        limit = limits.get(name, math.nan)
        passed = math.isfinite(value) and value <= limit
        ok &= passed
        rows.append((name, value, limit))
    return ok, rows
