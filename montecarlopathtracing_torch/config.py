"""Render configuration.

The same knobs as ``montecarlopathtracing_tpu/config.py``, field for field and
default for default, so an options object means the same render in both
packages.  The port keeps its own copy: importing the JAX package's module
would import JAX.

The kernel-shape fields (``cluster_rays``, ``cluster_width``,
``cluster_group``, ``cluster_mega``, ``chunk_size``) are accepted unchanged.
``cluster_width`` and ``cluster_order`` still decide the triangle order at
load time and with it the cluster ids; the Hopper kernels pick their own
launch shapes and treat ``cluster_group`` and ``cluster_mega`` as no-ops.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class CompatOptions:
    """Flags reproducing the reference integrator's quirks.  Defaults are the
    reference semantics (modulo RNG streams and f32 vs f64)."""

    # Quirk 1: every sample of a pixel shoots the identical primary ray
    # through the pixel's top-left lattice corner.  False => jittered AA.
    no_pixel_jitter: bool = True
    # Quirk 3: light-triangle point from three normalized uniforms (not
    # uniform over the triangle).  False => sqrt-warp uniform sampling.
    simplex_light_sampling: bool = True
    # Quirk 3: inverse-square distance clamped, dist = max(1, |xl - p|).
    clamp_light_distance: bool = True
    # The receiver cosine enters NEE twice.  False => single cosine.
    double_receiver_cosine: bool = True
    # Quirk 4: the light-pick range freezes at the first light's total area.
    # False => each light's own area.
    frozen_light_pick: bool = True
    # Quirk 5: shadow visibility by material equality of nearest hit vs the
    # sampled light face.  False => hit distance vs light distance.
    material_equality_visibility: bool = True
    # Plane solve + edge sign-product triangle test.  False => Moller-Trumbore.
    plane_sign_triangle_test: bool = True
    # Quirk 12: Morton world bounds hardcoded to [-1, 4].  False => scene AABB.
    hardcoded_morton_bounds: bool = True
    # Shading normal = interpolated vertex normals, not renormalized.
    unnormalized_shading_normal: bool = True
    # Transmission / TIR rays leave the hit point with no epsilon offset.
    no_transmission_epsilon: bool = True


@dataclasses.dataclass(frozen=True)
class RenderOptions:
    """Options for one render (hashable, immutable)."""

    spp: int = 25
    seed: int = 0
    # Russian-roulette continuation probability.
    rr_probability: float = 0.6
    # Depth cap (the reference terminates by RR only; bias < 0.6^32).
    max_depth: int = 32
    # Secondary / shadow ray origin offset.
    ray_epsilon: float = 0.01
    # Lanes in the persistent wavefront pool.
    chunk_size: int = 65536
    # Samples rendered per dispatch (progressive / checkpointed SPP).
    spp_chunk: int = 8
    # "auto" resolves to "cluster" in this package on every device: the CUDA
    # kernels on the card, their plain PyTorch versions on the CPU.
    # "brute" is the test oracle.  "bvh", "bvh_perray" and
    # "cluster_interpret" are not ported yet (see ROADMAP.md).
    intersector: str = "auto"
    packet_size: int = 1024
    leaf_width: int = 8
    # Cluster intersector shape: rays per subtile, triangles per cluster,
    # clusters per panel, subtiles per grid step.
    cluster_rays: int = 64
    cluster_width: int = 32
    cluster_group: int = 8
    cluster_mega: int = 16
    # Cluster-boundary gap padding at scene build (Morton order only).
    cluster_gap_bits: int = 19
    # Triangle ordering that defines the clusters: "morton_gap" or "median".
    cluster_order: str = "median"
    max_table_chunks: int = 64
    large_mode: str = "hbm"
    # Wavefront sort by (hit cluster, direction bin).  None = on iff the
    # resolved intersector is "cluster".
    sort_rays: Optional[bool] = None
    # Persistent lane-pool renderer; False runs the scan over samples.
    refill: bool = True
    # Phong-exponent gradients by a score-function surrogate; a forward
    # render is unchanged by it.
    ns_gradient: bool = False
    # Expected wavefront iterations per sample, which sizes the static
    # budget of a differentiable lane-pool render (None: 1.2 / (1 - p_rr)).
    bwd_seg_per_sample: Optional[float] = None
    compat: CompatOptions = dataclasses.field(default_factory=CompatOptions)

    def replace(self, **kw) -> "RenderOptions":
        return dataclasses.replace(self, **kw)


MODERN = CompatOptions(
    no_pixel_jitter=False,
    simplex_light_sampling=False,
    clamp_light_distance=False,
    double_receiver_cosine=False,
    frozen_light_pick=False,
    material_equality_visibility=False,
    plane_sign_triangle_test=False,
    hardcoded_morton_bounds=False,
    unnormalized_shading_normal=False,
    no_transmission_epsilon=False,
)
