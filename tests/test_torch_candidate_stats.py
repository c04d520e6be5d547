"""Port parity: kernels.cluster.candidate_stats against the JAX package's.

Both measure the candidate clusters per ray subtile on the frame's primary
tiles and on a seeded cosine-lobe bounce wavefront sorted by (hit cluster,
6-bit direction bin); the JAX side runs its Pallas kernels in interpret
mode, the port its plain versions.  The primary count comes from the key
kernel alone and is exact.  The bounce wavefront starts at the primary
hits, and a compat-mode edge hit may differ between the packages (the
compat edge caveat of ROADMAP.md: on the interior's 64 x 48 frame at
cluster width 32, 7 of 3,072 primary hits differ, at an edge or a tie),
which moves a few bounce origins and their place in the sort: the bounce
count and the mix are held within 2% relative (1.2% apart there, equal in
the other cases).
"""

import pytest
import torch

from montecarlopathtracing_tpu.config import RenderOptions as JOpts
from montecarlopathtracing_tpu.kernels import cluster as jcl
from montecarlopathtracing_tpu.scene.builtin import load_builtin_box as jbox
from montecarlopathtracing_tpu.scene.builtin import load_builtin_large as jlarge
from montecarlopathtracing_torch.config import RenderOptions
from montecarlopathtracing_torch.kernels import cluster as tcl
from montecarlopathtracing_torch.scene.builtin import load_builtin_box as tbox
from montecarlopathtracing_torch.scene.builtin import load_builtin_large as tlarge

torch.set_num_threads(2)

BOUNCE_RTOL = 2e-2


def _scenes(name):
    if name == "box":
        kw = dict(width=32, height=32, with_specular=True, with_glass=True)
        return jbox(**kw)[0], tbox(device="cpu", **kw)[0]
    kw = dict(n_tris=2000, width=64, height=48, n_textures=1)
    return jlarge(**kw)[0], tlarge(device="cpu", **kw)[0]


@pytest.mark.parametrize("name,width", [("box", 4), ("interior", 128),
                                        ("interior", 32)])
def test_candidate_stats_matches_jax(name, width):
    """The box's 12 triangles in clusters of 4, the 2k-triangle interior in
    16 clusters of 128 and 64 of 32."""
    js, ts = _scenes(name)
    want = jcl.candidate_stats(js, JOpts(intersector="cluster",
                                         cluster_width=width))
    got = tcl.candidate_stats(ts, RenderOptions(intersector="cluster",
                                                cluster_width=width))
    assert set(got) == {"candidates_per_ray", "primary_cand", "bounce_cand"}
    assert set(got) == set(want)
    assert got["primary_cand"] == want["primary_cand"]
    assert got["primary_cand"] >= 1.0
    assert got["bounce_cand"] == pytest.approx(want["bounce_cand"], rel=BOUNCE_RTOL)
    assert got["candidates_per_ray"] == pytest.approx(
        0.3 * got["primary_cand"] + 0.7 * got["bounce_cand"], rel=1e-12)
    assert got["candidates_per_ray"] == pytest.approx(want["candidates_per_ray"],
                                                      rel=BOUNCE_RTOL)


def test_candidate_stats_is_zero_off_the_cluster_plan():
    js, ts = _scenes("box")
    assert jcl.candidate_stats(js, JOpts(intersector="bvh")) == {
        "candidates_per_ray": 0.0}
    assert tcl.candidate_stats(ts, RenderOptions(intersector="bvh")) == {
        "candidates_per_ray": 0.0}
