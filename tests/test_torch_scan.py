"""Port parity: the scan-over-samples renderer (``refill=False``).

``render_pixels`` with ``refill=False`` runs ``trace_paths``, the bounce loop
at full width, once per sample.  It is held to the JAX package's
``render_pixels(refill=False)`` (Pallas kernels in interpret mode) on
identical scenes built by each package's loader, and, inside the port, to
the lane-pool renderer, which computes the same estimator on the same RNG
streams.

Tolerances.  Against the JAX package, as in tests/test_torch_render.py: at
most 0.5% of pixels outside rtol 1e-4 / atol 1e-5 (a path whose f32
arithmetic rounds differently in the two frameworks can diverge at a
triangle edge), image mean within 1e-4 relative, rays traced within 0.5%.
Inside the port, as tests/test_refill.py holds the JAX package: identical
ray counts and every value within rtol 1e-4 / atol 1e-5.  MODERN mode
throughout (compat primaries hit triangle edges exactly).
"""

import os

import numpy as np
import pytest
import torch

from montecarlopathtracing_tpu.config import MODERN as JMODERN
from montecarlopathtracing_tpu.config import RenderOptions as JOpts
from montecarlopathtracing_tpu.integrator import wavefront as jwf
from montecarlopathtracing_tpu.scene.builtin import box_scene_text
from montecarlopathtracing_tpu.scene.loader import build_scene as jbuild
from montecarlopathtracing_torch.config import MODERN, RenderOptions
from montecarlopathtracing_torch.integrator import wavefront as twf
from montecarlopathtracing_torch.scene.loader import build_scene as tbuild

torch.set_num_threads(2)

BASE = dict(spp=4, max_depth=8, cluster_width=4, cluster_rays=16, sort_rays=True)


def _write(d, name, obj, mtl, cam):
    for ext, text in ((".obj", obj), (".mtl", mtl), (".camera", cam)):
        with open(os.path.join(d, name + ext), "w") as fh:
            fh.write(text)


def _two_light_box():
    """The built-in box with a second, dimmer area light of its own material
    on the left wall."""
    obj, mtl, cam = box_scene_text(with_specular=True, width=16, height=16)
    n_v = obj.count("\nv ") + obj.startswith("v ")
    mtl += "newmtl Light2\nKd 0 0 0\nKs 0 0 0\nNs 1\nNi 1\n"
    obj += ("v 0.02 0.6 0.6\nv 0.02 0.6 1.1\nv 0.02 1.1 1.1\nv 0.02 1.1 0.6\n"
            f"usemtl Light2\nf {n_v + 1} {n_v + 2} {n_v + 3}\n"
            f"f {n_v + 1} {n_v + 3} {n_v + 4}\n")
    cam += "mtlname Light2 8 6 4\n"
    return obj, mtl, cam


SCENES = {
    "one_light": lambda: box_scene_text(width=16, height=16),
    "two_lights": _two_light_box,
    "spec_glass": lambda: box_scene_text(with_specular=True, with_glass=True,
                                         width=16, height=16),
}
NAMES = list(SCENES)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """name -> (JAX scene, port scene), each built by its own loader."""
    d = str(tmp_path_factory.mktemp("torch_scan"))
    out = {}
    jopts = JOpts(intersector="cluster_interpret", compat=JMODERN, **BASE)
    topts = RenderOptions(compat=MODERN, **BASE)
    for name, make in SCENES.items():
        _write(d, name, *make())
        out[name] = (jbuild(d, name, jopts)[0],
                     tbuild(d, name, topts, device="cpu")[0])
    return out


def _opts(**kw):
    return RenderOptions(compat=MODERN, **{**BASE, **kw})


def _ids(n):
    return torch.arange(n, dtype=torch.int32)


def _outside(a, b):
    return np.abs(a - b) > 1e-5 + 1e-4 * np.abs(a)


def _close_to_jax(ji, jr, ti, tr):
    assert np.isfinite(ti).all() and ti.mean() > 0
    frac = _outside(ji, ti).any(axis=-1).mean()
    assert frac <= 0.005, f"{frac:.2%} of pixels outside rtol 1e-4 / atol 1e-5"
    assert abs(ti.mean() - ji.mean()) <= 1e-4 * abs(ji.mean())
    assert abs(int(tr) - float(jr)) <= 0.005 * float(jr)


@pytest.mark.parametrize("name", NAMES)
def test_scan_matches_jax(scenes, name):
    js, ts = scenes[name]
    jopts = JOpts(intersector="cluster_interpret", compat=JMODERN, refill=False,
                  **BASE)
    ji, jr = jwf.render_pixels(js, None, jopts, np.arange(256, dtype=np.int32))
    ti, tr = twf.render_pixels(ts, None, _opts(refill=False), _ids(256))
    assert ti.shape == (256, 3)
    _close_to_jax(np.asarray(ji), jr, ti.numpy(), tr)


@pytest.mark.parametrize("name", NAMES)
def test_refill_matches_scan(scenes, name):
    _, ts = scenes[name]
    scan, n_scan = twf.render_pixels(ts, None, _opts(refill=False), _ids(256))
    refill, n_refill = twf.render_pixels(ts, None, _opts(), _ids(256))
    assert int(n_scan) == int(n_refill)  # identical paths traced
    np.testing.assert_allclose(scan.numpy(), refill.numpy(), rtol=1e-4, atol=1e-5)


def test_refill_matches_scan_sample_offset(scenes):
    """The spp-sharding contract: samples [3, 5) are the same sample set
    under both renderers."""
    _, ts = scenes["spec_glass"]
    opts = _opts(spp=2, max_depth=6)
    scan, n_scan = twf.render_pixels(ts, None, opts.replace(refill=False),
                                     _ids(256), sample_offset=3)
    refill, n_refill = twf.render_pixels(ts, None, opts, _ids(256),
                                         sample_offset=3)
    assert int(n_scan) == int(n_refill)
    np.testing.assert_allclose(scan.numpy(), refill.numpy(), rtol=1e-4, atol=1e-5)
    full, _ = twf.render_pixels(ts, None, opts.replace(refill=False), _ids(256))
    assert not torch.equal(full, scan)  # the offset selects other samples


def test_refill_matches_scan_ragged_spp(scenes):
    _, ts = scenes["spec_glass"]
    opts = _opts(spp=3, max_depth=4)
    scan, n_scan = twf.render_pixels(ts, None, opts.replace(refill=False),
                                     _ids(200))
    refill, n_refill = twf.render_pixels(ts, None, opts, _ids(200))
    assert int(n_scan) == int(n_refill)
    np.testing.assert_allclose(scan.numpy(), refill.numpy(), rtol=1e-4, atol=1e-5)


def test_scan_sorted_matches_unsorted(scenes):
    """The wavefront sort in trace_paths permutes lanes only: the same paths
    and, up to rounding, the same radiance."""
    _, ts = scenes["two_lights"]
    a, na = twf.render_pixels(ts, None, _opts(refill=False), _ids(256))
    b, nb = twf.render_pixels(ts, None, _opts(refill=False, sort_rays=False),
                              _ids(256))
    assert int(na) == int(nb)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


def test_trace_paths_differentiable_forward_is_unchanged(scenes):
    """differentiable=True runs exactly max_depth bounces; the bounces after
    every lane has died add nothing, so radiance and rays are bitwise those
    of the early-exit loop."""
    from montecarlopathtracing_torch.integrator import rng
    from montecarlopathtracing_torch.integrator.camera import primary_rays

    _, ts = scenes["spec_glass"]
    opts = _opts(refill=False)
    ids = _ids(256)
    keys = rng.lane_keys(opts.seed, ids, 0)
    o, d = primary_rays(ts.camera, ids, rng.primary_uniforms(keys))
    a, na = twf.trace_paths(ts, None, opts, keys, o, d)
    b, nb = twf.trace_paths(ts, None, opts, keys, o, d, differentiable=True)
    assert torch.equal(a, b) and int(na) == int(nb)


@pytest.mark.parametrize("chunk", [100, 1024], ids=["padded_chunks", "one_chunk"])
def test_image_stats_scan_matches_jax(scenes, chunk):
    """refill=False on a whole frame: pixel chunks of chunk_size lanes, the
    last one padded with the last id (chunk 100: 256 ids -> 3 chunks, 44
    pads; chunk 1024: one chunk of 256 ids and 768 pads)."""
    js, ts = scenes["one_light"]
    base = {**BASE, "spp": 2, "chunk_size": chunk, "refill": False}
    ji, jr = jwf.render_image_stats(
        js, None, JOpts(intersector="cluster_interpret", compat=JMODERN, **base))
    ti, tr = twf.render_image_stats(ts, None, _opts(**base), device="cpu")
    assert ti.shape == (16, 16, 3)
    _close_to_jax(np.asarray(ji), jr, ti.numpy(), tr)
    refill, r_refill = twf.render_image_stats(
        ts, None, _opts(**{**base, "refill": True}), device="cpu")
    np.testing.assert_allclose(ti.numpy(), refill.numpy(), rtol=1e-4, atol=1e-5)


def test_host_chunked_scan_matches_one_shot(scenes):
    """render_image_host_chunked with refill=False: pixel chunks (the last
    padded) rendered in spp slices add up to the one-shot scan render."""
    _, ts = scenes["spec_glass"]
    opts = _opts(refill=False, spp=3, chunk_size=100, spp_chunk=2)
    one, r1 = twf.render_image_stats(ts, None, opts, device="cpu")
    seen = []
    chunked, r2 = twf.render_image_host_chunked(
        ts, None, opts, device="cpu", progress=lambda i, n: seen.append((i, n)))
    assert seen == [(1, 3), (2, 3), (3, 3)]
    assert int(r1) == int(r2)
    np.testing.assert_allclose(one.numpy(), chunked.numpy(), rtol=1e-5, atol=1e-6)
