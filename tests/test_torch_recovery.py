"""Port parity: failure detection and recovery (tests/test_failure_recovery.py).

Recovery rests on one invariant: every chunk's samples are keyed by (pixel,
ABSOLUTE sample index), so rendering a chunk again, after a crash, a corrupt
checkpoint or a transient fault, gives exactly the same samples.  Each case
injects one failure into the port on the CPU (conftest's 32 x 32 box,
test_failure_recovery.py's options) and holds the recovered film:

* bit for bit to the port's uninterrupted film;
* to the JAX package's uninterrupted film: at least 99.5% of values within
  test_failure_recovery.py's own tolerance, rtol 1e-5 / atol 1e-6, and every
  value within the whole-render parity tolerance of tests/test_torch_render.py,
  rtol 1e-4 / atol 1e-5.  Across the two frameworks f32 shading rounds
  differently: 7 of this box's 3,072 values differ by up to 2.6e-5 relative.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from montecarlopathtracing_tpu import api as japi
from montecarlopathtracing_tpu.config import MODERN as JMODERN
from montecarlopathtracing_tpu.config import RenderOptions as JOpts
from montecarlopathtracing_tpu.integrator.wavefront import (
    render_image_host_chunked as jchunked)
from montecarlopathtracing_torch import api
from montecarlopathtracing_torch.config import MODERN, RenderOptions
from montecarlopathtracing_torch.film.film import load_checkpoint
from montecarlopathtracing_torch.integrator import wavefront as twf

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = 2
torch.set_num_threads(THREADS)

BASE = dict(spp=6, spp_chunk=2, max_depth=6, seed=5)
OPTS = RenderOptions(**BASE, compat=MODERN)
TOL = dict(rtol=1e-5, atol=1e-6)
PARITY_TOL = dict(rtol=1e-4, atol=1e-5)


def _close_to_jax(got, want):
    np.testing.assert_allclose(got, want, **PARITY_TOL)
    assert np.isclose(got, want, **TOL).mean() >= 0.995


@pytest.fixture(scope="module")
def port_box(box_scene_dir):
    return api.load_scene(box_scene_dir, "box", OPTS, use_native=False,
                          device="cpu")[0]


@pytest.fixture(scope="module")
def port_film(port_box):
    """The port's uninterrupted progressive film."""
    return api.render_progressive(port_box, OPTS, device="cpu")


@pytest.fixture(scope="module")
def jax_film(box_scene, box_bvh):
    """The JAX package's uninterrupted progressive film, as numpy."""
    film = japi.render_progressive(box_scene[0], JOpts(**BASE, compat=JMODERN),
                                   bvh=box_bvh)
    return np.asarray(film.mean)


def _check_film(film, port_film, jax_film):
    assert float(film.n_samples) == OPTS.spp
    assert torch.equal(film.radiance_sum, port_film.radiance_sum)
    _close_to_jax(film.mean.numpy(), jax_film)
    assert film.mean.mean() > 0


def test_killed_process_resume_equals_uninterrupted(box_scene_dir, port_box,
                                                    port_film, jax_film,
                                                    tmp_path):
    """A process killed (os._exit) right after its second chunk's checkpoint;
    a fresh process resumes from the checkpoint file alone."""
    ckpt = str(tmp_path / "film.npz")
    child = f"""
import os
import sys
sys.path.insert(0, {ROOT!r})
import torch
torch.set_num_threads({THREADS})
from montecarlopathtracing_torch import api
from montecarlopathtracing_torch.config import MODERN, RenderOptions

opts = RenderOptions(**{BASE!r}, compat=MODERN)
scene, _ = api.load_scene({box_scene_dir!r}, "box", opts, use_native=False,
                          device="cpu")
saves = []
orig = api.save_checkpoint
def crashing_save(path, f):
    orig(path, f)
    saves.append(1)
    if len(saves) == 2:
        os._exit(137)  # hard kill mid-render: no cleanup, no final film
api.save_checkpoint = crashing_save
api.render_progressive(scene, opts, checkpoint_path={ckpt!r}, device="cpu")
raise SystemExit("unreachable: render survived the injected crash")
"""
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True,
                          text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 137, proc.stderr[-2000:]
    assert float(load_checkpoint(ckpt, "cpu").n_samples) == 4  # two chunks
    film = api.render_progressive(port_box, OPTS, checkpoint_path=ckpt,
                                  device="cpu")
    _check_film(film, port_film, jax_film)


def test_corrupt_checkpoint_restarts_cleanly(port_box, port_film, jax_film,
                                             tmp_path):
    """A truncated checkpoint (a crash mid-save) is detected and the render
    starts over instead of failing."""
    ckpt = str(tmp_path / "film.npz")
    with open(ckpt, "wb") as f:
        f.write(b"PK\x03\x04garbage-truncated-npz")
    film = api.render_progressive(port_box, OPTS, checkpoint_path=ckpt,
                                  device="cpu")
    _check_film(film, port_film, jax_film)


def test_transient_device_fault_retried(port_box, box_scene, box_bvh,
                                        monkeypatch):
    """A dispatch that raises once is run again under retries=1 and the
    image equals a fault-free run's; with retries=0 the fault propagates."""
    clean, clean_rays = twf.render_image_host_chunked(port_box, None, OPTS,
                                                      device="cpu")
    ref, _ = jchunked(box_scene[0], box_bvh, JOpts(**BASE, compat=JMODERN))
    _close_to_jax(clean.numpy(), np.asarray(ref))

    real = twf.render_pixels_refill
    state = {"calls": 0}

    def flaky(*args, **kw):
        state["calls"] += 1
        if state["calls"] == 2:  # fail the second dispatch once
            raise RuntimeError("injected transient device fault")
        return real(*args, **kw)

    monkeypatch.setattr(twf, "render_pixels_refill", flaky)
    img, rays = twf.render_image_host_chunked(port_box, None, OPTS, retries=1,
                                              device="cpu")
    assert state["calls"] == len(twf.spp_steps(OPTS)) + 1 == 4
    assert torch.equal(img, clean) and rays == clean_rays

    state["calls"] = 0
    with pytest.raises(RuntimeError, match="injected"):
        twf.render_image_host_chunked(port_box, None, OPTS, device="cpu")
