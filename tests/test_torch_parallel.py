"""Rendering and training over a (tile, spp) grid of processes
(parallel/mesh.py, diff/gradients.py::make_distributed_train_step).

Two real processes on the CPU, joined by torch.distributed with gloo, each
with its own time limit: the sharded render on a 2 x 1 and a 1 x 2 grid
against the one-process render, and one distributed training step against
train_step on the whole 32 x 32 frame (per * tiles == n, so no pixel is
padded), at tests/test_parallel.py's tolerances:

* tile axis: rtol 1e-5 / atol 1e-6 (each pixel renders identically);
* spp axis: rtol 1e-4 / atol 1e-5 (the same samples, summed in another
  order);
* the step: loss rtol 1e-4, kd rtol 1e-3 / atol 1e-6.

The same ranks' outputs are also held to the JAX package's
render_image_sharded_jit and make_distributed_train_step on a 2 x 1 and a
1 x 2 mesh of host devices, with the same box, options and zero target, so a
convention both port sides might share (the spp rank's sample offset, the
mean over the grid) is checked against the reference.  Across the two
frameworks no pixel renders bit for bit alike (f32 shading rounds
differently), so the images are compared as tests/test_torch_render.py
compares whole renders: MODERN at rtol 1e-4 / atol 1e-5 on every value
(test_parallel.py's spp-axis tolerance) and the mean within 1e-4 relative;
compat, whose lattice-corner rays hit triangle edges exactly, per channel
mean within 1% and at least 95% of pixels within that tolerance.  The step
is held at test_parallel.py's tolerances.

Plus the world of one process (no process group), where the grid is 1 x 1.

Run as a script, this file is the worker:
``python tests/test_torch_parallel.py RANK WORLD PORT TILE SPP OUT.npz``.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RENDER = dict(spp=8, max_depth=4, chunk_size=256)
TRAIN = dict(spp=4, max_depth=3, chunk_size=256)
LR = 0.05
SIZE = 32
GRIDS = [(2, 1), (1, 2)]


def _scene():
    from montecarlopathtracing_torch.scene.builtin import load_builtin_box

    return load_builtin_box(width=SIZE, height=SIZE, device="cpu")[0]


def _worker(rank: int, world: int, port: int, tile: int, spp: int, out: str):
    """One rank: the sharded render (compat and MODERN) and one distributed
    step."""
    sys.path.insert(0, ROOT)
    torch.set_num_threads(1)
    from montecarlopathtracing_torch.config import MODERN, RenderOptions
    from montecarlopathtracing_torch.diff.gradients import (
        SceneParams, make_distributed_train_step)
    from montecarlopathtracing_torch.parallel.mesh import (
        _padded_ids, initialize_multihost, make_mesh, render_image_sharded)

    initialize_multihost(f"localhost:{port}", world, rank, backend="gloo")
    mesh = make_mesh(tile=tile, spp=spp)
    scene = _scene()
    img = render_image_sharded(scene, None, RenderOptions(**RENDER), mesh,
                               device="cpu")
    img_modern = render_image_sharded(
        scene, None, RenderOptions(**RENDER, compat=MODERN), mesh, device="cpu")
    n = SIZE * SIZE
    ids, per = _padded_ids(n, mesh.tile)
    target = torch.zeros((n, 3))[torch.as_tensor(ids.reshape(-1)).long()]
    step = make_distributed_train_step(scene, None, RenderOptions(**TRAIN), mesh,
                                       lr=LR, device="cpu")
    params, loss = step(SceneParams.from_scene(scene),
                        target.reshape(mesh.tile, per, 3), ids)
    np.savez(out, img=img.numpy(), img_modern=img_modern.numpy(), loss=float(loss), kd=params.kd.numpy(),
             light_radiance=params.light_radiance.numpy(), per=per)
    torch.distributed.destroy_process_group()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def grids(tmp_path_factory):
    """(tile, spp) -> the two ranks' outputs, each process under its own
    time limit."""
    d = tmp_path_factory.mktemp("torch_parallel")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = {}
    for tile, spp in GRIDS:
        port = _free_port()
        paths = [str(d / f"g{tile}x{spp}_r{r}.npz") for r in range(2)]
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(r), "2", str(port),
             str(tile), str(spp), paths[r]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=ROOT) for r in range(2)]
        logs = []
        for p in procs:
            try:
                log, _ = p.communicate(timeout=180)
            except subprocess.TimeoutExpired:
                p.kill()
                log, _ = p.communicate()
            logs.append((p.returncode, log))
        for r, (rc, log) in enumerate(logs):
            assert rc == 0, f"rank {r} of grid {tile}x{spp} failed:\n{log[-4000:]}"
        out[(tile, spp)] = [dict(np.load(p)) for p in paths]
    return out


@pytest.fixture(scope="module")
def single():
    """The one-process render and train_step on the whole frame."""
    torch.set_num_threads(2)
    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.diff.gradients import SceneParams, train_step
    from montecarlopathtracing_torch.integrator.wavefront import render_image

    scene = _scene()
    img = render_image(scene, None, RenderOptions(**RENDER), device="cpu")
    params, loss = train_step(SceneParams.from_scene(scene), scene, None,
                              RenderOptions(**TRAIN), torch.zeros((SIZE, SIZE, 3)),
                              lr=LR, device="cpu")
    return img.numpy(), float(loss), params


@pytest.fixture(scope="module")
def jax_grids():
    """(tile, spp) -> the JAX package's sharded renders (compat, MODERN) and
    distributed step on a mesh of two host devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from montecarlopathtracing_tpu.accel.lbvh import build_lbvh
    from montecarlopathtracing_tpu.config import MODERN as JMODERN
    from montecarlopathtracing_tpu.config import RenderOptions as JOpts
    from montecarlopathtracing_tpu.diff.gradients import (
        SceneParams as JParams, make_distributed_train_step as jstep)
    from montecarlopathtracing_tpu.parallel.mesh import (
        _padded_ids as jpad, make_mesh as jmesh, render_image_sharded_jit)
    from montecarlopathtracing_tpu.scene.builtin import load_builtin_box as jbox

    scene, _ = jbox(width=SIZE, height=SIZE)
    bvh = jax.jit(build_lbvh)(scene)
    n = SIZE * SIZE
    out = {}
    for tile, spp in GRIDS:
        mesh = jmesh(tile=tile, spp=spp, devices=jax.devices()[:2])
        img = render_image_sharded_jit(scene, bvh, JOpts(**RENDER), mesh)
        img_modern = render_image_sharded_jit(
            scene, bvh, JOpts(**RENDER, compat=JMODERN), mesh)
        ids, per = jpad(n, tile)
        target = jnp.zeros((n, 3))[np.minimum(np.arange(tile * per), n - 1)]
        sharding = NamedSharding(mesh, P("tile", None))
        step = jstep(scene, bvh, JOpts(**TRAIN), mesh, lr=LR)
        params, loss = step(JParams.from_scene(scene),
                            jax.device_put(target.reshape(tile, per, 3), sharding),
                            jax.device_put(ids, sharding))
        out[(tile, spp)] = dict(
            img=np.asarray(img), img_modern=np.asarray(img_modern),
            loss=float(loss), kd=np.asarray(params.kd),
            light_radiance=np.asarray(params.light_radiance))
    return out


@pytest.mark.parametrize("grid", GRIDS, ids=["tile2x1", "spp1x2"])
def test_sharded_render_matches_single(grids, single, grid):
    tol = dict(rtol=1e-5, atol=1e-6) if grid[1] == 1 else dict(rtol=1e-4, atol=1e-5)
    ranks = grids[grid]
    np.testing.assert_array_equal(ranks[0]["img"], ranks[1]["img"])  # replicated
    np.testing.assert_allclose(ranks[0]["img"], single[0], **tol)
    assert single[0].mean() > 0


@pytest.mark.parametrize("grid", GRIDS, ids=["tile2x1", "spp1x2"])
def test_distributed_step_matches_train_step(grids, single, grid):
    _, loss, params = single
    ranks = grids[grid]
    assert int(ranks[0]["per"]) * grid[0] == SIZE * SIZE
    for r in ranks:  # every rank holds the same update
        assert np.isclose(float(r["loss"]), loss, rtol=1e-4)
        np.testing.assert_allclose(r["kd"], params.kd.numpy(), rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(r["light_radiance"], params.light_radiance.numpy(),
                                   rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(ranks[0]["kd"], ranks[1]["kd"])
    assert np.abs(ranks[0]["kd"] - _scene().kd.numpy()).max() > 0


@pytest.mark.parametrize("grid", GRIDS, ids=["tile2x1", "spp1x2"])
def test_sharded_render_matches_jax(grids, jax_grids, grid):
    ref = jax_grids[grid]
    for r in grids[grid]:
        got = r["img_modern"]
        np.testing.assert_allclose(got, ref["img_modern"], rtol=1e-4, atol=1e-5)
        assert abs(got.mean() / ref["img_modern"].mean() - 1) < 1e-4
        got, want = r["img"], ref["img"]
        np.testing.assert_allclose(got.mean(axis=(0, 1)), want.mean(axis=(0, 1)),
                                   rtol=1e-2)
        close = np.isclose(got, want, rtol=1e-4, atol=1e-5).all(axis=-1)
        assert close.mean() >= 0.95, close.mean()


@pytest.mark.parametrize("grid", GRIDS, ids=["tile2x1", "spp1x2"])
def test_distributed_step_matches_jax(grids, jax_grids, grid):
    ref = jax_grids[grid]
    for r in grids[grid]:
        assert np.isclose(float(r["loss"]), ref["loss"], rtol=1e-4)
        np.testing.assert_allclose(r["kd"], ref["kd"], rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(r["light_radiance"], ref["light_radiance"],
                                   rtol=1e-3, atol=1e-6)


def test_world_of_one(single):
    """Without a process group the world is one rank: the grid is 1 x 1 and
    the sharded render and step are the one-process ones."""
    from montecarlopathtracing_torch.config import RenderOptions
    from montecarlopathtracing_torch.diff.gradients import (
        SceneParams, make_distributed_train_step)
    from montecarlopathtracing_torch.parallel.mesh import (
        _padded_ids, make_mesh, render_image_sharded)

    assert not torch.distributed.is_initialized()
    mesh = make_mesh()
    assert mesh.shape == {"tile": 1, "spp": 1} and mesh.rank == 0
    with pytest.raises(ValueError, match="mesh 2x1 != 1 ranks"):
        make_mesh(tile=2)
    scene = _scene()
    img = render_image_sharded(scene, None, RenderOptions(**RENDER), mesh,
                               device="cpu")
    np.testing.assert_array_equal(img.numpy(), single[0])
    ids, per = _padded_ids(SIZE * SIZE, 1)
    step = make_distributed_train_step(scene, None, RenderOptions(**TRAIN), mesh,
                                       lr=LR, device="cpu")
    params, loss = step(SceneParams.from_scene(scene), torch.zeros((1, per, 3)), ids)
    assert np.isclose(float(loss), single[1], rtol=1e-4)
    np.testing.assert_allclose(params.kd.numpy(), single[2].kd.numpy(),
                               rtol=1e-3, atol=1e-6)


def test_padded_ids_match_jax():
    from montecarlopathtracing_tpu.parallel.mesh import _padded_ids as jpad
    from montecarlopathtracing_torch.parallel.mesh import _padded_ids

    for n, t in ((1024, 4), (1000, 3), (7, 2), (5, 8)):
        a, pa = jpad(n, t)
        b, pb = _padded_ids(n, t)
        assert pa == pb and np.array_equal(a, b)


if __name__ == "__main__":
    _worker(*(int(a) for a in sys.argv[1:6]), sys.argv[6])
