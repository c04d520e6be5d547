"""bench_torch.py, the port's measuring entry point, on the CPU.

Each stage function runs on a 16 x 16 box (max_depth 4, one timed run, the
plain kernels) and returns its metrics, every key with a unit.  The fwd,
modern and bwd stages' ray counts are held to the JAX package's
``render_image_host_chunked`` / ``render_image_stats(differentiable=True)``
on the same scene and options (the JAX side with its Pallas kernels in
interpret mode) within 0.5%, as tests/test_torch_render.py holds whole
renders; MODERN options on both sides, since compat lattice-corner rays hit
triangle edges that the two frameworks round differently.  The failures
that must end the run: a truncated gradient chunk, a frame that disagrees
with the CPU at a checked pixel, an empty atlas in the large stage, a stage
that raises (exit 1, no metrics line), and no card without --device cpu.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from montecarlopathtracing_tpu.config import MODERN as JMODERN
from montecarlopathtracing_tpu.config import RenderOptions as JOpts
from montecarlopathtracing_tpu.integrator.wavefront import (
    render_image_host_chunked as j_host_chunked)
from montecarlopathtracing_tpu.integrator.wavefront import render_image_stats as jstats
from montecarlopathtracing_tpu.scene import builtin as jbuiltin
from montecarlopathtracing_torch.config import MODERN, RenderOptions
from montecarlopathtracing_torch.integrator.wavefront import render_image_host_chunked
from montecarlopathtracing_torch.scene import builtin as tbuiltin
from montecarlopathtracing_torch.utils.image_limit import (
    image_agreement, within_image_limit)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench_torch as bt  # noqa: E402

torch.set_num_threads(2)

BASE = dict(max_depth=4, cluster_width=4, cluster_rays=16)
BENCH = bt.Bench(device="cpu", repeats=1, seed=3, check_pixels=64)
OPTS = {
    "fwd": RenderOptions(spp=4, spp_chunk=4, **BASE),
    "stats": RenderOptions(spp=2, **BASE),
    "kernelfrac": RenderOptions(spp=4, spp_chunk=4, **BASE),
    "bwd": RenderOptions(spp=4, spp_chunk=2, bwd_seg_per_sample=2.15, **BASE),
    "modern": RenderOptions(spp=4, spp_chunk=4, compat=MODERN, **BASE),
    "large": RenderOptions(spp=2, spp_chunk=2, **BASE),
}
KEYS = {
    "fwd": ("fwd_seconds", "fwd_rays_per_s", "fwd_rays", "fwd_check_outside_share"),
    "stats": ("cand_clusters_per_ray", "primary_cand", "bounce_cand", "cluster_width"),
    "kernelfrac": (),  # device metrics only: nothing on the CPU
    "bwd": ("fwdbwd_seconds", "fwdbwd_rays_per_s", "fwdbwd_rays", "bwd_chunks",
            "bwd_launches_backward"),
    "modern": ("modern_seconds", "modern_rays_per_s", "modern_check_mean_rel_diff"),
    "large": ("large_scene_seconds", "large_scene_rays_per_s", "large_scene_texels",
              "large_check_pixels"),
}


def _box(**kw):
    return tbuiltin.load_builtin_box(width=16, height=16, device="cpu", **kw)[0]


@pytest.fixture(scope="module")
def box():
    return _box()


@pytest.mark.parametrize("stage", bt.STAGES)
def test_stage_returns_keys_with_units(box, stage):
    # The large stage needs a textured scene: the checker box.
    scene = _box(with_texture=True) if stage == "large" else box
    res = bt.STAGE_FNS[stage](scene, OPTS[stage], BENCH)
    assert set(KEYS[stage]) <= set(res), sorted(res)
    if stage == "kernelfrac":
        assert res == {}
    for key, value in res.items():
        assert bt.unit_of(key) is not None, key
        assert np.isfinite(value), (key, value)
    for key in res:
        if key + "_n" in res:
            assert res[key + "_n"] == 1 and res[key + "_min"] <= res[key] <= res[key + "_max"]
    if stage in bt.CHECKED_STAGES:
        name = "large" if stage == "large" else stage
        assert res[f"{name}_check_pixels"] == 64
        assert res[f"{name}_check_outside_share"] == 0.0  # CPU against CPU
    assert not set(bt.DEVICE_ONLY) & set(res)


def _jax_pair(opts: RenderOptions):
    """The JAX package's box and options matching the port's ``opts``."""
    kw = {f.name: getattr(opts, f.name) for f in dataclasses.fields(opts)
          if f.name != "compat"}
    jopts = JOpts(**{**kw, "intersector": "cluster_interpret"},
                  **({"compat": JMODERN} if opts.compat == MODERN else {}))
    return jbuiltin.load_builtin_box(width=16, height=16)[0], jopts


@pytest.mark.parametrize("stage", ["fwd", "modern", "bwd"])
def test_ray_counts_match_jax(box, stage):
    """MODERN options on every stage (see the module docstring).  The bwd
    stage renders one gradient chunk at sample offset 1, which the JAX side
    renders in one call: its jitted differentiable render fails on the CPU
    when called again with other sample offsets under the same options."""
    opts = OPTS[stage].replace(compat=MODERN)
    if stage == "bwd":
        opts = opts.replace(spp_chunk=opts.spp)
    js, jopts = _jax_pair(opts)
    if stage == "bwd":
        res = bt.stage_bwd(box, opts, BENCH)
        assert res["bwd_chunks"] == 1
        got = res["fwdbwd_rays"]
        want = float(jstats(js, None, jopts, differentiable=True, sample_offset=1)[1])
    else:
        got = bt.STAGE_FNS[stage](box, opts, BENCH)[f"{stage}_rays"]
        want = float(j_host_chunked(js, None, jopts)[1])
    assert want > 0
    assert abs(got - want) <= 0.005 * want, (got, want)


def test_bwd_raises_when_the_budget_truncates(box):
    opts = OPTS["bwd"].replace(spp=8, spp_chunk=8, bwd_seg_per_sample=0.05)
    with pytest.raises(bt.CheckFailed, match="truncated"):
        bt.stage_bwd(box, opts, BENCH)


def test_pixel_check_fails_on_one_perturbed_pixel(box):
    opts = OPTS["fwd"]
    img, _ = render_image_host_chunked(box, None, opts, device="cpu")
    res = bt.pixel_check(img, box, opts, BENCH, "fwd")
    assert res["fwd_check_outside_share"] == 0.0
    ids = bt.check_ids(16, 16, BENCH.check_pixels, BENCH.seed)
    assert len(ids) == 64 and len(set(ids.tolist())) == 64
    bad = img.clone().reshape(-1, 3)
    bad[int(ids[17]), 1] *= 1.01
    with pytest.raises(bt.CheckFailed, match="disagrees"):
        bt.pixel_check(bad.reshape(img.shape), box, opts, BENCH, "fwd")
    # A pixel that is not checked does not count.
    other = int(np.setdiff1d(np.arange(256), ids)[0])
    fine = img.clone().reshape(-1, 3)
    fine[other] += 1.0
    bt.pixel_check(fine.reshape(img.shape), box, opts, BENCH, "fwd")


def test_image_limit_scales_with_the_reference():
    """utils/image_limit.py, which bench_torch.py and chip_smoke.py share:
    the tolerance is atol 1e-5 + rtol 1e-4 of the reference's value; 1
    pixel in 200 may be outside it, 2 may not; the means must agree within
    1e-4 relative even where every pixel is inside."""
    ref = np.full((20, 10, 3), 0.5, np.float32)
    one = ref.copy()
    one[3, 4, 0] += 1e-4  # the tolerance at 0.5 is 6e-5
    res = image_agreement(one, ref)
    assert res["pixels"] == 200 and res["outside_share"] == 0.005
    assert res["max_abs_diff"] == pytest.approx(1e-4, rel=1e-3)
    assert within_image_limit(res)
    two = one.copy()
    two[7, 1, 2] -= 1e-4
    assert not within_image_limit(image_agreement(two, ref))
    big = np.full((1, 3), 10.0, np.float32)  # the tolerance at 10 is 1.01e-3
    assert image_agreement(big + 1e-4, big)["outside_share"] == 0.0
    assert image_agreement(big + 2e-3, big)["outside_share"] == 1.0
    shifted = ref + 5.5e-5  # every pixel inside, the mean 1.1e-4 off
    res = image_agreement(shifted, ref)
    assert res["outside_share"] == 0.0
    assert res["mean_rel_diff"] == pytest.approx(1.1e-4, rel=1e-2)
    assert not within_image_limit(res)
    assert image_agreement(torch.as_tensor(two), torch.as_tensor(ref)) == \
        image_agreement(two, ref)


def test_large_stage_refuses_an_untextured_scene(box):
    with pytest.raises(bt.CheckFailed, match="atlas is empty"):
        bt.stage_large(box, OPTS["large"], BENCH)


def test_failed_stage_exits_nonzero_without_metrics(monkeypatch, capsys):
    def broken(scene, opts, bench):
        raise bt.CheckFailed("fwd: forced failure")

    monkeypatch.setitem(bt.STAGE_FNS, "fwd", broken)
    rc = bt.main(["--device", "cpu", "--size", "16", "--stages", "fwd",
                  "--repeats", "1"])
    out, err = capsys.readouterr()
    assert rc == 1
    assert out.strip() == ""
    assert "fwd failed" in err and "forced failure" in err


def test_cli_on_the_cpu_prints_one_metrics_line():
    res = subprocess.run(
        [sys.executable, "bench_torch.py", "--device", "cpu", "--size", "32",
         "--spp", "2", "--spp-chunk", "2", "--stages", "fwd,stats,kernelfrac,bwd",
         "--repeats", "1", "--seed", "7"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["correct"] is True and line["device"] == "cpu" and line["seed"] == 7
    assert line["value"] == line["fwdbwd_rays_per_s"] > 0
    assert line["bwd_over_fwd"] > 0 and line["width"] == line["height"] == 32
    assert set(line["not_measured"]) == set(bt.DEVICE_ONLY)
    assert not set(bt.DEVICE_ONLY) & set(line)
    assert all(line["units"][k] for k in line["units"])


@pytest.mark.parametrize("argv", [
    ["bench_torch.py", "--stages", "fwd", "--size", "16"],
    ["bench_scaling_torch.py", "--repeats", "1"],
], ids=["bench", "scaling"])
def test_cli_refuses_without_cuda(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run([sys.executable, *argv], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "CUDA is not available" in res.stderr


def test_scaling_two_gloo_ranks_on_the_cpu():
    """bench_scaling_torch.py: one and two gloo ranks at 64 x 64, the
    two-rank image within the tile axis's tolerance of the one-rank image."""
    res = subprocess.run(
        [sys.executable, "bench_scaling_torch.py", "--device", "cpu",
         "--repeats", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [json.loads(ln) for ln in res.stdout.strip().splitlines()]
    assert [ln["ranks"] for ln in lines[:-1]] == [1, 2]
    summary = lines[-1]
    assert summary["device"] == "cpu" and summary["backend"] == "gloo"
    assert summary["width"] == summary["height"] == 64
    assert [r["ranks"] for r in summary["results"]] == [1, 2]
    assert summary["results"][0]["efficiency"] == 1.0
    for r in summary["results"]:
        assert r["seconds"] > 0 and r["seconds_n"] == 1
        assert r["max_abs_diff_vs_1"] <= 1e-5
