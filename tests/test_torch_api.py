"""Port: API, CLI, PNG I/O, device policy, kernel build, import hygiene.

Runs without a card: every entry point is called with device="cpu", a
missing card makes the default device raise, and the CUDA kernel build
raises a clear error without nvcc instead of falling back.
"""

import ast
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from montecarlopathtracing_torch import api, cli, read_png, write_png
from montecarlopathtracing_torch.config import RenderOptions
from montecarlopathtracing_torch.integrator import wavefront as twf
from montecarlopathtracing_torch.kernels import build as kbuild
from montecarlopathtracing_torch.kernels import cluster as kcl
from montecarlopathtracing_torch.scene.builtin import load_builtin_box, write_box_scene

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "montecarlopathtracing_torch")
FORBIDDEN = ("jax", "jaxlib", "montecarlopathtracing_tpu")


@pytest.fixture(scope="module")
def box_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_api"))
    write_box_scene(d, "box", width=16, height=16)
    return d


def test_cli_renders_png(box_dir, tmp_path, capsys):
    out = str(tmp_path / "out")
    rc = cli.main(["render", box_dir, "box", "--spp", "2", "--max-depth", "4",
                   "--out-dir", out, "--device", "cpu"])
    assert rc == 0
    path = capsys.readouterr().out.strip().splitlines()[-1]
    assert path == os.path.join(out, "box-SPP2.png")
    img = read_png(path)
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8 and img.max() > 0


def test_cli_progressive_checkpoint(box_dir, tmp_path, capsys):
    ck = str(tmp_path / "film.npz")
    args = ["render", box_dir, "box", "--max-depth", "4", "--spp-chunk", "1",
            "--checkpoint", ck, "--out-dir", str(tmp_path), "--device", "cpu",
            "--modern"]
    assert cli.main(args + ["--spp", "1"]) == 0
    assert float(np.load(ck)["n_samples"]) == 1
    assert cli.main(args + ["--spp", "2"]) == 0
    assert float(np.load(ck)["n_samples"]) == 2
    assert read_png(capsys.readouterr().out.strip().splitlines()[-1]).shape == (16, 16, 3)


def test_cli_missing_scene_and_unported_flags(tmp_path, box_dir):
    assert cli.main(["render", str(tmp_path), "nope", "--device", "cpu"]) == 2
    with pytest.raises(NotImplementedError, match="A14"):
        cli.main(["render", box_dir, "box", "--device", "cpu", "--mesh-tile", "2"])
    with pytest.raises(NotImplementedError, match="A16"):
        cli.main(["render", box_dir, "box", "--device", "cpu", "--profile", "x"])


def test_render_scene_phase_stats(box_dir, tmp_path):
    stats = {}
    img, path = api.render_scene(box_dir, "box", spp=2,
                                 options=RenderOptions(max_depth=4),
                                 out_dir=str(tmp_path), device="cpu", stats=stats)
    assert img.shape == (16, 16, 3) and os.path.exists(path)
    assert stats["rays"] > 16 * 16 * 2 and stats["phase2_s"] > 0


def test_png_round_trip_and_pil_filters(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (7, 11, 3), dtype=np.uint8)
    p = write_png(str(tmp_path / "a.png"), torch.as_tensor(img))
    np.testing.assert_array_equal(read_png(p), img)
    PIL = pytest.importorskip("PIL.Image")
    # A smooth image makes PIL pick the Sub/Up/Average/Paeth filters.
    yy, xx = np.mgrid[0:32, 0:40]
    smooth = np.stack([xx * 6, yy * 7, (xx + yy) * 3], -1).astype(np.uint8)
    PIL.fromarray(smooth).save(str(tmp_path / "b.png"))
    np.testing.assert_array_equal(read_png(str(tmp_path / "b.png")), smooth)
    PIL.fromarray(smooth).convert("RGBA").save(str(tmp_path / "c.png"))
    np.testing.assert_array_equal(read_png(str(tmp_path / "c.png")), smooth)
    ours = write_png(str(tmp_path / "d.png"), smooth)
    np.testing.assert_array_equal(np.asarray(PIL.open(ours).convert("RGB")), smooth)


def test_default_device_raises_without_cuda(box_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    scene, _ = load_builtin_box(width=16, height=16, device="cpu")
    opts = RenderOptions(spp=1, max_depth=2)
    calls = [
        lambda: load_builtin_box(width=16, height=16),
        lambda: api.load_scene(box_dir, "box"),
        lambda: api.render(scene, opts),
        lambda: api.render_scene(box_dir, "box", spp=1, write=False),
        lambda: api.render_progressive(scene, opts),
        lambda: twf.render_image_host_chunked(scene, None, opts),
        lambda: twf.render_image_stats(scene, None, opts),
        lambda: cli.main(["render", box_dir, "box", "--spp", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.delenv("NVCC", raising=False)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kbuild, "BUILD_DIR", str(tmp_path / "build"))
    kbuild.load.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kbuild.build()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kbuild.load("cluster_keys")


def test_wrappers_never_fall_back_off_cpu():
    """A tensor that is not on the CPU never reaches the plain version: the
    wrapper launches the kernel or raises (here: not a CUDA tensor)."""
    rays = torch.zeros((64, 8), device="meta")
    caabb = torch.zeros((8, 4), device="meta")
    before = (kcl.cluster_keys.launches, kcl.cluster_intersect_padded.launches)
    with pytest.raises(ValueError, match="CUDA"):
        kcl.cluster_keys(rays, caabb, 64)
    with pytest.raises(ValueError, match="CUDA"):
        kcl.cluster_intersect_padded(
            rays, torch.zeros((1,), dtype=torch.int32, device="meta"),
            torch.zeros((1, 4), dtype=torch.int32, device="meta"),
            torch.zeros((4, 16, 8), device="meta"), 64)
    assert (kcl.cluster_keys.launches, kcl.cluster_intersect_padded.launches) == before
    # CPU calls run the plain versions and do not count as launches.
    kcl.cluster_keys(torch.zeros((64, 8)), torch.zeros((8, 4)), 64)
    assert kcl.cluster_keys.launches == before[0]
    tree = ast.parse(open(os.path.join(PKG, "kernels", "cluster.py")).read())
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), \
        "no try/except around a kernel build or launch"


def _port_sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")
    yield os.path.join(ROOT, "profile_torch.py")


def test_import_hygiene_ast():
    for path in _port_sources():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{path} imports {n}"


def test_import_hygiene_subprocess():
    mods = []
    for path in _port_sources():
        if os.path.dirname(path) == ROOT:
            mods.append(os.path.basename(path)[:-3])
            continue
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        mods.append(rel[:-len(".__init__")] if rel.endswith(".__init__") else rel)
    code = ("import importlib, sys\n"
            f"for m in {sorted(mods)!r}:\n"
            "    importlib.import_module(m)\n"
            f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
            "assert not bad, bad\nprint(len(sys.modules))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, text=True,
                         capture_output=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, text=True, capture_output=True, timeout=120)
    assert res.returncode != 0 and res.stdout == ""
    # Alone in a directory, without the package, it fails as well.
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(tmp_path),
                         text=True, capture_output=True, timeout=120)
    assert res.returncode != 0 and '"ok": true' not in res.stdout
