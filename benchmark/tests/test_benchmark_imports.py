"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program."""

import ast
import os
import subprocess
import sys

import pytest

from benchmark import core

JAX_NAMES = {"jax", "jaxlib", "flax", "montecarlopathtracing_tpu"}


def modules():
    for dirpath, _, files in os.walk(core.BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.ImportFrom):
            yield "." * node.level + (node.module or "")


@pytest.mark.parametrize("path", sorted(modules()), ids=lambda p: os.path.relpath(p, core.BENCH))
def test_no_module_imports_jax(path):
    tops = {m.split(".")[0] for m in imported(path) if not m.startswith(".")}
    assert not tops & JAX_NAMES


def test_the_port_name_is_compared_whole():
    assert "montecarlopathtracing_torch".split(".")[0] not in JAX_NAMES


@pytest.mark.parametrize("path", sorted(
    p for p in modules() if os.sep + "reference" + os.sep in p))
def test_the_reference_imports_nothing_of_the_program(path):
    for m in imported(path):
        assert not m.startswith("montecarlopathtracing"), m
        assert m.startswith(".") or m.split(".")[0] in {
            "__future__", "dataclasses", "math", "numbers", "os", "struct",
            "typing", "zlib", "numpy", "torch"}, m


def test_a_run_leaves_no_jax_module_loaded():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from benchmark import core, readings\n"
            "from benchmark.tests import _tiny\n"
            "_tiny.run(_tiny.cell('interior-720p-grad-spp4'))\n"
            "print(core.forbidden_modules())\n") % core.ROOT
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=core.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_modules_seen_by_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert core.forbidden_modules() == ["jaxlib.xla_client"]
