"""Each traffic kind run end to end at a tiny size on the CPU, with the
kernels' plain versions: the result line's keys, the metrics each kind
reports, and the check's numbers."""

import json
import math

import pytest

from benchmark import core
from benchmark.tests import _tiny

def cells():
    return [(n, core.Cell(n).traffic["kind"]) for n in core.names("workloads", ".json")]


@pytest.mark.parametrize("name,kind", cells())
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_of_each_kind(name, kind, trace):
    cell = _tiny.cell(name)
    out = _tiny.run(cell, trace=trace)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    json.dumps(out, allow_nan=False)
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["checks"]) == set(cell.limits)
    assert all(math.isfinite(c["value"]) for c in out["checks"].values())
    if trace:
        assert "scene_load_s" in out["metrics"]
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(out["metrics"]) == set(cell.loop.METRICS) | {"setup_s"}
        assert all(m["value"] >= 0 for m in out["metrics"].values())
    assert out["device"]["platform"] == "cpu"


def test_the_box_is_correct_at_a_tiny_size():
    out = _tiny.run(_tiny.cell("cornell-1024-spp25", check_pixels=256))
    assert out["correct"], out["checks"]


def test_a_run_needs_the_cards_it_asks_for(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert core.main(["--workload", "cornell-1024-spp25", "--seed", "1",
                      "--seconds", "1"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "needs 1 CUDA device" in out.err


def test_an_unknown_cell_fails_without_a_result(capsys):
    assert core.main(["--workload", "nope", "--seed", "1", "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
