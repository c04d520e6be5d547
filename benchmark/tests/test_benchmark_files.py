"""The benchmark's files are found by name, and its names and units keep
to the characters the contract allows."""

import json
import os

import pytest

from benchmark import core

ROOT = core.ROOT


def bench_json():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


@pytest.mark.parametrize("name", core.names("workloads", ".json"))
def test_every_cell_resolves_by_name(name):
    cell = core.Cell(name)
    assert cell.workload["name"] == name
    assert cell.chips in (1, 4)
    assert 1 <= len(cell.workload["why"]) <= 200
    assert hasattr(cell.loop, "run") and hasattr(cell.generator, "write")
    assert cell.limits and all(v > 0 for v in cell.limits.values())
    assert "spp" in cell.options


@pytest.mark.parametrize("name", core.names("metrics", ".py"))
def test_every_reader_has_a_unit_and_reads_nothing_from_an_empty_trace(name):
    mod = core.load_module("metrics", name)
    core.check_name(name)
    core.check_unit(mod.UNIT)
    assert mod.read({}) is None


@pytest.mark.parametrize("good", ["setup_s", "graph_capture_ms.fwd", "a-b_c.d",
                                  "_x", "9lives"])
def test_names_allowed(good):
    assert core.check_name(good) == good


@pytest.mark.parametrize("bad", ["", "a b", "a,b", "a/b", ".x", "-x", "x" * 65,
                                 "µs"])
def test_names_refused(bad):
    with pytest.raises(core.HarnessError):
        core.check_name(bad)


@pytest.mark.parametrize("unit,ok", [("samples/s", True), ("%", True),
                                     ("GB", True), ("kernels", True),
                                     ("tokens per second", False), ("µs", False),
                                     ("", False), ("x" * 17, False)])
def test_units(unit, ok):
    if ok:
        assert core.check_unit(unit) == unit
    else:
        with pytest.raises(core.HarnessError):
            core.check_unit(unit)


def test_missing_cell_is_refused():
    with pytest.raises(core.HarnessError):
        core.Cell("no-such-cell")


def test_benchmark_json_names_files_that_exist():
    b = bench_json()
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    readers = core.metric_readers()
    for cfg in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, cfg["file"]))
        with open(os.path.join(ROOT, cfg["file"])) as fh:
            text = json.load(fh)
        assert text["source"] == cfg["source"]
        # Every key changed from the source is listed, with its reason in
        # the file, and names a key the file has.
        assert list(text["reduced"]) == cfg["reduced"]
        assert all(k in text and text["reduced"][k] for k in cfg["reduced"])
    for w in b["workloads"]:
        cell = core.Cell(w["name"])
        assert (cell.workload["config"], cell.workload["traffic"],
                cell.chips, cell.workload["why"]) == (
                    w["config"], w["traffic"], w["chips"], w["why"])
    for w in b["workloads"]:
        reported = set(core.Cell(w["name"]).loop.METRICS) | {"setup_s"}
        listed = {m["name"] for m in b["end_to_end"]
                  if w["name"] in m.get("workloads", [w["name"]])}
        assert reported == listed, w["name"]
    for m in b["per_layer"]:
        assert m["name"] in readers
        assert readers[m["name"]].UNIT == m["unit"]
    for m in b["end_to_end"] + b["per_layer"]:
        core.check_name(m["name"])
        core.check_unit(m["unit"])
    assert sum(w["chips"] == 4 for w in b["workloads"]) <= 1


def test_a_new_cell_and_a_new_reader_are_found_by_name():
    """Adding a cell (with its mix) and a per-layer metric is adding files:
    the harness finds them by name, no file it has is edited."""
    bench = core.BENCH
    files = {
        os.path.join(bench, "traffic", "zz-test-mix.json"): json.dumps(
            {"kind": "frames", "render_options": {"spp": 1}, "check_frames": 1,
             "check_pixels": 8, "trace_frames": 1}),
        os.path.join(bench, "workloads", "zz-test-cell.json"): json.dumps(
            {"name": "zz-test-cell", "config": "cornell-box-1024",
             "traffic": "zz-test-mix", "chips": 1, "why": "a test's cell",
             "limits": {"pixel_gap_median": 1.0, "pixel_bad_share": 1.0}}),
        os.path.join(bench, "metrics", "zz_test_metric.py"):
            "UNIT = 'kernels'\n\ndef read(trace):\n"
            "    return trace.get('zz')\n",
    }
    try:
        for path, text in files.items():
            with open(path, "w") as fh:
                fh.write(text)
        cell = core.Cell("zz-test-cell")
        assert cell.options["spp"] == 1 and cell.traffic["kind"] == "frames"
        assert core.per_layer({"zz": 3})["zz_test_metric"] == {
            "value": 3.0, "unit": "kernels"}
        assert "zz_test_metric" not in core.per_layer({})
    finally:
        for path in files:
            os.remove(path)


def test_a_new_traffic_loop_is_a_new_file():
    """A loop kind of its own is found by its mix's ``kind``; the run, the
    readings and the tests take its metrics and its check from it."""
    bench = core.BENCH
    files = {
        os.path.join(bench, "loops", "zz_test_loop.py"):
            "METRICS = ('zz_per_s',)\n\n"
            "def numbers(cell, opts, prog, ref, ctl, who, seed, dev):\n"
            "    return {'zz_gap': float(seed)}\n",
        os.path.join(bench, "traffic", "zz-test-loop-mix.json"): json.dumps(
            {"kind": "zz_test_loop", "render_options": {"spp": 1}}),
        os.path.join(bench, "workloads", "zz-test-loop-cell.json"): json.dumps(
            {"name": "zz-test-loop-cell", "config": "cornell-box-1024",
             "traffic": "zz-test-loop-mix", "chips": 1, "why": "a test's cell",
             "limits": {"zz_gap": 1.0}}),
    }
    try:
        for path, text in files.items():
            with open(path, "w") as fh:
                fh.write(text)
        cell = core.Cell("zz-test-loop-cell")
        assert cell.loop.METRICS == ("zz_per_s",)
        assert cell.loop.numbers(cell, None, None, None, None, "control", 3,
                                 None) == {"zz_gap": 3.0}
    finally:
        for path in files:
            os.remove(path)
