"""The program's tracer (utils/timing.py) and the spans and counters it
records inside the frame driver, the lane pool, the gradient and the scene
load, on the CPU.

On the CPU every block runs op by op, so a frame's dispatches hold one
``eager_block`` span a block and no ``capture`` or ``replay``; the card's
capture and replay spans are held here through a stand-in for the CUDA
graphs (as tests/test_torch_graph_blocks.py does), against the
``capture_s`` counter they share their clock readings with.  There the
lane pool is kept from one dispatch to the next, so only a pool's first
dispatch runs a block op by op and captures.
"""

import json
import os

import pytest
import torch

from montecarlopathtracing_torch import api
from montecarlopathtracing_torch.config import RenderOptions
from montecarlopathtracing_torch.diff import gradients as G
from montecarlopathtracing_torch.integrator import wavefront as twf
from montecarlopathtracing_torch.scene.builtin import write_box_scene
from montecarlopathtracing_torch.utils import timing

torch.set_num_threads(2)

# spp 4 in dispatches of 2; 64 lanes over 256 pixels, blocks of 8
# iterations: a few blocks a dispatch.
OPTS = RenderOptions(spp=4, spp_chunk=2, max_depth=4, chunk_size=64,
                     cluster_width=4, cluster_rays=16, seed=11)
WORK = {"pool_setup", "eager_block", "capture", "replay", "drain_read",
        "release", "sync", "assemble"}


@pytest.fixture(scope="module")
def box_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("tracing"))
    write_box_scene(d, "box", width=16, height=16)
    return d


@pytest.fixture(scope="module")
def scene(box_dir):
    return api.load_scene(box_dir, "box", OPTS, device="cpu")[0]


def _frame(scene, opts=OPTS):
    return twf.render_image_host_chunked(scene, None, opts, device="cpu")


def _by_id(spans):
    return {s["id"]: s for s in spans}


def _children(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


@pytest.mark.parametrize("graphs", [False, True], ids=["op_by_op", "graphs"])
def test_frame_spans_nest_under_frame_and_dispatch(scene, request, graphs):
    if graphs:
        request.getfixturevalue("fake_graphs")
    twf.reset_loop_stats()
    with timing.tracing() as tr:
        _frame(scene)
    spans = tr.spans
    stats = twf.loop_stats()
    (frame,) = [s for s in spans if s["name"] == "frame"]
    assert frame["parent"] is None and frame["counts"] == {"spp": 4}
    assert {s["request"] for s in spans} == {OPTS.seed}
    dispatches = [s for s in spans if s["name"] == "dispatch"]
    assert [d["parent"] for d in dispatches] == [frame["id"]] * 2
    assert [d["counts"] for d in dispatches] == [{"spp": 2, "attempt": 0}] * 2
    assert {s["name"] for s in _children(spans, frame)} == {"dispatch",
                                                           "assemble"}
    for k, d in enumerate(dispatches):
        kids = _children(spans, d)
        # With graphs the first dispatch makes the pool: its first block
        # runs op by op, and the flush phase of the blocks after it (one:
        # blocks of 8 iterations, a flush every 4) is captured once; the
        # second dispatch replays every block on the kept pool.
        names = ({"pool_setup", "replay", "drain_read", "release", "sync"}
                 | ({"eager_block", "capture"} if k == 0 else set())
                 if graphs else
                 {"pool_setup", "eager_block", "drain_read", "release", "sync"})
        assert {s["name"] for s in kids} == names
        (setup,) = [s for s in kids if s["name"] == "pool_setup"]
        assert setup["counts"] == {"lanes": 64, "reused": int(graphs and k > 0)}
        blocks = [s for s in kids if s["name"] in ("eager_block", "replay")]
        # The drain is read before every block and once after the last.
        assert sum(s["name"] == "drain_read" for s in kids) == len(blocks) + 1
        assert setup["end_ns"] <= min(b["start_ns"] for b in blocks)
        for s in kids:
            assert d["start_ns"] <= s["start_ns"] <= s["end_ns"] <= d["end_ns"]
    assert sum(s["name"] == "eager_block" for s in spans) == stats["eager_blocks"]
    assert sum(s["name"] == "capture" for s in spans) == stats["graphs"]
    assert sum(s["name"] == "replay" for s in spans) == stats["replays"]
    assert stats["eager_blocks"] == (1 if graphs else stats["iterations"] // 8)
    assert stats["graphs"] == int(graphs)
    assert stats["pool_reuses"] == int(graphs)
    assert len(_by_id(spans)) == len(spans)
    assert {s["name"] for s in spans} <= WORK | {"frame", "dispatch"}


def test_tracing_off_records_nothing_and_leaves_the_frame_alone(scene):
    assert timing.span("frame") is timing.span("replay")  # the shared no-op
    with timing.tracing() as tr:
        traced, rays_on = _frame(scene)
    n = len(tr.spans)
    plain, rays_off = _frame(scene)
    assert len(tr.spans) == n > 0
    assert torch.equal(traced, plain) and rays_on == rays_off


def test_query_rows_count_every_row_and_rays_the_rows_that_carried_one(scene):
    ids, fn = twf._frame_ids(scene, OPTS)
    twf.reset_loop_stats()
    rays = 0
    for offset in (0, 2):
        _, n = twf.render_pixels_refill(scene, None, OPTS.replace(spp=2), ids,
                                        offset, lanes=64, pixel_fn=fn)
        rays += int(n)
    st = twf.loop_stats()
    assert st["dispatches"] == 2
    assert st["query_rows"] == st["iterations"] * 64 * (1 + scene.num_lights)
    assert st["rays"] == rays
    assert 0 < st["rays"] <= st["query_rows"]


def test_loss_and_grad_nests_forward_and_backward_under_grad_step(scene):
    opts = RenderOptions(spp=1, max_depth=3, chunk_size=256, cluster_width=4,
                         cluster_rays=16, seed=5)
    params = G.SceneParams.from_scene(scene)
    target = torch.zeros((16, 16, 3))
    with timing.tracing() as tr:
        loss, grads = G.loss_and_grad(params, scene, None, opts, target,
                                      device="cpu")
    spans = tr.spans
    (step,) = [s for s in spans if s["name"] == "grad_step"]
    assert step["parent"] is None and step["request"] == 5
    kids = _children(spans, step)
    assert [s["name"] for s in kids] == ["forward", "backward"]
    fwd, bwd = kids
    assert fwd["end_ns"] <= bwd["start_ns"]
    assert "pool_setup" in {s["name"] for s in _children(spans, fwd)}
    # Each pass runs its blocks op by op on the CPU.
    for half in (fwd, bwd):
        assert any(s["name"] == "eager_block" for s in spans
                   if _ancestor(spans, s, half))
    assert {s["request"] for s in spans} == {5}
    assert torch.isfinite(loss) and float(grads.kd.abs().sum()) > 0


def _ancestor(spans, s, a) -> bool:
    by_id = _by_id(spans)
    while s["parent"] is not None:
        s = by_id[s["parent"]]
        if s["id"] == a["id"]:
            return True
    return False


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_load_scene_has_parse_build_and_upload(box_dir, native):
    with timing.tracing() as tr:
        _, meta = api.load_scene(box_dir, "box", OPTS, use_native=native,
                                 device="cpu")
    spans = tr.spans
    (root,) = [s for s in spans if s["parent"] is None]
    assert root["name"] == "load_scene" and root["request"] is None
    kids = _children(spans, root)
    # A native parser that could not be built leaves a parse span that
    # raised, then the Python parser's.
    assert [s["name"] for s in kids][-3:] == ["parse", "build", "upload"]
    assert kids[-3]["counts"] == {"faces": meta.num_faces}
    assert kids[-3]["end_ns"] <= kids[-2]["start_ns"]
    assert kids[-2]["end_ns"] <= kids[-1]["start_ns"]


@pytest.fixture
def fake_graphs(monkeypatch):
    """The card's path on the CPU through the stand-in graphs below, with
    no lane pool kept from an earlier test."""
    monkeypatch.setattr(twf, "_captures", lambda dev: not twf._eager)
    monkeypatch.setattr(twf, "_CudaGraphs", _FakeGraphs)
    twf._POOLS.clear()
    twf._FRAME_TABLES.clear()
    yield
    twf._POOLS.clear()
    twf._FRAME_TABLES.clear()


class _FakeGraph:
    """A captured block on the CPU: the capture ran it, so the first replay
    does nothing; later replays run it with the launch counters held."""

    def __init__(self, fn):
        self.fn, self.first = fn, True

    def replay(self):
        if self.first:
            self.first = False
            return
        held = [w.launches for w in twf._COUNTED]
        self.fn()
        for w, n in zip(twf._COUNTED, held):
            w.launches = n


class _FakeGraphs:
    def __init__(self, dev):
        self.dev = dev

    def warm_up(self, fn):
        fn()

    def capture(self, fn):
        fn()
        return _FakeGraph(fn)


def test_capture_spans_sum_to_the_capture_counter(scene, fake_graphs):
    twf.reset_loop_stats()
    with timing.tracing() as tr:
        graphed, _ = _frame(scene)
    st = twf.loop_stats()
    spans = tr.spans
    captures = [s for s in spans if s["name"] == "capture"]
    assert len(captures) == st["graphs"] > 0
    assert sum(s["name"] == "replay" for s in spans) == st["replays"] > 0
    # One pool serves both dispatches: its first block alone runs op by op.
    assert sum(s["name"] == "eager_block" for s in spans) == st["eager_blocks"] == 1
    total = sum(s["end_ns"] - s["start_ns"] for s in captures) * 1e-9
    assert abs(total - st["capture_s"]) <= 1e-6 * len(captures)
    by_id = _by_id(spans)
    first = min((s for s in spans if s["name"] == "dispatch"),
                key=lambda s: s["start_ns"])
    assert {s["parent"] for s in captures} == {first["id"]}
    assert {by_id[s["parent"]]["name"] for s in captures} == {"dispatch"}
    assert all(s["counts"]["phase"] in range(4) for s in captures)
    with twf.eager():
        assert torch.equal(graphed, _frame(scene)[0])


def test_spans_a_raising_block_left_open_close_with_their_parent():
    with timing.tracing() as tr:
        with timing.span("outer", {"k": 1}, request=7) as outer:
            with pytest.raises(ValueError):
                with timing.span("inner"):
                    left_open = timing.span("left_open")
                    left_open.__enter__()
                    raise ValueError
            timing.record("given", 10, 30, {"phase": 0})
            outer.note(n=2)
        with timing.tracing() as inner_tr:
            with timing.span("nested"):
                pass
        with timing.span("after"):
            pass
    spans = {s["name"]: s for s in tr.spans}
    assert set(spans) == {"outer", "inner", "given", "after"}
    assert spans["outer"]["counts"] == {"k": 1, "n": 2}
    assert spans["inner"]["parent"] == spans["given"]["parent"] == outer.id
    assert spans["inner"]["request"] == spans["given"]["request"] == 7
    assert (spans["given"]["start_ns"], spans["given"]["end_ns"]) == (10, 30)
    assert spans["after"]["parent"] is None
    assert [s["name"] for s in inner_tr.spans] == ["nested"]
    assert timing.span("x") is timing.span("y")


def test_profiler_trace_lays_the_spans_over_the_profiled_ops(scene, tmp_path):
    with timing.profiler_trace(str(tmp_path)):
        _frame(scene)
    doc = json.load(open(os.path.join(tmp_path, "trace.json")))
    events = doc["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program"]
    assert all(e["ph"] == "X" for e in spans)
    (frame,) = [e for e in spans if e["name"] == "frame"]
    assert frame["args"]["request"] == OPTS.seed
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("name", "").startswith("aten::")]
    inside = [e for e in ops
              if frame["ts"] <= e["ts"] and e["ts"] + e["dur"] <=
              frame["ts"] + frame["dur"]]
    # The profiler's ops and the spans share one clock: the frame holds
    # nearly all of the profiled ops (those outside it are the profiler's
    # own, at its ends).
    assert len(inside) >= 0.9 * len(ops) > 0
    assert sum(e.get("ph") == "M" and e["args"].get("name") == "program spans"
               for e in events) == 1
