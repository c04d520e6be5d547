"""The ``sharded_frames`` loop with all of its ranks on the CPU over gloo,
at a tiny size: correct when sound, not correct with the timed path broken
underneath, no hang and no result when a rank fails, and the readers of
the all-reduce and of the ranks' wait on synthetic traces.  Runs whose
faults are planted in every rank (``_faults.py``), or whose rank 0 has to
exit, run in a process of their own."""

import json
import multiprocessing
import subprocess
import sys
import time

import pytest

from benchmark import core, profiling
from benchmark.tests import _tiny

NAME = "cornell-1024-spp25-4chip"
SEED = 2**31 + 91


def cell():
    return _tiny.cell(NAME, check_pixels=256)


def run_apart(hook=None, seconds=0.3, timeout=90):
    """A tiny run of the cell in a process of its own, with the rank hook
    ``hook`` of ``_faults.py``: (exit code, result or None, stderr,
    seconds)."""
    code = ("import sys\n"
            f"sys.path.insert(0, {core.ROOT!r})\n"
            "from benchmark import core\n"
            "from benchmark.tests import _tiny\n"
            f"r = core.Run(_tiny.cell({NAME!r}, check_pixels=256), {SEED}, "
            f"{seconds}, False, device='cpu')\n"
            f"r.rank_hook = {'benchmark.tests._faults:' + hook if hook else None!r}\n"
            "sys.exit(core.finish(r))\n")
    t = time.monotonic()
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=timeout, cwd=core.ROOT)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    return p.returncode, json.loads(lines[-1]) if lines else None, p.stderr, \
        time.monotonic() - t


def no_process_left():
    from torch import distributed as dist

    assert not dist.is_initialized()
    assert multiprocessing.active_children() == []


def test_the_sharded_box_is_correct_at_a_tiny_size():
    out = _tiny.run(cell(), seed=SEED)
    assert out["correct"], out["checks"]
    assert out["device"]["count"] == 4 and out["failed"] == 0
    no_process_left()


def test_a_frame_altered_on_rank_0_fails(monkeypatch):
    from montecarlopathtracing_torch.parallel import mesh

    real = mesh.render_image_sharded
    monkeypatch.setattr(mesh, "render_image_sharded",
                        lambda *a, **kw: real(*a, **kw) * 1.1)
    assert not _tiny.run(cell(), seed=SEED)["correct"]
    no_process_left()


@pytest.mark.parametrize("hook", ["no_exchange", "half_samples"])
def test_a_fault_in_every_rank_fails(hook):
    rc, out, err, _ = run_apart(hook)
    assert rc == 0 and out is not None, err[-3000:]
    assert not out["correct"], out["checks"]


@pytest.mark.timeout(120)
@pytest.mark.parametrize("hook", ["rank2_raises_in_the_window", "rank1_raises_at_once",
                                  "rank0_raises_in_the_window"])
def test_a_rank_that_raises_ends_the_run_without_a_result(hook):
    rc, out, err, seconds = run_apart(hook, seconds=5.0)
    assert rc != 0 and out is None, err[-3000:]
    assert "a planted failure of this rank" in err
    if not hook.startswith("rank0"):
        # Rank 0 saw another rank end and stopped the run.
        assert rc == 4 and "the run stops without a result" in err
    assert seconds < 60


def test_rank_0_failing_stops_the_other_ranks(monkeypatch):
    from montecarlopathtracing_torch.parallel import mesh

    real, calls = mesh.render_image_sharded, []

    def failing(*a, **kw):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("rank 0 fails")
        return real(*a, **kw)

    monkeypatch.setattr(mesh, "render_image_sharded", failing)
    t = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 0 fails"):
        _tiny.run(cell(), seed=SEED)
    assert time.monotonic() - t < 60
    no_process_left()


def test_a_rank_holding_jax_fails_the_run():
    rc, out, err, _ = run_apart("rank3_holds_jax")
    assert rc == 3 and out is None, err[-3000:]
    assert "rank 3: jax" in err


def ranks_trace(allreduce, wall_s=2.0):
    return {"kind": "frames", "units": len(allreduce[0]), "wall_s": wall_s,
            "ranks": [{"rank": r, "busy_s": 1.0, "allreduce_s": a}
                      for r, a in enumerate(allreduce)]}


def test_allreduce_and_rank_wait_by_hand():
    ar = core.load_module("metrics", "allreduce_ms.shard")
    wait = core.load_module("metrics", "rank_wait_share.shard")
    # Two frames, 1 s of wall each; the least all-reduce 1 ms and 2 ms.
    trace = ranks_trace([[0.001, 0.010], [0.003, 0.002], [0.005, 0.006],
                         [0.011, 0.002]])
    assert ar.read(trace) == pytest.approx(1.5)
    # Frame 1 waits (0 + 2 + 4 + 10) / 4 = 4 ms, frame 2 (8 + 0 + 4 + 0) / 4
    # = 3 ms, each over 1 s.
    assert wait.read(trace) == pytest.approx(0.35)
    # A rank whose profiler recorded no all-reduce for a frame is left out
    # of that frame: frame 2 is the other three's, (0 + 4 + 8) / 3 ms.
    gap = ranks_trace([[0.001, 0.010], [0.003, None], [0.005, 0.006],
                       [0.011, 0.002]])
    assert ar.read(gap) == pytest.approx(1.5)
    assert wait.read(gap) == pytest.approx(100 * (0.004 + 0.004) / 2)
    # A frame that fewer than two ranks recorded is left out.
    one = ranks_trace([[0.001, None], [None, None], [0.003, 0.002]])
    assert ar.read(one) == pytest.approx(1.0)
    none = ranks_trace([[0.001, None], [None, 0.002]])
    assert ar.read(none) is None and wait.read(none) is None
    assert ar.read(dict(trace, ranks=[])) is None
    assert "allreduce_ms.shard" in core.per_layer(trace)
    assert "rank_wait_share.shard" not in core.per_layer(dict(trace, wall_s=0))


def test_a_ranks_summary_times_each_frames_allreduce_kernels():
    loop = core.load_module("loops", "sharded_frames")
    ar = "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)"
    # Three profiled frames: one all-reduce kernel, two, none.
    sessions = [[("k(x)", 0.0, 1.0), (ar, 1.0, 1.25)],
                [("k(x)", 5.0, 6.0), (ar, 6.5, 6.75), (ar, 6.75, 7.0)],
                [("k(x)", 9.0, 9.5)]]
    s = loop.rank_summary(sessions)
    assert s["allreduce_s"] == [0.25, 0.5, None]
    assert s["allreduce_n"] == [1, 2, 0]
    # Busy within each frame; the gaps between the frames' sessions are the
    # profiler's, not the device's.
    assert s["busy_s"] == pytest.approx(1.25 + 1.5 + 0.5)
    assert [round(g, 6) for _, g in s["idle_gaps"]] == [0.5]
    assert s["kernel_count"] == 6


def test_a_graphs_fill_and_copy_nodes_are_not_kernels():
    for name in ("memset32", "memcpy32_post", "memcpy128", "Memset (Device)",
                 "Memcpy DtoD (Device -> Device)"):
        assert profiling.is_copy(name), name
    assert not profiling.is_copy("void at::native::vectorized_gather_kernel<16, long>")
    events = [("memset32", 0.0, 0.1), ("memcpy128", 0.1, 0.2), ("k(x)", 0.2, 0.3),
              ("memcpy32_post", 0.3, 0.4)]
    assert profiling.summarize(events)["kernel_count"] == 1


def test_rank_0s_own_work_leaves_out_its_wait_in_the_allreduce():
    loop = core.load_module("loops", "sharded_frames")
    ranks = [{"busy_s": 1.0, "allreduce_s": [0.25, 0.002]},
             {"busy_s": 0.9, "allreduce_s": [0.001, 0.1]},
             {"busy_s": 0.9, "allreduce_s": [0.05, 0.3]}]
    # Rank 0 waited 0.249 s past the exchange in the first frame, and was
    # the last to arrive in the second.
    assert loop.own_work_s(ranks) == pytest.approx(0.751)
    # The least is over the ranks that recorded the frame's all-reduce.
    gap = ranks[:2] + [{"busy_s": 0.9, "allreduce_s": [None, 0.3]}]
    assert loop.own_work_s(gap) == pytest.approx(0.751)
    assert loop.own_work_s([{"busy_s": 1.0, "allreduce_s": [None, 0.002]}]
                           + ranks[1:]) == pytest.approx(1.0)
