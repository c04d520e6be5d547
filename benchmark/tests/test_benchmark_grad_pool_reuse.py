"""The reader of ``pool_reuse.grad``: the share of the profiled gradient
steps' passes that replayed a kept differentiable pool's graphs, and
nothing from a program that has no such counters."""

from benchmark import core


def test_grad_pool_reuse_reads_the_programs_counters():
    mod = core.load_module("metrics", "pool_reuse.grad")
    stats = {"dispatches": 2, "bwd_passes": 2, "fwd_pool_reuses": 2,
             "bwd_pool_reuses": 1, "fwd_graphs": 0, "bwd_graphs": 1}
    assert mod.read({"kind": "grad_steps", "grad_loop_stats": stats}) == 75.0
    assert mod.read({"kind": "grad_steps", "grad_loop_stats": dict(
        stats, fwd_pool_reuses=0, bwd_pool_reuses=0)}) == 0.0
    assert mod.read({"kind": "frames", "grad_loop_stats": stats}) is None
    assert mod.read({"kind": "grad_steps", "grad_loop_stats": dict(
        stats, dispatches=0, bwd_passes=0)}) is None


def test_a_program_without_kept_grad_pools_reads_no_grad_pool_reuse():
    """A program whose grad_loop_stats have no pool counters."""
    mod = core.load_module("metrics", "pool_reuse.grad")
    parent = {"kind": "grad_steps", "units": 2, "grad_loop_stats": {
        "dispatches": 2, "blocks": 40, "fwd_eager_blocks": 2,
        "fwd_graphs": 2, "fwd_replays": 38, "fwd_capture_s": 1.2,
        "bwd_eager_blocks": 2, "bwd_graphs": 2, "bwd_replays": 38,
        "bwd_capture_s": 1.4}}
    assert mod.read(parent) is None
    assert "pool_reuse.grad" not in core.per_layer(parent)
