"""The reader of ``pool_reuse.fwd``: the share of the profiled frames'
dispatches that replayed a kept lane pool's graphs, and nothing from a
program that has no such counter."""

from benchmark import core


def test_pool_reuse_reads_the_programs_counters():
    mod = core.load_module("metrics", "pool_reuse.fwd")
    stats = {"dispatches": 10, "pool_reuses": 9, "graphs": 0}
    assert mod.read({"kind": "frames", "loop_stats": stats}) == 90.0
    assert mod.read({"kind": "frames", "loop_stats": {
        "dispatches": 10, "pool_reuses": 0}}) == 0.0
    assert mod.read({"kind": "grad_steps", "loop_stats": stats}) is None
    assert mod.read({"kind": "frames", "loop_stats": {
        "dispatches": 0, "pool_reuses": 0}}) is None


def test_a_program_without_kept_pools_reads_no_pool_reuse():
    """A program whose loop_stats have no ``pool_reuses``."""
    mod = core.load_module("metrics", "pool_reuse.fwd")
    parent = {"kind": "frames", "units": 1, "loop_stats": {
        "dispatches": 5, "iterations": 400, "idle_iterations": 3,
        "eager_blocks": 5, "graphs": 25, "replays": 45, "capture_s": 4.2,
        "query_rows": 800, "rays": 500}}
    assert mod.read(parent) is None
    assert "pool_reuse.fwd" not in core.per_layer(parent)
