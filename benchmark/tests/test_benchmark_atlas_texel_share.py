"""The reader of ``atlas_texel_share.grad``: the share of the atlas
backward's lanes that carried a texel's gradient, and nothing from a
program without the atlas counters or a step that summed no lane."""

from benchmark import core


def test_atlas_texel_share_reads_the_programs_counters():
    mod = core.load_module("metrics", "atlas_texel_share.grad")
    stats = {"dispatches": 2, "bwd_passes": 2, "atlas_rows": 400,
             "atlas_texel_rows": 100, "atlas_longest_run": 9}
    assert mod.read({"kind": "grad_steps", "grad_loop_stats": stats}) == 25.0
    assert mod.read({"kind": "frames", "grad_loop_stats": stats}) is None
    assert mod.read({"kind": "grad_steps", "grad_loop_stats": dict(
        stats, atlas_rows=0, atlas_texel_rows=0)}) is None


def test_a_program_without_atlas_counters_reads_no_atlas_texel_share():
    """A program whose grad_loop_stats have no atlas counters."""
    mod = core.load_module("metrics", "atlas_texel_share.grad")
    parent = {"kind": "grad_steps", "units": 2, "grad_loop_stats": {
        "dispatches": 2, "blocks": 40, "bwd_passes": 2, "fwd_pool_reuses": 2,
        "bwd_pool_reuses": 2}}
    assert mod.read(parent) is None
    assert "atlas_texel_share.grad" not in core.per_layer(parent)
