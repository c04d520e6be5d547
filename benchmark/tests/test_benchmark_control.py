"""The control, the reference with the scene held in bfloat16 and computed
in float32 put in the program's place, fails each cell's check at a tiny
size here; at the cells' own sizes it runs on the card
(``benchmark/readings.py``, and the ``card`` test below).  Every cell is
taken, through its traffic loop's own ``numbers``."""

import pytest
import torch

from benchmark import checks, core, program
from benchmark.reference import scene as RS
from benchmark.tests import _tiny

NAMES = core.names("workloads", ".json")


def control_numbers(cell, dev, seed):
    r = core.Run(cell, seed, 0.0, False, str(dev))
    try:
        ref = RS.load(r.write_scene(), cell.scene_name, device=dev)
        numbers = cell.loop.numbers(cell, program.render_options(cell.options),
                                    None, ref, checks.control_scene(ref),
                                    "control", seed, dev)
        numbers.pop("detail", None)
        return numbers
    finally:
        r.cleanup()


@pytest.mark.parametrize("name", NAMES)
def test_the_control_fails_at_a_tiny_size(name):
    cell = _tiny.cell(name, check_pixels=512)
    cell.config.update({"width": 96, "height": 54, "n_tris": 20000}
                       if "n_tris" in cell.config else {})
    ok, rows = checks.judge(control_numbers(cell, torch.device("cpu"), 5), cell.limits)
    assert not ok, rows


@pytest.mark.card
@pytest.mark.parametrize("name", NAMES)
def test_the_control_fails_at_the_cells_size(card, name):
    cell = core.Cell(name)
    for seed in (31, 32, 33):
        ok, rows = checks.judge(control_numbers(cell, card, seed), cell.limits)
        assert not ok, rows
