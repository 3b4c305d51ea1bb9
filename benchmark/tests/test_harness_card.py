"""On the card: each cell's control fails its limits at the cell's own
size, and a short run of the cell is correct.  Skipped without a card."""

import pytest
from conftest import CELLS

from benchmark import run as bench_run
from benchmark.lib import manifest as mf
from benchmark.tools.control import control_numbers


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(card, name):
    man = mf.manifest()
    cell = mf.cell(man, name)
    limits = mf.limits(name)
    nums, _ = control_numbers(cell, mf.config(man, cell["config"]),
                              mf.traffic(cell["traffic"]), 424242, card)
    assert any(not (v <= limits[k]) for k, v in nums.items()
               if k in limits), (nums, limits)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_short_run_is_correct(card, name):
    man = mf.manifest()
    cell = mf.cell(man, name)
    res = bench_run.measure(cell, mf.config(man, cell["config"]),
                            mf.traffic(cell["traffic"]), mf.limits(name),
                            mf.metrics(man, name, False), 535353, 1.0,
                            False, card)
    assert res["correct"], res["checks"]
