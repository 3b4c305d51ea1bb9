"""A traced tiny run of each cell on the CPU reports every metric read
from the program's spans and counters as a number, but the route's build,
which the CPU does not make (``ops.accel.maybe_build`` takes no route
there)."""

import pytest
import torch
from conftest import CELLS, tiny

from benchmark import run as bench_run
from benchmark.lib import manifest as mf
from benchmark.lib.program import gl

FROM_PROGRAM = ("program_span", "program_counter")


@pytest.mark.parametrize("name", CELLS)
def test_traced_run_reads_the_programs_spans(name):
    man = mf.manifest()
    cell, cfg, tf = tiny(name)
    entries = mf.metrics(man, name, True)
    mine = {m["name"] for m in entries if m["source"] in FROM_PROGRAM}
    gl.observability.spans(clear=True)    # one run a process, as run.py's
    res = bench_run.measure(cell, cfg, tf, mf.limits(name), entries, 41,
                            0.2, True, torch.device("cpu"))
    got = {k: v["value"] for k, v in res["metrics"].items() if k in mine}
    assert set(got) == mine - {"route_build_s"}, (mine, got)
    for k, v in got.items():
        if k.startswith("host_reads_per_step"):
            assert 1.0 <= v <= 1.2, (k, v)
        else:
            assert v > 0, (k, v)
    assert res["correct"], res["checks"]
