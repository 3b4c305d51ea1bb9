"""Tests of the benchmark's harness and reference.  They run on the CPU at
tiny sizes; those marked ``cuda`` need a card and skip without one."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU with CUDA; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


TINY_N = {"mnist-vae-k10": 1200, "twomoons-1m-k10": 2000}


def tiny(name):
    """``(cell, config, traffic)`` of the cell ``name`` at a size the CPU
    runs in a second: the configuration's own points (its generator and
    seed) but fewer, and 6 trials a call."""
    from benchmark.lib import manifest as mf

    man = mf.manifest()
    cell = mf.cell(man, name)
    cfg = mf.config(man, cell["config"])
    cfg["points"] = {**cfg["points"], "n": TINY_N[cell["config"]]}
    tf = mf.traffic(cell["traffic"])
    if "trials" in tf:
        tf["trials"] = 6
    return cell, cfg, tf


CELLS = ["mnist70k.poisson.trials", "moons1m.laplace.fit"]
