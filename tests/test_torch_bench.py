"""The port's bench (``graphlearning_tpu_torch/bench.py``) on the CPU, at
small sizes.

It must print one JSON line with the JAX bench's keys (``BENCH_r05.json``
holds a JAX bench line), every mode within its error grade against the
scipy f64 chain, and plan a row-stochastic (non-symmetric) graph
correctly.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from graphlearning_tpu_torch import bench
from graphlearning_tpu_torch.ops import accel as taccel
from graphlearning_tpu_torch.ops import band_spmm as tbs

torch.set_num_threads(2)

JAX_LINE = json.loads(
    (Path(__file__).resolve().parents[1] / "BENCH_r05.json").read_text()
)["parsed"]
# The grades of tests/test_pallas_spmm.py: exact-grade modes 1e-4,
# bf16-grade modes 2e-2 (single product against scipy f64).
GRADES = {"f32": 1e-4, "rowq2_int8": 1e-4, "bf16i8": 1e-4,
          "rowq1_int8": 2e-2, "bf16": 2e-2}
SMALL = dict(n=4096, d=8, iters=3, k=16)


@pytest.fixture(scope="module")
def spmm_line():
    return bench.main(device="cpu", mode="spmm", geom="2d", prec=None,
                      band_kernels=True, stored_band=True, **SMALL)


def test_spmm_line_has_the_jax_keys(spmm_line, capsys):
    line = bench.main(device="cpu", mode="spmm", geom="2d", n=4096, d=8,
                      iters=2, k=16)
    printed = capsys.readouterr().out.strip().splitlines()
    assert len(printed) == 1
    assert json.loads(printed[0]) == json.loads(json.dumps(line))
    assert set(line) == set(JAX_LINE)
    jax_cfg = set(JAX_LINE["config"]) - {"hbm_frac_of_819GBps"}
    assert jax_cfg <= set(spmm_line["config"])
    assert "hbm_frac_of_3350GBps" in spmm_line["config"]
    modes = spmm_line["config"]["modes"]
    assert list(modes) == list(bench.SPMM_MODES)
    keys = set(JAX_LINE["config"]["modes"]["bf16"])
    assert all(set(m) == keys for m in modes.values())
    assert spmm_line["config"]["mode"] == "bf16"
    assert spmm_line["value"] == modes["bf16"]["edges_per_s"]
    assert spmm_line["config"]["kernel"] == "torch_tiles_packed_s12"


@pytest.mark.parametrize("mode", list(GRADES))
def test_spmm_modes_within_their_grades(spmm_line, mode):
    m = spmm_line["config"]["modes"][mode]
    assert 0 < m["rel_err_single"] <= GRADES[mode]
    assert np.isfinite(m["rel_err_chain"]) and m["edges_per_s"] > 0


def test_row_stochastic_graph_is_planned_right():
    """``AccelSpMM`` plans the bench's row-stochastic W (not symmetric) by
    rows over its symmetric pattern: ``spmm`` is ``W @ X`` at f64."""
    W = bench.bench_graph_2d(4096, 16, np.random.RandomState(0))
    assert (W != W.T).nnz > 0
    acc = taccel.AccelSpMM(W, device="cpu")
    assert acc.packed
    X = np.random.RandomState(1).randn(4096, 5)
    out = acc.from_perm(acc.spmm(acc.to_perm(torch.as_tensor(X)))).numpy()
    ref = W @ X
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("knob,kernel,modes", [
    ("GLT_NO_PACKED", "torch_tiles", ("bf16", "f32")),
    ("GLT_BENCH_BAND", "torch_banded_ell", ("bf16", "f32")),
    ("GLT_BENCH_PALLAS", "torch_ell_gather", ("f32",)),
])
def test_spmm_knobs_select_the_plan(monkeypatch, knob, kernel, modes):
    """GLT_NO_PACKED takes K3, GLT_BENCH_BAND=0 the unstored band (K6),
    GLT_BENCH_PALLAS=0 the plain ELL gather; each plan runs its modes."""
    monkeypatch.setenv(knob, "1" if knob == "GLT_NO_PACKED" else "0")
    line = bench.main(device="cpu", mode="spmm", geom="2d", prec=None,
                      **SMALL)
    cfg = line["config"]
    assert cfg["kernel"] == kernel and tuple(cfg["modes"]) == modes
    for mode in modes:
        assert cfg["modes"][mode]["rel_err_single"] <= GRADES[mode]


def test_spmm_launch_counts_stay_zero_on_the_cpu(spmm_line):
    """On the CPU every wrapper runs its twin: no launch is counted."""
    tbs.reset_launches()
    bench.main(device="cpu", mode="spmm", geom="2d", n=4096, d=4, iters=1,
               k=16)
    assert not any(tbs.launches().values())


# The JAX bench's band-hostile line (bench.py, GLT_BENCH_GEOM=highdim).
HIGHDIM_KEYS = {"metric", "value", "unit", "vs_baseline", "config",
                "baseline_edges_per_sec"}
HIGHDIM_CONFIG = {"n", "k", "d", "dim", "iters", "nnz", "backend", "kernel",
                  "slots", "slot_pad", "ns_per_edge", "rel_err", "baseline"}


@pytest.mark.parametrize("prec,grade", [("f32", 1e-5), ("bf16", 2e-2)])
def test_highdim_line(prec, grade):
    line = bench.main(device="cpu", mode="spmm", geom="highdim", prec=prec,
                      n=2048, k=16, d=8, iters=3, dim=30)
    assert set(line) == HIGHDIM_KEYS
    assert HIGHDIM_CONFIG <= set(line["config"])
    cfg = line["config"]
    assert cfg["kernel"] == f"gather_segmented_{prec}"
    assert cfg["rel_err_single"] <= grade and cfg["slot_pad"] >= 1.0
    assert np.isfinite(cfg["rel_err"])
    assert line["metric"] == "spmm_edges_per_sec_per_chip_band_hostile"


def test_highdim_case_serves_both_tables():
    """One ``highdim_case`` (graph, X and the scipy chain) serves the f32
    and the bf16 table, as the smoke runs them; each line is the one
    ``main`` prints for its table."""
    cfg = bench.settings(mode="spmm", geom="highdim", n=2048, k=16, d=8,
                         iters=3, dim=30)
    dev = torch.device("cpu")
    case = bench.highdim_case(cfg, dev)
    for prec, grade in (("f32", 1e-5), ("bf16", 2e-2)):
        line = bench.highdim_bench(dict(cfg, prec=prec), dev, case)
        fresh = bench.main(device="cpu", **dict(cfg, prec=prec))
        assert line["config"]["nnz"] == case[0].nnz == fresh["config"]["nnz"]
        for key in ("slots", "rel_err", "rel_err_single"):
            assert line["config"][key] == fresh["config"][key]
        assert line["config"]["rel_err_single"] <= grade


def test_poisson_line_takes_the_gather(monkeypatch):
    """The poisson mode's 20-d ten-cluster graph is band-hostile: with the
    band path admitted on the CPU the fit runs on GatherAccel, agreeing
    with the scipy reference."""
    monkeypatch.setattr(taccel, "enabled", lambda device: True)
    monkeypatch.setattr(taccel, "_MIN_N", 1)
    line = bench.main(device="cpu", mode="poisson", n=3000, k=10)
    cfg = line["config"]
    assert line["metric"] == "poisson_mnist_scale_solve_seconds"
    assert {"n", "k", "accuracy_pct", "agreement_with_reference_path",
            "reference_seconds", "backend", "path"} <= set(cfg)
    assert "GatherAccel" in cfg["path"]
    assert cfg["agreement_with_reference_path"] >= 0.99
    assert cfg["accuracy_pct"] > 80


def test_settings_from_the_environment(monkeypatch):
    monkeypatch.setenv("GLT_BENCH_N", "1024")
    monkeypatch.setenv("GLT_BENCH_GEOM", "highdim")
    monkeypatch.setenv("GLT_BENCH_PREC", "bf16")
    cfg = bench.settings(d=4)
    assert (cfg["n"], cfg["geom"], cfg["prec"], cfg["d"]) == (
        1024, "highdim", "bf16", 4)
    monkeypatch.delenv("GLT_BENCH_N")
    assert bench.settings(mode="poisson")["n"] == 70000
    with pytest.raises(TypeError):
        bench.settings(width=3)
    with pytest.raises(ValueError, match="sharded"):
        bench.main(device="cpu", mode="sharded")


def test_bench_needs_a_device_or_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default applies")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main(n=1024, d=4, iters=1)


def test_bench_gather_and_smoke_import_no_jax():
    """The bench, the gather and ``chip_smoke.py`` import neither JAX nor
    the JAX package (the card's machine has no JAX)."""
    repo = str(Path(__file__).resolve().parents[1])
    code = ("import sys; import graphlearning_tpu_torch.bench, "
            "graphlearning_tpu_torch.ops.gather, chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'graphlearning_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=repo)
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
