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
    # an unknown mode names the three the port runs
    with pytest.raises(ValueError, match="'sharded'"):
        bench.main(device="cpu", mode="scaling")
    sharded = bench.settings(mode="sharded")
    assert (sharded["n"], sharded["k"], sharded["d"], sharded["iters"],
            sharded["sharded_kernel"], sharded["devices"]) == (
        65536, 10, 64, 20, "gspmd", 8)


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


# -- the sharded mode ------------------------------------------------------------

SHARDED_SMALL = dict(n=4096, d=8, iters=3)


@pytest.fixture(scope="module")
def jax_sharded_line():
    """The JAX bench's sharded line at the same sizes (``bench.py`` at the
    repo root, on the test session's 8 CPU devices), run in-process."""
    import contextlib
    import importlib.util
    import io

    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("jax_bench",
                                                  root / "bench.py")
    jbench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jbench)
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for key, value in SHARDED_SMALL.items():
            mp.setenv(f"GLT_BENCH_{key.upper()}", str(value))
        with contextlib.redirect_stdout(buf):
            jbench.sharded_bench()
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.fixture(scope="module")
def sharded_runs():
    """Each kernel's sharded line at P = 1 and 2 (gloo ranks) and its
    gathered chains, the three benches' ranks spawned at once."""
    from concurrent.futures import ThreadPoolExecutor

    def run(kernel):
        chains = {}
        cfg = bench.settings(mode="sharded", sharded_kernel=kernel,
                             devices=2, **SHARDED_SMALL)
        return bench.sharded_bench(cfg, torch.device("cpu"),
                                   chains=chains), chains

    with ThreadPoolExecutor(len(bench.SHARDED_KERNELS)) as pool:
        runs = pool.map(run, bench.SHARDED_KERNELS)
        return dict(zip(bench.SHARDED_KERNELS, runs))


@pytest.mark.parametrize("kernel", ["gspmd", "ring", "banded"])
def test_sharded_line_has_the_jax_keys(sharded_runs, jax_sharded_line,
                                       kernel):
    line, _ = sharded_runs[kernel]
    assert set(line) == set(jax_sharded_line)
    assert set(jax_sharded_line["config"]) <= set(line["config"])
    cfg = line["config"]
    assert cfg["nnz"] == jax_sharded_line["config"]["nnz"]
    assert (cfg["kernel"], cfg["virtual_mesh"], cfg["d_effective"]) == (
        kernel, True, SHARDED_SMALL["d"])
    assert list(cfg["edges_per_sec"]) == ["1", "2"]
    assert all(v > 0 for v in cfg["edges_per_sec"].values())
    assert line["unit"] == ("% throughput retained sharded 2-way "
                            "(virtual mesh)")
    assert line["value"] == round(cfg["edges_per_sec"]["2"]
                                  / cfg["edges_per_sec"]["1"] * 100, 1)


@pytest.mark.parametrize("kernel", ["gspmd", "ring", "banded"])
def test_sharded_window_times_whole_chains(sharded_runs, kernel):
    """Each P times chains after a warm one until ``SHARDED_WINDOW_S``
    seconds have passed; edges/s is the timed chains' mean.  On the CPU
    the banded route runs the twins, which count no launch (the smoke
    holds K1 and K3 to their counts on the card)."""
    line, _ = sharded_runs[kernel]
    cfg = line["config"]
    for P in ("1", "2"):
        ms = cfg["chain_ms"][P]
        assert cfg["chains_timed"][P] == len(ms) - 1 >= 1
        assert cfg["window_s"] == bench.SHARDED_WINDOW_S
        assert sum(ms[1:]) >= bench.SHARDED_WINDOW_S * 1e3 * 0.999
        rate = cfg["nnz"] * cfg["iters"] / (np.mean(ms[1:]) / 1e3)
        assert cfg["edges_per_sec"][P] == pytest.approx(rate, rel=1e-3)
        assert cfg["launches"][P] == {}


@pytest.mark.parametrize("kernel", ["gspmd", "ring", "banded"])
def test_sharded_chain_equals_one_device_chain(sharded_runs, kernel):
    """Every P's gathered chain is ``W^iters X`` of the one-device scipy
    f64 chain on the bench's graph, within 1e-12 (f64 sums in another
    order); the bench's own ``rel_err_chain`` says as much."""
    line, chains = sharded_runs[kernel]
    rs = np.random.RandomState(0)
    W = bench.bench_graph_2d(SHARDED_SMALL["n"], 10, rs)
    X = rs.randn(SHARDED_SMALL["n"], SHARDED_SMALL["d"]).astype(np.float32)
    ref = X.astype(np.float64)
    for _ in range(SHARDED_SMALL["iters"]):
        ref = W @ ref
    assert sorted(chains) == [1, 2]
    for P, Y in chains.items():
        np.testing.assert_allclose(Y, ref, rtol=0,
                                   atol=1e-12 * np.abs(ref).max())
        assert line["config"]["rel_err_chain"][str(P)] <= 1e-12


def test_sharded_main_prints_its_line(capsys):
    """``main`` in the sharded mode at one rank prints the line it
    returns; an unknown kernel raises."""
    line = bench.main(device="cpu", mode="sharded", sharded_kernel="ring",
                      devices=1, **SHARDED_SMALL)
    printed = capsys.readouterr().out.strip().splitlines()
    assert json.loads(printed[-1]) == json.loads(json.dumps(line))
    assert line["value"] == 100.0 and line["unit"].startswith(
        "% throughput retained sharded 1-way")
    with pytest.raises(ValueError, match="GLT_BENCH_SHARDED_KERNEL"):
        bench.main(device="cpu", mode="sharded", sharded_kernel="pallas",
                   devices=1, **SHARDED_SMALL)
