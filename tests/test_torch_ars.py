"""ARS t-SNE of graphlearning_tpu_torch against graphlearning_tpu on the
CPU: the perplexity calibration at float64 within 1e-12, P within 1e-12
(its float32 ELL equal), the forces at a given float32 Y within 1e-5 of
the largest, and 20 iterations at n=200 with chunk 64 (the port's ragged
last chunk against JAX's padding) within 1e-4 of max|Y|; then the JAX
package's own checks (entropy, separation, zero mean) on the port."""

import inspect

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from graphlearning_tpu import ars as jars
from graphlearning_tpu.core.graphclass import graph as jgraph
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch import ars as tars

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def blobs():
    """Two 10-D Gaussian blobs, JAX's separation input (n=200)."""
    rs = np.random.RandomState(3)
    A = rs.randn(100, 10) * 0.3
    B = rs.randn(100, 10) * 0.3
    B[:, 0] += 10.0
    return np.vstack([A, B])


@pytest.fixture(scope="module")
def plans(blobs):
    """The preprocessed blobs and both packages' P at perplexity 15."""
    X, Y0 = tars._preprocess(blobs, 2, False, 200, "pca")
    return X, Y0, jars._build_P(X, 15), tars._build_P(X, 15, device="cpu")


@pytest.mark.parametrize("perplexity", [5.0, 12.0, 30.0])
def test_calibrate_perplexity_matches_jax(perplexity):
    rs = np.random.RandomState(0)
    d2 = rs.rand(50, 40) * 3.0
    Pj = np.asarray(jars._calibrate_perplexity(jnp.asarray(d2), perplexity))
    Pt = tars._calibrate_perplexity(torch.as_tensor(d2), perplexity)
    assert Pt.dtype == torch.float64
    np.testing.assert_allclose(Pt.numpy(), Pj, rtol=0, atol=1e-12)


def test_build_P_matches_jax(plans):
    _, _, Pj, Pt = plans
    assert Pt.vals.dtype == torch.float32 and Pt.k == Pj.k
    assert abs(Pt.to_scipy() - Pj.to_scipy()).max() <= 1e-12
    np.testing.assert_array_equal(Pt.cols.numpy(), np.asarray(Pj.cols))
    np.testing.assert_array_equal(Pt.vals.numpy(), np.asarray(Pj.vals))
    np.testing.assert_array_equal(Pt.deg.numpy(), np.asarray(Pj.deg))


@pytest.mark.parametrize("chunk", [64, 200])
def test_forces_match_jax(plans, chunk):
    _, _, Pj, Pt = plans
    Y = np.random.RandomState(1).randn(200, 2).astype(np.float32)
    pj, nj = jars._ars_forces(jnp.asarray(Y), Pj.cols, Pj.vals,
                              jnp.ones(200, bool), 2.0, 3.0, 200)
    pt, nt = tars._ars_forces(torch.as_tensor(Y), Pt.cols, Pt.vals, 2.0,
                              3.0, chunk)
    assert pt.dtype == nt.dtype == torch.float32
    for got, want in ((pt, pj), (nt, nj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_ars_matches_jax(blobs):
    """20 iterations, 5 of them early, at n=200 with chunk 64: the port's
    last chunk has 8 rows where JAX pads it to 64."""
    kw = dict(perplexity=15, iters=20, num_early=5, use_pca=False,
              chunk=64)
    Yj = jars.ars(blobs, **kw)
    Yt = tars.ars(blobs, **kw, device="cpu")
    assert Yt.dtype == np.float64 and Yt.shape == (200, 2)
    np.testing.assert_allclose(Yt, Yj, rtol=0,
                               atol=1e-4 * np.abs(Yj).max())


def test_prog_and_dump_are_bit_equal_to_the_plain_run(blobs, tmp_path,
                                                      monkeypatch, capsys):
    kw = dict(perplexity=15, iters=120, num_early=60, use_pca=False,
              chunk=64, device="cpu")
    Y = tars.ars(blobs, **kw)
    monkeypatch.chdir(tmp_path)
    Yp = tars.ars(blobs, prog=True, dump=True, **kw)
    np.testing.assert_array_equal(Yp, Y)
    out = capsys.readouterr().out
    assert "ARS iteration 50/120" in out and "ARS iteration 120/120" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ars_0.npy", "ars_1.npy", "ars_2.npy"]
    last = np.load(tmp_path / "ars_2.npy")
    assert last.dtype == np.float32
    np.testing.assert_array_equal(last.astype(np.float64), Y)


def test_graph_ars_binds_as_jax(blobs):
    names = list(inspect.signature(jgraph.ars).parameters)
    tnames = list(inspect.signature(tgl.graph.ars).parameters)
    assert tnames[:len(names) - 1] == names[:-1]
    assert tnames[-2:] == ["device", "kwargs"]
    assert list(inspect.signature(tars.ars).parameters) == (
        list(inspect.signature(jars.ars).parameters) + ["device"])
    args = (blobs, 2, 15, 0.5, 20, 1, 2, 3, 10, 5, False, 200, "random")
    Yj = jgraph.ars(*args, chunk=64)
    Yt = tgl.graph.ars(*args, chunk=64, device="cpu")
    np.testing.assert_allclose(Yt, Yj, rtol=0,
                               atol=1e-4 * np.abs(Yj).max())


def test_perplexity_calibration_entropy():
    """Calibrated rows have Shannon entropy log(perplexity)
    (tsne.cpp:536-588)."""
    rs = np.random.RandomState(0)
    d2 = rs.rand(50, 40) * 3.0
    perplexity = 12.0
    P = tars._calibrate_perplexity(torch.as_tensor(d2), perplexity).numpy()
    np.testing.assert_allclose(P.sum(1), 1.0, atol=1e-5)
    H = -(P * np.log(np.maximum(P, 1e-35))).sum(1)
    np.testing.assert_allclose(H, np.log(perplexity), atol=1e-3)


def test_ars_separates_clusters(blobs):
    """Two well-separated 10-D blobs stay separated in the 2-D embedding."""
    Y = tgl.graph.ars(blobs, perplexity=15, iters=250, num_early=60,
                      use_pca=False, init="pca", chunk=64, device="cpu")
    assert Y.shape == (200, 2)
    mA, mB = Y[:100].mean(0), Y[100:].mean(0)
    spread = 0.5 * (np.linalg.norm(Y[:100] - mA, axis=1).mean()
                    + np.linalg.norm(Y[100:] - mB, axis=1).mean())
    assert np.linalg.norm(mA - mB) > 3.0 * spread


def test_ars_init_array_and_zero_mean():
    rs = np.random.RandomState(1)
    X = rs.randn(60, 5)
    Y0 = rs.randn(60, 2) * 1e-4
    Y = tars.ars(X, perplexity=10, iters=20, num_early=5, init=Y0,
                 use_pca=False, chunk=30, device="cpu")
    np.testing.assert_allclose(Y.mean(0), 0.0, atol=1e-5)


def test_ars_pca_path_matches_jax(monkeypatch):
    """``use_pca`` with data wider than ``init_dim``: the host PCA by
    eigsh, then the same iterate.  ARPACK starts from a random vector, so
    its eigenvectors' signs, and with them the embedding's, vary from
    call to call: both packages get one fixed start here."""
    import scipy.sparse.linalg as spla

    real = spla.eigsh
    monkeypatch.setattr(spla, "eigsh", lambda A, **kw: real(
        A, v0=np.ones(A.shape[0]), **kw))
    rs = np.random.RandomState(2)
    X = rs.rand(120, 40)
    kw = dict(perplexity=10, iters=10, num_early=5, init_dim=8, chunk=50)
    Yj = jars.ars(X, **kw)
    Yt = tars.ars(X, **kw, device="cpu")
    np.testing.assert_allclose(Yt, Yj, rtol=0,
                               atol=1e-4 * np.abs(Yj).max())
