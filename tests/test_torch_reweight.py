"""``graph.reweight`` and the reweighted Laplace fits of
graphlearning_tpu_torch against graphlearning_tpu on the CPU, at float64
(JAX's x64 on): the reweighted CSR allclose to JAX's, then
``laplace(reweighting=...)`` with JAX's predictions, on the 500-node two
moons and on the hub graph (through the gather), and the reweighted graph
kept for the next fit of the same split."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import graphlearning_tpu as jgl
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch.ops import gather as tgather
from test_torch_gather import cpu_accel, hub_graph  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def moons():
    """The 500-node two moons of ``tests/test_ssl_models2.py``, with its
    points (the "properly" reweighting reads them)."""
    import sklearn.datasets as datasets

    X, labels = datasets.make_moons(n_samples=500, noise=0.1, random_state=0)
    W = jgl.weightmatrix.knn(X, 10)
    rs = np.random.RandomState(1)
    train_ind = np.concatenate(
        [rs.choice(np.where(labels == c)[0], 5, replace=False)
         for c in (0, 1)])
    return W, X, labels, train_ind


# (method, normalization): the Poisson reweighting in both normalizations
METHODS = [("poisson", "combinatorial"), ("poisson", "normalized"),
           ("wnll", "combinatorial"), ("properly", "combinatorial")]


@pytest.mark.parametrize("method,normalization", METHODS)
def test_reweight_matches_jax(moons, method, normalization):
    """The reweighted matrix: the same sparsity, values within 1e-12 of
    the largest; the Poisson weights within 1e-6, since they come from CG
    stopped at its tol 1e-5 on a singular system, where the two packages'
    sums in other orders move the iterate by about 1e-7."""
    W, X, _, ti = moons
    Wj = jgl.graph(W).reweight(ti, method=method,
                               normalization=normalization, X=X)
    Wt = tgl.graph(W, device="cpu").reweight(ti, method=method,
                                             normalization=normalization,
                                             X=X)
    Wj, Wt = sp.csr_matrix(Wj), sp.csr_matrix(Wt)
    Wj.sort_indices()
    Wt.sort_indices()
    np.testing.assert_array_equal(Wt.indptr, Wj.indptr)
    np.testing.assert_array_equal(Wt.indices, Wj.indices)
    tol = 1e-6 if method == "poisson" else 1e-12
    np.testing.assert_allclose(Wt.data, Wj.data, rtol=0,
                               atol=tol * np.abs(Wj.data).max())


def test_reweight_refuses_what_jax_refuses(moons):
    W, _, _, ti = moons
    G = tgl.graph(W, device="cpu")
    with pytest.raises(ValueError, match="requires features X"):
        G.reweight(ti, method="properly")
    with pytest.raises(ValueError, match="invalid reweighting"):
        G.reweight(ti, method="bogus")
    with pytest.raises(ValueError, match="unsupported normalization"):
        G.reweight(ti, method="poisson", normalization="randomwalk")
    with pytest.raises(ValueError, match="invalid reweighting"):
        tgl.ssl.laplace(W, reweighting="bogus", device="cpu")


@pytest.mark.parametrize("method", ["poisson", "wnll", "properly"])
@pytest.mark.parametrize("normalization", ["combinatorial", "normalized"])
def test_reweighted_laplace_matches_jax(moons, method, normalization):
    """JAX's predictions, and ``u`` within the CG tolerance's scale."""
    W, X, y, ti = moons
    jm = jgl.ssl.laplace(W, X=X, reweighting=method,
                         normalization=normalization)
    tm = tgl.ssl.laplace(W, X=X, reweighting=method,
                         normalization=normalization, device="cpu")
    np.testing.assert_array_equal(tm.fit_predict(ti, y[ti]),
                                  jm.fit_predict(ti, y[ti]))
    np.testing.assert_allclose(tm.prob, jm.prob, rtol=0,
                               atol=1e-5 * np.abs(jm.prob).max())
    assert tm.name == jm.name


def test_reweighted_graph_kept_per_split(moons):
    """A second fit of the same split reuses the reweighted graph; another
    split builds its own (as the JAX package's cache)."""
    W, X, y, ti = moons
    m = tgl.ssl.laplace(W, reweighting="wnll", device="cpu")
    p1 = m.fit_predict(ti, y[ti])
    G = m._reweight_G
    np.testing.assert_array_equal(m.fit_predict(ti, y[ti]), p1)
    assert m._reweight_G is G
    other = tgl.trainsets.generate(y, rate=8, seed=3)
    m.fit_predict(other, y[other])
    assert m._reweight_G is not G


@pytest.mark.parametrize("method", ["poisson", "wnll"])
def test_reweighted_laplace_through_the_gather(hub_graph, cpu_accel,
                                               method):
    """On the hub graph the reweighted graph gets its own gather (not
    cached on the model): JAX's predictions, ``u`` within the CG
    tolerance's scale."""
    W, y, ti = hub_graph
    jm = jgl.ssl.laplace(W, reweighting=method)
    tm = tgl.ssl.laplace(W, reweighting=method, device="cpu")
    np.testing.assert_array_equal(tm.fit_predict(ti, y[ti]),
                                  jm.fit_predict(ti, y[ti]))
    np.testing.assert_allclose(tm.prob, jm.prob, rtol=0,
                               atol=1e-5 * np.abs(jm.prob).max())
    Wr = tm._reweight_G.weight_matrix
    assert any(isinstance(a, tgather.GatherAccel)
               for a in Wr._gltt_accel_cache.values())
    assert getattr(tm, "_accel_cache", None) is None
