"""Dynamic and sparse label propagation of graphlearning_tpu_torch against
graphlearning_tpu at float64 on the CPU: the predictions identical and
``prob`` within 1e-10 (the same dense products and the same primal-dual
rounds; the divergence's per-row sums in another order), on a 480-node kNN
graph of four classes."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import graphlearning_tpu as jgl
import graphlearning_tpu_torch as tgl

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-10)
MODELS = ("dynamic_label_propagation", "sparse_label_propagation")


@pytest.fixture(scope="module")
def quads():
    """Four quadrant classes of 480 uniform points, k=10, 3 labels a
    class."""
    rs = np.random.RandomState(0)
    X = rs.rand(480, 2)
    y = (X[:, 0] > 0.5).astype(int) + 2 * (X[:, 1] > 0.5)
    W = jgl.weightmatrix.knn(X, 10)
    return W, y, jgl.trainsets.generate(y, rate=3, seed=1)


@pytest.mark.parametrize("name", MODELS)
def test_label_propagation_matches_jax(quads, name):
    W, y, ti = quads
    jm = getattr(jgl.ssl, name)(W)
    tm = getattr(tgl.ssl, name)(W, device="cpu")
    np.testing.assert_array_equal(tm.fit_predict(ti, y[ti]),
                                  jm.fit_predict(ti, y[ti]))
    np.testing.assert_allclose(tm.prob, jm.prob, **TOL)
    assert tm.accuracy_filename == jm.accuracy_filename
    assert tm.name == jm.name
    assert tgl.ssl.ssl_accuracy(tm.predict(), y, ti) > 60     # chance 25


@pytest.mark.parametrize("args", [(0.1, 0.2, 3), (0.0, 0.0, 1)])
def test_dynamic_label_propagation_positional_matches_jax(quads, args):
    """``(W, class_priors, alpha, lam, T)`` by position, both packages."""
    W, y, ti = quads
    jm = jgl.ssl.dynamic_label_propagation(W, None, *args)
    tm = tgl.ssl.dynamic_label_propagation(W, None, *args, device="cpu")
    jm.fit(ti, y[ti])
    tm.fit(ti, y[ti])
    np.testing.assert_allclose(tm.prob, jm.prob, **TOL)


def test_label_ids_not_consecutive(quads):
    """Label ids {0, 3, 7, 9}: dynamic LP widens its one-hot as JAX does;
    sparse LP refuses them (JAX's fit fails on the shapes)."""
    W, y, ti = quads
    y2 = np.array([0, 3, 7, 9])[y]
    jm = jgl.ssl.dynamic_label_propagation(W)
    tm = tgl.ssl.dynamic_label_propagation(W, device="cpu")
    np.testing.assert_array_equal(tm.fit_predict(ti, y2[ti]),
                                  jm.fit_predict(ti, y2[ti]))
    assert tm.prob.shape == jm.prob.shape == (480, 10)
    np.testing.assert_allclose(tm.prob, jm.prob, **TOL)
    with pytest.raises(ValueError):
        jgl.ssl.sparse_label_propagation(W).fit(ti, y2[ti])
    with pytest.raises(ValueError, match="label ids"):
        tgl.ssl.sparse_label_propagation(W, device="cpu").fit(ti, y2[ti])


def test_dynamic_label_propagation_refuses_large_graphs(capsys):
    """Above 5000 nodes both packages print the same line and return
    zeros (a ring of 5001 nodes keeps the check cheap)."""
    n = 5001
    i = np.arange(n)
    W = sp.csr_matrix((np.ones(2 * n), (np.r_[i, i], np.r_[(i + 1) % n,
                                                            (i - 1) % n])),
                      shape=(n, n))
    ti = np.array([0, 2500])
    tm = tgl.ssl.dynamic_label_propagation(W, device="cpu")
    tm.fit(ti, np.array([0, 1]))
    out = capsys.readouterr().out
    jm = jgl.ssl.dynamic_label_propagation(W)
    jm.fit(ti, np.array([0, 1]))
    assert out == capsys.readouterr().out != ""
    assert tm.prob.shape == (n, 2) and not tm.prob.any()
    np.testing.assert_array_equal(tm.prob, jm.prob)


def test_sparse_lp_edge_list_matches_jax(quads):
    """The flat edge list: rows, columns, weights and mirrors as JAX's,
    pads at row n to a multiple of 256 mirroring themselves; cached on the
    scipy matrix per device."""
    W = quads[0].copy()
    W[0, 5] = 0.5                         # one edge with no mirror
    W.eliminate_zeros()
    tm = tgl.ssl.sparse_label_propagation(W, device="cpu")
    jm = jgl.ssl.sparse_label_propagation(W)
    mine = [a.numpy() for a in tm._edge_list()]
    theirs = [np.asarray(a) for a in jm._edge_list()]
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    assert len(mine[0]) % 256 == 0 and mine[0][-1] == W.shape[0]
    assert tm._edge_list()[0] is W._gltt_edges["cpu"][0]


def test_sparse_lp_sums_without_atomics(quads, monkeypatch):
    """The divergence's per-row sums go through ``segment_reduce`` (sorted
    rows on the card), never ``index_add_`` or ``scatter_add_``."""
    W, y, ti = quads

    def refuse(*a, **k):
        raise AssertionError("atomic scatter")

    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    monkeypatch.setattr(torch.Tensor, "scatter_add_", refuse)
    tm = tgl.ssl.sparse_label_propagation(W, T=5, device="cpu")
    tm.fit(ti, y[ti])
    again = tgl.ssl.sparse_label_propagation(W, T=5, device="cpu")
    again.fit(ti, y[ti])
    np.testing.assert_array_equal(tm.prob, again.prob)
