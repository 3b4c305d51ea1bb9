"""Graph construction of graphlearning_tpu_torch (``epsilon_ball``,
``grid_graph``, ``knn_graph`` and the approximate search
``knnsearch(method="ivf" / "annoy")``) against graphlearning_tpu on the
CPU, at float64.

* ``epsilon_ball`` under each kernel, with ``features``, with an ``eta``,
  and an empty ball; ``grid_graph`` with and without ``return_xy``: the
  same host numpy, so the matrices are equal.
* ``knn_graph``'s ELL against JAX's ``SparseGraph``: within 1e-12.
* The IVF search on JAX's own recall input (``tests/test_weightmatrix.py``,
  n = 4000, 30-d clusters): the indices equal to JAX's where the
  neighbours' distances are not tied (1e-9 apart), the distances within
  1e-10 past the first column; the first, each point's distance to itself,
  is the square root of a cancellation (``|q|^2 - 2 q.q + |q|^2`` summed
  in another order), within 1e-6.  Recall against the brute search above
  0.95, and two searches equal.
"""

import numpy as np
import pytest
import torch

import graphlearning_tpu as jgl
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch.core.sparse import SparseGraph

torch.set_num_threads(2)

KERNELS = ("uniform", "gaussian", "distance", "singular")


@pytest.fixture(scope="module")
def points():
    return np.random.RandomState(0).rand(200, 2)


def _assert_same_matrix(Wt, Wj):
    assert Wt.shape == Wj.shape
    assert abs(Wt - Wj).max() == 0 if Wj.nnz else Wt.nnz == 0


@pytest.mark.parametrize("kernel", KERNELS)
def test_epsilon_ball_matches_jax(points, kernel):
    Wj = jgl.weightmatrix.epsilon_ball(points, 0.15, kernel=kernel)
    Wt = tgl.weightmatrix.epsilon_ball(points, 0.15, kernel=kernel)
    assert Wt.nnz > 0 and Wt.diagonal().max() == 0
    _assert_same_matrix(Wt, Wj)
    np.testing.assert_array_equal(Wt._glt_points, points)


def test_epsilon_ball_features_eta_and_empty(points):
    feats = np.random.RandomState(1).rand(200, 3)
    for kw in ({"features": feats, "epsilon_f": 0.5},
               {"eta": lambda t: np.exp(-t)},
               {"features": feats, "eta": lambda t: 1.0 / (1.0 + t)}):
        _assert_same_matrix(
            tgl.weightmatrix.epsilon_ball(points, 0.2, **kw),
            jgl.weightmatrix.epsilon_ball(points, 0.2, **kw))
    empty = tgl.weightmatrix.epsilon_ball(points, 1e-9)
    assert empty.shape == (200, 200) and empty.nnz == 0
    with pytest.raises(ValueError, match="kernel"):
        tgl.weightmatrix.epsilon_ball(points, 0.2, kernel="bogus")
    # high-dimensional data carries no points for the curve order
    X5 = np.random.RandomState(2).rand(50, 5)
    assert not hasattr(tgl.weightmatrix.epsilon_ball(X5, 0.6), "_glt_points")


@pytest.mark.parametrize("shape", [(5, 7), (1, 6), "image"])
def test_grid_graph_matches_jax(shape):
    if shape == "image":
        args = (np.zeros((4, 6)),)
    else:
        args = shape
    _assert_same_matrix(tgl.weightmatrix.grid_graph(*args),
                        jgl.weightmatrix.grid_graph(*args))
    Wt, Xt = tgl.weightmatrix.grid_graph(*args, return_xy=True)
    Wj, Xj = jgl.weightmatrix.grid_graph(*args, return_xy=True)
    _assert_same_matrix(Wt, Wj)
    np.testing.assert_array_equal(Xt, Xj)


@pytest.mark.parametrize("kernel", ["gaussian", "uniform"])
def test_knn_graph_matches_jax(kernel):
    X = np.random.RandomState(4).randn(300, 8)
    gj = jgl.weightmatrix.knn_graph(X, 7, kernel=kernel)
    gt = tgl.weightmatrix.knn_graph(X, 7, kernel=kernel, device="cpu")
    assert isinstance(gt, SparseGraph) and gt.device.type == "cpu"
    assert gt.vals.dtype == torch.float64 and gt.n == 300
    Aj, At = gj.to_scipy(), gt.to_scipy()
    assert At.nnz == Aj.nnz
    assert abs(At - Aj).max() < 1e-12
    g32 = tgl.weightmatrix.knn_graph(X, 7, dtype=torch.float32, device="cpu")
    assert g32.vals.dtype == torch.float32


@pytest.fixture(scope="module")
def recall_input():
    """JAX's recall input (``tests/test_weightmatrix.py``)."""
    rs = np.random.RandomState(3)
    n, d, ncls = 4000, 30, 10
    centers = rs.randn(ncls, d) * 2.0
    labels = rs.randint(0, ncls, n)
    X = centers[labels] + rs.randn(n, d) * 0.5
    return X, jgl.weightmatrix.knnsearch(X, 10, method="ivf")


def _untied(D):
    """Where a neighbour's distance is 1e-9 or more from both of its
    neighbours in the sorted row."""
    gap = np.diff(D, axis=1) > 1e-9
    left = np.concatenate([np.ones((len(D), 1), bool), gap], axis=1)
    right = np.concatenate([gap, np.ones((len(D), 1), bool)], axis=1)
    return left & right


def test_ivf_matches_jax_and_recalls_brute(recall_input):
    X, (Jj, Dj) = recall_input
    Jt, Dt = tgl.weightmatrix.knnsearch(X, 10, method="ivf", device="cpu")
    assert Jt.shape == Dt.shape == (4000, 10) and Jt.dtype == np.int64
    untied = _untied(Dj)
    assert untied.mean() > 0.99
    np.testing.assert_array_equal(Jt[untied], Jj[untied])
    np.testing.assert_allclose(Dt[:, 1:], Dj[:, 1:], rtol=0, atol=1e-10)
    np.testing.assert_allclose(Dt[:, 0], Dj[:, 0], rtol=0, atol=1e-6)
    Jb, Db = tgl.weightmatrix.knnsearch(X, 10, method="brute", device="cpu")
    recall = np.mean([len(np.intersect1d(Jb[i], Jt[i])) / 10
                      for i in range(len(X))])
    assert recall > 0.95, recall
    hit = Jt == Jb
    np.testing.assert_allclose(Dt[hit], Db[hit], rtol=0, atol=1e-6)
    J2, D2 = tgl.weightmatrix.knnsearch(X, 10, method="ivf", device="cpu")
    np.testing.assert_array_equal(J2, Jt)
    np.testing.assert_array_equal(D2, Dt)


def test_annoy_routes_to_ivf_and_angular(recall_input):
    X = recall_input[0][:1500]
    Ji, Di = tgl.weightmatrix.knnsearch(X, 8, method="ivf", device="cpu")
    Ja, Da = tgl.weightmatrix.knnsearch(X, 8, method="annoy", device="cpu")
    np.testing.assert_array_equal(Ja, Ji)
    np.testing.assert_array_equal(Da, Di)
    Jt, Dt = tgl.weightmatrix.knnsearch(X, 8, method="annoy",
                                        similarity="angular", device="cpu")
    Jj, Dj = jgl.weightmatrix.knnsearch(X, 8, method="annoy",
                                        similarity="angular")
    untied = _untied(Dj)
    np.testing.assert_array_equal(Jt[untied], Jj[untied])
    np.testing.assert_allclose(Dt[:, 1:], Dj[:, 1:], rtol=0, atol=1e-10)
    with pytest.raises(ValueError, match="ivf"):
        tgl.weightmatrix.knnsearch(X, 8, method="ivf", similarity="dot",
                                   device="cpu")


def test_ivf_options_match_jax():
    """Fewer probes and clusters than the defaults, with k above a
    cluster's size."""
    from graphlearning_tpu import weightmatrix as jwm
    from graphlearning_tpu_torch import weightmatrix as twm

    X = np.random.RandomState(6).randn(600, 4)
    Jj, Dj = jwm._ivf_knn_device(X, 12, num_clusters=20, num_probe=3,
                                 kmeans_iters=4, seed=2)
    Jt, Dt = twm._ivf_knn_device(X, 12, num_clusters=20, num_probe=3,
                                 kmeans_iters=4, seed=2, device="cpu")
    untied = _untied(Dj)
    np.testing.assert_array_equal(Jt[untied], Jj[untied])
    np.testing.assert_allclose(Dt[:, 1:], Dj[:, 1:], rtol=0, atol=1e-10)
