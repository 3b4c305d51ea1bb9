"""Graph container, graph ops, CG solvers, kNN construction, train sets and
the device policy of graphlearning_tpu_torch, against graphlearning_tpu at
float64 on the CPU (tolerance 1e-10 unless stated)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp

import graphlearning_tpu as jgl
from graphlearning_tpu.ops import graphops as jops
from graphlearning_tpu.solvers import cg as jcg
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch import config
from graphlearning_tpu_torch.ops import graphops as tops
from graphlearning_tpu_torch.solvers import cg as tcg

from conftest import random_knn_csr

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-10)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def W_diag():
    """Random symmetric graph with a few diagonal entries."""
    W = random_knn_csr(300, 8, seed=5).tolil()
    W[3, 3] = 0.7
    W[10, 10] = 1.3
    return W.tocsr()


@pytest.fixture(scope="module")
def graphs(W_diag):
    cols, vals, deg = jgl.SparseGraph.ell_from_scipy(W_diag)
    return (jgl.SparseGraph.from_ell_np(cols, vals, deg),
            tgl.SparseGraph.from_ell_np(cols, vals, deg, device="cpu"))


def test_ell_layout_and_roundtrip(W_diag):
    ref = jgl.SparseGraph.ell_from_scipy(W_diag)
    out = tgl.SparseGraph.ell_from_scipy(W_diag)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    g = tgl.SparseGraph.from_ell_np(*ref, device="cpu")
    assert g.vals.dtype == torch.float64 and g.cols.dtype == torch.int32
    assert (g.to_scipy() != W_diag).nnz == 0
    assert (g.transpose().to_scipy() != W_diag.T).nnz == 0
    assert g.nnz == W_diag.nnz
    knn = tgl.SparseGraph.from_knn(np.array([[1, 2], [0, 2], [0, 1]]),
                                   np.ones((3, 2)), device="cpu")
    assert knn.to_scipy().nnz == 6


def test_graphops_match_jax(graphs):
    jg, tg = graphs
    rs = np.random.RandomState(0)
    X = rs.randn(jg.n, 4)
    Xt = torch.as_tensor(X)
    pairs = [
        (jops.spmm(jg, jnp.asarray(X)), tops.spmm(tg, Xt)),
        (jops.spmm(jg, jnp.asarray(X[:, 0])), tops.spmm(tg, Xt[:, 0])),
        (jops.spmm_t(jg, jnp.asarray(X)), tops.spmm_t(tg, Xt)),
        (jops.degree_vector(jg), tops.degree_vector(tg)),
        (jops.degree_vector_p(jg, 2.0), tops.degree_vector_p(tg, 2.0)),
        (jops.diagonal(jg), tops.diagonal(tg)),
        (jops.neighbor_take(jg, jnp.asarray(X[:, 1])),
         tops.neighbor_take(tg, Xt[:, 1])),
    ]
    for norm in ("combinatorial", "randomwalk", "normalized"):
        pairs.append((jops.laplacian_matvec(jg, jnp.asarray(X), norm),
                      tops.laplacian_matvec(tg, Xt, norm)))
        pairs.append((jops.laplacian_diag(jg, norm),
                      tops.laplacian_diag(tg, norm)))
    for ref, out in pairs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError):
        tops.laplacian_matvec(tg, Xt, "bogus")


def test_conjgrad_and_constrained_solve_match_jax(graphs):
    jg, tg = graphs
    n = jg.n
    rs = np.random.RandomState(1)
    b = rs.randn(n, 3)
    jA = lambda X: X + jops.laplacian_matvec(jg, X)
    tA = lambda X: X + tops.laplacian_matvec(tg, X)
    jx, jit, _ = jcg.conjgrad(jA, jnp.asarray(b), tol=1e-12, max_iter=500)
    tx, tit, _ = tcg.conjgrad(tA, torch.as_tensor(b), tol=1e-12,
                              max_iter=500)
    assert tit == int(jit)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)

    mask = np.zeros(n, bool)
    mask[rs.choice(n, 20, replace=False)] = True
    bdy = rs.randn(n, 2)
    jL = lambda X: jops.laplacian_matvec(jg, X)
    tL = lambda X: tops.laplacian_matvec(tg, X)
    ju, jit, _ = jcg.constrained_solve(
        jL, jops.laplacian_diag(jg), jnp.asarray(mask), jnp.asarray(bdy),
        tol=1e-12, max_iter=1000)
    tu, tit, _ = tcg.constrained_solve(
        tL, tops.laplacian_diag(tg), torch.as_tensor(mask),
        torch.as_tensor(bdy), tol=1e-12, max_iter=1000)
    assert tit == int(jit)
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), **TOL)
    np.testing.assert_array_equal(tu.numpy()[mask], bdy[mask])


@pytest.mark.parametrize("dim,method", [(2, "kdtree"), (8, "brute")])
@pytest.mark.parametrize("kernel", ["gaussian", "uniform", "symgaussian"])
def test_knn_matches_jax(dim, method, kernel):
    rs = np.random.RandomState(dim)
    X = rs.rand(400, dim)
    ind, dist = tgl.weightmatrix.knnsearch(X, 11, device="cpu")
    jind, jdist = jgl.weightmatrix.knnsearch(X, 11)
    np.testing.assert_array_equal(ind, jind)
    # the self distance comes out of sqrt(~0): compare neighbours only
    np.testing.assert_allclose(dist[:, 1:], jdist[:, 1:], **TOL)
    W = tgl.weightmatrix.knn(X, 10, kernel=kernel, device="cpu")
    Wj = jgl.weightmatrix.knn(X, 10, kernel=kernel)
    assert abs(W - W.T).max() < 1e-12 and W.diagonal().sum() == 0
    assert abs(W - Wj).max() < 1e-10 and W.nnz == Wj.nnz
    assert hasattr(W, "_glt_points") == (dim <= 3)


@pytest.fixture
def knn_dirs(tmp_path, monkeypatch):
    """Both packages' ``knn_dir`` in a temporary directory."""
    monkeypatch.setattr(jgl.weightmatrix, "knn_dir", str(tmp_path / "jax"))
    monkeypatch.setattr(tgl.weightmatrix, "knn_dir", str(tmp_path / "torch"))
    return tmp_path


@pytest.mark.parametrize("similarity", ["euclidean", "angular"])
def test_knn_positional_metric_matches_jax(similarity, knn_dirs):
    """``knn(X, 10, "gaussian", None, True, "raw", similarity)``: the JAX
    package's positional order, ``metric`` sixth, gives its CSR matrix; so
    does a dataset name with ``metric``, on the kNN data JAX stored."""
    X = np.random.RandomState(7).rand(400, 3) + 0.5
    W = tgl.weightmatrix.knn(X, 10, "gaussian", None, True, "raw",
                             similarity, device="cpu")
    Wj = jgl.weightmatrix.knn(X, 10, "gaussian", None, True, "raw",
                              similarity)
    np.testing.assert_array_equal(W.indptr, Wj.indptr)
    np.testing.assert_array_equal(W.indices, Wj.indices)
    np.testing.assert_allclose(W.data, Wj.data, **TOL)
    jgl.weightmatrix.knnsearch(X, 11, None, similarity, "Points", "raw")
    tgl.weightmatrix.knn_dir = jgl.weightmatrix.knn_dir
    Wn = tgl.weightmatrix.knn("points", 10, "gaussian", None, True, "raw",
                              device="cpu")
    Wnj = jgl.weightmatrix.knn("points", 10, "gaussian", None, True, "raw")
    assert abs(Wn - Wnj).max() < 1e-10 and Wn.nnz == Wnj.nnz


@pytest.mark.parametrize("method", [None, "kdtree", "brute"])
def test_knnsearch_positional_dataset_metric_matches_jax(method, knn_dirs):
    """``knnsearch(X, 5, method, "euclidean", None, "raw")``: the JAX
    package's positional order, ``dataset`` fifth and ``metric`` sixth,
    gives its neighbors and distances; with a dataset name both packages
    store the same kNN data under it."""
    X = np.random.RandomState(8).rand(200, 3)
    args = (X, 5, method, "euclidean", None, "raw")
    ind, dist = tgl.weightmatrix.knnsearch(*args, device="cpu")
    jind, jdist = jgl.weightmatrix.knnsearch(*args)
    assert ind.shape == jind.shape == (200, 5)
    np.testing.assert_array_equal(ind, jind)
    np.testing.assert_allclose(dist[:, 1:], jdist[:, 1:], **TOL)
    tgl.weightmatrix.knnsearch(X, 5, method, "euclidean", "MNIST", "vae",
                               device="cpu")
    jgl.weightmatrix.knnsearch(X, 5, method, "euclidean", "MNIST", "vae")
    for pkg in (tgl, jgl):
        with np.load(os.path.join(pkg.weightmatrix.knn_dir,
                                  "mnist_vae.npz")) as f:
            np.testing.assert_array_equal(f["J"], jind)
            np.testing.assert_allclose(f["D"][:, 1:], jdist[:, 1:], **TOL)


@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_coifmanlafon_laplacian_matches_jax(W_diag, alpha):
    """The random-walk Laplacian of ``D^-alpha W D^-alpha``, alpha by
    position, against JAX's scipy matrix; alpha defaults to 1."""
    G = tgl.graph(W_diag, device="cpu")
    Gj = jgl.graph(W_diag)
    L = G.laplacian("coifmanlafon", alpha)
    Lj = Gj.laplacian("coifmanlafon", alpha)
    assert L.shape == Lj.shape and abs(L - Lj).max() < 1e-12
    if alpha == 1.0:
        assert abs(G.laplacian("coifmanlafon") - Lj).max() < 1e-12


def test_trainsets_and_utils_match_jax():
    labels = np.random.RandomState(2).randint(0, 4, 300)
    for rate in (5, 0.1, [3, 1, 2, 4]):
        np.testing.assert_array_equal(
            tgl.trainsets.generate(labels, rate=rate, seed=7),
            jgl.trainsets.generate(labels, rate=rate, seed=7))
    trials = tgl.trainsets.generate(labels, rate=2, num_trials=3, seed=1)
    assert len(trials) == 3
    np.testing.assert_array_equal(tgl.utils.labels_to_onehot(labels),
                                  jgl.utils.labels_to_onehot(labels))
    A = random_knn_csr(50, 4, seed=3)
    B = random_knn_csr(50, 4, seed=4)
    assert abs(tgl.utils.sparse_max(A, B)
               - jgl.utils.sparse_max(A, B)).max() == 0


def test_graph_object_laplacians(W_diag):
    G = tgl.graph(W_diag, device="cpu")
    Gj = jgl.graph(W_diag)
    for norm in ("combinatorial", "randomwalk", "normalized"):
        assert abs(G.laplacian(norm) - Gj.laplacian(norm)).max() < 1e-12
        mv, diag = G.laplacian_op(norm)
        jmv, jdiag = Gj.laplacian_op(norm)
        X = np.random.RandomState(3).randn(W_diag.shape[0], 2)
        np.testing.assert_allclose(mv(torch.as_tensor(X)).numpy(),
                                   np.asarray(jmv(jnp.asarray(X))), **TOL)
        np.testing.assert_allclose(diag.numpy(), np.asarray(jdiag), **TOL)
    # the device ELL is cached on the scipy matrix, apart from JAX's cache
    assert tgl.graph(W_diag, device="cpu").g is G.g
    np.testing.assert_allclose(G.degree_vector(), Gj.degree_vector(), **TOL)


def test_import_pulls_in_neither_jax_nor_the_jax_package():
    code = ("import sys, graphlearning_tpu_torch; "
            "from graphlearning_tpu_torch import clustering; "
            "from graphlearning_tpu_torch.solvers import eig, kmeans, lobpcg; "
            "bad = [m for m in sys.modules if m in ('jax', 'sklearn', "
            "'graphlearning_tpu') or m.startswith(('jax.', 'sklearn.', "
            "'graphlearning_tpu.'))]; print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(config, "_default_device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.RandomState(0).rand(50, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgl.weightmatrix.knn(X, 5)
    W = tgl.weightmatrix.knn(X, 5, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgl.ssl.laplace(W)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgl.graph(W)
    assert config.device("cpu").type == "cpu"
    config.set_device("cpu")
    assert tgl.ssl.poisson(W).graph.device.type == "cpu"
    assert config.float_dtype(config.device()) == torch.float64
