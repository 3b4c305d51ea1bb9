"""PageRank and the transposed product ``spmm_t`` of graphlearning_tpu_torch
against graphlearning_tpu on the CPU, at float64 (JAX's x64 on).

* ``graphops.spmm_t`` on an asymmetric ELL with hub columns (the
  transpose's spill) against JAX's ``spmm_t`` and scipy: within 1e-12 of
  max|ref|; the transpose is built once per graph.
* ``spmm_t`` and ``segment_reduce(kind="sum")`` sum without
  ``index_add_``, which adds by atomics on CUDA (the card's test of the
  same: ``test_torch_cuda_kernels.py``).
* ``solvers.pagerank.page_rank`` and ``graph.page_rank`` with and without
  a teleport vector: rtol 1e-10 against JAX's; the float32 tolerance
  clamped to ``100 eps``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import graphlearning_tpu as jgl
from graphlearning_tpu.core.sparse import SparseGraph as JSparseGraph
from graphlearning_tpu.ops import graphops as jops
from graphlearning_tpu.solvers import pagerank as jpagerank
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch.core.sparse import SparseGraph, segment_reduce
from graphlearning_tpu_torch.ops import graphops as tops
from graphlearning_tpu_torch.solvers import pagerank as tpagerank

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def directed():
    """A directed 6-NN graph of 600 points (not symmetrized) with 40 edges
    into each of three hub nodes, so the transpose's ELL spills."""
    rs = np.random.RandomState(0)
    n, k = 600, 6
    pts = rs.rand(n, 2)
    d2 = ((pts[:, None] - pts[None]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    ind = np.argsort(d2, axis=1)[:, :k]
    rows = np.repeat(np.arange(n), k)
    W = sp.csr_matrix((rs.rand(n * k) + 0.1, (rows, ind.ravel())),
                      shape=(n, n))
    hubs = sp.csr_matrix((rs.rand(120) + 0.1, (
        rs.choice(np.arange(3, n), 120, replace=False),
        np.repeat([0, 1, 2], 40))), shape=(n, n))
    return (W + hubs).tocsr()


def test_spmm_t_matches_jax_and_scipy(directed):
    W = directed
    assert (W != W.T).nnz > 0
    X = np.random.RandomState(1).randn(W.shape[0], 3)
    gt = SparseGraph.from_scipy(W, device="cpu")
    t = tops.transpose(gt)
    assert t.m > 0 and t.kcap < np.diff(W.T.tocsr().indptr).max()
    out = tops.spmm_t(gt, torch.as_tensor(X)).numpy()
    ref_j = np.asarray(jops.spmm_t(JSparseGraph.from_scipy(W), jnp.asarray(X)))
    ref = W.T @ X
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-12 * scale
    assert np.abs(out - ref_j).max() <= 1e-12 * scale
    x1 = tops.spmm_t(gt, torch.as_tensor(X[:, 0]))
    assert x1.shape == (W.shape[0],)
    np.testing.assert_allclose(x1.numpy(), ref[:, 0], rtol=0,
                               atol=1e-12 * scale)
    assert tops.transpose(gt) is t


def test_sums_use_no_atomic_scatter(directed, monkeypatch):
    """``index_add_`` sums by atomics on CUDA, in the order the threads
    arrive; ``spmm_t`` and ``segment_reduce(kind="sum")`` must not call
    it, so their results are the same in every run."""
    def refuse(*a, **k):
        raise AssertionError("index_add_ called")

    monkeypatch.setattr(torch.Tensor, "index_add_", refuse)
    W = directed
    gt = SparseGraph.from_scipy(W, device="cpu")
    X = np.random.RandomState(2).randn(W.shape[0], 2)
    out = tops.spmm_t(gt, torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(out, W.T @ X, rtol=0, atol=1e-12)
    rs = np.random.RandomState(3)
    index = torch.as_tensor(rs.randint(0, 5, 50))
    src = torch.as_tensor(rs.randn(50, 2))
    got = segment_reduce(torch.ones((5, 2), dtype=torch.float64), index, src,
                         "sum")
    ref = np.ones((5, 2))
    np.add.at(ref, index.numpy(), src.numpy())
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-14)


@pytest.mark.parametrize("teleport", [False, True])
def test_page_rank_matches_jax(directed, teleport):
    W = directed
    n = W.shape[0]
    v = None
    if teleport:
        v = np.random.RandomState(4).rand(n)
        v /= v.sum()
    ref = np.asarray(jpagerank.page_rank(JSparseGraph.from_scipy(W), v=v))
    info = {}
    got = tpagerank.page_rank(SparseGraph.from_scipy(W, device="cpu"), v=v,
                              info=info)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=0)
    assert 10 < info["iters"] < 10**5
    np.testing.assert_allclose(tgl.graph(W, device="cpu").page_rank(v=v),
                               jgl.graph(W).page_rank(v=v), rtol=1e-10,
                               atol=0)


def test_page_rank_on_a_symmetric_graph_sums_to_one():
    """On a symmetric kNN graph (``weightmatrix.knn``) PageRank sums to 1
    and matches JAX's at ``alpha=0.5``; in float32 the tolerance 1e-10 is
    clamped to ``100 eps``, so the loop stops, within ``alpha / (1 -
    alpha)`` times that step of the float64 vector (twice, for the
    rounding)."""
    X = np.random.RandomState(5).rand(400, 2)
    W = jgl.weightmatrix.knn(X, 8)
    got = tgl.graph(W, device="cpu").page_rank(alpha=0.5)
    assert abs(got.sum() - 1.0) < 1e-12
    np.testing.assert_allclose(got, jgl.graph(W).page_rank(alpha=0.5),
                               rtol=1e-10, atol=0)
    g32 = SparseGraph.from_scipy(W, dtype=torch.float32, device="cpu")
    info = {}
    u32 = tpagerank.page_rank(g32, tol=1e-10, info=info)
    assert u32.dtype == torch.float32 and info["iters"] < 10**5
    bound = 2 * 0.85 / 0.15 * 100 * np.finfo(np.float32).eps
    np.testing.assert_allclose(u32.numpy(), tgl.graph(W, device="cpu")
                               .page_rank(), rtol=0, atol=bound)


def test_spmm_t_of_a_symmetric_graph_is_its_spmm():
    """A symmetric ``W`` is its own transpose: ``spmm_t`` runs
    ``spmm`` over ``g`` itself (no second ELL, no spill), bit for bit."""
    X = np.random.RandomState(6).rand(300, 2)
    W = jgl.weightmatrix.knn(X, 7)
    g = SparseGraph.from_scipy(W, device="cpu")
    t = tops.transpose(g)
    assert t.main is g and t.m == 0
    Y = torch.as_tensor(np.random.RandomState(7).randn(300, 3))
    assert torch.equal(tops.spmm_t(g, Y), tops.spmm(g, Y))
    np.testing.assert_allclose(tops.spmm_t(g, Y).numpy(),
                               np.asarray(jops.spmm_t(
                                   JSparseGraph.from_scipy(W),
                                   jnp.asarray(Y.numpy()))),
                               rtol=0, atol=1e-12)
