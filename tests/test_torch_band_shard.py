"""The partitioned tiled band (``parallel/band_shard.py``) against the JAX
package's: ``build_band_partition`` at Pn in {2, 4}, R = WT = 64, n not a
multiple of the block, with and without a halo cut short
(``max_halo_frac``, which sends edges to the residual), array for array
(K1 on its CPU twin against the Pallas kernel in interpret mode, both in
float64: the same sums, so equal); then the blockwise product, K3 (its
twin) over each block's halo-extended X plus the residual, against
scipy's ``W @ X`` (1e-12 of max|ref|: float64 sums in another order).
One process: no ranks."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from graphlearning_tpu.parallel.band_shard import (
    build_band_partition as jax_partition)

from graphlearning_tpu_torch.ops import band_spmm as bs
from graphlearning_tpu_torch.parallel.band_shard import (
    build_band_partition, make_sharded_op)

N = 777


def _rcm_knn(n, k=6, seed=0):
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from scipy.spatial import cKDTree

    rs = np.random.RandomState(seed)
    pts = rs.rand(n, 2)
    dist, ind = cKDTree(pts).query(pts, k=k + 1)
    dist, ind = dist[:, 1:], ind[:, 1:]
    w = np.exp(-(dist / np.maximum(dist[:, -1:], 1e-12)) ** 2)
    W = sp.csr_matrix((w.ravel(), (np.repeat(np.arange(n), k),
                                   ind.ravel())), shape=(n, n))
    W = (W + W.T) / 2
    perm = np.asarray(reverse_cuthill_mckee(W, symmetric_mode=True))
    return W[perm][:, perm].tocsr()


@pytest.fixture(scope="module")
def W():
    W = _rcm_knn(N, seed=3).tolil()
    W[5, N - 3] = W[N - 3, 5] = 0.4          # a long edge
    rs = np.random.RandomState(7)            # and mid-range ones, beyond a
    for i in rs.choice(N - 200, 20, replace=False):   # short halo
        j = i + rs.randint(80, 150)
        W[i, j] = W[j, i] = 0.3
    return W.tocsr()


CASES = [(2, 1.0), (4, 1.0), (2, 0.1), (4, 0.25)]


@pytest.fixture(scope="module")
def partitions(W):
    return {(Pn, f): (build_band_partition(W, Pn, R=64, WT=64,
                                           max_halo_frac=f,
                                           band_dtype=torch.float64,
                                           device="cpu"),
                      jax_partition(W, Pn, R=64, WT=64, interpret=True,
                                    max_halo_frac=f, band_dtype=np.float64))
            for Pn, f in CASES}


@pytest.mark.parametrize("Pn,frac", CASES)
def test_partition_equals_jax(partitions, Pn, frac):
    part, ref = partitions[Pn, frac]
    for name in ("n", "n_pad", "B", "H", "G", "Pn", "R", "WT", "nnz"):
        assert getattr(part, name) == getattr(ref, name), name
    for name in ("tb", "ts", "bf", "cols", "vals", "deg", "lcols",
                 "res_rows", "res_slots", "res_cols", "res_vals"):
        np.testing.assert_array_equal(getattr(part, name),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(part.band.numpy(), np.asarray(ref.band))
    assert part.residual_frac == ref.residual_frac
    if frac < 1.0:
        assert len(part.res_rows) > 2        # the cut halo sent edges away


@pytest.mark.parametrize("Pn,frac", CASES)
def test_blockwise_product_equals_scipy(partitions, W, Pn, frac):
    """K3 over each block's halo-extended X (the neighbours' boundary
    rows, wrapped as the ring does), then the block's residual edges."""
    part, _ = partitions[Pn, frac]
    rs = np.random.RandomState(1)
    X = np.zeros((part.n_pad, 3))
    X[:N] = rs.randn(N, 3)
    B, H = part.B, part.H
    Xt = torch.as_tensor(X)
    out = np.zeros_like(X)
    for p in range(Pn):
        rows = (np.arange(B + 2 * H) + p * B - H) % part.n_pad
        plan = part.tiles_plan(p, "cpu")
        out[p * B:(p + 1) * B] = bs.band_tiles_spmm(part.bands[p], plan,
                                                    Xt[rows]).numpy()
    np.add.at(out, part.res_rows, part.res_vals[:, None] * X[part.res_cols])
    ref = W @ X[:N]
    np.testing.assert_allclose(out[:N], ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    np.testing.assert_array_equal(out[N:], 0.0)


def test_blocks_builds_only_the_named_bands(W):
    part = build_band_partition(W, 4, R=64, WT=64, band_dtype=torch.float64,
                                device="cpu", blocks=(2,))
    assert [b is None for b in part.bands] == [True, True, False, True]
    with pytest.raises(ValueError, match="K1 built only"):
        part.band
