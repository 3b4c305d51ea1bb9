"""The distribution layer's products on spawned gloo ranks (P = 2 and 4,
n not a multiple of P), held to scipy's ``W @ X`` and to the JAX
package's sharded products on its virtual CPU mesh: the ELL route
(``sharded_spmm``, ``sharded_spmm_ring``), the partitioned band
(``ShardedOp.spmm_``: K1, K3 and the ring halo, on the kernels' CPU
twins) with a residual edge, and the capped ELL plus spill of a hub
graph (``ShardedBucketedGraph``), with the degree and diagonal hooks; the
mesh's collectives; and ``initialize_distributed`` over ``tcp://``
loopback (skipped where sockets are forbidden).

The ranks run the cases of ``tests/test_torch_ranks.py`` (no JAX there):
one spawn for both world sizes, all cases in it.  Tolerances: the ELL
route and the band in float64 sum the same products in another order
(1e-12 of max|ref|); the ring reorders the k-sum (1e-12).
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

from graphlearning_tpu import parallel as jpar
from graphlearning_tpu.core.sparse import SparseGraph as JSparseGraph
from jax.sharding import NamedSharding, PartitionSpec

from graphlearning_tpu.ops import graphops as jops
from graphlearning_tpu.parallel.band_shard import (build_band_partition,
                                                   make_sharded_op)
from graphlearning_tpu.parallel.shard import build_sharded_bucketed as jbuck

import graphlearning_tpu_torch as tgl
from tests import test_torch_ranks as ranks

N = 301                        # not a multiple of 2 or 4
N_BAND = 1000
TOL = 1e-12


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


def _hub_graph(n, seed=3):
    """The ring with chords plus three hubs of degree about 60: the
    p95-capped ELL spills their tails."""
    rs = np.random.RandomState(seed)
    W = ranks.ring_graph(n, seed).tolil()
    for h in range(3):
        for j in rs.choice(n, 60, replace=False):
            if j != h:
                W[h, j] = W[j, h] = 0.5 + rs.rand()
    return W.tocsr()


@pytest.fixture(scope="module")
def inputs():
    rs = np.random.RandomState(0)
    W_band = _rcm_knn(N_BAND).tolil()
    W_band[0, N_BAND - 1] = W_band[N_BAND - 1, 0] = 0.7   # beyond any halo
    return {"W": ranks.ring_graph(N), "X": rs.randn(N, 5),
            "W_band": W_band.tocsr(), "X_band": rs.randn(N_BAND, 3),
            "W_hub": _hub_graph(N), "X_hub": rs.randn(N, 4),
            "R": 64, "WT": 64, "max_halo_frac": 1.0}


@pytest.fixture(scope="module")
def results(inputs, tmp_path_factory):
    cases = [("c", ranks.case_collectives, {"n": 5}),
             ("spmm", ranks.case_spmm, inputs)]
    return ranks.run_ranks({2: cases, 4: cases},
                           tmp_path_factory.mktemp("par"))


@pytest.fixture(scope="module")
def jmesh4():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("nodes",))


def _close(out, ref, tol=TOL):
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


@pytest.mark.parametrize("P", [2, 4])
def test_mesh_collectives(results, P):
    n = 5
    blocks = [np.arange(n, dtype=float)[:, None] + 100.0 * p
              for p in range(P)]
    for p, res in enumerate(results[P]):
        c = res["c"]
        assert (c["rank"], c["size"], c["device"]) == (p, P, "cpu")
        assert c["sum"] == P * (P + 1) / 2 and c["max"] == P - 1
        np.testing.assert_array_equal(c["gather"], np.concatenate(blocks))
        # the halo wraps around the ring, as lax.ppermute does
        np.testing.assert_array_equal(c["left"], blocks[(p - 1) % P][-2:])
        np.testing.assert_array_equal(c["right"], blocks[(p + 1) % P][:2])
        np.testing.assert_array_equal(c["shift"], blocks[(p + 1) % P])


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("form", ["gspmd", "ring"])
def test_ell_route_products(results, inputs, P, form):
    W, X = inputs["W"], inputs["X"]
    ref = W @ X
    jmesh = jpar.make_mesh()
    g = jpar.shard_graph(JSparseGraph.from_scipy(W), jmesh)
    Xs = jpar.put_features(X, jmesh)
    jfn = jpar.sharded_spmm if form == "gspmd" else jpar.sharded_spmm_ring
    jout = np.asarray(jfn(g, Xs, jmesh))[:N]
    for res in results[P]:
        out = res["spmm"][form]
        assert out.shape[0] == -(-N // P) * P
        _close(out[:N], ref)
        _close(out[:N], jout)
        np.testing.assert_array_equal(out[N:], 0.0)
        np.testing.assert_allclose(res["spmm"]["deg"][:N],
                                   np.asarray(W.sum(1)).ravel(), rtol=1e-14)
        np.testing.assert_array_equal(res["spmm"]["diag"][:N], W.diagonal())


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_op_spmm(results, inputs, jmesh4, P):
    """K3 over the halo-extended X (the twin on the CPU), the long edge
    through the residual, against scipy and the JAX package's partitioned
    band (interpret mode) on its 4-device mesh."""
    W, X = inputs["W_band"], inputs["X_band"]
    ref = W @ X
    jop = make_sharded_op(W, jmesh4, R=64, WT=64, mode="f64",
                          interpret=True)
    Xp = jax.device_put(jnp.asarray(np.pad(X, ((0, jop.n - N_BAND), (0, 0)))),
                        NamedSharding(jmesh4, PartitionSpec("nodes", None)))
    jout = np.asarray(jops.spmm(jop, Xp))[:N_BAND]
    jpart = build_band_partition(W, P, R=64, WT=64, interpret=True)
    for res in results[P]:
        s = res["spmm"]
        geometry = (jpart.B, jpart.H, jpart.n_pad, len(jpart.res_rows) > 0)
        assert s["band_geometry"] == geometry
        assert s["band_residual"] == len(jpart.res_rows)
        _close(s["band"][:N_BAND], ref)
        _close(s["band"][:N_BAND], jout)
        np.testing.assert_array_equal(s["band"][N_BAND:], 0.0)
        _close(s["band_1d"][:N_BAND], ref[:, 0])
        np.testing.assert_array_equal(s["band_diag"][:N_BAND],
                                      W.diagonal())


@pytest.mark.parametrize("P", [2, 4])
def test_sharded_bucketed_hub_graph(results, inputs, jmesh4, P):
    W, X = inputs["W_hub"], inputs["X_hub"]
    ref = W @ X
    jg, _ = jbuck(W, jmesh4, "nodes", 4)
    jout = np.asarray(jg.spmm_(jnp.asarray(np.pad(X, ((0, jg.n - N),
                                                      (0, 0))))))[:N]
    deg = np.diff(W.indptr)
    for res in results[P]:
        s = res["spmm"]
        kcap, n_spill = s["bucketed_kcap"]
        assert kcap == jg.k and kcap < deg.max()
        _close(s["bucketed"][:N], ref)
        _close(s["bucketed"][:N], jout)
        np.testing.assert_allclose(s["bucketed_deg"][:N],
                                   np.asarray(W.sum(1)).ravel(), rtol=1e-14)
        np.testing.assert_array_equal(s["bucketed_diag"][:N], W.diagonal())
    # each rank keeps only its own rows' spill; together, all of it
    assert sum(r["spmm"]["bucketed_kcap"][1] for r in results[P]) == int(
        np.maximum(deg - kcap, 0).sum())


def _free_port():
    s = socket.socket()
    try:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def test_initialize_distributed_over_tcp(tmp_path):
    """Two processes join over ``tcp://`` loopback through
    ``initialize_distributed`` (gloo on the CPU), sum a tensor and build
    a two-rank mesh."""
    try:
        port = _free_port()
    except OSError:
        pytest.skip("no loopback sockets on this machine")
    out = ranks.run_ranks(
        {2: [("init", ranks.case_initialize, {"port": port})]}, tmp_path,
        init=None)
    for rank, res in enumerate(out[2]):
        r = res["init"]
        if "skip" in r:
            pytest.skip(f"loopback rendezvous refused: {r['skip']}")
        assert r == {"backend": "gloo", "rank": rank, "size": 2,
                     "sum": 3.0, "again": True}


def test_no_group_initialize_is_a_no_op(monkeypatch):
    import torch.distributed as dist

    monkeypatch.delenv("MASTER_ADDR", raising=False)
    tgl.parallel.initialize_distributed()
    assert not dist.is_initialized()
