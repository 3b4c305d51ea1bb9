"""The rectangular band route of graphlearning_tpu_torch's AccelSpMM
against graphlearning_tpu and the plain path, on the CPU.

Off the tiled band (``materialize=False``, ``GLT_NO_BAND`` or a graph over
the size gate) the port plans a ``BandedPlan`` (K6, no stored band) or,
with ``materialize=True``, a ``RectPlan`` (K4 band, K5 matvec, K8
distance rounds).  The kernels' twins are held against the Pallas kernels
in ``test_torch_band_spmm.py`` and the CUDA kernels against the twins in
``test_torch_cuda_kernels.py``.
"""

import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp
from scipy.sparse.csgraph import reverse_cuthill_mckee
from scipy.spatial import cKDTree

import graphlearning_tpu as jgl
import graphlearning_tpu_torch as tgl
from graphlearning_tpu.ops import accel as jaccel
from graphlearning_tpu.solvers import eikonal as jeik
from graphlearning_tpu_torch import ssl as tssl
from graphlearning_tpu_torch.ops import accel as taccel
from graphlearning_tpu_torch.ops import band_spmm as tbs
from graphlearning_tpu_torch.solvers import eikonal as teik
from graphlearning_tpu_torch.solvers import plaplace as tpl

torch.set_num_threads(2)


def _knn_csr(n, k, seed):
    rs = np.random.RandomState(seed)
    pts = rs.rand(n, 2)
    dist, ind = cKDTree(pts).query(pts, k=k + 1)
    dist, ind = dist[:, 1:], ind[:, 1:]
    w = np.exp(-4 * dist ** 2 / np.maximum(dist[:, -1:] ** 2, 1e-12))
    W = sp.csr_matrix((w.ravel(), (np.repeat(np.arange(n), k), ind.ravel())),
                      shape=(n, n))
    W = ((W + W.T) / 2).tocsr()
    W._glt_points = pts
    return W


@pytest.fixture(scope="module")
def knn_900():
    return _knn_csr(900, 10, seed=3)


def _plan_of(materialize):
    return tbs.RectPlan if materialize else tbs.BandedPlan


@pytest.fixture
def small_rect(monkeypatch):
    """GLT_NO_BAND, and 128-row blocks and tiles: at this size the window
    then leaves edges to the residual."""
    monkeypatch.setenv("GLT_NO_BAND", "1")
    monkeypatch.setattr(taccel, "_RECT_R", 128)
    monkeypatch.setattr(taccel, "_RECT_WT", 128)


@pytest.mark.parametrize("materialize", [False, True])
def test_accel_spmm_matches_jax_and_scipy(knn_900, small_rect, materialize):
    """``spmm`` in original order on each plan of the rectangular route:
    1e-10 of scipy (the twins run in f64 on the CPU) and 2e-4 of JAX's
    own route at the same geometry (its band is f32)."""
    W = knn_900
    acc = taccel.AccelSpMM(W, device="cpu", materialize=materialize)
    assert type(acc.plan) is _plan_of(materialize)
    assert acc.materialize == materialize and acc.tiles_plan is None
    assert len(acc.plan.winstart_host) == acc.n_pad // acc.R
    assert acc.plan.W < acc.n_pad and acc.n_resid > 0
    X = np.random.RandomState(4).randn(900, 6)
    out = acc.from_perm(acc.spmm(acc.to_perm(torch.as_tensor(X)))).numpy()
    jacc = jaccel.AccelSpMM(W, interpret=True, materialize=materialize,
                            R=128, WT=128)
    assert jacc.materialize == materialize and jacc._tiles is None
    ref = np.asarray(jacc.from_perm(jacc.spmm(jacc.to_perm(
        jnp.asarray(X, jnp.float32)))))
    np.testing.assert_allclose(out, W @ X, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)


def test_banded_plan_without_the_knob(knn_900):
    """``materialize=False`` leaves the tiled band with no knob set: the
    JAX package's non-band geometry and RCM order, no stored band."""
    acc = taccel.AccelSpMM(knn_900, device="cpu", materialize=False)
    assert isinstance(acc.plan, tbs.BandedPlan)
    assert (acc.R, acc.WT) == (taccel._RECT_R, taccel._RECT_WT)
    assert acc.band_bytes == 0 == acc.matvec_band_bytes
    perm = np.asarray(reverse_cuthill_mckee(knn_900, symmetric_mode=True))
    np.testing.assert_array_equal(acc._perm_dev.numpy()[:900], perm)
    with pytest.raises(ValueError, match="stores no band"):
        acc.band()


def test_rect_route_orders_by_rcm_only(monkeypatch):
    """Off the tiled band only RCM is tried, as in the JAX package: the
    Hilbert order of the attached points is not even computed."""
    W = _knn_csr(8192, 6, seed=5)
    calls = []
    monkeypatch.setattr(taccel, "hilbert_order_2d",
                        lambda pts: calls.append(1) or np.arange(len(pts)))
    acc = taccel.AccelSpMM(W, device="cpu", materialize=False)
    assert not calls and isinstance(acc.plan, tbs.BandedPlan)
    perm = np.asarray(reverse_cuthill_mckee(W, symmetric_mode=True))
    np.testing.assert_array_equal(acc._perm_dev.numpy()[:8192], perm)


def test_rect_plan_reuses_its_band_and_refuses_over_budget(knn_900,
                                                           monkeypatch):
    """A RectPlan's band serves the matvec, the distance rounds and the
    block-Gauss-Seidel sweeps, built once; over the band budget the plan
    raises with the byte counts (JAX allocates it all the same)."""
    monkeypatch.setenv("GLT_NO_BAND", "1")
    acc = taccel.AccelSpMM(knn_900, device="cpu", materialize=True)
    assert acc.band_bytes == acc.rect_band_bytes() > 0
    assert acc.rect_band_ok()
    assert acc._rect_band()[0] is acc.band()
    with pytest.raises(ValueError, match="tiled band"):
        acc.lip_iterate_mc(np.zeros((900, 2)), np.zeros(900, bool),
                           np.zeros((900, 2)), 0.5, 0.5, 0.0, 5)
    monkeypatch.setattr(taccel, "_band_budget_bytes",
                        lambda dev: acc.band_bytes - 1)
    with pytest.raises(taccel.BandPlanUnavailable,
                       match=re.escape(f"{acc.band_bytes:.3g} B")):
        taccel.AccelSpMM(knn_900, device="cpu", materialize=True)


def test_bellman_ford_on_the_rect_plan_matches_jax(knn_900, small_rect):
    """K8's twin in bellman_ford (plain, reciprocal, Hopf-Lax) against the
    port's plain path at f64 and JAX's band_minplus route at f32; where
    the closest points differ, both seeds are equidistant."""
    W = knn_900
    seeds = np.random.RandomState(3).choice(900, 7, replace=False)
    acc = taccel.AccelSpMM(W, device="cpu", materialize=True)
    tg = tgl.SparseGraph.from_scipy(W, device="cpu")
    for kw in ({}, {"reciprocal_weights": True}, {"hopf_lax": True}):
        solve = teik.dijkstra_hl if kw.get("hopf_lax") else teik.dijkstra
        kw2 = {k: v for k, v in kw.items() if k != "hopf_lax"}
        info = {}
        d_b, cp_b = solve(tg, seeds, bdy_val=np.zeros(7), return_cp=True,
                          accel=acc, info=info, **kw2)
        assert info["path"] == "band"
        d_p, cp_p = solve(tg, seeds, bdy_val=np.zeros(7), return_cp=True,
                          **kw2)
        np.testing.assert_allclose(d_b, d_p, rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(cp_b, cp_p)
    jacc = jaccel.AccelSpMM(W, interpret=True, materialize=True, R=128,
                            WT=128)
    assert jacc._tiles is None and jacc.materialize
    d_j, cp_j = jeik.dijkstra(jgl.SparseGraph.from_scipy(W), seeds,
                              bdy_val=np.zeros(7), return_cp=True,
                              accel=jacc)
    d_b, cp_b = teik.dijkstra(tg, seeds, bdy_val=np.zeros(7),
                              return_cp=True, accel=acc)
    np.testing.assert_allclose(d_b, d_j, rtol=1e-5, atol=1e-6)
    dm = np.stack([teik.dijkstra(tg, [s]) for s in seeds])
    pos = {s: i for i, s in enumerate(seeds)}
    for i in np.nonzero(cp_b != cp_j)[0]:
        np.testing.assert_allclose(dm[pos[cp_b[i]], i], dm[pos[cp_j[i]], i],
                                   rtol=1e-5)


@pytest.mark.parametrize("materialize", [False, True])
def test_laplace_constrained_per_plan_matches_plain(knn_900, small_rect,
                                                    materialize):
    """One masked CG Laplace solve on each plan of the route against the
    plain ELL solve, at f64."""
    W = knn_900
    acc = taccel.AccelSpMM(W, device="cpu", materialize=materialize)
    G = tgl.graph(W, device="cpu")
    rs = np.random.RandomState(6)
    ti = rs.choice(900, 10, replace=False)
    mask = np.zeros(900, bool)
    mask[ti] = True
    bdy = np.zeros((900, 2))
    bdy[ti] = np.eye(2)[np.arange(10) % 2]
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    u_ref, _ = tssl._laplace_constrained(
        G.sparse, as_t(np.zeros(900)), torch.as_tensor(mask), as_t(bdy),
        1e-10)
    u, iters = tpl._laplace_init(acc, G.sparse, mask, bdy, tol=1e-10)
    assert iters > 5
    np.testing.assert_allclose(u.numpy(), u_ref.numpy(), rtol=1e-8,
                               atol=1e-10)


@pytest.fixture
def band_forced(monkeypatch):
    monkeypatch.setattr(taccel, "_MIN_N", 1)
    monkeypatch.setattr(taccel, "enabled", lambda device: True)


def test_maybe_build_plan_choice_and_cache_keys(knn_900, band_forced,
                                                monkeypatch):
    """Over the size gate maybe_build takes a BandedPlan (it returned None
    before); GLT_NO_BAND and materialize enter both cache keys, so a graph
    cached on the tiled band does not answer a call made under the knob."""
    W = knn_900.copy()
    W._glt_points = knn_900._glt_points
    holder = type("Holder", (), {})()
    tiles = taccel.maybe_build(W, cache_obj=holder, device="cpu")
    assert isinstance(tiles.plan, tbs.PackedPlan) and tiles.materialize
    monkeypatch.setenv("GLT_NO_BAND", "1")
    banded = taccel.maybe_build(W, cache_obj=holder, device="cpu")
    assert isinstance(banded.plan, tbs.BandedPlan) and not banded.materialize
    assert holder._accel_cache is banded
    rect = taccel.maybe_build(W, device="cpu", materialize=True)
    assert isinstance(rect.plan, tbs.RectPlan)
    monkeypatch.delenv("GLT_NO_BAND")
    assert taccel.maybe_build(W, cache_obj=holder, device="cpu") is tiles
    # a budget under n * 5120 * 4 bytes: the size gate
    monkeypatch.setattr(taccel, "_band_budget_bytes",
                        lambda dev: 900 * 5120 * 4 - 1)
    over = taccel.maybe_build(W.copy(), device="cpu")
    assert isinstance(over.plan, tbs.BandedPlan)


def test_solver_gates_keep_a_banded_plan_on_the_plain_path(knn_900):
    """Without a stored band the distances and the Lipschitz fits take the
    plain path, as in the JAX package; bellman_ford and lip_iterate_mc
    refuse a BandedPlan."""
    acc = taccel.AccelSpMM(knn_900, device="cpu", materialize=False)
    tg = tgl.SparseGraph.from_scipy(knn_900, device="cpu")
    info = {}
    d = teik.dijkstra(tg, [1, 50], accel=acc, info=info)
    assert info["path"] == "plain"
    np.testing.assert_array_equal(d, teik.dijkstra(tg, [1, 50]))
    assert not tpl._use_band(acc, 2)
    info = {}
    bdy = np.array([1, 50, 300, 600])
    vals = np.eye(2)[np.arange(4) % 2]
    tpl.amle_mc(tg, bdy, vals, tol=1e-3, max_num_it=50, weighted=False,
                accel=acc, info=info)
    assert info["path"] == "plain" and acc._rect is None
    with pytest.raises(ValueError, match="BandedPlan"):
        acc.bellman_ford(np.zeros(900), np.ones(900))
    with pytest.raises(ValueError, match="tiled band"):
        acc.lip_iterate_mc(np.zeros((900, 2)), np.zeros(900, bool),
                           np.zeros((900, 2)), 0.5, 0.5, 0.0, 5)


def test_ssl_fits_under_the_knob_match_plain(knn_900, band_forced,
                                              monkeypatch):
    """laplace and poisson through the ssl entry points on a BandedPlan
    predict as the plain path, at f64."""
    monkeypatch.setenv("GLT_NO_BAND", "1")
    W = knn_900
    y = (W._glt_points[:, 0] > 0.5).astype(int)
    ti = np.random.RandomState(8).choice(900, 20, replace=False)
    for make in (lambda W: tgl.ssl.laplace(W, tol=1e-10, device="cpu"),
                 lambda W: tgl.ssl.poisson(W, tol=1e-10, device="cpu")):
        m = make(W.copy())
        pred = m.fit_predict(ti, y[ti])
        assert isinstance(m._accel_cache.plan, tbs.BandedPlan)
        with monkeypatch.context() as mp:
            mp.setattr(taccel, "enabled", lambda device: False)
            ref = make(W.copy())
            ref_pred = ref.fit_predict(ti, y[ti])
        np.testing.assert_allclose(m.prob, ref.prob, rtol=1e-7, atol=1e-9)
        np.testing.assert_array_equal(pred, ref_pred)
