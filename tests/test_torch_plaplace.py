"""p-Laplace and AMLE of graphlearning_tpu_torch against graphlearning_tpu
on the CPU: the plain solvers at float64 within 1e-10 (the same Jacobi
rounds and stops), ``BucketedELL`` and the graph calculus within 1e-12,
the SSL models' predictions identical; the band path (block-Gauss-Seidel
sweeps, K9 Jacobi rounds) held to the plain fixed point at JAX's own
tolerance for it (rtol 2e-3, atol 2e-4)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import graphlearning_tpu as jgl
from graphlearning_tpu.core.sparse import BucketedELL as JBucketedELL
from graphlearning_tpu.ops import accel as jaccel
from graphlearning_tpu.ops import graphops as jops
from graphlearning_tpu.solvers import plaplace as jpl
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch.ops import accel as taccel
from graphlearning_tpu_torch.ops import graphops as tops
from graphlearning_tpu_torch.solvers import plaplace as tpl

from conftest import random_knn_csr

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-10)

# ``tests/test_distance_solvers.py`` deletes the JAX class's class-batched
# fit (``del type(m2)._fit_onevsrest``) to run its per-class loop, and
# restores nothing.  In a process that ran it first, JAX's ``ssl.plaplace``
# takes that loop, which stops at a different iterate (that test allows
# the two 5e-4 apart), and the comparison below would fail.  The method is
# kept here when the module is imported, at collection, and put back before
# each test of this file.
_JAX_PLAPLACE_FIT_ONEVSREST = jgl.ssl.plaplace.__dict__["_fit_onevsrest"]


def _restore_jax_plaplace():
    """Put JAX's ``ssl.plaplace._fit_onevsrest`` back where it is missing."""
    if "_fit_onevsrest" not in jgl.ssl.plaplace.__dict__:
        jgl.ssl.plaplace._fit_onevsrest = _JAX_PLAPLACE_FIT_ONEVSREST


@pytest.fixture(autouse=True)
def _jax_plaplace_intact():
    _restore_jax_plaplace()
    yield


def _skewed_csr(n, seed):
    """A kNN-like graph with a few hubs, so the ELL is much wider than
    its 95th-percentile degree and ``BucketedELL`` spills."""
    W = random_knn_csr(n, 6, seed=seed).tolil()
    rs = np.random.RandomState(seed)
    for hub in (0, 1, 2):
        for j in rs.choice(np.arange(3, n), 60, replace=False):
            W[hub, j] = W[j, hub] = 0.3 + rs.rand()
    return W.tocsr()


@pytest.fixture(scope="module")
def skewed():
    W = _skewed_csr(400, 5)
    return (W, jgl.SparseGraph.from_scipy(W),
            tgl.SparseGraph.from_scipy(W, device="cpu"))


SEEDS = np.array([5, 60, 123, 300, 350])
VALS = np.array([0.0, 1.0, 0.5, 0.2, 0.9])


def test_bucketed_ell_and_spill_reduce_match_jax(skewed):
    W = skewed[0]
    jb = JBucketedELL.from_scipy(W)
    tb = tgl.BucketedELL.from_scipy(W, device="cpu")
    assert tb.kcap == jb.kcap and tb.m == jb.m and tb.m > 0
    for a, b in ((tb.sp_rows, jb.sp_rows), (tb.sp_cols, jb.sp_cols),
                 (tb.sp_vals, jb.sp_vals), (tb.main.cols, jb.main.cols),
                 (tb.main.vals, jb.main.vals), (tb.main.deg, jb.main.deg)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    V = np.random.RandomState(1).randn(len(tb.sp_rows), 3)
    for kind, fill in (("sum", 0.0), ("min", 9.0), ("max", -9.0)):
        np.testing.assert_allclose(
            tb.spill_reduce(torch.as_tensor(V), kind, fill).numpy(),
            np.asarray(jb.spill_reduce(jnp.asarray(V), kind, fill)),
            rtol=1e-12, atol=1e-12)


def test_graph_calculus_matches_jax(skewed):
    _, jg, tg = skewed
    u = np.random.RandomState(2).randn(400)
    ut = torch.as_tensor(u)
    for weighted, p in ((True, 1.0), (True, 2.0), (False, 1.0)):
        gj = jops.gradient(jg, jnp.asarray(u), weighted=weighted, p=p)
        gt = tops.gradient(tg, ut, weighted=weighted, p=p)
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(
            tops.divergence(tg, gt, tops.build_mirror(tg), weighted=weighted,
                            p=p).numpy(),
            np.asarray(jops.divergence(jg, gj, jops.build_mirror(jg),
                                       weighted=weighted, p=p)),
            rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tops.infinity_laplacian(tg, ut).numpy(),
                               np.asarray(jops.infinity_laplacian(
                                   jg, jnp.asarray(u))), rtol=1e-12)
    W = skewed[0]
    jG, tG = jgl.graph(W), tgl.graph(W, device="cpu")
    np.testing.assert_allclose(tG.infinity_laplacian(u),
                               jG.infinity_laplacian(u), rtol=1e-12)
    np.testing.assert_allclose(tG.gradient(u, p=2).toarray(),
                               jG.gradient(u, p=2).toarray(), rtol=1e-12)
    V = jG.gradient(u, weighted=True)
    np.testing.assert_allclose(tG.divergence(V), jG.divergence(V),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("fast", [True, False])
def test_plaplace_matches_jax(skewed, fast):
    _, jg, tg = skewed
    np.testing.assert_allclose(
        tpl.plaplace(tg, SEEDS, VALS, 4, fast=fast),
        jpl.plaplace(jg, SEEDS, VALS, 4, fast=fast), **TOL)


@pytest.mark.parametrize("weighted", [True, False])
def test_amle_matches_jax(skewed, weighted):
    _, jg, tg = skewed
    np.testing.assert_allclose(
        tpl.amle(tg, SEEDS, VALS, weighted=weighted, max_num_it=300),
        jpl.amle(jg, SEEDS, VALS, weighted=weighted, max_num_it=300), **TOL)


BV = np.eye(5)[[0, 1, 2, 0, 1]][:, :3]       # three classes, one-hot


@pytest.mark.parametrize("bucketed", [False, True])
def test_lip_mc_variants_match_jax(skewed, bucketed):
    W, jg, tg = skewed
    jb = JBucketedELL.from_scipy(W) if bucketed else None
    tb = tgl.BucketedELL.from_scipy(W, device="cpu") if bucketed else None
    if bucketed:
        assert tg.k > 1.5 * tb.kcap
    info = {}
    np.testing.assert_allclose(
        tpl.plaplace_mc(tg, SEEDS, BV, 6, bucketed=tb, info=info),
        jpl.plaplace_mc(jg, SEEDS, BV, 6, bucketed=jb), **TOL)
    assert info["path"] == "plain" and info["iters"] > 20
    for weighted in (True, False):
        np.testing.assert_allclose(
            tpl.amle_mc(tg, SEEDS, BV, weighted=weighted, max_num_it=400,
                        bucketed=tb),
            jpl.amle_mc(jg, SEEDS, BV, weighted=weighted, max_num_it=400,
                        bucketed=jb), **TOL)
    np.testing.assert_allclose(
        tpl.plaplace_mc(tg, SEEDS, BV, 6, fast=False, tol=1e-3),
        jpl.plaplace_mc(jg, SEEDS, BV, 6, fast=False, tol=1e-3), **TOL)


def test_lip_iterate_internals_match_jax(skewed):
    _, jg, tg = skewed
    n = 400
    rs = np.random.RandomState(4)
    u0 = rs.rand(n, 2)
    mask = np.zeros(n, bool)
    mask[SEEDS] = True
    gv = np.zeros((n, 2))
    gv[SEEDS] = rs.rand(5, 2)
    uj = jpl._lip_iterate_mc(jg, jnp.asarray(u0), jnp.asarray(mask),
                             jnp.asarray(gv), 0.25, 0.75, 1e-9, 500)
    ut, rounds = tpl._lip_iterate_mc(tg, torch.as_tensor(u0),
                                     torch.as_tensor(mask),
                                     torch.as_tensor(gv), 0.25, 0.75, 1e-9,
                                     500)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), **TOL)
    uj = jpl._lip_iterate_weighted(jg, jnp.asarray(u0[:, 0]),
                                   jnp.asarray(mask), jnp.asarray(gv[:, 0]),
                                   1e-9, 50)
    ut, rounds = tpl._lip_iterate_weighted(
        tg, torch.as_tensor(u0[:, 0]), torch.as_tensor(mask),
        torch.as_tensor(gv[:, 0]), 1e-9, 50)
    assert rounds == 50
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), **TOL)
    uu, ul = jpl._lp_iterate(jg, jnp.ones(n), jnp.zeros(n), jnp.asarray(mask),
                             jnp.asarray(gv[:, 0]), 3.0, 1e-4, 200)
    tu, tl, _ = tpl._lp_iterate(tg, torch.ones(n, dtype=torch.float64),
                                torch.zeros(n, dtype=torch.float64),
                                torch.as_tensor(mask),
                                torch.as_tensor(gv[:, 0]), 3.0, 1e-4, 200)
    np.testing.assert_allclose(tu.numpy(), np.asarray(uu), **TOL)
    np.testing.assert_allclose(tl.numpy(), np.asarray(ul), **TOL)


@pytest.fixture(scope="module")
def moons():
    rs = np.random.RandomState(0)
    n = 600
    t = np.linspace(0, np.pi, n // 2)
    X = np.vstack([np.stack([np.cos(t), np.sin(t)], 1),
                   np.stack([1 - np.cos(t), 1 - np.sin(t) - 0.5], 1)])
    y = np.repeat([0, 1], n // 2)
    perm = rs.permutation(n)
    X, y = X[perm] + rs.normal(scale=0.1, size=(n, 2)), y[perm]
    W = jgl.weightmatrix.knn(X, 10)
    return W, y, jgl.trainsets.generate(y, rate=5, seed=0)


MODELS = {
    "plaplace": lambda gl, W, **kw: gl.ssl.plaplace(W, **kw),
    "plaplace_p4": lambda gl, W, **kw: gl.ssl.plaplace(W, p=4, **kw),
    "amle": lambda gl, W, **kw: gl.ssl.amle(W, **kw),
    "amle_weighted": lambda gl, W, **kw: gl.ssl.amle(W, weighted=True, **kw),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_ssl_models_predict_as_jax(moons, name):
    W, y, ti = moons
    jm = MODELS[name](jgl, W)
    tm = MODELS[name](tgl, W, device="cpu")
    np.testing.assert_array_equal(tm.fit_predict(ti, y[ti]),
                                  jm.fit_predict(ti, y[ti]))
    np.testing.assert_allclose(tm.prob, jm.prob, **TOL)
    assert tm.path == "plain" and tm.iters > 20


@pytest.mark.parametrize("name", ["plaplace", "plaplace_p4"])
def test_ssl_models_predict_as_jax_after_the_method_is_deleted(moons, name):
    """The comparison above after the JAX method is deleted as
    ``tests/test_distance_solvers.py`` deletes it: it holds once the method
    is put back, as the autouse fixture does before every test."""
    m2 = jgl.ssl.plaplace(moons[0], p=10)
    del type(m2)._fit_onevsrest
    try:
        _restore_jax_plaplace()
        assert "_fit_onevsrest" in jgl.ssl.plaplace.__dict__
        test_ssl_models_predict_as_jax(moons, name)
    finally:
        _restore_jax_plaplace()


@pytest.fixture
def band_forced(monkeypatch):
    """Band path on in both packages, at small tiles for this size."""
    monkeypatch.setattr(jaccel, "_MIN_N", 1)
    monkeypatch.setattr(jaccel, "enabled", lambda: True)
    monkeypatch.setenv("GLT_ACCEL_INTERPRET", "1")
    monkeypatch.setattr(taccel, "_MIN_N", 1)
    monkeypatch.setattr(taccel, "enabled", lambda device: True)
    monkeypatch.setattr(taccel, "_TILES_R", 256)
    monkeypatch.setattr(taccel, "_TILES_WT", 128)


@pytest.fixture(scope="module")
def lip_problem():
    W = random_knn_csr(2560, 10, seed=7)
    n = W.shape[0]
    rs = np.random.RandomState(1)
    bdy = np.sort(rs.choice(n, 20, replace=False))
    C = 3
    bdy_mask = np.zeros(n, bool)
    bdy_mask[bdy] = True
    gvals = np.zeros((n, C))
    gvals[bdy] = rs.rand(20, C)
    alpha = 1.0 / 7.0
    g = jgl.SparseGraph.from_scipy(W, dtype=jnp.float32)
    ref = np.asarray(jpl._lip_iterate_mc(
        g, jnp.zeros((n, C), jnp.float32), jnp.asarray(bdy_mask),
        jnp.asarray(gvals, jnp.float32), jnp.float32(alpha),
        jnp.float32(1.0 - alpha), jnp.float32(1e-6), 5000))
    return W, bdy_mask, gvals, alpha, ref


@pytest.mark.parametrize("packed", [True, False])
def test_band_lip_iterate_and_gs_match_plain(lip_problem, monkeypatch,
                                             packed):
    """lip_iterate_mc (K9 twin) and lip_gs_mc (K4 twin's band) reach the
    plain Jacobi fixed point of the JAX package."""
    monkeypatch.setattr(taccel, "_TILES_R", 128)
    monkeypatch.setattr(taccel, "_TILES_WT", 128)
    W, bdy_mask, gvals, alpha, ref = lip_problem
    n, C = gvals.shape
    acc = taccel.AccelSpMM(W, device="cpu", packed=packed)
    assert acc.packed == packed and acc._tiles_resid is not None
    u, rounds = acc.lip_iterate_mc(np.zeros((n, C)), bdy_mask, gvals, alpha,
                                   1.0 - alpha, 1e-6, 5000)
    assert 20 < rounds < 5000
    np.testing.assert_allclose(u.numpy(), ref, rtol=2e-3, atol=2e-4)
    assert acc.rect_band_ok()
    u, sweeps = acc.lip_gs_mc(np.zeros((n, C)), bdy_mask, gvals, alpha,
                              1.0 - alpha, 1e-6, 5000)
    assert 20 < sweeps < rounds
    np.testing.assert_allclose(u.numpy(), ref, rtol=2e-3, atol=2e-4)


def test_band_lip_gs_bf16_matches_plain(lip_problem, monkeypatch):
    """A bf16 band (JAX's choice for the SSL path; the port's takes f32):
    the sweeps stop and land within bf16's rounding of the weights."""
    monkeypatch.setattr(taccel, "_TILES_R", 128)
    monkeypatch.setattr(taccel, "_TILES_WT", 128)
    W, bdy_mask, gvals, alpha, ref = lip_problem
    n, C = gvals.shape
    acc = taccel.AccelSpMM(W, device="cpu", mode="bf16")
    assert acc._rect is None
    u, sweeps = acc.lip_gs_mc(np.zeros((n, C)), bdy_mask, gvals, alpha,
                              1.0 - alpha, 1e-5, 5000)
    assert acc._rect[0].dtype == torch.bfloat16 and 20 < sweeps < 5000
    np.testing.assert_allclose(u.numpy(), ref, rtol=0, atol=2e-2)


def test_rect_band_gating_refuses_over_budget(monkeypatch):
    """The rectangular band counts against the band budget beside the
    resident bands: over it, rect_band_ok() refuses, _rect_band raises,
    and amle_mc takes the Voronoi + Jacobi path without building it."""
    rs = np.random.RandomState(0)
    n = 1500
    W = jgl.weightmatrix.knn(rs.randn(n, 16), 8)    # high-dim: band-hostile
    monkeypatch.setattr(taccel, "_TILES_R", 128)
    monkeypatch.setattr(taccel, "_TILES_WT", 128)
    acc = taccel.AccelSpMM(W, device="cpu", mode="bf16")
    assert acc.rect_band_ok()
    # a budget that holds the matvec band but not the rectangular one too
    acc._budget = acc.rect_band_bytes() + acc.matvec_band_bytes - 1
    assert not acc.rect_band_ok()
    with pytest.raises(ValueError, match="rect_band_ok"):
        acc._rect_band()
    g = tgl.SparseGraph.from_scipy(W, device="cpu")
    bdy = rs.choice(n, 8, replace=False)
    vals = (np.arange(8) % 2).astype(float)[:, None]
    info = {}
    u = tpl.amle_mc(g, bdy, vals, tol=1e-3, max_num_it=200, weighted=False,
                    accel=acc, info=info)
    assert info["path"] == "plain" and acc._rect is None
    assert np.all(np.isfinite(u))
    np.testing.assert_allclose(
        u, jpl.amle_mc(jgl.SparseGraph.from_scipy(W), bdy, vals, tol=1e-3,
                       max_num_it=200, weighted=False), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["plaplace", "amle"])
def test_ssl_band_path_matches_plain(moons, band_forced, monkeypatch,
                                    name):
    """ssl.plaplace / ssl.amle on the band (harmonic start on the packed
    band, then block-Gauss-Seidel sweeps on the rectangular band) predict
    as the plain path and as JAX's plain path."""
    W, y, ti = moons[0].copy(), moons[1], moons[2]
    tm = MODELS[name](tgl, W, device="cpu")
    pred = tm.fit_predict(ti, y[ti])
    assert tm.path == "band" and tm._accel_dist.band_dtype == torch.float64
    monkeypatch.setattr(taccel, "enabled", lambda device: False)
    monkeypatch.setattr(jaccel, "enabled", lambda: False)
    ref = MODELS[name](tgl, moons[0].copy(), device="cpu")
    ref_pred = ref.fit_predict(ti, y[ti])
    assert ref.path == "plain"
    assert np.mean(pred == ref_pred) >= 0.99
    jpred = MODELS[name](jgl, moons[0].copy()).fit_predict(ti, y[ti])
    assert np.mean(pred == jpred) >= 0.99
