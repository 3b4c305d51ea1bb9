"""The five sharded families (``model.distribute(cfg).fit``) on spawned gloo
ranks at P = 2 and 4, on the "gspmd" (ELL rows, all-gathered X) and the
"banded" (K1, K3 and the ring halo, on the kernels' CPU twins) routes,
held to the JAX package's sharded fits on its 4-device CPU mesh: Laplace
(combinatorial and normalized) and Poisson CG at tol 1e-10 within 1e-7 of
max|u| (two CG solves of one
system stopped at their tolerance; JAX's own sharded tests allow 1e-7 /
1e-6), random walk within 1e-9 (tol 1e-10), gradient descent within
1e-10 with JAX's iteration count, PoissonMBO's one-hot labels equal, and
every prediction equal.  A directed graph's gradient descent (the
operator on ``W.T``, the degrees the row sums of W) on the ranks at P = 2.
In one process: ``distribute(None)`` and dynamic label propagation's
warning.  The other families' sharded fits are held in
``test_torch_sharded_families.py``.

The ranks run ``tests/test_torch_ranks.py`` (no JAX there), one spawn for
both world sizes.
"""

import warnings

import jax
import numpy as np
import pytest

import graphlearning_tpu as jgl
from graphlearning_tpu.config import GLTConfig as JConfig
from graphlearning_tpu.parallel import execute as jexec

import graphlearning_tpu_torch as tgl
from tests import test_torch_ranks as ranks

ROUTES = ("gspmd", "banded")
JAX_FITS = {
    "laplace": lambda W, priors: jgl.ssl.laplace(W, tol=1e-10),
    "laplace_normalized": lambda W, priors: jgl.ssl.laplace(
        W, normalization="normalized", tol=1e-10),
    "randomwalk": lambda W, priors: jgl.ssl.randomwalk(W),
    "poisson": lambda W, priors: jgl.ssl.poisson(W, tol=1e-10),
    "poisson_gd": lambda W, priors: jgl.ssl.poisson(
        W, solver="gradient_descent"),
    "poisson_mbo": lambda W, priors: jgl.ssl.poisson_mbo(
        W, class_priors=priors),
}
ATOL = {"laplace": 1e-7, "laplace_normalized": 1e-7, "poisson": 1e-7,
        "randomwalk": 1e-9, "poisson_gd": 1e-10, "poisson_mbo": 0.0}
# The JAX package's banded normalized Laplace fit returns the boundary
# values alone: a padding row's D^-1/2 is inf, its dense tiles' zero
# cells multiply it into NaN, and the CG's guarded step sizes fall to 0.
# The port zeroes X's padding rows before K3 (ShardedOp.halo_x); both
# routes are held to JAX's ELL route.
REFERENCE_ROUTE = {"laplace_normalized": "gspmd"}


def _clusters(n, ncls, dim, k, seed, symmetrize=True):
    from scipy.sparse.csgraph import connected_components

    rs = np.random.RandomState(seed)
    centers = rs.randn(ncls, dim) * 1.8
    labels = rs.randint(0, ncls, n)
    X = centers[labels] + rs.randn(n, dim)
    W = jgl.weightmatrix.knn(X, k, symmetrize=symmetrize)
    assert connected_components(W, directed=False)[0] == 1
    ti = np.concatenate([rs.choice(np.where(labels == c)[0], 5,
                                   replace=False) for c in range(ncls)])
    return W, labels, ti


@pytest.fixture(scope="module")
def clusters():
    """n = 603, not a multiple of 2 or 4 (mesh padding)."""
    W, labels, ti = _clusters(603, 3, 5, 10, seed=0)
    return W, labels, ti, np.bincount(labels) / len(labels)


@pytest.fixture(scope="module")
def directed():
    W, labels, ti = _clusters(241, 2, 4, 8, seed=3, symmetrize=False)
    assert (W != W.T).nnz > 0
    return W, labels, ti


@pytest.fixture(scope="module")
def both(clusters, directed, tmp_path_factory):
    """The ranks' fits and the JAX package's, the JAX fits computed while
    the ranks run."""
    W, labels, ti, priors = clusters
    cases = [(route, ranks.case_fits, {"W": W, "ti": ti, "labels": labels,
                                       "priors": priors, "kernel": route})
             for route in ROUTES]
    Wd, ld, tid = directed
    directed_case = ("directed", ranks.case_fits, {
        "W": Wd, "ti": tid, "labels": ld, "priors": None,
        "kernel": "gspmd", "names": ("poisson_gd",)})
    running = ranks.Ranks({2: cases + [directed_case], 4: cases},
                          tmp_path_factory.mktemp("fits"))
    jax_fits = {}
    for route in ROUTES:
        cfg = JConfig(mesh_shape=(4,), devices=jax.devices()[:4],
                      sharded_kernel=route)
        for name, make in JAX_FITS.items():
            if REFERENCE_ROUTE.get(name, route) != route:
                continue
            m = make(W, priors).distribute(cfg)
            u = m.fit(ti, labels[ti])
            jax_fits[route, name] = (np.asarray(u), m.predict(), m)
    return running.results(), jax_fits


@pytest.fixture(scope="module")
def ranked(both):
    return both[0]


@pytest.fixture(scope="module")
def jax_fits(both):
    return both[1]


def _jax_gd_iters(m, W, labels, ti, iters):
    """The JAX sharded gradient descent's step count, bracketed: its
    solution stops changing at ``iters`` steps and not at one fewer."""
    Wn = m._nodiag_graph()[0]
    k = len(np.unique(labels[ti]))
    onehot = np.eye(k)[labels[ti]]
    source = np.zeros((W.shape[0], k))
    source[ti] = onehot - onehot.mean(0)

    def run(max_iter):
        return jexec.poisson_gd_fit_sharded(m._dist, Wn, source, ti,
                                            m.min_iter, max_iter)

    full = run(m.max_iter)
    return (np.array_equal(run(iters), full)
            and not np.array_equal(run(iters - 1), full))


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", list(JAX_FITS))
def test_sharded_fit_matches_jax(ranked, jax_fits, clusters, P, route,
                                 name):
    W, labels, ti, _ = clusters
    ju, jpred, jm = jax_fits[REFERENCE_ROUTE.get(name, route), name]
    for rank_results in ranked[P]:
        u, pred, iters, got_route = rank_results[route][name]
        assert got_route == route
        np.testing.assert_allclose(u, ju, rtol=0,
                                   atol=ATOL[name] * np.abs(ju).max())
        np.testing.assert_array_equal(pred, jpred)
    if name == "poisson_gd":
        assert iters < jm.max_iter            # the mixing test stopped it
        assert _jax_gd_iters(jm, W, labels, ti, iters)


def test_directed_gradient_descent(ranked, directed):
    """JAX's contract for a directed graph: ``D^-1 W^T`` steps on the
    ranks equal the JAX package's sharded and the port's one-device fit."""
    W, labels, ti = directed
    jm = jgl.ssl.poisson(W, solver="gradient_descent").distribute(
        JConfig(mesh_shape=(4,), devices=jax.devices()[:4]))
    ju = np.asarray(jm.fit(ti, labels[ti]))
    one = tgl.ssl.poisson(W, solver="gradient_descent", device="cpu")
    tu = one.fit(ti, labels[ti])
    for rank_results in ranked[2]:
        u, pred, iters, route = rank_results["directed"]["poisson_gd"]
        assert route == "gspmd" and iters == one.iters
        np.testing.assert_allclose(u, ju, rtol=0, atol=1e-10 * abs(ju).max())
        np.testing.assert_allclose(u, tu, rtol=0, atol=1e-10 * abs(tu).max())
        np.testing.assert_array_equal(pred, jm.predict())


def test_distribute_none_and_world_size_one(clusters):
    """``distribute`` with no process group is a one-rank mesh; None
    undoes it.  The fit equals the one-device fit."""
    W, labels, ti, _ = clusters
    cfg = tgl.GLTConfig(devices="cpu")
    m = tgl.ssl.laplace(W, tol=1e-10, device="cpu").distribute(cfg)
    assert m._dist.P == 1 and m._dist.mesh.group is None
    u = m.fit(ti, labels[ti])
    assert m._dist.route == "gspmd"      # "auto" takes the band on CUDA only
    ref = tgl.ssl.laplace(W, tol=1e-10, device="cpu").fit(ti, labels[ti])
    np.testing.assert_allclose(u, ref, rtol=0, atol=1e-12)
    assert m.distribute(None) is m and m._dist is None
    pm = tgl.ssl.poisson_mbo(W, device="cpu").distribute(cfg)
    assert pm.poisson_model._dist is pm._dist
    pm.distribute(None)
    assert pm.poisson_model._dist is None


def test_dynamic_label_propagation_warns(clusters):
    W, _, _, _ = clusters
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        tgl.ssl.dynamic_label_propagation(W, device="cpu").distribute(
            tgl.GLTConfig(devices="cpu"))
    assert any("no sharded execution path" in str(w.message) for w in rec)
    with pytest.raises(NotImplementedError):
        tgl.ssl.dynamic_label_propagation(W, device="cpu").distribute(
            tgl.GLTConfig(devices="cpu"), strict=True)
