"""Laplace, Poisson and random-walk learning of graphlearning_tpu_torch
against graphlearning_tpu on the CPU.

Plain path: identical predictions at the default solver tolerances, and
``u`` allclose at float64 once CG is run to 1e-10 (at a loose tolerance
the stopping iterate carries rounding differences amplified by CG, up to
the tolerance's scale).  Band
path forced on in both packages (the Pallas kernels in interpret mode, the
torch kernels through their twins): ``u`` within float32 tolerance and
identical predictions.
"""

import numpy as np
import pytest
import torch

import graphlearning_tpu as jgl
from graphlearning_tpu.ops import accel as jaccel
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch.ops import accel as taccel
from graphlearning_tpu_torch.ops import band_spmm as tbs

torch.set_num_threads(2)


def _moons(n, noise, seed):
    rs = np.random.RandomState(seed)
    t = np.linspace(0, np.pi, n // 2)
    X = np.vstack([np.stack([np.cos(t), np.sin(t)], 1),
                   np.stack([1 - np.cos(t), 1 - np.sin(t) - 0.5], 1)])
    y = np.repeat([0, 1], n // 2)
    perm = rs.permutation(n)
    return X[perm] + rs.normal(scale=noise, size=(n, 2)), y[perm]


@pytest.fixture(scope="module")
def moons():
    X, y = _moons(600, 0.1, seed=0)
    W = jgl.weightmatrix.knn(X, 10)
    train_ind = jgl.trainsets.generate(y, rate=5, seed=0)
    return W, y, train_ind


MODELS = {
    "laplace": lambda gl, W, **kw: gl.ssl.laplace(W, **kw),
    "laplace_normalized": lambda gl, W, **kw: gl.ssl.laplace(
        W, normalization="normalized", **kw),
    "laplace_tau_order2": lambda gl, W, **kw: gl.ssl.laplace(
        W, tau=0.1, order=2, mean_shift=True, **kw),
    "poisson": lambda gl, W, **kw: gl.ssl.poisson(W, **kw),
    "poisson_gd": lambda gl, W, **kw: gl.ssl.poisson(
        W, solver="gradient_descent", **kw),
    "randomwalk": lambda gl, W, **kw: gl.ssl.randomwalk(W, **kw),
}


CG_MODELS = {"laplace", "laplace_normalized", "laplace_tau_order2",
             "poisson"}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_plain_path_matches_jax(moons, name):
    W, y, ti = moons
    jm = MODELS[name](jgl, W)
    jpred = jm.fit_predict(ti, y[ti])
    tm = MODELS[name](tgl, W, device="cpu")
    tpred = tm.fit_predict(ti, y[ti])
    assert tm.prob.dtype == np.float64 and tm.iters > 0
    np.testing.assert_array_equal(tpred, jpred)
    assert tgl.ssl.ssl_accuracy(tpred, y, ti) == \
        jgl.ssl.ssl_accuracy(jpred, y, ti)
    kw = {"tol": 1e-10} if name in CG_MODELS else {}
    jm = MODELS[name](jgl, W, **kw)
    jm.fit(ti, y[ti])
    tm = MODELS[name](tgl, W, device="cpu", **kw)
    tm.fit(ti, y[ti])
    np.testing.assert_allclose(tm.prob, jm.prob, rtol=1e-8,
                               atol=1e-10 * np.abs(jm.prob).max())


def test_class_priors_projection_matches_jax(moons):
    W, y, ti = moons
    priors = [0.3, 0.7]
    jm = jgl.ssl.poisson(W, class_priors=priors)
    tm = tgl.ssl.poisson(W, class_priors=priors, device="cpu")
    np.testing.assert_array_equal(tm.fit_predict(ti, y[ti]),
                                  jm.fit_predict(ti, y[ti]))
    np.testing.assert_allclose(tm.weights, jm.weights, rtol=1e-10)


def test_unported_options_raise(moons):
    W = moons[0]
    with pytest.raises(NotImplementedError):
        tgl.ssl.poisson(W, solver="spectral", device="cpu")
    with pytest.raises(NotImplementedError):
        tgl.ssl.poisson_mbo(W, [0.5, 0.5], "spectral", device="cpu")
    with pytest.raises(RuntimeError):
        tgl.ssl.laplace(W, device="cpu").predict()


@pytest.fixture(scope="module")
def moons_points():
    """The points of the ``moons`` graph."""
    return _moons(600, 0.1, seed=0)[0]


# Calls that bind the JAX package's parameters by position, the same in
# both packages (the port takes ``device`` last, by keyword).
POSITIONAL = {
    # (W, class_priors, solver, p, use_cuda): the GD defaults after them
    "poisson_gd": lambda gl, W, X, **kw: gl.ssl.poisson(
        W, None, "gradient_descent", 1, False, **kw),
    # ... then min_iter, max_iter, tol and spectral_cutoff
    "poisson_cg": lambda gl, W, X, **kw: gl.ssl.poisson(
        W, None, "conjugate_gradient", 1, False, 50, 1000, 1e-10, 10,
        **kw),
    # (W, class_priors, X)
    "laplace_X": lambda gl, W, X, **kw: gl.ssl.laplace(W, None, X, **kw),
    # ... then reweighting, normalization, tau, order, mean_shift, tol,
    # alpha, zeta and r
    "laplace_normalized": lambda gl, W, X, **kw: gl.ssl.laplace(
        W, None, X, "none", "normalized", 0, 1, False, 1e-10, 3, 1e6, 0.2,
        **kw),
}


@pytest.mark.parametrize("name", sorted(POSITIONAL))
def test_positional_parameters_match_jax(moons, moons_points, name):
    """The same positional call gives JAX's predictions and ``u``
    (allclose at f64; ``laplace_X`` stops CG at its default 1e-5, so its
    ``u`` is held to that scale), and stores the same parameters."""
    W, y, ti = moons
    X = moons_points
    jm = POSITIONAL[name](jgl, W, X)
    tm = POSITIONAL[name](tgl, W, X, device="cpu")
    np.testing.assert_array_equal(tm.fit_predict(ti, y[ti]),
                                  jm.fit_predict(ti, y[ti]))
    assert tm.iters > 0
    scale = np.abs(jm.prob).max()
    atol = 1e-5 * scale if name == "laplace_X" else 1e-10 * scale
    np.testing.assert_allclose(tm.prob, jm.prob, rtol=0, atol=atol)
    names = (("solver", "p", "min_iter", "max_iter", "tol",
              "spectral_cutoff") if name.startswith("poisson") else
             ("reweighting", "normalization", "tau", "order", "mean_shift",
              "tol", "alpha", "zeta", "r"))
    for attr in names:
        np.testing.assert_array_equal(np.unique(getattr(tm, attr)),
                                      np.unique(getattr(jm, attr)), attr)
    if name.startswith("laplace"):
        assert tm.X is X and jm.X is X


@pytest.fixture
def band_forced(monkeypatch):
    """Band path on in both packages at this small size."""
    monkeypatch.setattr(jaccel, "_MIN_N", 1)
    monkeypatch.setattr(jaccel, "enabled", lambda: True)
    monkeypatch.setenv("GLT_ACCEL_INTERPRET", "1")
    monkeypatch.setattr(taccel, "_MIN_N", 1)
    monkeypatch.setattr(taccel, "enabled", lambda device: True)


@pytest.mark.parametrize("name", ["laplace", "laplace_normalized", "poisson",
                                  "poisson_gd", "randomwalk"])
def test_band_path_matches_jax(moons, band_forced, name):
    W = moons[0].copy()          # fresh object: no plan caches from others
    y, ti = moons[1], moons[2]
    jm = MODELS[name](jgl, W)
    jpred = jm.fit_predict(ti, y[ti])
    tm = MODELS[name](tgl, W, device="cpu")
    tpred = tm.fit_predict(ti, y[ti])
    acc = getattr(tm, "_accel_gd" if name == "poisson_gd"
                  else "_accel_cache")
    assert isinstance(acc, taccel.AccelSpMM) and acc.packed
    # the JAX band runs in float32: hold the port to float32 accuracy
    scale = np.abs(jm.prob).max()
    np.testing.assert_allclose(tm.prob, jm.prob, rtol=0, atol=2e-4 * scale)
    np.testing.assert_array_equal(tpred, jpred)


def test_unpacked_band_path_matches_plain(moons, band_forced, monkeypatch):
    W = moons[0].copy()
    y, ti = moons[1], moons[2]
    monkeypatch.setenv("GLT_NO_PACKED", "1")
    tm = tgl.ssl.laplace(W, tol=1e-10, device="cpu")
    pred = tm.fit_predict(ti, y[ti])
    assert isinstance(tm._accel_cache.plan, tbs.TilesPlan)
    ref = tgl.ssl.laplace(moons[0].copy(), tol=1e-10, device="cpu")
    monkeypatch.setattr(taccel, "enabled", lambda device: False)
    ref_pred = ref.fit_predict(ti, y[ti])
    np.testing.assert_allclose(tm.prob, ref.prob, rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(pred, ref_pred)
