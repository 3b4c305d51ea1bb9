"""The eigenbasis SSL models of graphlearning_tpu_torch against
graphlearning_tpu on the CPU, at float64 (JAX's x64 on): Poisson learning's
spectral solver, PoissonMBO on it, Multiclass MBO and Modularity MBO.

* Fed the JAX package's own eigenpairs (``graph.eigen_decomp_device``
  replaced by JAX's ``graph.eigen_decomp`` of the same matrix), so the
  models' loops are compared alone: ``u`` within 1e-8 of JAX's and the
  predictions equal.
* End to end through the port's own ``eigen_decomp`` on JAX's LOBPCG start
  (``test_torch_eig.jax_start``): predictions equal on at least 99.5 % of
  the nodes.
* Positional calls in JAX's order, and the verbose paths.
"""

import numpy as np
import pytest
import torch

import graphlearning_tpu as jgl
import graphlearning_tpu_torch as tgl
from test_torch_eig import jax_start  # noqa: F401
from test_torch_mbo import moons  # noqa: F401

torch.set_num_threads(2)

# (name, maker); each maker takes the package, W, the priors and kwargs
MODELS = {
    "poisson_spectral": lambda gl, W, priors, **kw: gl.ssl.poisson(
        W, solver="spectral", **kw),
    "poisson_spectral_p2": lambda gl, W, priors, **kw: gl.ssl.poisson(
        W, solver="spectral", p=2, spectral_cutoff=6, **kw),
    "poisson_mbo_spectral": lambda gl, W, priors, **kw: gl.ssl.poisson_mbo(
        W, priors, solver="spectral", T=5, **kw),
    "multiclass_mbo": lambda gl, W, priors, **kw: gl.ssl.multiclass_mbo(
        W, num_eig=20, seed=3, **kw),
    "modularity_mbo": lambda gl, W, priors, **kw: gl.ssl.modularity_mbo(
        W, **kw),
}


_JAX_PAIRS = {}


@pytest.fixture
def jax_eigenpairs(monkeypatch):
    """The port's models on the JAX package's eigenpairs of the same
    matrix (each solve once a session)."""
    def eigen_decomp_device(self, normalization="combinatorial",
                            method="exact", k=10, c=None, gamma=0, tol=0,
                            q=1):
        W = self.weight_matrix
        key = (W.shape, W.nnz, float(W.sum()), normalization, method, k, c,
               gamma, tol, q)
        if key not in _JAX_PAIRS:
            _JAX_PAIRS[key] = jgl.graph(W).eigen_decomp(
                normalization=normalization, method=method, k=k, c=c,
                gamma=gamma, tol=tol, q=q)
        vals, vecs = _JAX_PAIRS[key]
        return torch.tensor(vals), torch.tensor(vecs)

    monkeypatch.setattr(tgl.graph, "eigen_decomp_device",
                        eigen_decomp_device)


def _fit(gl, name, moons, **kw):
    W, y, ti, priors = moons
    m = MODELS[name](gl, W, priors, **kw)
    m.fit(ti, y[ti])
    return m.prob, m.predict()


@pytest.mark.parametrize("name", sorted(MODELS))
def test_loops_on_jax_eigenpairs_match_jax(moons, jax_eigenpairs, name):
    uj, pj = _fit(jgl, name, moons)
    ut, pt = _fit(tgl, name, moons, device="cpu")
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(pt, pj)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_end_to_end_agrees_with_jax(moons, jax_start, name):
    W, y, ti, _ = moons
    _, pj = _fit(jgl, name, moons)
    _, pt = _fit(tgl, name, moons, device="cpu")
    assert np.mean(pt == pj) >= 0.995
    assert abs(tgl.ssl.ssl_accuracy(pt, y, ti)
               - jgl.ssl.ssl_accuracy(pj, y, ti)) <= 0.5


def test_positional_parameters_match_jax(moons, jax_eigenpairs):
    """Every parameter bound positionally in JAX's order (``device`` last,
    by keyword): the same fits as JAX's."""
    W, y, ti, priors = moons
    cases = [
        ("poisson", (W, None, "spectral", 2, False, 50, 1000, 1e-3, 5)),
        ("poisson_mbo", (W, priors, "spectral", False, 50, 1000, 1e-3, 5,
                         10, 1, 3)),
        ("multiclass_mbo", (W, None, 4, 5, 0.2, 40, 15, 1)),
        ("modularity_mbo", (W, None, 0.3, 2, 0.5, 6, 3)),
    ]
    for name, args in cases:
        mj = getattr(jgl.ssl, name)(*args)
        mt = getattr(tgl.ssl, name)(*args, device="cpu")
        np.testing.assert_array_equal(mt.fit_predict(ti, y[ti]),
                                      mj.fit_predict(ti, y[ti]))


@pytest.mark.parametrize("name", ["multiclass_mbo", "modularity_mbo"])
def test_verbose_path_matches(moons, jax_eigenpairs, capsys, name):
    """With ``all_labels`` the fit prints each round's accuracy, JAX's
    lines, and returns the same ``u``."""
    W, y, ti, priors = moons
    m = MODELS[name](tgl, W, priors, device="cpu")
    quiet = m.fit(ti, y[ti])
    capsys.readouterr()
    loud = MODELS[name](tgl, W, priors, device="cpu").fit(ti, y[ti],
                                                          all_labels=y)
    out_t = capsys.readouterr().out
    MODELS[name](jgl, W, priors).fit(ti, y[ti], all_labels=y)
    out_j = capsys.readouterr().out
    np.testing.assert_array_equal(loud, quiet)
    assert out_t == out_j and out_t.count("Accuracy") > 1


def test_spectral_fit_reuses_the_eigenpairs(moons):
    """PoissonMBO's spectral start and a spectral Poisson fit on the same W
    share one eigensolve (the zero-diagonal graph's memo)."""
    W, y, ti, priors = moons
    a = tgl.ssl.poisson(W, solver="spectral", device="cpu")
    a.fit(ti, y[ti])
    G0 = a._nodiag_graph()[1]
    key = ("randomwalk", "exact", 11, None, 0, 0, 1)
    assert key in G0.eigendata["randomwalk"]
    b = tgl.ssl.poisson_mbo(W, priors, solver="spectral", T=2, device="cpu")
    b.fit(ti, y[ti])
    assert b.poisson_model._nodiag_graph()[1] is G0
    with pytest.raises(ValueError, match="invalid Poisson solver"):
        tgl.ssl.poisson(W, solver="bogus", device="cpu")
