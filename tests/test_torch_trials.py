"""The experiment harness of graphlearning_tpu_torch against
graphlearning_tpu at float64 on the CPU: the batched Laplace and Poisson
fits (the JAX package's vmapped solves) trial by trial, each trial against
the port's own single solve (within 1e-12: the same operations on each
trial's block), the sequential fallbacks, the ``ssl_trials`` CSV files and
the ``accuracy_table`` file byte for byte, ``trials_statistics``,
``accuracy_plot``'s series, ``warmup`` and ``fit_device``.  Each package's
``results_dir`` is a temporary directory."""

import numpy as np
import pytest
import torch

import graphlearning_tpu as jgl
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch.solvers import cg as tcg

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-10)
SELF = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def quads():
    """Four quadrant classes of 400 uniform points, k=10; four trials of
    3 labels a class and four of 5."""
    rs = np.random.RandomState(0)
    X = rs.rand(400, 2)
    y = (X[:, 0] > 0.5).astype(int) + 2 * (X[:, 1] > 0.5)
    W = jgl.weightmatrix.knn(X, 10)
    trials = (jgl.trainsets.generate(y, rate=3, num_trials=4, seed=2)
              + jgl.trainsets.generate(y, rate=5, num_trials=4, seed=3))
    return W, y, trials


@pytest.fixture
def results_dirs(tmp_path, monkeypatch):
    monkeypatch.setattr(jgl.ssl, "results_dir", str(tmp_path / "jax"))
    monkeypatch.setattr(tgl.ssl, "results_dir", str(tmp_path / "torch"))
    return tmp_path


BATCHED = {
    "laplace": lambda gl, W, **kw: gl.ssl.laplace(W, **kw),
    "laplace_normalized_meanshift": lambda gl, W, **kw: gl.ssl.laplace(
        W, normalization="normalized", mean_shift=True, **kw),
    "laplace_tau_order2": lambda gl, W, **kw: gl.ssl.laplace(
        W, tau=0.1, order=2, **kw),
    "poisson": lambda gl, W, **kw: gl.ssl.poisson(W, **kw),
}


@pytest.mark.parametrize("name", sorted(BATCHED))
def test_batched_fits_match_jax_and_the_single_solves(quads, name):
    W, y, trials = quads
    trials = trials[:4]
    jm = BATCHED[name](jgl, W)
    tm = BATCHED[name](tgl, W, device="cpu")
    for a, b in zip(tm.fit_predict_batched(trials, y),
                    jm._fit_batched(np.stack(trials), y)):
        np.testing.assert_array_equal(a, b)
    (idx, u, iters), = tm._solve_batched(np.stack(trials), y)
    assert idx == [0, 1, 2, 3]
    for t in idx:
        single = BATCHED[name](tgl, W, device="cpu")
        ut = single._fit(trials[t], y[trials[t]])
        np.testing.assert_allclose(u[t].numpy(), ut.numpy(), **SELF)
        assert iters[t] == single.iters > 20


def test_batched_fits_in_groups(quads, monkeypatch):
    """A byte budget of three trials' gathers splits eight trials into
    groups of 3, 3 and 2, with the same answers (at a tight tolerance: the
    product's sums may round otherwise at another width, and CG at a loose
    one carries that to its stopping iterate)."""
    W, y, trials = quads
    trials = np.stack(trials[:4] * 2)
    tm = tgl.ssl.poisson(W, tol=1e-10, device="cpu")
    whole = np.concatenate([u.numpy() for _, u, _ in
                            tm._solve_batched(trials, y)])
    g = tm._nodiag_graph()[1].sparse
    monkeypatch.setattr(tgl.ssl, "_BATCH_BYTES", 3 * g.n * g.k * 4 * 8)
    parts = list(tm._solve_batched(trials, y))
    assert [p[0] for p in parts] == [[0, 1, 2], [3, 4, 5], [6, 7]]
    np.testing.assert_allclose(np.concatenate([u.numpy() for _, u, _ in
                                               parts]), whole, rtol=1e-8,
                               atol=1e-8)


def test_batched_cg_freezes_each_trial_at_its_own_stop():
    """Two trials on one SPD operator: the first right-hand side is an
    eigenvector (one step), the second is not (many).  Each trial's answer,
    steps and residual are its own :func:`conjgrad` solve's."""
    rs = np.random.RandomState(4)
    n, m = 120, 3
    Q, _ = np.linalg.qr(rs.randn(n, n))
    A = torch.as_tensor(Q @ np.diag(np.linspace(1.0, 50.0, n)) @ Q.T)
    b = torch.as_tensor(np.stack([np.repeat(Q[:, [7]], m, axis=1)
                                  * [1.0, 2.0, -1.0], rs.randn(n, m)]))
    x, iters, res = tcg.conjgrad_batched(lambda X: A @ X, b, tol=1e-9)
    assert iters[0] <= 2 and iters[1] > 20 * iters[0]
    for t in range(2):
        xs, it, r = tcg.conjgrad(lambda X: A @ X, b[t], tol=1e-9)
        np.testing.assert_allclose(x[t].numpy(), xs.numpy(), **SELF)
        assert iters[t] == it and abs(res[t] - r) <= 1e-12 * max(r, 1e-30)


def test_batched_constrained_solve_matches_the_single_solves(quads):
    """Masked Jacobi CG of trials of unequal stopping: each trial as
    :func:`constrained_solve` alone."""
    W, y, trials = quads
    G = tgl.graph(W, device="cpu")
    matvec, diag = G.laplacian_op("combinatorial")
    n = G.num_nodes
    masks = np.zeros((2, n), dtype=bool)
    bdy = np.zeros((2, n, 4))
    for t, ti in enumerate((trials[0], trials[5])):
        masks[t, ti] = True
        bdy[t, ti, y[ti]] = 1.0
    u, iters, _ = tcg.constrained_solve_batched(
        matvec, diag, torch.as_tensor(masks), torch.as_tensor(bdy),
        tol=1e-8, max_iter=10**5)
    for t in range(2):
        us, it, _ = tcg.constrained_solve(
            matvec, diag, torch.as_tensor(masks[t]), torch.as_tensor(bdy[t]),
            tol=1e-8, max_iter=10**5)
        np.testing.assert_allclose(u[t].numpy(), us.numpy(), **SELF)
        assert iters[t] == it


FALLBACKS = {
    "laplace_wnll": lambda gl, W, **kw: gl.ssl.laplace(
        W, reweighting="wnll", **kw),
    "poisson_gd": lambda gl, W, **kw: gl.ssl.poisson(
        W, solver="gradient_descent", **kw),
    "laplace_priors": lambda gl, W, **kw: gl.ssl.laplace(
        W, class_priors=np.ones(4), **kw),
    "randomwalk": lambda gl, W, **kw: gl.ssl.randomwalk(W, **kw),
}


@pytest.mark.parametrize("name", sorted(FALLBACKS))
def test_sequential_fallbacks_match_jax(quads, name):
    """Reweighting, a solver other than CG, class priors and models with
    no batched fit take one ``fit_predict`` a trial in both packages; so
    do trials of unequal sizes."""
    W, y, trials = quads
    trials = trials[:2] + trials[-1:]
    jm = FALLBACKS[name](jgl, W)
    tm = FALLBACKS[name](tgl, W, device="cpu")
    for a, b in zip(tm.fit_predict_batched(trials, y),
                    jm.fit_predict_batched(trials, y)):
        np.testing.assert_array_equal(a, b)


def _read(path):
    with open(path, "rb") as fh:
        return fh.read()


TRIAL_MODELS = {
    "laplace": lambda gl, W, **kw: gl.ssl.laplace(W, **kw),
    "poisson": lambda gl, W, **kw: gl.ssl.poisson(W, **kw),
    "laplace_priors": lambda gl, W, **kw: gl.ssl.laplace(
        W, class_priors=gl.utils.class_priors(kw.pop("y")), **kw),
}


def _pair(name, W, y):
    extra = {"y": y} if name == "laplace_priors" else {}
    return (TRIAL_MODELS[name](jgl, W, **dict(extra)),
            TRIAL_MODELS[name](tgl, W, device="cpu", **dict(extra)))


@pytest.mark.parametrize("name", sorted(TRIAL_MODELS))
def test_ssl_trials_files_match_jax(quads, results_dirs, name):
    """The CSV byte for byte (the plain two columns, the class-priors
    four), the returned rows, and ``trials_statistics``; then a sweep cut
    after three trials and resumed gives the same file."""
    W, y, trials = quads
    jm, tm = _pair(name, W, y)
    rj = jm.ssl_trials(trials, y, tag="t_")
    rt = tm.ssl_trials(trials, y, tag="t_")
    np.testing.assert_allclose(rt, rj, **TOL)
    fname = tm.get_accuracy_filename()
    assert fname == jm.get_accuracy_filename()
    theirs = _read(results_dirs / "jax" / ("t_" + fname))
    assert _read(results_dirs / "torch" / ("t_" + fname)) == theirs
    assert theirs.count(b"\n") == 9
    for a, b in zip(tm.trials_statistics(tag="t_"),
                    jm.trials_statistics(tag="t_")):
        np.testing.assert_allclose(a, b, **TOL)
    assert tm.ssl_trials(trials, y, tag="t_") is None       # no overwrite

    cut = TRIAL_MODELS[name](tgl, W, device="cpu",
                             **({"y": y} if name == "laplace_priors" else {}))
    assert len(cut.ssl_trials(trials, y, tag="r_", num_trials=3)) == 3
    rest = cut.ssl_trials(trials, y, tag="r_", resume=True)
    assert len(rest) == len(trials) - 3
    assert _read(results_dirs / "torch" / ("r_" + fname)) == theirs


def test_accuracy_table_matches_jax(quads, results_dirs):
    """The LaTeX table of two models, and a class-priors model appended
    with test errors, byte for byte."""
    W, y, trials = quads
    pairs = [_pair(name, W, y) for name in ("laplace", "poisson",
                                            "laplace_priors")]
    for jm, tm in pairs:
        jm.ssl_trials(trials, y)
        tm.ssl_trials(trials, y)
    for pkg, i in ((jgl, 0), (tgl, 1)):
        out = str(results_dirs / f"table{i}.tex")
        pkg.ssl.accuracy_table([p[i] for p in pairs[:2]], savefile=out,
                               title="Quads")
        pkg.ssl.accuracy_table([pairs[2][i]], savefile=out, title="CP",
                               testerror=True, append=True, two_column=True,
                               small_caps=False)
    assert (_read(results_dirs / "table1.tex")
            == _read(results_dirs / "table0.tex"))


def test_accuracy_plot_series_match_jax(quads, results_dirs):
    """Under the Agg backend: the same lines (labels, x and y), error
    bars and labels as the JAX package's figure."""
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    W, y, trials = quads
    pairs = [_pair(name, W, y) for name in ("laplace", "laplace_priors")]
    for jm, tm in pairs:
        jm.ssl_trials(trials, y)
        tm.ssl_trials(trials, y)
    figs = []
    for pkg, i in ((jgl, 0), (tgl, 1)):
        pkg.ssl.accuracy_plot([p[i] for p in pairs], errorbars=True,
                              savefile=str(results_dirs / f"plot{i}.png"),
                              title="Quads", ylim=(50, 100))
        ax = plt.gca()
        figs.append(([(ln.get_label(), ln.get_xdata().tolist(),
                       ln.get_ydata().tolist()) for ln in ax.lines],
                     [t.get_text() for t in ax.get_legend().get_texts()],
                     ax.get_xlabel(), ax.get_ylabel(), ax.get_ylim()))
        plt.close("all")
    assert figs[0] == figs[1]
    assert len(figs[1][1]) == 3                   # Laplace, +CP's two
    assert (results_dirs / "plot1.png").exists()


def test_warmup_resets_the_fitted_state(quads):
    """The method and the module function fit once and reset; the graph's
    caches stay; a real fit afterwards is the cold fit's."""
    W, y, trials = quads
    cold = tgl.ssl.poisson(W, device="cpu").fit_predict(trials[0],
                                                        y[trials[0]])
    m = tgl.ssl.poisson(W, device="cpu").warmup(4)
    assert not m.fitted and m.prob is None and m.weights == 1
    assert m._nodiag_cache is not None
    with pytest.raises(RuntimeError):
        m.predict()
    assert tgl.warmup(m, 4) is m and not m.fitted and m.prob is None
    np.testing.assert_array_equal(m.fit_predict(trials[0], y[trials[0]]),
                                  cold)
    jm = jgl.ssl.poisson(W).warmup(4)
    assert not jm.fitted and jm.prob is None


@pytest.mark.parametrize("name", ["laplace", "poisson", "laplace_priors"])
def test_fit_device_returns_the_scores_on_the_device(quads, name):
    """A tensor on the graph's device whose argmax is ``fit_predict``'s;
    ``predict`` works on it."""
    W, y, trials = quads
    ti = trials[1]
    _, tm = _pair(name, W, y)
    u = tm.fit_device(ti, y[ti])
    assert torch.is_tensor(u) and u.device == tm.graph.device
    assert u.shape == (W.shape[0], 4)
    _, other = _pair(name, W, y)
    pred = other.fit_predict(ti, y[ti])
    if name == "laplace_priors":           # the priors' weights apply
        np.testing.assert_array_equal(u.numpy(), other.prob)
    else:
        np.testing.assert_array_equal(torch.argmax(u, dim=1).numpy(), pred)
        np.testing.assert_array_equal(tm.predict(), pred)
