"""PoissonMBO, VolumeMBO and their solver pieces of graphlearning_tpu_torch
against graphlearning_tpu on the CPU, at float64 (JAX's x64 on).

* ``volume.assign_labels`` and ``volume.projection_weights`` on seeded
  inputs: identical labels, ``w`` within 1e-12 and ``err`` within 1e-15
  (XLA's FMA contraction on the CPU).
* The fits on the plain path (500-node two moons): identical predictions;
  VolumeMBO at temperature 0.1 fed JAX's own Gumbel draws: identical
  labels and iterations.
* The band path forced on the CPU (the kernels' twins, bf16 band) and the
  gather (a hub graph): agreement with the plain path at the JAX package's
  own bounds (``tests/test_accel.py``: > 0.98 PoissonMBO, > 0.97
  VolumeMBO, whose bf16 convolutions may flip ties), and each accel entry
  allclose to the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearning_tpu as jgl
from graphlearning_tpu import ssl as jssl
from graphlearning_tpu.ops import accel as jaccel
from graphlearning_tpu.ops import gather as jgather
from graphlearning_tpu.solvers import volume as jvolume
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch.ops import accel as taccel
from graphlearning_tpu_torch.ops import gather as tgather
from graphlearning_tpu_torch.solvers import volume as tvolume
from test_torch_gather import cpu_accel, hub_graph  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def moons():
    """The 500-node two moons of ``tests/test_ssl_models2.py``."""
    import sklearn.datasets as datasets

    X, labels = datasets.make_moons(n_samples=500, noise=0.1, random_state=0)
    W = jgl.weightmatrix.knn(X, 10)
    rs = np.random.RandomState(1)
    train_ind = np.concatenate(
        [rs.choice(np.where(labels == c)[0], 5, replace=False)
         for c in (0, 1)])
    return W, labels, train_ind, jgl.utils.class_priors(labels)


@pytest.fixture
def band_forced(monkeypatch):
    """Band path on in both packages at this small size."""
    monkeypatch.setattr(jaccel, "_MIN_N", 1)
    monkeypatch.setattr(jaccel, "enabled", lambda: True)
    monkeypatch.setenv("GLT_ACCEL_INTERPRET", "1")
    monkeypatch.setattr(taccel, "_MIN_N", 1)
    monkeypatch.setattr(taccel, "enabled", lambda device: True)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def test_class_priors_matches_jax():
    labels = np.random.RandomState(0).randint(-1, 4, 300)
    np.testing.assert_array_equal(tgl.utils.class_priors(labels),
                                  jgl.utils.class_priors(labels))


def _assignment_case(name):
    """``(a, fixed_mask, fixed_labels, lower, upper, max_price_it)``.
    "ties": affinities on a grid of eight values, many rows equal;
    "repair": a start far over the bounds and a 2-step price ascent, so
    the batched repair moves up to 128 nodes a round; "pinned": a third of
    the nodes fixed, some to the class the bounds squeeze."""
    rs = np.random.RandomState({"ties": 0, "repair": 1, "pinned": 2}[name])
    n, k = 400, 3
    a = rs.rand(n, k)
    fixed = np.zeros(n, bool)
    fixed_labels = np.zeros(n, np.int64)
    lower, upper = np.full(k, 100.0), np.full(k, 160.0)
    max_price_it = 500
    if name == "ties":
        a = np.floor(a * 8) / 8
    elif name == "repair":
        a[:, 0] += 1.0
        lower, upper = np.array([90.0, 120.0, 120.0]), np.full(k, 150.0)
        max_price_it = 2
    else:
        fixed[rs.choice(n, n // 3, replace=False)] = True
        fixed_labels[fixed] = rs.randint(0, k, fixed.sum())
        fixed_labels[np.nonzero(fixed)[0][:20]] = 2
        upper[2] = 120.0
    return a, fixed, fixed_labels, lower, upper, max_price_it


@pytest.mark.parametrize("name", ["ties", "repair", "pinned"])
def test_assign_labels_matches_jax(name):
    a, fixed, fixed_labels, lower, upper, it = _assignment_case(name)
    lj = np.asarray(jvolume.assign_labels(
        jnp.asarray(a), jnp.asarray(fixed), jnp.asarray(fixed_labels),
        jnp.asarray(lower), jnp.asarray(upper), max_price_it=it))
    lt = tvolume.assign_labels(_t(a), _t(fixed), _t(fixed_labels),
                               _t(lower), _t(upper), max_price_it=it).numpy()
    np.testing.assert_array_equal(lt, lj)
    counts = np.bincount(lt, minlength=a.shape[1])
    assert np.all(counts >= lower) and np.all(counts <= upper)
    np.testing.assert_array_equal(lt[fixed], fixed_labels[fixed])
    if name == "repair":
        # the price ascent alone leaves the counts infeasible
        start = np.argmax(a, axis=1)
        assert np.bincount(start, minlength=3)[0] > upper[0] + 128


@pytest.mark.parametrize("similarity", [True, False])
def test_projection_weights_matches_jax(similarity):
    rs = np.random.RandomState(3)
    scores = rs.rand(500, 4)
    priors = np.array([0.1, 0.2, 0.3, 0.4])
    dt = -0.1 if similarity else 0.1
    wj, ej = jvolume.projection_weights(
        jnp.asarray(scores), jnp.ones(4), jnp.asarray(priors), dt,
        similarity=similarity)
    wt, et = tvolume.projection_weights(
        _t(scores), torch.ones(4, dtype=torch.float64), _t(priors), dt,
        similarity=similarity)
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=0,
                               atol=1e-12)
    # the last step's class sizes meet the priors exactly in both; XLA on
    # the CPU contracts ``count / n - prior`` into one FMA, which leaves
    # JAX's err at about 1e-17 where the port's is 0
    assert abs(float(et) - float(ej)) <= 1e-15


def test_poisson_mbo_plain_matches_jax(moons):
    W, y, ti, priors = moons
    jm = jgl.ssl.poisson_mbo(W, priors, T=10)
    tm = tgl.ssl.poisson_mbo(W, priors, T=10, device="cpu")
    np.testing.assert_array_equal(tm.fit_predict(ti, y[ti]),
                                  jm.fit_predict(ti, y[ti]))
    np.testing.assert_allclose(tm.weights, jm.weights, rtol=1e-10)
    assert tgl.ssl.ssl_accuracy(tm.predict(), y, ti) > 90.0


def test_poisson_mbo_positional_parameters_match_jax(moons):
    """JAX's positional order: (W, class_priors, solver, use_cuda,
    min_iter, max_iter, tol, spectral_cutoff, Ns, mu, T)."""
    W, y, ti, priors = moons
    args = (W, priors, "conjugate_gradient", False, 50, 1000, 1e-3, 10, 20,
            1.5, 4)
    jm = jgl.ssl.poisson_mbo(*args)
    tm = tgl.ssl.poisson_mbo(*args, device="cpu")
    assert (tm.Ns, tm.mu, tm.T) == (jm.Ns, jm.mu, jm.T) == (20, 1.5, 4)
    np.testing.assert_array_equal(tm.fit_predict(ti, y[ti]),
                                  jm.fit_predict(ti, y[ti]))
    with pytest.raises(NotImplementedError, match="P10"):
        tgl.ssl.poisson_mbo(W, priors, "spectral", device="cpu")


def test_poisson_mbo_verbose_path_matches_fused(moons, capsys):
    """``all_labels`` prints each round's accuracy and predicts as the
    fused loop."""
    W, y, ti, priors = moons
    fused = tgl.ssl.poisson_mbo(W, priors, T=3, device="cpu")
    verbose = tgl.ssl.poisson_mbo(W, priors, T=3, device="cpu")
    np.testing.assert_array_equal(
        verbose.fit_predict(ti, y[ti], all_labels=y),
        fused.fit_predict(ti, y[ti]))
    assert capsys.readouterr().out.count("Accuracy") == 3


def test_volume_mbo_plain_matches_jax(moons):
    W, y, ti, priors = moons
    jm = jgl.ssl.volume_mbo(W, priors, temperature=0.0)
    tm = tgl.ssl.volume_mbo(W, priors, temperature=0.0, device="cpu")
    pred = tm.fit_predict(ti, y[ti])
    np.testing.assert_array_equal(pred, jm.fit_predict(ti, y[ti]))
    assert tgl.ssl.ssl_accuracy(pred, y, ti) > 90.0
    with pytest.raises(SystemExit):
        tgl.ssl.volume_mbo(W, None, device="cpu")


def _mbo_inputs(W, y, ti, priors):
    """VolumeMBO's loop inputs as both fits build them: the zero-diagonal
    graph, the Voronoi labels, pins and bounds."""
    Wn, G = jgl.ssl.volume_mbo(W, priors)._nodiag_graph()
    n = W.shape[0]
    _, cp = jgl.graph(Wn).dijkstra(ti, bdy_val=np.zeros(len(ti)),
                                   return_cp=True)
    lab_of = np.full(n, -1)
    lab_of[ti] = y[ti]
    labels0 = lab_of[np.maximum(cp, 0)]
    labels0[labels0 < 0] = 0
    fixed = np.zeros(n, bool)
    fixed[ti] = True
    fixed_labels = np.zeros(n, np.int64)
    fixed_labels[ti] = y[ti]
    counts = (n * priors / np.sum(priors)).astype(int)
    return (Wn, G, labels0, fixed, fixed_labels, np.floor(0.5 * counts),
            np.ceil(1.5 * counts))


def test_volume_mbo_with_jax_draws_matches_jax(moons):
    """At temperature 0.1, ``volume.mbo_loop`` fed JAX's Gumbel draws
    (the key split once an iteration, as JAX's loop does) gives JAX's
    labels and iteration count."""
    W, y, ti, priors = moons
    Wn, G, labels0, fixed, fixed_labels, lower, upper = _mbo_inputs(
        W, y, ti, priors)
    n = W.shape[0]
    deg = jgl.graph(Wn).degree_vector()
    lj, itj = jssl._volume_mbo_loop_xla(
        G.sparse, jnp.asarray(deg), jnp.asarray(labels0, jnp.int32),
        jnp.asarray(fixed), jnp.asarray(fixed_labels), jnp.asarray(lower),
        jnp.asarray(upper), jnp.asarray(0.1), jax.random.PRNGKey(7), k=2,
        max_iters=300, n_true=n)
    key = [jax.random.PRNGKey(7)]

    def draw(shape):
        key[0], sub = jax.random.split(key[0])
        return _t(jax.random.gumbel(sub, tuple(shape), dtype=jnp.float64))

    g = tgl.graph(Wn, device="cpu").sparse
    dinv = 1.0 / tgl.ops.graphops.degree_vector(g)

    def dual_conv(labels):
        a = dinv[:, None] * tgl.ops.graphops.spmm(
            g, tvolume._onehot(labels, 2, torch.float64))
        return dinv[:, None] * tgl.ops.graphops.spmm(g, a)

    lt, itt = tvolume.mbo_loop(dual_conv, _t(labels0), _t(fixed),
                               _t(fixed_labels), _t(lower), _t(upper), 0.1,
                               draw, n_true=n, max_iters=300)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    assert itt == int(itj) > 11


def test_volume_mbo_generator_is_seeded(moons):
    """The port's own noise: the same seed gives the same labels (also a
    seed drawn from numpy's global state, as JAX draws its key), and the
    accuracy is JAX's test's."""
    W, y, ti, priors = moons
    fit = lambda seed: tgl.ssl.volume_mbo(
        W, priors, temperature=0.1, seed=seed, device="cpu").fit_predict(
            ti, y[ti])
    pred = fit(0)
    np.testing.assert_array_equal(fit(0), pred)
    assert tgl.ssl.ssl_accuracy(pred, y, ti) > 90.0
    np.random.seed(11)
    first = fit(None)
    np.random.seed(11)
    np.testing.assert_array_equal(fit(None), first)


def test_volume_mbo_verbose_path_matches_fused(moons, capsys):
    W, y, ti, priors = moons
    fused = tgl.ssl.volume_mbo(W, priors, temperature=0.1, seed=3,
                               device="cpu")
    verbose = tgl.ssl.volume_mbo(W, priors, temperature=0.1, seed=3,
                                 device="cpu")
    np.testing.assert_array_equal(
        verbose.fit_predict(ti, y[ti], all_labels=y),
        fused.fit_predict(ti, y[ti]))
    assert verbose.iters == fused.iters
    assert capsys.readouterr().out.count("changed=") == fused.iters


# -- the band path and the gather -------------------------------------------


@pytest.mark.parametrize("name", ["poisson_mbo", "volume_mbo"])
def test_band_fits_agree_with_plain(moons, band_forced, monkeypatch, name):
    """The fits on the bf16 band (K1, K2's twin; K7's for the Voronoi
    start) against the plain path, at the JAX package's bounds."""
    W, y, ti, priors = moons
    make = {"poisson_mbo": lambda: tgl.ssl.poisson_mbo(
                W.copy(), priors, T=5, device="cpu"),
            "volume_mbo": lambda: tgl.ssl.volume_mbo(
                W.copy(), priors, temperature=0.0, device="cpu")}[name]
    m = make()
    pred = m.fit_predict(ti, y[ti])
    acc = m._accel_mbo if name == "poisson_mbo" else m._accel_vmbo
    assert isinstance(acc, taccel.AccelSpMM) and acc.mode == "bf16"
    monkeypatch.setattr(taccel, "enabled", lambda device: False)
    ref = make().fit_predict(ti, y[ti])
    assert np.mean(pred == ref) > (0.98 if name == "poisson_mbo" else 0.97)


def _entry_inputs(n, k, seed):
    rs = np.random.RandomState(seed)
    u = np.eye(k)[rs.randint(0, k, n)]
    Db = np.zeros((n, k))
    Db[rs.choice(n, 10, replace=False)] = rs.randn(10, k) * 0.01
    return u, Db, rs.randint(0, k, n)


def _check_entries(jacc, tacc, W, tol):
    """heat_steps, dual_conv_labels, poisson_mbo and volume_mbo of the two
    accels on the same inputs, in original order: within ``tol`` of the
    largest value (labels identical for the MBO loops)."""
    n, k = W.shape[0], 2
    u, Db, labels = _entry_inputs(n, k, 0)
    deg = np.asarray(W.sum(axis=1)).ravel()
    dt = 1.0 / deg.max()
    dinv = 1.0 / deg
    jt = lambda a: jacc.to_perm(jnp.asarray(a))
    tt = lambda a: tacc.to_perm(_t(a))

    def close(out_t, out_j):
        ref = np.asarray(out_j)
        np.testing.assert_allclose(out_t.numpy(), ref, rtol=0,
                                   atol=tol * np.abs(ref).max())

    close(tacc.from_perm(tacc.heat_steps(tt(deg), tt(u), tt(Db), dt, 5)),
          jacc.from_perm(jacc.heat_steps(jt(deg), jt(u), jt(Db), dt, 5)))
    close(tacc.dual_conv_labels(tt(dinv), _t(labels), k),
          jacc.dual_conv_labels(jt(dinv), jnp.asarray(labels), k))
    priors = np.array([0.5, 0.5])
    ut, wt, _ = tacc.poisson_mbo(tt(deg), tt(Db), _t(u), torch.ones(
        k, dtype=torch.float64), _t(priors), dt, 5, 2)
    uj, wj, _ = jacc.poisson_mbo(jt(deg), jt(Db), jnp.asarray(u),
                                 jnp.ones(k), jnp.asarray(priors), dt, 5, 2)
    np.testing.assert_array_equal(ut.numpy(), np.asarray(uj))
    close(wt, wj)
    lower, upper = np.full(k, 0.3 * n), np.full(k, 0.7 * n)
    fixed = np.zeros(n, bool)
    fixed[:4] = True
    lt, _ = tacc.volume_mbo(tt(dinv), _t(labels), _t(fixed), _t(labels),
                            _t(lower), _t(upper), 0.0, None, k, 30)
    lj, _ = jacc.volume_mbo(jt(dinv), jnp.asarray(labels),
                            jnp.asarray(fixed), jnp.asarray(labels),
                            jnp.asarray(lower), jnp.asarray(upper), 0.0,
                            jax.random.PRNGKey(0), k=k, max_iters=30)
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))


def test_band_entries_match_jax(moons, band_forced):
    """The entries on the f32 band (K2's twin; the JAX kernels in
    interpret mode) within float32 tolerance of the JAX package's."""
    W = moons[0]
    _check_entries(jaccel.AccelSpMM(W, interpret=True),
                   taccel.AccelSpMM(W, device="cpu"), W, 2e-5)


def test_gather_entries_match_jax(hub_graph):
    W = hub_graph[0]
    _check_entries(jgather.GatherAccel(W, prec="f32"),
                   tgather.GatherAccel(W, prec="f32", device="cpu"), W,
                   1e-10)


@pytest.mark.parametrize("variant", ["plain", "recip", "hopf_lax"])
def test_gather_bellman_ford_matches_jax(hub_graph, variant):
    """``GatherAccel.bellman_ford``: ``d`` and ``cp`` equal to the JAX
    package's (both f32, the same operations), seeds with values.  The
    Hopf-Lax update's ``d`` within 1e-6 relative: XLA on the CPU contracts
    its ``fw * fw + 4 d d`` into FMAs, the port rounds each product."""
    W = hub_graph[0]
    n = W.shape[0]
    rs = np.random.RandomState(4)
    seeds = rs.choice(n, 9, replace=False)
    d0 = np.full(n, 1e30, np.float32)
    d0[seeds] = rs.rand(9)
    f = rs.rand(n) + 0.5
    kw = {"hopf_lax": variant == "hopf_lax", "recip": variant == "recip"}
    dj, cpj = jgather.GatherAccel(W, prec="f32").bellman_ford(
        d0, f, **kw)
    dt, cpt, rounds = tgather.GatherAccel(W, prec="f32",
                                          device="cpu").bellman_ford(
        d0, f, **kw)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=0,
                               rtol=1e-6 if variant == "hopf_lax" else 0)
    np.testing.assert_array_equal(cpt.numpy(), np.asarray(cpj))
    assert rounds > 2 and np.all(np.isin(cpt.numpy(), seeds))


@pytest.mark.parametrize("name", ["poisson_mbo", "volume_mbo"])
def test_gather_fits_agree_with_plain(hub_graph, cpu_accel, monkeypatch,
                                      name):
    """On the hub graph ``maybe_build`` takes the gather: the fits run its
    entries (VolumeMBO's Voronoi start its ``bellman_ford``, in f32) and
    agree with the plain path at the JAX package's bounds."""
    from graphlearning_tpu_torch.solvers import eikonal

    W, y, ti = hub_graph
    priors = tgl.utils.class_priors(y)
    make = {"poisson_mbo": lambda: tgl.ssl.poisson_mbo(
                W.copy(), priors, T=5, device="cpu"),
            "volume_mbo": lambda: tgl.ssl.volume_mbo(
                W.copy(), priors, temperature=0.0, device="cpu")}[name]
    paths = []
    real = eikonal.dijkstra

    def spy(*a, **kw):
        info = kw.setdefault("info", {})
        out = real(*a, **kw)
        paths.append(info["path"])
        return out

    monkeypatch.setattr(eikonal, "dijkstra", spy)
    m = make()
    pred = m.fit_predict(ti, y[ti])
    acc = m._accel_mbo if name == "poisson_mbo" else m._accel_vmbo
    assert isinstance(acc, tgather.GatherAccel) and acc.prec == "auto"
    monkeypatch.setattr(taccel, "enabled", lambda device: False)
    ref = make().fit_predict(ti, y[ti])
    assert np.mean(pred == ref) > (0.98 if name == "poisson_mbo" else 0.97)
    if name == "volume_mbo":
        assert paths == ["gather", "plain"]
        counts = np.bincount(pred, minlength=3)
        target = (len(y) * priors).astype(int)
        assert np.all(counts >= np.floor(0.5 * target))
        assert np.all(counts <= np.ceil(1.5 * target))
