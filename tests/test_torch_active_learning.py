"""Active learning of graphlearning_tpu_torch against graphlearning_tpu on
the CPU, at float64 (JAX's x64 on), on a 300-node two-moons 10-NN graph.

* Each acquisition's ``compute`` (truncated and full storage, before and
  after a downdate) and ``unc_sampling``'s six methods on a host array and
  on a tensor: rtol = atol = 1e-10.
* The learner: 5 queries of one node for each covariance acquisition,
  the same nodes as JAX's learner, and the scores within 1e-9 (both fits
  CG at tol 1e-10; the two packages sum in other orders, measured 1e-11).
* The "rand" and "prop" policies under ``np.random.seed``: JAX's nodes.
* ``warm_start=True`` against a cold learner for Laplace and Poisson's
  CG: the same queries, the scores within 1e-8 at tol 1e-10, fewer CG
  steps in all, ``_warm_u`` set during each refit and cleared after.
* ``spectral_covariance`` of a model, a graph and a weight matrix, the
  port's LOBPCG started from JAX's start: within 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearning_tpu as jgl
from graphlearning_tpu import active_learning as jal
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch import active_learning as tal
from graphlearning_tpu_torch.solvers import eig as teig

torch.set_num_threads(2)

ACQS = ("var_opt", "sigma_opt", "model_change", "model_change_var_opt")
UNC = ("norm", "entropy", "least_confidence", "smallest_margin",
       "largest_margin", "unc_2norm")


@pytest.fixture(scope="module")
def moons():
    """300-node two moons, 10-NN; 2 labels a class; JAX's eigenpairs (k=20)
    of the normalized Laplacian and its Laplace scores."""
    import sklearn.datasets as datasets

    X, y = datasets.make_moons(n_samples=300, noise=0.1, random_state=0)
    W = jgl.weightmatrix.knn(X, 10)
    ti = jgl.trainsets.generate(y, rate=2, seed=0)
    vals, vecs = jgl.graph(W).eigen_decomp(normalization="normalized", k=20)
    C0 = np.diag(1.0 / (np.asarray(vals) + 0.11))
    u = np.asarray(jgl.ssl.laplace(W, tol=1e-10).fit(ti, y[ti]))
    return W, y, ti, C0, np.asarray(vecs), u


@pytest.fixture
def jax_start(monkeypatch):
    """The port's LOBPCG started from JAX's start."""
    def start(n, k, key, dtype, device):
        dt = jnp.float32 if dtype == torch.float32 else jnp.float64
        x = jax.random.normal(jax.random.PRNGKey(0 if key is None else key),
                              (n, k), dtype=dt)
        return torch.as_tensor(np.array(x)).to(device)

    monkeypatch.setattr(teig, "_start", start)


def _pair(name, C0, V, storage):
    if storage == "full":
        C = V @ C0 @ V.T
        return getattr(jal, name)(C), getattr(tal, name)(C, device="cpu")
    return (getattr(jal, name)(C0, V=V), getattr(tal, name)(C0, V=V,
                                                            device="cpu"))


@pytest.mark.parametrize("storage", ["trunc", "full"])
@pytest.mark.parametrize("name", ACQS)
def test_acquisition_compute_matches_jax(moons, name, storage):
    W, y, ti, C0, V, u = moons
    ja, ta = _pair(name, C0, V, storage)
    ja.update(ti, y[ti])
    ta.update(ti, y[ti])
    cand = np.setdiff1d(np.arange(W.shape[0]), ti)
    np.testing.assert_allclose(ta.compute(u, cand), ja.compute(u, cand),
                               rtol=1e-10, atol=1e-10)
    q = cand[[3, 50]]
    ja.update(q, y[q])
    ta.update(q, y[q])
    np.testing.assert_allclose(np.asarray(ta.C), np.asarray(ja.C),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(ta.compute(u, cand), ja.compute(u, cand),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("method", UNC)
def test_unc_sampling_matches_jax_on_host_and_tensor(moons, method):
    u, cand = moons[5], np.arange(0, 300, 3)
    ja, ta = jal.unc_sampling(method), tal.unc_sampling(method)
    ref = ja.compute(u, cand)
    np.testing.assert_allclose(ta.compute(u, cand), ref, rtol=1e-10,
                               atol=1e-10)
    on_dev = ta.compute(torch.tensor(u), cand)
    np.testing.assert_allclose(on_dev, ja.compute(jnp.asarray(u), cand),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(on_dev, ref, rtol=1e-10, atol=1e-10)


def test_unc_sampling_refuses_a_bad_method(moons):
    u = moons[5]
    for uu in (u, torch.tensor(u)):
        with pytest.raises(ValueError, match="unc_method"):
            tal.unc_sampling("bogus").compute(uu, np.arange(5))


def test_var_opt_downdate_matches_direct():
    rs = np.random.RandomState(0)
    A = rs.randn(30, 30)
    C = A @ A.T
    acq = tal.var_opt(C, gamma2=0.01, device="cpu")
    ck = C[:, 7].copy()
    acq.update(np.array([7]), np.array([0]))
    np.testing.assert_allclose(acq.C.numpy(),
                               C - np.outer(ck, ck) / (0.01 + C[7, 7]),
                               rtol=1e-12, atol=1e-12)


def test_truncated_storage_matches_full():
    """With V the identity the truncated storage is the full one."""
    rs = np.random.RandomState(1)
    A = rs.randn(25, 25)
    C = A @ A.T
    cand = np.arange(25)
    for name in ACQS:
        full = getattr(tal, name)(C, gamma2=0.04, device="cpu")
        trunc = getattr(tal, name)(C, V=np.eye(25), gamma2=0.04,
                                   device="cpu")
        u = rs.randn(25, 3)
        np.testing.assert_allclose(trunc.compute(u, cand),
                                   full.compute(u, cand), rtol=1e-10)
        full.update([4], [0])
        trunc.update([4], [0])
        np.testing.assert_allclose(trunc.compute(u, cand),
                                   full.compute(u, cand), rtol=1e-10)


def test_covariance_needs_square_or_vectors():
    with pytest.raises(ValueError):
        tal.var_opt(np.ones((3, 4)), device="cpu")


def _run(al, model, W, y, ti, acq, queries=5, policy="max", **kw):
    learner = al.active_learner(model, acq, ti, y[ti], policy=policy, **kw)
    picked = []
    for _ in range(queries):
        q = learner.select_queries()
        picked += list(np.atleast_1d(q))
        learner.update(q, y[q])
    return learner, picked


@pytest.mark.parametrize("name", ACQS)
def test_learner_queries_and_scores_match_jax(moons, name):
    W, y, ti, C0, V, _ = moons
    jl, jq = _run(jal, jgl.ssl.laplace(W, tol=1e-10), W, y, ti,
                  getattr(jal, name), C=C0, V=V)
    tl, tq = _run(tal, tgl.ssl.laplace(W, tol=1e-10, device="cpu"), W, y,
                  ti, getattr(tal, name), C=C0, V=V, device="cpu")
    assert tq == jq
    np.testing.assert_allclose(np.asarray(tl.u), np.asarray(jl.u), rtol=0,
                               atol=1e-9)
    np.testing.assert_array_equal(tl.labeled_ind, jl.labeled_ind)


@pytest.mark.parametrize("policy", ["rand", "prop"])
def test_random_policies_pick_jax_nodes(moons, policy):
    W, y, ti, C0, V, u = moons
    picks = {}
    for name, al, gl in (("jax", jal, jgl), ("torch", tal, tgl)):
        kw = {"device": "cpu"} if al is tal else {}
        model = gl.ssl.laplace(W, tol=1e-10, **kw)
        learner = al.active_learner(model, al.var_opt, ti, y[ti],
                                    C=C0, V=V, **kw)
        np.random.seed(5)
        if policy == "rand":
            picks[name] = learner.select_queries(batch_size=3,
                                                 candidate_ind="rand",
                                                 rand_frac=0.2)
        else:
            picks[name] = learner.select_queries(batch_size=4, policy="prop",
                                                 prop_gamma=50.0)
    np.testing.assert_array_equal(picks["torch"], picks["jax"])


@pytest.mark.parametrize("model", ["laplace", "poisson"])
def test_warm_start_matches_cold_in_fewer_steps(moons, model):
    W, y, ti, C0, V, _ = moons
    runs = {}
    for warm in (False, True):
        m = getattr(tgl.ssl, model)(W, tol=1e-10, device="cpu")
        steps, seen, fit = [], [], m._fit

        def record(*a, m=m, fit=fit, steps=steps, seen=seen, **k):
            seen.append(getattr(m, "_warm_u", None) is not None)
            out = fit(*a, **k)
            steps.append(m.iters)
            return out

        m._fit = record
        learner, q = _run(tal, m, W, y, ti, tal.model_change,
                          warm_start=warm, C=C0, V=V, device="cpu")
        assert m._warm_u is None
        assert seen == [False] + [warm] * 5
        runs[warm] = (learner, q, steps)
    (cold, qc, sc), (warm, qw, sw) = runs[False], runs[True]
    assert qw == qc
    assert isinstance(warm.u, torch.Tensor) and not isinstance(cold.u,
                                                               torch.Tensor)
    np.testing.assert_allclose(warm.u.numpy(), cold.u, rtol=0, atol=1e-8)
    assert sum(sw[1:]) < sum(sc[1:]), (sw, sc)
    # and JAX's warm learner queries the same nodes
    jm = getattr(jgl.ssl, model)(W, tol=1e-10)
    _, qj = _run(jal, jm, W, y, ti, jal.model_change, warm_start=True,
                 C=C0, V=V)
    assert qw == qj


@pytest.mark.parametrize("kind", ["model", "graph", "matrix"])
def test_spectral_covariance_matches_jax(moons, jax_start, kind):
    W = moons[0]
    j_arg = {"model": jgl.ssl.laplace(W), "graph": jgl.graph(W),
             "matrix": W}[kind]
    t_arg = {"model": tgl.ssl.laplace(W, device="cpu"),
             "graph": tgl.graph(W, device="cpu"), "matrix": W}[kind]
    Cj, Vj = jal.spectral_covariance(j_arg, k=8)
    Ct, Vt = tal.spectral_covariance(t_arg, k=8, device="cpu")
    np.testing.assert_allclose(Ct, Cj, rtol=1e-8, atol=1e-8)
    # eigenvectors up to sign
    sign = np.sign(np.sum(Vt * Vj, axis=0))
    np.testing.assert_allclose(Vt * sign, Vj, rtol=0, atol=1e-6)


def test_spectral_covariance_refuses_a_distributed_model(moons):
    """(Name kept from when a distributed model refused.)  A distributed
    model now solves on its mesh (one rank here): its covariance within
    1e-8 of the one-device model's and of the JAX package's distributed
    model's on a 4-device mesh."""
    from graphlearning_tpu.config import GLTConfig as JConfig

    W = moons[0]
    m = tgl.ssl.laplace(W, device="cpu").distribute(
        tgl.GLTConfig(devices="cpu"))
    C, V = tal.spectral_covariance(m, k=8)
    Ct, Vt = tal.spectral_covariance(tgl.ssl.laplace(W, device="cpu"), k=8)
    Cj, _ = jal.spectral_covariance(jgl.ssl.laplace(W).distribute(
        JConfig(mesh_shape=(4,), devices=jax.devices()[:4])), k=8)
    np.testing.assert_allclose(C, Ct, rtol=0, atol=1e-8)
    np.testing.assert_allclose(C, np.asarray(Cj), rtol=0, atol=1e-8)
    assert V.shape == Vt.shape
