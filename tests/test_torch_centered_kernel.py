"""The centered kernel method of graphlearning_tpu_torch against
graphlearning_tpu on the CPU, at float64 (JAX's x64 on).

The power iteration starts from JAX's normal draw (the ``jax_normal_start``
fixture replaces ``solvers.centered.start``), so the fixed points are the
same: ``u`` within 1e-8 of JAX's plain path, on the port's plain path, its
gather (a 10-d mixture) and its band (the kernels' twins, forced
on the CPU); the gather entry fed JAX's gather's own start (drawn in its
permuted space) within 1e-8 of that entry; the predictions equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearning_tpu as jgl
from graphlearning_tpu.ops import gather as jgather
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch.ops import accel as taccel
from graphlearning_tpu_torch.ops import gather as tgather
from graphlearning_tpu_torch.solvers import centered as tcentered
from test_torch_gather import cpu_accel  # noqa: F401
from test_torch_mbo import moons  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def mixture():
    """1200 points of a 10-d three-cluster mixture, exact 8-NN gaussian
    weights, symmetrized; 5 labels a class.  Returns ``(W, labels,
    train_ind)``."""
    import scipy.sparse as sp
    from scipy.spatial import cKDTree

    rs = np.random.RandomState(0)
    n, dim, k = 1200, 10, 8
    labels = rs.randint(0, 3, n)
    X = (rs.randn(3, dim) * 1.6)[labels] + rs.randn(n, dim)
    dist, ind = cKDTree(X).query(X, k=k + 1)
    w = np.exp(-4 * dist[:, 1:] ** 2 / dist[:, -1:] ** 2)
    W = sp.csr_matrix((w.ravel(), (np.repeat(np.arange(n), k),
                                   ind[:, 1:].ravel())), shape=(n, n))
    W = ((W + W.T) / 2).tocsr()
    train_ind = np.concatenate([rs.choice(np.where(labels == c)[0], 5,
                                          replace=False) for c in range(3)])
    return W, labels, train_ind


@pytest.fixture
def jax_normal_start(monkeypatch):
    def start(n, seed, dtype, device):
        e = jax.random.normal(jax.random.PRNGKey(seed), (n, 1),
                              dtype=jnp.float64)
        return torch.tensor(np.asarray(e), device=device).to(dtype)

    monkeypatch.setattr(tcentered, "start", start)


def _fits(W, y, ti, seed=0):
    mj = jgl.ssl.centered_kernel(W, seed=seed)
    uj = mj.fit(ti, y[ti])
    mt = tgl.ssl.centered_kernel(W, seed=seed, device="cpu")
    ut = mt.fit(ti, y[ti])
    return mt, ut, uj, mt.predict(), mj.predict()


def test_plain_matches_jax(moons, jax_normal_start):
    W, y, ti, _ = moons
    m, ut, uj, pt, pj = _fits(W, y, ti, seed=2)
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(pt, pj)
    assert 10 < m.iters < 10**5 and getattr(m, "_accel_ck", None) is None


def test_band_matches_jax(moons, jax_normal_start, cpu_accel):
    W, y, ti, _ = moons
    m, ut, uj, pt, pj = _fits(W.copy(), y, ti)
    assert isinstance(m._accel_ck, taccel.AccelSpMM)
    assert m._accel_ck.mode == "f32" and m._accel_ck.n_pad > W.shape[0]
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(pt, pj)


def test_gather_matches_jax(mixture, jax_normal_start, cpu_accel,
                            monkeypatch):
    monkeypatch.setattr(taccel, "_band_hostile", lambda W: True)
    W, y, ti = mixture
    m, ut, uj, pt, pj = _fits(W.copy(), y, ti, seed=1)
    assert isinstance(m._accel_ck, tgather.GatherAccel)
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-8)
    np.testing.assert_array_equal(pt, pj)


def test_gather_entry_on_jax_gather_start(mixture):
    """The gather entry fed the JAX gather's own start (its normal draw in
    permuted space) gives that entry's ``u``."""
    W, y, ti = mixture
    n = W.shape[0]
    K = np.zeros((n, 3))
    K[ti, y[ti]] = 1.0
    K[ti] -= K[ti].sum(axis=0) / len(ti)
    mask = np.zeros(n, bool)
    mask[ti] = True
    key = jax.random.PRNGKey(4)
    ja = jgather.GatherAccel(W, prec="f32")
    uj = ja.from_perm(ja.centered_kernel(
        ja.to_perm(jnp.asarray(K)), ja.to_perm(jnp.asarray(mask)), 1.05,
        1e-10, key, power_it=100, n_true=n))
    e0 = np.asarray(jax.random.normal(key, (n, 1), dtype=jnp.float64))
    ta = tgather.GatherAccel(W, prec="f32", device="cpu")
    info = {}
    ut = ta.from_perm(ta.centered_kernel(
        ta.to_perm(torch.as_tensor(K)), ta.to_perm(torch.as_tensor(mask)),
        1.05, 1e-10, torch.tensor(e0), 100, n, info=info))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-8)
    assert info["iters"] > 10


def test_seeded_start_and_tolerance(moons):
    """The port's own start is a seeded normal draw (the same seed, the same
    ``u``); in float32 the tolerance is clamped to ``100 eps``."""
    W, y, ti, _ = moons
    fit = lambda seed: tgl.ssl.centered_kernel(W, seed=seed,
                                               device="cpu").fit(ti, y[ti])
    np.testing.assert_array_equal(fit(5), fit(5))
    e = tcentered.start(7, 3, torch.float32, "cpu")
    assert e.shape == (7, 1) and e.dtype == torch.float32
    g32 = tgl.graph(W, dtype=torch.float32, device="cpu").sparse
    n = W.shape[0]
    K = torch.zeros((n, 2), dtype=torch.float32)
    K[ti, y[ti]] = 1.0
    K[ti] -= K[ti].sum(dim=0) / len(ti)
    mask = torch.zeros(n, dtype=torch.bool)
    mask[ti] = True
    info = {}
    u = tcentered.solve(lambda X: tgl.ops.graphops.spmm(g32, X), K, mask,
                        1.05, 100 * torch.finfo(torch.float32).eps,
                        tcentered.start(n, 0, torch.float32, "cpu"), 100, n,
                        info=info)
    assert u.dtype == torch.float32 and info["iters"] < 10**5
    u64 = fit(0)
    assert np.mean(np.argmax(u.numpy(), 1) == np.argmax(u64, 1)) > 0.99
