"""k-means and spectral clustering of graphlearning_tpu_torch against
graphlearning_tpu on the CPU, at float64 (JAX's x64 on).

* ``solvers.kmeans``: on separated blobs the labels equal JAX's up to a
  permutation and the inertia within 1e-9 relative (the draws differ:
  JAX's come from its PRNG keys, the port's from a ``torch.Generator``);
  Lloyd's iterations from given centers against a numpy Lloyd loop.
* ``clustering.spectral`` on ``make_moons(400, noise=0.08,
  random_state=0)``: NgJordanWeiss within 1 point of JAX's accuracy
  (96.0 %), the other methods agreeing with JAX's labels on >= 0.99 of
  the nodes up to a permutation.
* ``clustering_accuracy`` and ``purity`` equal to JAX's; the base class's
  ``sys.exit`` cases.
* ``clustering.fokker_planck`` on JAX's two-clique graph, k-means from
  JAX's starts (``jax_kmeans_starts``): labels equal to JAX's;
  ``withinss`` equal to JAX's and to a brute-force split; ``RP1D`` with
  the same seed: JAX's labels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearning_tpu as jgl
from graphlearning_tpu.solvers import kmeans as jkmeans
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch.solvers import kmeans as tkmeans
from test_torch_gather import cpu_accel, hub_graph  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def moons():
    import sklearn.datasets as datasets

    X, y = datasets.make_moons(n_samples=400, noise=0.08, random_state=0)
    return jgl.weightmatrix.knn(X, 10), y


def blobs(n, k, dim, seed, spread=0.3):
    rs = np.random.RandomState(seed)
    centers = rs.randn(k, dim) * 4
    labels = rs.randint(0, k, n)
    return centers[labels] + spread * rs.randn(n, dim), labels


def agreement(a, b):
    """The share of nodes on which two labelings agree under the best
    matching of their labels."""
    return jgl.clustering.clustering_accuracy(a, b) / 100.0


@pytest.mark.parametrize("k,dim", [(3, 2), (5, 4), (8, 3)])
def test_kmeans_on_blobs_matches_jax(k, dim):
    X, y = blobs(600, k, dim, seed=k)
    lj, ij = jkmeans._kmeans_all(jnp.asarray(X), jax.random.PRNGKey(0), k=k,
                                 n_init=10, max_iter=300)
    gen = torch.Generator().manual_seed(0)
    lt, it = tkmeans._kmeans_all(torch.as_tensor(X), k, 10, 300, gen=gen)
    assert lt.dtype == torch.int32 and lt.shape == (600,)
    assert agreement(lt.numpy(), np.asarray(lj)) == 1.0
    assert agreement(lt.numpy(), y) == 1.0
    assert abs(float(it) - float(ij)) <= 1e-9 * float(ij)
    pub = tgl.solvers.kmeans.kmeans(X, k, seed=0, device="cpu")
    np.testing.assert_array_equal(pub.numpy(), lt.numpy())


def _lloyd_numpy(X, C, max_iter):
    """Lloyd's iterations, an empty cluster keeping its center."""
    lab = np.argmin(((X[:, None, :] - C[None]) ** 2).sum(-1), axis=1)
    for _ in range(max_iter):
        Cn = C.copy()
        for j in range(C.shape[0]):
            if np.any(lab == j):
                Cn[j] = X[lab == j].mean(axis=0)
        new = np.argmin(((X[:, None, :] - Cn[None]) ** 2).sum(-1), axis=1)
        C = Cn
        if np.array_equal(new, lab):
            break
        lab = new
    return lab, ((X - C[lab]) ** 2).sum()


def test_kmeans_lloyd_from_given_centers():
    """Three restarts from given centers (one with a center far from every
    point, whose cluster stays empty): the least inertia wins, labels and
    inertia as a numpy Lloyd loop gives them."""
    X, _ = blobs(300, 3, 2, seed=7, spread=1.5)
    rs = np.random.RandomState(1)
    C0 = X[rs.choice(300, (3, 3), replace=False)].copy()
    C0[1, 2] = [100.0, 100.0]
    lt, it = tkmeans._kmeans_all(torch.as_tensor(X), 3, 3, 300,
                                 C0=torch.as_tensor(C0))
    refs = [_lloyd_numpy(X, C0[r], 300) for r in range(3)]
    best = int(np.argmin([r[1] for r in refs]))
    np.testing.assert_array_equal(lt.numpy(), refs[best][0])
    assert abs(float(it) - refs[best][1]) <= 1e-9 * refs[best][1]
    lab1, _ = tkmeans._kmeans_all(torch.as_tensor(X), 3, 1, 300,
                                  C0=torch.as_tensor(C0[1:2]))
    assert 2 not in lab1.numpy()


def test_kmeans_seeds():
    X, _ = blobs(500, 6, 3, seed=2, spread=1.0)
    a = tgl.solvers.kmeans.kmeans(X, 6, seed=3, device="cpu")
    b = tgl.solvers.kmeans.kmeans(X, 6, seed=torch.Generator().manual_seed(3),
                                  device="cpu")
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_array_equal(
        tgl.solvers.kmeans.kmeans(torch.as_tensor(X), 6, seed=3).numpy(),
        a.numpy())


def test_kmeans_plus_plus_seeds_each_blob():
    """Greedy k-means++ puts one starting center in each of well separated
    blobs, in every restart."""
    X, y = blobs(400, 5, 2, seed=4, spread=0.1)
    Xt = torch.as_tensor(X)
    C = tkmeans._plus_plus(Xt, torch.sum(Xt * Xt, dim=1), 5, 4,
                           torch.Generator().manual_seed(0))
    for r in range(4):
        near = np.argmin(((X[:, None, :] - C[r].numpy()[None]) ** 2).sum(-1),
                         axis=0)
        assert len(set(y[near])) == 5


@pytest.mark.parametrize("method", ["NgJordanWeiss", "ShiMalik",
                                    "combinatorial"])
def test_spectral_matches_jax(moons, method):
    W, y = moons
    pt = tgl.clustering.spectral(W, 2, method=method,
                                 device="cpu").fit_predict()
    pj = jgl.clustering.spectral(W, 2, method=method).fit_predict()
    assert pt.shape == (400,) and set(np.unique(pt)) <= {0, 1}
    acc_t = tgl.clustering.clustering_accuracy(pt, y)
    acc_j = jgl.clustering.clustering_accuracy(pj, y)
    if method == "NgJordanWeiss":
        assert acc_j == 96.0 and abs(acc_t - acc_j) <= 1.0
    assert agreement(pt, pj) >= 0.99


def test_spectral_extra_dim_and_seed(moons):
    """``extra_dim`` widens the embedding, not the clusters; ``seed=None``
    draws k-means' seed from numpy's global state."""
    W, y = moons
    model = tgl.clustering.spectral(tgl.graph(W, device="cpu"), 2,
                                    extra_dim=2)
    pred = model.fit_predict()
    assert set(np.unique(pred)) <= {0, 1}
    assert ("normalized", "exact", 4, None, 0, 0, 1) in \
        model.graph.eigendata["normalized"]
    pj = jgl.clustering.spectral(W, 2, extra_dim=2).fit_predict()
    assert abs(tgl.clustering.clustering_accuracy(pred, y)
               - jgl.clustering.clustering_accuracy(pj, y)) <= 1.0
    np.random.seed(5)
    a = tgl.clustering.spectral(W, 2, seed=None, device="cpu").fit_predict()
    np.random.seed(5)
    b = tgl.clustering.spectral(W, 2, seed=None, device="cpu").fit_predict()
    np.testing.assert_array_equal(a, b)


def test_spectral_on_the_gather_agrees_with_plain(hub_graph, cpu_accel,
                                                  monkeypatch):
    """On the hub graph the eigensolve takes the gather; three clusters,
    as on the plain path."""
    from graphlearning_tpu_torch.ops import accel as taccel

    W, y, _ = hub_graph
    model = tgl.clustering.spectral(W.copy(), 3, device="cpu")
    pred = model.fit_predict()
    key = ("normalized", "exact", 3, None, 0, 0, 1)
    assert "GatherAccel" in model.graph.eigen_info[key]["path"]
    monkeypatch.setattr(taccel, "enabled", lambda device: False)
    ref = tgl.clustering.spectral(W, 3, device="cpu").fit_predict()
    assert agreement(pred, ref) >= 0.99
    pj = jgl.clustering.spectral(W, 3).fit_predict()
    assert abs(tgl.clustering.clustering_accuracy(pred, y)
               - jgl.clustering.clustering_accuracy(pj, y)) <= 1.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_accuracy_and_purity_match_jax(seed):
    rs = np.random.RandomState(seed)
    true = rs.randint(0, 4, 300) * 3 - 1          # classes -1, 2, 5, 8
    pred = rs.randint(0, 5 + seed, 300)
    assert tgl.clustering.clustering_accuracy(pred, true) == \
        jgl.clustering.clustering_accuracy(pred, true)
    assert tgl.clustering.purity(pred, true) == \
        jgl.clustering.purity(pred, true)
    assert tgl.clustering.clustering_accuracy(true // 3 + 1, true) == 100.0


def test_base_class_exits(moons):
    W = moons[0]
    model = tgl.clustering.spectral(W, 2, device="cpu")
    with pytest.raises(SystemExit, match="not been fitted"):
        model.predict()
    with pytest.raises(SystemExit, match="Invalid spectral clustering"):
        tgl.clustering.spectral(W, 2, method="bogus", device="cpu").fit()
    with pytest.raises(NotImplementedError, match="P15"):
        model.distribute()
    with pytest.raises(NotImplementedError, match="_fit"):
        tgl.clustering.clustering(W, 2, device="cpu").fit()
    model.fit()
    assert model.fitted and model.predict() is model.cluster_labels


# -- Fokker-Planck, withinss and RP1D ------------------------------------------


def _jax_plus_plus(X, key, k):
    """The JAX package's greedy k-means++ start of one restart
    (``solvers/kmeans.py``, ``plus_plus_init``), as JAX draws it."""
    n = X.shape[0]
    Xsq = jnp.sum(X * X, axis=1)
    L = 2 + int(np.log(max(k, 2)))
    k0, key = jax.random.split(key)
    C = jnp.zeros((k, X.shape[1]), X.dtype).at[0].set(
        X[jax.random.randint(k0, (), 0, n)])
    d2 = jnp.maximum(Xsq - 2.0 * (X @ C[0]) + jnp.sum(C[0] * C[0]), 0.0)
    for i in range(1, k):
        kc, key = jax.random.split(key)
        logits = jnp.where(d2 > 0, jnp.log(d2), -jnp.inf)
        cand = X[jax.random.categorical(kc, logits, shape=(L,))]
        d2c = jnp.maximum(Xsq[None, :] - 2.0 * (cand @ X.T)
                          + jnp.sum(cand * cand, axis=1)[:, None], 0.0)
        best = jnp.argmin(jnp.sum(jnp.minimum(d2[None, :], d2c), axis=1))
        C = C.at[i].set(cand[best])
        d2 = jnp.minimum(d2, d2c[best])
    return C


@pytest.fixture
def jax_kmeans_starts(monkeypatch):
    """The port's k-means from JAX's starts: the restarts' keys split from
    the seed as JAX splits them."""
    def plus_plus(X, Xsq, k, n_init, gen):
        keys = jax.random.split(jax.random.PRNGKey(gen.initial_seed()),
                                n_init)
        Xj = jnp.asarray(X.numpy())
        return torch.tensor(np.stack([np.asarray(_jax_plus_plus(Xj, key, k))
                                      for key in keys]))

    monkeypatch.setattr(tkmeans, "_plus_plus", plus_plus)


def _two_cliques():
    """JAX's test graph (``tests/test_clustering.py``): two 30-node cliques
    joined by one weak edge."""
    import scipy.sparse as sp

    A = np.ones((30, 30)) - np.eye(30)
    W = sp.block_diag([A, A]).tolil()
    W[0, 30] = W[30, 0] = 0.01
    return W.tocsr(), np.repeat([0, 1], 30)


@pytest.mark.parametrize("beta,t", [(0.5, 1), (0.2, 3)])
def test_fokker_planck_matches_jax(jax_kmeans_starts, beta, t):
    """On JAX's starts the labels equal JAX's (not only up to a
    permutation), and the cliques are separated."""
    W, y = _two_cliques()
    pj = jgl.clustering.fokker_planck(W, 2, beta=beta, t=t,
                                      seed=0).fit_predict()
    pt = tgl.clustering.fokker_planck(W, 2, beta=beta, t=t, seed=0,
                                      device="cpu").fit_predict()
    np.testing.assert_array_equal(pt, pj)
    assert tgl.clustering.clustering_accuracy(pt, y) == 100.0


def test_fokker_planck_density_and_seed():
    """A density ``rho`` and a seed drawn from numpy's global state: the
    same labels for the same state, within a point of JAX's accuracy."""
    W, y = _two_cliques()
    rho = np.linspace(1.0, 2.0, 60)
    np.random.seed(2)
    a = tgl.clustering.fokker_planck(W, 2, rho=rho, device="cpu").fit_predict()
    np.random.seed(2)
    b = tgl.clustering.fokker_planck(W, 2, rho=rho, device="cpu").fit_predict()
    np.testing.assert_array_equal(a, b)
    pj = jgl.clustering.fokker_planck(W, 2, rho=rho, seed=0).fit_predict()
    assert abs(tgl.clustering.clustering_accuracy(a, y)
               - jgl.clustering.clustering_accuracy(pj, y)) <= 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_withinss_matches_jax_and_brute_force(seed):
    rs = np.random.RandomState(seed)
    x = np.concatenate([rs.randn(50), rs.randn(70) + 5.0])
    w, m = tgl.clustering.withinss(x)
    wj, mj = jgl.clustering.withinss(x)
    assert w == wj and m == mj
    xs = np.sort(x)
    best = min(((xs[:i] - xs[:i].mean()) ** 2).sum()
               + ((xs[i:] - xs[i:].mean()) ** 2).sum()
               for i in range(1, len(xs)))
    np.testing.assert_allclose(w, best / (len(x) * np.std(x) ** 2),
                               rtol=1e-10)
    assert 1.0 < m < 4.0


@pytest.mark.parametrize("seed", [0, 3])
def test_rp1d_matches_jax(seed):
    rs = np.random.RandomState(1)
    X = np.vstack([rs.randn(60, 5), rs.randn(60, 5) + 8.0])
    pt = tgl.clustering.RP1D(X, T=50, seed=seed, device="cpu")
    np.testing.assert_array_equal(pt, jgl.clustering.RP1D(X, T=50,
                                                          seed=seed))
    assert pt.dtype == np.float64
    assert tgl.clustering.clustering_accuracy(pt, np.repeat([0, 1], 60)) \
        == 100.0
