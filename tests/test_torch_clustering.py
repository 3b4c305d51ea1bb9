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
