"""Graph clustering (counterpart of ``graphlearning_tpu/clustering.py``):
the ``clustering`` base class, spectral clustering, Fokker-Planck
clustering, INCRES, the 1-D split ``withinss`` and random-projection
clustering ``RP1D``, and the Hungarian-matched clustering accuracy and
purity.

Spectral clustering takes the low-lying eigenvectors of a graph Laplacian
on the device (:meth:`graph.eigen_decomp_device`, on the band or the
gather where ``ops.accel.maybe_build`` takes one) and clusters their rows
with the device k-means (:mod:`solvers.kmeans`); only the int32 labels
come back to the host.  INCRES's diffusion runs on the bf16 band or the
gather likewise (:mod:`solvers.incres`).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from graphlearning_tpu_torch.core import graphclass as _graphmod


class clustering:
    """Base class: ``fit`` / ``predict`` / ``fit_predict`` over a
    subclass's ``_fit``."""

    def __init__(self, W, num_clusters, device=None):
        if isinstance(W, _graphmod.graph):
            self.graph = W
        else:
            self.graph = _graphmod.graph(W, device=device)
        self.cluster_labels = None
        self.num_clusters = num_clusters
        self.fitted = False

    def distribute(self, mesh="auto", strict=False):
        """Sharded execution comes with the distribution layer, not ported
        yet."""
        raise NotImplementedError(
            "clustering.distribute: the distribution layer is not ported "
            "yet (P15)")

    def predict(self):
        if not self.fitted:
            sys.exit("Model has not been fitted yet.")
        return self.cluster_labels

    def fit(self, all_labels=None):
        pred = self._fit(all_labels=all_labels)
        self.fitted = True
        self.cluster_labels = pred.cpu().numpy()
        return self.cluster_labels

    def fit_predict(self, all_labels=None):
        self.fit(all_labels=all_labels)
        return self.predict()

    def _fit(self, all_labels=None):
        raise NotImplementedError("Must override _fit")


class spectral(clustering):
    """Spectral clustering: the first ``num_clusters + extra_dim``
    eigenvectors of the combinatorial Laplacian ("combinatorial"), the
    randomwalk one ("ShiMalik") or the normalized one with unit rows
    ("NgJordanWeiss"), then k-means with 10 restarts.  ``seed`` seeds
    k-means; ``None`` draws one from numpy's global state."""

    def __init__(self, W, num_clusters, method="NgJordanWeiss", extra_dim=0,
                 seed=0, device=None):
        super().__init__(W, num_clusters, device=device)
        self.method = method
        self.extra_dim = extra_dim
        self.seed = seed

    def _fit(self, all_labels=None):
        from graphlearning_tpu_torch.solvers.kmeans import kmeans

        norm_of = {"combinatorial": "combinatorial",
                   "ShiMalik": "randomwalk",
                   "NgJordanWeiss": "normalized"}
        if self.method not in norm_of:
            sys.exit("Invalid spectral clustering method " + self.method)
        k = self.num_clusters + self.extra_dim
        _, vec = self.graph.eigen_decomp_device(
            normalization=norm_of[self.method], k=k)
        if self.method == "NgJordanWeiss":
            norms = torch.sqrt(torch.sum(vec * vec, dim=1))
            vec = vec / torch.clamp(norms[:, None], min=1e-30)
        seed = (int(np.random.randint(2**31)) if self.seed is None
                else int(self.seed))
        return kmeans(vec, self.num_clusters, n_init=10, seed=seed)


class fokker_planck(clustering):
    """Fokker-Planck clustering: ``Q = beta Q_ms + (1 - beta) Q_1``, ``Q_1``
    minus the Coifman-Lafon Laplacian and ``Q_ms`` the mean-shift generator
    of the density ``rho`` (the positive part of the weighted gradient of
    ``1 / rho``, transposed, less its row sums), then k-means (10
    restarts) on the rows of ``expm(Q t)``.  ``Q`` is dense and
    ``torch.linalg.matrix_exp`` runs on the device, so the cost is O(n^3):
    a method for small graphs.  ``seed`` seeds k-means; None draws one
    from numpy's global state."""

    def __init__(self, W, num_clusters, beta=0.5, t=1, rho=None, seed=None,
                 device=None):
        super().__init__(W, num_clusters, device=device)
        self.beta = beta
        self.t = t
        self.rho = (np.ones(self.graph.num_nodes) if rho is None
                    else np.asarray(rho))
        self.seed = seed

    def generator(self):
        """The generator ``Q`` (scipy sparse, host) of the diffusion."""
        import scipy.sparse as sp

        G = self.graph
        n = G.num_nodes
        Q1 = -G.laplacian(normalization="coifmanlafon")
        Qms = G.gradient(1.0 / self.rho, weighted=True).T.tocsr()
        Qms.data[Qms.data < 0] = 0
        Qms.eliminate_zeros()
        Qms = Qms - sp.spdiags(np.asarray(Qms @ np.ones(n)), 0, n, n)
        return self.beta * Qms + (1 - self.beta) * Q1

    def _fit(self, all_labels=None):
        from graphlearning_tpu_torch import config
        from graphlearning_tpu_torch.solvers.kmeans import kmeans

        dev = self.graph.device
        Qd = torch.as_tensor(self.generator().toarray(), device=dev).to(
            config.float_dtype(dev))
        with config.exact_matmul():
            expQt = torch.linalg.matrix_exp(Qd * self.t)
        seed = (int(np.random.randint(2**31)) if self.seed is None
                else int(self.seed))
        return kmeans(expQt, self.num_clusters, n_init=10, seed=seed)


class incres(clustering):
    """INCRES incremental reseeding: ``T`` rounds that plant ``m`` seeds in
    each cluster (``m`` grows by ``Dm = max(int(speed 1e-4 n / k), 1)`` a
    round), grow them by the random walk ``W D^-1`` until every node is
    reached, and relabel by the largest diffusion
    (:func:`solvers.incres.rounds`).  The walk runs on the bf16 band or
    the gather where :func:`~ops.accel.maybe_build` takes one, as the JAX
    package's inexact mode.  The start labels come from
    ``np.random.RandomState(seed)`` (numpy's global state when ``seed`` is
    None), as the JAX package draws them; each round's ``(k, n)`` uniform
    scores from a ``torch.Generator`` on the device seeded by ``seed`` (or
    a seed drawn from numpy's global state), so they are not the JAX
    package's draws.  ``self.steps`` holds each round's grow steps.  With
    ``all_labels`` the fit runs the reference's host loop (the seeds
    drawn by numpy, the walk on the plain path) and prints each round's
    accuracy."""

    def __init__(self, W, num_clusters, speed=5, T=200, seed=None,
                 device=None):
        super().__init__(W, num_clusters, device=device)
        self.speed = speed
        self.T = T
        self.seed = seed

    def _fit(self, all_labels=None):
        from graphlearning_tpu_torch import config
        from graphlearning_tpu_torch.ops import accel as _accel
        from graphlearning_tpu_torch.ops import graphops as _ops
        from graphlearning_tpu_torch.solvers import incres as _incres

        G = self.graph
        n, k = G.num_nodes, self.num_clusters
        g = G.sparse
        dev = G.device
        deg = _ops.degree_vector(g)
        rs = (np.random if self.seed is None
              else np.random.RandomState(self.seed))
        dev_seed = (int(np.random.randint(2**31)) if self.seed is None
                    else int(self.seed))
        Dm = max(int(self.speed * 1e-4 * n / k), 1)
        u = rs.randint(0, k, size=n)
        info = {}

        if all_labels is None:
            draw = _incres.uniform(
                torch.Generator(device=dev).manual_seed(dev_seed),
                config.float_dtype(dev))
            u0 = torch.as_tensor(u, device=dev)
            acc = _accel.maybe_build(G.weight_matrix, cache_obj=self,
                                     attr="_accel_incres", device=dev,
                                     mode="bf16")
            if acc is not None:
                deg_p = acc.to_perm(deg)
                dinv_p = torch.where(deg_p > 0, 1.0 / torch.where(
                    deg_p == 0, torch.ones_like(deg_p), deg_p),
                    torch.zeros_like(deg_p))
                labels = acc.incres(dinv_p, u0, draw, k, self.T, Dm, n,
                                    info=info)
            else:
                dinv = torch.where(deg > 0, 1.0 / torch.where(
                    deg == 0, torch.ones_like(deg), deg),
                    torch.zeros_like(deg))
                labels = _incres.rounds(lambda X: _ops.spmm(g, X), dinv, u0,
                                        draw, k, self.T, Dm, n, info=info)
            self.steps = info["steps"]
            return labels

        # the reference's host loop: numpy plants the seeds each round
        m = 1
        self.steps = []
        for i in range(self.T):
            F = np.zeros((n, k))
            for r in range(k):
                ind = np.where(u == r)[0]
                if len(ind) == 0:
                    ind = np.arange(n)
                F[rs.choice(ind, m), r] = 1
            F = torch.as_tensor(F, device=dev).to(deg.dtype)
            F, it = _incres.grow(lambda F: _ops.spmm(g, F / deg[:, None]),
                                 F, n)
            self.steps.append(int(it))
            u = torch.argmax(F, dim=1).cpu().numpy()
            m = m + Dm
            acc = clustering_accuracy(u, all_labels)
            print("Iteration %d: Accuracy = %.2f%%, #seeds = %d"
                  % (i, acc, m))
        return torch.as_tensor(u)


def withinss(x):
    """The exact 1-D 2-means split of ``x`` by a scan of the sorted values:
    ``(w, m)``, ``w`` the within-cluster sum of squares over ``n`` times
    the variance and ``m`` the largest value of the lower cluster."""
    x = np.sort(np.asarray(x, dtype=float))
    n = x.shape[0]
    sigma = np.std(x)
    csum = np.cumsum(x)
    total = csum[-1]
    i = np.arange(1, n)
    m1 = csum[:-1] / i
    m2 = (total - csum[:-1]) / (n - i)
    v = i * m1**2 + (n - i) * m2**2
    ind = np.argmax(v)
    w = (np.sum(x**2) - v[ind]) / (n * sigma**2)
    return w, x[ind]


def RP1D(X, T=100, seed=None, device=None):
    """Random-projection 1-D clustering into two clusters: ``T`` random
    directions drawn from ``np.random.RandomState(seed)``, all projections
    in one product on the device, and the direction whose :func:`withinss`
    split is best (the first on ties) gives the labels (float 0 / 1)."""
    from graphlearning_tpu_torch import config

    X = np.asarray(X)
    n, d = X.shape
    v = np.random.RandomState(seed).rand(T, d)
    dev = config.device(device)
    dtype = config.float_dtype(dev)
    with config.exact_matmul():
        P = (torch.as_tensor(X, device=dev).to(dtype)
             @ torch.as_tensor(v.T, device=dev).to(dtype)).cpu().numpy()
    wmin, imin, mbest = np.inf, 0, 0.0
    for i in range(T):
        w, m = withinss(P[:, i])
        if w < wmin:
            wmin, imin, mbest = w, i, m
    labels = np.zeros(n)
    labels[P[:, imin] > mbest] = 1
    return labels


def clustering_accuracy(pred_labels, true_labels):
    """Clustering accuracy in percent under the best matching of clusters
    to classes (scipy's ``linear_sum_assignment``)."""
    from scipy.optimize import linear_sum_assignment

    pred = np.asarray(pred_labels).astype(int)
    tl = np.asarray(true_labels).copy()
    unique_classes, tl = np.unique(tl, return_inverse=True)
    num_classes = len(unique_classes)
    num_pred = int(pred.max()) + 1
    C = np.zeros((num_pred, num_classes))
    for i in range(num_pred):
        for j in range(num_classes):
            C[i, j] = np.sum((pred == i) & (tl == j))
    row, col = linear_sum_assignment(-C)
    return 100.0 * C[row, col].sum() / len(tl)


def purity(cluster_labels, true_labels):
    """Cluster purity in percent: each cluster counted by its largest
    class."""
    pred = np.asarray(cluster_labels).astype(int)
    tl = np.asarray(true_labels)
    n = len(tl)
    total = 0
    for c in np.unique(pred):
        members = tl[pred == c]
        if len(members):
            _, counts = np.unique(members, return_counts=True)
            total += counts.max()
    return 100.0 * total / n
