"""Graph clustering (counterpart of ``graphlearning_tpu/clustering.py:24-132,
346-375``): the ``clustering`` base class, spectral clustering, and the
Hungarian-matched clustering accuracy and purity.

Spectral clustering takes the low-lying eigenvectors of a graph Laplacian
on the device (:meth:`graph.eigen_decomp_device`, on the band or the
gather where ``ops.accel.maybe_build`` takes one) and clusters their rows
with the device k-means (:mod:`solvers.kmeans`); only the int32 labels
come back to the host.
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
