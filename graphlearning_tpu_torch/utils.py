"""Label encodings, class priors and sparse helpers (counterpart of
``graphlearning_tpu/utils.py:194-235``)."""

from __future__ import annotations

import numpy as np


def labels_to_onehot(labels, k=None, standardize=False):
    labels = np.asarray(labels).astype(int)
    n = labels.shape[0]
    if standardize:
        _, labels = np.unique(labels, return_inverse=True)
    kk = int(np.max(labels)) + 1 if n > 0 else 0
    k = max(kk, k if k is not None else 0)
    onehot = np.zeros((n, k))
    onehot[np.arange(n), labels] = 1
    return onehot


def class_priors(labels):
    """The share of each class among the nonnegative ``labels``, classes
    in ascending order."""
    labels = np.asarray(labels)
    L = np.unique(labels)
    L = L[L >= 0]
    n = np.sum(labels >= 0)
    return np.array([np.sum(labels == l) / n for l in L])


def sparse_max(A, B):
    """Elementwise max of two nonnegative scipy sparse matrices."""
    I = (A + B) > 0
    IB = B > A
    IA = I - IB
    return A.multiply(IA) + B.multiply(IB)
