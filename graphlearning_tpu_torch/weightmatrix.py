"""kNN graph construction (counterpart of
``graphlearning_tpu/weightmatrix.py:37-93,195-341``).

Brute-force search is a chunked distance matmul plus ``torch.topk`` on the
device; low-dimensional data takes a host cKDTree.  Kernel weights are
computed on the device.  ``knn`` returns a scipy CSR matrix, as the JAX
package does.  The kNN data of a named dataset is kept in ``knn_dir`` (a
module attribute the caller may reassign) as ``<dataset>_<metric>.npz``
with fields ``J`` (indices) and ``D`` (distances), the JAX package's files.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.sparse as sparse
import torch

from graphlearning_tpu_torch import config, utils

knn_dir = os.path.abspath(os.path.join(os.getcwd(), "knn_data"))


def _chunk_topk(Q, X, Xsq, k: int, similarity: str):
    """Top-k nearest of each query row in Q against all of X (one chunk).
    Returns ``(idx, dist)``."""
    if similarity in ("euclidean", "angular"):
        Qsq = torch.sum(Q * Q, dim=1)
        d2 = Qsq[:, None] - 2.0 * Q @ X.T + Xsq[None, :]
        score, idx = torch.topk(-d2, k, dim=1)
        dist = torch.sqrt(torch.clamp(-score, min=0.0))
    elif similarity == "dot":
        score, idx = torch.topk(Q @ X.T, k, dim=1)
        dist = -score                   # annoy 'dot' convention
    elif similarity == "hamming":
        q1 = torch.sum(Q, dim=1)
        x1 = torch.sum(X, dim=1)
        d = q1[:, None] + x1[None, :] - 2.0 * Q @ X.T
        score, idx = torch.topk(-d, k, dim=1)
        dist = -score
    elif similarity == "manhattan":
        d = torch.sum(torch.abs(Q[:, None, :] - X[None, :, :]), dim=2)
        score, idx = torch.topk(-d, k, dim=1)
        dist = -score
    else:
        raise ValueError(f"invalid similarity {similarity}")
    return idx, dist


def _brute_knn_device(X, k, similarity="euclidean", chunk_size=2048,
                      device=None):
    """Chunked all-pairs kNN on ``device``.  Returns ``(ind, dist)`` numpy
    arrays of shape (n, k), self first."""
    dev = config.device(device)
    dtype = config.float_dtype(dev)
    Xn = np.asarray(X, dtype=np.float64 if dtype == torch.float64
                    else np.float32)
    if similarity == "angular":
        Xn = Xn / np.maximum(np.linalg.norm(Xn, axis=1, keepdims=True), 1e-30)
    n = Xn.shape[0]
    k = min(k, n)
    Xd = torch.as_tensor(Xn, device=dev)
    Xsq = torch.sum(Xd * Xd, dim=1)
    if similarity == "manhattan":
        # materialises (chunk, n, d): keep its chunks small
        chunk_size = max(1, min(chunk_size,
                                (1 << 24) // max(1, n * Xn.shape[1])))
    inds, dists = [], []
    for s in range(0, n, chunk_size):
        idx, dist = _chunk_topk(Xd[s:s + chunk_size], Xd, Xsq, k, similarity)
        inds.append(idx)
        dists.append(dist)
    return (torch.cat(inds).cpu().numpy(), torch.cat(dists).cpu().numpy())


def knnsearch(X, k, method=None, similarity="euclidean", dataset=None,
              metric="raw", device=None):
    """kNN search: ``method`` is 'kdtree' (host cKDTree, the default for
    dim <= 5) or 'brute' (device matmul + top-k, the default above).  The
    parameters are the JAX package's, in its order, with ``device`` last.
    With ``dataset`` the result is also written to
    ``knn_dir/<dataset>_<metric>.npz`` for :func:`load_knn_data`."""
    X = np.asarray(X)
    n, m = X.shape
    k = min(k, n)
    if method is None:
        method = "kdtree" if m <= 5 else "brute"
    if method == "kdtree":
        from scipy import spatial

        if similarity not in ("euclidean", "angular"):
            raise ValueError("Invalid choice of similarity " + similarity)
        Y = X
        if similarity == "angular":
            Y = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-30)
        knn_dist, knn_ind = spatial.cKDTree(Y).query(Y, k=k)
        if k == 1:
            knn_dist = knn_dist[:, None]
            knn_ind = knn_ind[:, None]
    elif method == "brute":
        knn_ind, knn_dist = _brute_knn_device(X, k, similarity=similarity,
                                              device=device)
    else:
        raise ValueError("Invalid choice of knnsearch method " + method)
    if dataset is not None:
        os.makedirs(knn_dir, exist_ok=True)
        np.savez_compressed(
            os.path.join(knn_dir, dataset.lower() + "_" + metric.lower()
                         + ".npz"), J=knn_ind, D=knn_dist)
    return knn_ind, knn_dist


def load_knn_data(dataset, metric="raw"):
    """``(J, D)``, the kNN indices and distances that :func:`knnsearch`
    stored for ``dataset`` and ``metric``, fetched from the GraphLearning
    repository when ``knn_dir`` lacks them."""
    fname = dataset.lower() + "_" + metric.lower() + ".npz"
    path = os.path.join(knn_dir, fname)
    if not os.path.exists(path):
        os.makedirs(knn_dir, exist_ok=True)
        utils.download_file(
            "https://github.com/jwcalder/GraphLearning/raw/master/kNNData/"
            + fname, path)
    return utils.numpy_load(path, "J"), utils.numpy_load(path, "D")


def _knn_weights_device(knn_ind, knn_dist, kernel: str):
    """Self-tuning kernel weights from kNN distances (tensors)."""
    k = knn_dist.shape[1]
    if kernel == "uniform":
        return torch.ones_like(knn_dist)
    if kernel == "gaussian":
        D = knn_dist * knn_dist
        eps = D[:, k - 1]
        return torch.exp(-4.0 * D / torch.clamp(eps[:, None], min=1e-30))
    if kernel == "symgaussian":
        eps = knn_dist[:, k - 1]
        return torch.exp(-4.0 * knn_dist * knn_dist
                         / torch.clamp(eps[:, None] * eps[knn_ind], min=1e-30))
    if kernel == "distance":
        return knn_dist
    if kernel == "singular":
        return 1.0 / torch.where(knn_dist == 0, torch.ones_like(knn_dist),
                                 knn_dist)
    raise ValueError("Invalid choice of kernel: " + kernel)


def knn(data, k, kernel="gaussian", eta=None, symmetrize=True, metric="raw",
        similarity="euclidean", knn_data=None, device=None):
    """kNN weight matrix as scipy CSR.  The parameters are the JAX
    package's, in its order, with ``device`` last.  Symmetrization per
    kernel as in the JAX package.  With ``data`` a dataset name, the kNN
    data stored for it under ``metric`` (:func:`load_knn_data`) is read in
    place of a search.  Low-dimensional (<= 3) point coordinates ride along as
    ``W._glt_points`` for the space-filling-curve ordering of
    ``ops.accel.AccelSpMM``."""
    dev = config.device(device)
    k = k + 1                                   # self counted in knn data
    if knn_data is not None:
        knn_ind, knn_dist = knn_data
    elif isinstance(data, str):
        knn_ind, knn_dist = load_knn_data(data, metric=metric)
    else:
        knn_ind, knn_dist = knnsearch(data, k, similarity=similarity,
                                      device=dev)
    n = knn_ind.shape[0]
    k = min(knn_ind.shape[1], k)
    knn_ind = np.asarray(knn_ind)[:, :k]
    knn_dist = np.asarray(knn_dist)[:, :k]

    if eta is None:
        weights = _knn_weights_device(
            torch.as_tensor(knn_ind.astype(np.int64), device=dev),
            torch.as_tensor(knn_dist, device=dev).to(config.float_dtype(dev)),
            kernel).cpu().numpy()
    else:
        D = knn_dist * knn_dist
        eps = D[:, k - 1]
        weights = eta(D / np.maximum(eps[:, None], 1e-30))

    self_ind = np.repeat(np.arange(n), k)
    W = sparse.coo_matrix((weights.flatten(), (self_ind, knn_ind.flatten())),
                          shape=(n, n)).tocsr()
    if symmetrize:
        if kernel in ("distance", "uniform", "singular"):
            W = utils.sparse_max(W, W.T.tocsr())
        elif kernel == "symgaussian":
            WT = W.T.tocsr()
            W = W + WT.multiply(WT > W) - W.multiply(WT > W)
        else:
            W = (W + W.T) / 2
    W = sparse.csr_matrix(W)
    W.setdiag(0)
    W.eliminate_zeros()
    if np.ndim(data) == 2 and np.shape(data)[1] <= 3:
        W._glt_points = np.asarray(data)
    return W
