"""Label encodings, class priors, sparse helpers, the randomized SVD and
the Dirichlet eigenvectors (counterpart of ``graphlearning_tpu/utils.py:
28-40, 92-110, 148-191, 194-235``)."""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from graphlearning_tpu_torch import config
from graphlearning_tpu_torch.core.sparse import SparseGraph
from graphlearning_tpu_torch.ops import graphops as _ops


def _as_matvec(A, device):
    """A callable on ``(n, j)`` tensors from a callable (as it is), a
    :class:`SparseGraph`, a dense numpy array or a scipy sparse matrix (on
    ``device``, in its working dtype: a padded ELL when square, a torch
    CSR otherwise)."""
    if callable(A):
        return A
    if isinstance(A, SparseGraph):
        return lambda X: _ops.spmm(A, X)
    if isinstance(A, np.ndarray):
        At = torch.as_tensor(A, device=device).to(config.float_dtype(device))
        return lambda X: At @ X
    A = sp.csr_matrix(A)
    if A.shape[0] == A.shape[1]:
        g = SparseGraph.from_scipy(A, device=device)
        return lambda X: _ops.spmm(g, X)
    At = torch.sparse_csr_tensor(
        torch.as_tensor(A.indptr.astype(np.int64)),
        torch.as_tensor(A.indices.astype(np.int64)),
        torch.as_tensor(A.data), size=A.shape).to(
            device=device, dtype=config.float_dtype(device))
    return lambda X: torch.sparse.mm(At, X)


def dirichlet_eigenvectors(L, ind, k):
    """Smallest Dirichlet eigenpairs: ``L x = lambda x`` off ``ind``, ``x =
    0`` on ``ind``, by scipy's ``eigsh`` of the interior block on the host,
    as the JAX package computes them.  Returns numpy ``(vals, vecs)``,
    ``vecs`` flat when ``k == 1``."""
    import scipy.sparse.linalg as splinalg

    L = sp.csr_matrix(L)
    n = L.shape[0]
    idx = np.full((n,), True, dtype=bool)
    idx[ind] = False
    A = L[idx, :][:, idx]
    vals, vec = splinalg.eigsh(A, k=k, which="SM")
    vecs = np.zeros((n, k))
    vecs[idx, :] = vec
    if k == 1:
        vecs = vecs.flatten()
    return vals, vecs


def randomized_svd(A, k=10, c=None, q=1, key=None, device=None):
    """Halko-Martinsson-Tropp randomized SVD on ``device``: a Gaussian
    sketch of ``c`` columns (``2 k`` by default) drawn from ``key`` (a
    seed, 0 by default, or a ``torch.Generator``), ``q`` power iterations,
    QR and a small dense SVD.  ``A`` is a scipy sparse matrix, a numpy
    array, a :class:`SparseGraph` or a symmetric operator (a callable with
    a ``shape``).  Returns numpy ``(u, s, vt)`` of the top ``k``."""
    if c is None:
        c = 2 * k
    n = A.shape[1] if hasattr(A, "shape") else None
    if n is None:
        raise ValueError("A must have .shape for randomized_svd")
    dev = A.device if isinstance(A, SparseGraph) else config.device(device)
    matvec = _as_matvec(A, dev)
    if isinstance(A, SparseGraph) or callable(A):
        rmatvec = matvec         # the symmetric operators of the graphs
    else:
        rmatvec = _as_matvec(A.T if isinstance(A, np.ndarray)
                             else sp.csr_matrix(A).T.tocsr(), dev)
    dtype = config.float_dtype(dev)
    Omega = torch.randn((n, c), generator=config.generator(
        0 if key is None else key, dev), dtype=dtype, device=dev)
    return _randomized_svd(matvec, rmatvec, Omega, k, q)


def _randomized_svd(matvec, rmatvec, Omega, k, q):
    """:func:`randomized_svd` from its sketch ``Omega``."""
    with config.exact_matmul():
        Y = matvec(Omega)
        for _ in range(q):
            Y = matvec(rmatvec(Y))
        Q, _ = torch.linalg.qr(Y)
        B = rmatvec(Q).T                         # Q^T A
        u2, s, vt = torch.linalg.svd(B, full_matrices=False)
        u = Q @ u2
    order = torch.argsort(-s)[:k]
    return (u[:, order].cpu().numpy(), s[order].cpu().numpy(),
            vt[order, :].cpu().numpy())


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
