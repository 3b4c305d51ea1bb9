"""The kNN weight matrix, and the arithmetic of the plain solvers.

:func:`weight_matrix` is a frozen copy of the Gaussian branch of
``graphlearning_tpu_torch/weightmatrix.py:249-251`` (the self-tuning
weights ``exp(-4 |x_i - x_j|^2 / d_k(x_i)^2)``, ``d_k`` the distance to the
k-th neighbour) and ``:297-310`` (the COO build, the symmetrisation ``(W +
W^T) / 2`` and the zeroed diagonal), in float64 on the host.

:class:`Arith` carries one precision through a solve: ``float64`` (the
reference), or ``tf32``, the control one step below the float32 that the
configurations state: float32 vectors, every product's operands rounded
to TF32 as a tensor core takes them, sums in float32."""

import warnings

import numpy as np
import scipy.sparse as sp
import torch


def weight_matrix(ind, dist, k):
    """The symmetric kNN weight matrix (scipy CSR, float64, zero diagonal)
    from ``(ind, dist)`` with the node itself first, of its first ``k + 1``
    columns."""
    ind = np.asarray(ind)[:, :k + 1]
    dist = np.asarray(dist, dtype=np.float64)[:, :k + 1]
    n = ind.shape[0]
    D = dist * dist
    eps = D[:, k]
    weights = np.exp(-4.0 * D / np.maximum(eps[:, None], 1e-30))
    self_ind = np.repeat(np.arange(n), k + 1)
    W = sp.coo_matrix((weights.flatten(), (self_ind, ind.flatten())),
                      shape=(n, n)).tocsr()
    W = sp.csr_matrix((W + W.T) / 2)
    W.setdiag(0)
    W.eliminate_zeros()
    return W


def round_tf32(x):
    """``x`` (float32) rounded to TF32's 10 mantissa bits, to nearest with
    ties away from zero (``cvt.rna.tf32.f32``)."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0x1000) & ~0x1FFF
    return b.view(torch.float32)


class Arith:
    def __init__(self, W, prec, device):
        """``W`` scipy CSR; ``prec`` float64 or tf32."""
        if prec not in ("float64", "tf32"):
            raise ValueError(f"unknown precision {prec!r}")
        self.prec = prec
        self.device = device
        self.dtype = {"float64": torch.float64, "tf32": torch.float32}[prec]
        W = sp.csr_matrix(W)
        vals = torch.as_tensor(W.data, dtype=torch.float64)
        if prec == "tf32":
            vals = round_tf32(vals.to(torch.float32))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)   # "beta state"
            self.W = torch.sparse_csr_tensor(
                torch.as_tensor(W.indptr, dtype=torch.int64),
                torch.as_tensor(W.indices, dtype=torch.int64), vals,
                size=W.shape, check_invariants=False).to(device)
        self.n = W.shape[0]
        self.deg = self.vec(np.asarray(W.sum(axis=1)).ravel())

    def vec(self, a):
        """A host array or tensor as a tensor of this precision."""
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                               device=self.device).to(self.dtype)

    def spmm(self, X):
        """``W @ X`` for ``X`` (n, c) of this precision."""
        if self.prec == "float64":
            return torch.sparse.mm(self.W, X)
        return torch.sparse.mm(self.W, round_tf32(X))
