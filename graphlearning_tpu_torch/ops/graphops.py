"""Neighborhood aggregation over the padded-ELL graph, in plain torch.

Counterpart of ``graphlearning_tpu/ops/graphops.py:30-225``.  Every op is a
gather plus a reduction over the fixed ``k`` axis.  This is the path for
graphs the band kernels do not take, and the CPU path.  The graph calculus
at the end (gradient, divergence, neighbor min/max, infinity Laplacian)
serves the distance and Lipschitz solvers.
"""

from __future__ import annotations

import numpy as np
import torch

from graphlearning_tpu_torch.core.sparse import SparseGraph


def _as_2d(X):
    if X.dim() == 1:
        return X[:, None], True
    return X, False


def spmm(g: SparseGraph, X):
    """``W @ X``: gather neighbor rows, weight, reduce over k.  Padding
    slots have ``vals == 0`` and a valid column, so no mask is needed."""
    X2, was_1d = _as_2d(X)
    gathered = X2[g.cols]                                # (n, k, d)
    out = torch.einsum("nk,nkd->nd", g.vals.to(X2.dtype), gathered)
    return out[:, 0] if was_1d else out


def neighbor_take(g: SparseGraph, x):
    """``x[g.cols]``: per-slot neighbor values, (n,) -> (n, k)."""
    return x[g.cols]


def spmm_t(g: SparseGraph, X):
    """``W.T @ X`` by a scatter-add over the flattened columns."""
    X2, was_1d = _as_2d(X)
    contrib = g.vals.to(X2.dtype)[:, :, None] * X2[:, None, :]   # (n, k, d)
    out = torch.zeros_like(X2)
    out.index_add_(0, g.cols.reshape(-1), contrib.reshape(g.n * g.k, -1))
    return out[:, 0] if was_1d else out


def degree_vector(g: SparseGraph):
    """Weighted degree ``d_i = sum_j w_ij``."""
    return torch.sum(g.vals, dim=1)


def degree_vector_p(g: SparseGraph, p: float):
    """``d_i = sum_j |w_ij|^p`` over valid entries."""
    vp = torch.where(g.mask(), torch.abs(g.vals) ** p,
                     torch.zeros((), dtype=g.vals.dtype, device=g.device))
    return torch.sum(vp, dim=1)


def diagonal(g: SparseGraph):
    """diag(W).  Padding (col == row, val == 0) contributes nothing."""
    rows = torch.arange(g.n, device=g.device)[:, None]
    return torch.sum(torch.where(g.cols == rows, g.vals,
                                 torch.zeros((), dtype=g.vals.dtype,
                                             device=g.device)), dim=1)


_NORMS = ("combinatorial", "randomwalk", "normalized")


def laplacian_matvec(g: SparseGraph, X, normalization="combinatorial",
                     deg=None):
    """``L @ X``: combinatorial (D - W) X, randomwalk (I - D^-1 W) X,
    normalized (I - D^-1/2 W D^-1/2) X."""
    if deg is None:
        deg = degree_vector(g)
    X2, was_1d = _as_2d(X)
    if normalization == "combinatorial":
        out = deg[:, None] * X2 - spmm(g, X2)
    elif normalization == "randomwalk":
        out = X2 - spmm(g, X2) / deg[:, None]
    elif normalization == "normalized":
        s = 1.0 / torch.sqrt(deg)
        out = X2 - s[:, None] * spmm(g, s[:, None] * X2)
    else:
        raise ValueError(f"normalization must be one of {_NORMS}")
    return out[:, 0] if was_1d else out


def laplacian_diag(g: SparseGraph, normalization="combinatorial", deg=None):
    """diag(L), for Jacobi preconditioning.  Isolated nodes of the
    randomwalk/normalized Laplacians get diagonal 1."""
    if deg is None:
        deg = degree_vector(g)
    dW = diagonal(g)
    if normalization == "combinatorial":
        return deg - dW
    if normalization in ("randomwalk", "normalized"):
        one = torch.ones((), dtype=deg.dtype, device=deg.device)
        return torch.where(deg > 0, 1.0 - dW / torch.clamp(deg, min=1e-30),
                           one)
    raise ValueError(f"normalization must be one of {_NORMS}")


# -- graph calculus -----------------------------------------------------------


def _weights_p(g: SparseGraph, p: float):
    """``w^p`` on valid slots (``g.vals`` itself for p = 1)."""
    if p == 1.0:
        return g.vals
    return torch.where(g.mask(), torch.abs(g.vals) ** p, 0.0)


def gradient(g: SparseGraph, u, weighted=True, p: float = 1.0):
    """Edge field ``(grad u)_ij = w_ij^p (u_j - u_i)`` as an (n, k) tensor;
    padding entries are exactly 0."""
    diff = u[g.cols] - u[:, None]
    if weighted:
        diff = _weights_p(g, p) * diff
    return torch.where(g.mask(), diff, 0.0)


def build_mirror(g: SparseGraph):
    """Host-side: flat index of the mirrored entry (j, i) of each stored
    (i, j), and whether it exists.  Entries without a mirror map to
    themselves.  Returns ``(mirror (n, k) int64, has (n, k) bool)`` on the
    graph's device."""
    cols = g.cols.cpu().numpy().astype(np.int64)
    deg = g.deg.cpu().numpy()
    n, k = g.n, g.k
    rows = np.repeat(np.arange(n, dtype=np.int64)[:, None], k, axis=1)
    valid = np.arange(k)[None, :] < deg[:, None]
    # unique key per stored (i, j); invalid slots never match
    key = np.where(valid, rows * n + cols, -1).reshape(-1)
    mkey = np.where(valid, cols * n + rows, -2).reshape(-1)
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    pos = np.clip(np.searchsorted(sorted_key, mkey), 0, n * k - 1)
    found = sorted_key[pos] == mkey
    mirror = np.where(found, order[pos], np.arange(n * k)).reshape(n, k)
    return (torch.as_tensor(mirror, device=g.device),
            torch.as_tensor(found.reshape(n, k), device=g.device))


def divergence(g: SparseGraph, V, mirror=None, weighted=True, p: float = 1.0):
    """``div(V)_i = (1/2) sum_j w_ij^p (V_ij - V_ji)`` of an (n, k) edge
    field; ``mirror`` from :func:`build_mirror`."""
    if mirror is None:
        raise ValueError("divergence requires mirror indices (build_mirror(g))")
    mirror_idx, has = mirror
    Vt = torch.where(has, V.reshape(-1)[mirror_idx], 0.0)
    A = V - Vt
    if weighted:
        A = _weights_p(g, p) * A
    return 0.5 * torch.sum(torch.where(g.mask(), A, 0.0), dim=1)


def neighbor_min(g: SparseGraph, e):
    """min over the valid entries of an (n, k) edge array (the dtype's
    largest value where a row has none)."""
    big = torch.finfo(e.dtype).max
    return torch.amin(torch.where(g.mask(), e, big), dim=1)


def neighbor_max(g: SparseGraph, e):
    small = torch.finfo(e.dtype).min
    return torch.amax(torch.where(g.mask(), e, small), dim=1)


def infinity_laplacian(g: SparseGraph, u):
    """``(L_inf u)_i = min_j w_ij (u_j - u_i) + max_j w_ij (u_j - u_i)``
    over valid neighbors."""
    e = g.vals * (u[g.cols] - u[:, None])
    return neighbor_min(g, e) + neighbor_max(g, e)
