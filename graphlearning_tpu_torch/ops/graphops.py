"""Neighborhood aggregation over the padded-ELL graph, in plain torch.

Counterpart of ``graphlearning_tpu/ops/graphops.py:30-225``.  Every op is a
gather plus a reduction over the fixed ``k`` axis.  This is the path for
graphs the band kernels do not take, and the CPU path.  The graph calculus
at the end (gradient, divergence, neighbor min/max, infinity Laplacian)
serves the distance and Lipschitz solvers.

Operator hooks, as in the JAX package: a graph-like object with
``spmm_``, ``neighbor_take_``, ``deg_`` or ``diag_`` (the sharded graphs
of ``parallel``) computes :func:`spmm`, :func:`neighbor_take`,
:func:`degree_vector` or :func:`diagonal` itself.  That is how a sharded
operator reaches the unchanged solvers.
"""

from __future__ import annotations

import numpy as np
import torch

from graphlearning_tpu_torch.core.sparse import BucketedELL, SparseGraph


def _as_2d(X):
    if X.dim() == 1:
        return X[:, None], True
    return X, False


# Widest X that CUDA sums by a multiply and a reduction over k; wider X,
# and X on the CPU, go through one batched product, the JAX package's form
# (on the CPU its sums follow the JAX package's, which the parity tests
# hold to 1e-10).  On an H100 (the n=65536, k=19 moons ELL, ``graph_ms``)
# the sum took 0.028 / 0.034 / 0.134 / 0.865 ms at d = 1 / 2 / 10 / 16
# against the product's 0.071 / 0.112 / 0.191 / 0.903, the same at d =
# 24, and 0.957 / 0.656 / 1.961 ms at d = 32 / 57 / 171 against 0.911 /
# 0.480 / 1.410 (``tools/plain_spmm_time.py``).
_SUM_DMAX = 16


def spmm(g: SparseGraph, X):
    """``W @ X``: gather neighbor rows, weight, reduce over k.  Padding
    slots have ``vals == 0`` and a valid column, so no mask is needed.
    A ``g`` with ``spmm_`` computes the product itself."""
    X2, was_1d = _as_2d(X)
    custom = getattr(g, "spmm_", None)
    if custom is not None:
        out = custom(X2)
        return out[:, 0] if was_1d else out
    gathered = X2[g.cols]                                # (n, k, d)
    vals = g.vals.to(X2.dtype)
    if X2.is_cuda and X2.shape[1] <= _SUM_DMAX:
        out = torch.sum(vals[:, :, None] * gathered, dim=1)
    else:
        out = torch.einsum("nk,nkd->nd", vals, gathered)
    return out[:, 0] if was_1d else out


def neighbor_take(g: SparseGraph, x, slot=None):
    """``x[g.cols]``: per-slot neighbor values, (n,) -> (n, k); with
    ``slot`` (n,), each row's value at that slot alone, (n,) -> (n,).  A
    ``g`` with ``neighbor_take_`` takes them itself (``slot`` passed on
    when given)."""
    custom = getattr(g, "neighbor_take_", None)
    if custom is not None:
        return custom(x) if slot is None else custom(x, slot)
    return x[_slot_cols(g.cols, slot)]


def _slot_cols(cols, slot=None):
    """``cols`` (n, k), or with ``slot`` (n,) each row's column there."""
    return cols if slot is None else torch.gather(cols, 1,
                                                  slot[:, None])[:, 0]


def transpose(g: SparseGraph) -> BucketedELL:
    """``W.T`` as a :class:`BucketedELL` (an ELL capped at the 95th
    percentile in-degree, the hub columns' tails in its spill; ``g``
    itself, with no spill, when ``W`` is symmetric), built once on the
    host and kept on ``g``."""
    t = getattr(g, "_transpose", None)
    if t is None:
        W = g.to_scipy()
        if (W != W.T).nnz == 0:
            t = BucketedELL(g, None, None, None, kcap=g.k, m=0)
        else:
            t = BucketedELL.from_scipy(W.T.tocsr(), dtype=g.vals.dtype,
                                       device=g.device)
        g._transpose = t
    return t


def spmm_t(g: SparseGraph, X):
    """``W.T @ X``: :func:`spmm` over the transpose's ELL plus its spill,
    summed in sorted order (:func:`segment_reduce`), so the result is the
    same in every run.  The JAX package scatters over the flattened
    columns, which on CUDA would add by atomics in any order."""
    X2, was_1d = _as_2d(X)
    t = transpose(g)
    out = spmm(t.main, X2)
    if t.m:
        spill = t.sp_vals.to(X2.dtype)[:, None] * X2[t.sp_cols]
        out = out + t.spill_reduce(spill, "sum", 0.0)
    return out[:, 0] if was_1d else out


def degree_vector(g: SparseGraph):
    """Weighted degree ``d_i = sum_j w_ij`` (``g.deg_()`` where ``g`` has
    one: a hybrid graph whose spill edges lie outside its ELL)."""
    custom = getattr(g, "deg_", None)
    if custom is not None:
        return custom()
    return torch.sum(g.vals, dim=1)


def degree_vector_p(g: SparseGraph, p: float):
    """``d_i = sum_j |w_ij|^p`` over valid entries."""
    vp = torch.where(g.mask(), torch.abs(g.vals) ** p,
                     torch.zeros((), dtype=g.vals.dtype, device=g.device))
    return torch.sum(vp, dim=1)


def diagonal(g: SparseGraph):
    """diag(W).  Padding (col == row, val == 0) contributes nothing.
    ``g.diag_()`` where ``g`` has one (a hybrid graph, or a rank's rows
    of a sharded one)."""
    custom = getattr(g, "diag_", None)
    if custom is not None:
        return custom()
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
