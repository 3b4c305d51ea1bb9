"""Neighborhood aggregation over the padded-ELL graph.

Counterpart of ``graphlearning_tpu/ops/graphops.py:30-225``.  Every op is a
gather plus a reduction over the fixed ``k`` axis, in plain torch, but for
the float32 product on CUDA: :func:`plain_ell_spmm`, a CUDA kernel
(``csrc/plain_ell_spmm.cu``) that reads each row's real slots alone.  This
is the path for graphs the band kernels do not take, and the CPU path.
The graph calculus at the end (gradient, divergence, neighbor min/max,
infinity Laplacian) serves the distance and Lipschitz solvers.

Operator hooks, as in the JAX package: a graph-like object with
``spmm_``, ``neighbor_take_``, ``deg_`` or ``diag_`` (the sharded graphs
of ``parallel``) computes :func:`spmm`, :func:`neighbor_take`,
:func:`degree_vector` or :func:`diagonal` itself.  That is how a sharded
operator reaches the unchanged solvers.
"""

from __future__ import annotations

import numpy as np
import torch

from graphlearning_tpu_torch import observability as _obs
from graphlearning_tpu_torch.core.sparse import BucketedELL, SparseGraph
from graphlearning_tpu_torch.ops import _build
from graphlearning_tpu_torch.ops import band_spmm as _bs


def _as_2d(X):
    if X.dim() == 1:
        return X[:, None], True
    return X, False


def spmm(g: SparseGraph, X):
    """``W @ X`` over the ELL's slots, by :func:`plain_ell_spmm`.  A ``g``
    with ``spmm_`` computes the product itself."""
    X2, was_1d = _as_2d(X)
    custom = getattr(g, "spmm_", None)
    if custom is not None:
        out = custom(X2)
    else:
        out = plain_ell_spmm(g.cols, g.vals, g.deg, X2)
    return out[:, 0] if was_1d else out


def _plain_ell_spmm_twin(cols, vals, X):
    """The plain twin of :func:`plain_ell_spmm`: ``X[cols]``, every slot of
    the ``(n, k, d)`` gather, and one batched product over k.  Padding
    slots have ``vals == 0`` and a valid column, so it needs no mask; on
    the CPU its sums follow the JAX package's."""
    return torch.einsum("nk,nkd->nd", vals.to(X.dtype), X[cols])


def plain_ell_spmm(cols, vals, deg, X):
    """``out[i] = sum_{j < deg[i]} vals[i, j] X[cols[i, j]]``: the product
    of an ELL whose rows hold their ``deg[i]`` real slots first.  ``cols``
    (n, k) and ``deg`` (n,) int32, ``vals`` (n, k), ``X`` (rows, d), all on
    one device; ``X`` needs a row for every column of a real slot.

    A float32 ``X`` on CUDA takes one launch of ``csrc/plain_ell_spmm.cu``
    (counted as ``spmm.ell_kernel`` in ``observability.counters``, and in
    ``plain_ell_spmm.launches``), which replaces no TPU kernel (the JAX
    package leaves this product to XLA): bound by bytes, it reads each
    real slot once and materialises nothing, with X's rows through L2.  A
    sub-group of lanes owns a row, a lane a column of X; the sub-group's
    width follows ``d``.  Each output sums its slots in slot order by
    float32 FFMA, with no atomics, so the result is the same in every run.
    ``X`` may be strided by rows; ``out`` is (n, d) float32.  Any other
    ``X`` (the CPU, other dtypes) takes :func:`_plain_ell_spmm_twin`
    (``spmm.ell_torch``)."""
    if (_bs._dispatch_device("plain_ell_spmm", cols, vals, deg, X) == "cpu"
            or X.dtype != torch.float32):
        _obs.counters.add("spmm.ell_torch")
        return _plain_ell_spmm_twin(cols, vals, X)
    _obs.counters.add("spmm.ell_kernel")
    if vals.dtype != torch.float32:
        vals = vals.float()
    # one condition, its message formatted only on failure: the check runs
    # once a product, on the host's side of a CG step
    if not (cols.dtype == torch.int32 and deg.dtype == torch.int32
            and cols.dim() == 2 and vals.shape == cols.shape
            and deg.dim() == 1 and deg.shape[0] == cols.shape[0]
            and X.dim() == 2 and cols.is_contiguous()
            and vals.is_contiguous() and deg.is_contiguous()):
        got = [(tuple(t.shape), t.dtype, t.is_contiguous())
               for t in (cols, vals, deg, X)]
        raise ValueError(
            f"plain_ell_spmm: the kernel takes contiguous cols (n, k) and "
            f"deg (n,) int32, vals (n, k) and X (rows, d), not {got}")
    if X.shape[1] > 1 and X.stride(1) != 1:
        X = X.contiguous()
    n, k = cols.shape
    out = torch.empty((n, X.shape[1]), dtype=torch.float32, device=X.device)
    rc = _build.load("plain_ell_spmm").glt_plain_ell_spmm(
        cols.data_ptr(), vals.data_ptr(), deg.data_ptr(), k, n,
        X.data_ptr(), X.stride(0), X.shape[1], out.data_ptr(),
        torch.cuda.current_stream(X.device).cuda_stream)
    if rc:
        raise RuntimeError(f"plain_ell_spmm: CUDA error {rc}")
    plain_ell_spmm.launches += 1
    return out


plain_ell_spmm.launches = 0


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
