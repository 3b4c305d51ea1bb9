"""Device-resident sparse graph container (padded ELL layout).

Counterpart of ``graphlearning_tpu/core/sparse.py``.  The graph lives on a
device as three tensors:

  * ``cols[i, j]`` -- column of the j-th stored entry of row i (padding
    slots point at row ``i`` itself, an always-valid gather target),
  * ``vals[i, j]`` -- its weight (padding slots are exactly ``0``),
  * ``deg[i]``     -- number of valid entries of row i (valid slots first).

``from_ell_np`` takes the host arrays of ``ell_from_scipy`` unchanged, so
the JAX package and this one compute on one ELL layout.  ``BucketedELL``
splits a degree-skewed graph into a capped ELL plus a COO spill.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from graphlearning_tpu_torch import config


def _np_float(dtype: torch.dtype):
    return np.float64 if dtype == torch.float64 else np.float32


class SparseGraph:
    """Padded-ELL sparse matrix / weighted graph on one device.
    Semantically a scipy CSR matrix ``W`` of shape ``(n, n)``."""

    def __init__(self, cols, vals, deg, n: int, k: int):
        self.cols = cols
        self.vals = vals
        self.deg = deg
        self.n = n
        self.k = k

    # -- construction -----------------------------------------------------

    @staticmethod
    def ell_from_scipy(W, k: int | None = None):
        """Host-only ELL assembly: ``(cols, vals, deg)`` numpy arrays."""
        import scipy.sparse as sp

        W = sp.csr_matrix(W)
        n = W.shape[0]
        deg_np = np.diff(W.indptr).astype(np.int32)
        kmax = int(deg_np.max()) if n > 0 and deg_np.size else 1
        if k is None:
            k = max(1, kmax)
        elif k < kmax:
            raise ValueError(f"k={k} < max row degree {kmax}")
        cols_np = np.repeat(np.arange(n, dtype=np.int32)[:, None], k, axis=1)
        vals_np = np.zeros((n, k), dtype=np.float64)
        rows = np.repeat(np.arange(n), deg_np)
        slot = np.arange(W.indptr[-1]) - np.repeat(W.indptr[:-1], deg_np)
        cols_np[rows, slot] = W.indices.astype(np.int32)
        vals_np[rows, slot] = W.data
        return cols_np, vals_np, deg_np

    @staticmethod
    def from_ell_np(cols_np, vals_np, deg_np, dtype=None,
                    device=None) -> "SparseGraph":
        """Move host-assembled ELL arrays to ``device`` (one transfer)."""
        dev = config.device(device)
        dtype = dtype or config.float_dtype(dev)
        n, k = np.shape(cols_np)
        return SparseGraph(
            cols=torch.as_tensor(np.asarray(cols_np, np.int32), device=dev),
            vals=torch.as_tensor(np.asarray(vals_np, _np_float(dtype)),
                                 device=dev),
            deg=torch.as_tensor(np.asarray(deg_np, np.int32), device=dev),
            n=n, k=k)

    @staticmethod
    def from_scipy(W, k: int | None = None, dtype=None,
                   device=None) -> "SparseGraph":
        cols_np, vals_np, deg_np = SparseGraph.ell_from_scipy(W, k=k)
        return SparseGraph.from_ell_np(cols_np, vals_np, deg_np, dtype=dtype,
                                       device=device)

    @staticmethod
    def from_coo(rows, cols, vals, n: int, k: int | None = None, dtype=None,
                 device=None) -> "SparseGraph":
        """From COO triplets (duplicates summed), through scipy."""
        import scipy.sparse as sp

        W = sp.coo_matrix((np.asarray(vals), (np.asarray(rows),
                                              np.asarray(cols))),
                          shape=(n, n))
        return SparseGraph.from_scipy(W, k=k, dtype=dtype, device=device)

    @staticmethod
    def from_knn(knn_ind, knn_weight, n: int | None = None, dtype=None,
                 device=None) -> "SparseGraph":
        """Build directly from a dense kNN result ``(n, k)``: every row has
        full degree k."""
        dev = config.device(device)
        dtype = dtype or config.float_dtype(dev)
        cols = torch.as_tensor(knn_ind, device=dev).to(config.index_dtype)
        vals = torch.as_tensor(knn_weight, device=dev).to(dtype)
        n = n or cols.shape[0]
        k = cols.shape[1]
        deg = torch.full((n,), k, dtype=config.index_dtype, device=dev)
        return SparseGraph(cols=cols, vals=vals, deg=deg, n=n, k=k)

    # -- conversion -------------------------------------------------------

    def to_scipy(self):
        """Convert back to scipy CSR (host-side; drops padding)."""
        import scipy.sparse as sp

        cols = self.cols.cpu().numpy()
        vals = self.vals.cpu().numpy()
        deg = self.deg.cpu().numpy()
        mask = np.arange(self.k)[None, :] < deg[:, None]
        rows = np.repeat(np.arange(self.n), deg)
        W = sp.coo_matrix((vals[mask], (rows, cols[mask])),
                          shape=(self.n, self.n))
        return W.tocsr()

    def todense(self):
        """The dense ``(n, n)`` numpy matrix."""
        return np.asarray(self.to_scipy().todense())

    # -- basic properties -------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.n, self.n)

    @property
    def nnz(self) -> int:
        return int(self.deg.sum())

    def mask(self):
        """(n, k) bool validity mask, recomputed on the fly."""
        slots = torch.arange(self.k, device=self.device)
        return slots[None, :] < self.deg[:, None]

    def reorder_rcm(self):
        """Reverse Cuthill-McKee order (host-side): ``(reordered graph,
        perm)`` with ``perm`` mapping new to old indices, on the same
        device and dtype."""
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        W = self.to_scipy()
        perm = np.asarray(reverse_cuthill_mckee(W, symmetric_mode=True))
        return (SparseGraph.from_scipy(W[perm, :][:, perm],
                                       dtype=self.vals.dtype,
                                       device=self.device), perm)

    def astype(self, dtype) -> "SparseGraph":
        """The same graph with its values in ``dtype`` (a torch dtype or a
        numpy one)."""
        if not isinstance(dtype, torch.dtype):
            dtype = torch.from_numpy(np.zeros(0, dtype)).dtype
        return SparseGraph(self.cols, self.vals.to(dtype), self.deg, self.n,
                           self.k)

    def transpose(self) -> "SparseGraph":
        """Transpose (host-side rebuild)."""
        return SparseGraph.from_scipy(self.to_scipy().T.tocsr(),
                                      dtype=self.vals.dtype,
                                      device=self.device)

    def with_vals(self, vals) -> "SparseGraph":
        """Same sparsity pattern, new values (already 0 on padding)."""
        return SparseGraph(self.cols, vals, self.deg, self.n, self.k)

    def __repr__(self):
        return (f"SparseGraph(n={self.n}, k={self.k}, nnz={self.nnz}, "
                f"dtype={self.vals.dtype}, device={self.device})")


def segment_reduce(out, index, src, kind: str, include_self: bool = True):
    """Reduce rows of ``src`` into ``out`` in place at rows ``index``:
    ``kind`` "sum", "min" or "max".  A min or max row that ``index``
    reaches combines with its value in ``out`` only with
    ``include_self``; the other rows keep theirs.  A sum is the same in
    every run: ``index_put_(accumulate=True)`` sorts the rows and adds each
    row's terms in order (``index_add_`` on CUDA adds them by atomics, in
    the order the threads arrive)."""
    if kind == "sum":
        return out.index_put_((index.long(),), src, accumulate=True)
    idx = index.reshape((-1,) + (1,) * (src.dim() - 1)).expand_as(src)
    return out.scatter_reduce_(0, idx, src,
                               reduce={"min": "amin", "max": "amax"}[kind],
                               include_self=include_self)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class BucketedELL:
    """ELL+COO hybrid for degree-skewed graphs (counterpart of
    ``graphlearning_tpu/core/sparse.py:193-270``): ``main`` holds the
    first ``kcap`` slots of each row, and the tail of high-degree rows
    spills into flat COO arrays reduced per row.  The spill is padded to
    a multiple of 128 slots; padding slots carry row id ``n`` and reduce
    into a discarded extra row."""

    def __init__(self, main: SparseGraph, sp_rows, sp_cols, sp_vals,
                 kcap: int, m: int):
        self.main = main
        self.sp_rows = sp_rows
        self.sp_cols = sp_cols
        self.sp_vals = sp_vals
        self.kcap = kcap
        self.m = m            # real (unpadded) spill count

    @staticmethod
    def from_ell_np(cols_np, vals_np, deg_np, kcap: int | None = None,
                    dtype=None, device=None) -> "BucketedELL":
        """Host-side split of the arrays of
        :meth:`SparseGraph.ell_from_scipy`."""
        dev = config.device(device)
        dtype = dtype or config.float_dtype(dev)
        n, k = cols_np.shape
        if kcap is None:
            # 95th-percentile degree, a multiple of 8: covers almost all
            # rows; hub tails spill
            kcap = int(np.percentile(deg_np, 95)) if n else 1
            kcap = max(8, _round_up(max(kcap, 1), 8))
        kcap = min(kcap, k)
        main_deg = np.minimum(deg_np, kcap).astype(np.int32)
        main = SparseGraph.from_ell_np(cols_np[:, :kcap], vals_np[:, :kcap],
                                       main_deg, dtype=dtype, device=dev)
        hub = np.nonzero(deg_np > kcap)[0]
        tail = [(np.full(int(deg_np[r]) - kcap, r, np.int32),
                 cols_np[r, kcap:int(deg_np[r])],
                 vals_np[r, kcap:int(deg_np[r])]) for r in hub]
        m = int(sum(len(t[0]) for t in tail))
        mp = max(128, _round_up(m, 128))
        sp_rows = np.full(mp, n, np.int64)          # pad -> row n (dropped)
        sp_cols = np.zeros(mp, np.int64)
        sp_vals = np.zeros(mp, np.float64)
        if m:
            sp_rows[:m] = np.concatenate([t[0] for t in tail])
            sp_cols[:m] = np.concatenate([t[1] for t in tail])
            sp_vals[:m] = np.concatenate([t[2] for t in tail])
        return BucketedELL(main, torch.as_tensor(sp_rows, device=dev),
                           torch.as_tensor(sp_cols, device=dev),
                           torch.as_tensor(sp_vals, device=dev).to(dtype),
                           kcap=int(kcap), m=m)

    @staticmethod
    def from_scipy(W, kcap: int | None = None, dtype=None,
                   device=None) -> "BucketedELL":
        cols_np, vals_np, deg_np = SparseGraph.ell_from_scipy(W)
        return BucketedELL.from_ell_np(cols_np, vals_np, deg_np, kcap=kcap,
                                       dtype=dtype, device=device)

    @property
    def n(self) -> int:
        return self.main.n

    def spill_reduce(self, slot_vals, kind: str, fill):
        """Reduce per-spill-slot values into per-row values: (m_pad,) ->
        (n,) or (m_pad, C) -> (n, C).  ``kind`` is sum, min or max; rows
        with no spill get 0 for a sum and ``fill`` otherwise."""
        n = self.main.n
        init = 0.0 if kind == "sum" else fill
        out = torch.full((n + 1,) + tuple(slot_vals.shape[1:]), init,
                         dtype=slot_vals.dtype, device=slot_vals.device)
        return segment_reduce(out, self.sp_rows, slot_vals, kind,
                              include_self=False)[:n]
