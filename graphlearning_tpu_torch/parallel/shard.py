"""Row-sharded graphs and the distributed SpMM on the ELL route.

Counterpart of ``graphlearning_tpu/parallel/shard.py``.

* **Partition**: the padded ELL (``cols``, ``vals``, ``deg``) is padded to
  a multiple of the mesh size and split into equal contiguous row blocks,
  one a rank (:func:`shard_graph`).  Columns stay global.  Padding rows
  have degree 0, ``vals`` 0 and columns that point to themselves.
* **:func:`sharded_spmm`**: an all-gather of X, then the local rows' ELL
  gather: what GSPMD emits for the JAX package's annotated gather.
* **:func:`sharded_spmm_ring`**: X's blocks rotate around the ring, and
  each step accumulates the slots whose columns lie in the block held
  (only ``n / P`` rows of X on a rank at a time).
* **:class:`ShardedBucketedGraph`**: the degree-skewed hybrid, a capped
  ELL row-sharded plus the hub tails' spill, which each rank keeps for
  its own rows.

A sharded graph quacks like a :class:`SparseGraph` of its local rows:
``ops.graphops`` dispatches ``spmm``, ``neighbor_take``, ``degree_vector``
and ``diagonal`` to its ``spmm_``, ``neighbor_take_``, ``deg_`` and
``diag_``, so the single-device solvers run on it unchanged.
"""

from __future__ import annotations

import numpy as np
import torch

from graphlearning_tpu_torch import config
from graphlearning_tpu_torch.core.sparse import (BucketedELL, SparseGraph,
                                                 _np_float, segment_reduce)
from graphlearning_tpu_torch.ops import graphops as _ops
from graphlearning_tpu_torch.parallel.mesh import Mesh, Sharding


def pad_ell(cols, vals, deg, n_pad: int):
    """Host ELL arrays padded with rows of degree 0, ``vals`` 0 and
    columns that point to themselves, up to ``n_pad`` rows."""
    n, k = cols.shape
    extra = n_pad - n
    if extra <= 0:
        return cols, vals, deg
    pad_cols = np.repeat(np.arange(n, n_pad, dtype=cols.dtype)[:, None], k,
                         axis=1)
    return (np.concatenate([cols, pad_cols]),
            np.concatenate([vals, np.zeros((extra, k), vals.dtype)]),
            np.concatenate([deg, np.zeros(extra, deg.dtype)]))


def pad_graph_to(g: SparseGraph, multiple: int) -> SparseGraph:
    """``g`` with its node count padded up to a multiple of ``multiple``
    (padding rows: degree 0, ``vals`` 0, self columns)."""
    n_pad = -(-g.n // multiple) * multiple
    if n_pad == g.n:
        return g
    dev = g.device
    pad_cols = torch.arange(g.n, n_pad, dtype=g.cols.dtype,
                            device=dev)[:, None].expand(-1, g.k)
    return SparseGraph(
        cols=torch.cat([g.cols, pad_cols]),
        vals=torch.cat([g.vals, g.vals.new_zeros((n_pad - g.n, g.k))]),
        deg=torch.cat([g.deg, g.deg.new_zeros(n_pad - g.n)]),
        n=n_pad, k=g.k)


def _ell_arrays(W):
    """Host ``(cols, vals, deg, n)`` of a scipy matrix or a SparseGraph."""
    if isinstance(W, SparseGraph):
        return (W.cols.cpu().numpy(), W.vals.cpu().numpy(),
                W.deg.cpu().numpy(), W.n)
    cols, vals, deg = SparseGraph.ell_from_scipy(W)
    return cols, vals, deg, W.shape[0]


class ShardedGraph:
    """This rank's rows ``[row0, row0 + n)`` of a padded ELL graph of
    ``n_global`` rows, with global columns.  Per-node tensors of a
    sharded solve have ``n`` rows; ``shape`` is the local block of the
    matrix, ``(n, n_global)``."""

    def __init__(self, cols, vals, deg, row0: int, n_global: int,
                 mesh: Mesh):
        self.local = SparseGraph(cols, vals, deg, cols.shape[0],
                                 cols.shape[1])
        self.row0 = int(row0)
        self.n_global = int(n_global)
        self.mesh = mesh

    @classmethod
    def from_host(cls, cols, vals, deg, mesh: Mesh, dtype):
        """This rank's block of host ELL arrays whose row count is a
        multiple of the mesh size, on the mesh's device."""
        n_global = cols.shape[0]
        B = n_global // mesh.size
        sl = slice(mesh.rank * B, (mesh.rank + 1) * B)
        local = SparseGraph.from_ell_np(cols[sl], vals[sl], deg[sl],
                                        dtype=dtype, device=mesh.device)
        return cls(local.cols, local.vals, local.deg, mesh.rank * B,
                   n_global, mesh)

    cols = property(lambda self: self.local.cols)
    vals = property(lambda self: self.local.vals)
    deg = property(lambda self: self.local.deg)
    n = property(lambda self: self.local.n)
    k = property(lambda self: self.local.k)
    device = property(lambda self: self.local.device)

    @property
    def shape(self):
        return (self.n, self.n_global)

    def mask(self):
        return self.local.mask()

    def spmm_(self, X):
        """This rank's rows of ``W @ X``: X (n, d) local rows, all-gathered,
        then the local rows' ELL gather."""
        return _ops.spmm(self.local, self.mesh.all_gather(X))

    def deg_(self):
        return _ops.degree_vector(self.local)

    def diag_(self):
        rows = torch.arange(self.row0, self.row0 + self.n,
                            device=self.device)[:, None]
        zero = torch.zeros((), dtype=self.vals.dtype, device=self.device)
        return torch.sum(torch.where(self.cols == rows, self.vals, zero),
                         dim=1)

    def neighbor_take_(self, x, slot=None):
        """``x[cols]`` of this rank's rows, (n, k, ...), or with ``slot``
        (n,) each row's one slot: x's local rows all-gathered, then the
        local rows' slots (what GSPMD emits for the JAX package's
        gather)."""
        return self.mesh.all_gather(x)[_ops._slot_cols(self.cols, slot)]

    def with_vals(self, vals):
        """The same rows and columns with other slot values."""
        return ShardedGraph(self.cols, vals, self.deg, self.row0,
                            self.n_global, self.mesh)


def shard_graph(g, mesh: Mesh, dtype=None) -> ShardedGraph:
    """This rank's rows of ``g`` (a SparseGraph or a scipy matrix), padded
    to a multiple of the mesh size, on the mesh's device."""
    cols, vals, deg, n = _ell_arrays(g)
    n_pad = -(-n // mesh.size) * mesh.size
    cols, vals, deg = pad_ell(cols, vals, deg, n_pad)
    dtype = dtype or (g.vals.dtype if isinstance(g, SparseGraph)
                      else config.float_dtype(mesh.device))
    return ShardedGraph.from_host(cols, vals, deg, mesh, dtype)


def sharded_spmm(g: ShardedGraph, X, mesh: Mesh):
    """This rank's rows of ``W @ X`` on the ELL route: X's local rows
    all-gathered, then the local rows' gather (``mesh`` is ``g``'s)."""
    if mesh is not g.mesh:
        raise ValueError("sharded_spmm: X's mesh is not the graph's")
    return g.spmm_(X)


def sharded_spmm_ring(g: ShardedGraph, X, mesh: Mesh):
    """This rank's rows of ``W @ X`` by the ring: P steps, at step s the
    rank holds block ``(p + s) mod P`` of X, adds the slots whose columns
    lie in it, and passes it to rank p-1.  The k-sum is reordered against
    :func:`sharded_spmm` (equal up to rounding)."""
    P, p = mesh.size, mesh.rank
    blk = g.n
    cols = g.cols.long()
    vals = g.vals.to(X.dtype)
    acc = X.new_zeros((blk, X.shape[1]))
    Xblk = X
    for s in range(P):
        start = ((p + s) % P) * blk
        in_blk = (cols >= start) & (cols < start + blk)
        local = torch.clamp(cols - start, 0, blk - 1)
        w = torch.where(in_blk, vals, torch.zeros((), dtype=vals.dtype,
                                                  device=vals.device))
        acc = acc + torch.einsum("nk,nkd->nd", w, Xblk[local])
        if s + 1 < P:
            Xblk = mesh.ring_shift(Xblk)
    return acc


def put_features(X, mesh: Mesh, sharding: Sharding | None = None):
    """A feature or label matrix on the mesh's device in its working float
    dtype: this rank's rows of ``X`` padded with zero rows to a multiple
    of the mesh size (``sharding`` None or :func:`node_sharding`), or the
    whole of it (:func:`replicated`)."""
    X = np.asarray(X)
    dtype = config.float_dtype(mesh.device)
    if sharding is not None and not sharding.rows:
        return torch.as_tensor(X, device=mesh.device).to(dtype)
    n_pad = -(-X.shape[0] // mesh.size) * mesh.size
    if n_pad > X.shape[0]:
        X = np.concatenate([X, np.zeros((n_pad - X.shape[0],)
                                        + X.shape[1:], X.dtype)])
    B = n_pad // mesh.size
    return torch.as_tensor(X[mesh.rank * B:(mesh.rank + 1) * B],
                           device=mesh.device).to(dtype)


class ShardedBucketedGraph(ShardedGraph):
    """The row-sharded capped ELL plus the hub tails' spill: the ELL
    route's operator for degree-skewed (band-hostile, hub-degree) graphs,
    where a full padded ELL would pad every row to the hub degree.
    ``cols``/``vals``/``deg`` are the capped ELL's local rows; each rank
    keeps the spill edges of its own rows (``sp_rows`` local, ``sp_cols``
    global) and its rows' full degree and diagonal (``degv``,
    ``diagv``)."""

    def __init__(self, cols, vals, deg, degv, diagv, sp_rows, sp_cols,
                 sp_vals, row0: int, n_global: int, mesh: Mesh):
        super().__init__(cols, vals, deg, row0, n_global, mesh)
        self.degv, self.diagv = degv, diagv
        self.sp_rows, self.sp_cols, self.sp_vals = sp_rows, sp_cols, sp_vals

    def spmm_(self, X):
        Xg = self.mesh.all_gather(X)
        out = _ops.spmm(self.local, Xg)
        if self.sp_rows.shape[0]:
            sv = self.sp_vals.to(Xg.dtype)[:, None] * Xg[self.sp_cols]
            out = segment_reduce(out, self.sp_rows, sv.to(out.dtype), "sum")
        return out

    def deg_(self):
        return self.degv

    def diag_(self):
        return self.diagv


def build_sharded_bucketed(W, mesh: Mesh, dtype=None):
    """This rank's :class:`ShardedBucketedGraph` of ``W`` (scipy): the ELL
    capped at the 95th-percentile degree (:class:`BucketedELL`), the hub
    tails spilled, the full degree and diagonal taken from ``W``.
    Returns ``(graph, n)``, ``n`` the unpadded node count."""
    import scipy.sparse as sp

    W = sp.csr_matrix(W)
    n = W.shape[0]
    dtype = dtype or config.float_dtype(mesh.device)
    cols, vals, deg = SparseGraph.ell_from_scipy(W)
    b = BucketedELL.from_ell_np(cols, vals, deg, dtype=torch.float64,
                                device="cpu")
    n_pad = -(-n // mesh.size) * mesh.size
    mcols, mvals, mdeg = pad_ell(b.main.cols.numpy(), b.main.vals.numpy(),
                                 b.main.deg.numpy(), n_pad)
    degv = np.zeros(n_pad)
    diagv = np.zeros(n_pad)
    degv[:n] = np.asarray(W.sum(1)).ravel()
    diagv[:n] = W.diagonal()
    B = n_pad // mesh.size
    row0 = mesh.rank * B
    sl = slice(row0, row0 + B)
    sp_rows = b.sp_rows[:b.m].numpy()
    mine = (sp_rows >= row0) & (sp_rows < row0 + B)
    dev = mesh.device
    local = SparseGraph.from_ell_np(mcols[sl], mvals[sl], mdeg[sl],
                                    dtype=dtype, device=dev)
    as_val = lambda a: torch.as_tensor(np.asarray(a, _np_float(dtype)),
                                       device=dev)
    as_idx = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=dev)
    g = ShardedBucketedGraph(
        local.cols, local.vals, local.deg, as_val(degv[sl]),
        as_val(diagv[sl]), as_idx(sp_rows[mine] - row0),
        as_idx(b.sp_cols[:b.m].numpy()[mine]),
        as_val(b.sp_vals[:b.m].numpy()[mine]), row0, n_pad, mesh)
    return g, n
