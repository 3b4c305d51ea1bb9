"""The partitioned tiled band: K1 and K3 over a mesh with a ring halo.

Counterpart of ``graphlearning_tpu/parallel/band_shard.py:53-656`` (the
distance and Lipschitz reductions, K7 and K9 over the halo, come with
P15b).

* **Partition** (:func:`build_band_partition`): the rows split into P
  contiguous blocks of ``B`` rows (a multiple of ``lcm(R, WT)``), each
  block's columns rebased onto its halo-extended local space ``[left halo
  | block | right halo]`` of ``B + 2H`` rows (``lcols``), H the largest
  column overhang rounded up to WT.  Each block's tiles are planned by
  :func:`ops.band_spmm.plan_tiles` keeping every in-halo edge, and built
  by **K1** (:func:`ops.band_spmm.materialize_band_tiles`) on the rank
  that owns the block.  Edges beyond the halo form the residual COO.
* **Halo exchange** (:meth:`parallel.mesh.Mesh.halo`): each rank sends its
  first H rows to rank p-1 and its last H to rank p+1, wrapping around
  the ring; at world size 1 the wrap is a local slice.  On RCM-ordered
  kNN graphs one hop covers every edge.
* **Compute**: **K3** (:func:`ops.band_spmm.band_tiles_spmm`) streams the
  rank's own tiles over the halo-extended X, ``(B + 2H, d)`` in, ``(B,
  d)`` out.  d is not padded to the TPU's 128 lanes.

:class:`ShardedOp` quacks like the rank's rows of a :class:`SparseGraph`,
so the single-device solvers run their products on the partitioned band
through the ``spmm_`` hook of ``ops.graphops``.  :class:`ShardedBandPlan`
is the standalone handle of one graph on one mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from graphlearning_tpu_torch import config
from graphlearning_tpu_torch.ops import band_spmm as _bs
from graphlearning_tpu_torch.parallel.mesh import Mesh
from graphlearning_tpu_torch.parallel.shard import (ShardedGraph,
                                                    _ell_arrays, pad_ell)


def _roundup(x: int, m: int) -> int:
    return -(-int(x) // m) * m


_BAND_DTYPES = {"f64": torch.float64, "f32": torch.float32,
                "bf16": torch.bfloat16}


class BandPartition:
    """The host plan of a graph's tiled band over P contiguous row blocks,
    with the bands of the blocks that K1 built (``bands[p]``, None for the
    others).  ``tb``, ``ts``, ``bf`` and ``band`` give the JAX package's
    layout: every block's tiles padded to the most tiles of any block
    (``G``) by no-op tiles repeating its last (block, start) pair."""

    def __init__(self, *, plans, cols, vals, deg, lcols, band_vals,
                 res_rows, res_slots, res_cols, res_vals, n, n_pad, B, H, Pn,
                 R, WT, nnz):
        self.plans = plans        # per block: (tile_block, tile_start, first)
        self.bands = [None] * Pn  # per block: (g R, WT) tensor, once built
        self.cols = cols          # (n_pad, k) padded ELL, global columns
        self.vals = vals          #   (residual edges kept)
        self.deg = deg
        self.lcols = lcols        # (n_pad, k) halo-local columns
        self.band_vals = band_vals  # vals with the residual edges zeroed
        self.res_rows = res_rows  # the out-of-halo edges, global COO
        self.res_slots = res_slots
        self.res_cols = res_cols
        self.res_vals = res_vals
        self.n, self.n_pad = n, n_pad
        self.B, self.H, self.Pn = B, H, Pn
        self.R, self.WT = R, WT
        self.nnz = nnz
        self.G = max(len(p[0]) for p in plans)

    @property
    def residual_frac(self) -> float:
        return len(self.res_rows) / max(1, self.nnz)

    def k1_inputs(self, p: int, device):
        """K1's arguments for block ``p`` on ``device``: ``(cols, vals,
        tile_block, tile_start, R, WT)``, the block's halo-local columns
        and its values without the residual edges (float32 on CUDA, the
        kernel's input; float64 on the CPU)."""
        dev = torch.device(device)
        sl = slice(p * self.B, (p + 1) * self.B)
        val_dtype = np.float32 if dev.type == "cuda" else np.float64
        tb, ts, _ = self.plans[p]
        as_t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a, dt),
                                             device=dev)
        return (as_t(self.lcols[sl], np.int32),
                as_t(self.band_vals[sl], val_dtype), as_t(tb, np.int32),
                as_t(ts, np.int32), self.R, self.WT)

    def tiles_plan(self, p: int, device) -> _bs.TilesPlan:
        """K3's plan of block ``p``: ``B`` output rows over ``B + 2H`` rows
        of halo-extended X."""
        tb, ts, _ = self.plans[p]
        return _bs.TilesPlan.from_tiles(tb, ts, self.B, self.R, self.WT,
                                        device)

    def _padded(self, i: int):
        out = np.zeros((self.Pn, self.G), np.int32)
        for p, plan in enumerate(self.plans):
            g = len(plan[0])
            out[p, :g] = plan[i]
            if i < 2:
                out[p, g:] = plan[i][-1]
        return out.reshape(-1)

    @property
    def tb(self):
        return self._padded(0)

    @property
    def ts(self):
        return self._padded(1)

    @property
    def bf(self):
        return self._padded(2)

    @property
    def band(self):
        """Every block's band, padded to ``G`` tiles with zero tiles, as
        one host array ``(Pn G R, WT)``."""
        if any(b is None for b in self.bands):
            raise ValueError("band: K1 built only some blocks' bands")
        dtype = self.bands[0].dtype
        out = torch.zeros((self.Pn, self.G * self.R, self.WT), dtype=dtype)
        for p, b in enumerate(self.bands):
            out[p, :b.shape[0]] = b.cpu()
        return out.reshape(-1, self.WT)


def build_band_partition(W, Pn: int, R: int = 512, WT: int = 512,
                         max_halo_frac: float = 1.0,
                         band_dtype=torch.float32, device=None,
                         blocks=None) -> BandPartition:
    """Partition ``W`` (scipy or SparseGraph) into ``Pn`` contiguous row
    blocks and plan each block's tiled band on its halo-extended local
    columns, the JAX package's plan array for array.  K1 builds the bands
    of ``blocks`` (default all) on ``device`` (the default device when
    None).  A halo over ``max_halo_frac`` of a block is cut there; the
    edges beyond it go to the residual."""
    cols, vals, deg, n = _ell_arrays(W)
    nnz = int(deg.sum())
    unit = int(np.lcm(R, WT))
    B = _roundup(-(-n // Pn), unit)
    n_pad = B * Pn
    k = cols.shape[1]
    cols, vals, deg = pad_ell(cols, vals, deg, n_pad)

    valid = np.arange(k)[None, :] < deg[:, None]
    lo = np.repeat(np.arange(Pn), B)[:, None] * B       # block starts
    over_l = np.maximum(lo - cols, 0)
    over_r = np.maximum(cols - (lo + B - 1), 0)
    over = np.where(valid, np.maximum(over_l, over_r), 0)
    H = _roundup(max(1, int(over.max())), WT)
    if H > max_halo_frac * B:
        H = _roundup(int(max_halo_frac * B), WT) or WT
    H = min(H, B)

    res = valid & ~(np.maximum(over_l, over_r) <= H)
    rr, rs = np.nonzero(res)
    res_cols = cols[rr, rs].astype(np.int32)
    res_vals = vals[rr, rs].copy()
    ell_cols, ell_vals = cols, vals
    # the band leaves the residual edges out (zero value, a column inside
    # the block); the ELL handed on keeps them
    vals = vals.copy()
    vals[rr, rs] = 0.0
    cols = cols.copy()
    cols[rr, rs] = lo[rr, 0]

    Wloc = B + 2 * H
    lcols = np.empty_like(cols)
    plans = []
    for p in range(Pn):
        sl = slice(p * B, (p + 1) * B)
        local = np.clip(cols[sl] - (p * B - H), 0, Wloc - 1)
        lcols[sl] = local
        # every in-halo edge is kept: no cost threshold, no budget
        tb, ts, bf, prr, _, _ = _bs.plan_tiles(
            local, R=R, WT=WT, deg=None, kcap=k, min_edges_per_tile=1,
            ncols=Wloc, hbm_budget_bytes=float("inf"))
        if len(prr):
            raise RuntimeError("plan_tiles left in-halo edges out of the "
                               "band")
        plans.append((tb, ts, bf))

    part = BandPartition(
        plans=plans, cols=ell_cols, vals=ell_vals, deg=deg, lcols=lcols,
        band_vals=vals, res_rows=rr.astype(np.int32),
        res_slots=rs.astype(np.int32), res_cols=res_cols, res_vals=res_vals,
        n=n, n_pad=n_pad, B=B, H=H, Pn=Pn, R=R, WT=WT, nnz=nnz)
    dev = config.device(device)
    for p in (range(Pn) if blocks is None else blocks):
        cols_t, vals_t, tb_t, ts_t, _, _ = part.k1_inputs(p, dev)
        part.bands[p] = _bs.materialize_band_tiles(
            cols_t, vals_t, tb_t, ts_t, R=R, WT=WT, out_dtype=band_dtype)
    return part


class ShardedOp:
    """This rank's rows of a graph partitioned into tiled-band blocks: a
    duck-typed :class:`SparseGraph` (``cols``, ``vals``, ``deg``, ``n``,
    ``k``, ``shape``, ``mask``: the rank's rows of the padded ELL, global
    columns, residual edges kept) whose ``spmm_`` runs K3 over the
    halo-extended X.  ``deg_`` and ``diag_`` read the ELL rows;
    ``neighbor_take_``, ``minplus_`` and ``lip_reduce_`` come with P15b.

    ``n_residual`` counts the rank's edges beyond the halo (none on RCM
    kNN graphs): where any rank has one, every product all-gathers X and
    each rank adds its own."""

    def __init__(self, g: ShardedGraph, band, plan: _bs.TilesPlan, H: int,
                 mode: str, res, has_res: bool, xpad, n_orig: int,
                 residual_frac: float, G: int):
        self.g = g
        self.band = band
        self.plan = plan
        self.H = H
        self.mode = mode
        self.res = res            # (local rows, global cols, vals) or None
        self.has_res = has_res    # some rank has residual edges
        self._xpad = xpad         # padding rows of the extended X, or None
        self.n_orig = n_orig
        self.residual_frac = residual_frac
        self.n_residual = 0 if res is None else int(res[0].shape[0])
        self.G = G

    mesh = property(lambda self: self.g.mesh)
    cols = property(lambda self: self.g.cols)
    vals = property(lambda self: self.g.vals)
    deg = property(lambda self: self.g.deg)
    n = property(lambda self: self.g.n)
    k = property(lambda self: self.g.k)
    n_global = property(lambda self: self.g.n_global)
    shape = property(lambda self: self.g.shape)
    device = property(lambda self: self.g.device)

    def mask(self):
        return self.g.mask()

    def deg_(self):
        return self.g.deg_()

    def diag_(self):
        return self.g.diag_()

    def halo_x(self, X):
        """The halo-extended X of K3, ``(B + 2H, d)``, in the band's input
        dtype, its padding rows zeroed: a padding column holds zero cells
        of the dense tiles, and a non-finite padding value (``inf * 0``
        of an unguarded ``D^-1/2`` scaling) would reach real rows through
        them, where the ELL gather reads only real neighbours."""
        in_dtype = torch.float64 if self.mode == "f64" else torch.float32
        Xp = X.to(in_dtype)
        left, right = self.mesh.halo(Xp, self.H)
        Xloc = torch.cat([left, Xp, right])
        if self._xpad is not None:
            Xloc = Xloc.masked_fill(self._xpad[:, None], 0.0)
        return Xloc

    def spmm_(self, X):
        """This rank's rows of ``W @ X``, X its (B, d) rows: K3 over the
        halo-extended X, then the residual edges; in X's dtype."""
        X2 = X[:, None] if X.dim() == 1 else X
        Xloc = self.halo_x(X2)
        Xk = Xloc.to(torch.bfloat16) if self.mode == "bf16" else Xloc
        out = _bs.band_tiles_spmm(self.band, self.plan, Xk)
        if self.has_res:
            Xg = self.mesh.all_gather(Xloc[self.H:self.H + self.n])
            if self.res is not None:
                rr, rc, rv = self.res
                out.index_put_((rr,), (rv[:, None] * Xg[rc]).to(out.dtype),
                               accumulate=True)
        out = out.to(X.dtype)
        return out[:, 0] if X.dim() == 1 else out

    def neighbor_take_(self, x):
        raise NotImplementedError(
            "ShardedOp.neighbor_take_ (the gather through the halo) comes "
            "with P15b")

    def minplus_(self, d, f, hopf_lax: bool = False, recip: bool = False):
        raise NotImplementedError(
            "ShardedOp.minplus_ (K7 over the halo) comes with P15b")

    def lip_reduce_(self, U):
        raise NotImplementedError(
            "ShardedOp.lip_reduce_ (K9 over the halo) comes with P15b")


def make_sharded_op(W, mesh: Mesh, axis: str | None = None, R: int = 512,
                    WT: int = 512, mode: str = "f32",
                    max_halo_frac: float = 1.0, ell_dtype=None) -> ShardedOp:
    """This rank's :class:`ShardedOp` of ``W`` on ``mesh``: the partition
    over the mesh's ranks, K1 for the rank's own block on its device.
    ``mode``: "f64" (the CPU), "f32" or "bf16" (the band's dtype)."""
    axis = axis or mesh.node_axis
    if axis != mesh.node_axis:
        raise ValueError(f"axis {axis!r} is not the mesh's node axis")
    if mode not in _BAND_DTYPES:
        raise ValueError(f"mode must be one of {tuple(_BAND_DTYPES)}, not "
                         f"{mode!r}")
    dev = mesh.device
    part = build_band_partition(W, mesh.size, R=R, WT=WT,
                                max_halo_frac=max_halo_frac,
                                band_dtype=_BAND_DTYPES[mode], device=dev,
                                blocks=(mesh.rank,))
    p, B, H = mesh.rank, part.B, part.H
    g = ShardedGraph.from_host(part.cols, part.vals, part.deg, mesh,
                               ell_dtype or config.float_dtype(dev))
    res = None
    mine = (part.res_rows >= p * B) & (part.res_rows < (p + 1) * B)
    if mine.any():
        res_dtype = torch.float64 if mode == "f64" else torch.float32
        res = (torch.as_tensor(part.res_rows[mine].astype(np.int64) - p * B,
                               device=dev),
               torch.as_tensor(part.res_cols[mine].astype(np.int64),
                               device=dev),
               torch.as_tensor(part.res_vals[mine], device=dev).to(res_dtype))
    glob = (np.arange(B + 2 * H) + p * B - H) % part.n_pad
    xpad = None
    if (glob >= part.n).any():
        xpad = torch.as_tensor(glob >= part.n, device=dev)
    return ShardedOp(g, part.bands[p], part.tiles_plan(p, dev), H, mode, res,
                     len(part.res_rows) > 0, xpad, part.n,
                     part.residual_frac, part.G)


class ShardedBandPlan:
    """One graph's partitioned band on one mesh, standalone: ``spmm(X)``
    of this rank's rows.  Build once per (graph, mesh)."""

    def __init__(self, W, mesh: Mesh, axis: str | None = None, R: int = 512,
                 WT: int = 512, mode: str = "f32",
                 max_halo_frac: float = 1.0):
        self.mesh = mesh
        self.axis = axis or mesh.node_axis
        self.Pn = mesh.size
        self.R, self.WT, self.mode = R, WT, mode
        self.op = make_sharded_op(W, mesh, axis=self.axis, R=R, WT=WT,
                                  mode=mode, max_halo_frac=max_halo_frac)
        self.n = self.op.n_orig
        self.n_pad = self.op.n_global
        self.B = self.op.n
        self.H = self.op.H
        self.G = self.op.G

    @property
    def res_rows(self):
        """This rank's rows with residual edges (global row ids)."""
        if self.op.res is None:
            return np.empty(0, np.int64)
        return self.op.res[0].cpu().numpy() + self.mesh.rank * self.B

    def put_rows(self, X):
        """This rank's rows of ``X`` (host, ``n`` or ``n_pad`` rows),
        padded with zero rows to ``n_pad``, on the mesh's device in the
        band's input dtype."""
        X = np.asarray(X)
        if X.shape[0] < self.n_pad:
            X = np.concatenate([X, np.zeros((self.n_pad - X.shape[0],)
                                            + X.shape[1:], X.dtype)])
        dt = torch.float64 if self.mode == "f64" else torch.float32
        r0 = self.mesh.rank * self.B
        return torch.as_tensor(X[r0:r0 + self.B],
                               device=self.mesh.device).to(dt)

    def spmm(self, X):
        """This rank's rows of ``W @ X``; ``X`` is this rank's rows (a
        tensor) or the whole host array."""
        if not isinstance(X, torch.Tensor):
            X = self.put_rows(X)
        return self.op.spmm_(X)
