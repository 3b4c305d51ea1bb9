"""The partitioned tiled band: K1, K3, K7 and K9 over a mesh with a ring
halo.

Counterpart of ``graphlearning_tpu/parallel/band_shard.py:53-656``.

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
  the ring; at world size 1 the wrap is a local slice.  The halo is
  measured without the wrap, so rank 0's left halo and rank P-1's right
  halo hold no edge.  On RCM-ordered kNN graphs one hop covers every edge.
* **Compute**, each over the rank's halo-extended input
  (:meth:`ShardedOp._halo_map`): **K3** (:func:`ops.band_spmm.
  band_tiles_spmm`) for the products, **K7** (``band_tiles_minplus``, with
  the argmin) for a min-plus relaxation round and **K9**
  (``band_tiles_lip``, C <= 32 a launch) for the three Lipschitz
  reductions, K7 and K9 on the band's live-chunk list, built once with
  the operator; the gather ``x[cols]`` takes the extended rows.  The
  residual edges go through all-gathered inputs.  d is not padded to the
  TPU's 128 lanes.

:class:`ShardedOp` quacks like the rank's rows of a :class:`SparseGraph`,
so the single-device solvers run on the partitioned band through the
``spmm_`` and ``neighbor_take_`` hooks of ``ops.graphops``.
:class:`ShardedBandPlan` is the standalone handle of one graph on one
mesh.
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
_LIP_CMAX = 32          # K9's widest U on CUDA


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
    # the halo is measured without the ring's wrap, so the wrapped rows
    # (block 0's left halo, block P-1's right one) feed no cell: K7's
    # argmin never points into them
    kept = valid & ~res
    if (np.any(kept[:B] & (lcols[:B] < H))
            or np.any(kept[-B:] & (lcols[-B:] >= B + H))):
        raise RuntimeError("an edge of the first or last block lies in "
                           "its wrapped halo")

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
    columns, residual edges kept) whose ``spmm_`` runs K3,
    ``neighbor_take_`` gathers and ``minplus_`` (K7) and ``lip_reduce_``
    (K9) reduce, each over the halo-extended input.  ``deg_`` and
    ``diag_`` read the ELL rows.  ``lcols`` are the rank's rows' columns in
    the extended space, ``chunks`` the band's live-chunk list of K7 and
    K9, built once here.

    ``n_residual`` counts the rank's edges beyond the halo (none on RCM
    kNN graphs): where any rank has one, every call all-gathers its input
    and each rank adds its own."""

    def __init__(self, g: ShardedGraph, band, plan: _bs.TilesPlan, H: int,
                 mode: str, res, has_res: bool, xpad, n_orig: int,
                 residual_frac: float, G: int, lcols, res_slots):
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
        self.lcols = lcols        # (B, k) columns in [0, B + 2H)
        self._res_slots = res_slots
        self._spill = None        # the residual as a spill, for K7/K9's
        if res is not None:       # residual_minplus / residual_lip
            rr, rc, rv = res
            dev = rr.device
            self._spill = (torch.zeros(0, dtype=torch.long, device=dev),
                           torch.zeros((0, 1), dtype=torch.long, device=dev),
                           torch.zeros((0, 1), dtype=rv.dtype, device=dev),
                           rr, rc, rv)
        self.chunks = _bs.tiles_live_chunks(band, plan)

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

    @property
    def _in_dtype(self):
        """The kernels' input dtype: float64 for an f64 band (the CPU),
        else float32."""
        return torch.float64 if self.mode == "f64" else torch.float32

    def _halo_map(self, X):
        """The halo-extended rows of the row-sharded ``X`` (B, ...), any
        dtype: ``(B + 2H, ...)``, ``[left halo | X | right halo]``, its
        padding rows zeroed.  A padding row holds only zero cells of the
        dense tiles, and a non-finite value there (``inf * 0`` of an
        unguarded ``D^-1/2`` scaling) would reach real rows through them,
        where the ELL gather reads only real neighbours."""
        left, right = self.mesh.halo(X, self.H)
        ext = torch.cat([left, X, right])
        if self._xpad is not None:
            ext = ext.masked_fill(
                self._xpad.reshape((-1,) + (1,) * (X.dim() - 1)), 0)
        return ext

    def halo_x(self, X):
        """The halo-extended X of K3, ``(B + 2H, d)``, in the band's input
        dtype (:meth:`_halo_map`)."""
        return self._halo_map(X.to(self._in_dtype))

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
        """``x[cols]`` of this rank's rows, ``(B, k, ...)``: the halo-extended
        x at ``lcols``, the residual slots from the all-gathered x.  Per
        call it moves the 2H boundary rows, not all n."""
        out = self._halo_map(x)[self.lcols]
        if self.has_res:
            xg = self.mesh.all_gather(x)
            if self.res is not None:
                rr, rc, _ = self.res
                out[rr, self._res_slots] = xg[rc]
        return out

    def minplus_prep(self, f):
        """The speeds ``f`` (B,) of a run of :meth:`minplus_round` calls:
        halo-extended once, and all-gathered where there are residual
        edges."""
        f = f.to(self._in_dtype)
        return (self._halo_map(f),
                self.mesh.all_gather(f) if self.has_res else None)

    def minplus_round(self, d, prep, hopf_lax: bool = False,
                      recip: bool = False):
        """One min-plus relaxation of this rank's rows over the band (K7
        with the argmin, on the halo-extended ``d`` and the speeds of
        :meth:`minplus_prep`) and the residual edges.  Returns ``(best,
        a_ext, a_res)``: per row the least candidate (``MINPLUS_BIG`` where
        none), K7's argmin in the extended space ``[0, B + 2H)`` (-1 where
        none) and, where a residual edge's candidate is strictly smaller,
        its global column (else -1)."""
        f_ext, fg = prep
        d = d.to(self._in_dtype)
        m, a = _bs.band_tiles_minplus(self.band, self.plan, self._halo_map(d),
                                      f_ext, hopf_lax=hopf_lax,
                                      track_arg=True, recip=recip,
                                      chunks=self.chunks)
        a_res = torch.full_like(a, -1)
        if self.has_res:
            dg = self.mesh.all_gather(d)
            if self._spill is not None:
                m_r, a_r = _bs.residual_minplus(dg, fg, self._spill,
                                                hopf_lax=hopf_lax,
                                                track_arg=True, recip=recip)
                m_r, a_r = m_r[:self.n].to(m.dtype), a_r[:self.n]
                better = m_r < m
                m = torch.where(better, m_r, m)
                a_res = torch.where(better, a_r, a_res)
        return m, a, a_res

    def minplus_(self, d, f, hopf_lax: bool = False, recip: bool = False):
        """One min-plus relaxation round of this rank's rows (K7 over the
        halo-extended ``d`` and ``f`` plus the residual edges): ``(best,
        arg)``, the least candidate (``MINPLUS_BIG`` where none) and its
        global column (-1 where none), as the JAX package's."""
        m, a, a_res = self.minplus_round(d, self.minplus_prep(f),
                                         hopf_lax=hopf_lax, recip=recip)
        glob = (a + (self.mesh.rank * self.n - self.H)) % self.n_global
        arg = torch.where(a_res >= 0, a_res, torch.where(a >= 0, glob, -1))
        arg = torch.where(m >= 0.5 * _bs.MINPLUS_BIG, -1, arg)
        return m.to(d.dtype), arg.to(torch.int32)

    def lip_reduce_(self, U):
        """The three reductions of a Lipschitz round over this rank's rows,
        ``(wsum_u, nmin, nmax)``, each (B, C) in U's dtype: the weighted
        neighbor sums and the neighbors' min and max of U's columns
        (``LIP_BIG`` / ``-LIP_BIG`` where a row has none).  K9 on the
        halo-extended U, one launch for each block of 32 columns (K9's
        widest on CUDA), then the residual edges."""
        Uk = U.to(self._in_dtype)
        ext = self._halo_map(Uk)
        parts = [_bs.band_tiles_lip(self.band, self.plan,
                                    ext[:, c0:c0 + _LIP_CMAX].contiguous(),
                                    self.chunks)
                 for c0 in range(0, U.shape[1], _LIP_CMAX)]
        s, mn, mx = (torch.cat(x, dim=1) for x in zip(*parts))
        if self.has_res:
            Ug = self.mesh.all_gather(Uk)
            if self._spill is not None:
                s_r, mn_r, mx_r = _bs.residual_lip(Ug, self._spill, self.n)
                s = s + s_r.to(s.dtype)
                mn = torch.minimum(mn, mn_r.to(mn.dtype))
                mx = torch.maximum(mx, mx_r.to(mx.dtype))
        return s.to(U.dtype), mn.to(U.dtype), mx.to(U.dtype)


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
    res = res_slots = None
    mine = (part.res_rows >= p * B) & (part.res_rows < (p + 1) * B)
    if mine.any():
        res_slots = torch.as_tensor(part.res_slots[mine].astype(np.int64),
                                    device=dev)
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
    lcols = torch.as_tensor(part.lcols[p * B:(p + 1) * B].astype(np.int64),
                            device=dev)
    return ShardedOp(g, part.bands[p], part.tiles_plan(p, dev), H, mode, res,
                     len(part.res_rows) > 0, xpad, part.n,
                     part.residual_frac, part.G, lcols, res_slots)


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
