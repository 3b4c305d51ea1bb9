"""Band SpMM: host planners, device glue, explicit plans and kernels K1-K9.

Counterpart of ``graphlearning_tpu/ops/pallas_spmm.py``.
A kNN graph in a locality-preserving order has, per block of ``R`` rows,
its edges inside a few ``WT``-column windows ("tiles").  The band stores
each kept tile as a dense ``(R, WT)`` block; an SpMM then streams the band
and the X rows of each tile's window.  Edges outside kept tiles (or beyond
the ``kcap`` ELL slots) form the residual, applied by a gather.

Host planners, copied from the JAX package (numpy only, so the two plan
identically): :func:`plan_banded`, :func:`plan_tiles`, :func:`pack_tiles`,
:func:`build_residual_ell`.  Device glue in plain torch (XLA in JAX):
:func:`pack_band`, :func:`apply_residual`.

Kernels (CUDA C++ for sm_90a in ``graphlearning_tpu_torch/csrc``):

* K1 :func:`materialize_band_tiles` -- build the band once per graph;
* K2 :func:`band_tiles_spmm_packed` -- the matvec of every CG iteration,
  over slabs of ``S`` same-block tiles;
* K3 :func:`band_tiles_spmm` -- the same over single tiles (``S = 1``),
  taken when the packed plan is absent; ``X`` may have more or fewer rows
  than the output;
* K4 :func:`materialize_band` -- the rectangular ``(n, W)`` band of the
  block-Gauss-Seidel Lipschitz sweeps, built once per graph;
* K7 :func:`band_tiles_minplus` -- one min-plus (Bellman-Ford or
  Hopf-Lax) relaxation round over the unpacked tiles;
* K9 :func:`band_tiles_lip` -- the weighted sum, min and max of C class
  columns over each row's band neighbors, one Lipschitz round;
* K5 :func:`band_spmm` and K8 :func:`band_minplus` -- the matvec and the
  min-plus round over the stored rectangular band of a :class:`RectPlan`;
* K6 :func:`banded_spmm` -- the matvec of a :class:`BandedPlan`, straight
  from the ELL slots, with no stored band;
* K10 :func:`band_tiles_spmm_packed_rowq` and K11
  :func:`band_tiles_spmm_packed_i8` -- K2 on a quantized packed band
  (:func:`quantize_band_rowq`, :func:`quantize_band_i8`, plain torch as
  XLA in JAX); the bench (``graphlearning_tpu_torch/bench.py``) is their
  only caller, as in the JAX package.

The residual edges of the distance and Lipschitz rounds go through
:func:`residual_minplus` and :func:`residual_lip` (plain torch; XLA in
JAX).

Each wrapper runs its plain torch twin for CPU tensors only; a CUDA tensor
goes to the kernel or raises.  ``launches`` on each wrapper counts the
kernel launches (K2's ``launches_by_d`` splits its count by X's columns).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from graphlearning_tpu_torch.core.sparse import segment_reduce
from graphlearning_tpu_torch.ops import _build

# -- host planners (numpy copies of the JAX package's) ----------------------


def plan_banded(cols_np, R: int = 512, W: int | None = None, WT: int = 1024,
                max_residual: float = 0.002, max_W: int = 16384,
                deg=None, kcap: int | None = None,
                kcap_max: int | None = None,
                gain_per_tile: int | None = None):
    """Per-row-block window starts and the residual (out-of-window or
    over-``kcap``) edge list of a rectangular band.

    With ``W`` None, picks the smallest window (multiple of WT, at most
    ``max_W`` and n) whose residual fraction is at most ``max_residual``,
    stopping early when a wider window absorbs fewer than
    ``gain_per_tile`` residual edges.  With ``deg`` given and ``kcap``
    None, caps the ELL slots at the smallest count whose overflow stays
    under ``max_residual / 2`` of all edges.

    Returns ``(winstart, residual_rows, residual_slots, W, kcap)``.
    """
    n, k = cols_np.shape
    if n % R or n % WT:
        raise ValueError(f"n={n} must be a multiple of R={R} and WT={WT}")
    nblocks = n // R

    if deg is not None:
        deg = np.asarray(deg)
        valid = np.arange(k)[None, :] < deg[:, None]
    else:
        valid = np.ones((n, k), dtype=bool)
    total_edges = max(1, int(valid.sum()))

    if kcap is None:
        if deg is not None:
            budget = max_residual / 2 * total_edges
            kcap = k
            for c in range(1, k + 1):
                if np.maximum(np.minimum(deg, k) - c, 0).sum() <= budget:
                    kcap = c
                    break
        else:
            kcap = k
    if kcap_max is not None:
        kcap = min(kcap, kcap_max)

    blocks = cols_np.reshape(nblocks, R * k)
    med = np.median(blocks, axis=1)
    in_cap = np.arange(k)[None, :] < kcap

    def residuals(Wc):
        ws = np.clip(med - Wc // 2, 0, max(0, n - Wc))
        ws = (ws // WT).astype(np.int64) * WT
        ws = np.clip(ws, 0, max(0, n - Wc)).astype(np.int32)
        lo = np.repeat(ws, R)[:, None]
        out = (cols_np < lo) | (cols_np >= lo + Wc)
        return ws, valid & (out | ~in_cap)

    if W is None:
        cap = min(max_W, max(WT, (n // WT) * WT))
        W = WT
        prev = None
        while True:
            winstart, out_mask = residuals(W)
            cur = int(out_mask.sum())
            if cur / total_edges <= max_residual or W >= cap:
                break
            if (gain_per_tile is not None and prev is not None
                    and prev - cur < gain_per_tile):
                W -= WT
                winstart, out_mask = residuals(W)
                break
            prev = cur
            W += WT
    if W % WT or W > n:
        raise ValueError(f"window W={W} must be a multiple of WT={WT} "
                         f"and at most n={n}")
    winstart, out_mask = residuals(W)
    ridx = np.argwhere(out_mask)
    return (winstart, ridx[:, 0].astype(np.int32),
            ridx[:, 1].astype(np.int32), int(W), int(kcap))


def plan_tiles(cols_np, R: int, WT: int, *, min_edges_per_tile: int,
               deg=None, kcap: int | None = None, kcap_max: int | None = None,
               hbm_budget_bytes: float = 8e9, ncols: int | None = None):
    """Per-(row-block, window-tile) occupancy plan.

    A tile is kept when it holds at least ``min_edges_per_tile`` edges
    (the caller states the threshold from its cost model); every block
    keeps its most populated tile, so every output row is written.  Kept
    tiles beyond ``hbm_budget_bytes`` (at 4 bytes a cell) are dropped,
    fewest edges first.

    Returns ``(tile_block, tile_start, block_first, rrows, rslots, kcap)``:
    the row block and first column of each kept tile (sorted by block,
    then column), a 1 on each block's first tile, the residual edges as
    (row, slot) pairs, and the ELL slot cap.
    """
    n, k = cols_np.shape
    if ncols is None:
        ncols = n
    if n % R or ncols % WT:
        raise ValueError(f"rows {n} must be a multiple of R={R} and "
                         f"columns {ncols} a multiple of WT={WT}")
    nblocks = n // R
    ntiles_cols = ncols // WT

    if deg is not None:
        deg = np.asarray(deg)
        valid = np.arange(k)[None, :] < deg[:, None]
    else:
        valid = np.ones((n, k), dtype=bool)
    total_edges = max(1, int(valid.sum()))

    if kcap is None:
        if deg is not None:
            budget = 0.001 * total_edges
            kcap = k
            for c in range(1, k + 1):
                if np.maximum(np.minimum(deg, k) - c, 0).sum() <= budget:
                    kcap = c
                    break
        else:
            kcap = k
    if kcap_max is not None:
        kcap = min(kcap, kcap_max)
    in_cap = np.arange(k)[None, :] < kcap

    block_of = np.repeat(np.arange(nblocks, dtype=np.int64), R)
    covered = valid & in_cap
    brow = block_of[:, None] * np.ones((1, k), np.int64)
    tcol = np.clip(cols_np.astype(np.int64) // WT, 0, ntiles_cols - 1)
    flat = (brow * ntiles_cols + tcol)[covered]
    counts = np.bincount(flat, minlength=nblocks * ntiles_cols).reshape(
        nblocks, ntiles_cols)

    keep = counts >= min_edges_per_tile
    best = counts.argmax(axis=1)
    keep[np.arange(nblocks), best] = True
    max_tiles = (np.inf if np.isinf(hbm_budget_bytes)
                 else int(hbm_budget_bytes / (R * WT * 4)))
    if keep.sum() > max_tiles:
        order = np.argsort(counts[keep])
        drop = keep.sum() - max_tiles
        kept_idx = np.argwhere(keep)
        for bi, ti in kept_idx[order[:drop]]:
            if ti != best[bi]:                   # never drop a block's anchor
                keep[bi, ti] = False

    tb, tt = np.nonzero(keep)
    tile_block = tb.astype(np.int32)
    tile_start = (tt * WT).astype(np.int32)
    block_first = np.zeros(len(tb), np.int32)
    block_first[np.unique(tb, return_index=True)[1]] = 1

    covered_by_kept = covered & keep[block_of[:, None],
                                     np.clip(tcol, 0, ntiles_cols - 1)]
    ridx = np.argwhere(valid & ~covered_by_kept)
    return (tile_block, tile_start, block_first,
            ridx[:, 0].astype(np.int32), ridx[:, 1].astype(np.int32),
            int(kcap))


def pack_tiles(tb, ts, bf, S: int):
    """Group the block-sorted kept tiles into slabs of up to ``S``
    consecutive tiles of the same block.  A short slab is padded at its
    end by repeating its last start with source ``-1`` (a zero tile).
    Returns ``(slab_block, slab_starts (G, S), slab_first,
    slab_src (G, S))``."""
    tb = np.asarray(tb)
    ts = np.asarray(ts)
    bf = np.asarray(bf)
    slabs_b, slabs_ts, slabs_bf, slabs_src = [], [], [], []
    i = 0
    G0 = len(tb)
    while i < G0:
        j = i
        while j < i + S and j < G0 and tb[j] == tb[i]:
            j += 1
        starts = list(ts[i:j])
        src = list(range(i, j))
        while len(starts) < S:
            starts.append(starts[-1])
            src.append(-1)
        slabs_b.append(tb[i])
        slabs_ts.append(starts)
        slabs_bf.append(int(bf[i:j].max()))
        slabs_src.append(src)
        i = j
    return (np.asarray(slabs_b, np.int32),
            np.asarray(slabs_ts, np.int32).reshape(-1, S),
            np.asarray(slabs_bf, np.int32),
            np.asarray(slabs_src, np.int32).reshape(-1, S))


def build_residual_ell(rrows, rslots, cols_np, vals_np, n_pad: int,
                       rb: int | None = None):
    """Regroup the residual edges into an ELL bucket of unique rows by
    ``rb`` slots plus a COO spill for rows with more than ``rb`` residual
    edges.  Returns numpy ``(urows, rcols, rvals, spill_rows, spill_cols,
    spill_vals)``, or None when there is no residual.  Values keep the
    dtype of ``vals_np``."""
    m = len(rrows)
    if m == 0:
        return None
    rcols_e = cols_np[rrows, rslots].astype(np.int64)
    rvals_e = vals_np[rrows, rslots]
    order = np.argsort(rrows, kind="stable")
    rr = rrows[order]
    rc = rcols_e[order]
    rv = rvals_e[order]
    counts = np.bincount(rr, minlength=n_pad)
    urows = np.nonzero(counts)[0]
    if rb is None:
        # 95th-percentile row count, clamped: hub tails go to the spill
        rb = int(np.clip(np.percentile(counts[urows], 95), 4, 32))
    start_of = np.zeros(n_pad + 1, np.int64)
    start_of[1:] = np.cumsum(counts)
    rank = np.arange(m) - start_of[rr]
    in_ell = rank < rb
    ui = np.searchsorted(urows, rr[in_ell])
    rcols = np.zeros((len(urows), rb), np.int32)
    rvals = np.zeros((len(urows), rb), vals_np.dtype)
    rcols[ui, rank[in_ell]] = rc[in_ell]
    rvals[ui, rank[in_ell]] = rv[in_ell]
    return (urows.astype(np.int32), rcols, rvals,
            rr[~in_ell].astype(np.int32), rc[~in_ell].astype(np.int32),
            rv[~in_ell])


# -- device glue (plain torch) -----------------------------------------------


def pack_band(band, slab_src, R: int, WT: int):
    """Re-lay unpacked ``(G0*R, WT)`` tiles into packed ``(G*R, S*WT)``
    slabs; source ``-1`` leaves a zero tile."""
    src = np.asarray(slab_src)
    G, S = src.shape
    G0 = band.shape[0] // R
    out = band.new_zeros((G, R, S, WT))
    g_idx, s_idx = np.nonzero(src >= 0)
    dev = band.device
    out[torch.as_tensor(g_idx, device=dev), :,
        torch.as_tensor(s_idx, device=dev), :] = band.reshape(G0, R, WT)[
            torch.as_tensor(src[g_idx, s_idx].astype(np.int64), device=dev)]
    return out.reshape(G * R, S * WT)


def residual_to_device(resid, device, dtype):
    """Move a :func:`build_residual_ell` result to ``device``."""
    if resid is None:
        return None
    urows, rcols, rvals, sp_r, sp_c, sp_v = resid
    as_idx = lambda a: torch.as_tensor(a.astype(np.int64), device=device)
    as_val = lambda a: torch.as_tensor(a, device=device).to(dtype)
    return (as_idx(urows), as_idx(rcols), as_val(rvals), as_idx(sp_r),
            as_idx(sp_c), as_val(sp_v))


def apply_residual(out, X, resid):
    """Add the residual edges' contribution ``W_resid @ X`` to ``out``, in
    place (``out`` is the band product, owned by the caller).  The sums are
    the same in every run: the ELL bucket's rows are unique, and the
    spill's repeated rows are summed by ``index_put_(accumulate=True)``,
    which orders them (``index_add_`` on CUDA sums by atomics, in the
    order the threads arrive)."""
    if resid is None:
        return out
    urows, rcols, rvals, sp_r, sp_c, sp_v = resid
    if rcols.shape[0]:
        C = torch.einsum("ur,urd->ud", rvals.to(X.dtype), X[rcols])
        out.index_add_(0, urows, C.to(out.dtype))
    if sp_r.shape[0]:
        out.index_put_((sp_r,),
                       (sp_v.to(X.dtype)[:, None] * X[sp_c]).to(out.dtype),
                       accumulate=True)
    return out


# -- explicit matvec plans ------------------------------------------------------


@dataclass(frozen=True)
class _SlabPlan:
    """Device-side plan of a band SpMM: slab ``g`` holds ``slab_ntiles[g]``
    real tiles (pads trail) of output row block ``slab_block[g]``; tile
    ``s`` of slab ``g`` multiplies X rows ``slab_starts[g, s] + [0, WT)``.
    Slabs of block ``b`` are ``block_ptr[b]:block_ptr[b + 1]``."""

    slab_block: torch.Tensor
    slab_starts: torch.Tensor
    slab_ntiles: torch.Tensor
    block_ptr: torch.Tensor
    n: int           # output rows
    x_rows: int      # least number of X rows the plan reads
    R: int
    WT: int
    S: int

    @classmethod
    def from_numpy(cls, slab_block, slab_starts, slab_ntiles, n: int,
                   R: int, WT: int, device):
        slab_block = np.asarray(slab_block, np.int32)
        slab_starts = np.asarray(slab_starts, np.int32)
        slab_starts = slab_starts.reshape(len(slab_block), -1)
        slab_ntiles = np.asarray(slab_ntiles, np.int32)
        S = slab_starts.shape[1]
        if n % R:
            raise ValueError(f"output rows {n} not a multiple of R={R}")
        nblocks = n // R
        if len(slab_block) and (np.any(np.diff(slab_block) < 0)
                                or slab_block[0] < 0
                                or slab_block[-1] >= nblocks):
            raise ValueError("slab_block must be sorted and within the "
                             "output blocks")
        if np.any(slab_ntiles < 1) or np.any(slab_ntiles > S):
            raise ValueError("each slab needs 1..S real tiles")
        if slab_starts.size and slab_starts.min() < 0:
            raise ValueError("negative tile start")
        if np.any(slab_starts % WT):
            # K2/K3 stage a chunk's X rows as one contiguous block
            raise ValueError(f"tile starts must be multiples of WT={WT}")
        x_rows = int(slab_starts.max()) + WT if slab_starts.size else 0
        block_ptr = np.searchsorted(slab_block, np.arange(nblocks + 1),
                                    side="left").astype(np.int32)
        dev = torch.device(device)
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
        return cls(t(slab_block), t(slab_starts), t(slab_ntiles),
                   t(block_ptr), int(n), x_rows, int(R), int(WT), int(S))


class TilesPlan(_SlabPlan):
    """Unpacked tiles (``S = 1``): the plan of K3."""

    @classmethod
    def from_tiles(cls, tile_block, tile_start, n: int, R: int, WT: int,
                   device):
        tile_block = np.asarray(tile_block, np.int32)
        return cls.from_numpy(tile_block, np.asarray(tile_start)[:, None],
                              np.ones(len(tile_block), np.int32), n, R, WT,
                              device)


class PackedPlan(_SlabPlan):
    """Slabs of ``S`` same-block tiles (:func:`pack_tiles`): the plan of
    K2."""

    @classmethod
    def from_slabs(cls, slab_block, slab_starts, slab_src, n: int, R: int,
                   WT: int, device):
        ntiles = (np.asarray(slab_src) >= 0).sum(axis=1)
        return cls.from_numpy(slab_block, slab_starts, ntiles, n, R, WT,
                              device)


@dataclass(frozen=True)
class _WindowPlan:
    """Device-side plan of a rectangular band (:func:`plan_banded`): row
    block ``b`` of ``R`` rows reads the ``W`` columns ``winstart[b] + [0,
    W)`` of its first ``kcap`` ELL slots; ``resid`` (from
    :func:`residual_to_device`, or None) holds every other edge."""

    winstart: torch.Tensor     # (n // R,) int32, on the device
    winstart_host: np.ndarray
    n: int           # rows
    x_rows: int      # least number of X rows the plan reads
    R: int
    WT: int
    W: int
    kcap: int
    resid: tuple | None

    @classmethod
    def from_numpy(cls, winstart, n: int, R: int, WT: int, W: int,
                   kcap: int, device, resid=None):
        winstart = np.ascontiguousarray(winstart, np.int32)
        if n % R or W % WT or winstart.shape != (n // R,):
            raise ValueError(f"rows {n} must be a multiple of R={R}, W={W} "
                             f"of WT={WT}, and winstart "
                             f"{winstart.shape} one per row block")
        if winstart.size and winstart.min() < 0:
            raise ValueError("negative window start")
        x_rows = int(winstart.max()) + W if winstart.size else 0
        return cls(torch.as_tensor(winstart, device=torch.device(device)),
                   winstart, int(n), x_rows, int(R), int(WT), int(W),
                   int(kcap), resid)


class RectPlan(_WindowPlan):
    """A stored ``(n, W)`` band, built by K4: the matvec is K5 and the
    distance rounds are K8."""


class BandedPlan(_WindowPlan):
    """No stored band: the matvec is K6, straight from the capped ELL."""


# -- kernels ------------------------------------------------------------------

_CUDA_BAND_DTYPES = (torch.float32, torch.bfloat16)
# the chunk of the tiles band's live-chunk list (tiles_live_chunks), which
# drives K7 and K9: a warp owns _LIVE_ROWS output rows and reads their
# _LIVE_KC-column chunks (csrc/band_tiles_minplus.cu and band_tiles_lip.cu
# ROWS and KC)
_LIVE_ROWS = 16
_LIVE_KC = 32
# the tensor-core CTA of K2, K3, K5, K10 and K11: csrc/band_tiles_spmm.cu
# ROWS, QROWS, KC, DMAX.  ROWS x KC is also the chunk of the live-chunk
# list of K5 and K8 (rect_live_chunks; band_rect_minplus.cu ROWS and KC).
_TILES_ROWS = 64       # output rows per CTA (K2, K3, K5; K10/K11 at least)
_TILES_QROWS = 128     # ... of K10/K11 where R is a multiple of it
_TILES_KC = 64         # band columns per ring stage
_TILES_DMAX = 128      # widest d of one launch
_TILES_FMA_DMAX = 16   # K2/K3/K5 f32 up to this d sum by FFMA (FMA_DMAX)
_RECT_WIN_ALIGN = 8    # K5/K8 window starts: whole 16-byte pieces of X


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def _require_cuda(name, dev, **tensors):
    for k, t in tensors.items():
        _require(t.device == dev, f"{name}: {k} is on {t.device}, not {dev}")
        _require(t.is_contiguous(), f"{name}: {k} must be contiguous")


def _dispatch_device(name, *tensors):
    """'cpu' when every tensor is on the CPU, 'cuda' when every one is on
    one CUDA device; raises otherwise."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev.type


def _materialize_band_tiles_plain(cols, vals, tile_block, tile_start, R, WT,
                                  out_dtype):
    """Plain twin of K1: scatter each tile row's in-tile slots into a
    zeroed (R, WT) block, summing duplicate columns in f32 (f64 for an f64
    band) before one cast."""
    acc = torch.float64 if out_dtype == torch.float64 else torch.float32
    dev = cols.device
    G = tile_block.shape[0]
    rows = tile_block.long()[:, None] * R + torch.arange(R, device=dev)
    c = cols.long()[rows]                                       # (G, R, k)
    v = vals.to(acc)[rows]
    local = c - tile_start.long()[:, None, None]
    ok = (local >= 0) & (local < WT)
    cell = (torch.arange(G * R, device=dev).reshape(G, R, 1) * WT
            + local.clamp(0, WT - 1))
    out = torch.zeros(G * R * WT, dtype=acc, device=dev)
    out.index_add_(0, cell[ok], v[ok])
    return out.reshape(G * R, WT).to(out_dtype)


def materialize_band_tiles(cols, vals, tile_block, tile_start, R: int,
                           WT: int, out_dtype=torch.float32):
    """K1: the compact ``(G*R, WT)`` tiled band, one dense (R, WT) block per
    kept tile (see :func:`plan_tiles`).  ``cols``/``vals`` are the first
    ``kcap`` ELL slots, ``(n, kcap)``.

    Replaces ``graphlearning_tpu/ops/pallas_spmm.py:661``
    ``materialize_band_tiles`` (kernel ``_tiles_build_kernel``, :642).
    On the H100 it is bound by bytes: it writes the zeroed band once and
    reads each row's slots once per tile.  One thread owns one (tile, row),
    so it needs no atomics; it sums a column's duplicate slots in f32 and
    rounds once, instead of the TPU kernel's k compare/select passes over
    the whole block.  Runs once per graph.
    """
    G = tile_block.shape[0]
    if _dispatch_device("materialize_band_tiles", cols, vals, tile_block,
                        tile_start) == "cpu":
        return _materialize_band_tiles_plain(cols, vals, tile_block,
                                             tile_start, R, WT, out_dtype)
    dev = cols.device
    _require_cuda("materialize_band_tiles", dev, cols=cols, vals=vals,
                  tile_block=tile_block, tile_start=tile_start)
    _require(cols.dtype == torch.int32 and tile_block.dtype == torch.int32
             and tile_start.dtype == torch.int32,
             "materialize_band_tiles: index tensors must be int32")
    _require(vals.dtype == torch.float32,
             "materialize_band_tiles: vals must be float32 on CUDA")
    _require(out_dtype in _CUDA_BAND_DTYPES,
             f"materialize_band_tiles: no CUDA kernel for {out_dtype}")
    _require(cols.dim() == 2 and cols.shape == vals.shape
             and cols.shape[0] % R == 0,
             f"materialize_band_tiles: cols {tuple(cols.shape)} / vals "
             f"{tuple(vals.shape)} must be (n, k) with n a multiple of R={R}")
    _require(tile_start.shape == (G,),
             "materialize_band_tiles: tile_block and tile_start differ")
    out = torch.zeros((G * R, WT), dtype=out_dtype, device=dev)
    lib = _build.load("band_tiles_build")
    rc = lib.glt_tiles_build(
        _ptr(cols), _ptr(vals), int(cols.shape[1]), _ptr(tile_block),
        _ptr(tile_start), int(G), int(R), int(WT), _ptr(out),
        int(out_dtype == torch.bfloat16), _stream(cols))
    if rc:
        raise RuntimeError(f"materialize_band_tiles: CUDA error {rc}")
    materialize_band_tiles.launches += 1
    return out


materialize_band_tiles.launches = 0


def _slab_windows(plan: _SlabPlan, X, acc):
    """Each slab's S stacked X windows in ``acc``: (G, S*WT, d)."""
    G = plan.slab_block.shape[0]
    rows = (plan.slab_starts.long()[:, :, None]
            + torch.arange(plan.WT, device=X.device)).reshape(-1)
    return X.to(acc)[rows].reshape(G, plan.S * plan.WT, X.shape[1])


def _block_sums(plan: _SlabPlan, prod):
    """Sum the slabs' (G, R, d) products into their output row blocks:
    (plan.n, d)."""
    R = plan.R
    out = prod.new_zeros((plan.n // R, R, prod.shape[2]))
    out.index_add_(0, plan.slab_block.long(), prod)
    return out.reshape(plan.n, prod.shape[2])


def _tiles_spmm_plain(band, plan: _SlabPlan, X):
    """Plain twin of K2/K3: each slab's (R, S*WT) block times its stacked
    X windows, summed into the slab's output block.  Exact products in
    f32 (f64 for an f64 band) for an f32 or a bf16 band."""
    acc = torch.float64 if band.dtype == torch.float64 else torch.float32
    G = plan.slab_block.shape[0]
    A = band.to(acc).reshape(G, plan.R, plan.S * plan.WT)
    return _block_sums(plan, torch.bmm(A, _slab_windows(plan, X, acc)))


def _require_x_rows(name, plan: _SlabPlan, X):
    _require(X.dim() == 2 and X.shape[1] >= 1 and X.shape[0] >= plan.x_rows,
             f"{name}: X {tuple(X.shape)} needs >= {plan.x_rows} rows")


def _require_tiles_launch(name, plan: _SlabPlan, X, **planes):
    """The checks of the tensor-core CTA (K2, K3, K10, K11): X's rows, the
    CTA geometry, and operands on 16-byte boundaries (the ``cp.async``
    ring copies 16-byte pieces)."""
    _require_x_rows(name, plan, X)
    _require(plan.R % _TILES_ROWS == 0 and plan.WT % _TILES_KC == 0,
             f"{name}: the kernel takes R a multiple of {_TILES_ROWS} and "
             f"WT a multiple of {_TILES_KC}")
    for k, t in dict(planes, X=X).items():
        _require(t.data_ptr() % 16 == 0,
                 f"{name}: {k} must start on a 16-byte boundary")


def _column_blocks(name, X, out, launch):
    """Call ``launch(X block, out pointer, its d)`` once per
    ``_TILES_DMAX`` columns of d (one launch covers d <= _TILES_DMAX; wider
    X goes in column blocks into the strided ``out``); returns the number
    of launches."""
    d = X.shape[1]
    n_launch = 0
    for c0 in range(0, d, _TILES_DMAX):
        Xc = X if d <= _TILES_DMAX else X[:, c0:c0 + _TILES_DMAX].contiguous()
        rc = launch(Xc, ctypes.c_void_p(out.data_ptr() + 4 * c0),
                    int(Xc.shape[1]))
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")
        n_launch += 1
    return n_launch


def _plan_args(plan: _SlabPlan):
    return (int(plan.R), _ptr(plan.block_ptr), _ptr(plan.slab_starts),
            _ptr(plan.slab_ntiles), int(plan.S), int(plan.WT),
            int(plan.n // plan.R))


def _tiles_spmm_cuda(name, band, plan: _SlabPlan, X):
    """Launch K2/K3 once per ``_TILES_DMAX`` columns of d; returns ``(out,
    launches)``."""
    dev = band.device
    _require_cuda(name, dev, band=band, X=X, slab_starts=plan.slab_starts,
                  slab_ntiles=plan.slab_ntiles, block_ptr=plan.block_ptr)
    _require(band.dtype in _CUDA_BAND_DTYPES and X.dtype == band.dtype,
             f"{name}: band {band.dtype} and X {X.dtype} must both be "
             "float32 or both bfloat16 on CUDA")
    G = plan.slab_block.shape[0]
    _require(band.shape == (G * plan.R, plan.S * plan.WT),
             f"{name}: band {tuple(band.shape)} does not match the plan "
             f"({G * plan.R}, {plan.S * plan.WT})")
    _require_tiles_launch(name, plan, X, band=band)
    d = X.shape[1]
    out = torch.empty((plan.n, d), dtype=torch.float32, device=dev)
    lib = _build.load("band_tiles_spmm")
    n_launch = _column_blocks(name, X, out, lambda Xc, o, dc: (
        lib.glt_tiles_spmm(
            _ptr(band), int(band.dtype == torch.bfloat16),
            int(band.shape[1]), *_plan_args(plan), _ptr(Xc), dc, o, int(d),
            _stream(band))))
    return out, n_launch


def band_tiles_spmm_packed(band, plan: PackedPlan, X):
    """K2: ``out = packed band @ X``; ``out`` is (plan.n, d) float32 (f64
    for the CPU twin on an f64 band).

    Replaces ``graphlearning_tpu/ops/pallas_spmm.py:1077``
    ``band_tiles_spmm_packed`` (kernel ``_tiles_packed_kernel``, :1040).
    On the H100 its bound is the bytes of the band at any d up to 128: the
    dense tiles' products run on the tensor cores, and only their occupied
    fragments (about 10 % at the bench geometry).  One CTA of 8 warps (16
    for f32 above 32 columns of d) owns 64 output rows of one row block and
    all of d up to 128 (wider X goes in 128-column launches): it walks that
    block's slabs through a 4-stage ``cp.async`` ring of 64-column band
    chunks and their X rows, multiplies on the tensor cores (bf16
    ``mma.sync``, or 3xTF32 for the exact f32 mode), splits each chunk's K
    slices across its warps and sums their partial tiles in shared memory
    before one store (no atomics, so the zeroing flag of the TPU kernel is
    implicit).  The exact f32 mode at d <= ``_TILES_FMA_DMAX`` (a fit's
    class count) sums by FFMA instead, rounded to nearest: one row and a
    quarter of each chunk a thread.  Pad tiles and all-zero band fragments
    are skipped.  d is not padded in memory (the TPU padded it to its 128 lanes).  Modes: an f32
    band with f32 X computes f32 to about 2^-21 (the TPU's f32 and bf16x3);
    a bf16 band with bf16 X multiplies exactly and sums in f32 (the TPU's
    bf16).  ``band`` and ``X`` must start on 16-byte boundaries; R must be a
    multiple of 64 and WT of 64.
    """
    if not isinstance(plan, PackedPlan):
        raise TypeError("band_tiles_spmm_packed takes a PackedPlan")
    if _dispatch_device("band_tiles_spmm_packed", band, X,
                        plan.slab_starts) == "cpu":
        return _tiles_spmm_plain(band, plan, X)
    out, n_launch = _tiles_spmm_cuda("band_tiles_spmm_packed", band, plan,
                                     X)
    band_tiles_spmm_packed.launches += n_launch
    if band.dtype == torch.bfloat16:
        band_tiles_spmm_packed.bf16_launches += n_launch
    by_d = band_tiles_spmm_packed.launches_by_d
    by_d[X.shape[1]] = by_d.get(X.shape[1], 0) + n_launch
    return out


band_tiles_spmm_packed.launches = 0
band_tiles_spmm_packed.bf16_launches = 0  # of them, on a bf16 band
band_tiles_spmm_packed.launches_by_d = {}  # of them, by X's columns


def band_tiles_spmm(band, plan: TilesPlan, X):
    """K3: ``out = tiled band @ X`` over single (R, WT) tiles; ``X`` may be
    rectangular (tile starts index X rows, tile blocks index output
    rows).  CUDA takes f32 and bf16; an f64 band runs on the CPU twin.

    Replaces ``graphlearning_tpu/ops/pallas_spmm.py:742``
    ``band_tiles_spmm`` (kernel ``_tiles_matmul_kernel``, :700).  The same
    CUDA kernel as K2 with S = 1, so the same bound and design: see
    :func:`band_tiles_spmm_packed`.
    """
    if not isinstance(plan, TilesPlan):
        raise TypeError("band_tiles_spmm takes a TilesPlan")
    if _dispatch_device("band_tiles_spmm", band, X,
                        plan.slab_starts) == "cpu":
        return _tiles_spmm_plain(band, plan, X)
    out, n_launch = _tiles_spmm_cuda("band_tiles_spmm", band, plan, X)
    band_tiles_spmm.launches += n_launch
    if band.dtype == torch.bfloat16:
        band_tiles_spmm.bf16_launches += n_launch
    return out


band_tiles_spmm.launches = 0
band_tiles_spmm.bf16_launches = 0  # of them, on a bf16 band


# -- K10 and K11: quantized packed bands -----------------------------------------


def packed_row_of(plan: PackedPlan):
    """The graph row of each packed band row: row ``r`` of slab ``g`` is
    ``slab_block[g] * R + r``."""
    R = plan.R
    dev = plan.slab_block.device
    G = plan.slab_block.shape[0]
    return (plan.slab_block.long().repeat_interleave(R) * R
            + torch.arange(R, device=dev).repeat(G))


def quantize_band_rowq(band, plan: PackedPlan, n: int, planes: int = 2):
    """Row-quantize a packed f32 band ``(G*R, S*WT)`` into ``(qband,
    srow)``: ``qband`` int8 ``(G*R, planes*S*WT)`` with the planes side by
    side in each row, ``srow`` (n,) f32, and ``band[i] ~ srow[row] *
    (q_hi[i] + q_lo[i] / 254)`` for the graph row ``row`` of band row
    ``i`` (:func:`packed_row_of`), so slabs of one row block share their
    rows' scales.  ``srow`` is the least power of two with ``127 * srow >=
    rowmax`` (1 where a row holds no weight), so rescaling is exact.

    JAX's ``quantize_band_rowq`` (``pallas_spmm.py:1239``) in plain torch,
    rounding half to even as ``jnp.round``.  Two departures: the exponent
    is exact (``frexp``; JAX takes ``ceil(log2(rowmax / 127))`` in f32,
    which can be off by one where ``log2`` rounds across an integer),
    and it is clamped to ``>= -126``, so a row of subnormal weights gets
    a normal scale where JAX's underflows to 0 on a device that flushes
    subnormals."""
    if planes not in (1, 2):
        raise ValueError(f"planes must be 1 or 2, not {planes}")
    _require(band.dtype == torch.float32 and band.dim() == 2,
             "quantize_band_rowq: the band must be a 2-D float32 tensor")
    row_of = packed_row_of(plan)
    rowmax = torch.zeros(n, dtype=torch.float32, device=band.device)
    rowmax = rowmax.scatter_reduce(0, row_of, band.abs().amax(dim=1), "amax")
    has = rowmax > 0
    mant, ex = torch.frexp(torch.where(has, rowmax, 1.0) / 127.0)
    e = (ex - (mant == 0.5).to(ex.dtype)).clamp(min=-126)
    s = torch.where(has, torch.ldexp(torch.ones_like(rowmax), e), 1.0)
    s = torch.where(rowmax > 127.0 * s, 2.0 * s, s)
    t = band / s[row_of][:, None]                     # |t| <= 127
    q_hi = torch.round(t)
    if planes == 1:
        return q_hi.clamp(-127, 127).to(torch.int8), s
    q_lo = torch.round((t - q_hi) * 254.0).clamp(-127, 127)
    return torch.cat([q_hi.clamp(-127, 127), q_lo], dim=1).to(torch.int8), s


def quantize_band_i8(band):
    """Split an f32 band into ``(hi, q)``: ``hi`` bf16 and ``q`` int8, with
    ``band ~ hi + q * ulp(hi) * 2**-8`` per cell.  ``ulp(hi) * 2**-8 =
    2**(e - 15)`` comes from ``hi``'s exponent bits, so no scale is
    stored.  JAX's ``quantize_band_i8`` (``pallas_spmm.py:1129``) in plain
    torch (eager torch needs no barrier against folding the round
    trip)."""
    _require(band.dtype == torch.float32,
             "quantize_band_i8: the band must be float32")
    hi = band.to(torch.bfloat16)
    r = band - hi.to(torch.float32)
    u = (hi.view(torch.int16) & 0x7F80).view(torch.bfloat16).to(
        torch.float32)
    s = u * 2.0 ** -15
    q = torch.where(s > 0, torch.round(r / torch.where(s > 0, s, 1.0)), 0.0)
    return hi, q.clamp(-127, 127).to(torch.int8)


def _dequantize_i8(hi, q, acc):
    """``hi + q * 2**(e - 15)`` in ``acc``: exact in f32, since both terms
    fit in 16 significant bits at ``hi``'s exponent."""
    u = (hi.view(torch.int16) & 0x7F80).view(torch.bfloat16).to(acc)
    return hi.to(acc) + q.to(acc) * (u * 2.0 ** -15)


def _tiles_spmm_rowq_plain(qband, srow, plan: PackedPlan, X, planes: int):
    """Plain twin of K10: per slab the int8 planes (exact in f32) times the
    X windows, the planes summed apart over each block's slabs, then
    ``srow * (acc_hi + acc_lo / 254)``; in f32, f64 for f64 X."""
    acc = torch.float64 if X.dtype == torch.float64 else torch.float32
    G = plan.slab_block.shape[0]
    SW = plan.S * plan.WT
    Q = qband.reshape(G, plan.R, planes * SW)
    Xw = _slab_windows(plan, X, acc)
    out = _block_sums(plan, torch.bmm(Q[:, :, :SW].to(acc), Xw))
    if planes == 2:
        out = out + _block_sums(plan, torch.bmm(Q[:, :, SW:].to(acc),
                                                Xw)) / 254.0
    return srow.to(acc)[:, None] * out


def _tiles_spmm_i8_plain(hi, q, plan: PackedPlan, X):
    """Plain twin of K11: the band rebuilt exactly from ``hi`` and ``q``,
    times the X windows; in f32, f64 for f64 X."""
    acc = torch.float64 if X.dtype == torch.float64 else torch.float32
    G = plan.slab_block.shape[0]
    A = _dequantize_i8(hi, q, acc).reshape(G, plan.R, plan.S * plan.WT)
    return _block_sums(plan, torch.bmm(A, _slab_windows(plan, X, acc)))


def _require_packed_plan(name, plan):
    if not isinstance(plan, PackedPlan):
        raise TypeError(f"{name} takes a PackedPlan")


def band_tiles_spmm_packed_rowq(qband, srow, plan: PackedPlan, X,
                                planes: int = 2):
    """K10: ``out = srow * (q_hi + q_lo / 254) @ X`` on the packed slabs of
    a :func:`quantize_band_rowq` band; ``out`` is (plan.n, d) float32
    (f64 for the CPU twin on f64 X), already scaled by ``srow``.
    ``planes=2`` (exact grade) takes f32 X, ``planes=1`` bf16 X.

    Replaces ``graphlearning_tpu/ops/pallas_spmm.py:1301``
    ``band_tiles_spmm_packed_rowq`` (kernel ``_tiles_packed_rowq_kernel``,
    :1267).  On the H100 its bound is the band's bytes (1 or 2 a cell);
    at d near 128 it is held by the CTA's work on each band fragment
    (loads, votes, rebuilt cells, X splits), not by bytes.  K2's
    tensor-core
    CTA (``csrc/band_tiles_spmm.cu``) with the int8 planes staged as
    stored: planes=2 rebuilds each cell ``q_hi + q_lo / 254`` in f32 at
    the fragment load and multiplies in 3xTF32, as K2's f32 mode (about
    2^-21); planes=1 multiplies int8 cells (exact in bf16) by bf16 X on
    the bf16 tensor cores.  The epilogue writes ``srow[row] * sum`` once:
    the row's power-of-two scale is fused there, where JAX scaled after
    the kernel.  The TPU's bf16 hi/lo split of X is dropped.  A CTA takes
    128 rows where R is a multiple of 128, else 64; d > 128 goes in
    128-column launches.  Operands must start on
    16-byte boundaries; R must be a multiple of 64 and WT of 64."""
    name = "band_tiles_spmm_packed_rowq"
    _require_packed_plan(name, plan)
    if planes not in (1, 2):
        raise ValueError(f"{name}: planes must be 1 or 2, not {planes}")
    if _dispatch_device(name, qband, srow, X, plan.slab_starts) == "cpu":
        return _tiles_spmm_rowq_plain(qband, srow, plan, X, planes)
    dev = qband.device
    _require_cuda(name, dev, qband=qband, srow=srow, X=X,
                  slab_starts=plan.slab_starts, slab_ntiles=plan.slab_ntiles,
                  block_ptr=plan.block_ptr)
    x_dtype = torch.float32 if planes == 2 else torch.bfloat16
    _require(qband.dtype == torch.int8 and srow.dtype == torch.float32
             and X.dtype == x_dtype,
             f"{name}: planes={planes} takes an int8 band, float32 srow and "
             f"{x_dtype} X, not {qband.dtype}, {srow.dtype}, {X.dtype}")
    G = plan.slab_block.shape[0]
    SW = plan.S * plan.WT
    _require(qband.shape == (G * plan.R, planes * SW),
             f"{name}: band {tuple(qband.shape)} does not match the plan "
             f"({G * plan.R}, {planes * SW})")
    _require(srow.shape == (plan.n,),
             f"{name}: srow {tuple(srow.shape)} must be ({plan.n},)")
    _require_tiles_launch(name, plan, X, qband=qband, srow=srow)
    d = X.shape[1]
    out = torch.empty((plan.n, d), dtype=torch.float32, device=dev)
    lib = _build.load("band_tiles_spmm")
    band_tiles_spmm_packed_rowq.launches += _column_blocks(
        name, X, out, lambda Xc, o, dc: lib.glt_tiles_spmm_rowq(
            _ptr(qband), int(planes), _ptr(srow), *_plan_args(plan),
            _ptr(Xc), dc, o, int(d), _stream(qband)))
    return out


band_tiles_spmm_packed_rowq.launches = 0


def band_tiles_spmm_packed_i8(hi, q, plan: PackedPlan, X):
    """K11: ``out = (hi + q * 2**(e_hi - 15)) @ X`` on the packed slabs of
    a :func:`quantize_band_i8` band (``hi`` bf16 and ``q`` int8, both
    (G*R, S*WT)); X float32, ``out`` (plan.n, d) float32 (f64 for the CPU
    twin on f64 X).

    Replaces ``graphlearning_tpu/ops/pallas_spmm.py:1184``
    ``band_tiles_spmm_packed_i8`` (kernel ``_tiles_packed_i8_kernel``,
    :1152).  On the H100 its bound is the band's 3 bytes a cell; at d
    near 128 it is held by the CTA's fragment work, as K10.  K2's
    tensor-core CTA with
    ``hi`` and ``q`` staged as stored; each occupied fragment's cells are
    rebuilt exactly in f32 from ``hi``'s exponent bits and multiplied in
    3xTF32, as K2's f32 mode.  The TPU's bf16 hi/lo split of X is
    dropped, as in K10; CTA rows, wide d and alignment as K10's."""
    name = "band_tiles_spmm_packed_i8"
    _require_packed_plan(name, plan)
    if _dispatch_device(name, hi, q, X, plan.slab_starts) == "cpu":
        return _tiles_spmm_i8_plain(hi, q, plan, X)
    dev = hi.device
    _require_cuda(name, dev, hi=hi, q=q, X=X, slab_starts=plan.slab_starts,
                  slab_ntiles=plan.slab_ntiles, block_ptr=plan.block_ptr)
    _require(hi.dtype == torch.bfloat16 and q.dtype == torch.int8
             and X.dtype == torch.float32,
             f"{name}: takes bfloat16 hi, int8 q and float32 X, not "
             f"{hi.dtype}, {q.dtype}, {X.dtype}")
    G = plan.slab_block.shape[0]
    shape = (G * plan.R, plan.S * plan.WT)
    _require(hi.shape == shape and q.shape == shape,
             f"{name}: hi {tuple(hi.shape)} and q {tuple(q.shape)} must be "
             f"{shape}")
    _require_tiles_launch(name, plan, X, hi=hi, q=q)
    d = X.shape[1]
    out = torch.empty((plan.n, d), dtype=torch.float32, device=dev)
    lib = _build.load("band_tiles_spmm")
    band_tiles_spmm_packed_i8.launches += _column_blocks(
        name, X, out, lambda Xc, o, dc: lib.glt_tiles_spmm_i8(
            _ptr(hi), _ptr(q), *_plan_args(plan), _ptr(Xc), dc, o, int(d),
            _stream(hi)))
    return out


band_tiles_spmm_packed_i8.launches = 0


# -- K4: the rectangular band --------------------------------------------------


def _materialize_band_plain(cols, vals, winstart, W, R, out_dtype):
    """Plain twin of K4: scatter each row's in-window slots into a zeroed
    (n, W) band, summing duplicate columns in f32 (f64 for an f64 band)
    before one cast."""
    acc = torch.float64 if out_dtype == torch.float64 else torch.float32
    n = cols.shape[0]
    dev = cols.device
    lo = torch.repeat_interleave(winstart.long(), R)[:, None]
    local = cols.long() - lo
    ok = (local >= 0) & (local < W)
    cell = (torch.arange(n, device=dev)[:, None] * W
            + local.clamp(0, W - 1))
    out = torch.zeros(n * W, dtype=acc, device=dev)
    out.index_add_(0, cell[ok], vals.to(acc)[ok])
    return out.reshape(n, W).to(out_dtype)


def materialize_band(cols, vals, winstart, W: int, R: int, WT: int,
                     out_dtype=torch.float32):
    """K4: the rectangular ``(n, W)`` band, ``band[i, c] = sum of vals[i,
    j]`` over the slots with ``cols[i, j] == winstart[i // R] + c``;
    out-of-window slots are dropped (the caller's residual holds them).
    ``cols``/``vals`` are ``(n, kcap)``; ``W`` is a multiple of ``WT``.

    Replaces ``graphlearning_tpu/ops/pallas_spmm.py:197``
    ``materialize_band`` (kernel ``_band_build_kernel``, :171).  On the
    H100 it is bound by bytes: the wrapper zeroes the band, and the kernel
    reads each row's slots once per ``WT``-wide window chunk and writes
    only the nonzero cells.  One thread owns one (row, chunk), so it needs
    no atomics; duplicate columns are summed in f32 in slot order and
    rounded once, so a bf16 band rounds as JAX's does.  The TPU's k
    compare/select passes over whole blocks and its (chunk, row) grid
    order, a note about its DMA, are not carried over.  Runs once per
    graph."""
    n, k = cols.shape
    if n % R or W % WT or winstart.shape != (n // R,):
        raise ValueError(f"materialize_band: rows {n} must be a multiple of "
                         f"R={R}, W={W} of WT={WT}, and winstart "
                         f"{tuple(winstart.shape)} one per row block")
    if _dispatch_device("materialize_band", cols, vals, winstart) == "cpu":
        return _materialize_band_plain(cols, vals, winstart, W, R, out_dtype)
    dev = cols.device
    _require_cuda("materialize_band", dev, cols=cols, vals=vals,
                  winstart=winstart)
    _require(cols.dtype == torch.int32 and winstart.dtype == torch.int32,
             "materialize_band: index tensors must be int32")
    _require(vals.dtype == torch.float32 and vals.shape == cols.shape,
             "materialize_band: vals must be float32, shaped like cols")
    _require(out_dtype in _CUDA_BAND_DTYPES,
             f"materialize_band: no CUDA kernel for {out_dtype}")
    out = torch.zeros((n, W), dtype=out_dtype, device=dev)
    lib = _build.load("band_rect_build")
    rc = lib.glt_rect_build(
        _ptr(cols), _ptr(vals), int(k), _ptr(winstart), int(n), int(R),
        int(W), int(WT), _ptr(out), int(out_dtype == torch.bfloat16),
        _stream(cols))
    if rc:
        raise RuntimeError(f"materialize_band: CUDA error {rc}")
    materialize_band.launches += 1
    return out


materialize_band.launches = 0


# -- K7: min-plus rounds over the tiles ----------------------------------------

MINPLUS_BIG = 1e30       # min where a row has no candidate
_NO_ARG = torch.iinfo(torch.int32).max
_TWIN_CELLS = 1 << 24    # tile cells per chunk of the twins


def _tile_chunks(plan: _SlabPlan, per_tile: int):
    """Tile ranges ``[g0, g1)`` of a twin's chunks, at most
    ``_TWIN_CELLS`` elements each when a tile costs ``per_tile``."""
    G = plan.slab_block.shape[0]
    step = max(1, _TWIN_CELLS // max(1, per_tile))
    return [(g0, min(G, g0 + step)) for g0 in range(0, G, step)]


def _minplus_cand(A, d, f, hopf_lax: bool, recip: bool):
    """The relaxation candidates of band values ``A`` against the window
    values ``d``, ``f``; ``MINPLUS_BIG`` where ``A`` holds no edge."""
    if recip:
        A = torch.where(A > 0, 1.0 / torch.where(A == 0, 1.0, A), 0.0)
    if hopf_lax:
        fw = A * f
        cand = 0.5 * (fw + torch.sqrt(fw * fw + 4.0 * d * d))
    else:
        cand = d + A * f
    return torch.where(A > 0, cand, MINPLUS_BIG)


def _tiles_minplus_plain(band, plan: TilesPlan, d, f, hopf_lax: bool,
                         track_arg: bool, recip: bool):
    """Plain twin of K7, in f32 (f64 for an f64 band): per row the least
    candidate over its tiles' cells, ``MINPLUS_BIG`` where none is
    smaller; with ``track_arg`` the column of the first such cell, earlier
    tiles first and the smallest column within a tile, else -1."""
    acc = torch.float64 if band.dtype == torch.float64 else torch.float32
    dev = band.device
    R, WT = plan.R, plan.WT
    tb = plan.slab_block.long()
    starts = plan.slab_starts[:, 0].long()
    d, f = d.to(acc), f.to(acc)
    ms, cols = [], []
    for g0, g1 in _tile_chunks(plan, R * WT):
        idx = starts[g0:g1, None] + torch.arange(WT, device=dev)
        A = band[g0 * R:g1 * R].to(acc).reshape(g1 - g0, R, WT)
        cand = _minplus_cand(A, d[idx][:, None, :], f[idx][:, None, :],
                             hopf_lax, recip)
        m = torch.amin(cand, dim=2)
        ms.append(m)
        if track_arg:
            hit = cand == m[:, :, None]
            cols.append(torch.amin(torch.where(
                hit, idx[:, None, :].to(torch.int32), _NO_ARG), dim=2))
    nblocks = plan.n // R
    best = torch.full((nblocks, R), MINPLUS_BIG, dtype=acc, device=dev)
    if not ms:
        return best.reshape(-1), (torch.full((plan.n,), -1, dtype=torch.int32,
                                             device=dev) if track_arg else None)
    m_all = torch.cat(ms)
    segment_reduce(best, tb, m_all, "min")
    if not track_arg:
        return best.reshape(-1), None
    # the first tile (in plan order) whose own minimum is the row's
    take = (m_all == best[tb]) & (m_all < MINPLUS_BIG)
    G = m_all.shape[0]
    tile = torch.arange(G, device=dev)[:, None].expand(G, R)
    first = torch.full((nblocks, R), G, dtype=torch.long, device=dev)
    segment_reduce(first, tb, torch.where(take, tile, G), "min")
    col_all = torch.cat(cols)
    arg = torch.gather(torch.cat([col_all, torch.full_like(col_all[:1], -1)]),
                       0, first)
    return best.reshape(-1), arg.reshape(-1)


def band_tiles_minplus(band, plan: TilesPlan, d, f, hopf_lax: bool = False,
                       track_arg: bool = False, recip: bool = False,
                       chunks=None):
    """K7: one min-plus relaxation round over the unpacked tiles.  For each
    output row, the least of ``d[c] + A f[c]`` (or the Hopf-Lax
    ``(f A + sqrt((f A)^2 + 4 d[c]^2)) / 2``) over the tile cells ``c``
    with ``A > 0``; ``recip`` uses ``1/A`` for ``A``.  Returns ``(min,
    arg)``: ``min`` (plan.n,) float32 (f64 for the CPU twin on an f64
    band), ``MINPLUS_BIG`` where no candidate is smaller; ``arg`` (plan.n,)
    int32, the column of the least candidate (earlier tile, then smaller
    column, on ties) or -1, and None without ``track_arg``.  ``chunks``:
    the band's :func:`tiles_live_chunks`, built here when None.

    Replaces ``graphlearning_tpu/ops/pallas_spmm.py:824``
    ``band_tiles_minplus`` (kernel ``_tiles_minplus_kernel``, :781).  On
    the H100 it is bound by the bytes of the band's live chunks (a few
    flops per cell); a skipped chunk holds no edge, so no candidate.  One
    warp owns 16 output rows and walks their live 16 x 32 chunks in list
    order (tile, then column); two lanes serve a row, each with 16-byte
    loads of 16 cells and their ``d`` and ``f`` straight from global
    memory, the next chunk's loads in flight while the current one is
    reduced.  Each lane keeps its row's least candidate and that
    candidate's column and place in the list (a later cell wins only when
    strictly smaller), and one shuffle combines the two lanes, the
    earlier place on ties: the TPU's first-tile reset and smallest lane.
    The candidates are formed with the same f32 operations as the twin,
    in round-to-nearest without contraction, so the two agree exactly.
    The argmin comes back as int32, not as the TPU's float-coded lane, and
    the output is (n,), not the TPU's 128 lanes.  R must be a multiple of
    16 and WT of 32; ``band``, ``d`` and ``f`` must start on 16-byte
    boundaries."""
    if not isinstance(plan, TilesPlan):
        raise TypeError("band_tiles_minplus takes a TilesPlan")
    if _dispatch_device("band_tiles_minplus", band, d, f,
                        plan.slab_starts) == "cpu":
        return _tiles_minplus_plain(band, plan, d, f, hopf_lax, track_arg,
                                    recip)
    dev = band.device
    name = "band_tiles_minplus"
    _require_cuda(name, dev, band=band, d=d, f=f,
                  tile_start=plan.slab_starts)
    _require(band.dtype in _CUDA_BAND_DTYPES,
             f"{name}: band must be float32 or bfloat16 on CUDA")
    _require(d.dtype == torch.float32 and f.dtype == torch.float32,
             f"{name}: d and f must be float32 on CUDA")
    _require_tiles_band(name, band, plan)
    _require(d.dim() == 1 and d.shape == f.shape
             and d.shape[0] >= plan.x_rows,
             f"{name}: d and f must be (>= {plan.x_rows},)")
    chunk_ptr, chunk_id = _chunk_launch_args(name, band, plan, chunks, d=d,
                                             f=f)
    out = torch.empty((plan.n,), dtype=torch.float32, device=dev)
    arg = (torch.empty((plan.n,), dtype=torch.int32, device=dev)
           if track_arg else None)
    lib = _build.load("band_tiles_minplus")
    rc = lib.glt_tiles_minplus(
        _ptr(band), int(band.dtype == torch.bfloat16), int(plan.R),
        int(plan.WT), _ptr(chunk_ptr), _ptr(chunk_id),
        _ptr(plan.slab_starts), int(plan.n // _LIVE_ROWS), _ptr(d), _ptr(f),
        _ptr(out), _ptr(arg) if track_arg else ctypes.c_void_p(0),
        int(hopf_lax), int(recip), int(track_arg), _stream(band))
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    band_tiles_minplus.launches += 1
    return out, arg


band_tiles_minplus.launches = 0


def residual_minplus(d, f, resid, hopf_lax: bool = False,
                     track_arg: bool = False, recip: bool = False):
    """Min-plus contribution of the residual edges
    (:func:`residual_to_device`; zero-valued slots are padding).  Returns
    ``(min, arg)`` per row (``MINPLUS_BIG`` / -1 where none; ``arg`` None
    without ``track_arg``).  Where several spill edges of a row tie for
    its least candidate, the smallest column wins (the JAX package keeps
    whichever scatter lands last)."""
    urows, rcols, rvals, sp_r, sp_c, sp_v = resid
    n = d.shape[0]
    dev = d.device
    best = torch.full((n,), MINPLUS_BIG, dtype=d.dtype, device=dev)
    arg = torch.full((n,), -1, dtype=torch.int32, device=dev)
    rvals, sp_v = rvals.to(d.dtype), sp_v.to(d.dtype)
    if rcols.shape[0]:
        cand = _minplus_cand(rvals, d[rcols], f[rcols], hopf_lax, recip)
        m, slot = torch.min(cand, dim=1)              # first slot on ties
        best[urows] = m
        a = torch.gather(rcols, 1, slot[:, None])[:, 0].to(torch.int32)
        arg[urows] = torch.where(m < MINPLUS_BIG, a, -1)
    if sp_r.shape[0]:
        cand = _minplus_cand(sp_v, d[sp_c], f[sp_c], hopf_lax, recip)
        prev = best[sp_r]
        segment_reduce(best, sp_r, cand, "min")
        if track_arg:
            hit = (best[sp_r] < prev) & (cand <= best[sp_r])
            first = torch.full((n,), _NO_ARG, dtype=torch.int32, device=dev)
            segment_reduce(first, sp_r, torch.where(
                hit, sp_c.to(torch.int32), _NO_ARG), "min")
            arg = torch.where(first < _NO_ARG, first, arg)
    return best, (arg if track_arg else None)


# -- K9: the Lipschitz reductions over the tiles -------------------------------

LIP_BIG = 3e38           # min / max identities of K9


def _tiles_lip_plain(band, plan: TilesPlan, U):
    """Plain twin of K9, in f32 (f64 for an f64 band): per row and class,
    the band-weighted sum of ``U`` over the row's tile cells, and the min
    and max of ``U`` over the cells with ``A > 0``."""
    acc = torch.float64 if band.dtype == torch.float64 else torch.float32
    dev = band.device
    R, WT = plan.R, plan.WT
    C = U.shape[1]
    nblocks = plan.n // R
    tb = plan.slab_block.long()
    starts = plan.slab_starts[:, 0].long()
    U = U.to(acc)
    sums = torch.zeros((nblocks, R, C), dtype=acc, device=dev)
    mins = torch.full((nblocks, R, C), LIP_BIG, dtype=acc, device=dev)
    maxs = torch.full((nblocks, R, C), -LIP_BIG, dtype=acc, device=dev)
    for g0, g1 in _tile_chunks(plan, R * WT * C):
        idx = starts[g0:g1, None] + torch.arange(WT, device=dev)
        Araw = band[g0 * R:g1 * R].reshape(g1 - g0, R, WT)
        Uw = U[idx]                                       # (g, WT, C)
        segment_reduce(sums, tb[g0:g1], torch.bmm(Araw.to(acc), Uw), "sum")
        has = (Araw > 0)[:, :, :, None]
        Ub = Uw[:, None, :, :]
        segment_reduce(mins, tb[g0:g1], torch.amin(
            torch.where(has, Ub, LIP_BIG), dim=2), "min")
        segment_reduce(maxs, tb[g0:g1], torch.amax(
            torch.where(has, Ub, -LIP_BIG), dim=2), "max")
    return (sums.reshape(plan.n, C), mins.reshape(plan.n, C),
            maxs.reshape(plan.n, C))


def band_tiles_lip(band, plan: TilesPlan, U, chunks=None):
    """K9: one pass of the Lipschitz-round reductions over the unpacked
    tiles.  ``U`` is ``(>= plan.x_rows, C)``, C <= 32 on CUDA.  Returns
    ``(sums, mins, maxs)``, each (plan.n, C) float32 (f64 for the CPU twin
    on an f64 band): the band-weighted neighbor sum, and the neighbor min
    and max (``LIP_BIG`` / ``-LIP_BIG`` where a row has no band edge).
    ``chunks``: the band's :func:`tiles_live_chunks`, built here when
    None.

    Replaces ``graphlearning_tpu/ops/pallas_spmm.py:902``
    ``band_tiles_lip`` (kernel ``_tiles_lip_kernel``, :861).  On the H100
    it is bound by the bytes of the band's live chunks at small C and by
    f32 instructions on the nonzero cells near C = 32 (a multiply-add and a
    compare pair per cell and class).  K7's walk: a warp owns 16 output
    rows and their live 16 x 32 chunks, two lanes a row, the next chunk's
    loads in flight while the current one is reduced, and the chunk's 32
    rows of ``U`` staged in shared memory by ``cp.async``, also one chunk
    ahead; a lane visits only its nonzero cells, reads their C values of
    ``U`` from the stage and keeps its row's C sums (exact f32 FFMA; a bf16
    band is widened on load), mins and maxes in registers; one shuffle
    combines the two lanes and each output is written once.  The min and max test ``A > 0`` on the stored value.
    ``U`` is not padded to the TPU's 128 lanes, and the three results are
    separate arrays, not one (n, 384) block.  R must be a multiple of 16
    and WT of 32; ``band`` and ``U`` must start on 16-byte boundaries."""
    if not isinstance(plan, TilesPlan):
        raise TypeError("band_tiles_lip takes a TilesPlan")
    if _dispatch_device("band_tiles_lip", band, U, plan.slab_starts) == "cpu":
        return _tiles_lip_plain(band, plan, U)
    dev = band.device
    name = "band_tiles_lip"
    _require_cuda(name, dev, band=band, U=U, tile_start=plan.slab_starts)
    _require(band.dtype in _CUDA_BAND_DTYPES and U.dtype == torch.float32,
             f"{name}: band must be float32 or bfloat16 and U float32 on "
             "CUDA")
    _require_tiles_band(name, band, plan)
    _require(U.dim() == 2 and 1 <= U.shape[1] <= 32
             and U.shape[0] >= plan.x_rows,
             f"{name}: U {tuple(U.shape)} must be (>= {plan.x_rows}, C) "
             "with 1 <= C <= 32")
    chunk_ptr, chunk_id = _chunk_launch_args(name, band, plan, chunks, U=U)
    C = U.shape[1]
    sums, mins, maxs = (torch.empty((plan.n, C), dtype=torch.float32,
                                    device=dev) for _ in range(3))
    lib = _build.load("band_tiles_lip")
    rc = lib.glt_tiles_lip(
        _ptr(band), int(band.dtype == torch.bfloat16), int(plan.R),
        int(plan.WT), _ptr(chunk_ptr), _ptr(chunk_id),
        _ptr(plan.slab_starts), int(plan.n // _LIVE_ROWS), _ptr(U), int(C),
        _ptr(sums), _ptr(mins), _ptr(maxs), _stream(band))
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    band_tiles_lip.launches += 1
    return sums, mins, maxs


band_tiles_lip.launches = 0


def residual_lip(U, resid, n: int):
    """Residual-edge contributions to the Lipschitz reductions: ``(sum_add,
    min_r, max_r)``, each (n, C), with identities 0 / ``LIP_BIG`` /
    ``-LIP_BIG`` (zero-valued slots are padding)."""
    urows, rcols, rvals, sp_r, sp_c, sp_v = resid
    C = U.shape[1]
    dev = U.device
    sum_add = torch.zeros((n, C), dtype=U.dtype, device=dev)
    min_r = torch.full((n, C), LIP_BIG, dtype=U.dtype, device=dev)
    max_r = torch.full((n, C), -LIP_BIG, dtype=U.dtype, device=dev)
    rvals, sp_v = rvals.to(U.dtype), sp_v.to(U.dtype)
    if rcols.shape[0]:
        un = U[rcols]                                     # (u, rb, C)
        valid = (rvals > 0)[:, :, None]
        segment_reduce(sum_add, urows, torch.einsum("ur,urc->uc", rvals, un),
                       "sum")
        segment_reduce(min_r, urows, torch.amin(
            torch.where(valid, un, LIP_BIG), dim=1), "min")
        segment_reduce(max_r, urows, torch.amax(
            torch.where(valid, un, -LIP_BIG), dim=1), "max")
    if sp_r.shape[0]:
        un = U[sp_c]                                      # (m, C)
        valid = (sp_v > 0)[:, None]
        segment_reduce(sum_add, sp_r,
                       torch.where(valid, sp_v[:, None] * un, 0.0), "sum")
        segment_reduce(min_r, sp_r, torch.where(valid, un, LIP_BIG), "min")
        segment_reduce(max_r, sp_r, torch.where(valid, un, -LIP_BIG), "max")
    return sum_add, min_r, max_r


# -- the rectangular route: K5, K6 and K8 ---------------------------------------


def _block_chunks(plan: _WindowPlan, per_block: int):
    """Row-block ranges ``[b0, b1)`` of a twin's chunks, at most
    ``_TWIN_CELLS`` elements each when a block costs ``per_block``."""
    nb = plan.n // plan.R
    step = max(1, _TWIN_CELLS // max(1, per_block))
    return [(b0, min(nb, b0 + step)) for b0 in range(0, nb, step)]


def _window_index(plan: _WindowPlan, b0: int, b1: int):
    """(b1 - b0, W) absolute columns of the windows of blocks b0..b1-1."""
    return (plan.winstart[b0:b1, None].long()
            + torch.arange(plan.W, device=plan.winstart.device))


def rect_live_chunks(band, plan: RectPlan):
    """The live-chunk list of a rectangular ``band``, which drives K5 and
    K8: for each group of ``_TILES_ROWS`` rows (one CTA), the
    ``_TILES_KC``-column chunks of its window that hold a nonzero cell,
    ascending.  Returns int32 ``(chunk_ptr, chunk_col)`` on the band's
    device: group ``i``'s chunks are ``chunk_col[chunk_ptr[i]:chunk_ptr[i
    + 1]]``.

    Built from the band the kernels read (K4's first ``kcap`` slots, in
    the band's dtype), never from the plan's ELL, so no cell is dropped; in
    pieces of row blocks, so no band-sized temporary is made.  A list
    belongs to the band it was built from: after the band changes, build
    it again."""
    _require(band.shape == (plan.n, plan.W),
             f"rect_live_chunks: band {tuple(band.shape)} does not match "
             f"the plan ({plan.n}, {plan.W})")
    rows, kc = _TILES_ROWS, _TILES_KC
    _require(plan.n % rows == 0 and plan.W % kc == 0,
             f"rect_live_chunks: rows {plan.n} must be a multiple of "
             f"{rows} and W={plan.W} of {kc}")
    live = [(band[b0 * plan.R:b1 * plan.R] != 0)
            .reshape(-1, rows, plan.W // kc, kc).any(dim=3).any(dim=1)
            for b0, b1 in _block_chunks(plan, plan.R * plan.W)]
    live = (torch.cat(live) if live else
            torch.zeros((0, plan.W // kc), dtype=torch.bool,
                        device=band.device))
    chunk_ptr = torch.zeros(plan.n // rows + 1, dtype=torch.int32,
                            device=band.device)
    torch.cumsum(live.sum(dim=1), 0, out=chunk_ptr[1:])
    chunk_col = live.nonzero()[:, 1].to(torch.int32)
    return chunk_ptr, chunk_col


def _require_tiles_band(name, band, plan: TilesPlan):
    G = plan.slab_block.shape[0]
    _require(band.dim() == 2 and band.shape == (G * plan.R, plan.WT),
             f"{name}: band {tuple(band.shape)} does not match the plan "
             f"({G * plan.R}, {plan.WT})")


def tiles_live_chunks(band, plan: TilesPlan):
    """The live-chunk list of the unpacked tiles ``band``, which drives K7
    and K9: for each group of ``_LIVE_ROWS`` output rows (one warp), the
    ``(_LIVE_ROWS, _LIVE_KC)`` chunks of its row block's tiles that hold a
    nonzero cell, by tile in plan order, then by column.  Returns int32
    ``(chunk_ptr, chunk_id)`` on the band's device: group ``i``'s chunks
    are ``chunk_id[chunk_ptr[i]:chunk_ptr[i + 1]]``, and chunk ``g * (WT //
    _LIVE_KC) + c`` is columns ``[c, c + 1) * _LIVE_KC`` of tile ``g``.

    Built from the band the kernels read (K1's tiles, in the band's dtype),
    never from the plan's ELL, so no cell is dropped; in pieces of tiles,
    so no band-sized temporary is made.  A list belongs to the band it was
    built from: after the band changes, build it again."""
    name = "tiles_live_chunks"
    _require_tiles_band(name, band, plan)
    rows, kc, R, WT = _LIVE_ROWS, _LIVE_KC, plan.R, plan.WT
    _require(R % rows == 0 and WT % kc == 0,
             f"{name}: R={R} must be a multiple of {rows} and WT={WT} of "
             f"{kc}")
    rg, cpt = R // rows, WT // kc
    dev = band.device
    hits = []                                  # (tile, row group, chunk)
    for g0, g1 in _tile_chunks(plan, R * WT):
        live = ((band[g0 * R:g1 * R] != 0)
                .reshape(g1 - g0, rg, rows, cpt, kc).any(dim=4).any(dim=2))
        hit = live.nonzero()
        hit[:, 0] += g0
        hits.append(hit)
    hit = (torch.cat(hits) if hits else
           torch.zeros((0, 3), dtype=torch.long, device=dev))
    group = plan.slab_block.long()[hit[:, 0]] * rg + hit[:, 1]
    chunk_id = hit[:, 0] * cpt + hit[:, 2]
    order = torch.argsort(group * (plan.slab_block.shape[0] * cpt)
                          + chunk_id)
    groups = plan.n // rows
    chunk_ptr = torch.zeros(groups + 1, dtype=torch.int32, device=dev)
    torch.cumsum(torch.bincount(group, minlength=groups), 0,
                 out=chunk_ptr[1:])
    return chunk_ptr, chunk_id[order].to(torch.int32)


def _chunk_launch_args(name, band, plan, chunks, **operands):
    """The checks of a launch driven by a live-chunk list (K5 and K8 on a
    ``RectPlan``'s band, K7 and K9 on a ``TilesPlan``'s): the geometry of
    the list's chunk; for a ``RectPlan`` the window starts on whole 16-byte
    pieces of X, d and f; ``band`` and the operands on 16-byte boundaries
    for the kernels' vector loads.  Returns the list, built from ``band``
    when ``chunks`` is None (the caller holds the tensors until the launch
    is enqueued), else ``chunks`` once :func:`_check_live_chunks` passes
    it."""
    if isinstance(plan, TilesPlan):
        rows, kc, width, build = _LIVE_ROWS, _LIVE_KC, plan.WT, \
            tiles_live_chunks
        what = f"WT={plan.WT}"
    else:
        rows, kc, width, build = _TILES_ROWS, _TILES_KC, plan.W, \
            rect_live_chunks
        what = f"W={plan.W}"
        _require(not (plan.winstart_host % _RECT_WIN_ALIGN).any(),
                 f"{name}: window starts must be multiples of "
                 f"{_RECT_WIN_ALIGN} (16-byte chunks of X, d and f)")
    _require(plan.R % rows == 0 and width % kc == 0,
             f"{name}: the kernel takes R a multiple of {rows} and {what} "
             f"a multiple of {kc}")
    for k, t in dict(operands, band=band).items():
        _require(t.data_ptr() % 16 == 0,
                 f"{name}: {k} must start on a 16-byte boundary")
    if chunks is None:
        return build(band, plan)
    chunk_ptr, chunk_id = chunks
    _require_cuda(name, band.device, chunk_ptr=chunk_ptr, chunk_id=chunk_id)
    _check_live_chunks(name, plan, chunk_ptr, chunk_id)
    return chunk_ptr, chunk_id


# chunk_id -> (chunk_ptr, plan geometry) of the lists that passed
# _check_live_chunks
_CHECKED_CHUNKS = WeakIdKeyDictionary()


def _check_live_chunks(name, plan, chunk_ptr, chunk_id):
    """Refuse a live-chunk list that would read out of bounds or out of
    order: int32, ``chunk_ptr`` of one entry a row group and one more,
    from 0 to ``chunk_id``'s length without falling, and each group's
    entries ascending within their range: the window's chunks ``[0, W //
    _TILES_KC)`` for a ``RectPlan`` (:func:`rect_live_chunks`), the chunks
    of the group's row block's tiles for a ``TilesPlan``
    (:func:`tiles_live_chunks`).  The values are checked on the host once
    per list (a list that passed is remembered by its tensors and the
    plan's geometry), so the launches after the first wait on nothing.
    Whether the list is that of the band's current cells is not
    checked."""
    tiles = isinstance(plan, TilesPlan)
    if tiles:
        rows, lister = _LIVE_ROWS, "tiles_live_chunks"
        token = ("tiles", plan.n, plan.R, plan.WT,
                 int(plan.slab_block.shape[0]))
    else:
        rows, lister = _TILES_ROWS, "rect_live_chunks"
        token = ("rect", plan.n, plan.W)
    seen = _CHECKED_CHUNKS.get(chunk_id)
    if seen is not None and seen[0] is chunk_ptr and seen[1] == token:
        return
    groups = plan.n // rows
    _require(chunk_ptr.dtype == torch.int32 and chunk_id.dtype == torch.int32
             and chunk_ptr.shape == (groups + 1,) and chunk_id.dim() == 1,
             f"{name}: chunks must be {lister}' int32 "
             f"(chunk_ptr ({groups + 1},), chunk_id)")
    ptr, ids = chunk_ptr.long(), chunk_id.long()
    _require(int(ptr[0]) == 0 and int(ptr[-1]) == ids.numel()
             and bool((ptr[1:] >= ptr[:-1]).all()),
             f"{name}: chunk_ptr must rise from 0 to the list's length "
             f"{ids.numel()}")
    group = torch.repeat_interleave(
        torch.arange(groups, device=ids.device), ptr[1:] - ptr[:-1],
        output_size=ids.numel())
    if tiles:
        cpt = plan.WT // _LIVE_KC
        block_ptr = plan.block_ptr.long().to(ids.device)
        blk = group * rows // plan.R
        lo, hi = block_ptr[blk] * cpt, block_ptr[blk + 1] * cpt
        span = "the chunks of its row block's tiles"
    else:
        lo, hi = 0, plan.W // _TILES_KC
        span = f"[0, {hi})"
    _require(ids.numel() == 0
             or (bool((ids >= lo).all()) and bool((ids < hi).all())
                 and bool(((ids[1:] > ids[:-1])
                           | (group[1:] != group[:-1])).all())),
             f"{name}: each group's chunks must ascend within {span}")
    _CHECKED_CHUNKS[chunk_id] = (chunk_ptr, token)


def _rect_spmm_plain(band, plan: RectPlan, X):
    """Plain twin of K5: each row block's (R, W) slice of the band times
    its X window.  Exact products in f32 (f64 for an f64 band) for an f32
    or a bf16 band."""
    acc = torch.float64 if band.dtype == torch.float64 else torch.float32
    R, W = plan.R, plan.W
    d = X.shape[1]
    X = X.to(acc)
    out = []
    for b0, b1 in _block_chunks(plan, R * W + W * d):
        A = band[b0 * R:b1 * R].to(acc).reshape(b1 - b0, R, W)
        out.append(torch.bmm(A, X[_window_index(plan, b0, b1)]))
    if not out:
        return torch.zeros((0, d), dtype=acc, device=band.device)
    return torch.cat(out).reshape(plan.n, d)


def band_spmm(band, plan: RectPlan, X, chunks=None):
    """K5: ``out = rectangular band @ X``, row block ``b`` against the X
    rows ``winstart[b] + [0, W)``; ``out`` is (plan.n, d) float32 (f64 for
    the CPU twin on an f64 band).  ``chunks``: the band's
    :func:`rect_live_chunks`, built here when None.

    Replaces ``graphlearning_tpu/ops/pallas_spmm.py:277`` ``band_spmm``
    (kernel ``_band_matmul_kernel``, :240).  On the H100 it is bound by the
    bytes of the band's live chunks: the band is about 0.3 % nonzero, and
    only its 64 x 64 chunks that hold a nonzero cell (16 % on the smoke's
    band) are read.  K2's tensor-core CTA with a second producer: 64 rows
    of one block a CTA, its live chunks and their X rows through the
    ``cp.async`` ring, bf16 ``mma.sync`` or 3xTF32 (FFMA for f32 at d <=
    ``_TILES_FMA_DMAX``), all-zero fragments skipped, one store per output (the TPU's zeroing step is implicit); d
    up to 128 a launch, wider X in 128-column launches.  Modes as K2: an
    f32 band with f32 X computes f32 to about 2^-21 (the TPU's f32 and
    bf16x3); a bf16 band with bf16 X multiplies exactly and sums in f32.
    R must be a multiple of 64, W of 64 and the window starts of 8;
    ``band`` and ``X`` must start on 16-byte boundaries."""
    if not isinstance(plan, RectPlan):
        raise TypeError("band_spmm takes a RectPlan")
    if _dispatch_device("band_spmm", band, X, plan.winstart) == "cpu":
        return _rect_spmm_plain(band, plan, X)
    dev = band.device
    name = "band_spmm"
    _require_cuda(name, dev, band=band, X=X, winstart=plan.winstart)
    _require(band.dtype in _CUDA_BAND_DTYPES and X.dtype == band.dtype,
             f"{name}: band {band.dtype} and X {X.dtype} must both be "
             "float32 or both bfloat16 on CUDA")
    _require(band.shape == (plan.n, plan.W),
             f"{name}: band {tuple(band.shape)} does not match the plan "
             f"({plan.n}, {plan.W})")
    _require(X.dim() == 2 and X.shape[1] >= 1 and X.shape[0] >= plan.x_rows,
             f"{name}: X {tuple(X.shape)} needs >= {plan.x_rows} rows")
    chunk_ptr, chunk_col = _chunk_launch_args(name, band, plan, chunks, X=X)
    d = X.shape[1]
    out = torch.empty((plan.n, d), dtype=torch.float32, device=dev)
    lib = _build.load("band_tiles_spmm")
    band_spmm.launches += _column_blocks(name, X, out, lambda Xc, o, dc: (
        lib.glt_rect_spmm(
            _ptr(band), int(band.dtype == torch.bfloat16), int(plan.W),
            int(plan.R), _ptr(plan.winstart), _ptr(chunk_ptr),
            _ptr(chunk_col), int(plan.n // plan.R), _ptr(Xc), dc, o, int(d),
            _stream(band))))
    return out


band_spmm.launches = 0


def _banded_spmm_plain(cols, vals, plan: BandedPlan, X):
    """Plain twin of K6: each row's in-window slots times the X rows they
    name, summed in f32 (f64 for f64 values)."""
    acc = torch.float64 if vals.dtype == torch.float64 else torch.float32
    lo = torch.repeat_interleave(plan.winstart.long(), plan.R)[:, None]
    c = cols.long()
    w = torch.where((c >= lo) & (c < lo + plan.W), vals.to(acc), 0.0)
    return torch.einsum("nk,nkd->nd", w, X.to(acc)[c])


def banded_spmm(cols, vals, plan: BandedPlan, X):
    """K6: the rectangular band's product with no stored band: ``out[i] =
    sum_j vals[i, j] X[cols[i, j]]`` over the slots whose column lies in
    row ``i``'s window ``winstart[i // R] + [0, W)``.  ``cols``/``vals``
    are the first ``kcap`` ELL slots, ``(n, kcap)``; ``out`` is (plan.n,
    d) float32 (f64 for the CPU twin on f64 values).

    Replaces ``graphlearning_tpu/ops/pallas_spmm.py:109`` ``banded_spmm``
    (kernel ``_banded_kernel``, :53).  On the H100 it is bound by bytes:
    the slots read once and ``out`` written once, with X's rows through
    L2.  The TPU kernel rebuilt a dense (R, WT) block per window tile by k
    compare/select passes for its matrix unit (work n * W * k); here one
    thread owns one (row, column of d) and sums the row's in-window slots
    in slot order with FFMA (work n * k * d, whatever the window's
    width).  Modes: f32 values with f32 X (the TPU's f32 and bf16x3), or
    bf16 values with bf16 X, products exact in f32 and f32 sums."""
    if not isinstance(plan, BandedPlan):
        raise TypeError("banded_spmm takes a BandedPlan")
    if _dispatch_device("banded_spmm", cols, vals, X, plan.winstart) == "cpu":
        return _banded_spmm_plain(cols, vals, plan, X)
    dev = cols.device
    name = "banded_spmm"
    _require_cuda(name, dev, cols=cols, vals=vals, X=X,
                  winstart=plan.winstart)
    _require(cols.dtype == torch.int32, f"{name}: cols must be int32")
    _require(vals.dtype in _CUDA_BAND_DTYPES and X.dtype == vals.dtype,
             f"{name}: vals {vals.dtype} and X {X.dtype} must both be "
             "float32 or both bfloat16 on CUDA")
    _require(cols.dim() == 2 and cols.shape == vals.shape
             and cols.shape[0] == plan.n,
             f"{name}: cols {tuple(cols.shape)} / vals "
             f"{tuple(vals.shape)} must be ({plan.n}, k)")
    _require(X.dim() == 2 and X.shape[1] >= 1 and X.shape[0] >= plan.x_rows,
             f"{name}: X {tuple(X.shape)} needs >= {plan.x_rows} rows")
    out = torch.empty((plan.n, X.shape[1]), dtype=torch.float32, device=dev)
    lib = _build.load("band_ell_spmm")
    rc = lib.glt_ell_spmm(
        _ptr(cols), _ptr(vals), int(vals.dtype == torch.bfloat16),
        int(cols.shape[1]), _ptr(plan.winstart), int(plan.n), int(plan.R),
        int(plan.W), _ptr(X), int(X.shape[1]), _ptr(out), _stream(cols))
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    banded_spmm.launches += 1
    return out


banded_spmm.launches = 0


def _rect_minplus_plain(band, plan: RectPlan, d, f, hopf_lax: bool,
                        track_arg: bool, recip: bool):
    """Plain twin of K8, in f32 (f64 for an f64 band): per row the least
    candidate over its window's cells, ``MINPLUS_BIG`` where none is
    smaller; with ``track_arg`` the smallest column among the least
    candidates, else -1."""
    acc = torch.float64 if band.dtype == torch.float64 else torch.float32
    R, W = plan.R, plan.W
    d, f = d.to(acc), f.to(acc)
    ms, args = [], []
    for b0, b1 in _block_chunks(plan, R * W):
        idx = _window_index(plan, b0, b1)
        A = band[b0 * R:b1 * R].to(acc).reshape(b1 - b0, R, W)
        cand = _minplus_cand(A, d[idx][:, None, :], f[idx][:, None, :],
                             hopf_lax, recip)
        m = torch.amin(cand, dim=2)
        ms.append(m)
        if track_arg:
            hit = cand == m[:, :, None]
            a = torch.amin(torch.where(hit, idx[:, None, :].to(torch.int32),
                                       _NO_ARG), dim=2)
            args.append(torch.where(m < MINPLUS_BIG, a, -1))
    dev = band.device
    if not ms:
        return (torch.zeros((0,), dtype=acc, device=dev),
                torch.zeros((0,), dtype=torch.int32, device=dev)
                if track_arg else None)
    m = torch.cat(ms).reshape(-1)
    return m, (torch.cat(args).reshape(-1) if track_arg else None)


def band_minplus(band, plan: RectPlan, d, f, hopf_lax: bool = False,
                 track_arg: bool = False, recip: bool = False, chunks=None):
    """K8: one min-plus relaxation round over the rectangular band: per row
    the least of ``d[c] + A f[c]`` (or the Hopf-Lax ``(f A + sqrt((f A)^2
    + 4 d[c]^2)) / 2``) over its window's cells ``c`` with ``A > 0``;
    ``recip`` uses ``1/A`` for ``A``.  Returns ``(min, arg)``: ``min``
    (plan.n,) float32 (f64 for the CPU twin on an f64 band),
    ``MINPLUS_BIG`` where no candidate is smaller; ``arg`` (plan.n,) int32,
    the smallest column among the least candidates, or -1, and None
    without ``track_arg``.  ``chunks``: the band's
    :func:`rect_live_chunks`, built here when None.

    Replaces ``graphlearning_tpu/ops/pallas_spmm.py:369`` ``band_minplus``
    (kernel ``_band_minplus_kernel``, :320).  On the H100 it is bound by
    the bytes of the band's live chunks (a few flops per cell); a skipped
    chunk holds no edge, so no candidate.  One CTA of 8 warps owns 64 rows
    of one block and walks their live 64-column chunks, ascending, through
    a 4-stage ``cp.async`` ring of the chunk's cells as stored and its
    ``d`` and ``f``; a lane keeps each of its warp's 8 rows' least
    candidate and its column over its two columns of every chunk, and one
    shuffle reduction a row at the end takes the least, the smaller column
    on ties: the column JAX's smallest lane and strict ``<`` across tiles
    give.  The candidates use the same f32 operations as the twin, rounded
    to nearest without contraction, so the two agree exactly.  The argmin
    comes back as int32, not the TPU's float-coded lane, and the output is
    (n,), not the TPU's 128 lanes.  R must be a multiple of 64, W of 64 and
    the window starts of 8; ``band``, ``d`` and ``f`` must start on 16-byte
    boundaries."""
    if not isinstance(plan, RectPlan):
        raise TypeError("band_minplus takes a RectPlan")
    if _dispatch_device("band_minplus", band, d, f, plan.winstart) == "cpu":
        return _rect_minplus_plain(band, plan, d, f, hopf_lax, track_arg,
                                   recip)
    dev = band.device
    name = "band_minplus"
    _require_cuda(name, dev, band=band, d=d, f=f, winstart=plan.winstart)
    _require(band.dtype in _CUDA_BAND_DTYPES,
             f"{name}: band must be float32 or bfloat16 on CUDA")
    _require(d.dtype == torch.float32 and f.dtype == torch.float32,
             f"{name}: d and f must be float32 on CUDA")
    _require(band.shape == (plan.n, plan.W),
             f"{name}: band {tuple(band.shape)} does not match the plan "
             f"({plan.n}, {plan.W})")
    _require(d.dim() == 1 and d.shape == f.shape
             and d.shape[0] >= plan.x_rows,
             f"{name}: d and f must be (>= {plan.x_rows},)")
    chunk_ptr, chunk_col = _chunk_launch_args(name, band, plan, chunks, d=d,
                                              f=f)
    out = torch.empty((plan.n,), dtype=torch.float32, device=dev)
    arg = (torch.empty((plan.n,), dtype=torch.int32, device=dev)
           if track_arg else None)
    lib = _build.load("band_rect_minplus")
    rc = lib.glt_rect_minplus(
        _ptr(band), int(band.dtype == torch.bfloat16), int(plan.W),
        int(plan.R), _ptr(plan.winstart), _ptr(chunk_ptr), _ptr(chunk_col),
        int(plan.n // plan.R), _ptr(d), _ptr(f), _ptr(out),
        _ptr(arg) if track_arg else ctypes.c_void_p(0), int(hopf_lax),
        int(recip), int(track_arg), _stream(band))
    if rc:
        raise RuntimeError(f"{name}: CUDA error {rc}")
    band_minplus.launches += 1
    return out, arg


band_minplus.launches = 0


# name -> wrapper, for launch accounting
KERNELS = {
    "materialize_band_tiles": materialize_band_tiles,
    "band_tiles_spmm_packed": band_tiles_spmm_packed,
    "band_tiles_spmm": band_tiles_spmm,
    "materialize_band": materialize_band,
    "band_tiles_minplus": band_tiles_minplus,
    "band_tiles_lip": band_tiles_lip,
    "band_spmm": band_spmm,
    "banded_spmm": banded_spmm,
    "band_minplus": band_minplus,
    "band_tiles_spmm_packed_rowq": band_tiles_spmm_packed_rowq,
    "band_tiles_spmm_packed_i8": band_tiles_spmm_packed_i8,
}


def reset_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
        if hasattr(fn, "bf16_launches"):
            fn.bf16_launches = 0
        if hasattr(fn, "launches_by_d"):
            fn.launches_by_d = {}


def launches() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}
