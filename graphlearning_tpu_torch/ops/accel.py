"""Band-accelerated SpMM context for the iterative solvers.

Counterpart of ``graphlearning_tpu/ops/accel.py``.  :class:`AccelSpMM`
reorders a symmetric graph once on the host (RCM, a space-filling curve on
the point coordinates, or a cluster ordering: whichever its cost model
prefers), plans the compact tiled band, and exposes ``spmm`` in the
permuted, padded space plus the ``to_perm`` / ``from_perm`` index maps.
The solvers run entirely in permuted space.

The matvec plan is explicit, one of four, and dispatch goes by its type.
On the tiled band (intended unless ``materialize=False``, ``GLT_NO_BAND``
is set, or the graph is over the size gate, as in the JAX package):

* a :class:`~band_spmm.PackedPlan` (kernel K2, the default) or a
  :class:`~band_spmm.TilesPlan` (kernel K3, taken when the packed plan is
  switched off by ``GLT_NO_PACKED`` or does not fit the band budget); the
  band is built once by K1.

Off it, on the rectangular route (RCM order only, the JAX package's
non-band geometry):

* a :class:`~band_spmm.RectPlan` with ``materialize=True``: the stored
  ``(n_pad, Wr)`` band, built by K4, the matvec K5 on the band's live
  chunks (:meth:`AccelSpMM.live_chunks`);
* a :class:`~band_spmm.BandedPlan` otherwise: no stored band, the matvec
  K6 straight from the ELL slots.

The distance and Lipschitz solvers stream other layouts:

* :meth:`AccelSpMM.bellman_ford` K8 over a ``RectPlan``'s band, else K7
  over the unpacked tiles band, which K1 builds lazily from the
  :class:`~band_spmm.TilesPlan` when the matvec plan is packed, both on
  the band's live chunks; a ``BandedPlan`` has none (``materialize`` is
  False) and the solvers take the plain path;
* :meth:`AccelSpMM.lip_iterate_mc` (K9) the unpacked tiles band only, on
  its live chunks;
* :meth:`AccelSpMM.lip_gs_mc` the rectangular ``(n_pad, Wr)`` band of the
  ``plan_banded`` plan, which K4 builds lazily (a ``RectPlan``'s own band).

Off the band, :func:`maybe_build` takes the segmented gather
(:class:`~graphlearning_tpu_torch.ops.gather.GatherAccel`) where the JAX
package does: a band-hostile graph, a band over the budget, or a band its
cost model rejects.

Departures from the JAX package:

* Failures are not swallowed: only :class:`BandPlanUnavailable` leads to
  the gather, and a plan that cannot be used is reported.
* One band budget covers every band resident together: the packed and the
  unpacked tiles, and in :meth:`AccelSpMM.rect_band_ok` the rectangular
  band beside them (JAX budgets each band on its own).  A ``RectPlan``
  whose band is over the budget raises :class:`BandPlanUnavailable`; JAX
  allocates it all the same.
* The JAX modes f32 and bf16x3 are both exact f32 here (FFMA); ``bf16``
  keeps a bf16 band and bf16 X with f32 sums.

``GLT_NO_ACCEL=1`` keeps every fit on the plain path, as in the JAX
package.
"""

from __future__ import annotations

import logging
import os
import warnings

import numpy as np
import scipy.sparse as sp
import torch
from torch.utils.weak import WeakIdKeyDictionary

from graphlearning_tpu_torch import config
from graphlearning_tpu_torch import observability as _obs
from graphlearning_tpu_torch.core.sparse import SparseGraph
from graphlearning_tpu_torch.ops import band_spmm as _bs
from graphlearning_tpu_torch.ops.gather import GatherAccel
from graphlearning_tpu_torch.ops.solver_entries import SpmmSolvers
from graphlearning_tpu_torch.solvers.eikonal import _fixed_point
from graphlearning_tpu_torch.solvers.plaplace import _lip_loop

log = logging.getLogger(__name__)

_MIN_N = 4096
_KCAP_MAX = 32          # ELL slots the band covers (hub tails -> residual)

# Geometry carried over from the JAX package until it is tuned on the H100:
# the unpacked tiles of its exact band configuration and its packed slabs.
_TILES_R, _TILES_WT = 512, 1024
_PACKED_R, _PACKED_WT, _PACKED_S = 256, 128, 12
_MAX_RESIDUAL = 0.002
# PLACEHOLDERS until the torch bench (P8) tunes them on the H100: the
# geometry of the rectangular route, the JAX package's non-band defaults
# (its _tuned_defaults(exact, band=False) and best_exact of
# scripts/spmm_tuned.json).
_RECT_R, _RECT_WT = 256, 512
_RECT_MAX_RESIDUAL = 0.05

# Cost model.  _HBM_BPS is the H100 SXM device memory rate (NVIDIA H100
# data sheet).  The rest are PLACEHOLDERS carried over from the JAX
# package's calibration on another device, kept until the torch bench (P8)
# calibrates them on the H100: the per-edge cost of the XLA-style gather
# and of a residual edge, and the X width the ordering cost assumes.
_HBM_BPS = 3.35e12
_GATHER_NS = 30e-9
_RESID_NS = 40e-9
_D_EST = 128


def _band_budget_bytes(device) -> float:
    """Memory budget for the stored bands, packed and unpacked together: a
    quarter of the card's memory on CUDA, the JAX package's 6 GB default
    on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory / 4
    return 6e9


class BandPlanUnavailable(ValueError):
    """The band the plan would store does not fit the band budget."""


def enabled(device) -> bool:
    """The band path applies to graphs on a CUDA device."""
    return (torch.device(device).type == "cuda"
            and not os.environ.get("GLT_NO_ACCEL"))


def hilbert_order_2d(pts, bits: int = 16):
    """Hilbert curve ordering of 2-D points (Skilling's algorithm,
    vectorized): per-row neighbor locality for planar kNN graphs."""
    pts = np.asarray(pts, dtype=np.float64)
    lo = pts.min(0)
    scale = pts.max(0) - lo
    scale[scale == 0] = 1.0
    q = np.clip(((pts - lo) / scale * ((1 << bits) - 1)).astype(np.int64),
                0, (1 << bits) - 1)
    x, y = q[:, 0].copy(), q[:, 1].copy()
    d = np.zeros_like(x)
    s = 1 << (bits - 1)
    while s > 0:
        rx = ((x & s) > 0).astype(np.int64)
        ry = ((y & s) > 0).astype(np.int64)
        d += s * s * ((3 * rx) ^ ry)
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f = np.where(flip, s - 1 - x, x)
        y_f = np.where(flip, s - 1 - y, y)
        x, y = np.where(swap, y_f, x_f), np.where(swap, x_f, y_f)
        s //= 2
    return np.argsort(d, kind="stable")


def morton_order_3d(pts, bits: int = 20):
    """Morton (z-order) ordering of 3-D points."""
    pts = np.asarray(pts, dtype=np.float64)
    lo = pts.min(0)
    scale = pts.max(0) - lo
    scale[scale == 0] = 1.0
    q = np.clip(((pts - lo) / scale * ((1 << bits) - 1)).astype(np.int64),
                0, (1 << bits) - 1)

    def spread3(v):
        v &= 0xFFFFF
        v = (v | (v << 32)) & 0x1F00000000FFFF
        v = (v | (v << 16)) & 0x1F0000FF0000FF
        v = (v | (v << 8)) & 0x100F00F00F00F00F
        v = (v | (v << 4)) & 0x10C30C30C30C30C3
        v = (v | (v << 2)) & 0x1249249249249249
        return v

    key = (spread3(q[:, 0]) | (spread3(q[:, 1]) << 1)
           | (spread3(q[:, 2]) << 2))
    return np.argsort(key, kind="stable")


def _cluster_order(W, R: int, inv_rcm, seed: int = 0):
    """Cluster-aligned ordering for graphs RCM cannot band: diffusion
    embedding, k-means, greedy centroid chain, clusters padded to R-row
    boundaries.  Returns ``(order, pos, n_pad)``: original node
    ``order[i]`` sits at padded row ``pos[i]``."""
    n = W.shape[0]
    rs = np.random.RandomState(seed)
    deg = np.asarray(W.sum(1)).ravel()
    P = sp.diags(1.0 / np.maximum(deg, 1e-12)) @ W
    m = 8
    Y = rs.randn(n, m)
    for i in range(12):
        Y = P @ Y
        if i % 4 == 3:
            Y = np.linalg.qr(Y)[0]
    Y = np.linalg.qr(Y)[0]

    S = int(max(2, min(256, n // 2048)))
    cent = Y[rs.choice(n, S, replace=False)]
    for _ in range(10):
        d2 = ((Y * Y).sum(1)[:, None] - 2.0 * Y @ cent.T
              + (cent * cent).sum(1)[None, :])
        a = d2.argmin(1)
        cnt = np.bincount(a, minlength=S).astype(np.float64)
        cent = np.stack(
            [np.bincount(a, weights=Y[:, j], minlength=S) for j in range(m)],
            axis=1) / np.maximum(cnt, 1.0)[:, None]

    cd = ((cent[:, None, :] - cent[None, :, :]) ** 2).sum(-1)
    chain = [0]
    left = set(range(1, S))
    while left:
        last = chain[-1]
        nxt = min(left, key=lambda j: cd[last, j])
        chain.append(nxt)
        left.remove(nxt)
    rank = np.empty(S, np.int64)
    rank[np.asarray(chain)] = np.arange(S)
    cl = rank[a]

    order = np.lexsort((inv_rcm, cl))         # cluster-major, RCM within
    sizes = np.bincount(cl, minlength=S)
    pos = np.zeros(n, np.int64)
    off = 0
    start = 0
    for c in range(S):
        sz = int(sizes[c])
        pos[start:start + sz] = off + np.arange(sz)
        off += ((sz + R - 1) // R) * R
        start += sz
    return order, pos, int(off)


def _min_edges_per_tile(R: int, WT: int) -> int:
    """Keep a tile when streaming it costs less than gathering its edges."""
    return max(8, int(R * WT * 4 / _HBM_BPS / _RESID_NS))


class AccelSpMM(SpmmSolvers):
    """Band SpMM in permuted, padded space for one symmetric graph.

    ``mode``: "f32" (exact f32) or "bf16" (bf16 band and X, f32 sums).
    ``packed``: use the packed-slab plan (K2); None reads
    ``GLT_NO_PACKED``.  ``materialize``, as in the JAX package: the tiled
    band is intended unless it is False, ``GLT_NO_BAND`` is set or the
    graph is over the size gate (``n * 5120 * 4`` bytes over the budget);
    off the tiled band, True stores the rectangular band
    (:class:`~band_spmm.RectPlan`) and None or False stores none
    (:class:`~band_spmm.BandedPlan`).  Raises
    :class:`BandPlanUnavailable` when the stored band does not fit the
    budget."""

    def __init__(self, W, mode: str = "f32", packed: bool | None = None,
                 device=None, materialize: bool | None = None):
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        if mode not in ("f32", "bf16"):
            raise ValueError(f"mode must be 'f32' or 'bf16', not {mode!r}")
        dev = config.device(device)
        self.device = dev
        self.mode = mode
        if packed is None:
            packed = not os.environ.get("GLT_NO_PACKED")
        self._val_dtype = config.float_dtype(dev)
        self.band_dtype = (torch.bfloat16 if mode == "bf16"
                            else self._val_dtype)
        bytes_per = torch.finfo(self.band_dtype).bits // 8

        # point coordinates attached by weightmatrix.knn (read before the
        # csr copy drops instance attributes)
        pts = getattr(W, "_glt_points", None)
        W = sp.csr_matrix(W)
        n = W.shape[0]
        self.n = n
        self.nnz = int(W.nnz)
        budget = _band_budget_bytes(dev)
        self._budget = budget
        band_intent = (materialize is not False
                       and not os.environ.get("GLT_NO_BAND")
                       and n * 5120 * 4 <= budget)
        if band_intent:
            self.R, self.WT, max_residual = _TILES_R, _TILES_WT, _MAX_RESIDUAL
        else:
            self.R, self.WT = _RECT_R, _RECT_WT
            max_residual = _RECT_MAX_RESIDUAL
        block = max(self.R, self.WT)
        perm_rcm = np.asarray(reverse_cuthill_mckee(W, symmetric_mode=True))
        inv_rcm = np.argsort(perm_rcm)

        def assemble(order, pos, n_raw):
            """Padded permuted ELL (host) + rectangular plan + the cost of
            streaming its occupied tiles (the tiled band only)."""
            n_pad = ((n_raw + block - 1) // block) * block
            Psel = sp.csr_matrix((np.ones(n), (pos, order)), shape=(n_pad, n))
            Wp = (Psel @ W @ Psel.T).tocsr()
            cols_np, vals_np, deg_np = SparseGraph.ell_from_scipy(Wp)
            if band_intent or materialize:
                # a stored band streams n_pad * WT more cells for each WT
                # of window: grow it while a WT absorbs more residual
                # edges than that stream costs
                gain = int(n_pad * self.WT * 4 / _HBM_BPS / _RESID_NS)
            else:
                # K6 reads each row's kcap slots once, whatever the window,
                # and X through L2: one more WT of window moves no more
                # device-memory bytes, so it costs nothing to weigh
                # against the residual edges it absorbs.  The window grows
                # until the residual is under max_residual.
                gain = 0
            plan = _bs.plan_banded(
                cols_np, R=self.R, WT=self.WT, max_residual=max_residual,
                deg=deg_np, kcap_max=_KCAP_MAX, gain_per_tile=gain)
            cost = 0.0
            if band_intent:
                coo = Wp.tocoo()
                _, counts = np.unique(
                    (coo.row // self.R).astype(np.int64)
                    * (n_pad // self.WT + 1) + coo.col // self.WT,
                    return_counts=True)
                tile_c = (self.R * self.WT * bytes_per
                          + self.WT * _D_EST * 4) / _HBM_BPS
                cost = float(np.minimum(tile_c, counts * _RESID_NS).sum())
            return (cols_np, vals_np, deg_np), plan, n_pad, cost

        order, pos = perm_rcm, np.arange(n)
        cand = assemble(order, pos, n)
        # off the tiled band only RCM is tried, as in the JAX package
        if (band_intent and pts is not None and np.ndim(pts) == 2
                and pts.shape[0] == n and pts.shape[1] in (2, 3)
                and n >= 8192):
            order_h = (hilbert_order_2d(pts) if pts.shape[1] == 2
                       else morton_order_3d(pts))
            cand_h = assemble(order_h, np.arange(n), n)
            if cand_h[3] < cand[3]:
                cand, order = cand_h, order_h
        if (band_intent and n >= 8192
                and len(cand[1][1]) / max(1, self.nnz) > 0.02):
            order2, pos2, n_raw2 = _cluster_order(W, self.R, inv_rcm)
            cand2 = assemble(order2, pos2, n_raw2)
            if cand2[3] < cand[3]:
                cand, order, pos = cand2, order2, pos2
        (cols_np, vals_np, deg_np), rect_plan, self.n_pad, _ = cand
        self.g = SparseGraph.from_ell_np(cols_np, vals_np, deg_np,
                                         dtype=self._val_dtype, device=dev)
        vals_host = vals_np.astype(np.float64 if self._val_dtype
                                   == torch.float64 else np.float32)
        # the rectangular plan (winstart, rrows, rslots, Wr, kcap): the
        # block-Gauss-Seidel sweeps' band beside the tiles, the matvec
        # plan off them; and its residual edges
        self._rect_plan = rect_plan
        self._rect_resid_host = _bs.build_residual_ell(
            rect_plan[1], rect_plan[2], cols_np, vals_host, self.n_pad)
        self._rect = None
        self._band = None
        self._tiles_band = None
        self._chunks = WeakIdKeyDictionary()   # band -> its live-chunk list
        self._ell = None
        if band_intent:
            self._plan_tiles(cols_np, deg_np, vals_host, bytes_per, packed)
        else:
            self._plan_window(materialize)
        self.materialize = not isinstance(self.plan, _bs.BandedPlan)

        # original node order[i] lives at padded row pos[i]
        perm_ext = np.full(self.n_pad, -1, np.int64)
        perm_ext[pos] = order
        pos_of = np.empty(n, np.int64)
        pos_of[order] = pos
        self._perm_dev = torch.as_tensor(perm_ext, device=dev)
        self._inv_dev = torch.as_tensor(pos_of, device=dev)

    def _plan_window(self, materialize):
        """The rectangular route: a :class:`~band_spmm.RectPlan` (K4 band,
        K5, K8) with ``materialize``, else a :class:`~band_spmm.BandedPlan`
        (K6)."""
        winstart, rrows, _, Wr, kcap = self._rect_plan
        resid = _bs.residual_to_device(self._rect_resid_host, self.device,
                                       self._val_dtype)
        cls = _bs.RectPlan if materialize else _bs.BandedPlan
        self.plan = cls.from_numpy(winstart, self.n_pad, self.R, self.WT, Wr,
                                   kcap, self.device, resid=resid)
        self._resid = resid
        self.n_resid = len(rrows)
        self.tiles_plan = self._tiles_resid = None
        self._build_args = self._tiles_build_args = None
        self.band_bytes = self.matvec_band_bytes = (
            self.rect_band_bytes() if materialize else 0)
        if self.band_bytes > self._budget:
            # the JAX package allocates it all the same
            raise BandPlanUnavailable(
                f"rectangular band of {self.band_bytes:.3g} B (n_pad="
                f"{self.n_pad}, W={Wr}) exceeds the band budget of "
                f"{self._budget:.3g} B")

    def _plan_tiles(self, cols_np, deg_np, vals_host, bytes_per, packed):
        """The tiled band: the packed slabs (K2) or the unpacked tiles
        (K3) for the matvec, the unpacked tiles for the distance and
        Lipschitz kernels, one budget for all of them."""
        dev, budget = self.device, self._budget
        tb, ts, _, rrows, rslots, kcap = _bs.plan_tiles(
            cols_np, R=self.R, WT=self.WT, deg=deg_np, kcap_max=_KCAP_MAX,
            min_edges_per_tile=_min_edges_per_tile(self.R, self.WT),
            hbm_budget_bytes=budget)
        tiles_bytes = len(tb) * self.R * self.WT * bytes_per
        if tiles_bytes > budget:
            raise BandPlanUnavailable(
                f"tiled band of {tiles_bytes:.3g} B exceeds the budget of "
                f"{budget:.3g} B; the JAX package would take the "
                "rectangular band matvec (K5), not ported")
        # steady-state cost inputs of maybe_build (the unpacked band)
        self.band_bytes = tiles_bytes
        self.n_resid = len(rrows)
        # the unpacked tiles of the distance and Lipschitz kernels
        self.tiles_plan = _bs.TilesPlan.from_tiles(tb, ts, self.n_pad, self.R,
                                                   self.WT, dev)
        self._tiles_build_args = (tb, ts, kcap, self.R, self.WT, None)
        self._tiles_resid = _bs.residual_to_device(
            _bs.build_residual_ell(rrows, rslots, cols_np, vals_host,
                                   self.n_pad),
            dev, self._val_dtype)
        self._tiles_band = None
        self.matvec_band_bytes = tiles_bytes

        self.plan = None
        pR, pWT, pS = _PACKED_R, _PACKED_WT, _PACKED_S
        if packed and (self.n_pad % pR or self.n_pad % pWT):
            warnings.warn(
                f"n_pad={self.n_pad} is not a multiple of the packed "
                f"geometry ({pR}, {pWT}): using the unpacked tiles (K3)",
                RuntimeWarning, stacklevel=2)
            packed = False
        if packed:
            ptb, pts_, pbf, prr, prs, pkcap = _bs.plan_tiles(
                cols_np, R=pR, WT=pWT, deg=deg_np, kcap_max=_KCAP_MAX,
                min_edges_per_tile=_min_edges_per_tile(pR, pWT),
                hbm_budget_bytes=budget)
            psb, psts, _, psrc = _bs.pack_tiles(ptb, pts_, pbf, pS)
            pbytes = len(psb) * pR * pS * pWT * bytes_per
            if tiles_bytes + pbytes <= budget:
                self.plan = _bs.PackedPlan.from_slabs(
                    psb, psts, psrc, self.n_pad, pR, pWT, dev)
                self._build_args = (ptb, pts_, pkcap, pR, pWT, psrc)
                self._resid = _bs.residual_to_device(
                    _bs.build_residual_ell(prr, prs, cols_np, vals_host,
                                           self.n_pad),
                    dev, self._val_dtype)
                self.matvec_band_bytes = pbytes
            else:
                warnings.warn(
                    f"packed band ({pbytes:.3g} B) and unpacked band "
                    f"({tiles_bytes:.3g} B) exceed the band budget of "
                    f"{budget:.3g} B together: using the "
                    "unpacked tiles (K3)", RuntimeWarning, stacklevel=2)
        if self.plan is None:
            self.plan = self.tiles_plan
            self._build_args = self._tiles_build_args
            self._resid = self._tiles_resid

    @property
    def packed(self) -> bool:
        return isinstance(self.plan, _bs.PackedPlan)

    def band_inputs(self, tiles: bool = False):
        """K1's arguments for the matvec plan's tiles (the unpacked tiles
        of the distance kernels with ``tiles``):
        ``(cols, vals, tile_block, tile_start, R, WT)``."""
        if self.tiles_plan is None:
            raise ValueError(f"a {type(self.plan).__name__} has no tiles")
        tb, ts, kcap, R, WT, _ = (self._tiles_build_args if tiles
                                  else self._build_args)
        dev = self.device
        return (self.g.cols[:, :kcap].contiguous(),
                self.g.vals[:, :kcap].contiguous(),
                torch.as_tensor(tb, device=dev),
                torch.as_tensor(ts, device=dev), R, WT)

    def build_band(self, dtype, tiles: bool = False):
        """The band of the matvec plan (the unpacked tiles with ``tiles``)
        in ``dtype``: K4 for a rectangular plan; K1, then the re-layout into
        slabs for the packed plan."""
        plan = self.plan
        if not tiles and isinstance(plan, _bs.BandedPlan):
            raise ValueError("a BandedPlan stores no band")
        if not tiles and isinstance(plan, _bs.RectPlan):
            return _bs.materialize_band(
                self.g.cols[:, :plan.kcap].contiguous(),
                self.g.vals[:, :plan.kcap].contiguous(), plan.winstart,
                plan.W, R=plan.R, WT=plan.WT, out_dtype=dtype)
        cols, vals, tb, ts, R, WT = self.band_inputs(tiles)
        band = _bs.materialize_band_tiles(cols, vals, tb, ts, R=R, WT=WT,
                                          out_dtype=dtype)
        src = None if tiles else self._build_args[5]
        return band if src is None else _bs.pack_band(band, src, R=R, WT=WT)

    def band(self):
        """The stored band of the matvec plan, built on first use."""
        if self._band is None:
            self._band = self.build_band(self.band_dtype)
        return self._band

    def live_chunks(self, band):
        """The live-chunk list of ``band``: for a ``RectPlan``, its
        rectangular band (:meth:`band` or :meth:`build_band`), the list of
        K5 and K8 (:func:`~band_spmm.rect_live_chunks`); else the unpacked
        tiles band (:meth:`tiles_band`, or :meth:`build_band` with
        ``tiles``), the list of K7 and K9
        (:func:`~band_spmm.tiles_live_chunks`).  Built on first use and kept
        beside that band tensor, keyed by the tensor itself, so a band
        built anew gets its own list.  An edit of the band in place leaves
        its list stale (a cell made nonzero in a chunk not listed is never
        read): build the band anew instead."""
        chunks = self._chunks.get(band)
        if chunks is None:
            if isinstance(self.plan, _bs.RectPlan):
                chunks = _bs.rect_live_chunks(band, self.plan)
            elif self.tiles_plan is not None:
                chunks = _bs.tiles_live_chunks(band, self.tiles_plan)
            else:
                raise ValueError(f"a {type(self.plan).__name__} stores no "
                                 "band")
            self._chunks[band] = chunks
        return chunks

    def packed_band(self):
        """The band of the packed plan (K2), built on first use.  It is
        the port's own slab layout (:func:`~band_spmm.pack_band`): the
        slabs of the packed geometry, with no padding of d to the TPU's
        128 lanes.  Raises when the matvec plan is not packed
        (``GLT_NO_PACKED``, or the packed band over the budget)."""
        if not self.packed:
            raise ValueError(f"a {type(self.plan).__name__} has no packed "
                             "band")
        return self.band()

    def tiles_band(self):
        """The unpacked tiles band of the distance and Lipschitz kernels:
        the matvec band itself under the unpacked plan, else built by K1 on
        first use (the budget admitted both at planning)."""
        if self.tiles_plan is None:
            raise ValueError(f"a {type(self.plan).__name__} has no tiles "
                             "band")
        if not self.packed:
            return self.band()
        if self._tiles_band is None:
            self._tiles_band = self.build_band(self.band_dtype, tiles=True)
        return self._tiles_band

    def ell_operands(self):
        """K6's operands for a :class:`~band_spmm.BandedPlan`: the first
        ``kcap`` ELL slots, the values in the band's dtype (built once)."""
        if self._ell is None:
            k = self.plan.kcap
            self._ell = (self.g.cols[:, :k].contiguous(),
                         self.g.vals[:, :k].to(self.band_dtype).contiguous())
        return self._ell

    def laplacian_matvec(self, normalization: str, deg_p):
        """``X -> L X`` in permuted space on :meth:`spmm`, for the three
        normalizations (``ops.graphops.laplacian_matvec``); ``deg_p`` the
        permuted degrees, padding rows (degree 0) identity or zero rows."""
        ok = deg_p > 0
        safe = torch.where(ok, deg_p, torch.ones_like(deg_p))
        zero = torch.zeros_like(deg_p)
        if normalization == "combinatorial":
            return lambda X: deg_p[:, None] * X - self.spmm(X)
        if normalization == "randomwalk":
            dinv = torch.where(ok, 1.0 / safe, zero)
            return lambda X: X - dinv[:, None] * self.spmm(X)
        if normalization == "normalized":
            s = torch.where(ok, safe ** -0.5, zero)
            return lambda X: X - s[:, None] * self.spmm(s[:, None] * X)
        raise ValueError(f"unsupported normalization {normalization!r}")

    # -- index maps (one gather each, outside the solver loop) ------------

    def to_perm(self, X, fill=0.0):
        """Original -> permuted padded space; padding rows get ``fill``."""
        Xp = X[self._perm_dev.clamp(min=0)]
        valid = (self._perm_dev >= 0).reshape((-1,) + (1,) * (X.dim() - 1))
        return torch.where(valid, Xp, torch.full((), fill, dtype=Xp.dtype,
                                                 device=Xp.device))

    def from_perm(self, Xp):
        """Permuted padded -> original space."""
        return Xp[self._inv_dev]

    # -- the matvec ----------------------------------------------------------

    def spmm(self, Xp):
        """``Wp @ Xp`` in permuted padded space: the kernel of the plan
        (K2, K3, K5 or K6) plus the residual edges."""
        plan = self.plan
        Xk = Xp.to(torch.bfloat16) if self.mode == "bf16" else Xp
        if isinstance(plan, _bs.BandedPlan):
            out = _bs.banded_spmm(*self.ell_operands(), plan, Xk)
        elif isinstance(plan, _bs.RectPlan):
            band = self.band()
            out = _bs.band_spmm(band, plan, Xk, self.live_chunks(band))
        elif isinstance(plan, _bs.PackedPlan):
            out = _bs.band_tiles_spmm_packed(self.band(), plan, Xk)
        else:
            out = _bs.band_tiles_spmm(self.band(), plan, Xk)
        out = _bs.apply_residual(out, Xp, self._resid)
        return out.to(Xp.dtype)

    # -- distance rounds on the unpacked tiles (K7) or the rectangular band
    # (K8) ------------------------------------------------------------------

    def _minplus(self, d, f, hopf_lax, recip, track):
        """One relaxation round: K8 over a rectangular plan's band, else K7
        over the tiles, plus the residual edges.  Returns ``(min, arg)`` in
        permuted space."""
        if isinstance(self.plan, _bs.RectPlan):
            resid = self.plan.resid
            band = self.band()
            bmin, barg = _bs.band_minplus(
                band, self.plan, d, f, hopf_lax=hopf_lax, track_arg=track,
                recip=recip, chunks=self.live_chunks(band))
        else:
            resid = self._tiles_resid
            band = self.tiles_band()
            bmin, barg = _bs.band_tiles_minplus(
                band, self.tiles_plan, d, f, hopf_lax=hopf_lax,
                track_arg=track, recip=recip, chunks=self.live_chunks(band))
        if resid is not None:
            rmin, rarg = _bs.residual_minplus(d, f, resid,
                                              hopf_lax=hopf_lax,
                                              track_arg=track, recip=recip)
            if track:
                barg = torch.where(bmin <= rmin, barg, rarg)
            bmin = torch.minimum(bmin, rmin)
        return bmin, barg

    def bellman_ford(self, d0, f, hopf_lax: bool = False,
                     recip: bool = False, max_iter: int = 10**6):
        """Distance iteration to the Dijkstra (or Hopf-Lax) fixed point on
        the stored band (the tiles, or a rectangular plan's band), then
        each node's closest seed: the parents of the shortest-path tree at
        the fixed point, followed to the root by pointer doubling.  ``d0``
        holds the seeds' values and ``_bs.MINPLUS_BIG`` elsewhere; every
        speed ``f`` must be positive (a zero edge cost would make the
        parents ambiguous).  Takes and returns original-order arrays:
        ``(d, cp, rounds)``, with ``cp`` -1 where unreached.  Needs
        ``materialize``: a :class:`~band_spmm.BandedPlan` stores no band."""
        if not self.materialize:
            raise ValueError("bellman_ford needs a stored band: this "
                             "graph's plan is a BandedPlan")
        dev, dt = self.device, self._val_dtype
        big = _bs.MINPLUS_BIG
        d0_p = self.to_perm(torch.as_tensor(d0, device=dev).to(dt), fill=big)
        f_p = self.to_perm(torch.as_tensor(f, device=dev).to(dt))

        def relax(d):
            bmin, _ = self._minplus(d, f_p, hopf_lax, recip, False)
            d_new = torch.minimum(d, bmin)
            return d_new, (d_new < d).any()

        d, rounds = _fixed_point(relax, d0_p, max_iter)
        # a node that took a candidate equals its least candidate exactly
        # (the same operations); a seed never improved parents to itself
        pmin, parg = self._minplus(d, f_p, hopf_lax, recip, True)
        own = torch.arange(self.n_pad, dtype=torch.int32, device=dev)
        parent = torch.where(pmin <= d, parg,
                             torch.where(d0_p < big, own, -1))
        parent = torch.where(d >= 0.5 * big, -1, parent).long()
        for _ in range(max(1, int(np.ceil(np.log2(max(2, self.n_pad)))))):
            parent = torch.where(parent >= 0, parent[parent.clamp(min=0)], -1)
        root = self.from_perm(parent)
        cp = torch.where(root >= 0, self._perm_dev[root.clamp(min=0)], -1)
        return self.from_perm(d), cp, rounds

    # -- Lipschitz rounds -------------------------------------------------

    def _lip_inputs(self, u0, bdy_mask, gvals):
        """Permuted ``(u0, bdy, gvals, 1/wsum)``; padding rows are boundary
        rows pinned to 0."""
        dev, dt = self.device, self._val_dtype
        as_t = lambda a: torch.as_tensor(a, device=dev)
        u0_p = self.to_perm(as_t(u0).to(dt))
        bdy_p = self.to_perm(as_t(bdy_mask).to(torch.int32), fill=1) > 0
        gv_p = self.to_perm(as_t(gvals).to(dt))
        wsum = torch.sum(self.g.vals, dim=1)
        inv_wsum = torch.where(wsum > 0, 1.0 / torch.where(
            wsum == 0, torch.ones_like(wsum), wsum), torch.zeros_like(wsum))
        return u0_p, bdy_p, gv_p, inv_wsum

    def lip_iterate_mc(self, u0, bdy_mask, gvals, alpha, beta, tol,
                       max_iter: int):
        """One-vs-rest p-Laplace / unweighted AMLE Jacobi rounds ``u <-
        alpha avg + beta (min + max)/2`` on the tiles band: K9 gives the
        three reductions of a round in one band pass.  Original-order
        (n, C) in and out, C <= 32 on CUDA; the period-2 stop and the
        21-round minimum of the plain iteration.  Returns ``(u, rounds)``.
        Needs the tiled band, as in the JAX package."""
        if self.tiles_plan is None:
            raise ValueError("lip_iterate_mc requires the tiled band")
        u0_p, bdy_p, gv_p, inv_wsum = self._lip_inputs(u0, bdy_mask, gvals)
        band, resid = self.tiles_band(), self._tiles_resid
        chunks = self.live_chunks(band)

        def step(u):
            sumu, minu, maxu = _bs.band_tiles_lip(band, self.tiles_plan, u,
                                                  chunks)
            if resid is not None:
                sa, mr, xr = _bs.residual_lip(u, resid, self.n_pad)
                sumu = sumu + sa
                minu = torch.minimum(minu, mr)
                maxu = torch.maximum(maxu, xr)
            return (alpha * sumu * inv_wsum[:, None]
                    + beta * 0.5 * (minu + maxu))

        u, rounds = _lip_loop(step, u0_p, bdy_p[:, None], gv_p, tol,
                              int(max_iter))
        return self.from_perm(u), rounds

    def rect_band_bytes(self) -> int:
        """Bytes of the rectangular ``(n_pad, Wr)`` band that
        :meth:`lip_gs_mc` streams; far more than the tiles on a
        band-hostile graph."""
        return (self.n_pad * int(self._rect_plan[3])
                * (torch.finfo(self.band_dtype).bits // 8))

    def rect_band_ok(self) -> bool:
        """Whether the rectangular band fits the band budget beside the
        bands resident with it: the matvec band (the harmonic warm start
        runs on it first) and the unpacked tiles band once built.  A
        rectangular plan's matvec band is this band."""
        if isinstance(self.plan, _bs.RectPlan):
            return self.rect_band_bytes() <= self._budget
        resident = self.matvec_band_bytes
        if self.packed and self._tiles_band is not None:
            resident += self.band_bytes
        return self.rect_band_bytes() + resident <= self._budget

    def _rect_band(self):
        """The rectangular band (K4), its window starts on the host and on
        the device, its residual and its width, built on first use."""
        if self._rect is None:
            if not self.rect_band_ok():
                raise ValueError(
                    f"rectangular band of {self.rect_band_bytes():.3g} B does "
                    f"not fit the band budget of {self._budget:.3g} B beside "
                    "the resident bands: callers gate on rect_band_ok()")
            plan = self.plan
            if isinstance(plan, _bs.RectPlan):
                # the matvec band is the rectangular band: no second copy
                self._rect = (self.band(), plan.winstart_host.tolist(),
                              plan.resid, plan.W)
                return self._rect
            winstart, _, _, Wr, kcap = self._rect_plan
            dev = self.device
            ws = torch.as_tensor(winstart, device=dev)
            band = _bs.materialize_band(
                self.g.cols[:, :kcap].contiguous(),
                self.g.vals[:, :kcap].contiguous(), ws, int(Wr), R=self.R,
                WT=self.WT, out_dtype=self.band_dtype)
            resid = _bs.residual_to_device(self._rect_resid_host, dev,
                                           self._val_dtype)
            self._rect = (band, np.asarray(winstart).tolist(), resid, int(Wr))
        return self._rect

    def lip_gs_mc(self, u0, bdy_mask, gvals, alpha, beta, tol,
                  max_iter: int):
        """One-vs-rest p-Laplace / unweighted AMLE by block-Gauss-Seidel
        sweeps over the row blocks of the rectangular band: each block
        updates from the current ``u`` (earlier blocks already updated in
        this sweep), so information crosses the whole band each sweep
        instead of one ring of neighbors per Jacobi round.  The residual
        edges contribute from the sweep's starting iterate; the fixed point
        is the Jacobi one.  Original-order (n, C) in and out.  Returns
        ``(u, sweeps)``.

        The block loop runs on the host, one block after another by design
        (forward Gauss-Seidel), as JAX's ``fori_loop`` does; each block's
        ``(R, Wr) @ (Wr, C)`` product is ``torch.matmul`` in f32 (products
        of a bf16 band and the bf16-rounded window are exact in f32, as
        JAX's ``preferred_element_type``), and the masked min and max are
        torch reductions."""
        band, winstart, resid, Wr = self._rect_band()
        u0_p, bdy_p, gv_p, inv_wsum = self._lip_inputs(u0, bdy_mask, gvals)
        R = self.R
        acc = torch.float64 if band.dtype == torch.float64 else torch.float32
        big = _bs.LIP_BIG

        def sweep(u):
            if resid is not None:
                rsum, rmin, rmax = _bs.residual_lip(u, resid, self.n_pad)
            u = u.clone()
            err = torch.zeros((), dtype=u.dtype, device=u.device)
            for i, ws in enumerate(winstart):
                r0 = i * R
                uw = u[ws:ws + Wr]
                A = band[r0:r0 + R]
                s = torch.matmul(A.to(acc), uw.to(band.dtype).to(acc))
                has = (A > 0)[:, :, None]
                mn = torch.amin(torch.where(has, uw[None], big), dim=1)
                mx = torch.amax(torch.where(has, uw[None], -big), dim=1)
                if resid is not None:
                    s = s + rsum[r0:r0 + R]
                    mn = torch.minimum(mn, rmin[r0:r0 + R])
                    mx = torch.maximum(mx, rmax[r0:r0 + R])
                ub = u[r0:r0 + R]
                ne = (alpha * s.to(u.dtype) * inv_wsum[r0:r0 + R, None]
                      + beta * 0.5 * (mn + mx))
                ne = torch.where(bdy_p[r0:r0 + R, None], ub, ne)
                err = torch.maximum(err, torch.max(torch.abs(ne - ub)))
                u[r0:r0 + R] = ne
            return u, err

        u = torch.where(bdy_p[:, None], gv_p, u0_p)
        u_prev = u
        err, it = float("inf"), 0
        while (err > tol or it <= 20) and it < max_iter:
            u_new, e = sweep(u)
            err = min(float(e), float(torch.max(torch.abs(u_new - u_prev))))
            u_prev, u = u, u_new
            it += 1
        return self.from_perm(u), it


def _hybrid_estimate(acc: AccelSpMM) -> float:
    """Steady-state seconds of one band SpMM: stream the stored band (for
    a :class:`~band_spmm.BandedPlan`, K6 reads the ``kcap`` ELL slots, an
    int32 column and a value each, once instead) plus gather the residual
    edges."""
    stream = acc.band_bytes
    if isinstance(acc.plan, _bs.BandedPlan):
        stream = acc.n_pad * acc.plan.kcap * (
            4 + torch.finfo(acc.band_dtype).bits // 8)
    return stream / _HBM_BPS + acc.n_resid * _GATHER_NS


_PLAN_NAMES = {_bs.PackedPlan: "packed tiles (K2)",
               _bs.TilesPlan: "unpacked tiles (K3)",
               _bs.RectPlan: "stored rectangular band (K5)",
               _bs.BandedPlan: "unstored rectangular band (K6)"}


def path_name(acc) -> str:
    """The path a fit takes with the accel ``acc`` (from
    :func:`maybe_build`): the band plan, the gather, or the plain ELL
    gather when ``acc`` is None (or a cached refusal)."""
    if acc is None or isinstance(acc, _Disabled):
        return "plain ELL"
    if isinstance(acc, GatherAccel):
        return f"segmented gather (GatherAccel, prec {acc.prec})"
    return _PLAN_NAMES[type(acc.plan)]


class _Disabled:
    """Negative-decision cache entry (graph rejected for the band path).
    ``gather_reason`` is set when the gather applies but was not built
    (the caller passed ``gather=False``)."""

    def __init__(self, n, nnz, gather_reason=None):
        self.n, self.nnz = n, nnz
        self.gather_reason = gather_reason


def maybe_build(W, cache_obj=None, attr="_accel_cache", device=None,
                gather=True, **kw):
    """The accel of ``W`` for the fits, as the JAX package chooses it: an
    :class:`AccelSpMM` when the band path applies and its cost model
    predicts a gain over the gather; else the segmented gather
    (:class:`~graphlearning_tpu_torch.ops.gather.GatherAccel`) for a
    band-hostile graph, a band over the budget
    (:class:`BandPlanUnavailable`) or a band the cost model rejects; None
    (the plain ELL path) off CUDA, under ``_MIN_N`` nodes, or under
    ``GLT_NO_GATHER`` where the gather would be taken.  The gather keeps
    f32 tables unless the caller asked for the bf16 band (``mode="bf16"``:
    prec "auto", as JAX's inexact mode).  ``gather=False`` is for callers
    that run only on a stored band (the distance and Lipschitz solvers):
    they get None where the gather would be taken, and no gather is built
    for them (the JAX package builds it and leaves it unused).

    The choice is logged and memoized on ``cache_obj`` and on the ``W``
    object (repeated fits on one graph skip the host build), keyed by the
    band configuration, ``materialize``, ``GLT_NO_BAND`` and
    ``GLT_NO_GATHER`` included; a later ``gather=True`` call on a graph
    refused for a ``gather=False`` one builds the gather then.  Any error
    other than :class:`BandPlanUnavailable` raises (JAX falls back on
    every exception)."""
    dev = config.device(device)
    n = W.shape[0]
    if not enabled(dev):
        log.info("plain ELL path on %s: the band path needs CUDA "
                 "(or GLT_NO_ACCEL is set)", dev)
        return None
    if n < _MIN_N:
        log.info("plain ELL path: n=%d < %d", n, _MIN_N)
        return None
    if kw.get("packed") is None:
        kw["packed"] = not os.environ.get("GLT_NO_PACKED")
    kw.setdefault("mode", "f32")      # one cache entry per band config
    kw.setdefault("materialize", None)
    gkey = ((str(dev), bool(os.environ.get("GLT_NO_BAND")),
             bool(os.environ.get("GLT_NO_GATHER")))
            + tuple(sorted(kw.items())))

    def hit(cached):
        return (cached is not None and getattr(cached, "cache_key", None)
                == gkey and cached.n == n and cached.nnz == W.nnz)

    def keep(value):
        value.cache_key = gkey
        if cache_obj is not None:
            setattr(cache_obj, attr, value)
        if not isinstance(getattr(W, "_gltt_accel_cache", None), dict):
            W._gltt_accel_cache = {}
        W._gltt_accel_cache[gkey] = value
        return use(value)

    def build(choose, *args):
        """``choose(*args)``, a cache miss's choice and build, in an
        ``accel.build`` span that names the route taken."""
        with _obs.span("accel.build") as span:
            acc = choose(*args)
            span.set(route=path_name(acc))
        return acc

    def use(value):
        if isinstance(value, _Disabled):
            if gather and value.gather_reason:
                return build(fallback, value.gather_reason)
            return None
        if not gather and isinstance(value, GatherAccel):
            return None
        return value

    def fallback(reason):
        if os.environ.get("GLT_NO_GATHER"):
            log.info("plain ELL path: %s, and GLT_NO_GATHER is set", reason)
            return keep(_Disabled(n, int(W.nnz)))
        if not gather:
            log.info("plain ELL path: %s; the caller runs only on a stored "
                     "band, so the gather is not built", reason)
            return keep(_Disabled(n, int(W.nnz), gather_reason=reason))
        acc = GatherAccel(W, prec="auto" if kw["mode"] == "bf16" else "f32",
                          device=dev)
        log.info("%s: %s, %d segments, %d slots for %d edges",
                 path_name(acc), reason, len(acc.segs), acc.slots, acc.nnz)
        return keep(acc)

    if cache_obj is not None:
        cached = getattr(cache_obj, attr, None)
        if hit(cached):
            return use(cached)
    gcache = getattr(W, "_gltt_accel_cache", None)
    if isinstance(gcache, dict) and hit(gcache.get(gkey)):
        cached = gcache[gkey]
        if cache_obj is not None:
            setattr(cache_obj, attr, cached)
        return use(cached)

    def choose():
        if _band_hostile(W):
            return fallback("the graph is band-hostile (p95 RCM bandwidth "
                            "> n/4)")
        try:
            acc = AccelSpMM(W, device=dev, **kw)
        except BandPlanUnavailable as e:
            return fallback(str(e))
        if _hybrid_estimate(acc) > 0.7 * W.nnz * _GATHER_NS:
            return fallback("the band cost model predicts no gain")
        log.info("band path: %s plan, n_pad=%d, %d residual edges",
                 path_name(acc), acc.n_pad, acc.n_resid)
        return keep(acc)

    return build(choose)


def _band_hostile(W) -> bool:
    """Cheap pre-gate: one RCM pass; band-hostile when the p95 RCM
    bandwidth exceeds n/4."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    Wc = sp.csr_matrix(W)
    n = Wc.shape[0]
    perm = np.asarray(reverse_cuthill_mckee(Wc, symmetric_mode=True))
    inv = np.argsort(perm)
    deg = np.diff(Wc.indptr)
    I = np.repeat(np.arange(n, dtype=np.int64), deg)
    bw = np.abs(inv[I] - inv[Wc.indices])
    return float(np.percentile(bw, 95)) > n / 4
