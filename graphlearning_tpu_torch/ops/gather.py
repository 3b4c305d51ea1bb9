"""Degree-sorted segmented gather SpMM: the path of band-hostile graphs.

Counterpart of ``graphlearning_tpu/ops/gather.py``.  A high-dimensional kNN
graph (image embeddings at 30 dimensions and more) has no band: no
ordering brings its edges near the diagonal, so every band format streams
mostly zeros.  Its SpMM is a row gather.  One ELL at the largest degree
pads every row to the hubs' degree, so :class:`GatherSpMM` sorts the rows
by degree and cuts them into segments at the boundaries of ``_BOUNDS``:
each segment is a tight ``(rows, kcap)`` ELL, padded only up to its
boundary.  Everything runs in the degree-sorted (permuted) space, as
:class:`~graphlearning_tpu_torch.ops.accel.AccelSpMM` does, so a solver
pays the permutation once each way.

The gather is plain torch, as it is XLA in the JAX package: each segment
gathers its X rows in chunks of rows, bounded by ``_GATHER_CELLS``
elements (one ``(rows, kcap, d)`` take of a whole segment reaches
gigabytes at n = 262144, d = 128), and sums them against the slot
weights.  :class:`GatherAccel` adds the solver entries the ported fits
call on an accel, and the segmented min-plus relaxation of the distance
solvers (:meth:`GatherAccel.bellman_ford`).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from graphlearning_tpu_torch import config
from graphlearning_tpu_torch.ops.band_spmm import MINPLUS_BIG
from graphlearning_tpu_torch.ops.solver_entries import SpmmSolvers
from graphlearning_tpu_torch.solvers.eikonal import _fixed_point, _slot_min

# Segment kcap boundaries: a segment pads its rows at most to the next
# boundary (<= 33 % here); degree-0 rows fold into the first.
_BOUNDS = (4, 8, 12, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512,
           768, 1024, 2048, 4096)

# PLACEHOLDER, measured on a TPU v5e by the JAX package (its gather slowed
# once the gathered table passed about 100 MB); not an H100 number.
# prec="auto" takes the bf16 table above it.  The port's bench measures
# the f32 and the bf16 table on the card (GLT_BENCH_GEOM=highdim).
_FAST_TABLE_BYTES = 100e6

# Elements of one chunk's (rows, kcap, d) gather.
_GATHER_CELLS = 1 << 25


class GatherSpMM:
    """Degree-sorted segmented gather SpMM for one graph, on ``device``
    (resolved by :func:`config.device`).

    ``prec``: "f32" (the table in the working dtype), "bf16" (the table
    cast to bf16, sums in f32) or "auto" (bf16 only when the f32 table of
    a call is over ``_FAST_TABLE_BYTES``).  ``segs`` holds each segment's
    ``(start, end, kcap)`` in sorted rows; ``cols`` and ``vals`` its slots,
    the columns in permuted space, pad slots pointing at their own row
    with value 0."""

    def __init__(self, W, prec: str = "f32", device=None):
        if prec not in ("f32", "bf16", "auto"):
            raise ValueError(f"prec must be 'f32', 'bf16' or 'auto', not "
                             f"{prec!r}")
        dev = config.device(device)
        self.device = dev
        W = sp.csr_matrix(W)
        n = W.shape[0]
        self.n = n
        self.nnz = int(W.nnz)
        self.prec = prec
        deg = np.diff(W.indptr)
        order = np.argsort(deg, kind="stable")
        self.order = order
        self.inv = np.argsort(order)
        deg_s = deg[order]
        bounds = _BOUNDS
        if n and int(deg_s[-1]) > bounds[-1]:
            # a hub over the table: one more segment at its degree,
            # rounded up to a multiple of 8
            bounds = bounds + (-(-int(deg_s[-1]) // 8) * 8,)
        val_dtype = np.float64 if config.float_dtype(dev) == torch.float64 \
            else np.float32
        self.segs, self.cols, self.vals = [], [], []
        start = 0
        for kcap in bounds:
            end = int(np.searchsorted(deg_s, kcap, side="right"))
            if end <= start:
                continue
            rows = order[start:end]
            a = W.indptr[rows].astype(np.int64)
            dseg = deg[rows].astype(np.int64)
            slot = np.arange(kcap, dtype=np.int64)[None, :]
            valid = slot < dseg[:, None]
            flat = np.minimum(a[:, None] + np.minimum(
                slot, np.maximum(dseg[:, None] - 1, 0)), max(self.nnz - 1, 0))
            cols = np.where(valid, self.inv[W.indices[flat]],
                            self.inv[rows][:, None])
            vals = np.where(valid, W.data[flat], 0.0).astype(val_dtype)
            self.cols.append(torch.as_tensor(cols, device=dev))
            self.vals.append(torch.as_tensor(vals, device=dev))
            self.segs.append((start, end, kcap))
            start = end
            if end == n:
                break
        if start != n:
            raise ValueError("a degree exceeds the largest segment boundary")
        self._order_dev = torch.as_tensor(order, device=dev)
        self._inv_dev = torch.as_tensor(self.inv, device=dev)

    @property
    def slots(self) -> int:
        """ELL slots over all segments, padding included."""
        return sum((e - s) * kc for s, e, kc in self.segs)

    # -- index maps (once per solve, outside the iteration loops) ---------

    def to_perm(self, X, fill=0.0):
        """Original -> permuted space.  There are no padding rows, so
        ``fill`` (:class:`AccelSpMM`'s signature) is unused."""
        return X[self._order_dev]

    def from_perm(self, Xp):
        return Xp[self._inv_dev]

    # -- the SpMM ---------------------------------------------------------

    def spmm(self, Xp):
        """``W @ X`` in permuted space: ``Xp`` (n, d) or (n,), degree-sorted
        rows.  Sums in f32, f64 for f64 ``Xp``."""
        if Xp.dim() == 1:
            return self.spmm(Xp[:, None])[:, 0]
        d = Xp.shape[1]
        bf16 = self.prec == "bf16" or (
            self.prec == "auto"
            and Xp.numel() * Xp.element_size() > _FAST_TABLE_BYTES)
        table = Xp.to(torch.bfloat16) if bf16 else Xp
        acc = torch.float64 if Xp.dtype == torch.float64 else torch.float32
        out = torch.empty((self.n, d), dtype=acc, device=Xp.device)
        for (start, end, kcap), c, v in zip(self.segs, self.cols, self.vals):
            step = max(1, _GATHER_CELLS // (kcap * max(d, 1)))
            for r0 in range(0, end - start, step):
                r1 = min(end - start, r0 + step)
                g = table[c[r0:r1]].to(acc)                # (rows, kcap, d)
                out[start + r0:start + r1] = torch.bmm(
                    v[r0:r1].to(acc)[:, None, :], g)[:, 0]
        return out.to(Xp.dtype)


class GatherAccel(GatherSpMM, SpmmSolvers):
    """The accel of a band-hostile graph: :class:`GatherSpMM` with the
    solver entries that the ported fits call on an accel
    (:class:`~graphlearning_tpu_torch.ops.solver_entries.SpmmSolvers`) and
    :meth:`bellman_ford`, which the distance solvers take
    (``supports_bellman_ford``): VolumeMBO's Voronoi start is its caller.
    It stores no band, so the Lipschitz solvers' band gates
    (``materialize``, ``rect_band_ok()``) send them to their plain
    path."""

    materialize = False
    supports_bellman_ford = True
    n_resid = 0

    def __init__(self, W, prec: str = "f32", device=None):
        super().__init__(W, prec=prec, device=device)
        self.n_pad = self.n
        self.mode = self.prec
        self.kcap = max(kc for _, _, kc in self.segs)

    def rect_band_ok(self) -> bool:
        return False

    def rect_band_bytes(self) -> int:
        return 0

    def bellman_ford(self, d0, f, hopf_lax: bool = False,
                     recip: bool = False, max_iter: int = 10**6):
        """Min-plus Bellman-Ford to the Dijkstra (or Hopf-Lax) fixed point
        on the segments, carrying each node's closest seed, in f32 as in
        the JAX package: each round takes every row's least candidate
        ``d_j + w f_j`` over its slots (the first slot on ties).  ``d0``
        holds the seeds' values and ``MINPLUS_BIG`` elsewhere.  Takes and
        returns original-order arrays: ``(d, cp, rounds)``, ``cp`` original
        ids, -1 where unreached."""
        dev, f32 = self.device, torch.float32
        big = torch.tensor(MINPLUS_BIG, dtype=f32, device=dev)
        d0 = torch.as_tensor(np.asarray(d0), device=dev).to(f32)
        cp0 = torch.where(d0 < MINPLUS_BIG * 0.5,
                          torch.arange(self.n, device=dev), -1)
        f_p = self.to_perm(torch.as_tensor(np.asarray(f), device=dev).to(f32))
        segs = []
        for c, v in zip(self.cols, self.vals):
            v = v.to(f32)
            w = torch.where(v > 0, 1.0 / torch.where(v == 0, 1.0, v), 0.0) \
                if recip else v
            segs.append((c, v > 0, w * f_p[c]))

        def relax(state):
            d, cp = state
            best, arg = [], []
            for c, edge, fw in segs:
                b, s = _slot_min(d[c], fw, edge, big, hopf_lax)
                best.append(b)
                arg.append(torch.gather(c, 1, s[:, None])[:, 0])
            best, arg = torch.cat(best), torch.cat(arg)
            upd = best < d
            return ((torch.where(upd, best, d),
                     torch.where(upd, cp[arg], cp)), upd.any())

        (d, cp), rounds = _fixed_point(
            relax, (self.to_perm(d0), self.to_perm(cp0)), max_iter)
        return self.from_perm(d), self.from_perm(cp), rounds
