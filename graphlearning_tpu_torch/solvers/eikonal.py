"""Graph distance and Hamilton-Jacobi solvers (counterpart of
``graphlearning_tpu/solvers/eikonal.py``).

* Dijkstra and Hopf-Lax distances by Bellman-Ford label correction: every
  node relaxes in parallel each round, ``d_j <- min(d_j, min_i update(d_i,
  w_ij, f_i))``, to the Dijkstra fixed point.  On a band-friendly graph
  the round streams the tiled band (:meth:`AccelSpMM.bellman_ford`, kernel
  K7); given a ``GatherAccel`` (VolumeMBO's Voronoi start on a
  band-hostile graph) it runs on the gather's degree segments; otherwise
  it is a gather over the padded ELL.
* The p-eikonal equation ``sum_j w_ij (u_i - u_j)_+^p = f_i`` by Jacobi
  rounds: for p = 1 an exact sorted prefix-scan node solve, otherwise a
  30-step bisection in lockstep.

The relaxation loops test for the fixed point every ``_CHECK_EVERY``
rounds, not every round: a round at the fixed point changes nothing, so the
result is the one a per-round test gives, with fewer host syncs.  Rounds
are still capped at ``max_iter``.  The Jacobi loops of the p-eikonal solver
test their tolerance every round, as the JAX package does.

The gathers go through ``ops.graphops.neighbor_take``, so
``_bellman_ford`` and ``_peikonal_jacobi_mc`` run unchanged on a rank's
rows of a sharded graph (``parallel``); their stop tests then read the
largest change over the ranks (``reduce``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from graphlearning_tpu_torch.core.sparse import SparseGraph
from graphlearning_tpu_torch.ops.band_spmm import MINPLUS_BIG
from graphlearning_tpu_torch.ops.graphops import neighbor_take

_CHECK_EVERY = 8
_DM_BIG = 1e30


def _boundary_handling(bdy_set, bdy_val):
    bdy_set = np.asarray(bdy_set)
    if bdy_set.dtype == bool:
        bdy_set = np.where(bdy_set)[0]
    m = len(bdy_set)
    if not isinstance(bdy_val, np.ndarray):
        bdy_val = np.ones((m,)) * bdy_val
    return bdy_set.astype(np.int32), np.asarray(bdy_val, dtype=float)


def _speed(f, n):
    if np.isscalar(f) or np.ndim(f) == 0:
        f = np.full((n,), float(f))
    return np.asarray(f, dtype=float)


def _as(g: SparseGraph, a, dtype=None):
    return torch.as_tensor(np.asarray(a), device=g.device).to(
        dtype or g.vals.dtype)


def _fixed_point(relax, state, max_iter: int, reduce=None):
    """Apply ``relax(state) -> (state, changed)`` until a round changes
    nothing (on any rank, with ``reduce``) or ``max_iter`` rounds ran.
    Returns ``(state, rounds)``."""
    it = 0
    while it < max_iter:
        for _ in range(min(_CHECK_EVERY, max_iter - it)):
            state, changed = relax(state)
            it += 1
        if reduce is not None:
            changed = reduce(changed.to(torch.int32), "max")
        if not bool(changed):
            break
    return state, it


# -- Bellman-Ford (min-plus) distance iteration ------------------------------


def _slot_min(dn, fw, mask, big, hopf_lax: bool):
    """One relaxation over the slot axis 1: each slot's candidate
    ``d_nbr + w f_nbr``, or the Hopf-Lax quadratic of ``d_nbr`` and ``fw =
    w f_nbr``, ``big`` off ``mask``; returns each row's least candidate and
    its slot (the first on ties)."""
    if hopf_lax:
        cand = 0.5 * (fw + torch.sqrt(fw * fw + 4.0 * dn * dn))
    else:
        cand = dn + fw
    return torch.min(torch.where(mask, cand, big), dim=1)


def _bellman_ford(g: SparseGraph, d0, cp0, f, hopf_lax: bool, max_iter: int,
                  reduce=None):
    """Iterate ``d_j <- min(d_j, min_s update(d_nbr, w_js, f_nbr))`` to the
    Dijkstra fixed point, carrying each node's closest boundary point.
    ``update`` is ``d_i + w_ij f_i`` or the Hopf-Lax quadratic
    ``(f w + sqrt(f^2 w^2 + 4 d^2)) / 2``.  Returns ``(d, cp, rounds)``."""
    mask = g.mask()
    big = torch.finfo(d0.dtype).max
    fn = neighbor_take(g, f)
    fw = fn * g.vals if hopf_lax else g.vals * fn

    def relax(state):
        d, cp = state
        best, s = _slot_min(neighbor_take(g, d), fw, mask, big, hopf_lax)
        upd = best < d
        d = torch.where(upd, best, d)
        cp = torch.where(upd, neighbor_take(g, cp, s), cp)
        return (d, cp), upd.any()

    (d, cp), rounds = _fixed_point(relax, (d0, cp0), max_iter, reduce)
    return d, cp, rounds


def _finish(d, cp, unreached_at, max_dist, return_cp):
    d = d.cpu().numpy().astype(float)
    cp = cp.cpu().numpy()
    d[d >= unreached_at] = np.inf
    if np.isfinite(max_dist):
        far = d > max_dist
        d[far] = np.inf
        cp[far] = -1
    return (d, cp) if return_cp else d


def _distance(g, bdy_set, bdy_val, f, max_dist, return_cp,
              reciprocal_weights, max_iter, accel, hopf_lax, info):
    n = g.n
    bdy_set, bdy_val_arr = _boundary_handling(
        bdy_set, 0 if bdy_val is None else bdy_val)
    f_np = _speed(f, n)
    # the accel's rounds: a stored band's (not a BandedPlan's), or the
    # gather's segments
    if (accel is not None and np.all(f_np > 0)
            and (accel.materialize
                 or getattr(accel, "supports_bellman_ford", False))):
        d0 = np.full((n,), MINPLUS_BIG)
        d0[bdy_set] = bdy_val_arr
        d, cp, rounds = accel.bellman_ford(
            d0, f_np, hopf_lax=hopf_lax, recip=reciprocal_weights,
            max_iter=max_iter)
        if info is not None:
            info.update(iters=rounds,
                        path="band" if accel.materialize else "gather")
        return _finish(d, cp.to(torch.int32), MINPLUS_BIG * 0.5, max_dist,
                       return_cp)
    gg = g
    if reciprocal_weights:
        gg = g.with_vals(torch.where(
            g.mask(), 1.0 / torch.where(g.vals == 0, 1.0, g.vals), 0.0))
    dtype = g.vals.dtype
    big = torch.finfo(dtype).max
    idx = torch.as_tensor(bdy_set.astype(np.int64), device=g.device)
    d0 = torch.full((n,), big, dtype=dtype, device=g.device)
    d0[idx] = _as(g, bdy_val_arr)
    cp0 = torch.full((n,), -1, dtype=torch.int32, device=g.device)
    cp0[idx] = idx.to(torch.int32)
    d, cp, rounds = _bellman_ford(gg, d0, cp0, _as(g, f_np), hopf_lax,
                                  max_iter)
    if info is not None:
        info.update(iters=rounds, path="plain")
    return _finish(d, cp, big * 0.5, max_dist, return_cp)


def dijkstra(g: SparseGraph, bdy_set, bdy_val=None, f=1, max_dist=np.inf,
             return_cp=False, reciprocal_weights=False, max_iter=10**6,
             accel=None, info=None):
    """Graph distance to a terminal set: ``u(x) = min_{i in Gamma} g_i +
    d(x, x_i)`` with edge cost ``w_ij f`` (``f / w_ij`` with
    ``reciprocal_weights``).  Nodes farther than ``max_dist`` get ``inf``
    (cp = -1).  ``accel`` runs the relaxation where every speed is
    positive: an :class:`AccelSpMM` on its stored band when it has one
    (``accel.materialize``), a ``GatherAccel`` on its segments
    (``supports_bellman_ford``).  ``info``, a dict, receives the
    rounds run and the path taken."""
    return _distance(g, bdy_set, bdy_val, f, max_dist, return_cp,
                     reciprocal_weights, max_iter, accel, False, info)


def dijkstra_hl(g: SparseGraph, bdy_set, bdy_val=None, f=1, max_dist=np.inf,
                return_cp=False, max_iter=10**6, accel=None, info=None):
    """Hopf-Lax Hamilton-Jacobi distance (quadratic update), as
    :func:`dijkstra`."""
    return _distance(g, bdy_set, bdy_val, f, max_dist, return_cp, False,
                     max_iter, accel, True, info)


def _bellman_ford_panel(g: SparseGraph, D0, max_iter: int):
    """Multi-source min-plus relaxation over an (n, B) panel, one column
    per source."""
    mask3 = g.mask()[:, :, None]
    cost = g.vals[:, :, None]
    cols = g.cols.long()

    def relax(D):
        cand = torch.where(mask3, D[cols] + cost, _DM_BIG)
        D_new = torch.minimum(D, torch.amin(cand, dim=1))
        return D_new, (D_new < D).any()

    D, _ = _fixed_point(relax, D0, max_iter)
    return D


def distance_matrix(g: SparseGraph, centered=False, panel_bytes=2**29):
    """All-pairs distances by source-paneled multi-source Bellman-Ford:
    panels of B sources keep the per-round (n, k, B) candidate tensor under
    ``panel_bytes``."""
    n = g.n
    dtype = g.vals.dtype
    itemsize = torch.finfo(dtype).bits // 8
    B = int(max(8, min(n, panel_bytes // max(1, n * g.k * itemsize))))
    D = np.empty((n, n), dtype=np.float64 if itemsize == 8 else np.float32)
    eye = torch.arange(B, device=g.device)
    for s in range(0, n, B):
        e = min(s + B, n)
        D0 = torch.full((n, B), _DM_BIG, dtype=dtype, device=g.device)
        D0[s + eye[: e - s], eye[: e - s]] = 0.0
        D[:, s:e] = _bellman_ford_panel(g, D0, max_iter=n)[:, : e - s] \
            .cpu().numpy()
    D[D >= _DM_BIG * 0.5] = np.inf
    if centered:
        # ISOMAP-style double centering
        J = np.eye(n) - np.ones((n, n)) / n
        D = -J @ (D**2) @ J / 2
    return D


# -- p-eikonal Jacobi iteration ----------------------------------------------


def _jacobi(step, u0, bdy_mask, gvals, tol, max_iter: int, reduce=None):
    """``u <- where(bdy, gvals, step(u))`` until ``max|du| <= tol`` (over
    the ranks, with ``reduce``) or ``max_iter`` rounds.  Returns ``(u,
    rounds)``."""
    u = torch.where(bdy_mask, gvals, u0)
    err, it = float("inf"), 0
    while err > tol and it < max_iter:
        u_new = torch.where(bdy_mask, gvals, step(u))
        du = torch.max(torch.abs(u_new - u))
        err = float(du if reduce is None else reduce(du, "max"))
        u = u_new
        it += 1
    return u, it


def _prefix_solve(un, w, f):
    """Exact p = 1 node solve over the slot axis 1 (sorted prefix scan):
    ``t_k = (f + sum_{s<=k} w u) / sum_{s<=k} w`` at the first k with
    ``t_k <= u_{k+1}``.  ``un`` holds the dtype's largest value on padding
    slots, where ``w`` is 0."""
    big = torch.finfo(un.dtype).max
    us, order = torch.sort(un, dim=1, stable=True)
    ws = torch.gather(w.expand_as(un), 1, order)
    wu = torch.where(us >= big, 0.0, ws * us)
    cw = torch.cumsum(ws, dim=1)
    cwu = torch.cumsum(wu, dim=1)
    t = (f + cwu) / torch.clamp(cw, min=1e-30)
    u_next = torch.cat([us[:, 1:], torch.full_like(us[:, :1], big)], dim=1)
    kstar = torch.argmax((t <= u_next).to(torch.uint8), dim=1, keepdim=True)
    return torch.gather(t, 1, kstar)[:, 0]


def _peikonal_jacobi(g: SparseGraph, u0, bdy_mask, gvals, f, p, tol,
                     max_iter: int, num_bisection_it: int, p_is_one: bool):
    mask = g.mask()
    big = torch.finfo(u0.dtype).max
    cols = g.cols.long()
    w = torch.where(mask, g.vals, 0.0)

    def step(u):
        un = torch.where(mask, u[cols], big)
        if p_is_one:
            return _prefix_solve(un, w, f[:, None])
        inc = (f / torch.clamp(torch.sum(w, dim=1), min=1e-30)) ** (1.0 / p)
        a = torch.amin(un, dim=1) + inc
        b = torch.amax(torch.where(mask, u[cols], -big), dim=1) + inc
        for _ in range(num_bisection_it):
            t = 0.5 * (a + b)
            v = torch.clamp(t[:, None] - u[cols], min=0.0) ** p
            hi = torch.sum(torch.where(mask, v * g.vals, 0.0), dim=1) > f
            a, b = torch.where(hi, a, t), torch.where(hi, t, b)
        return 0.5 * (a + b)

    return _jacobi(step, u0, bdy_mask, gvals, tol, max_iter)


def _peikonal_jacobi_mc(g: SparseGraph, u0, bdy_mask, f, tol, *, p: float,
                        max_iter: int, num_bisection_it: int, reduce=None):
    """(n, C) class-batched p-eikonal Jacobi: C one-vs-rest problems that
    differ only in their boundary set (``bdy_mask`` (n, C), value 0) share
    one neighbor gather per round.  p = 1 at kNN slot widths (k <= 32)
    takes the exact prefix-scan solve, else bisection; ``GLT_PEIKONAL_PREFIX``
    ("1"/"0") overrides the choice."""
    mask3 = g.mask()[:, :, None]
    big = torch.finfo(u0.dtype).max
    w3 = torch.where(mask3, g.vals[:, :, None], 0.0)
    force = os.environ.get("GLT_PEIKONAL_PREFIX")
    p_is_one = float(p) == 1.0 and (
        force == "1" or (force != "0" and g.k <= 32))
    wsum = torch.sum(w3[:, :, 0], dim=1)
    inc = ((f / torch.clamp(wsum, min=1e-30)) ** (1.0 / p))[:, None]

    def step(u):
        un = neighbor_take(g, u)                         # (n, k, C)
        if p_is_one:
            return _prefix_solve(torch.where(mask3, un, big), w3,
                                 f[:, None, None])
        a = torch.amin(torch.where(mask3, un, big), dim=1) + inc
        b = torch.amax(torch.where(mask3, un, -big), dim=1) + inc
        for _ in range(num_bisection_it):
            t = 0.5 * (a + b)
            v = torch.clamp(t[:, None, :] - un, min=0.0)
            if p != 1:
                v = v ** p
            hi = torch.sum(v * w3, dim=1) > f[:, None]
            a, b = torch.where(hi, a, t), torch.where(hi, t, b)
        return 0.5 * (a + b)

    zero = torch.zeros((), dtype=u0.dtype, device=u0.device)
    return _jacobi(step, u0, bdy_mask, zero, tol, max_iter, reduce)


def _bellman_ford_mc(g: SparseGraph, D0, f, *, recip: bool, max_iter: int):
    """Class-batched min-plus Bellman-Ford over an (n, C) distance block,
    ``D_j^c <- min(D_j^c, min_i D_i^c + w_ij f_i)``, without closest-point
    tracking (the p-eikonal warm start)."""
    mask = g.mask()
    big = torch.finfo(D0.dtype).max / 4
    cols = g.cols.long()
    w = g.vals
    if recip:
        w = torch.where(mask, 1.0 / torch.where(w == 0, 1.0, w), 0.0)
    cost = torch.where(mask, w * f[cols], big)[:, :, None]
    mask3 = mask[:, :, None]

    def relax(D):
        cand = torch.clamp(D[cols], max=big) + cost
        best = torch.amin(torch.where(mask3, cand, big), dim=1)
        D_new = torch.minimum(D, best)
        return D_new, (D_new < D).any()

    D, _ = _fixed_point(relax, D0, max_iter)
    return D


def peikonal_mc(g: SparseGraph, bdy_sets, f=1, p=1, max_num_it=10**5,
                tol=1e-3, num_bisection_it=30, info=None):
    """One-vs-rest batched p-eikonal with zero boundary values:
    ``bdy_sets`` is a list of C index arrays.  Warm-started per class from
    the first-neighbor distance ``u_i ~ u_j + (f_j / w_ij)^(1/p)`` by one
    class-batched Bellman-Ford.  ``info``, a dict, receives the Jacobi
    rounds."""
    n = g.n
    dtype = g.vals.dtype
    C = len(bdy_sets)
    f = _speed(f, n)
    bdy_mask = np.zeros((n, C), dtype=bool)
    for c, bs in enumerate(bdy_sets):
        bdy_mask[np.asarray(bs), c] = True

    u0 = np.zeros((n, C))
    if np.all(f > 0):
        D0 = np.full((n, C), 1e30)
        D0[bdy_mask] = 0.0
        D = _bellman_ford_mc(g, _as(g, D0), _as(g, f ** (1.0 / p)),
                             recip=(p == 1), max_iter=10**6)
        u0 = D.cpu().numpy().astype(float)
        unreached = u0 >= 1e30 * 0.5
        u0[unreached] = u0[~unreached].max() if (~unreached).any() else 0.0
    tol = max(tol, 100 * float(torch.finfo(dtype).eps))
    u, rounds = _peikonal_jacobi_mc(
        g, _as(g, u0), _as(g, bdy_mask, torch.bool), _as(g, f), tol,
        p=float(p), max_iter=int(max_num_it),
        num_bisection_it=int(num_bisection_it))
    if info is not None:
        info.update(iters=rounds, path="plain")
    return u.cpu().numpy().astype(float)


def peikonal(g: SparseGraph, bdy_set, bdy_val=0, f=1, p=1, max_num_it=10**5,
             tol=1e-3, num_bisection_it=30, u0=None):
    """p-eikonal equation ``sum_j w_ij (u_i - u_j)_+^p = f_i`` with
    Dirichlet data."""
    n = g.n
    dtype = g.vals.dtype
    bdy_set, bdy_val_arr = _boundary_handling(bdy_set, bdy_val)
    bdy_mask = np.zeros(n, dtype=bool)
    bdy_mask[bdy_set] = True
    gvals = np.zeros(n)
    gvals[bdy_set] = bdy_val_arr
    u0 = np.zeros(n) if u0 is None else np.asarray(u0)
    tol = max(tol, 100 * float(torch.finfo(dtype).eps))
    u, _ = _peikonal_jacobi(
        g, _as(g, u0), _as(g, bdy_mask, torch.bool), _as(g, gvals),
        _as(g, _speed(f, n)), float(p), tol, int(max_num_it),
        int(num_bisection_it), p == 1)
    return u.cpu().numpy().astype(float)
