"""Game-theoretic p-Laplace and infinity-Laplace (AMLE) solvers
(counterpart of ``graphlearning_tpu/solvers/plaplace.py``).

* ``_lp_iterate``: two-sided (upper/lower) relaxation of the
  game-theoretic p-Laplacian ``(alpha/deg) sum w grad u + delta (min +
  max)`` until the sandwich closes.
* ``_lip_iterate``: the iteration ``u <- alpha avg + beta (min + max)/2``
  (unweighted AMLE for alpha = 0, the fast p-Laplace otherwise).
* ``_lip_iterate_weighted``: a 30-step bisection per node on
  ``min_j w (t - u_j) + max_j w (t - u_j) = 0``.

All are Jacobi rounds over every node, each testing its tolerance every
round.  A Jacobi round of this nonexpansive map can settle into a 2-cycle
straddling the fixed point, so the Lipschitz iterations also stop when an
iterate repeats the one two rounds back, and never before 20 rounds.  The
``_mc`` variants solve the C one-vs-rest problems of the SSL models as one
(n, C) iteration; the ``_bucketed`` ones run on :class:`BucketedELL`.

On a band-friendly graph ``plaplace_mc`` and ``amle_mc`` (unweighted) take
the band path instead: a harmonic warm start by masked CG on the packed
band (:func:`_laplace_init`, kernel K2), then block-Gauss-Seidel sweeps
over the rectangular band (:meth:`AccelSpMM.lip_gs_mc`, built by K4).
Without it they start from the geodesic Voronoi labels (:func:`_voronoi_init`,
on the band by K7 when a band is given).

The ``_mc`` Jacobi rounds gather through ``ops.graphops.neighbor_take``
and take a ``reduce`` for their stop test (the largest change over the
ranks), so they run unchanged on a rank's rows of a sharded graph
(``parallel.execute.lip_fit_sharded``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from graphlearning_tpu_torch.core.sparse import BucketedELL, SparseGraph
from graphlearning_tpu_torch.ops import graphops as _ops
from graphlearning_tpu_torch.ops.graphops import neighbor_take
from graphlearning_tpu_torch.solvers.eikonal import (_as, _boundary_handling,
                                                     dijkstra)


def _eps_floor(dtype) -> float:
    return 100 * float(torch.finfo(dtype).eps)


def _lip_loop(step, u0, bdy_mask, gvals, tol, max_iter: int, reduce=None):
    """``u <- where(bdy, gvals, step(u))`` with the period-2 stop: until
    ``min(max|u_new - u|, max|u_new - u_prev|) <= tol`` after at least 21
    rounds, or ``max_iter`` rounds; the maxima over the ranks with
    ``reduce``.  Returns ``(u, rounds)``."""
    u = torch.where(bdy_mask, gvals, u0)
    u_prev = u
    err, it = float("inf"), 0
    while (err > tol or it <= 20) and it < max_iter:
        u_new = torch.where(bdy_mask, gvals, step(u))
        du = torch.stack([torch.max(torch.abs(u_new - u)),
                          torch.max(torch.abs(u_new - u_prev))])
        if reduce is not None:
            du = reduce(du, "max")
        err = float(torch.min(du))
        u_prev, u = u, u_new
        it += 1
    return u, it


def _lp_iterate(g: SparseGraph, uu0, ul0, bdy_mask, gvals, p, tol,
                max_iter: int):
    """Upper and lower game-theoretic p-Laplace iterates until
    ``max(uu - ul) <= tol`` (after at least 11 rounds).  Returns
    ``(uu, ul, rounds)``."""
    mask = g.mask()
    alpha = 1.0 / p
    delta = 1.0 - 2.0 / p
    dt = 0.9 / (alpha + 2.0 * abs(delta)) / torch.max(g.vals)
    wsum = torch.sum(torch.where(mask, g.vals, 0.0), dim=1)
    invdeg = alpha / wsum
    cols = g.cols.long()

    def step_one(u):
        e = torch.where(mask, g.vals * (u[cols] - u[:, None]), 0.0)
        minw = torch.clamp(torch.amin(e, dim=1), max=0.0)
        maxw = torch.clamp(torch.amax(e, dim=1), min=0.0)
        return u + dt * (invdeg * torch.sum(e, dim=1) + delta * (minw + maxw))

    uu = torch.where(bdy_mask, gvals, uu0)
    ul = torch.where(bdy_mask, gvals, ul0)
    err, it = float("inf"), 0
    while (err > tol or it <= 10) and it < max_iter:
        uu = torch.where(bdy_mask, gvals, step_one(uu))
        ul = torch.where(bdy_mask, gvals, step_one(ul))
        err = float(torch.max(uu - ul))
        it += 1
    return uu, ul, it


def _lip_iterate(g: SparseGraph, u0, bdy_mask, gvals, alpha, beta, tol,
                 max_iter: int):
    """Returns ``(u, rounds)``."""
    mask = g.mask()
    big = torch.finfo(u0.dtype).max
    wsum = torch.sum(torch.where(mask, g.vals, 0.0), dim=1)
    cols = g.cols.long()

    def step(u):
        un = u[cols]
        sumu = torch.sum(torch.where(mask, g.vals * un, 0.0), dim=1)
        minu = torch.amin(torch.where(mask, un, big), dim=1)
        maxu = torch.amax(torch.where(mask, un, -big), dim=1)
        return alpha * sumu / wsum + beta * 0.5 * (minu + maxu)

    return _lip_loop(step, u0, bdy_mask, gvals, tol, max_iter)


def _bisect_lip(a, b, slope, num_bisection_it: int, spill=None):
    """Bisection of ``min_j w (t - u_j) + max_j w (t - u_j) = 0`` on
    ``[a, b]``; ``slope(t)`` gives the masked ``w (t - u_j)`` terms over
    the slot axis 1, ``spill(t)`` (optional) the extra per-row min and
    max.  Both extremes count 0 (the reference starts them there)."""
    for _ in range(num_bisection_it):
        t = 0.5 * (a + b)
        e = slope(t)
        minw = torch.clamp(torch.amin(e, dim=1), max=0.0)
        maxw = torch.clamp(torch.amax(e, dim=1), min=0.0)
        if spill is not None:
            smin, smax = spill(t)
            minw = torch.minimum(minw, smin)
            maxw = torch.maximum(maxw, smax)
        pos = (minw + maxw) > 0
        a, b = torch.where(pos, a, t), torch.where(pos, t, b)
    return 0.5 * (a + b)


def _lip_iterate_weighted(g: SparseGraph, u0, bdy_mask, gvals, tol,
                          max_iter: int, num_bisection_it: int = 30):
    """Returns ``(u, rounds)``."""
    mask = g.mask()
    big = torch.finfo(u0.dtype).max
    cols = g.cols.long()

    def step(u):
        un = u[cols]
        a = torch.amin(torch.where(mask, un, big), dim=1)
        b = torch.amax(torch.where(mask, un, -big), dim=1)
        return _bisect_lip(
            a, b, lambda t: torch.where(mask, g.vals * (t[:, None] - un), 0.0),
            num_bisection_it)

    return _lip_loop(step, u0, bdy_mask, gvals, tol, max_iter)


def _prep(g: SparseGraph, bdy_set, bdy_val):
    bdy_set, bdy_val_arr = _boundary_handling(bdy_set, bdy_val)
    bdy_mask = np.zeros(g.n, dtype=bool)
    bdy_mask[bdy_set] = True
    gvals = np.zeros(g.n)
    gvals[bdy_set] = bdy_val_arr
    return _as(g, bdy_mask, torch.bool), gvals, bdy_val_arr


def plaplace(g: SparseGraph, bdy_set, bdy_val, p, max_num_it=10**6, tol=1e-1,
             fast=True):
    """Game-theoretic p-Laplace interpolation: ``fast`` runs the
    unweighted Lipschitz iteration with alpha = 1/(p-1); otherwise the
    two-sided upper/lower sandwich."""
    dtype = g.vals.dtype
    bdy_mask, gvals, bdy_val_arr = _prep(g, bdy_set, bdy_val)
    if fast:
        alpha = 1.0 / (p - 1.0)
        u, _ = _lip_iterate(g, _as(g, np.zeros(g.n)), bdy_mask, _as(g, gvals),
                            alpha, 1.0 - alpha, max(1e-6, _eps_floor(dtype)),
                            int(max_num_it))
        return u.cpu().numpy().astype(float)
    uu, ul, _ = _lp_iterate(
        g, _as(g, np.full(g.n, bdy_val_arr.max())),
        _as(g, np.full(g.n, bdy_val_arr.min())), bdy_mask, _as(g, gvals),
        float(p), max(tol, _eps_floor(dtype)), int(max_num_it))
    return ((uu + ul) / 2).cpu().numpy().astype(float)


def amle(g: SparseGraph, bdy_set, bdy_val, tol=1e-5, max_num_it=1000,
         weighted=True):
    """Absolutely minimal Lipschitz extension: the graph infinity-Laplace
    equation."""
    bdy_mask, gvals, _ = _prep(g, bdy_set, bdy_val)
    tol = max(tol, _eps_floor(g.vals.dtype))
    u0 = _as(g, np.zeros(g.n))
    if weighted:
        u, _ = _lip_iterate_weighted(g, u0, bdy_mask, _as(g, gvals), tol,
                                     int(max_num_it))
    else:
        u, _ = _lip_iterate(g, u0, bdy_mask, _as(g, gvals), 0.0, 1.0, tol,
                            int(max_num_it))
    return u.cpu().numpy().astype(float)


# -- multi-class (one-vs-rest batched) variants ----------------------------


def _lip_iterate_mc(g: SparseGraph, u0, bdy_mask, gvals, alpha, beta, tol,
                    max_iter: int, reduce=None):
    """(n, C) batched :func:`_lip_iterate`; ``bdy_mask`` is (n,).
    Returns ``(u, rounds)``."""
    mask = g.mask()[:, :, None]
    big = torch.finfo(u0.dtype).max
    wsum = torch.sum(torch.where(g.mask(), g.vals, 0.0), dim=1)[:, None]
    w3 = g.vals[:, :, None]

    def step(u):
        un = neighbor_take(g, u)                         # (n, k, C)
        sumu = torch.sum(torch.where(mask, w3 * un, 0.0), dim=1)
        minu = torch.amin(torch.where(mask, un, big), dim=1)
        maxu = torch.amax(torch.where(mask, un, -big), dim=1)
        return alpha * sumu / wsum + beta * 0.5 * (minu + maxu)

    return _lip_loop(step, u0, bdy_mask[:, None], gvals, tol, max_iter,
                     reduce)


def _lip_iterate_weighted_mc(g: SparseGraph, u0, bdy_mask, gvals, tol,
                             max_iter: int, num_bisection_it: int = 30,
                             reduce=None):
    """(n, C) batched :func:`_lip_iterate_weighted`.  Returns
    ``(u, rounds)``."""
    mask = g.mask()[:, :, None]
    big = torch.finfo(u0.dtype).max
    w3 = g.vals[:, :, None]

    def step(u):
        un = neighbor_take(g, u)
        a = torch.amin(torch.where(mask, un, big), dim=1)
        b = torch.amax(torch.where(mask, un, -big), dim=1)
        return _bisect_lip(
            a, b, lambda t: torch.where(mask, w3 * (t[:, None, :] - un), 0.0),
            num_bisection_it)

    return _lip_loop(step, u0, bdy_mask[:, None], gvals, tol, max_iter,
                     reduce)


def _lip_iterate_mc_bucketed(b: BucketedELL, u0, bdy_mask, gvals, alpha,
                             beta, tol, max_iter: int):
    """(n, C) Lipschitz iteration on the ELL + COO hybrid: the main gather
    is ``n * kcap`` slots and the hub tails reduce per row.  Returns
    ``(u, rounds)``."""
    g = b.main
    mask = g.mask()[:, :, None]
    big = torch.finfo(u0.dtype).max
    wsum = (torch.sum(torch.where(g.mask(), g.vals, 0.0), dim=1)
            + b.spill_reduce(b.sp_vals, "sum", 0.0))[:, None]
    w3 = g.vals[:, :, None]
    cols = g.cols.long()

    def step(u):
        un = u[cols]                                     # (n, kcap, C)
        sumu = torch.sum(torch.where(mask, w3 * un, 0.0), dim=1)
        minu = torch.amin(torch.where(mask, un, big), dim=1)
        maxu = torch.amax(torch.where(mask, un, -big), dim=1)
        usp = u[b.sp_cols]                               # (m_pad, C)
        sumu = sumu + b.spill_reduce(b.sp_vals[:, None] * usp, "sum", 0.0)
        minu = torch.minimum(minu, b.spill_reduce(usp, "min", big))
        maxu = torch.maximum(maxu, b.spill_reduce(usp, "max", -big))
        return alpha * sumu / wsum + beta * 0.5 * (minu + maxu)

    return _lip_loop(step, u0, bdy_mask[:, None], gvals, tol, max_iter)


def _lip_iterate_weighted_mc_bucketed(b: BucketedELL, u0, bdy_mask, gvals,
                                      tol, max_iter: int,
                                      num_bisection_it: int = 30):
    """(n, C) weighted AMLE bisection on the ELL + COO hybrid.  Returns
    ``(u, rounds)``."""
    g = b.main
    mask = g.mask()[:, :, None]
    big = torch.finfo(u0.dtype).max
    w3 = g.vals[:, :, None]
    cols = g.cols.long()
    # padding spill slots carry row n: read row n - 1 for them (their
    # results reduce into the dropped row n)
    sp_rows = b.sp_rows.clamp(max=g.n - 1)

    def step(u):
        un = u[cols]                                     # (n, kcap, C)
        usp = u[b.sp_cols]                               # (m_pad, C)
        a = torch.amin(torch.where(mask, un, big), dim=1)
        bb = torch.amax(torch.where(mask, un, -big), dim=1)
        spill = None
        if b.m > 0:
            a = torch.minimum(a, b.spill_reduce(usp, "min", big))
            bb = torch.maximum(bb, b.spill_reduce(usp, "max", -big))

            def spill(t):
                esp = b.sp_vals[:, None] * (t[sp_rows] - usp)
                return (b.spill_reduce(esp, "min", 0.0),
                        b.spill_reduce(esp, "max", 0.0))

        return _bisect_lip(
            a, bb, lambda t: torch.where(mask, w3 * (t[:, None, :] - un), 0.0),
            num_bisection_it, spill)

    return _lip_loop(step, u0, bdy_mask[:, None], gvals, tol, max_iter)


def _laplace_init(accel, g: SparseGraph, bdy_mask, gvals, tol=1e-3):
    """Harmonic warm start of the Lipschitz iterations on the band: a
    masked CG Laplace solve on the packed band (K2).  Jacobi's slow modes
    are the smooth, global ones, which this solve settles.  Returns the
    (n, C) start in original order and the CG iterations."""
    deg_p = accel.to_perm(_ops.degree_vector(g))
    diag_p = accel.to_perm(_ops.laplacian_diag(g), fill=1.0)
    u, iters = accel.laplace_constrained(
        deg_p, diag_p, torch.zeros_like(deg_p),
        accel.to_perm(_as(g, bdy_mask, torch.int32)) > 0,
        accel.to_perm(_as(g, gvals)), tol)
    return accel.from_perm(u), iters


def _voronoi_init(g: SparseGraph, bdy_set, bdy_vals, accel=None):
    """Closest-labeled-point warm start of the Lipschitz iterations: each
    node takes the boundary values of its geodesically closest boundary
    node (on the band by K7 when ``accel`` is given)."""
    _, cp = dijkstra(g, bdy_set, bdy_val=np.zeros(len(bdy_set)),
                     return_cp=True, accel=accel)
    return voronoi_values(cp, bdy_set, bdy_vals)


def voronoi_values(cp, bdy_set, bdy_vals):
    """Each node's values from its closest boundary node ``cp`` (-1 where
    none: zeros), ``bdy_vals`` (m, ...) those of ``bdy_set``."""
    n = len(cp)
    val_of = np.zeros((n,) + bdy_vals.shape[1:])
    pos_in_bdy = -np.ones(n, dtype=int)
    pos_in_bdy[np.asarray(bdy_set)] = np.arange(len(bdy_set))
    src = pos_in_bdy[np.maximum(cp, 0)]
    ok = (cp >= 0) & (src >= 0)
    val_of[ok] = bdy_vals[src[ok]]
    return val_of


def _mc_setup(g: SparseGraph, bdy_set, bdy_vals):
    bdy_set = np.asarray(bdy_set)
    bdy_vals = np.asarray(bdy_vals, dtype=float)
    bdy_mask = np.zeros(g.n, dtype=bool)
    bdy_mask[bdy_set] = True
    gvals = np.zeros((g.n, bdy_vals.shape[1]))
    gvals[bdy_set] = bdy_vals
    return bdy_set, bdy_vals, bdy_mask, gvals


def _band_lip(accel, g, bdy_mask, gvals, alpha, beta, tol, max_num_it, info):
    """The band path of the one-vs-rest Lipschitz fits: harmonic warm
    start (K2), then block-Gauss-Seidel sweeps (K4's band)."""
    u0, cg_iters = _laplace_init(accel, g, bdy_mask, gvals)
    t0 = time.perf_counter()
    u, sweeps = accel.lip_gs_mc(u0, bdy_mask, gvals, alpha, beta,
                                max(tol, 1e-5), int(max_num_it))
    if info is not None:
        # lip_gs_mc reads its error on the host every sweep, so the host
        # clock closes on the device's work
        info.update(iters=sweeps, init_iters=cg_iters, path="band",
                    sweep_seconds=time.perf_counter() - t0)
    return u.cpu().numpy().astype(float)


def _use_band(accel, C: int) -> bool:
    return (accel is not None and accel.materialize and C <= 32
            and accel.rect_band_ok())


def plaplace_mc(g: SparseGraph, bdy_set, bdy_vals, p, max_num_it=10**6,
                tol=1e-1, fast=True, accel=None, bucketed=None, info=None):
    """One-vs-rest batched p-Laplace: ``bdy_vals`` is (m, C), one column
    per class, solved jointly (the ``fast`` iteration; otherwise one
    sandwich per class).  ``info``, a dict, receives the rounds or sweeps
    run and the path taken."""
    dtype = g.vals.dtype
    bdy_set, bdy_vals, bdy_mask, gvals = _mc_setup(g, bdy_set, bdy_vals)
    C = bdy_vals.shape[1]
    if not fast:
        return np.stack([
            plaplace(g, bdy_set, bdy_vals[:, c], p, max_num_it=max_num_it,
                     tol=tol, fast=False) for c in range(C)], axis=1)
    alpha = 1.0 / (p - 1.0)
    beta = 1.0 - alpha
    # the caller's tolerance; the default 1e-1 belongs to the sandwich and
    # maps to 1e-5 here
    tol_fast = max(tol if tol < 1e-1 else 1e-5, _eps_floor(dtype))
    if _use_band(accel, C):
        return _band_lip(accel, g, bdy_mask, gvals, alpha, beta, tol_fast,
                         max_num_it, info)
    u0 = _voronoi_init(g, bdy_set, bdy_vals, accel=accel)
    args = (_as(g, u0), _as(g, bdy_mask, torch.bool), _as(g, gvals), alpha,
            beta, tol_fast, int(max_num_it))
    if bucketed is not None and g.k > 1.5 * bucketed.kcap:
        # degree-skewed ELL: hub rows pad every gather
        u, rounds = _lip_iterate_mc_bucketed(bucketed, *args)
    else:
        u, rounds = _lip_iterate_mc(g, *args)
    if info is not None:
        info.update(iters=rounds, path="plain")
    return u.cpu().numpy().astype(float)


def amle_mc(g: SparseGraph, bdy_set, bdy_vals, tol=1e-5, max_num_it=10**5,
            weighted=True, accel=None, bucketed=None, info=None):
    """One-vs-rest batched AMLE: ``bdy_vals`` is (m, C).  ``info`` as in
    :func:`plaplace_mc`."""
    dtype = g.vals.dtype
    bdy_set, bdy_vals, bdy_mask, gvals = _mc_setup(g, bdy_set, bdy_vals)
    C = bdy_vals.shape[1]
    tol = max(tol, _eps_floor(dtype))
    if not weighted and _use_band(accel, C):
        return _band_lip(accel, g, bdy_mask, gvals, 0.0, 1.0, tol,
                         max_num_it, info)
    u0 = _voronoi_init(g, bdy_set, bdy_vals, accel=accel)
    skewed = bucketed is not None and g.k > 1.5 * bucketed.kcap
    head = (_as(g, u0), _as(g, bdy_mask, torch.bool), _as(g, gvals))
    if weighted:
        fn = (_lip_iterate_weighted_mc_bucketed if skewed
              else _lip_iterate_weighted_mc)
        u, rounds = fn(bucketed if skewed else g, *head, tol,
                       int(max_num_it))
    else:
        fn = _lip_iterate_mc_bucketed if skewed else _lip_iterate_mc
        u, rounds = fn(bucketed if skewed else g, *head, 0.0, 1.0, tol,
                       int(max_num_it))
    if info is not None:
        info.update(iters=rounds, path="plain")
    return u.cpu().numpy().astype(float)
