"""Multi-RHS conjugate-gradient solvers.

Counterpart of ``graphlearning_tpu/solvers/cg.py:25-156``.  The JAX version
is a ``lax.while_loop``; here the loop is Python with one convergence check
(one host synchronisation) per iteration.

* The constrained (Dirichlet) solve runs masked CG on the full system: the
  operator is ``x -> P L P x`` with ``P`` zeroing labeled rows.
* ``b`` is ``(n, m)``; one operator application serves all m columns.
* Stopping rule: ``||r||_F < tol``, with ``tol`` clamped to what the dtype
  can reach.
* ``reduce``: the sum over the nodes of a sharded solve
  (``parallel.execute.Distributor.reduce``), applied to every dot
  product and norm; None on one device.
* The batched forms (:func:`conjgrad_batched`,
  :func:`constrained_solve_batched`) solve several trials at once, each to
  its own stop, as the JAX package's ``jax.vmap`` of these solvers does.
* Tracing (:mod:`observability`): a solve is a ``cg.solve`` span (its
  ``steps``, ``columns`` and ``trials``), each host read that waits on the
  device a ``cg.wait`` span; ``counters["cg.steps"]`` counts the loop's
  iterations (one product each), ``counters["host_reads"]`` the reads.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from graphlearning_tpu_torch import observability as _obs


def _safe_div(num, den):
    """``num / den`` where ``den > 0``, else 0 (elementwise)."""
    ok = den > 0
    return torch.where(ok, num / torch.where(den == 0, torch.ones_like(den),
                                             den),
                       torch.zeros_like(num))


def _sum(t, reduce):
    return t if reduce is None else reduce(t)


def _read(t, to_host):
    """``to_host(t)``: a host read that waits on the device (``cg.wait``)."""
    with _obs.span("cg.wait"):
        out = to_host(t)
    _obs.counters.add("host_reads")
    return out


def _numpy(t):
    return t.cpu().numpy()


def _norm(r, reduce):
    """``||r||_F``, over every rank's rows with ``reduce``."""
    if reduce is None:
        return _read(torch.linalg.norm(r), float)
    return _read(torch.sqrt(reduce(torch.sum(r * r))), float)


def conjgrad(A: Callable, b, x0=None, max_iter: int = 1000,
             tol: float = 1e-10, M: Optional[Callable] = None,
             reduce: Optional[Callable] = None):
    """Preconditioned CG for an SPD operator ``A`` on ``(n, m)`` tensors;
    ``M`` approximates ``A^{-1}``; ``reduce`` sums over the ranks of a
    sharded solve.  Returns ``(x, iters, residual)``."""
    was_1d = b.dim() == 1
    if was_1d:
        b = b[:, None]
    x = torch.zeros_like(b) if x0 is None else x0.reshape(b.shape).clone()
    if M is None:
        M = lambda r: r

    with _obs.span("cg.solve", columns=b.shape[1], trials=1) as sp:
        r = b - A(x)
        z = M(r)
        p = z
        rz = _sum(torch.sum(r * z, dim=0), reduce)

        # Clamp the tolerance to what the dtype can reach: f64-sized
        # tolerances would otherwise run f32 to max_iter.  The clamp uses
        # the system scale ||b||, not the warm-start residual, so a good x0
        # never tightens it.
        eps = torch.finfo(b.dtype).eps
        tol = max(float(tol), 50.0 * eps * (_norm(b, reduce) + 1.0))

        it = 0
        while it < max_iter and _norm(r, reduce) > tol:
            Ap = A(p)
            pAp = _sum(torch.sum(p * Ap, dim=0), reduce)
            alpha = _safe_div(rz, pAp)
            x = x + alpha[None, :] * p
            r = r - alpha[None, :] * Ap
            z = M(r)
            rz_new = _sum(torch.sum(r * z, dim=0), reduce)
            beta = _safe_div(rz_new, rz)
            p = z + beta[None, :] * p
            rz = rz_new
            it += 1
        res = _norm(r, reduce)
        _obs.counters.add("cg.steps", it)
        sp.set(steps=it)
    if was_1d:
        x = x[:, 0]
    return x, it, res


def constrained_solve(L: Callable, Ldiag, bdy_mask, bdy_values, f=None,
                      max_iter: int = 1000, tol: float = 1e-10, u0=None,
                      reduce: Optional[Callable] = None):
    """Solve ``L u = f`` subject to ``u = bdy_values`` on ``bdy_mask`` by
    masked Jacobi-preconditioned CG.

    ``L``: SPD operator on (n, m) tensors; ``Ldiag``: its (n,) diagonal;
    ``bdy_mask``: (n,) bool, True at labeled nodes; ``bdy_values``: (n, m);
    ``f``: optional (n, m) right-hand side on interior nodes; ``u0``:
    optional warm start (only its interior rows are used); ``reduce``:
    the sum over the ranks of a sharded solve.
    """
    was_1d = bdy_values.dim() == 1
    if was_1d:
        bdy_values = bdy_values[:, None]
    interior = (~bdy_mask)[:, None]
    zero = torch.zeros((), dtype=bdy_values.dtype, device=bdy_values.device)

    g_ext = torch.where(bdy_mask[:, None], bdy_values, zero)
    rhs = -L(g_ext)
    if f is not None:
        rhs = rhs + (f[:, None] if f.dim() == 1 else f)
    rhs = torch.where(interior, rhs, zero)

    def A(x):
        return torch.where(interior, L(torch.where(interior, x, zero)), zero)

    inv_diag = torch.where((~bdy_mask) & (Ldiag != 0),
                           1.0 / torch.where(Ldiag == 0,
                                             torch.ones_like(Ldiag), Ldiag),
                           torch.zeros_like(Ldiag))

    def M(r):
        return inv_diag[:, None] * r

    x0 = None
    if u0 is not None:
        x0 = torch.where(interior, u0[:, None] if u0.dim() == 1 else u0, zero)
    x, iters, res = conjgrad(A, rhs, x0=x0, max_iter=max_iter, tol=tol, M=M,
                             reduce=reduce)
    u = g_ext + torch.where(interior, x, zero)
    if was_1d:
        u = u[:, 0]
    return u, iters, res


def conjgrad_batched(A: Callable, b, max_iter: int = 1000, tol: float = 1e-10,
                     M: Optional[Callable] = None):
    """:func:`conjgrad` on ``T`` systems at once, the trials on the leading
    axis of ``b`` (``(T, n, m)``).  ``A`` acts on ``(n, c)`` tensors column
    by column: the trials are folded into ``c = T m`` columns, so one
    application serves them all.  ``M`` acts on the ``(T, n, m)`` stack.
    Each trial has its own ``alpha`` and ``beta`` (one a column, as in
    :func:`conjgrad`), its own tolerance clamp from its own ``||b||`` and
    its own stopping test; a trial that has stopped is frozen, not stepped
    further (what a vmapped ``lax.while_loop`` does), so its answer is its
    own solve's.  The sums over the nodes run on each trial's contiguous
    block, as :func:`conjgrad` runs them.  Returns ``(x (T, n, m), iters,
    residuals)``, the last two numpy arrays of ``T``."""
    T, n, m = b.shape
    if M is None:
        M = lambda r: r

    def A_stack(P):
        Y = A(P.permute(1, 0, 2).reshape(n, T * m))
        return Y.reshape(n, T, m).permute(1, 0, 2).contiguous()

    def norms(R):
        return torch.linalg.vector_norm(R, dim=(1, 2))

    b = b.contiguous()
    x = torch.zeros_like(b)
    with _obs.span("cg.solve", columns=T * m, trials=T) as sp:
        r = b - A_stack(x)
        z = M(r)
        p = z
        rz = torch.sum(r * z, dim=1)
        eps = torch.finfo(b.dtype).eps
        tols = torch.clamp(50.0 * eps * (norms(b) + 1.0), min=float(tol))

        iters = np.zeros(T, dtype=np.int64)
        steps = 0
        while True:
            active = _read(norms(r) > tols, _numpy) & (iters < max_iter)
            if not active.any():
                break
            on = torch.as_tensor(active, device=b.device)[:, None, None]
            Ap = A_stack(p)
            pAp = torch.sum(p * Ap, dim=1)
            alpha = _safe_div(rz, pAp)[:, None, :]
            x = torch.where(on, x + alpha * p, x)
            r_new = r - alpha * Ap
            z_new = M(r_new)
            rz_new = torch.sum(r_new * z_new, dim=1)
            beta = _safe_div(rz_new, rz)[:, None, :]
            p = torch.where(on, z_new + beta * p, p)
            r = torch.where(on, r_new, r)
            z = torch.where(on, z_new, z)
            rz = torch.where(on[:, 0], rz_new, rz)
            iters += active
            steps += 1
        res = _read(norms(r), _numpy)
        _obs.counters.add("cg.steps", steps)
        sp.set(steps=steps)
    return x, iters, res


def constrained_solve_batched(L: Callable, Ldiag, bdy_masks, bdy_values,
                              max_iter: int = 1000, tol: float = 1e-10):
    """:func:`constrained_solve` of ``T`` trials at once by
    :func:`conjgrad_batched`: ``bdy_masks`` ``(T, n)`` bool, ``bdy_values``
    ``(T, n, m)``; ``L`` acts on ``(n, c)`` tensors column by column, with
    the trials folded into its columns.  Returns ``(u (T, n, m), iters,
    residuals)``."""
    T, n, m = bdy_values.shape
    zero = torch.zeros((), dtype=bdy_values.dtype, device=bdy_values.device)
    interior = (~bdy_masks)[:, :, None]
    fold_L = lambda Y: L(Y.permute(1, 0, 2).reshape(n, T * m)).reshape(
        n, T, m).permute(1, 0, 2)

    g_ext = torch.where(bdy_masks[:, :, None], bdy_values, zero)
    rhs = torch.where(interior, -fold_L(g_ext), zero)
    interior_cols = (~bdy_masks).T.repeat_interleave(m, dim=1)   # (n, T m)

    def A(x):
        return torch.where(interior_cols,
                           L(torch.where(interior_cols, x, zero)), zero)

    inv_diag = torch.where(interior & (Ldiag != 0)[None, :, None],
                           1.0 / torch.where(Ldiag == 0,
                                             torch.ones_like(Ldiag),
                                             Ldiag)[None, :, None], zero)

    def M(r):
        return inv_diag * r

    x, iters, res = conjgrad_batched(A, rhs, max_iter=max_iter, tol=tol, M=M)
    return g_ext + torch.where(interior, x, zero), iters, res
