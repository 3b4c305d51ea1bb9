"""Restarted GMRES with Givens rotations (the counterpart of
``jax.scipy.sparse.linalg.gmres(solve_method="incremental")``, which the
JAX package's ``utils.constrained_solve_gmres`` calls; torch has no GMRES).

The steps are JAX's, in its order, so that the two stop at the same step:

* the residual is preconditioned, ``M (b - A x)``, everywhere;
* ``atol = max(tol ||b||, atol)`` ends the restarts and ``ptol = ||M b||
  min(1, atol / ||b||)`` ends the Arnoldi steps inside one;
* each Arnoldi vector is orthogonalised by classical Gram-Schmidt,
  repeated once where the first pass's overlaps are small against the
  remainder (JAX's ``_iterative_classical_gram_schmidt``), and
  normalised to zero below ``eps`` times its norm before the projection;
* a norm at or under the dtype's ``eps`` counts as 0 (``_safe_normalize``).

The vectors stay on ``b``'s device in its dtype; the small Hessenberg
quantities (the rotations, the rotated right-hand side, the triangle) are
host float64.  ``b`` may have any shape: the operator sees ``b``'s shape
and the solver works on the flattened vector.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.linalg
import torch

from graphlearning_tpu_torch import config


def _norm(x) -> float:
    return float(torch.sqrt(torch.sum(x * x)))


def _safe_norm(x, thresh=None) -> float:
    """``||x||``, or 0 where it is at most ``thresh`` (the dtype's eps by
    default)."""
    norm = _norm(x)
    return norm if norm > (torch.finfo(x.dtype).eps if thresh is None
                           else thresh) else 0.0


def _safe_normalize(x, thresh=None):
    """``(x / ||x||, ||x||)``, or zeros and 0 where :func:`_safe_norm` is
    0."""
    norm = _safe_norm(x, thresh)
    return (x / norm, norm) if norm else (torch.zeros_like(x), 0.0)


def _gram_schmidt(V, q):
    """``q`` orthogonalised against the rows of ``V``, and its overlaps:
    a second pass when the overlaps' norm is under ``||q|| / sqrt 2``
    after the first (JAX's test, two passes at most)."""
    h = V @ q
    q = q - V.T @ h
    r = h
    if _safe_norm(r) < _safe_norm(q) / math.sqrt(2.0):
        h = V @ q
        q = q - V.T @ h
        r = r + h
    return q, r


def _rotate(H, i, cs, sn):
    x1, y1 = H[i], H[i + 1]
    H[i] = cs * x1 - sn * y1
    H[i + 1] = sn * x1 + cs * y1


def _givens(a, b):
    if b == 0:
        return 1.0, 0.0
    if abs(a) < abs(b):
        t = -a / b
        r = 1.0 / math.sqrt(1.0 + t * t)
        return r * t, r
    t = -b / a
    r = 1.0 / math.sqrt(1.0 + t * t)
    return r, r * t


def _restart(A, M, b, x, unit_residual, residual_norm, ptol, restart, info):
    """One restart: up to ``restart`` Arnoldi steps, each ending the
    restart once the rotated residual is under ``ptol``.  Returns the new
    ``(x, unit_residual, residual_norm)``."""
    V = torch.zeros((restart + 1, b.numel()), dtype=b.dtype,
                    device=b.device)
    V[0] = unit_residual
    R = np.eye(restart, restart + 1)
    givens = np.zeros((restart, 2))
    beta = np.zeros(restart + 1)
    beta[0] = residual_norm
    eps = torch.finfo(b.dtype).eps
    k, err = 0, residual_norm
    while k < restart and err > ptol:
        v = M(A(V[k]))
        v_norm_0 = _safe_norm(v)
        v, h = _gram_schmidt(V, v)
        unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
        V[k + 1] = unit_v
        row = h.double().cpu().numpy().copy()
        row[k + 1] = v_norm_1
        for i in range(k):
            _rotate(row, i, *givens[i])
        givens[k] = _givens(row[k], row[k + 1])
        _rotate(row, k, *givens[k])
        R[k] = row
        _rotate(beta, k, *givens[k])
        err = abs(beta[k + 1])
        k += 1
        info["steps"] += 1
    y = scipy.linalg.solve_triangular(R[:, :-1].T, beta[:-1])
    dx = torch.as_tensor(y, dtype=b.dtype, device=b.device) @ V[:-1]
    x = x + dx
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)))
    return x, unit_residual, residual_norm


def gmres(A, b, x0=None, tol=1e-5, atol=0.0, restart=20, maxiter=None,
          M=None, info=None):
    """Solve ``A x = b`` by restarted GMRES (the incremental form).  ``A``
    and ``M`` (the preconditioner, an approximate inverse; the identity by
    default) act on tensors of ``b``'s shape.  ``maxiter`` bounds the
    restarts (``10 b.numel()`` by default, as JAX and scipy).  ``info``,
    when given, gets the restarts ("restarts"), the Arnoldi steps
    ("steps", each one application of ``A``) and the last preconditioned
    residual norm ("residual").  Returns ``x``."""
    shape = b.shape
    Af = lambda v: A(v.reshape(shape)).reshape(-1)
    Mf = (lambda v: v) if M is None else (
        lambda v: M(v.reshape(shape)).reshape(-1))
    b = b.reshape(-1)
    x = torch.zeros_like(b) if x0 is None else x0.reshape(-1).to(b)
    size = b.numel()
    if maxiter is None:
        maxiter = 10 * size
    restart = min(restart, size)
    if info is None:
        info = {}
    info.update(restarts=0, steps=0)

    with config.exact_matmul():
        b_norm = _norm(b)
        atol = max(tol * b_norm, atol)
        ptol = _norm(Mf(b)) * min(1.0, atol / b_norm)
        unit_residual, residual_norm = _safe_normalize(Mf(b - Af(x)))
        while info["restarts"] < maxiter and residual_norm > atol:
            x, unit_residual, residual_norm = _restart(
                Af, Mf, b, x, unit_residual, residual_norm, ptol, restart,
                info)
            info["restarts"] += 1
    info["residual"] = residual_norm
    return x.reshape(shape)
