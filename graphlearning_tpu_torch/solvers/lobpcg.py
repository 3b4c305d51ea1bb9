"""LOBPCG for the top-k eigenpairs of a symmetric operator.

The torch counterpart of ``lobpcg_standard`` of JAX's
``jax/experimental/sparse/linalg.py`` (its callable form), which the JAX
package's ``solvers/eig.py`` calls.  That code is Copyright 2022 The JAX
Authors and licensed under the Apache License, Version 2.0
(https://www.apache.org/licenses/LICENSE-2.0); this module follows it step
for step: an orthonormal block ``[X, P, R]`` kept by SVQB, the residuals
projected out of ``[X, P]`` twice and twice again, a Rayleigh-Ritz solve a
step, the search directions ``P`` from the QR of the Ritz vectors' upper
block, and no locking.  A pair is converged when its residual norm is
below ``tol * 10 * n * (|A x| + theta)``, ``tol`` the dtype's epsilon by
default; the loop ends when all ``k`` are, or after ``m`` steps.

The JAX loop is a ``lax.while_loop``; here it is Python with one host read
of the converged count a step.  Every product runs in full f32 precision
(:func:`config.exact_matmul`), as JAX's run at ``Precision.HIGHEST``.

On a mesh (``parallel.execute``) ``X`` is a rank's rows of the block:
every product over the rows (the Gram matrices, the projections, the
Rayleigh-Ritz matrix, the column norms) goes through ``reduce``, a sum
over the ranks, and everything of size k x k stays the same on every
rank, so every rank takes the same steps.  ``row0`` places the rank's rows
in the global block (the basis extension reads its first rows) and ``n``
is the global row count.  The mesh runs the one-device formulas (an SVQB
reduces its column norms and its Gram matrix apart), so a one-rank solve
follows the one-device arithmetic: norms taken from one reduced Gram
matrix round otherwise, and move this float32 solve's steps.
"""

from __future__ import annotations

import torch

from graphlearning_tpu_torch import config


def _identity(t):
    return t


def _norms(X, reduce=None):
    """Column 2-norms, shape (1, k) (a vector's 2-norm, shape (1,)); over
    the ranks with ``reduce``."""
    if reduce is None:
        return torch.linalg.vector_norm(X, dim=0, keepdim=True)
    return torch.sqrt(reduce(torch.sum(X * X, dim=0, keepdim=True)))


def _check_inputs(A, X, n):
    rows, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(
            f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    out = A(torch.zeros((rows, 1), dtype=X.dtype, device=X.device))
    if out.dtype != X.dtype:
        raise ValueError(
            f"A, X must have same dtypes (were {out.dtype}, {X.dtype})")
    if tuple(out.shape) != (rows, 1):
        raise ValueError(
            f"A must be ({n}, {n}) matrix A, got output {tuple(out.shape)}")


def _eigh_ascending(A):
    """``eigh`` of the symmetric part of ``A`` (as ``jnp.linalg.eigh``
    symmetrizes its input), the largest eigenvalue first (JAX's name
    kept)."""
    w, V = torch.linalg.eigh((A + A.T) / 2)
    return w.flip(0), V.flip(1)


def _svqb(X, reduce=None):
    """A truncated orthonormal basis of the columns of ``X``: directions
    of the Gram matrix under ``eps`` of its largest eigenvalue are
    zeroed."""
    norms = _norms(X, reduce)
    X = X / torch.where(norms == 0, torch.ones_like(norms), norms)
    inner = (reduce or _identity)(X.T @ X)
    w, V = _eigh_ascending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, torch.ones_like(padded)) ** -0.5
    ortho = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    ortho = ortho * keep.to(ortho.dtype)
    norms = _norms(ortho, reduce)
    keep = keep & (norms > 0.0)
    return ortho / torch.where(keep, norms, torch.ones_like(norms))


def _orthonormalize(basis, reduce=None):
    for _ in range(2):
        basis = _svqb(basis, reduce)
    return basis


def _project_out(basis, U, reduce=None):
    """The part of ``U`` orthogonal to the orthonormal ``basis`` (zero
    columns allowed), its nonzero columns orthonormal; columns that lose
    more than 1 % of their norm in the last subtractions are zeroed."""
    red = reduce or _identity
    for _ in range(2):
        U = U - basis @ red(basis.T @ U)
        U = _orthonormalize(U, reduce)
    for _ in range(2):
        U = U - basis @ red(basis.T @ U)
    return U * (_norms(U, reduce) >= 0.99).to(U.dtype)


def _rayleigh_ritz_orth(A, S, reduce=None):
    """Eigenpairs of ``S^T A S`` for an orthonormal ``S``, largest
    first."""
    return _eigh_ascending((reduce or _identity)(S.T @ A(S)))


def _global_rows(X, lo: int, hi: int, row0: int, reduce):
    """Rows ``[lo, hi)`` of the global block whose rows ``[row0, row0 +
    len(X))`` are ``X``, the same on every rank: ``(those rows, the mask
    of X's rows that lie in [lo, hi), X's global rows)``."""
    rows = torch.arange(row0, row0 + X.shape[0], device=X.device)
    sel = (rows >= lo) & (rows < hi)
    out = X.new_zeros((hi - lo,) + X.shape[1:])
    out[rows[sel] - lo] = X[sel]
    return reduce(out), sel, rows


def _extend_basis(X, m: int, reduce=None, row0: int = 0):
    """``m`` columns orthonormal to the orthonormal ``X`` and to each
    other, by a block Householder reflector (deterministic).  The
    reflector reads the global block's first ``k + m`` rows."""
    k = X.shape[1]
    red = reduce or _identity
    Xupper, sel, rows = _global_rows(X, 0, k, row0, red)
    u, s, vt = torch.linalg.svd(Xupper)
    y = X.clone()
    y[sel] = (Xupper + u @ vt)[rows[sel]]
    w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    wk, sel, rows = _global_rows(w, k, k + m, row0, red)
    h = -2 * (w @ wk.T)
    eye = torch.eye(m, dtype=X.dtype, device=X.device)
    h[sel] += eye[rows[sel] - k]
    return h


def per_pair_tol(tol, X, n=None):
    """The ``tol`` to give :func:`lobpcg_standard` so that a pair converges
    when ``|A x - theta x| < 10 t (|A x| + theta)``, ``t`` being ``tol``
    or, when that is 0 or None, the dtype's epsilon: ``t / n``, for the
    ``n`` rows of ``X`` (the global row count on a mesh).  JAX's rule
    multiplies by ``n``, which in float32 on a large graph stops the loop
    after a step or two: at n = 65536 the threshold is about 40 for an
    operator of norm 256 (the 8th power of the normalized one)."""
    n = X.shape[0] if n is None else n
    return (float(tol) if tol else float(torch.finfo(X.dtype).eps)) / n


def lobpcg_standard(A, X, m: int = 100, tol=None, reduce=None, row0=0,
                    n=None):
    """Top-k eigenpairs of the symmetric operator ``A`` (a callable on
    ``(n, j)`` tensors) from the ``(n, k)`` start ``X`` (need not be
    orthonormal; ``5 k < n``).  On a mesh ``X`` is the rank's rows,
    global rows ``row0`` on, of ``n`` rows in all, and ``reduce`` sums
    over the ranks.  Returns ``(theta, U, iters)``: the eigenvalues (k,),
    largest first, the eigenvectors (the rank's rows) and the number of
    steps taken."""
    k = X.shape[1]
    n = X.shape[0] if n is None else int(n)
    red = reduce or _identity
    _check_inputs(A, X, n)
    if tol is None:
        tol = float(torch.finfo(X.dtype).eps)
    with config.exact_matmul():
        X = _orthonormalize(X, reduce)
        P = _extend_basis(X, k, reduce, row0)
        AX = A(X)
        theta = red(torch.sum(X * AX, dim=0))
        R = AX - theta[None, :] * X
        i, converged = 0, 0
        while i < m and converged < k:
            R = _project_out(torch.cat([X, P], dim=1), R, reduce)
            XPR = torch.cat([X, P, R], dim=1)
            theta, Q = _rayleigh_ritz_orth(A, XPR, reduce)

            B = Q[:, :k]
            B = B / _norms(B)
            X = XPR @ B
            X = X / _norms(X, reduce)

            q, _ = torch.linalg.qr(Q[:k, k:].T)
            P = XPR @ (Q[:, k:] @ q)
            normP = _norms(P, reduce)
            P = P / torch.where(normP == 0, torch.ones_like(normP), normP)

            AX = A(X)
            R = AX - theta[None, :k] * X
            reltol = (_norms(AX, reduce)[0] + theta[:k]) * n
            reltol = reltol * 10
            resid = _norms(R, reduce)[0]
            converged = int(torch.sum(resid < tol * reltol))
            theta = theta[:k]
            i += 1
    return theta, X, i
