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
"""

from __future__ import annotations

import torch

from graphlearning_tpu_torch import config


def _norms(X):
    """Column 2-norms, shape (1, k)."""
    return torch.linalg.vector_norm(X, dim=0, keepdim=True)


def _check_inputs(A, X):
    n, k = X.shape
    if k == 0:
        raise ValueError(f"must have search dim > 0, got {k}")
    if k * 5 >= n:
        raise ValueError(
            f"expected search dim * 5 < matrix dim (got {k * 5}, {n})")
    out = A(torch.zeros((n, 1), dtype=X.dtype, device=X.device))
    if out.dtype != X.dtype:
        raise ValueError(
            f"A, X must have same dtypes (were {out.dtype}, {X.dtype})")
    if tuple(out.shape) != (n, 1):
        raise ValueError(
            f"A must be ({n}, {n}) matrix A, got output {tuple(out.shape)}")


def _eigh_ascending(A):
    """``eigh`` of the symmetric part of ``A`` (as ``jnp.linalg.eigh``
    symmetrizes its input), the largest eigenvalue first (JAX's name
    kept)."""
    w, V = torch.linalg.eigh((A + A.T) / 2)
    return w.flip(0), V.flip(1)


def _svqb(X):
    """A truncated orthonormal basis of the columns of ``X``: directions
    of the Gram matrix under ``eps`` of its largest eigenvalue are
    zeroed."""
    norms = _norms(X)
    X = X / torch.where(norms == 0, torch.ones_like(norms), norms)
    inner = X.T @ X
    w, V = _eigh_ascending(inner)
    tau = torch.finfo(X.dtype).eps * w[0]
    padded = torch.maximum(w, tau)
    sqrted = torch.where(tau > 0, padded, torch.ones_like(padded)) ** -0.5
    ortho = X @ (V * sqrted[None, :])
    keep = ((w > tau) & (torch.diagonal(inner) > 0.0))[None, :]
    ortho = ortho * keep.to(ortho.dtype)
    norms = _norms(ortho)
    keep = keep & (norms > 0.0)
    return ortho / torch.where(keep, norms, torch.ones_like(norms))


def _orthonormalize(basis):
    for _ in range(2):
        basis = _svqb(basis)
    return basis


def _project_out(basis, U):
    """The part of ``U`` orthogonal to the orthonormal ``basis`` (zero
    columns allowed), its nonzero columns orthonormal; columns that lose
    more than 1 % of their norm in the last subtractions are zeroed."""
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
        U = _orthonormalize(U)
    for _ in range(2):
        U = U - basis @ (basis.T @ U)
    return U * (_norms(U) >= 0.99).to(U.dtype)


def _rayleigh_ritz_orth(A, S):
    """Eigenpairs of ``S^T A S`` for an orthonormal ``S``, largest
    first."""
    return _eigh_ascending(S.T @ A(S))


def _extend_basis(X, m: int):
    """``m`` columns orthonormal to the orthonormal ``X`` and to each
    other, by a block Householder reflector (deterministic)."""
    n, k = X.shape
    Xupper, Xlower = X[:k], X[k:]
    u, s, vt = torch.linalg.svd(Xupper)
    y = torch.cat([Xupper + u @ vt, Xlower], dim=0)
    other = torch.cat([torch.eye(m, dtype=X.dtype, device=X.device),
                       torch.zeros((n - k - m, m), dtype=X.dtype,
                                   device=X.device)], dim=0)
    w = y @ (vt.T * ((2 * (1 + s)) ** -0.5)[None, :])
    h = -2 * (w @ (w[k:].T @ other))
    h[k:] += other
    return h


def per_pair_tol(tol, X):
    """The ``tol`` to give :func:`lobpcg_standard` so that a pair converges
    when ``|A x - theta x| < 10 t (|A x| + theta)``, ``t`` being ``tol``
    or, when that is 0 or None, the dtype's epsilon: ``t / n``, for the
    ``n`` rows of ``X``.  JAX's rule multiplies by ``n``, which in float32
    on a large graph stops the loop after a step or two: at n = 65536 the
    threshold is about 40 for an operator of norm 256 (the 8th power of
    the normalized one)."""
    n = X.shape[0]
    return (float(tol) if tol else float(torch.finfo(X.dtype).eps)) / n


def lobpcg_standard(A, X, m: int = 100, tol=None):
    """Top-k eigenpairs of the symmetric operator ``A`` (a callable on
    ``(n, j)`` tensors) from the ``(n, k)`` start ``X`` (need not be
    orthonormal; ``5 k < n``).  Returns ``(theta, U, iters)``: the
    eigenvalues (k,), largest first, the eigenvectors (n, k) and the
    number of steps taken."""
    n, k = X.shape
    _check_inputs(A, X)
    if tol is None:
        tol = float(torch.finfo(X.dtype).eps)
    with config.exact_matmul():
        X = _orthonormalize(X)
        P = _extend_basis(X, k)
        AX = A(X)
        theta = torch.sum(X * AX, dim=0)
        R = AX - theta[None, :] * X
        i, converged = 0, 0
        while i < m and converged < k:
            R = _project_out(torch.cat([X, P], dim=1), R)
            XPR = torch.cat([X, P, R], dim=1)
            theta, Q = _rayleigh_ritz_orth(A, XPR)

            B = Q[:, :k]
            B = B / _norms(B)
            X = XPR @ B
            X = X / _norms(X)

            q, _ = torch.linalg.qr(Q[:k, k:].T)
            P = XPR @ (Q[:, k:] @ q)
            normP = _norms(P)
            P = P / torch.where(normP == 0, torch.ones_like(normP), normP)

            AX = A(X)
            R = AX - theta[None, :k] * X
            reltol = (torch.linalg.vector_norm(AX, dim=0) + theta[:k]) * n
            reltol = reltol * 10
            resid = torch.linalg.vector_norm(R, dim=0)
            converged = int(torch.sum(resid < tol * reltol))
            theta = theta[:k]
            i += 1
    return theta, X, i
