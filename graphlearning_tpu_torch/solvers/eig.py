"""The low-lying spectrum of graph Laplacians (counterpart of
``graphlearning_tpu/solvers/eig.py``).

* ``exact``: LOBPCG (:mod:`solvers.lobpcg`) on a shifted operator whose
  top-k eigenpairs are the Laplacian's smallest k, ``I + D^-1/2 W D^-1/2``
  for the normalized and randomwalk Laplacians, ``M I - L`` with ``M = 2
  max(deg)`` for the combinatorial one.  In float32 LOBPCG runs on the
  operator's 8th power (:func:`_default_power`), which widens the relative
  gaps at the top; eigenvalues come back as Rayleigh quotients of the
  unpowered operator.
* ``lowrank``: a randomized SVD (:func:`utils.randomized_svd`) of the
  normalized adjacency, ``vals = 1 - s``.

The randomwalk eigenvectors are the normalized ones times ``D^-1/2``.  The
random starts come from a ``torch.Generator`` (seeded as the JAX package
seeds its keys), or are given as ``X0``; the band and the gather start
from the plain path's draw, mapped to their permuted space.

Two departures from the JAX package:

* In float32 ``tol`` is per pair and free of ``n``
  (``lobpcg.per_pair_tol``); float64 keeps JAX's rule, ``tol`` times
  ``10 n (|A x| + theta)``.  JAX's threshold stops a float32 solve after
  two steps on the n=65536 two-moons graph (``tools/spectral_paths.py``),
  with the eigenvalues 0.038 off and spectral clustering at 50.8 %
  (``tools/spectral_reference.py``).
* The accel's start is the plain path's draw, not a draw of its own in
  its permuted space, so the paths differ only by rounding.

On a mesh (``parallel.execute.eigen_decomp_sharded``) ``g`` is a rank's
rows and ``shard`` describes them: ``reduce`` (sums, maxima over the
ranks), ``valid`` (the rank's real rows; the operators are masked to
them, so padding rows stay 0 and out of the top of the spectrum),
``take`` (a node-order tensor to the rank's rows: the random starts are
the plain path's draws, over the true ``n`` nodes), ``n`` and ``row0``.
"""

from __future__ import annotations

import numpy as np
import torch

from graphlearning_tpu_torch import config
from graphlearning_tpu_torch.core.sparse import SparseGraph
from graphlearning_tpu_torch.ops import graphops as _ops
from graphlearning_tpu_torch.solvers.lobpcg import (_norms, lobpcg_standard,
                                                    per_pair_tol)


def _start(n, k, key, dtype, device):
    """LOBPCG's random start ``(n, k)``, a normal draw from ``key`` (a
    seed, 0 by default, or a generator)."""
    return torch.randn((n, k), generator=config.generator(
        0 if key is None else key, device), dtype=dtype, device=device)


def guard_count(n: int, k: int) -> int:
    """The guard vectors solved beyond the ``k`` pairs kept (LOBPCG's last
    pairs converge worst), for a graph of ``n`` nodes."""
    return min(2 + k // 10, max(n // 4 - k, 0))


def _lobpcg_tol(tol, X, n=None):
    """The ``tol`` given to :func:`lobpcg_standard` for the start ``X``
    (of ``n`` rows in all): JAX's (``tol``, or None for the dtype's
    epsilon) in float64, per pair (:func:`lobpcg.per_pair_tol`) in
    float32, where JAX's threshold lets a large graph's solve stop after a
    step or two."""
    if torch.finfo(X.dtype).bits >= 64:
        return tol if tol else None
    return per_pair_tol(tol, X, n)


def _identity(t, op="sum"):
    return t


def _draw(n, k, key, dtype, device, shard=None):
    """:func:`_start`'s draw over the ``n`` nodes, or its rows of the
    ``shard``."""
    X = _start(n, k, key, dtype, device)
    return X if shard is None else shard.take(X)


def _lobpcg_topk(matvec, n, k, tol, key=None, m=200, dtype=None, power=1,
                 X0=None, device=None, info=None, shard=None):
    """Top-k eigenpairs ``(theta, U)`` of a symmetric PSD operator by
    LOBPCG, on ``matvec^power`` when ``power > 1`` (its eigenvectors are
    the operator's).  The start is ``X0``, else :func:`_start` (the
    ``shard``'s rows of it); the tolerance :func:`_lobpcg_tol`'s.
    ``info`` gets the steps taken as "iters"."""
    if X0 is None:
        dev = config.device(device)
        X0 = _draw(n, k, key, dtype or config.float_dtype(dev), dev, shard)

    def op(Y):
        for _ in range(power):
            Y = matvec(Y)
        return Y

    if shard is None:
        theta, U, iters = lobpcg_standard(op, X0, m=m,
                                          tol=_lobpcg_tol(tol, X0))
    else:
        theta, U, iters = lobpcg_standard(
            op, X0, m=m, tol=_lobpcg_tol(tol, X0, n), reduce=shard.reduce,
            row0=shard.row0, n=n)
    if info is not None:
        info["iters"] = iters
    return theta, U


def _rayleigh(matvec, U, reduce=_identity):
    """Per-column Rayleigh quotients ``u^T A u / u^T u``."""
    AU = matvec(U)
    return (reduce(torch.sum(U * AU, dim=0))
            / reduce(torch.sum(U * U, dim=0)))


def power_iteration(matvec, n, num_iter=100, key=None, dtype=None,
                    device=None, shard=None):
    """Largest eigenvalue estimate ``(lam, v)`` (for spectral shifts);
    the start is drawn from ``key`` (seed 1 by default)."""
    dev = config.device(device)
    dtype = dtype or config.float_dtype(dev)
    red = None if shard is None else shard.reduce
    v = _draw(n, 1, 1 if key is None else key, dtype, dev, shard)[:, 0]
    v = v / _norms(v, red)
    for _ in range(num_iter):
        w = matvec(v[:, None])[:, 0]
        v = w / torch.clamp(_norms(w, red), min=1e-30)
    lam = torch.dot(v, matvec(v[:, None])[:, 0])
    return (lam if red is None else red(lam)), v


def _default_power(dtype):
    """LOBPCG's spectral-filter power: 1 in float64; float32 needs the
    gaps of near-degenerate low modes widened."""
    return 1 if torch.finfo(dtype).bits >= 64 else 8


def smallest_eigh(matvec, n, k, shift, tol=0, key=None, m=200, dtype=None,
                  device=None, info=None, shard=None):
    """Smallest-k eigenpairs of a symmetric operator by LOBPCG on
    ``(shift I - Op)^p`` (``shift`` must bound the spectrum above);
    eigenvalues by Rayleigh quotients on the unpowered operator.  ``info``
    gets LOBPCG's steps ("iters")."""
    dev = config.device(device)
    dtype = dtype or config.float_dtype(dev)
    keep = _masker(shard)

    def A(X):
        return keep(shift * X - matvec(X))

    _, U = _lobpcg_topk(A, n, k, tol, key=key, m=m, dtype=dtype,
                        power=_default_power(dtype), device=dev, info=info,
                        shard=shard)
    vals = shift - _rayleigh(A, U, _reducer(shard))
    order = torch.argsort(vals)
    return vals[order], U[:, order]


def _masker(shard):
    """The operators' output on the shard's real rows (padding rows 0)."""
    if shard is None:
        return lambda Y: Y
    v = shard.valid[:, None]
    return lambda Y: torch.where(v, Y, torch.zeros((), dtype=Y.dtype,
                                                   device=Y.device))


def _reducer(shard):
    return _identity if shard is None else shard.reduce


def _inv_sqrt(deg, shard):
    """``deg^-1/2``; 0 on the padding rows (degree 0) of a shard."""
    if shard is None:
        return 1.0 / torch.sqrt(deg)
    ok = deg > 0
    return torch.where(ok, torch.where(ok, deg, torch.ones_like(deg))
                       ** -0.5, torch.zeros_like(deg))


def eigen_decomp(g: SparseGraph, normalization="combinatorial",
                 method="exact", k=10, c=None, gamma=0, tol=0, q=1,
                 spmm=None, accel=None, info=None, shard=None, key=None,
                 X0=None):
    """Low-lying spectrum of the graph Laplacian: increasing eigenvalues,
    eigenvectors as columns, tensors on ``g``'s device.  ``gamma > 0``
    adds the modularity term.  ``spmm`` overrides ``W @ X``; ``accel`` (an
    :class:`~graphlearning_tpu_torch.ops.accel.AccelSpMM` or
    :class:`~graphlearning_tpu_torch.ops.gather.GatherAccel`) runs the
    normalized / randomwalk "exact" solve in its permuted space
    (``eig_normalized``).  ``info`` gets LOBPCG's steps ("iters").  The
    JAX package's "lowrank" branch never takes the accel (its ``spmm`` is
    set before the test), so here neither does it.  Outside LOBPCG and
    the randomized SVD, which run their products in full f32 precision
    (:func:`config.exact_matmul`), every product is elementwise.  With
    ``shard`` (a rank's rows of a mesh; see the module's docstring) the
    "exact" solves of the normalized, randomwalk and combinatorial
    Laplacians run, with ``gamma`` too; the vectors are the rank's rows.
    ``key`` seeds LOBPCG's start (0 when None); ``X0`` (n, k), in node
    order, replaces the draw in an ``accel``'s solve."""
    if c is None:
        c = 2 * k
    n = g.n if shard is None else shard.n
    dev = g.device
    deg = _ops.degree_vector(g)
    dtype = g.vals.dtype
    if spmm is None:
        spmm = lambda X: _ops.spmm(g, X)
    red, keep = _reducer(shard), _masker(shard)
    topk = lambda A: _lobpcg_topk(A, n, k, tol, key=key, dtype=dtype,
                                  power=_default_power(dtype), device=dev,
                                  info=info, shard=shard)
    if shard is not None and (method != "exact" or accel is not None
                              or normalization not in (
                                  "normalized", "randomwalk",
                                  "combinatorial")):
        raise ValueError(f"a sharded eigen_decomp solves the normalized, "
                         f"randomwalk and combinatorial Laplacians by "
                         f"LOBPCG, not {normalization!r} by {method!r}")

    if gamma != 0:
        # the modularity operator L v + (gamma / m) (deg2 . v) deg1
        if normalization == "randomwalk":
            p1, p2, lap_norm = 1.5, 0.5, "normalized"
        else:
            p1, p2, lap_norm = 1.0, 1.0, normalization
        deg1 = deg ** p1
        deg2 = deg ** p2
        mm = red(torch.sum(deg)) / 2
        if lap_norm == "combinatorial":
            lap_mv = lambda X: deg[:, None] * X - spmm(X)
        elif lap_norm == "normalized":
            sL = _inv_sqrt(deg, shard)
            lap_mv = lambda X: X - sL[:, None] * spmm(sL[:, None] * X)
        else:
            lap_mv = lambda X: _ops.laplacian_matvec(g, X, lap_norm, deg=deg)

        def Mop(X):
            return keep(lap_mv(X) + (gamma / mm) * deg1[:, None] * red(
                torch.sum(deg2[:, None] * X, dim=0, keepdim=True)))

        lmax, _ = power_iteration(Mop, n, num_iter=100, device=dev,
                                  shard=shard)
        shift = 1.01 * lmax + 1.0
        vals, vecs = smallest_eigh(Mop, n, k, shift, tol=tol, key=key,
                                   device=dev, info=info, shard=shard)
        if normalization == "randomwalk":
            vecs = (vecs / torch.sqrt(deg)[:, None] if shard is None
                    else _inv_sqrt(deg, shard)[:, None] * vecs)
        return vals, vecs

    if normalization in ("randomwalk", "normalized"):
        s = _inv_sqrt(deg, shard)
        if method == "exact":
            if accel is not None:
                # the plain path's start, in the accel's permuted space
                if X0 is None:
                    X0 = _start(n, k, None, dtype, dev)
                vals, U_p = accel.eig_normalized(
                    accel.to_perm(s.to(dtype)), k,
                    power=_default_power(dtype), X0=accel.to_perm(X0),
                    tol=tol, info=info)
                U = accel.from_perm(U_p)
            else:
                def A(X):          # I + D^-1/2 W D^-1/2: spectrum in [0, 2]
                    return keep(X + s[:, None] * spmm(s[:, None] * X))

                _, U = topk(A)
                vals = 2.0 - _rayleigh(A, U, red)
            order = torch.argsort(vals)
            vals, vecs = vals[order], U[:, order]
        elif method == "lowrank":
            from graphlearning_tpu_torch.utils import randomized_svd

            u, sv, _ = randomized_svd(Anorm_wrap(g, s, spmm=spmm), k=k, c=c,
                                      q=q, device=dev)
            vals = 1.0 - sv
            order = np.argsort(vals)
            vals = torch.as_tensor(vals[order], device=dev)
            vecs = torch.as_tensor(u[:, order], device=dev)
        else:
            raise ValueError("Invalid eigensolver method " + method)
        if normalization == "randomwalk":
            vecs = s[:, None] * vecs
        return vals, vecs

    if normalization == "combinatorial":
        M = 2.0 * (torch.max(deg) if shard is None
                   else shard.reduce(torch.max(deg), "max"))

        def A(X):          # M I - L = (M - deg) X + W X: PSD
            return keep((M - deg)[:, None] * X + spmm(X))

        if method == "exact":
            _, U = topk(A)
            theta = _rayleigh(A, U, red)
        elif method == "lowrank":
            from graphlearning_tpu_torch.utils import randomized_svd

            class _Op:
                shape = (n, n)

                def __call__(self, X):
                    return A(X)

            u, sv, _ = randomized_svd(_Op(), k=k, c=c, q=q, device=dev)
            theta = torch.as_tensor(sv, device=dev)
            U = torch.as_tensor(u, device=dev)
        else:
            raise ValueError("Invalid eigensolver method " + method)
        vals = M - theta
        order = torch.argsort(vals)
        return vals[order], U[:, order]

    if normalization == "coifmanlafon":
        # the density-normalized kernel K = D^-a W D^-a, then the randomwalk
        # Laplacian of K; a float c is the density exponent (the JAX
        # package's reading of c here)
        alpha = c if isinstance(c, float) else 0.5
        da = deg ** -alpha

        def Kmv(X):
            return da[:, None] * spmm(da[:, None] * X)

        dK = Kmv(torch.ones((n, 1), dtype=dtype, device=dev))[:, 0]
        sK = 1.0 / torch.sqrt(dK)

        def A(X):          # I + D_K^-1/2 K D_K^-1/2
            return X + sK[:, None] * Kmv(sK[:, None] * X)

        _, U = topk(A)
        vals = 2.0 - _rayleigh(A, U)
        order = torch.argsort(vals)
        return vals[order], sK[:, None] * U[:, order]

    raise ValueError("Invalid choice of normalization " + normalization)


def Anorm_wrap(g: SparseGraph, s, spmm=None):
    """The symmetric normalized adjacency ``diag(s) W diag(s)`` as an
    operator with a ``shape``, for :func:`utils.randomized_svd`."""
    n = g.n
    if spmm is None:
        spmm = lambda X: _ops.spmm(g, X)

    class _Op:
        shape = (n, n)

        def __call__(self, X):
            return s[:, None] * spmm(s[:, None] * X)

    return _Op()


def fiedler_vector(g: SparseGraph, tol=0):
    """The second eigenpair ``(value, vector)`` of the normalized
    Laplacian."""
    vals, vecs = eigen_decomp(g, normalization="normalized", k=2, tol=tol)
    return vals[1], vecs[:, 1]
