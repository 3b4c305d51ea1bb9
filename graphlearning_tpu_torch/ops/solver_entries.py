"""The solver entries of an SpMM operator in its permuted space.

:class:`SpmmSolvers` holds the CG, constrained-Laplace and Poisson
gradient-descent loops, and the heat steps, dual convolution and MBO loops
of PoissonMBO and VolumeMBO, that the fits call on an accel, written once
in terms of the operator's ``spmm`` and ``to_perm`` / ``from_perm``: the
band operator
(:class:`~graphlearning_tpu_torch.ops.accel.AccelSpMM`) and the gather
operator (:class:`~graphlearning_tpu_torch.ops.gather.GatherAccel`) both
take them, as the JAX package's ``accel.py`` and ``gather.py`` each carry
their own copy.
"""

from __future__ import annotations

import torch

from graphlearning_tpu_torch.solvers import cg as _cg
from graphlearning_tpu_torch.solvers import volume as _volume


class SpmmSolvers:
    """Solver entries over ``self.spmm`` (``Wp @ Xp`` in permuted
    space)."""

    def cg_scaled(self, s_p, b, c0=1.0, c1=1.0, tol=1e-10, max_iter=10**5,
                  x0=None):
        """CG solve of ``(c0 I - c1 diag(s) Wp diag(s)) x = b``.  Returns
        ``(x, iters)``."""
        def A(X):
            return c0 * X - c1 * s_p[:, None] * self.spmm(s_p[:, None] * X)

        x, iters, _ = _cg.conjgrad(A, b, x0=x0, tol=tol, max_iter=max_iter)
        return x, iters

    def laplace_constrained(self, deg_p, diag_p, tau_p, mask_p, bdy_p, tol,
                            normalization="combinatorial", order=1,
                            max_iter=10**5, u0_p=None):
        """Masked CG solve of ``(tau + L)^order u = 0`` with ``u = bdy`` on
        ``mask``.  Returns ``(u, iters)``."""
        zero = torch.zeros((), dtype=deg_p.dtype, device=deg_p.device)
        if normalization == "combinatorial":
            matvec = lambda X: deg_p[:, None] * X - self.spmm(X)
        elif normalization == "randomwalk":
            dinv = torch.where(deg_p > 0, 1.0 / torch.where(
                deg_p == 0, torch.ones_like(deg_p), deg_p), zero)
            matvec = lambda X: X - dinv[:, None] * self.spmm(X)
        elif normalization == "normalized":
            s = torch.where(deg_p > 0, torch.where(
                deg_p == 0, torch.ones_like(deg_p), deg_p) ** -0.5, zero)
            matvec = lambda X: X - s[:, None] * self.spmm(s[:, None] * X)
        else:
            raise ValueError(f"unsupported normalization {normalization!r}")

        def L(X):
            Y = X
            for _ in range(order):
                Y = tau_p[:, None] * Y + matvec(Y)
            return Y

        u, iters, _ = _cg.constrained_solve(
            L, (tau_p + diag_p) ** order, mask_p, bdy_p, tol=tol,
            max_iter=max_iter, u0=u0_p)
        return u, iters

    def poisson_gd(self, deg_p, Db_p, v0_p, min_iter: int, max_iter: int,
                   n_true: int):
        """Poisson gradient descent ``u <- Db + D^-1 W u`` until the random
        walk from the labels mixes (``max|v - v_inf| <= 1/n``), at least
        ``min_iter`` and at most ``max_iter`` steps.  ``u`` and the walker
        share one SpMM per step: the extra column holds ``D^-1 v``.
        Symmetric graphs only.  Returns ``(u, iters)``."""
        zero = torch.zeros((), dtype=deg_p.dtype, device=deg_p.device)
        dinv = torch.where(deg_p > 0, 1.0 / torch.where(
            deg_p == 0, torch.ones_like(deg_p), deg_p), zero)
        vinf = deg_p / torch.sum(deg_p)
        kcls = Db_p.shape[1]
        U = torch.cat([torch.zeros_like(Db_p), (dinv * v0_p)[:, None]], dim=1)
        T = 0
        while T < max_iter:
            if T >= min_iter:
                v = deg_p * U[:, kcls]
                if not bool(torch.max(torch.abs(v - vinf)) > 1.0 / n_true):
                    break
            WU = self.spmm(U)
            u = Db_p + dinv[:, None] * WU[:, :kcls]
            U = torch.cat([u, (dinv * WU[:, kcls])[:, None]], dim=1)
            T += 1
        return U[:, :kcls], T

    # -- PoissonMBO and VolumeMBO ------------------------------------------

    def heat_steps(self, deg_p, u_p, Db_p, dt, Ns: int):
        """``Ns`` heat-equation steps ``u <- u - dt (D u - W u) + Db`` in
        permuted space (PoissonMBO's diffusion)."""
        for _ in range(int(Ns)):
            u_p = u_p - dt * (deg_p[:, None] * u_p - self.spmm(u_p)) + Db_p
        return u_p

    def dual_conv_labels(self, dinv_p, labels, k: int):
        """VolumeMBO's dual convolution ``D^-1 W D^-1 W onehot(labels)``:
        ``labels`` (n,) in original order, the affinities (n, k) too.
        Padding rows of the permuted space hold zeros."""
        U = _volume._onehot(labels, int(k), dinv_p.dtype)
        a = dinv_p[:, None] * self.spmm(self.to_perm(U))
        return self.from_perm(dinv_p[:, None] * self.spmm(a))

    def poisson_mbo(self, deg_p, Db_p, u0, w0, priors, dt, Ns: int, T: int):
        """PoissonMBO's T rounds (:func:`volume.poisson_mbo_loop`): the heat
        steps in permuted space, the projection and threshold in original
        order, so padding rows stay zero and out of the class sizes.
        ``u0`` (n, k) in original order.  Returns ``(u, w, err)``."""
        def heat(u):
            return self.from_perm(self.heat_steps(deg_p, self.to_perm(u),
                                                  Db_p, dt, Ns))

        return _volume.poisson_mbo_loop(heat, u0, w0, priors, T)

    def volume_mbo(self, dinv_p, labels0, fixed_mask, fixed_labels, lower,
                   upper, temp, draw, k: int, max_iters: int):
        """VolumeMBO's fixed point (:func:`volume.mbo_loop`) on
        :meth:`dual_conv_labels`, labels in original order; ``draw`` gives
        the noise.  Returns ``(labels, iters)``."""
        return _volume.mbo_loop(
            lambda labels: self.dual_conv_labels(dinv_p, labels, k), labels0,
            fixed_mask, fixed_labels, lower, upper, temp, draw,
            n_true=int(self.n), max_iters=int(max_iters))
