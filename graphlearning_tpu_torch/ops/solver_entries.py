"""The solver entries of an SpMM operator in its permuted space.

:class:`SpmmSolvers` holds the CG, constrained-Laplace and Poisson
gradient-descent loops, and the heat steps, dual convolution and MBO loops
of PoissonMBO and VolumeMBO, the normalized eigensolve, the centered
kernel method's solve and INCRES's rounds, that the fits call on an
accel, written once
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
from graphlearning_tpu_torch.solvers import centered as _centered
from graphlearning_tpu_torch.solvers import eig as _eig
from graphlearning_tpu_torch.solvers import incres as _incres
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

    def eig_normalized(self, s_p, k: int, m: int = 200, power: int = 8,
                       key=None, X0=None, tol=None, info=None):
        """Top-k eigenpairs of ``A = I + diag(s) Wp diag(s)`` in permuted
        space by LOBPCG on ``A^power`` (:func:`solvers.eig._lobpcg_topk`):
        ``(2 - u^T A u / u^T u, U)``, the smallest eigenvalues of the
        normalized Laplacian, unsorted, and their eigenvectors in permuted
        space.  Padding rows have ``s = 0``, so ``A`` is the identity there
        (eigenvalue 1, below the low modes' eigenvalues near 2).  The start
        is ``X0`` (``s_p``'s rows), else a normal draw from ``key`` (seed 0
        by default, or a generator).  ``info`` gets the steps taken
        ("iters")."""
        def A(X):
            return X + s_p[:, None] * self.spmm(s_p[:, None] * X)

        _, U = _eig._lobpcg_topk(A, s_p.shape[0], int(k), tol, key=key,
                                 m=int(m), dtype=s_p.dtype, power=int(power),
                                 X0=X0, device=s_p.device, info=info)
        return 2.0 - _eig._rayleigh(A, U), U

    def _valid(self):
        """The true rows of the permuted space (padding rows False)."""
        ones = torch.ones(self.n, dtype=torch.bool, device=self.device)
        return self.to_perm(ones, fill=False)

    def centered_kernel(self, K_p, mask_p, alpha_factor, tol, e0_p,
                        power_it: int, n_true: int, max_iter: int = 10**5,
                        info=None):
        """The centered kernel method's solve (:func:`solvers.centered.
        solve`) in permuted space, the column means over the true rows
        only: ``K_p`` the centered labels, ``mask_p`` the labeled rows,
        ``e0_p`` the power iteration's start.  Returns ``u_p``."""
        return _centered.solve(self.spmm, K_p, mask_p, alpha_factor, tol,
                               e0_p, power_it, n_true, valid=self._valid(),
                               max_iter=max_iter, info=info)

    def incres(self, dinv_p, u0, draw, k: int, T: int, Dm: int, n_true: int,
               info=None):
        """INCRES's rounds (:func:`solvers.incres.rounds`): the seeds
        planted and the labels read in original order, the diffusion in
        permuted space, its stop test over the true rows.  ``draw((k,
        n))`` gives each round's scores.  Returns the labels (n,)."""
        return _incres.rounds(self.spmm, dinv_p, u0, draw, int(k), int(T),
                              int(Dm), int(n_true), to_perm=self.to_perm,
                              from_perm=self.from_perm, valid=self._valid(),
                              info=info)

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
