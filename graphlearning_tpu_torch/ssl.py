"""Semi-supervised learning on graphs (counterpart of
``graphlearning_tpu/ssl.py:36-345,507-1334,1722-1952`` for Laplace (with
its reweightings), Poisson and random-walk learning, PoissonMBO and
VolumeMBO, and the distance and Lipschitz models: graph nearest neighbor,
AMLE, p-eikonal and p-Laplace).

Each model's ``_fit`` moves the labels to the graph's device once and runs
a matrix-free solver there.  On a large band-friendly graph on CUDA, every
matvec goes through the band kernels (:mod:`ops.accel`); otherwise through
the plain ELL gather (:mod:`ops.graphops`).  ``self.iters`` holds the
solver's iteration (or sweep) count after a fit.  One-vs-rest models solve
their C problems together (``_fit_onevsrest``) or one class at a time.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from graphlearning_tpu_torch import config, utils
from graphlearning_tpu_torch.core import graphclass as _graphmod
from graphlearning_tpu_torch.core.sparse import SparseGraph
from graphlearning_tpu_torch.ops import accel as _accel
from graphlearning_tpu_torch.ops import graphops as _ops
from graphlearning_tpu_torch.solvers import cg as _cg
from graphlearning_tpu_torch.solvers import eikonal as _eik
from graphlearning_tpu_torch.solvers import plaplace as _pl
from graphlearning_tpu_torch.solvers import volume as _volume


def _cg_scaled_solve(g, s, b, c0, c1, tol, max_iter=10**5, x0=None):
    """CG solve of ``(c0 I - c1 diag(s) W diag(s)) x = b``.  Returns
    ``(x, iters)``."""

    def A(X):
        return c0 * X - c1 * s[:, None] * _ops.spmm(g, s[:, None] * X)

    x, iters, _ = _cg.conjgrad(A, b, x0=x0, tol=tol, max_iter=max_iter)
    return x, iters


def _project_out_nlap_kernel(v, deg):
    """Remove the ``D^{1/2} 1`` kernel component of each column.  The
    normalized Laplacian is singular with that kernel, and float32 rounding
    drifts a different multiple of it into each class column, which shifts
    the argmax; projecting it out restores the f64 gauge.  Padding rows
    (degree 0) contribute nothing."""
    q = torch.sqrt(torch.clamp(deg, min=0.0)).to(v.dtype)
    coef = (q @ v) / torch.sum(q * q)
    return v - q[:, None] * coef[None, :]


def _laplace_constrained(g, tau, mask, bdy, tol, normalization="combinatorial",
                         order=1, max_iter=10**5, u0=None):
    """Masked CG solve of ``(tau + L)^order u = 0`` with ``u = bdy`` on
    ``mask``.  Returns ``(u, iters)``."""
    deg = _ops.degree_vector(g)

    def L(X):
        Y = X
        for _ in range(order):
            Y = tau[:, None] * Y + _ops.laplacian_matvec(
                g, Y, normalization=normalization, deg=deg)
        return Y

    diag = _ops.laplacian_diag(g, normalization=normalization, deg=deg)
    u, iters, _ = _cg.constrained_solve(L, (tau + diag) ** order, mask, bdy,
                                        tol=tol, max_iter=max_iter, u0=u0)
    return u, iters


class ssl:
    """Base class: fit / predict / class-prior volume projection."""

    def __init__(self, W=None, class_priors=None, device=None):
        self._device = device
        if W is None:
            self.graph = None
        else:
            self.set_graph(W)
        self.prob = None
        self.fitted = False
        self.name = ""
        self.similarity = True
        self.class_priors = class_priors
        if self.class_priors is not None:
            self.class_priors = np.asarray(self.class_priors, dtype=float)
            self.class_priors = self.class_priors / np.sum(self.class_priors)
        self.weights = 1
        self.class_priors_error = 1
        self.iters = None
        self.onevsrest = False

    def set_graph(self, W):
        if isinstance(W, _graphmod.graph):
            self.graph = W
        else:
            self.graph = _graphmod.graph(W, device=self._device)
        self._accel_cache = None
        self._nodiag_cache = None

    def _nodiag_graph(self):
        """Zero-diagonal copy ``(W, graph)`` of the model's graph, cached on
        the scipy matrix so repeated fits reuse its device arrays and band
        plan."""
        if self._nodiag_cache is None:
            W0 = self.graph.weight_matrix
            key = str(self.graph.device)
            cache = getattr(W0, "_gltt_nodiag_cache", None)
            if not isinstance(cache, dict):
                cache = W0._gltt_nodiag_cache = {}
            if key not in cache:
                W = W0
                if W0.diagonal().any():
                    W = W0.copy()
                    W.setdiag(0)
                    W.eliminate_zeros()
                cache[key] = (W, _graphmod.graph(W, device=self.graph.device))
            self._nodiag_cache = cache[key]
        return self._nodiag_cache

    def predict(self, ignore_class_priors=False):
        if not self.fitted:
            raise RuntimeError("Model has not been fitted yet.")
        w = 1 if ignore_class_priors else self.weights
        scores = self.prob - np.min(self.prob)
        m = np.max(scores)
        if m > 0:
            scores = scores / m
        if self.similarity:
            return np.argmax(scores * w, axis=1)
        return np.argmin(scores * w, axis=1)

    def fit_predict(self, train_ind, train_labels, all_labels=None):
        self.fit(train_ind, train_labels, all_labels=all_labels)
        return self.predict()

    def volume_label_projection(self):
        """Adjust per-class decision weights until the predicted class sizes
        match ``class_priors``."""
        k = self.prob.shape[1]
        if isinstance(self.weights, int):
            self.weights = np.ones((k,))
        dev = self.graph.device
        dtype = config.float_dtype(dev)
        scores = self.prob - np.min(self.prob)
        m = np.max(scores)
        if m > 0:
            scores = scores / m
        as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(dtype)
        w, err = _volume.projection_weights(
            as_t(scores), as_t(self.weights), as_t(self.class_priors),
            -0.1 if self.similarity else 0.1,
            similarity=bool(self.similarity))
        self.weights = w.cpu().numpy().astype(float)
        self.class_priors_error = float(err)
        return self.predict()

    def fit(self, train_ind, train_labels, all_labels=None):
        if self.graph is None:
            raise RuntimeError("SSL object has no graph. Use set_graph().")
        train_ind = np.asarray(train_ind)
        train_labels = np.asarray(train_labels)
        self.fitted = True
        if self.onevsrest:
            unique_labels = np.unique(train_labels)
            if hasattr(self, "_fit_onevsrest"):
                # all C one-vs-rest problems in one batched solve
                u = self._fit_onevsrest(train_ind, train_labels,
                                        unique_labels)
            else:
                u = np.stack([_as_numpy(self._fit(train_ind,
                                                  train_labels == l))
                              for l in unique_labels], axis=1)
        else:
            u = self._fit(train_ind, train_labels, all_labels=all_labels)
        self.prob = _as_numpy(u)
        if self.class_priors is not None:
            self.volume_label_projection()
        return self.prob

    def _fit(self, train_ind, train_labels, all_labels=None):
        raise NotImplementedError("Must override _fit")


def _as_numpy(u):
    return u.cpu().numpy() if torch.is_tensor(u) else np.asarray(u)


def ssl_accuracy(pred_labels, true_labels, train_ind=None):
    """Accuracy in percent, excluding training points and negatively
    labeled nodes."""
    pred_labels = np.asarray(pred_labels)
    true_labels = np.asarray(true_labels)
    mask = true_labels >= 0
    if train_ind is not None:
        train_ind = np.asarray(train_ind)
        if train_ind.dtype == bool:
            mask &= ~train_ind
        else:
            tm = np.zeros(len(true_labels), dtype=bool)
            tm[train_ind] = True
            mask &= ~tm
    if mask.sum() == 0:
        return 100.0
    return 100.0 * np.mean(pred_labels[mask] == true_labels[mask])


_NORMALIZATIONS = ("combinatorial", "randomwalk", "normalized")


class laplace(ssl):
    """Laplace (harmonic) learning: solve ``tau u + L^order u = 0`` on the
    unlabeled nodes with ``u = y`` at the labels, by masked
    Jacobi-preconditioned CG.  The parameters are the JAX package's, in
    its order, with ``device`` last.  ``reweighting`` ("none", "poisson",
    "wnll" or "properly", :meth:`graph.reweight`, which reads ``X``,
    ``alpha``, ``zeta`` and ``r``) fits on the reweighted graph, built
    once per train set and kept for the next fit of the same split."""

    def __init__(self, W=None, class_priors=None, X=None, reweighting="none",
                 normalization="combinatorial", tau=0, order=1,
                 mean_shift=False, tol=1e-5, alpha=2, zeta=1e7, r=0.1,
                 device=None):
        if reweighting not in ("none", "poisson", "wnll", "properly"):
            raise ValueError(f"invalid reweighting method {reweighting}")
        if normalization not in _NORMALIZATIONS:
            raise ValueError(f"normalization must be one of {_NORMALIZATIONS}")
        super().__init__(W, class_priors, device=device)
        self.reweighting = reweighting
        self.normalization = normalization
        self.mean_shift = mean_shift
        self.tol = tol
        self.order = int(order)
        self.tau = tau
        self.X = X
        self.alpha, self.zeta, self.r = alpha, zeta, r
        self.name = "Laplace Learning"
        if reweighting != "none":
            self.name += ": " + reweighting + " reweighted"
        if normalization != "combinatorial":
            self.name += " " + normalization

    def _reweighted_graph(self, train_ind):
        """The graph reweighted for ``train_ind``, cached per train set: a
        second fit on the same split reuses the scipy build, the device
        graph and the accel on it."""
        rkey = (self.reweighting, np.asarray(train_ind).tobytes())
        if getattr(self, "_reweight_key", None) != rkey:
            W = self.graph.reweight(
                train_ind, method=self.reweighting,
                normalization=(self.normalization
                               if self.reweighting == "poisson"
                               else "combinatorial"),
                X=self.X, alpha=self.alpha, zeta=self.zeta, r=self.r)
            self._reweight_G = _graphmod.graph(W, device=self.graph.device)
            self._reweight_key = rkey
        return self._reweight_G

    def _fit(self, train_ind, train_labels, all_labels=None):
        G = (self.graph if self.reweighting == "none"
             else self._reweighted_graph(train_ind))
        dev = G.device
        dtype = config.float_dtype(dev)
        n = G.num_nodes
        k = len(np.unique(train_labels))
        F = utils.labels_to_onehot(train_labels, k)
        mask = np.zeros(n, dtype=bool)
        mask[train_ind] = True
        bdy = np.zeros((n, k))
        bdy[train_ind] = F
        tau = np.broadcast_to(np.atleast_1d(self.tau), (n,)).astype(float)
        as_t = lambda a: torch.as_tensor(a, device=dev).to(dtype)
        tau_t, bdy_t = as_t(tau), as_t(bdy)
        mask_t = torch.as_tensor(mask, device=dev)

        # a reweighted graph's accel rides on its own W, not on the model
        acc = _accel.maybe_build(
            G.weight_matrix,
            cache_obj=self if self.reweighting == "none" else None,
            device=dev)
        if acc is not None:
            # permuted space; padding rows are identity rows (diag 1,
            # tau 0, unlabeled, zero rhs)
            deg_p = acc.to_perm(_ops.degree_vector(G.sparse))
            diag_p = acc.to_perm(
                _ops.laplacian_diag(G.sparse, self.normalization), fill=1.0)
            u, self.iters = acc.laplace_constrained(
                deg_p, diag_p, acc.to_perm(tau_t),
                acc.to_perm(mask_t.to(torch.int32)) > 0, acc.to_perm(bdy_t),
                self.tol, normalization=self.normalization, order=self.order)
            u = acc.from_perm(u)
        else:
            u, self.iters = _laplace_constrained(
                G.sparse, tau_t, mask_t, bdy_t, self.tol,
                normalization=self.normalization, order=self.order)
        if self.mean_shift:
            u = u - torch.mean(u, dim=0)
        return u


class randomwalk(ssl):
    """Lazy random-walk learning: CG solve of
    ``((1 + tau) I - alpha D^-1/2 W D^-1/2) u = F``."""

    def __init__(self, W=None, class_priors=None, alpha=0.95, tau=0,
                 device=None):
        super().__init__(W, class_priors, device=device)
        self.alpha = alpha
        self.tau = tau
        self.name = "Random Walk"

    def _fit(self, train_ind, train_labels, all_labels=None):
        G = self.graph
        dev = G.device
        n = G.num_nodes
        k = len(np.unique(train_labels))
        F = np.zeros((n, k))
        F[train_ind] = utils.labels_to_onehot(train_labels, k)
        g = G.sparse
        s = 1.0 / torch.sqrt(_ops.degree_vector(g))
        F_t = torch.as_tensor(F, device=dev).to(config.float_dtype(dev))
        acc = _accel.maybe_build(G.weight_matrix, cache_obj=self, device=dev)
        if acc is not None:
            u, self.iters = acc.cg_scaled(acc.to_perm(s), acc.to_perm(F_t),
                                          c0=1.0 + self.tau, c1=self.alpha,
                                          tol=1e-10)
            return acc.from_perm(u)
        u, self.iters = _cg_scaled_solve(g, s, F_t, 1.0 + self.tau,
                                         self.alpha, 1e-10)
        return u


class poisson(ssl):
    """Poisson learning.  Solvers: 'conjugate_gradient' (normalized
    Laplacian CG with ``D^{+-1/2}`` conjugation) and 'gradient_descent'
    (``u <- D^-1 b + D^-1 W u`` until the random walk from the labels
    mixes).  'spectral' waits for the eigensolvers.  The parameters are
    the JAX package's, in its order, with ``device`` last: ``p`` and
    ``spectral_cutoff`` are stored for the spectral solver, the only one
    that reads them, and ``use_cuda`` is accepted and ignored (the device
    comes from ``device``)."""

    def __init__(self, W=None, class_priors=None, solver="conjugate_gradient",
                 p=1, use_cuda=False, min_iter=50, max_iter=1000, tol=1e-3,
                 spectral_cutoff=10, device=None):
        if solver == "spectral":
            raise NotImplementedError(
                "poisson solver='spectral' needs the eigensolvers, not "
                "ported yet")
        if solver not in ("conjugate_gradient", "gradient_descent"):
            raise ValueError(f"invalid Poisson solver {solver!r}")
        super().__init__(W, class_priors, device=device)
        self.solver = solver
        self.p = p
        self.min_iter = min_iter
        self.max_iter = max_iter
        self.tol = tol
        self.spectral_cutoff = spectral_cutoff
        self.name = "Poisson Learning"

    def _fit(self, train_ind, train_labels, all_labels=None):
        n = self.graph.num_nodes
        dev = self.graph.device
        dtype = config.float_dtype(dev)
        k = len(np.unique(train_labels))
        # zero diagonal for faster convergence
        W, G0 = self._nodiag_graph()
        g = G0.sparse
        onehot = utils.labels_to_onehot(train_labels, k)
        source = np.zeros((n, k))
        source[train_ind] = onehot - np.mean(onehot, axis=0)
        b = torch.as_tensor(source, device=dev).to(dtype)
        deg = _ops.degree_vector(g)

        if self.solver == "conjugate_gradient":
            s = 1.0 / torch.sqrt(deg)
            acc = _accel.maybe_build(W, cache_obj=self, device=dev)
            if acc is not None:
                # padding rows have s = 0: identity rows with zero rhs
                s_p = acc.to_perm(s)
                v, self.iters = acc.cg_scaled(
                    s_p, s_p[:, None] * acc.to_perm(b), tol=self.tol)
                deg_p = torch.where(
                    s_p > 0, 1.0 / torch.where(s_p == 0, torch.ones_like(s_p),
                                               s_p) ** 2,
                    torch.zeros_like(s_p))
                v = _project_out_nlap_kernel(v, deg_p)
                return acc.from_perm(s_p[:, None] * v)
            v, self.iters = _cg_scaled_solve(g, s, s[:, None] * b, 1.0, 1.0,
                                             self.tol)
            return s[:, None] * _project_out_nlap_kernel(v, deg)

        # gradient descent: the band path needs a symmetric graph
        acc = None
        if (W != W.T).nnz == 0:
            acc = _accel.maybe_build(W, cache_obj=self, attr="_accel_gd",
                                     device=dev)
        if acc is not None:
            v0 = np.zeros(n)
            v0[train_ind] = 1.0
            v0 /= v0.sum()
            u, self.iters = acc.poisson_gd(
                acc.to_perm(deg), acc.to_perm(b / deg[:, None]),
                acc.to_perm(torch.as_tensor(v0, device=dev).to(dtype)),
                self.min_iter, self.max_iter, n)
            return acc.from_perm(u)
        u, self.iters = _poisson_gradient_descent(
            g, b, train_ind, self.min_iter, self.max_iter)
        return u


def _poisson_gradient_descent(g: SparseGraph, b, train_ind, min_iter,
                              max_iter):
    """Poisson GD ``u <- D^-1 b + D^-1 W^T u`` until the random walk from
    the labeled set mixes (``max|v - v_inf| <= 1/n``), at least
    ``min_iter`` and at most ``max_iter`` steps.  Returns ``(u, iters)``."""
    n = g.n
    deg = _ops.degree_vector(g)
    dinv = 1.0 / deg
    Db = dinv[:, None] * b
    v = torch.zeros(n, dtype=b.dtype, device=b.device)
    v[torch.as_tensor(np.asarray(train_ind), device=b.device)] = 1.0
    v = v / torch.sum(v)
    vinf = deg / torch.sum(deg)
    u = torch.zeros_like(b)
    T = 0
    while T < max_iter:
        if T >= min_iter and not bool(torch.max(torch.abs(v - vinf))
                                      > 1.0 / n):
            break
        u = Db + dinv[:, None] * _ops.spmm_t(g, u)
        v = _ops.spmm_t(g, dinv * v)
        T += 1
    return u, T


# -- MBO: PoissonMBO and VolumeMBO --------------------------------------------


class poisson_mbo(ssl):
    """PoissonMBO: Poisson learning's labels, then T rounds of Ns heat
    steps ``u <- u - dt L u + mu dt source`` (``dt = 1 / max degree``),
    each followed by the volume projection onto ``class_priors`` and a
    one-hot threshold.  The parameters are the JAX package's, in its
    order, with ``device`` last; ``use_cuda`` is accepted and ignored (the
    device comes from ``device``).  The heat steps run on the bf16 band or
    the gather where :func:`~ops.accel.maybe_build` takes one (a threshold
    follows them, so the bf16 band's rounding does not matter), else on
    the plain ELL path; the projection loops stay on the device.  With
    ``all_labels`` the fit prints each round's accuracy."""

    def __init__(self, W=None, class_priors=None, solver="conjugate_gradient",
                 use_cuda=False, min_iter=50, max_iter=1000, tol=1e-3,
                 spectral_cutoff=10, Ns=40, mu=1, T=20, device=None):
        if solver == "spectral":
            raise NotImplementedError(
                "poisson_mbo solver='spectral' needs the eigensolvers (P10), "
                "not ported yet")
        super().__init__(W, class_priors, device=device)
        self.poisson_model = poisson(W, solver=solver, min_iter=min_iter,
                                     max_iter=max_iter, tol=tol,
                                     spectral_cutoff=spectral_cutoff,
                                     device=device)
        self.Ns = Ns
        self.mu = mu
        self.T = T
        self.name = "Poisson MBO"

    def _fit(self, train_ind, train_labels, all_labels=None):
        n = self.graph.num_nodes
        dev = self.graph.device
        dtype = config.float_dtype(dev)
        k = len(np.unique(train_labels))
        W, G = self._nodiag_graph()
        g = G.sparse
        onehot = utils.labels_to_onehot(train_labels, k)
        source = np.zeros((n, k))
        source[train_ind] = onehot - np.mean(onehot, axis=0)
        labels = self.poisson_model.fit_predict(train_ind, train_labels)
        as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(dtype)
        u = as_t(utils.labels_to_onehot(labels, k))
        deg = _ops.degree_vector(g)
        dt = 1.0 / float(torch.max(deg))
        Db = as_t(self.mu * dt * source)
        if isinstance(self.weights, int):
            self.weights = np.ones((k,))
        # the bf16 band (K2 bf16) or the gather with its "auto" table
        acc = _accel.maybe_build(W, cache_obj=self, attr="_accel_mbo",
                                 device=dev, mode="bf16")
        if acc is not None:
            deg_p, Db_p = acc.to_perm(deg), acc.to_perm(Db)

            def heat_steps(u):
                return acc.from_perm(acc.heat_steps(
                    deg_p, acc.to_perm(u), Db_p, dt, self.Ns))
        else:
            def heat_steps(u):
                for _ in range(self.Ns):
                    u = u - dt * (deg[:, None] * u - _ops.spmm(g, u)) + Db
                return u

        if all_labels is None:
            u, w, err = _volume.poisson_mbo_loop(
                heat_steps, u, as_t(self.weights), as_t(self.class_priors),
                self.T)
            self.weights = w.cpu().numpy().astype(float)
            self.class_priors_error = float(err)
            return u
        # verbose path: each round's accuracy
        for i in range(self.T):
            self.prob = heat_steps(u).cpu().numpy()
            labels = self.volume_label_projection()
            u = as_t(utils.labels_to_onehot(labels, k))
            print("%d, Accuracy = %.2f"
                  % (i, ssl_accuracy(labels, all_labels, train_ind)))
        return u


class volume_mbo(ssl):
    """VolumeMBO (auction dynamics with volume constraints): a Voronoi
    start from the closest labeled node (Bellman-Ford closest points),
    then until no label changes, the dual convolution ``D^-1 W D^-1 W``
    of the one-hot labels, annealed Gumbel noise at ``temperature > 0``,
    and the volume-constrained assignment with class counts in
    ``[floor(v c), ceil((2 - v) c)]`` (``v`` the volume constraint, ``c``
    the counts of ``class_priors``).  ``self.voronoi_info`` holds the
    start's rounds and path, ``self.iters`` the MBO iterations.  The
    parameters are the JAX package's, in its order, with ``device``
    last.  The noise comes from a
    ``torch.Generator`` on the fit's device, seeded from ``seed`` or, when
    it is None, from ``np.random.randint(2**31)``.  The convolutions and
    the Voronoi start run on the bf16 band (K2, K7) or the gather (its
    ``bellman_ford``) where :func:`~ops.accel.maybe_build` takes one,
    else on the plain ELL path.  With ``all_labels`` the fit prints each
    iteration's accuracy."""

    def __init__(self, W=None, class_priors=None, temperature=0.1,
                 volume_constraint=0.5, max_iters=300, seed=None,
                 device=None):
        super().__init__(W, None, device=device)
        if class_priors is None:
            sys.exit("Class priors must be provided for Volume MBO.")
        self.class_counts = (self.graph.num_nodes * np.asarray(class_priors)
                             / np.sum(class_priors)).astype(int)
        self.temperature = temperature
        self.volume_constraint = volume_constraint
        self.max_iters = max_iters
        self.seed = seed
        self.name = "Volume MBO (T=%.2f, V=%.2f)" % (temperature,
                                                     volume_constraint)

    def _fit(self, train_ind, train_labels, all_labels=None):
        n = self.graph.num_nodes
        dev = self.graph.device
        dtype = config.float_dtype(dev)
        k = len(np.unique(train_labels))
        W, G = self._nodiag_graph()
        g = G.sparse
        acc = _accel.maybe_build(W, cache_obj=self, attr="_accel_vmbo",
                                 device=dev, mode="bf16")
        self.voronoi_info = {}
        _, cp = _eik.dijkstra(g, train_ind, bdy_val=np.zeros(len(train_ind)),
                              return_cp=True, accel=acc,
                              info=self.voronoi_info)
        lab_of = np.full(n, -1, dtype=int)
        lab_of[train_ind] = train_labels
        labels = np.array(lab_of[np.maximum(cp, 0)])
        labels[labels < 0] = 0
        labels[train_ind] = train_labels

        fixed = np.zeros(n, dtype=bool)
        fixed[train_ind] = True
        fixed_labels = np.zeros(n, dtype=int)
        fixed_labels[train_ind] = train_labels
        vc = self.volume_constraint
        as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
        lower = as_t(np.floor(vc * self.class_counts)).to(dtype)
        upper = as_t(np.ceil((2 - vc) * self.class_counts)).to(dtype)
        fixed, fixed_labels = as_t(fixed), as_t(fixed_labels)

        deg = _ops.degree_vector(g)
        if acc is not None:
            deg_p = acc.to_perm(deg)
            dinv_p = torch.where(deg_p > 0, 1.0 / torch.where(
                deg_p == 0, torch.ones_like(deg_p), deg_p),
                torch.zeros_like(deg_p))

            def dual_conv(labels):
                return acc.dual_conv_labels(dinv_p, labels, k)
        else:
            dinv = torch.where(deg > 0, 1.0 / torch.where(
                deg == 0, torch.ones_like(deg), deg), torch.zeros_like(deg))

            def dual_conv(labels):
                a = dinv[:, None] * _ops.spmm(
                    g, _volume._onehot(labels, k, dtype))
                return dinv[:, None] * _ops.spmm(g, a)

        seed = (int(np.random.randint(2**31)) if self.seed is None
                else int(self.seed))
        gen = torch.Generator(device=dev).manual_seed(seed)
        draw = _volume.gumbel(gen, dtype)
        temp = self.temperature
        report = None
        if all_labels is not None:
            def report(old, state):
                # verbose path: each iteration's accuracy
                print("%d, changed=%d, Accuracy = %.2f" % (
                    state[1] - 1, int(torch.sum(state[0] != old)),
                    ssl_accuracy(state[0].cpu().numpy(), all_labels,
                                 train_ind)))
        labels, self.iters = _volume.mbo_loop(
            dual_conv, as_t(labels), fixed, fixed_labels, lower, upper, temp,
            draw, n_true=n, max_iters=self.max_iters, on_round=report)
        labels = labels.cpu().numpy()
        labels[train_ind] = train_labels
        return utils.labels_to_onehot(labels, k)


# -- distance and Lipschitz models --------------------------------------------


def _density_speed(D, alpha):
    """Eikonal speed ``(d / max d)^alpha`` from the kNN distance matrix
    ``D`` (``d`` the distance to the farthest neighbor), or 1."""
    if D is None:
        return 1
    d = np.asarray(D.max(axis=1).todense()).ravel()
    return (d / np.max(d)) ** alpha


class graph_nearest_neighbor(ssl):
    """Geodesic nearest-neighbor classifier: each node takes the label of
    its closest labeled node (Bellman-Ford closest points, on the plain
    ELL path as in the JAX package), with an optional kNN-density speed.
    With class priors, one-vs-rest distances instead."""

    def __init__(self, W=None, class_priors=None, D=None, alpha=1,
                 device=None):
        super().__init__(W, class_priors, device=device)
        self.alpha = alpha
        if class_priors is not None:
            self.onevsrest = True
            self.similarity = False
        self.f = _density_speed(D, alpha)
        self.name = "Graph NN (alpha=%.2f)" % self.alpha

    def _fit(self, train_ind, train_labels, all_labels=None):
        g = self.graph.sparse
        info = {}
        if self.onevsrest:
            u = _eik.dijkstra(g, train_ind[train_labels], bdy_val=0,
                              f=self.f, info=info)
            self.iters = info["iters"]
            return u
        _, cp = _eik.dijkstra(g, train_ind, bdy_val=np.zeros(len(train_ind)),
                              f=self.f, return_cp=True, info=info)
        self.iters = info["iters"]
        lab_of = np.zeros(self.graph.num_nodes, dtype=int)
        lab_of[train_ind] = train_labels
        k = len(np.unique(train_labels))
        return utils.labels_to_onehot(lab_of[cp], k)


def _onehot_bdy(train_labels, unique_labels):
    return (train_labels[:, None] == unique_labels[None, :]).astype(float)


def _lip_accel(model):
    """The band of the Lipschitz fits: an f32 band where JAX takes a bf16
    one (``exact=False, fast=True``).  In bf16 the sweeps of the p-Laplace
    fit round the window of u to 8 bits each block, stop much later and
    move the prediction: on the 65536-node moons input 2602 sweeps against
    2129, agreeing with the plain path on 0.9878 of the nodes against
    0.9975 (``tools/lip_paths.py`` on an H100).  The fits run only on a
    stored band, so no gather is built for them."""
    return _accel.maybe_build(model.graph.weight_matrix, cache_obj=model,
                              attr="_accel_dist", device=model.graph.device,
                              mode="f32", gather=False)


class amle(ssl):
    """AMLE (infinity-Laplace) learning, one-vs-rest.  Unweighted, it takes
    the band path where it applies (harmonic warm start on K2, then
    block-Gauss-Seidel sweeps over the K4 band); otherwise a Voronoi warm
    start and Jacobi rounds on the ELL.  ``self.path`` says which ran.
    The two starts stop at different iterates unless ``tol`` is tight: at
    the default 1e-3 they can disagree on a tenth of the nodes."""

    def __init__(self, W=None, class_priors=None, tol=1e-3, max_num_it=10**5,
                 weighted=False, prog=False, device=None):
        super().__init__(W, class_priors, device=device)
        self.tol = tol
        self.max_num_it = max_num_it
        self.weighted = weighted
        self.onevsrest = True
        self.name = "AMLE"

    def _fit(self, train_ind, train_labels, all_labels=None):
        return self.graph.amle(train_ind, train_labels.astype(float),
                               tol=self.tol, max_num_it=self.max_num_it,
                               weighted=self.weighted)

    def _fit_onevsrest(self, train_ind, train_labels, unique_labels):
        acc = _lip_accel(self)
        info = {}
        u = _pl.amle_mc(self.graph.sparse, train_ind,
                        _onehot_bdy(train_labels, unique_labels),
                        tol=self.tol, accel=acc,
                        bucketed=self.graph.bucketed(),
                        max_num_it=self.max_num_it, weighted=self.weighted,
                        info=info)
        self.iters, self.path, self.info = info["iters"], info["path"], info
        return u


class peikonal(ssl):
    """p-eikonal learning: one-vs-rest distance scores (smaller is
    closer), by the class-batched Jacobi solver on the ELL."""

    def __init__(self, W=None, class_priors=None, D=None, p=1, alpha=1,
                 max_num_it=10**5, tol=1e-3, num_bisection_it=30,
                 eps_ball_graph=False, device=None):
        super().__init__(W, class_priors, device=device)
        self.p = p
        self.alpha = alpha
        self.max_num_it = max_num_it
        self.tol = tol
        self.num_bisection_it = num_bisection_it
        self.onevsrest = True
        self.similarity = False
        if D is None and eps_ball_graph:
            d = self.graph.degree_vector()
            self.f = (d / np.max(d)) ** (-alpha)
        else:
            self.f = _density_speed(D, alpha)
        self.name = "p-eikonal (p=%.2f, alpha=%.2f)" % (self.p, self.alpha)

    def _fit(self, train_ind, train_labels, all_labels=None):
        return self.graph.peikonal(train_ind[train_labels], bdy_val=0,
                                   f=self.f, p=self.p,
                                   max_num_it=self.max_num_it, tol=self.tol,
                                   num_bisection_it=self.num_bisection_it)

    def _fit_onevsrest(self, train_ind, train_labels, unique_labels):
        info = {}
        u = _eik.peikonal_mc(
            self.graph.sparse,
            [train_ind[train_labels == l] for l in unique_labels], f=self.f,
            p=self.p, max_num_it=self.max_num_it, tol=self.tol,
            num_bisection_it=self.num_bisection_it, info=info)
        self.iters = info["iters"]
        return u


class plaplace(ssl):
    """Game-theoretic p-Laplace learning, one-vs-rest.  The ``fast``
    iteration takes the band path where it applies (as :class:`amle`);
    otherwise a Voronoi warm start and Jacobi rounds on the ELL."""

    def __init__(self, W=None, class_priors=None, p=10, max_num_it=10**6,
                 tol=1e-1, fast=True, device=None):
        super().__init__(W, class_priors, device=device)
        self.p = p
        self.max_num_it = max_num_it
        self.tol = 1e-5 if fast else tol
        self.onevsrest = True
        self.fast = fast
        self.name = "p-Laplace (p=%.2f)" % self.p

    def _fit(self, train_ind, train_labels, all_labels=None):
        return self.graph.plaplace(train_ind, train_labels.astype(float),
                                   self.p, max_num_it=self.max_num_it,
                                   tol=self.tol)

    def _fit_onevsrest(self, train_ind, train_labels, unique_labels):
        acc = _lip_accel(self) if self.fast else None
        info = {}
        u = _pl.plaplace_mc(self.graph.sparse, train_ind,
                            _onehot_bdy(train_labels, unique_labels), self.p,
                            max_num_it=self.max_num_it, tol=self.tol,
                            fast=self.fast, accel=acc,
                            bucketed=self.graph.bucketed(), info=info)
        self.iters, self.path = info.get("iters"), info.get("path")
        self.info = info
        return u
