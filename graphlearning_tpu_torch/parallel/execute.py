"""Sharded model execution: the distribution layer the models run on.

Counterpart of ``graphlearning_tpu/parallel/execute.py:39-506`` and
``:587-602`` (the Laplace, Poisson CG and gradient descent, PoissonMBO and
random-walk fits; the other sharded fits come with P15b).

A :class:`Distributor`, made from a :class:`config.GLTConfig`, a
:class:`parallel.mesh.Mesh` or ``"auto"``,

* builds each graph's sharded operator (:meth:`Distributor.operator`):
  the partitioned tiled band (K1 and K3 with the ring halo), the ELL
  rows with an all-gathered X, or the capped ELL plus spill of a
  degree-skewed graph; the route is decided in the open and kept on the
  operator (``op.route``), and a failure to build or launch propagates;
* places each fit's per-node inputs as this rank's rows
  (:meth:`Distributor.put_rows`; padding rows are decoupled identity rows
  with degree 0 and a zero right-hand side), and
* runs the single-device solvers on them (``ssl._laplace_constrained``,
  ``ssl._cg_scaled_solve``, ``solvers.volume.poisson_mbo_loop``): every
  reduction over the nodes goes through :meth:`Distributor.reduce`, an
  all-reduce, so every rank takes the same branch on the same scalar.

Each fit returns the whole solution on every rank, in the caller's node
order, with the solver's iteration count where it has one.
"""

from __future__ import annotations

import numpy as np
import torch

from graphlearning_tpu_torch import config as _config
from graphlearning_tpu_torch.core.sparse import SparseGraph
from graphlearning_tpu_torch.ops import graphops as _ops
from graphlearning_tpu_torch.parallel import shard as _shard
from graphlearning_tpu_torch.parallel.mesh import (Mesh, node_sharding,
                                                   replicated)


class Distributor:
    """Runtime handle of one mesh: the operators of its graphs and the
    placement of per-node arrays.  Made from a ``GLTConfig``, a ``Mesh``,
    another ``Distributor``, or ``"auto"`` (None): the default config's
    mesh over the initialized process group (world size 1 without
    one)."""

    def __init__(self, spec="auto"):
        if isinstance(spec, Distributor):
            cfg, mesh = spec.config, spec.mesh
        elif isinstance(spec, Mesh):
            cfg, mesh = None, spec
        elif isinstance(spec, _config.GLTConfig):
            cfg, mesh = spec, spec.make_mesh()
        elif spec is None or (isinstance(spec, str) and spec == "auto"):
            cfg = _config.GLTConfig()
            mesh = cfg.make_mesh()
        else:
            raise TypeError(f"cannot build a Distributor from {spec!r}")
        self.config = cfg or _config.GLTConfig(
            mesh_axes=mesh.axis_names, node_axis=mesh.node_axis)
        self.mesh = mesh
        self.axis = self.config.node_axis
        if self.axis != mesh.node_axis:
            raise ValueError(f"node axis {self.axis!r} is not the mesh's "
                             f"{mesh.node_axis!r}")
        self.P = mesh.size
        self.device = mesh.device
        self.last_op = None     # the operator of the last fit
        # the key of W's operator cache: two meshes never share one
        self._key = ("mesh", mesh.size, mesh.rank, str(mesh.device),
                     id(mesh.group), self.axis)

    @property
    def route(self):
        """The route of the last fit's operator (None before a fit)."""
        return None if self.last_op is None else self.last_op.route

    def reduce(self, t, op: str = "sum"):
        """``t`` summed (or maximized) over the ranks: the reduction over
        the nodes that the sharded solvers pass down."""
        return self.mesh.all_reduce(t, op)

    # -- the sharded SpMM operator ------------------------------------------

    def _band_params(self):
        """``(R, WT, mode)`` of the partitioned band: the config's, else
        512 on CUDA and 64 on the CPU (K3 takes multiples of 64), and
        "f32" on CUDA (the exact grade) and "f64" on the CPU."""
        cpu = self.device.type == "cpu"
        R = self.config.band_R or (64 if cpu else 512)
        WT = self.config.band_WT or R
        mode = self.config.band_mode or ("f64" if cpu else "f32")
        return R, WT, mode

    def operator(self, W, transpose: bool = False,
                 need_slots: bool = False):
        """This rank's sharded operator for ``W`` (scipy) and the unpadded
        node count, ``(op, n)``.  ``op.n`` is the rank's row count, which
        every per-node array of the fit has (:meth:`put_rows` with
        ``op``); a banded op carries the RCM permutation that
        :meth:`put_rows` and :meth:`gather` apply.  ``transpose`` builds
        it on ``W.T``; ``need_slots`` keeps the full ELL of a
        degree-skewed graph.

        The route (``config.sharded_kernel``): "banded" and "gspmd" force
        the band or the ELL rows; "auto" takes the band only on CUDA, when
        ``n >= 4 P max(R, WT)``, the graph is not band-hostile
        (``ops.accel._band_hostile``) and at most ``band_max_residual``
        of the edges fall outside the halos.  ``op.route`` says which:
        "banded", "gspmd" or "bucketed" (the capped ELL of a
        degree-skewed graph).  Cached on ``W`` per mesh and route."""
        import scipy.sparse as sp

        kernel = self.config.sharded_kernel
        R, WT, mode = self._band_params()
        key = (self._key, kernel, bool(transpose), bool(need_slots), R, WT,
               mode)
        cache = getattr(W, "_gltt_shard_cache", None)
        if isinstance(cache, dict) and key in cache:
            self.last_op = cache[key][0]
            return cache[key]
        W0, W = W, sp.csr_matrix(W)
        n = W.shape[0]
        use_band = kernel == "banded"
        if kernel == "auto":
            from graphlearning_tpu_torch.ops.accel import _band_hostile

            use_band = (self.device.type == "cuda"
                        and n >= 4 * self.P * max(R, WT)
                        and not _band_hostile(W))
        entry = None
        if use_band:
            entry = self._build_band_op(W, R, WT, mode, transpose,
                                        strict=kernel == "banded")
        if entry is None:
            Wd = W.T.tocsr() if transpose else W
            if not need_slots and self._degree_skewed(Wd):
                g, n = _shard.build_sharded_bucketed(
                    Wd, self.mesh, dtype=self._dtype())
                g.route = "bucketed"
            else:
                g, n = self.shard_graph(Wd)
                g.route = "gspmd"
            entry = (g, n)
        else:
            entry[0].route = "banded"
        self._remember(W0, key, entry)
        self.last_op = entry[0]
        return entry

    def _remember(self, W, key, entry):
        cache = getattr(W, "_gltt_shard_cache", None)
        if not isinstance(cache, dict):
            cache = W._gltt_shard_cache = {}
        cache[key] = entry

    def _dtype(self):
        return self.config.resolve_dtype(self.device)

    @staticmethod
    def _degree_skewed(W) -> bool:
        """True when a full padded ELL would waste over 2x the slots of
        one capped at the 95th-percentile degree (hub-degree graphs)."""
        import scipy.sparse as sp

        deg = np.diff(sp.csr_matrix(W).indptr)
        if len(deg) == 0 or deg.max() == 0:
            return False
        return float(deg.max()) > 2.0 * float(np.percentile(deg, 95))

    def _build_band_op(self, W, R, WT, mode, transpose, strict=False):
        """RCM-reorder ``W`` and build its partitioned band operator; None
        (the ELL route) when the residual share is over
        ``band_max_residual``, unless ``strict``."""
        import scipy.sparse as sp
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        from graphlearning_tpu_torch.parallel.band_shard import (
            make_sharded_op)

        W = sp.csr_matrix(W)
        if transpose:
            W = W.T.tocsr()
        perm = np.asarray(reverse_cuthill_mckee(W, symmetric_mode=True))
        Wp = W[perm, :][:, perm].tocsr()
        op = make_sharded_op(Wp, self.mesh, R=R, WT=WT, mode=mode,
                             ell_dtype=self._dtype())
        if not strict and op.residual_frac > self.config.band_max_residual:
            return None
        op._perm = perm
        return op, W.shape[0]

    # -- shardings and placement ----------------------------------------------

    def rows(self, ndim: int = 2):
        """Leading (node) axis sharded, rest replicated."""
        return node_sharding(self.mesh, ndim)

    def replicated(self):
        return replicated(self.mesh)

    def pad_rows(self, X, fill=0.0, n_pad=None):
        """Host-side pad of the leading axis to ``n_pad`` rows (a multiple
        of the mesh size when None)."""
        X = np.asarray(X)
        extra = ((n_pad - X.shape[0]) if n_pad is not None
                 else (-X.shape[0]) % self.P)
        if extra:
            X = np.concatenate([X, np.full((extra,) + X.shape[1:], fill,
                                           dtype=X.dtype)])
        return X

    def put_rows(self, X, fill=0.0, dtype=None, op=None):
        """This rank's rows of the per-node host array ``X`` on the mesh's
        device: with ``op`` (from :meth:`operator`) in its RCM order and
        padded to its rows; padding rows hold ``fill``.  ``dtype``: a
        torch dtype, else X's."""
        X = np.asarray(X)
        perm = getattr(op, "_perm", None)
        if perm is not None:
            X = X[perm]
        n_pad = op.n * self.P if op is not None else None
        X = self.pad_rows(X, fill=fill, n_pad=n_pad)
        B = X.shape[0] // self.P
        r0 = self.mesh.rank * B
        t = torch.tensor(X[r0:r0 + B], device=self.device)
        return t if dtype is None else t.to(dtype)

    def shard_graph(self, W) -> tuple:
        """This rank's rows of ``W`` (scipy or SparseGraph) on the ELL
        route, padded to a multiple of the mesh size (padding rows: degree
        0, ``vals`` 0, self columns): ``(graph, n)``.  Cached on ``W``."""
        cache = getattr(W, "_gltt_shard_cache", None)
        if isinstance(cache, dict) and self._key in cache:
            return cache[self._key]
        n = W.n if isinstance(W, SparseGraph) else W.shape[0]
        entry = (_shard.shard_graph(W, self.mesh, dtype=self._dtype()), n)
        self._remember(W, self._key, entry)
        return entry

    def valid_mask(self, n_orig: int, n_pad: int, op=None):
        """This rank's rows of the ``(n_pad,)`` mask of real rows (RCM
        permutes the real rows among themselves; padding follows
        them)."""
        v = np.zeros(n_pad, dtype=bool)
        v[:n_orig] = True
        return self.put_rows(v)

    def gather(self, X, n_orig: int, op=None):
        """Every rank's rows of ``X`` to the host, padding dropped and the
        operator's RCM permutation undone."""
        out = self.mesh.all_gather(X).cpu().numpy()[:n_orig]
        perm = getattr(op, "_perm", None)
        if perm is not None:
            res = np.empty_like(out)
            res[perm] = out
            return res
        return out


# -- the sharded fits ----------------------------------------------------------


def safe_inv_sqrt_deg(deg):
    """``deg^-1/2``, 0 on degree-0 (padding) rows."""
    ok = deg > 0
    return torch.where(ok, torch.where(ok, deg, torch.ones_like(deg))
                       ** -0.5, torch.zeros_like(deg))


def safe_inv_deg(deg):
    """``1 / deg``, 0 on degree-0 (padding) rows."""
    ok = deg > 0
    return torch.where(ok, 1.0 / torch.where(ok, deg, torch.ones_like(deg)),
                       torch.zeros_like(deg))


def laplace_fit_sharded(dist: Distributor, W, train_mask, bdy_values, tau,
                        tol, normalization, order, max_iter=10**5,
                        u0=None):
    """Laplace learning's masked CG on the mesh (``ssl._laplace_constrained``
    with the mesh's reduction): padding rows enter as labeled rows of
    value 0, decoupled identity rows.  ``u0``: a warm start.  Returns
    ``(u, iters)``."""
    from graphlearning_tpu_torch import ssl as _ssl

    g, n = dist.operator(W)
    dtype = dist._dtype()
    mask = dist.put_rows(np.asarray(train_mask, dtype=bool), fill=True, op=g)
    bdy = dist.put_rows(bdy_values, dtype=dtype, op=g)
    tau_t = dist.put_rows(np.broadcast_to(np.atleast_1d(tau), (n,)),
                          dtype=dtype, op=g)
    if u0 is not None:
        u0 = dist.put_rows(np.asarray(u0), dtype=dtype, op=g)
    u, iters = _ssl._laplace_constrained(
        g, tau_t, mask, bdy, tol, normalization=normalization,
        order=int(order), max_iter=int(max_iter), u0=u0, reduce=dist.reduce)
    return dist.gather(u, n, op=g), iters


def poisson_cg_fit_sharded(dist: Distributor, W, source, tol,
                           max_iter=10**5, u0=None):
    """Poisson learning's CG on the normalized Laplacian, on the mesh:
    ``D^-1/2`` guarded on padding rows (identity rows, zero right-hand
    side), the kernel component projected out over the real rows.
    ``u0``: a warm start in the original (unscaled) space.  Returns
    ``(u, iters)``."""
    from graphlearning_tpu_torch import ssl as _ssl

    g, n = dist.operator(W)
    dtype = dist._dtype()
    b = dist.put_rows(source, dtype=dtype, op=g)
    deg = _ops.degree_vector(g)
    s = safe_inv_sqrt_deg(deg)
    x0 = None
    if u0 is not None:
        x0 = (dist.put_rows(np.asarray(u0), dtype=dtype, op=g)
              * torch.sqrt(torch.clamp(deg, min=0.0))[:, None])
    v, iters = _ssl._cg_scaled_solve(g, s, s[:, None] * b, 1.0, 1.0, tol,
                                     max_iter=int(max_iter), x0=x0,
                                     reduce=dist.reduce)
    v = _ssl._project_out_nlap_kernel(v, deg, reduce=dist.reduce)
    return dist.gather(s[:, None] * v, n, op=g), iters


def _poisson_gd_sharded(g, deg, Db, v0, *, min_iter, max_iter, n_true,
                        reduce):
    """Poisson gradient descent ``u <- Db + D^-1 W u`` until the random
    walk from the labels mixes (``max |v - v_inf| <= 1 / n_true``), at
    least ``min_iter`` and at most ``max_iter`` steps, padding-aware
    (``v_inf`` 0 on padding rows, the sums over the mesh).  For a directed
    graph ``g``'s product is ``W^T u`` and ``deg`` the row sums of W.
    Returns ``(u, iters)``."""
    dinv = safe_inv_deg(deg)
    vinf = deg / reduce(torch.sum(deg))
    u = torch.zeros_like(Db)
    v = v0
    T = 0
    while T < max_iter:
        if T >= min_iter and not bool(
                reduce(torch.max(torch.abs(v - vinf)), "max") > 1.0 / n_true):
            break
        u = Db + dinv[:, None] * _ops.spmm(g, u)
        v = _ops.spmm(g, dinv * v)
        T += 1
    return u, T


def poisson_gd_fit_sharded(dist: Distributor, W, source, train_ind,
                           min_iter, max_iter):
    """Poisson learning's gradient descent on the mesh.  A directed graph
    keeps the JAX package's contract: the operator is built on ``W.T``
    (the reference iterates with ``D^-1 W^T``) and the degrees are the
    row sums of W.  Returns ``(u, iters)``."""
    symmetric = (W != W.T).nnz == 0
    g, n = dist.operator(W, transpose=not symmetric)
    dtype = dist._dtype()
    b = dist.put_rows(source, dtype=dtype, op=g)
    if symmetric:
        deg = _ops.degree_vector(g)
    else:
        deg = dist.put_rows(np.asarray(W.sum(1)).ravel(), dtype=dtype, op=g)
    Db = safe_inv_deg(deg)[:, None] * b
    v0 = np.zeros(n)
    v0[np.asarray(train_ind)] = 1.0
    v0 /= v0.sum()
    v0 = dist.put_rows(v0, dtype=dtype, op=g)
    u, iters = _poisson_gd_sharded(g, deg, Db, v0, min_iter=int(min_iter),
                                   max_iter=int(max_iter), n_true=int(n),
                                   reduce=dist.reduce)
    return dist.gather(u, n, op=g), iters


def poisson_mbo_fit_sharded(dist: Distributor, W, source_scaled, u0, w0,
                            priors, dt, Ns, T):
    """PoissonMBO's T rounds on the mesh (``solvers.volume.poisson_mbo_loop``
    with the real rows' mask and the mesh's reduction): padding rows stay
    0 and out of the class sizes.  Returns ``(u, w, err)``."""
    from graphlearning_tpu_torch.solvers import volume as _volume

    g, n = dist.operator(W)
    dtype = dist._dtype()
    deg = _ops.degree_vector(g)
    Db = dist.put_rows(source_scaled, dtype=dtype, op=g)
    u0 = dist.put_rows(u0, dtype=dtype, op=g)
    valid = dist.valid_mask(n, g.n * dist.P, op=g)
    as_t = lambda a: torch.as_tensor(np.asarray(a),
                                     device=dist.device).to(dtype)

    def heat_steps(u):
        for _ in range(int(Ns)):
            u = u - dt * (deg[:, None] * u - _ops.spmm(g, u)) + Db
        return u

    u, w, err = _volume.poisson_mbo_loop(heat_steps, u0, as_t(w0),
                                         as_t(priors), int(T), valid=valid,
                                         reduce=dist.reduce)
    return dist.gather(u, n, op=g), w.cpu().numpy(), float(err)


def randomwalk_fit_sharded(dist: Distributor, W, F, alpha, tau, tol=1e-10):
    """Lazy random-walk learning on the mesh: CG on ``((1 + tau) I - alpha
    D^-1/2 W D^-1/2) u = F``, ``D^-1/2`` guarded on padding rows.  Returns
    ``(u, iters)``."""
    from graphlearning_tpu_torch import ssl as _ssl

    g, n = dist.operator(W)
    dtype = dist._dtype()
    Ft = dist.put_rows(F, dtype=dtype, op=g)
    s = safe_inv_sqrt_deg(_ops.degree_vector(g))
    u, iters = _ssl._cg_scaled_solve(g, s, Ft, 1.0 + float(tau),
                                     float(alpha), tol, reduce=dist.reduce)
    return dist.gather(u, n, op=g), iters
