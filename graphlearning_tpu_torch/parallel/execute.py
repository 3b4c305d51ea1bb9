"""Sharded model execution: the distribution layer the models run on.

Counterpart of ``graphlearning_tpu/parallel/execute.py``: the Laplace,
Poisson (CG and gradient descent), PoissonMBO, VolumeMBO, random-walk,
centered-kernel, sparse label propagation and INCRES fits, the distance
and Lipschitz fits (Bellman-Ford on K7 over the halo, the Lipschitz
rounds on K9, the p-eikonal and weighted AMLE rounds on the halo gather)
and the sharded eigensolvers (LOBPCG over the ranks).

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
  ``ssl._cg_scaled_solve``, ``solvers.volume.poisson_mbo_loop``,
  ``solvers.eikonal._bellman_ford``, ``solvers.plaplace._lip_loop``,
  ``solvers.eig.eigen_decomp``, ...): every reduction over the nodes goes
  through :meth:`Distributor.reduce`, an all-reduce, so every rank takes
  the same branch on the same scalar.  VolumeMBO's assignment and INCRES's
  seeding read all n nodes: they run whole on every rank, in the
  operator's padded row space (:meth:`Distributor.put_all`), on the
  all-gathered products, as the JAX package's sharded loops read every
  node.

The random draws are independent of the mesh and the route: each comes
from the fit's seeded generator over the true node count in node order,
the plain single-device fit's draw, seen through the operator's order
(:class:`RowSpace` for a rank's rows, :meth:`Distributor.all_rows` for a
loop run whole on every rank).  Each fit returns the whole solution on
every rank, in the caller's node order, with the solver's iteration
count where it has one.
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
        """``t`` summed (or maximized, minimized) over the ranks: the
        reduction over the nodes that the sharded solvers pass down."""
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
                 need_slots: bool = False, exact: bool = False):
        """This rank's sharded operator for ``W`` (scipy) and the unpadded
        node count, ``(op, n)``.  ``op.n`` is the rank's row count, which
        every per-node array of the fit has (:meth:`put_rows` with
        ``op``); a banded op carries the RCM permutation that
        :meth:`put_rows` and :meth:`gather` apply.  ``transpose`` builds
        it on ``W.T``; ``need_slots`` keeps the full ELL of a
        degree-skewed graph (the gathers of the distance and Lipschitz
        fits read every slot); ``exact`` builds a band of ``band_mode``
        "bf16" at f32 (those fits' band, as on one device).

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
        if exact and mode == "bf16":
            mode = "f32"
        # the band keeps every slot: need_slots matters on the ELL route
        key = (self._key, kernel, bool(transpose),
               bool(need_slots) and kernel != "banded", R, WT, mode)
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

    def _op_space(self, X, fill, op):
        """The host array ``X`` in ``op``'s row space: its RCM order,
        padded with ``fill`` to the ranks' rows."""
        X = np.asarray(X)
        perm = getattr(op, "_perm", None)
        if perm is not None:
            X = X[perm]
        n_pad = op.n * self.P if op is not None else None
        return self.pad_rows(X, fill=fill, n_pad=n_pad)

    def put_rows(self, X, fill=0.0, dtype=None, op=None):
        """This rank's rows of the per-node host array ``X`` on the mesh's
        device: with ``op`` (from :meth:`operator`) in its RCM order and
        padded to its rows; padding rows hold ``fill``.  ``dtype``: a
        torch dtype, else X's."""
        X = self._op_space(X, fill, op)
        B = X.shape[0] // self.P
        r0 = self.mesh.rank * B
        t = torch.tensor(X[r0:r0 + B], device=self.device)
        return t if dtype is None else t.to(dtype)

    def put_all(self, X, fill=0.0, dtype=None, op=None):
        """All rows of ``X`` in ``op``'s row space (:meth:`put_rows`
        without the rank's slice), on the mesh's device: the state of a
        loop that runs whole on every rank."""
        t = torch.tensor(self._op_space(X, fill, op), device=self.device)
        return t if dtype is None else t.to(dtype)

    def row_space(self, op, n: int) -> "RowSpace":
        """This rank's rows of ``op``'s row space (``n`` real nodes)."""
        return RowSpace(self, op, n)

    def all_rows(self, X, op, n: int):
        """The node-order tensor ``X`` (n, ...) as the whole of ``op``'s
        row space, ``(op.n * P, ...)``: its RCM order, padding rows 0."""
        out = X.new_zeros((op.n * self.P,) + tuple(X.shape[1:]))
        if getattr(op, "_perm", None) is None:
            out[:n] = X
            return out
        perm = getattr(op, "_perm_t", None)
        if perm is None or perm.device != X.device:
            perm = op._perm_t = torch.as_tensor(
                np.ascontiguousarray(op._perm), device=X.device)
        out[:n] = X[perm]
        return out

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
        return self.node_order(self.mesh.all_gather(X), n_orig, op)

    @staticmethod
    def node_order(X, n_orig: int, op=None):
        """The whole row space ``X`` (a tensor) as a host array in node
        order: padding dropped, ``op``'s RCM permutation undone."""
        out = X.cpu().numpy()[:n_orig]
        perm = getattr(op, "_perm", None)
        if perm is not None:
            res = np.empty_like(out)
            res[perm] = out
            return res
        return out


class RowSpace:
    """This rank's rows of an operator's row space: what
    ``solvers.eig.eigen_decomp`` and the other sharded solves need to know
    of them.  ``reduce`` (the mesh's all-reduce), ``n`` (the real nodes),
    ``row0`` (the global row of the first), ``valid`` (the real rows) and
    :meth:`take`."""

    def __init__(self, dist: Distributor, op, n: int):
        B = op.n
        self.reduce = dist.reduce
        self.n = int(n)
        self.row0 = dist.mesh.rank * B
        rows = np.arange(self.row0, self.row0 + B)
        perm = getattr(op, "_perm", None)
        src = np.minimum(rows, self.n - 1)
        if perm is not None:
            src = perm[src]
        src = np.where(rows < self.n, src, -1)
        self._src = torch.as_tensor(src.astype(np.int64), device=dist.device)
        self.valid = self._src >= 0

    def take(self, X):
        """This rank's rows of the node-order tensor ``X`` (n, ...), in the
        operator's order, padding rows 0: a draw over the n nodes seen
        through the mesh."""
        out = X[self._src.clamp(min=0)]
        keep = self.valid.reshape((-1,) + (1,) * (X.dim() - 1))
        return torch.where(keep, out, torch.zeros((), dtype=out.dtype,
                                                  device=out.device))


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
                            priors, dt, Ns, T, on_round=None):
    """PoissonMBO's T rounds on the mesh (``solvers.volume.poisson_mbo_loop``
    with the real rows' mask and the mesh's reduction): padding rows stay
    0 and out of the class sizes.  ``on_round(i, labels)``, when given, is
    called after round ``i`` with its labels (n,) in node order, gathered
    from the ranks.  Returns ``(u, w, err)``."""
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

    report = None
    if on_round is not None:
        def report(i, state):
            on_round(i, np.argmax(dist.gather(state[0], n, op=g), axis=1))
    u, w, err = _volume.poisson_mbo_loop(heat_steps, u0, as_t(w0),
                                         as_t(priors), int(T), valid=valid,
                                         reduce=dist.reduce, on_round=report)
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


# -- the distance and Lipschitz fits --------------------------------------------


def _bellman_ford_banded(op, d0, cp0, f, hopf_lax: bool, recip: bool,
                         max_iter: int, reduce):
    """Bellman-Ford rounds on the partitioned band: each round one K7
    launch over the rank's block (:meth:`ShardedOp.minplus_round`, its
    argmin in the halo-extended space), one exchange of the 2H boundary
    rows of ``d`` and one of the closest points ``cp`` (int32), whose
    halo-extended copy the argmin indexes directly; only a residual
    edge's argmin, a global column, reads an all-gathered ``cp``.  The
    fixed point of ``solvers.eikonal._bellman_ford``.  Returns ``(d, cp,
    rounds)``."""
    from graphlearning_tpu_torch.solvers import eikonal as _eik

    prep = op.minplus_prep(f)

    def relax(state):
        d, cp = state
        m, a, a_res = op.minplus_round(d, prep, hopf_lax=hopf_lax,
                                       recip=recip)
        m = m.to(d.dtype)
        upd = m < d
        cand = op._halo_map(cp)[a.clamp(min=0).long()]
        if op.has_res:
            cpg = op.mesh.all_gather(cp)
            cand = torch.where(a_res >= 0, cpg[a_res.clamp(min=0).long()],
                               cand)
        found = (a >= 0) | (a_res >= 0)
        return ((torch.where(upd, m, d),
                 torch.where(upd & found, cand, cp)), upd.any())

    (d, cp), rounds = _eik._fixed_point(relax, (d0, cp0), max_iter, reduce)
    return d, cp, rounds


def dijkstra_fit_sharded(dist: Distributor, W, bdy_set, bdy_val, f,
                         return_cp=False, max_iter=10**6, hopf_lax=False,
                         reciprocal_weights=False):
    """Bellman-Ford graph distances on the mesh (``hopf_lax``: the
    Hopf-Lax update): padding rows start at the sentinel with no edge, so
    they never relax.  The banded route runs :func:`_bellman_ford_banded`
    with the 1e30 sentinel (``recip`` on K7 for reciprocal weights); the
    ELL route ``solvers.eikonal._bellman_ford`` with the dtype's largest
    value (``with_vals`` for reciprocal weights), as the JAX package.
    Returns ``(d, rounds)``, or ``(d, cp, rounds)`` with ``return_cp``;
    unreached distances are ``inf``."""
    from graphlearning_tpu_torch.ops.band_spmm import MINPLUS_BIG
    from graphlearning_tpu_torch.solvers import eikonal as _eik

    g, n = dist.operator(W, need_slots=True, exact=True)
    dtype = dist._dtype()
    bdy_set, bdy_val_arr = _eik._boundary_handling(bdy_set, bdy_val)
    f = _eik._speed(f, n)
    banded = hasattr(g, "minplus_")
    big = MINPLUS_BIG if banded else float(torch.finfo(dtype).max)
    d0 = np.full((n,), big)
    d0[bdy_set] = bdy_val_arr
    cp0 = np.full((n,), -1, np.int32)
    cp0[bdy_set] = bdy_set
    d0 = dist.put_rows(d0, fill=big, dtype=dtype, op=g)
    cp0 = dist.put_rows(cp0, fill=-1, op=g)
    fj = dist.put_rows(f, fill=0.0, dtype=dtype, op=g)
    if banded:
        d, cp, rounds = _bellman_ford_banded(
            g, d0, cp0, fj, bool(hopf_lax), bool(reciprocal_weights),
            int(max_iter), dist.reduce)
    else:
        g_run = g
        if reciprocal_weights:
            one = torch.ones((), dtype=g.vals.dtype, device=g.device)
            g_run = g.with_vals(torch.where(
                g.mask(), 1.0 / torch.where(g.vals == 0, one, g.vals),
                torch.zeros_like(g.vals)))
        d, cp, rounds = _eik._bellman_ford(g_run, d0, cp0, fj,
                                           bool(hopf_lax), int(max_iter),
                                           reduce=dist.reduce)
    d = dist.gather(d, n, op=g).astype(float)
    d[d >= big * 0.5] = np.inf
    if return_cp:
        return d, dist.gather(cp, n, op=g), rounds
    return d, rounds


def peikonal_fit_sharded(dist: Distributor, W, bdy_mask, f, p, tol,
                         max_num_it, num_bisection_it):
    """The class-batched p-eikonal Jacobi on the mesh
    (``solvers.eikonal._peikonal_jacobi_mc``, its gather through the halo
    on the banded route), from zero as the JAX package's sharded fit:
    padding rows are boundary rows of value 0 and speed 0.  Returns ``(u,
    rounds)``."""
    from graphlearning_tpu_torch.solvers import eikonal as _eik

    g, n = dist.operator(W, need_slots=True, exact=True)
    dtype = dist._dtype()
    C = np.shape(bdy_mask)[1]
    bdy = dist.put_rows(np.asarray(bdy_mask, bool), fill=True, op=g)
    fj = dist.put_rows(np.asarray(f, float), fill=0.0, dtype=dtype, op=g)
    u0 = dist.put_rows(np.zeros((n, C)), dtype=dtype, op=g)
    tol = max(float(tol), 100 * float(torch.finfo(dtype).eps))
    u, rounds = _eik._peikonal_jacobi_mc(
        g, u0, bdy, fj, tol, p=float(p), max_iter=int(max_num_it),
        num_bisection_it=int(num_bisection_it), reduce=dist.reduce)
    return dist.gather(u, n, op=g), rounds


# The widest C of the Lipschitz rounds on the band (K9 in blocks of 32
# columns); wider ones take the ELL rounds, as the JAX package.
LIP_BAND_CMAX = 128


def _lip_iterate_banded(op, u0, bdy_mask, gvals, alpha, beta, tol,
                        max_iter: int, reduce):
    """The unweighted Lipschitz rounds ``u <- alpha avg + beta (min +
    max) / 2`` with the three reductions of a round from K9 over the
    halo (:meth:`ShardedOp.lip_reduce_`); the fixed point and the
    period-2 stop of ``solvers.plaplace._lip_iterate_mc``.  Returns ``(u,
    rounds)``."""
    from graphlearning_tpu_torch.solvers import plaplace as _pl

    zero = torch.zeros((), dtype=op.vals.dtype, device=op.device)
    wsum = torch.sum(torch.where(op.mask(), op.vals, zero),
                     dim=1).to(u0.dtype)[:, None]
    wsum = torch.where(wsum == 0, torch.ones_like(wsum), wsum)

    def step(u):
        s, mn, mx = op.lip_reduce_(u)
        return alpha * s / wsum + beta * 0.5 * (mn + mx)

    return _pl._lip_loop(step, u0, bdy_mask[:, None], gvals, tol, max_iter,
                         reduce)


def lip_fit_sharded(dist: Distributor, W, bdy_set, bdy_vals, *, alpha=None,
                    beta=None, weighted=False, tol=1e-5, max_num_it=10**5,
                    u0=None):
    """The one-vs-rest p-Laplace / AMLE Lipschitz rounds on the mesh:
    padding rows are boundary rows pinned to 0, the tolerance at least
    100 eps of the dtype.  Unweighted with C <= ``LIP_BAND_CMAX`` on the
    band: :func:`_lip_iterate_banded` (K9); weighted, the bisection rounds
    on the halo gather; otherwise the ELL rounds.  Returns ``(u,
    rounds)``."""
    from graphlearning_tpu_torch.solvers import plaplace as _pl

    g, n = dist.operator(W, need_slots=True, exact=True)
    dtype = dist._dtype()
    bdy_set = np.asarray(bdy_set)
    bdy_vals = np.asarray(bdy_vals, dtype=float)
    C = bdy_vals.shape[1]
    bdy_mask = np.zeros(n, dtype=bool)
    bdy_mask[bdy_set] = True
    gvals = np.zeros((n, C))
    gvals[bdy_set] = bdy_vals
    if u0 is None:
        u0 = np.zeros((n, C))
    mask = dist.put_rows(bdy_mask, fill=True, op=g)
    gv = dist.put_rows(gvals, dtype=dtype, op=g)
    u0 = dist.put_rows(np.asarray(u0, dtype=float), dtype=dtype, op=g)
    tol = max(float(tol), 100 * float(torch.finfo(dtype).eps))
    if weighted:
        u, rounds = _pl._lip_iterate_weighted_mc(
            g, u0, mask, gv, tol, int(max_num_it), reduce=dist.reduce)
    elif hasattr(g, "lip_reduce_") and C <= LIP_BAND_CMAX:
        u, rounds = _lip_iterate_banded(g, u0, mask, gv, float(alpha),
                                        float(beta), tol, int(max_num_it),
                                        dist.reduce)
    else:
        u, rounds = _pl._lip_iterate_mc(g, u0, mask, gv, float(alpha),
                                        float(beta), tol, int(max_num_it),
                                        reduce=dist.reduce)
    return dist.gather(u, n, op=g), rounds


# -- VolumeMBO, the centered kernel, sparse label propagation, INCRES ----------


def volume_mbo_fit_sharded(dist: Distributor, W, labels0, fixed_mask,
                           fixed_labels, lower, upper, temp, draw, k,
                           max_iters, on_round=None):
    """VolumeMBO's fixed point on the mesh: the dual convolution
    ``D^-1 W D^-1 W`` of the one-hot labels on the rank's rows, then
    all-gathered, and the noise and the volume-constrained assignment
    (``solvers.volume.mbo_loop``) whole on every rank in the operator's
    padded row space, the padding rows frozen and out of the counts.
    ``draw((n, k))`` gives the Gumbel noise in node order, the same on
    every rank (the one-device fit's draw), placed in the row space.
    ``on_round(it, changed, labels)``, when given, is called after each
    iteration with its index, the labels it changed and its labels (n,)
    in node order.  Returns ``(labels, iters)`` in node order."""
    from graphlearning_tpu_torch.solvers import volume as _volume

    g, n = dist.operator(W)
    dtype = dist._dtype()
    dinv = safe_inv_deg(_ops.degree_vector(g).to(dtype))[:, None]
    n_pad = g.n * dist.P
    rows = slice(dist.mesh.rank * g.n, (dist.mesh.rank + 1) * g.n)
    valid = torch.arange(n_pad, device=dist.device) < n
    valid_rows = valid[rows, None]
    zero = torch.zeros((), dtype=dtype, device=dist.device)

    def dual_conv(labels):
        u = torch.where(valid_rows, _volume._onehot(labels[rows], k, dtype),
                        zero)
        a = dinv * _ops.spmm(g, u)
        return dist.mesh.all_gather(dinv * _ops.spmm(g, a))

    as_t = lambda a: torch.as_tensor(np.asarray(a),
                                     device=dist.device).to(dtype)
    report = None
    if on_round is not None:
        def report(old, state):
            on_round(state[1] - 1, int(torch.sum(state[0] != old)),
                     dist.node_order(state[0], n, op=g))
    labels, iters = _volume.mbo_loop(
        dual_conv, dist.put_all(np.asarray(labels0, np.int64), op=g),
        dist.put_all(np.asarray(fixed_mask, bool), fill=False, op=g),
        dist.put_all(np.asarray(fixed_labels, np.int64), op=g),
        as_t(lower), as_t(upper), temp,
        lambda shape: dist.all_rows(draw((n,) + tuple(shape[1:])), g, n),
        n_true=n, max_iters=int(max_iters), on_round=report, valid=valid)
    return dist.node_order(labels, n, op=g), iters


def centered_kernel_fit_sharded(dist: Distributor, W, K, train_mask,
                                alpha, tol, power_it, seed, e0=None):
    """The centered kernel method on the mesh (``solvers.centered.solve``
    over the ranks): the centering means over the true n, padding rows
    pinned to 0.  The power iteration starts from ``e0`` (n,) in node
    order, else from the plain fit's draw (``solvers.centered.start``
    seeded by ``seed``).  Returns ``(u, iters)``."""
    from graphlearning_tpu_torch.solvers import centered as _centered

    g, n = dist.operator(W)
    dtype = dist._dtype()
    Kt = dist.put_rows(K, dtype=dtype, op=g)
    mask = dist.put_rows(np.asarray(train_mask, bool), fill=True, op=g)
    rs = dist.row_space(g, n)
    if e0 is None:
        e0 = _centered.start(n, seed, dtype, dist.device)
    else:
        e0 = torch.as_tensor(np.asarray(e0, float).reshape(n, 1),
                             device=dist.device).to(dtype)
    info = {}
    u = _centered.solve(lambda X: _ops.spmm(g, X), Kt, mask, alpha, tol,
                        rs.take(e0), int(power_it), n, valid=rs.valid,
                        info=info, reduce=dist.reduce)
    return dist.gather(u, n, op=g), info["iters"]


def sparse_lp_fit_sharded(dist: Distributor, model, train_ind,
                          train_labels):
    """Sparse label propagation on the mesh, edge-parallel: each rank
    takes a contiguous slice of the flat edge arrays (``model._edge_list``,
    padded to a multiple of the ranks with zero-weight edges that mirror
    themselves) and the dual field of its edges; the node arrays keep the
    true n, the divergence summed over the ranks and the mirrors read from
    the all-gathered field (``ssl._sparse_lp_run``).  Returns ``u``."""
    from graphlearning_tpu_torch import ssl as _ssl
    from graphlearning_tpu_torch import utils

    n = model.graph.num_nodes
    dev = dist.device
    dtype = dist._dtype()
    kc = len(np.unique(train_labels))
    onehot = utils.labels_to_onehot(train_labels, kc)
    if onehot.shape[1] != kc:
        raise ValueError("sparse_label_propagation takes the label ids "
                         f"0..{kc - 1}, not {np.unique(train_labels)}")
    erow, ecol, ew, emir = (t.to(dev) for t in model._edge_list())
    m = erow.shape[0]
    E = -(-m // dist.P)
    extra = E * dist.P - m
    if extra:
        erow = torch.cat([erow, erow.new_full((extra,), n)])
        ecol = torch.cat([ecol, ecol.new_zeros(extra)])
        ew = torch.cat([ew, ew.new_zeros(extra)])
        emir = torch.cat([emir, torch.arange(m, m + extra, device=dev)])
    sl = slice(dist.mesh.rank * E, (dist.mesh.rank + 1) * E)
    gamma = (1.0 / _ops.degree_vector(model.graph.sparse)).to(dev).to(dtype)
    u = _ssl._sparse_lp_run(
        erow[sl], ecol[sl], ew[sl].to(dtype), emir[sl], gamma,
        torch.as_tensor(np.asarray(train_ind), device=dev),
        torch.as_tensor(onehot, device=dev).to(dtype), n, kc, model.T,
        reduce=dist.reduce, gather=dist.mesh.all_gather)
    return u.cpu().numpy()


def incres_fit_sharded(dist: Distributor, W, u0, draw, *, k, T, Dm,
                       info=None):
    """INCRES's rounds on the mesh (``solvers.incres.rounds``): the labels,
    each round's scores and the seeds whole on every rank in the
    operator's padded row space (padding rows never members, never
    planted), the walk ``W D^-1`` on the rank's rows until every real row
    is reached (the stop the least value over the ranks, at most n_pad
    steps), then the all-gathered diffusion's argmax.  ``draw((k, n))``
    gives a round's scores in node order, the same on every rank (the
    one-device fit's draw), placed in the row space.  Returns the labels
    in node order; ``info`` gets each round's grow steps."""
    from graphlearning_tpu_torch.solvers import incres as _incres

    g, n = dist.operator(W)
    dtype = dist._dtype()
    dinv = safe_inv_deg(_ops.degree_vector(g).to(dtype))
    n_pad = g.n * dist.P
    rows = slice(dist.mesh.rank * g.n, (dist.mesh.rank + 1) * g.n)
    valid = torch.arange(n_pad, device=dist.device) < n
    labels = _incres.rounds(
        lambda X: _ops.spmm(g, X), dinv,
        dist.put_all(np.asarray(u0, np.int64), op=g),
        lambda shape: dist.all_rows(draw((shape[0], n)).T, g, n).T,
        int(k), int(T), int(Dm), n_pad, to_perm=lambda F: F[rows],
        from_perm=dist.mesh.all_gather, valid=valid[rows], info=info,
        reduce=dist.reduce, seed_valid=valid)
    return dist.node_order(labels, n, op=g)


def incres_grow_sharded(dist: Distributor, W):
    """The walk of INCRES's host loop (the reference's, which ``all_labels``
    runs) on the mesh: ``grow(F)`` places the seeds ``F`` (n, k), a host
    array in node order, as the ranks' rows, walks ``F <- W D^-1 F`` until
    every real row is reached (the stop the least value over the ranks, at
    most n steps; padding rows decoupled) and returns ``(labels, steps)``,
    the gathered diffusion's argmax in node order."""
    from graphlearning_tpu_torch.solvers import incres as _incres

    g, n = dist.operator(W)
    dtype = dist._dtype()
    deg = _ops.degree_vector(g).to(dtype)
    deg = torch.where(deg > 0, deg, torch.ones_like(deg))[:, None]
    valid = dist.valid_mask(n, g.n * dist.P, op=g)

    def grow(F):
        Ft, steps = _incres.grow(lambda X: _ops.spmm(g, X / deg),
                                 dist.put_rows(F, dtype=dtype, op=g), n,
                                 valid=valid, reduce=dist.reduce)
        return np.argmax(dist.gather(Ft, n, op=g), axis=1), int(steps)

    return grow


# -- the sharded eigensolvers ---------------------------------------------------


def _eig_solved(dist: Distributor, W, normalization, k, gamma, seed, info):
    """The sharded eigenpairs of ``W``'s operator, ``(vals, vecs)`` host
    arrays (vecs in node order), solved once per (normalization, k,
    gamma, seed) and kept on the operator (``op._eig_memo``, with the
    solve's LOBPCG steps), as ``graph.eigen_decomp_device`` keeps its
    eigendata.  ``info`` gets the LOBPCG steps of this call (0 when the
    pairs were kept)."""
    from graphlearning_tpu_torch.solvers import eig as _eig

    g, n = dist.operator(W)
    memo = g.__dict__.setdefault("_eig_memo", {})
    key = (normalization, int(k), float(gamma), seed)
    steps = 0
    if key not in memo:
        solve = {}
        vals, vecs = _eig.eigen_decomp(
            g, normalization=normalization,
            k=int(k) + _eig.guard_count(n, int(k)), gamma=gamma, shard=dist.row_space(g, n), key=seed, info=solve)
        steps = solve["iters"]
        memo[key] = (vals[:k].cpu().numpy(),
                     dist.gather(vecs[:, :k], n, op=g), steps)
    if info is not None:
        info["iters"] = steps
    vals, vecs, _ = memo[key]
    return vals.copy(), vecs.copy()


def eigen_decomp_sharded(dist: Distributor, W, normalization="normalized",
                         k=10, seed=0, info=None):
    """The low-lying Laplacian spectrum on the mesh (``solvers.eig.
    eigen_decomp`` with the rank's :class:`RowSpace`: LOBPCG over the
    ranks on the operator masked to the real rows): host ``(vals,
    vecs)``, vecs in node order.  ``k`` plus the guard vectors are solved
    from the plain fit's start (seeded by ``seed``); the randomwalk pairs
    are the normalized ones, the vectors scaled by ``D^-1/2``.  ``info``
    gets LOBPCG's steps (:func:`_eig_solved`)."""
    if normalization not in ("normalized", "randomwalk", "combinatorial"):
        raise ValueError("Invalid normalization " + normalization)
    if normalization != "randomwalk":
        return _eig_solved(dist, W, normalization, k, 0.0, seed, info)
    vals, vecs = _eig_solved(dist, W, "normalized", k, 0.0, seed, info)
    g, n = dist.operator(W)
    deg = dist.gather(_ops.degree_vector(g), n, op=g)
    return vals, vecs * (1.0 / np.sqrt(deg))[:, None]


def eigen_decomp_mod_sharded(dist: Distributor, W, k=10, gamma=0.5, seed=0,
                             info=None):
    """The low-lying spectrum of the combinatorial modularity operator
    ``L X + (gamma / m) deg (deg^T X)`` on the mesh (Modularity MBO's), as
    :func:`eigen_decomp_sharded`: the power iteration's shift and LOBPCG
    over the ranks."""
    return _eig_solved(dist, W, "combinatorial", k, gamma, seed, info)
