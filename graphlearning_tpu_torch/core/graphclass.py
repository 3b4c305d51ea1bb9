"""``graph``: user-facing graph object (counterpart of
``graphlearning_tpu/core/graphclass.py:24-283,296-532``).  The graph lives
on a device as a padded-ELL :class:`SparseGraph`; the scipy matrix is kept
for interop and for the caches attached to it.  The distance and
Lipschitz methods run on the band (:mod:`ops.accel`) where it applies, and
the normalized eigensolve on the band or the gather."""

from __future__ import annotations

import pickle

import numpy as np
import scipy.sparse as sp
import torch

from graphlearning_tpu_torch import config
from graphlearning_tpu_torch import observability as _obs
from graphlearning_tpu_torch.core.sparse import BucketedELL, SparseGraph
from graphlearning_tpu_torch.ops import graphops as _ops


class graph:
    """Weighted graph on a device.  Accepts a scipy sparse matrix, a dense
    numpy array, a :class:`SparseGraph` or another :class:`graph`."""

    def __init__(self, W, k: int | None = None, dtype=None, device=None):
        self._scipy = None
        if isinstance(W, graph):
            self.g = W.g
            self._scipy = W._scipy
        elif isinstance(W, SparseGraph):
            self.g = W
        else:
            dev = config.device(device)
            self.g = None
            ckey = None
            if sp.issparse(W):
                # repeated model constructions on the SAME scipy matrix
                # reuse its device ELL (validated against shape and nnz)
                ckey = (k, str(dtype), str(dev))
                cached = getattr(W, "_gltt_sparsegraph", None)
                if isinstance(cached, dict):
                    hit = cached.get(ckey)
                    if hit is not None and hit[1] == (W.shape[0], W.nnz):
                        self.g = hit[0]
            if self.g is None:
                with _obs.span("graph.ell") as span:
                    self.g = SparseGraph.from_scipy(W, k=k, dtype=dtype,
                                                    device=dev)
                    span.set(n=self.g.n, k=self.g.k)
                if ckey is not None:
                    if not isinstance(getattr(W, "_gltt_sparsegraph", None),
                                      dict):
                        W._gltt_sparsegraph = {}
                    W._gltt_sparsegraph[ckey] = (self.g, (W.shape[0], W.nnz))
            if sp.issparse(W):
                # keep the original object: caches ride on it
                self._scipy = W.tocsr() if W.format != "csr" else W
        self.num_nodes = self.g.n
        # the eigendata memo, keyed by normalization, then by every
        # parameter of eigen_decomp
        self.eigendata = {}
        self.eigen_info = {}

    @property
    def device(self):
        return self.g.device

    @property
    def weight_matrix(self):
        """scipy CSR view (built lazily on the host)."""
        if self._scipy is None:
            self._scipy = self.g.to_scipy()
        return self._scipy

    @property
    def sparse(self) -> SparseGraph:
        return self.g

    def mirror(self):
        """:func:`ops.graphops.build_mirror` of the graph, built once."""
        if getattr(self, "_mirror", None) is None:
            self._mirror = _ops.build_mirror(self.g)
        return self._mirror

    def degree_vector(self):
        return _ops.degree_vector(self.g).cpu().numpy()

    # -- host-side views (scipy) ------------------------------------------

    def adjacency(self):
        """The 0/1 matrix of the stored entries."""
        W = self.weight_matrix.copy()
        W.data = np.ones_like(W.data)
        return W

    def rand(self, seed=None):
        """The graph's pattern with uniform values from ``seed``."""
        W = self.weight_matrix.copy()
        W.data = np.random.RandomState(seed).rand(len(W.data))
        return W

    def randn(self, seed=None):
        """The graph's pattern with normal values from ``seed``."""
        W = self.weight_matrix.copy()
        W.data = np.random.RandomState(seed).randn(len(W.data))
        return W

    def subgraph(self, ind):
        """The graph on the nodes ``ind``, on the same device."""
        return graph(self.weight_matrix[ind, :][:, ind], device=self.device)

    def isconnected(self):
        from scipy.sparse import csgraph

        ncomp, _ = csgraph.connected_components(self.weight_matrix)
        return ncomp == 1

    def neighbors(self, i, return_weights=False):
        """The neighbors of node ``i`` (itself left out), with their
        weights when ``return_weights``."""
        N = self.weight_matrix[i, :].nonzero()[1]
        N = N[N != i]
        if return_weights:
            return N, np.asarray(self.weight_matrix[i, N].todense()).ravel()
        return N

    def largest_connected_component(self):
        """``(graph, mask)``: the graph on its largest connected component,
        on the same device, and the boolean mask of its nodes."""
        from scipy.sparse import csgraph

        ncomp, labels = csgraph.connected_components(self.weight_matrix,
                                                     directed=False)
        ind = labels == np.argmax(np.bincount(labels, minlength=ncomp))
        return graph(self.weight_matrix[ind, :][:, ind],
                     device=self.device), ind

    def laplacian(self, normalization: str = "combinatorial",
                  alpha: float = 1.0):
        """scipy sparse Laplacian, for interop.  The compute path uses the
        matrix-free :meth:`laplacian_op`.  "coifmanlafon" is the
        random-walk Laplacian of the density-normalized kernel ``D^-alpha
        W D^-alpha``."""
        W = self.weight_matrix
        n = self.num_nodes
        d = self.degree_vector()
        if normalization == "combinatorial":
            return (sp.spdiags(d, 0, n, n) - W).tocsr()
        if normalization == "randomwalk":
            return (sp.identity(n) - sp.spdiags(1.0 / d, 0, n, n) @ W).tocsr()
        if normalization == "normalized":
            s = sp.spdiags(d ** -0.5, 0, n, n)
            return (sp.identity(n) - s @ W @ s).tocsr()
        if normalization == "coifmanlafon":
            s = sp.spdiags(d ** -alpha, 0, n, n)
            K = s @ W @ s
            dK = np.asarray(K.sum(axis=1)).ravel()
            return (sp.identity(n) - sp.spdiags(1.0 / dK, 0, n, n) @ K
                    ).tocsr()
        raise ValueError(f"invalid normalization {normalization}")

    def laplacian_op(self, normalization: str = "combinatorial"):
        """Matrix-free ``(matvec, diag)`` pair on the device."""
        g = self.g
        deg = _ops.degree_vector(g)

        def matvec(X):
            return _ops.laplacian_matvec(g, X, normalization, deg=deg)

        return matvec, _ops.laplacian_diag(g, normalization, deg=deg)

    def degree_matrix(self, p: float = 1.0):
        d = self.degree_vector() ** p
        return sp.spdiags(d, 0, self.num_nodes, self.num_nodes).tocsr()

    def bucketed(self):
        """ELL + COO hybrid view (:class:`BucketedELL`) for the gather-path
        Lipschitz solvers on degree-skewed graphs; cached on the scipy
        matrix per device and dtype."""
        W0 = self.weight_matrix
        key = (str(self.device), str(self.g.vals.dtype))
        cache = getattr(W0, "_gltt_bucketed", None)
        if not isinstance(cache, dict):
            cache = W0._gltt_bucketed = {}
        hit = cache.get(key)
        if hit is None or hit.n != self.num_nodes:
            hit = cache[key] = BucketedELL.from_scipy(
                W0, dtype=self.g.vals.dtype, device=self.device)
        return hit

    # -- graph calculus (scipy, for interop) -----------------------------

    def gradient(self, u, weighted: bool = False, p: float = 0.0):
        """Sparse gradient matrix ``(grad u)_ij = w_ij^p (u_j - u_i)``; the
        device form is ``ops.graphops.gradient``."""
        u = np.asarray(u)
        W = self.weight_matrix.tocoo()
        if p != 0.0:
            weighted = True
        if weighted and p == 0.0:
            p = 1.0
        diff = u[W.col] - u[W.row]
        vals = (W.data**p) * diff if weighted else diff
        n = self.num_nodes
        return sp.coo_matrix((vals, (W.row, W.col)), shape=(n, n)).tocsr()

    def divergence(self, V, weighted: bool = True):
        """Divergence of a sparse edge field: the row sums of ``w (V -
        V^T) / 2``."""
        V = V - V.T
        if weighted:
            V = V.multiply(self.weight_matrix)
        return np.asarray(V @ np.ones(self.num_nodes)) / 2

    def infinity_laplacian(self, u):
        u = torch.as_tensor(np.asarray(u), device=self.device).to(
            self.g.vals.dtype)
        return _ops.infinity_laplacian(self.g, u).cpu().numpy()

    # -- reweighting ---------------------------------------------------------

    def reweight(self, idx, method="poisson", normalization="combinatorial",
                 tau=0, X=None, alpha=2, zeta=1e7, r=0.1):
        """The low-label-rate reweighting of the labeled nodes ``idx``: a
        new scipy weight matrix.  "poisson": ``D W D`` with ``D`` the
        Poisson solution of a unit source at the labels (CG on the
        graph's device), shifted positive; "wnll": ``D W + W D`` with
        ``D = n / |idx|`` at the labels, 1 elsewhere; "properly": ``D W +
        W D`` with ``D = 1 + (r / dist)^alpha``, ``dist`` the distance of
        each point of ``X`` to the nearest labeled one (scipy's
        ``cKDTree``), at least ``r / (zeta - 1)^(1/alpha)``.  ``tau`` is
        accepted and unused, as in the JAX package."""
        from graphlearning_tpu_torch.solvers.cg import conjgrad

        n = self.num_nodes
        idx = np.asarray(idx)
        if method == "poisson":
            f = np.zeros(n)
            f[idx] = 1.0
            if normalization == "combinatorial":
                f = f - np.mean(f)
            elif normalization == "normalized":
                ds = np.sqrt(self.degree_vector())
                f = f - np.sum(ds * f) / np.sum(ds)
            else:
                raise ValueError(f"unsupported normalization {normalization}")
            matvec, _ = self.laplacian_op(normalization)
            w, _, _ = conjgrad(matvec, torch.as_tensor(
                f, device=self.device).to(config.float_dtype(self.device)),
                tol=1e-5, max_iter=10**5)
            w = w.cpu().numpy().astype(float)
            w = w - np.min(w) + 1e-5
            D = sp.spdiags(w, 0, n, n).tocsr()
            return D @ self.weight_matrix @ D
        if method == "wnll":
            a = np.ones(n)
            a[idx] = n / len(idx)
            D = sp.spdiags(a, 0, n, n).tocsr()
            W = self.weight_matrix
            return D @ W + W @ D
        if method == "properly":
            if X is None:
                raise ValueError("properly reweighting requires features X")
            from scipy import spatial

            rzeta = r / (zeta - 1) ** (1 / alpha)
            D, _ = spatial.cKDTree(X[idx, :]).query(X)
            D[D < rzeta] = rzeta
            gamma = 1 + (r / D) ** alpha
            Dg = sp.spdiags(gamma, 0, n, n).tocsr()
            W = self.weight_matrix
            return Dg @ W + W @ Dg
        raise ValueError(f"invalid reweighting method {method}")

    # -- PageRank ------------------------------------------------------------

    def page_rank(self, alpha=0.85, v=None, tol=1e-10):
        """The PageRank vector (:func:`solvers.pagerank.page_rank`) as a
        numpy array; ``v`` the teleport vector (uniform by default)."""
        from graphlearning_tpu_torch.solvers.pagerank import page_rank

        return page_rank(self.g, alpha=alpha, v=v, tol=tol).cpu().numpy()

    # -- spectrum ------------------------------------------------------------

    def eigen_decomp_device(self, normalization="combinatorial",
                            method="exact", k=10, c=None, gamma=0, tol=0,
                            q=1):
        """The low-lying spectrum of the Laplacian (:func:`solvers.eig.
        eigen_decomp`) as tensors on the graph's device, memoized per
        ``(normalization, method, k, c, gamma, tol, q)`` in
        ``eigendata[normalization]``.  ``k + b`` pairs are solved and the
        first ``k`` kept, ``b = min(2 + k // 10, max(n // 4 - k, 0))``
        guard vectors, since LOBPCG's last pairs converge worst.  The
        normalized and randomwalk "exact" solves with ``gamma == 0`` run
        on the f32 band or the gather where ``ops.accel.maybe_build`` takes
        one (the JAX package also builds it for "lowrank", which does not
        use it).  ``eigen_info`` holds each solve's LOBPCG steps
        ("iters") and its path ("path")."""
        from graphlearning_tpu_torch.ops import accel as _accel
        from graphlearning_tpu_torch.solvers import eig as _eig

        key = (normalization, method, k, c, gamma, tol, q)
        cache = self.eigendata.setdefault(normalization, {})
        if key not in cache:
            acc = None
            if (gamma == 0 and method == "exact"
                    and normalization in ("normalized", "randomwalk")):
                acc = _accel.maybe_build(self.weight_matrix, cache_obj=self,
                                         attr="_accel_eig",
                                         device=self.device, mode="f32")
            b = _eig.guard_count(self.num_nodes, k)
            info = {"path": _accel.path_name(acc)}
            vals, vecs = _eig.eigen_decomp(
                self.g, normalization=normalization, method=method,
                k=k + b, c=c, gamma=gamma, tol=tol, q=q, accel=acc,
                info=info)
            cache[key] = (vals[:k], vecs[:, :k])
            self.eigen_info[key] = info
        return cache[key]

    def eigen_decomp(self, normalization="combinatorial", method="exact",
                     k=10, c=None, gamma=0, tol=0, q=1):
        """:meth:`eigen_decomp_device` as numpy ``(vals, vecs)``: increasing
        eigenvalues, eigenvectors as columns."""
        vals, vecs = self.eigen_decomp_device(
            normalization=normalization, method=method, k=k, c=c,
            gamma=gamma, tol=tol, q=q)
        return vals.cpu().numpy(), vecs.cpu().numpy()

    def fiedler_vector(self, return_value=False, tol=1e-8, method="exact"):
        """The second eigenvector of the normalized Laplacian (and its
        eigenvalue with ``return_value``)."""
        vals, vecs = self.eigen_decomp(normalization="normalized",
                                       method=method, k=2, tol=tol)
        if return_value:
            return vecs[:, 1], vals[1]
        return vecs[:, 1]

    def diffusion_map(self, k=1, alpha=1, d=3, full=False):
        """Coifman-Lafon diffusion map: ``k`` diffusion steps, density
        exponent ``alpha``, ``d`` dimensions.  Returns ``(vals, emb)``
        without the trivial mode unless ``full``."""
        vals, vecs = self.eigen_decomp(normalization="coifmanlafon", k=d,
                                       c=float(alpha))
        if full:
            S = 1.0 - vals
            return vals, vecs * (S ** k)[None, :]
        S = 1.0 - vals[1:]
        return vals[1:], vecs[:, 1:] * (S ** k)[None, :]

    # -- distance and Lipschitz solvers ---------------------------------

    def _accel_exact(self):
        """The f32-band accel of the distance solvers (cost-gated and
        cached), or None off the band path.  They run only on a stored
        band, so no gather is built for them."""
        from graphlearning_tpu_torch.ops import accel as _accel

        return _accel.maybe_build(self.weight_matrix, cache_obj=self,
                                  attr="_accel_exact_cache",
                                  device=self.device, mode="f32",
                                  gather=False)

    def dijkstra(self, bdy_set, bdy_val=None, f=1, max_dist=np.inf,
                 return_cp=False, reciprocal_weights=False):
        """Graph distance to ``bdy_set`` (see ``solvers.eikonal.dijkstra``),
        on the band (K7) where it applies."""
        from graphlearning_tpu_torch.solvers import eikonal as _eik

        return _eik.dijkstra(self.g, bdy_set, bdy_val=bdy_val, f=f,
                             max_dist=max_dist, return_cp=return_cp,
                             reciprocal_weights=reciprocal_weights,
                             accel=self._accel_exact())

    def dijkstra_hl(self, bdy_set, bdy_val=None, f=1, max_dist=np.inf,
                    return_cp=False):
        """Hopf-Lax distance to ``bdy_set``, on the band (K7) where it
        applies."""
        from graphlearning_tpu_torch.solvers import eikonal as _eik

        return _eik.dijkstra_hl(self.g, bdy_set, bdy_val=bdy_val, f=f,
                                max_dist=max_dist, return_cp=return_cp,
                                accel=self._accel_exact())

    def distance(self, i, j):
        return self.dijkstra([i])[j]

    def distance_matrix(self, centered=False):
        from graphlearning_tpu_torch.solvers import eikonal as _eik

        return _eik.distance_matrix(self.g, centered=centered)

    def peikonal(self, bdy_set, bdy_val=0, f=1, p=1, nl_bdy=False, u0=None,
                 solver="fmm", max_num_it=10**5, tol=1e-3,
                 num_bisection_it=30, prog=False):
        """p-eikonal equation by Jacobi rounds.  ``solver`` ("fmm" or
        "gauss-seidel") is accepted for API parity: both reach the same
        viscosity solution.  ``nl_bdy`` dilates the boundary data to the
        graph neighbors."""
        from graphlearning_tpu_torch.solvers import eikonal as _eik

        if nl_bdy:
            n = self.num_nodes
            bdy_set, bdy_val = _eik._boundary_handling(bdy_set, bdy_val)
            D = self.degree_matrix(p=-1)
            W = self.weight_matrix
            bdy_mask = np.zeros(n)
            bdy_mask[bdy_set] = 1
            bdy_dilate = (D @ W @ bdy_mask) > 0
            bdy_val_all = np.zeros(n)
            bdy_val_all[bdy_mask == 1] = bdy_val
            bdy_set = np.where(bdy_dilate)[0]
            bdy_val = (D @ W @ bdy_val_all)[bdy_set]
        return _eik.peikonal(self.g, bdy_set, bdy_val=bdy_val, f=f, p=p,
                             max_num_it=max_num_it, tol=tol,
                             num_bisection_it=num_bisection_it, u0=u0)

    def plaplace(self, bdy_set, bdy_val, p, max_num_it=10**6, tol=1e-1,
                 prog=False, fast=True):
        from graphlearning_tpu_torch.solvers import plaplace as _pl

        return _pl.plaplace(self.g, bdy_set, bdy_val, p,
                            max_num_it=max_num_it, tol=tol, fast=fast)

    def amle(self, bdy_set, bdy_val, tol=1e-5, max_num_it=10**5,
             weighted=True, prog=False):
        from graphlearning_tpu_torch.solvers import plaplace as _pl

        return _pl.amle(self.g, bdy_set, bdy_val, tol=tol,
                        max_num_it=max_num_it, weighted=weighted)

    # -- persistence and drawing ------------------------------------------

    def save(self, filename):
        """Pickle the weight matrix as the JAX package does (``{"scipy":
        csr, "version": 1}``), so either package loads it.  A fresh copy
        is pickled: the caches on the original carry device tensors."""
        with open(filename, "wb") as fh:
            pickle.dump({"scipy": sp.csr_matrix(self.weight_matrix,
                                                copy=True), "version": 1},
                        fh, protocol=pickle.HIGHEST_PROTOCOL)

    @staticmethod
    def load(filename, device=None):
        """A graph on ``device`` from :meth:`save`'s pickle, a pickled
        GraphLearning graph object or a pickled matrix."""
        with open(filename, "rb") as fh:
            obj = pickle.load(fh)
        if isinstance(obj, dict) and "scipy" in obj:
            return graph(obj["scipy"], device=device)
        if hasattr(obj, "weight_matrix"):
            return graph(obj.weight_matrix, device=device)
        return graph(obj, device=device)

    def draw(self, X=None, c=None, cmap="viridis", markersize=None,
             linewidth=None, edges=True, linecolor="black", alpha=1.0):
        """Scatter the nodes at ``X`` (by default a metric-MDS layout of
        the graph distances) with their edges, on a new matplotlib figure.
        Needs matplotlib, imported here.  Returns ``X``."""
        import matplotlib.pyplot as plt

        if X is None:
            H = self.distance_matrix(centered=True)
            vals, vecs = np.linalg.eigh(H)
            X = vecs[:, -2:] * np.sqrt(np.abs(vals[-2:]))[None, :]
        W = self.weight_matrix.tocoo()
        fig, ax = plt.subplots()
        if edges:
            for i, j in zip(W.row, W.col):
                if i < j:
                    ax.plot([X[i, 0], X[j, 0]], [X[i, 1], X[j, 1]],
                            color=linecolor, linewidth=linewidth or 0.5,
                            alpha=0.5 * alpha)
        ax.scatter(X[:, 0], X[:, 1], c=c, cmap=cmap, s=markersize, zorder=3,
                   alpha=alpha)
        return X

    @staticmethod
    def ars(X, dim=2, perplexity=30, kappa=0.5, iters=1000, time_step=1,
            theta1=2, theta2=3, alpha=10, num_early=250, use_pca=True,
            init_dim=200, init="pca", prog=False, dump=False, device=None,
            **kwargs):
        """Attraction-Repulsion Swarming t-SNE embedding (static, reference
        ``graph.py:1494-1609``); ``kwargs`` (``chunk``) pass on.  See
        :func:`graphlearning_tpu_torch.ars.ars`."""
        from graphlearning_tpu_torch.ars import ars as _ars

        return _ars(X, dim=dim, perplexity=perplexity, kappa=kappa,
                    iters=iters, time_step=time_step, theta1=theta1,
                    theta2=theta2, alpha=alpha, num_early=num_early,
                    use_pca=use_pca, init_dim=init_dim, init=init,
                    prog=prog, dump=dump, device=device, **kwargs)
