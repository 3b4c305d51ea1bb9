"""Active learning (counterpart of ``graphlearning_tpu/active_learning.py``).

``active_learner`` runs the query loop (select, label, refit).  The
acquisition functions ``unc_sampling``, ``var_opt``, ``sigma_opt``,
``model_change`` and ``model_change_var_opt`` share one covariance engine,
:class:`_covariance_acq`: the covariance lives on a device, in full
``(n, n)`` or truncated ``(k, k)`` storage over eigenvectors ``V``, its
column statistics are dense products there (in full precision,
:func:`config.exact_matmul`) and each query downdates it by rank one.
The candidates are drawn from numpy's global state where the JAX package
draws them, so a seeded loop queries the same nodes in both packages.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import softmax

from graphlearning_tpu_torch import config


class active_learner:
    """The query loop over an SSL ``model``: ``acq_function`` (an instance,
    or a class built with ``**kwargs``) scores the candidates,
    ``select_queries`` picks them by ``policy`` and ``update`` refits the
    model with their labels.

    ``warm_start=True`` starts each refit's solver from the previous
    round's scores (Laplace and Poisson's CG read ``model._warm_u``): the
    same solution in fewer steps.  The refits then go through
    ``model.fit_device``, so the scores stay a tensor on the graph's
    device between rounds and the acquisitions read them there."""

    def __init__(self, model, acq_function, labeled_ind, labels,
                 policy="max", warm_start=False, **kwargs):
        self.model = model
        self.warm_start = bool(warm_start)
        self.labeled_ind = np.asarray(labeled_ind).copy()
        self.labels = np.asarray(labels).copy()
        self.acq_function = (acq_function(**kwargs)
                             if isinstance(acq_function, type)
                             else acq_function)
        self.acq_function.update(self.labeled_ind, self.labels)
        self.policy = policy
        self._fit = (self.model.fit_device
                     if self.warm_start and hasattr(self.model, "fit_device")
                     else self.model.fit)
        self.u = self._fit(self.labeled_ind, self.labels)
        self.n = self.model.graph.num_nodes
        self.all_inds = np.arange(self.n)
        self.unlabeled_ind = np.setdiff1d(self.all_inds, self.labeled_ind)
        self.printed_warning = False

    def select_queries(self, batch_size=1, policy=None, candidate_ind="full",
                       rand_frac=0.1, return_acq_vals=False, prop_gamma=1.0,
                       allow_repeat=False):
        """The next ``batch_size`` nodes to label among the candidates
        (``"full"``: every node not labeled, or every node with
        ``allow_repeat``; ``"rand"``: a random ``rand_frac`` of those; or
        an index array): the best by ``"max"``, drawn with probabilities
        ``exp(prop_gamma acq)`` by ``"prop"``, or ``policy(candidates,
        values, batch_size)``."""
        if policy is None:
            policy = self.policy
        if isinstance(candidate_ind, np.ndarray):
            if candidate_ind.min() < 0 or candidate_ind.max() > self.n:
                raise ValueError(f"candidate_ind must be in [0, {self.n}]")
        elif candidate_ind == "full":
            candidate_ind = (
                self.all_inds if allow_repeat
                else np.setdiff1d(self.all_inds, self.labeled_ind)
            )
        elif candidate_ind == "rand" and 0 < rand_frac < 1:
            pool = self.all_inds if allow_repeat else self.unlabeled_ind
            candidate_ind = np.random.choice(
                pool, size=int(rand_frac * len(pool)), replace=False
            )
        else:
            raise ValueError("Invalid input for candidate_ind")

        acq_vals = self.acq_function.compute(self.u, candidate_ind)
        if policy == "max":
            query_ind = candidate_ind[(-acq_vals).argsort()[:batch_size]]
        elif policy == "prop":
            probs = np.exp(prop_gamma * (acq_vals - acq_vals.max()))
            probs /= probs.sum()
            query_ind = np.random.choice(candidate_ind, batch_size, p=probs)
        else:
            query_ind = policy(candidate_ind, acq_vals, batch_size)
        if return_acq_vals:
            return query_ind, acq_vals
        return query_ind

    def update(self, query_ind, query_labels):
        """Add the labels of ``query_ind``, refit the model (from the last
        scores with ``warm_start``) and downdate the acquisition."""
        query_ind = np.atleast_1d(query_ind)
        query_labels = np.atleast_1d(query_labels)
        if (np.intersect1d(query_ind, self.labeled_ind).size > 0
                and not self.printed_warning):
            print("WARNING: Having multiple observations at a single node "
                  "detected")
            self.printed_warning = True
        self.labeled_ind = np.append(self.labeled_ind, query_ind)
        self.labels = np.append(self.labels, query_labels)
        if self.warm_start:
            self.model._warm_u = self.u
        try:
            self.u = self._fit(self.labeled_ind, self.labels)
        finally:
            self.model._warm_u = None
        self.unlabeled_ind = np.setdiff1d(self.all_inds, self.labeled_ind)
        self.acq_function.update(query_ind, query_labels)


def spectral_covariance(model_or_graph, k=20, tau=0.11,
                        normalization="normalized", device=None):
    """The truncated covariance ``(C0, V)`` that the covariance
    acquisitions take, ``C0 = diag(1 / (lambda + tau))`` over the ``k``
    lowest eigenpairs of the graph Laplacian (``graph.eigen_decomp``: LOBPCG
    on the band or the gather where ``ops.accel.maybe_build`` takes one):
    ``var_opt(*spectral_covariance(model))``.  Takes an SSL model, a
    ``graph`` or a weight matrix (its graph on ``device``).  Returns numpy.
    A distributed model (``model.distribute(mesh)``) solves on its mesh
    (``parallel.execute.eigen_decomp_sharded``), so the whole learner,
    acquisitions and refits, runs there."""
    from graphlearning_tpu_torch.core.graphclass import graph as _graph

    dist = getattr(model_or_graph, "_dist", None)
    if dist is not None:
        from graphlearning_tpu_torch.parallel import execute as _exec

        vals, vecs = _exec.eigen_decomp_sharded(
            _exec.Distributor(dist), model_or_graph.graph.weight_matrix,
            normalization=normalization, k=k)
        return np.diag(1.0 / (np.asarray(vals) + tau)), np.asarray(vecs)
    G = model_or_graph
    if hasattr(G, "graph"):              # an SSL model
        G = G.graph
    if not isinstance(G, _graph):        # a weight matrix
        G = _graph(G, device=device)
    vals, vecs = G.eigen_decomp(normalization=normalization, k=k)
    C0 = np.diag(1.0 / (np.asarray(vals) + tau))
    return C0, np.asarray(vecs)


class acquisition_function:
    def compute(self, u, candidate_ind):
        raise NotImplementedError("Must override compute")

    def update(self, query_ind, query_labels):
        return


def _unc_full(u, method):
    """The uncertainty of every node from the ``(n, C)`` scores tensor
    ``u``, on its device."""
    if method in ("norm", "entropy"):
        p = torch.softmax(u, dim=1)
        if method == "norm":
            onehot = torch.nn.functional.one_hot(
                torch.argmax(u, dim=1), u.shape[1]).to(u.dtype)
            return torch.linalg.vector_norm(p - onehot, dim=1)
        return torch.max(p, dim=1).values - torch.sum(
            p * torch.log(p + 1e-5), dim=1)
    if method == "least_confidence":
        return 1.0 - torch.max(u, dim=1).values
    if method == "smallest_margin":
        top2 = torch.topk(u, 2, dim=1).values
        return 1.0 - (top2[:, 0] - top2[:, 1])
    if method == "largest_margin":
        return 1.0 - (torch.max(u, dim=1).values - torch.min(u, dim=1).values)
    if method == "unc_2norm":
        return 1.0 - torch.linalg.vector_norm(u, dim=1)
    raise ValueError("invalid unc_method " + method)


class unc_sampling(acquisition_function):
    """Uncertainty sampling, six methods: "norm", "entropy",
    "least_confidence", "smallest_margin", "largest_margin" and
    "unc_2norm".  Scores held as a tensor (a ``fit_device`` refit) are
    scored for every node on their device, and only the ``(n,)`` values
    are copied to the host; a host array is scored on the host."""

    def __init__(self, unc_method="smallest_margin"):
        self.unc_method = unc_method

    def compute(self, u, candidate_ind):
        if isinstance(u, torch.Tensor):
            return _unc_full(u, self.unc_method).cpu().numpy()[candidate_ind]
        uc = np.asarray(u)[candidate_ind]
        m = self.unc_method
        if m == "norm":
            p = softmax(uc, axis=1)
            onehot = np.eye(uc.shape[1])[np.argmax(uc, axis=1)]
            return np.linalg.norm(p - onehot, axis=1)
        if m == "entropy":
            p = softmax(uc, axis=1)
            return np.max(p, axis=1) - np.sum(p * np.log(p + 1e-5), axis=1)
        if m == "least_confidence":
            return 1.0 - np.max(uc, axis=1)
        if m == "smallest_margin":
            s = np.sort(uc)
            return 1.0 - (s[:, -1] - s[:, -2])
        if m == "largest_margin":
            s = np.sort(uc)
            return 1.0 - (s[:, -1] - s[:, 0])
        if m == "unc_2norm":
            return 1.0 - np.linalg.norm(uc, axis=1)
        raise ValueError("invalid unc_method " + m)


class _covariance_acq(acquisition_function):
    """The engine of the covariance acquisitions: ``C`` in full ``(n, n)``
    storage, or ``(k, k)`` over the eigenvectors ``V`` (n, k) ("trunc"),
    on ``device`` in its working dtype, downdated by rank one at each
    query (``C - c c^T / (gamma2 + c_k)``)."""

    def __init__(self, C, V=None, gamma2=0.1**2, device=None):
        dev = config.device(device)
        dtype = config.float_dtype(dev)
        C = np.array(C)                 # a copy: JAX's arrays are read-only
        if C.shape[0] != C.shape[1] and V is None:
            raise ValueError("C must be square, or V given")
        self.C = torch.as_tensor(C, device=dev).to(dtype)
        self.V = (None if V is None
                  else torch.as_tensor(np.array(V), device=dev).to(dtype))
        self.gamma2 = gamma2
        self.storage = "full" if V is None else "trunc"

    def _col_stats(self, candidate_ind):
        """``(column norms^2, column sums^2, gamma2 + diagonal)`` of the
        candidates' columns of the covariance, tensors."""
        idx = torch.as_tensor(np.asarray(candidate_ind), device=self.C.device)
        with config.exact_matmul():
            if self.storage == "full":
                cols = self.C[:, idx]
                diag = self.gamma2 + torch.diagonal(self.C)[idx]
            else:
                Vc = self.V[idx, :].T                    # (k, m)
                cols = self.C @ Vc
                diag = self.gamma2 + torch.sum(Vc * cols, dim=0)
        norms2 = torch.sum(cols * cols, dim=0)
        sums2 = torch.sum(cols, dim=0) ** 2
        return norms2, sums2, diag

    def update(self, query_ind, query_labels):
        with config.exact_matmul():
            for k in np.atleast_1d(query_ind):
                if self.storage == "full":
                    ck = self.C[:, k]
                    self.C = self.C - torch.outer(ck, ck) / (
                        self.gamma2 + self.C[k, k])
                else:
                    vk = self.V[k]
                    Cavk = self.C @ vk
                    ip = torch.dot(vk, Cavk)
                    self.C = self.C - torch.outer(Cavk, Cavk) / (
                        self.gamma2 + ip)


class var_opt(_covariance_acq):
    """V-optimality (Ji-Han): ``|c|^2 / (gamma2 + c_k)`` of each
    candidate's covariance column ``c``."""

    def compute(self, u, candidate_ind):
        norms2, _, diag = self._col_stats(candidate_ind)
        return (norms2 / diag).cpu().numpy()


class sigma_opt(_covariance_acq):
    """Sigma-optimality (Ma-Garnett-Schneider): ``(sum c)^2 / (gamma2 +
    c_k)``."""

    def compute(self, u, candidate_ind):
        _, sums2, diag = self._col_stats(candidate_ind)
        return (sums2 / diag).cpu().numpy()


class model_change(_covariance_acq):
    """Model change (Miller-Bertozzi): the uncertainty (``unc_method``)
    times ``|c| / (gamma2 + c_k)``."""

    def __init__(self, C, V=None, gamma2=0.1**2,
                 unc_method="smallest_margin", device=None):
        super().__init__(C, V=V, gamma2=gamma2, device=device)
        self.unc_sampling = unc_sampling(unc_method=unc_method)

    def compute(self, u, candidate_ind):
        unc = self.unc_sampling.compute(u, candidate_ind)
        norms2, _, diag = self._col_stats(candidate_ind)
        return unc * (torch.sqrt(norms2) / diag).cpu().numpy()


class model_change_var_opt(_covariance_acq):
    """Model change and V-optimality together: the uncertainty times
    ``|c|^2 / (gamma2 + c_k)``."""

    def __init__(self, C, V=None, gamma2=0.1**2,
                 unc_method="smallest_margin", device=None):
        super().__init__(C, V=V, gamma2=gamma2, device=device)
        self.unc_sampling = unc_sampling(unc_method=unc_method)

    def compute(self, u, candidate_ind):
        unc = self.unc_sampling.compute(u, candidate_ind)
        norms2, _, diag = self._col_stats(candidate_ind)
        return unc * (norms2 / diag).cpu().numpy()
