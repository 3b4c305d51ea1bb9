"""Semi-supervised learning on graphs (counterpart of
``graphlearning_tpu/ssl.py``): Laplace (with its
reweightings), Poisson (its spectral solver too) and random-walk learning,
PoissonMBO and VolumeMBO, the eigenbasis models Multiclass MBO and
Modularity MBO, the centered kernel method, dynamic and sparse label
propagation, the distance and Lipschitz models (graph nearest neighbor,
AMLE, p-eikonal and p-Laplace), and the experiment harness: ``warmup``,
``fit_predict_batched``, ``fit_device``, ``ssl_trials`` with its CSV files
under ``results_dir``, ``trials_statistics``, ``accuracy_table`` and
``accuracy_plot``).

Each model's ``_fit`` moves the labels to the graph's device once and runs
a matrix-free solver there.  On a large band-friendly graph on CUDA, every
matvec goes through the band kernels (:mod:`ops.accel`); otherwise through
the plain ELL gather (:mod:`ops.graphops`).  ``self.iters`` holds the
solver's iteration (or sweep) count after a fit.  One-vs-rest models solve
their C problems together (``_fit_onevsrest``) or one class at a time.

``model.distribute(mesh)`` runs the fits of every family but dynamic
label propagation on a mesh of ranks (:mod:`parallel.execute`), as the JAX
package does; PoissonMBO and VolumeMBO with ``all_labels`` run their
rounds there too, each rank printing each round's accuracy.  A
checkpointed PoissonMBO or VolumeMBO fit refuses on a mesh: the JAX
package's sharded fit drops the checkpoint without a word.  p-Laplace
with ``fast=False`` fits on one device, as the JAX package's.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from graphlearning_tpu_torch import config, utils
from graphlearning_tpu_torch import observability as _obs
from graphlearning_tpu_torch.core import graphclass as _graphmod
from graphlearning_tpu_torch.core.sparse import SparseGraph
from graphlearning_tpu_torch.ops import accel as _accel
from graphlearning_tpu_torch.ops import graphops as _ops
from graphlearning_tpu_torch.solvers import centered as _centered
from graphlearning_tpu_torch.solvers import cg as _cg
from graphlearning_tpu_torch.solvers import eikonal as _eik
from graphlearning_tpu_torch.solvers import plaplace as _pl
from graphlearning_tpu_torch.solvers import volume as _volume


def _cg_scaled_solve(g, s, b, c0, c1, tol, max_iter=10**5, x0=None,
                     reduce=None):
    """CG solve of ``(c0 I - c1 diag(s) W diag(s)) x = b``; ``reduce`` sums
    over the ranks of a sharded solve.  Returns ``(x, iters)``."""

    def A(X):
        return c0 * X - c1 * s[:, None] * _ops.spmm(g, s[:, None] * X)

    x, iters, _ = _cg.conjgrad(A, b, x0=x0, tol=tol, max_iter=max_iter,
                               reduce=reduce)
    return x, iters


def _project_out_nlap_kernel(v, deg, reduce=None):
    """Remove the ``D^{1/2} 1`` kernel component of each column.  The
    normalized Laplacian is singular with that kernel, and float32 rounding
    drifts a different multiple of it into each class column, which shifts
    the argmax; projecting it out restores the f64 gauge.  Padding rows
    (degree 0) contribute nothing; ``reduce`` sums over the ranks."""
    q = torch.sqrt(torch.clamp(deg, min=0.0)).to(v.dtype)
    num, den = q @ v, torch.sum(q * q)
    if reduce is not None:
        num, den = reduce(num), reduce(den)
    return v - q[:, None] * (num / den)[None, :]


def _laplace_constrained(g, tau, mask, bdy, tol, normalization="combinatorial",
                         order=1, max_iter=10**5, u0=None, reduce=None):
    """Masked CG solve of ``(tau + L)^order u = 0`` with ``u = bdy`` on
    ``mask``; ``reduce`` sums over the ranks of a sharded solve.  Returns
    ``(u, iters)``."""
    deg = _ops.degree_vector(g)

    def L(X):
        Y = X
        for _ in range(order):
            Y = tau[:, None] * Y + _ops.laplacian_matvec(
                g, Y, normalization=normalization, deg=deg)
        return Y

    diag = _ops.laplacian_diag(g, normalization=normalization, deg=deg)
    u, iters, _ = _cg.constrained_solve(L, (tau + diag) ** order, mask, bdy,
                                        tol=tol, max_iter=max_iter, u0=u0,
                                        reduce=reduce)
    return u, iters


def _laplace_accel(acc, g, tau, mask, bdy, tol, normalization, order,
                   u0=None):
    """:func:`_laplace_constrained` on an accel (the band or the gather):
    ``g``'s degrees and ``diag(L)``, ``tau``, ``mask``, ``bdy`` and ``u0``
    in node order, the solve in the accel's permuted space, whose padding
    rows are identity rows (diag 1, tau 0, unlabeled, zero rhs).  Returns
    ``(u, iters)``, ``u`` in node order."""
    deg_p = acc.to_perm(_ops.degree_vector(g))
    diag_p = acc.to_perm(_ops.laplacian_diag(g, normalization), fill=1.0)
    u, iters = acc.laplace_constrained(
        deg_p, diag_p, acc.to_perm(tau),
        acc.to_perm(mask.to(torch.int32)) > 0, acc.to_perm(bdy), tol,
        normalization=normalization, order=order,
        u0_p=None if u0 is None else acc.to_perm(u0))
    return acc.from_perm(u), iters


def _poisson_accel(acc, s, b, tol, x0=None):
    """Poisson learning's CG on an accel: ``(I - D^-1/2 W D^-1/2) v = s
    b`` with ``s = D^-1/2`` (n,), ``b`` (n, C) and the scaled start ``x0``
    in node order, the ``D^{1/2} 1`` kernel projected out.  Padding rows
    have ``s = 0``: identity rows with zero rhs.  Returns ``(s v,
    iters)`` in node order."""
    s_p = acc.to_perm(s)
    v, iters = acc.cg_scaled(s_p, s_p[:, None] * acc.to_perm(b), tol=tol,
                             x0=None if x0 is None else acc.to_perm(x0))
    deg_p = torch.where(
        s_p > 0, 1.0 / torch.where(s_p == 0, torch.ones_like(s_p), s_p) ** 2,
        torch.zeros_like(s_p))
    v = _project_out_nlap_kernel(v, deg_p)
    return acc.from_perm(s_p[:, None] * v), iters


results_dir = os.path.abspath(os.path.join(os.getcwd(), "results"))

# The largest plain ELL gather a batched fit makes on the device, in bytes:
# ``ops.graphops.spmm`` gathers ``(n, k, d)`` at ``d`` = trials x classes,
# so the trials of ``fit_predict_batched`` go in groups that keep it there.
_BATCH_BYTES = 1 << 30


def _batch_groups(T, g, C, dtype):
    """Groups of the ``T`` trial indices whose plain gather on the ELL
    ``g`` at ``C`` classes stays within ``_BATCH_BYTES``."""
    per = g.n * g.k * C * torch.finfo(dtype).bits // 8
    size = max(1, _BATCH_BYTES // max(1, per))
    return [list(range(s, min(s + size, T))) for s in range(0, T, size)]


def _trial_classes(labels):
    """``(classes, remap)``: the nonnegative label values, sorted, and the
    column of each in the one-hot blocks of the batched fits."""
    classes = np.unique(labels[labels >= 0])
    remap = np.zeros(int(classes.max()) + 1, dtype=int)
    remap[classes] = np.arange(len(classes))
    return classes, remap


class ssl:
    """Base class: fit / predict / class-prior volume projection, and the
    experiment harness (``ssl_trials`` and its statistics)."""

    def __init__(self, W=None, class_priors=None, device=None):
        self._device = device
        if W is None:
            self.graph = None
        else:
            self.set_graph(W)
        self.prob = None
        self.fitted = False
        self.name = ""
        self.accuracy_filename = ""
        self.requires_eig = False
        self.similarity = True
        self.class_priors = class_priors
        if self.class_priors is not None:
            self.class_priors = np.asarray(self.class_priors, dtype=float)
            self.class_priors = self.class_priors / np.sum(self.class_priors)
        self.weights = 1
        self.class_priors_error = 1
        self.iters = None
        self.onevsrest = False
        self._dist = None

    # Families with a sharded fit, or none at all (dynamic label
    # propagation is dense and capped at n <= 5000: distribute() warns,
    # and its fits run on one device, as the JAX package's do).
    _sharded_supported = True

    def distribute(self, mesh="auto", strict=False):
        """Run this model's fits on a mesh of ranks (:mod:`parallel`):
        ``mesh`` is a :class:`parallel.mesh.Mesh`, a
        :class:`config.GLTConfig`, a ``Distributor``, ``"auto"`` (the
        default config's mesh over the initialized process group, world
        size 1 without one) or None to undo it.  The fits give the same
        results as on one device up to the order of float sums (the
        stochastic ones at equal draws).  A model with no sharded path
        warns (``strict=True`` raises); a fit the mesh does not take
        (:meth:`_dist_gap`) raises when fitted.  Returns self:
        ``gl.ssl.poisson(W).distribute(cfg).fit_predict(...)``."""
        if mesh is None:
            self._dist = None
        else:
            if not type(self)._sharded_supported:
                msg = (f"{type(self).__name__} has no sharded execution "
                       "path; fits will run single-device despite "
                       "distribute()")
                if strict:
                    raise NotImplementedError(msg)
                import warnings

                warnings.warn(msg, stacklevel=2)
            from graphlearning_tpu_torch.parallel import execute as _exec

            self._dist = _exec.Distributor(mesh)
        pm = getattr(self, "poisson_model", None)
        if pm is not None:             # poisson_mbo's initializer model
            pm._dist = self._dist
        return self

    def _dist_gap(self, all_labels=None):
        """What of this fit the mesh does not take (None: it takes it, or
        the model has no sharded path at all)."""
        return None

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
        prob = _as_numpy(self.prob)          # a device tensor after fit_device
        scores = prob - np.min(prob)
        m = np.max(scores)
        if m > 0:
            scores = scores / m
        if self.similarity:
            return np.argmax(scores * w, axis=1)
        return np.argmin(scores * w, axis=1)

    def fit_predict(self, train_ind, train_labels, all_labels=None,
                    checkpoint_path=None, checkpoint_every=1):
        with self._span("ssl.fit_predict", train_labels):
            self.fit(train_ind, train_labels, all_labels=all_labels,
                     checkpoint_path=checkpoint_path,
                     checkpoint_every=checkpoint_every)
            return self.predict()

    def _span(self, name, train_labels, trials=1):
        """The fit API's span of an entry point (:mod:`observability`)."""
        return _obs.span(name, model=type(self).__name__,
                         n=None if self.graph is None
                         else self.graph.num_nodes,
                         classes=len(np.unique(train_labels)), trials=trials)

    def warmup(self, num_classes=2, num_labels=None, seed=0):
        """One throwaway fit on a random balanced train set (``num_labels``,
        by default 5 a class, from ``seed``), so that the one-time costs of
        the graph (the band's plan and build, the zero-diagonal copy) are
        paid now and not in the first real fit; the fitted state is then
        reset.  Returns self."""
        n = self.graph.num_nodes
        rs = np.random.RandomState(seed)
        m = num_labels if num_labels is not None else 5 * num_classes
        ti = rs.choice(n, min(m, n), replace=False)
        self.fit(ti, np.arange(len(ti)) % num_classes)
        self.fitted = False
        self.prob = None
        self.weights = 1
        return self

    def fit_predict_batched(self, trainsets, labels):
        """Fit many trials, returning a list of prediction arrays.  Where
        the model has ``_fit_batched`` and all the trials have one size
        (and neither class priors nor one-vs-rest), the trials solve
        together, in groups whose plain gather stays within
        ``_BATCH_BYTES``; otherwise one ``fit_predict`` a trial."""
        labels = np.asarray(labels)
        trainsets = [np.asarray(t) for t in trainsets]
        sizes = {len(t) for t in trainsets}
        with self._span("ssl.fit_predict_batched",
                        labels[np.concatenate(trainsets)] if trainsets
                        else [], len(trainsets)):
            if (len(sizes) == 1 and self.class_priors is None
                    and not self.onevsrest and hasattr(self, "_fit_batched")
                    and self._dist is None):
                preds = self._fit_batched(np.stack(trainsets), labels)
                self.fitted = True
                return [np.asarray(p) for p in preds]
            return [self.fit_predict(t, labels[t]) for t in trainsets]

    def _predict_batched(self, trainsets, labels):
        """The trials' predicted labels from the model's
        ``_solve_batched``; their CG steps in ``self.iters``, an array in
        trial order."""
        classes = _trial_classes(labels)[0]
        preds = [None] * len(trainsets)
        self.iters = np.zeros(len(trainsets), dtype=np.int64)
        for idx, u, iters in self._solve_batched(trainsets, labels):
            self.iters[idx] = iters
            with _obs.span("ssl.labels"):
                for i, ui in zip(idx, _as_numpy(torch.argmax(u, dim=2))):
                    preds[i] = classes[ui]
        return preds

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

    def fit(self, train_ind, train_labels, all_labels=None,
            checkpoint_path=None, checkpoint_every=1):
        """Fit the model; returns the (n, C) scores.  ``checkpoint_path``
        makes the outer loop of PoissonMBO and VolumeMBO resumable: its
        state is saved there every ``checkpoint_every`` rounds
        (:mod:`checkpoint`), and a killed fit run again on the same path
        goes on from its last save to the same prediction.  Models without
        such a loop ignore both."""
        if self.graph is None:
            raise RuntimeError("SSL object has no graph. Use set_graph().")
        self._ckpt = ((os.path.abspath(checkpoint_path),
                       int(checkpoint_every))
                      if checkpoint_path else None)
        if self._dist is not None:
            gap = self._dist_gap(all_labels)
            if gap is not None:
                raise NotImplementedError(
                    f"{type(self).__name__}.fit on a mesh: {gap}")
        train_ind = np.asarray(train_ind)
        train_labels = np.asarray(train_labels)
        self.fitted = True
        with self._span("ssl.fit", train_labels):
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
            with _obs.span("ssl.labels"):
                self.prob = _as_numpy(u)
            if self.class_priors is not None:
                self.volume_label_projection()
        return self.prob

    def _fit(self, train_ind, train_labels, all_labels=None):
        raise NotImplementedError("Must override _fit")

    def _warm_start(self, n, k, dev, dtype):
        """The previous round's scores that an active learner with
        ``warm_start`` leaves in ``self._warm_u``, as a tensor on ``dev``,
        where they have the shape (n, k) of this fit; else None."""
        warm = getattr(self, "_warm_u", None)
        if warm is None or tuple(warm.shape) != (n, k):
            return None
        return torch.as_tensor(warm, device=dev).to(dtype)

    def fit_device(self, train_ind, train_labels):
        """:meth:`fit` that returns the ``(n, C)`` scores as a tensor on
        the graph's device, with no copy to the host; ``self.prob`` is that
        tensor (``predict`` copies it once).  One-vs-rest models and class
        priors take :meth:`fit` and come back as a device tensor."""
        if self.graph is None:
            raise RuntimeError("SSL object has no graph. Use set_graph().")
        dev = self.graph.device
        if (self.onevsrest or self.class_priors is not None
                or self._dist is not None):
            return torch.as_tensor(self.fit(train_ind, train_labels),
                                   device=dev)
        self._ckpt = None
        self.fitted = True
        self.prob = self._fit_on_device(np.asarray(train_ind),
                                        np.asarray(train_labels))
        return self.prob

    def _fit_on_device(self, train_ind, train_labels):
        """``_fit``'s scores on the graph's device.  Laplace's and
        Poisson's ``_fit`` return the device tensor itself; a model whose
        ``_fit`` returns a host array is copied to the device."""
        return torch.as_tensor(self._fit(train_ind, train_labels),
                               device=self.graph.device)

    # -- the trial harness ----------------------------------------------------

    def get_accuracy_filename(self):
        fname = self.accuracy_filename
        if self.class_priors is not None:
            fname += "_classpriors"
        return fname + "_accuracy.csv"

    def ssl_trials(self, trainsets, labels, num_cores=1, tag="",
                   save_results=True, overwrite=False, num_trials=-1,
                   resume=False):
        """Run the trials ``trainsets`` and append a row a trial to
        ``results_dir/<tag><get_accuracy_filename()>``: ``Number of
        labels,Accuracy``, or with class priors the accuracy without and
        with them and the priors' error.  Same-size trials solve together
        (:meth:`fit_predict_batched`).  An existing file is left as it is
        (and None returned) unless ``overwrite``; with ``resume`` the
        trials it already holds are skipped and the new rows appended.
        ``num_cores`` is accepted and unused.  Returns this call's rows."""
        labels = np.asarray(labels)
        has_priors = self.class_priors is not None
        done_rows = 0
        outfile = None
        if save_results:
            os.makedirs(results_dir, exist_ok=True)
            outfile = os.path.join(results_dir,
                                   tag + self.get_accuracy_filename())
            exists = os.path.exists(outfile)
            if exists and resume:
                with open(outfile) as fh:
                    done_rows = max(0, sum(1 for _ in fh) - 1)
            elif exists and not overwrite:
                print(f"Results file {outfile} exists; aborting "
                      "(overwrite=False)")
                return None
            if done_rows == 0:
                with open(outfile, "w") as fh:
                    if has_priors:
                        fh.write("Number of labels,Accuracy,"
                                 "Accuracy with class priors,"
                                 "Class priors error\n")
                    else:
                        fh.write("Number of labels,Accuracy\n")

        if num_trials > 0:
            trainsets = trainsets[:num_trials]
        trainsets = [np.asarray(t) for t in trainsets[done_rows:]]
        if not trainsets:
            return np.zeros((0, 4 if has_priors else 2))

        if has_priors:
            # one fit a trial, then both predictions
            results = []
            for train_ind in trainsets:
                pred = self.fit_predict(train_ind, labels[train_ind])
                acc_with = ssl_accuracy(pred, labels, train_ind)
                acc_without = ssl_accuracy(
                    self.predict(ignore_class_priors=True), labels, train_ind)
                row = (len(train_ind), acc_without, acc_with,
                       self.class_priors_error)
                results.append(row)
                if outfile is not None:
                    with open(outfile, "a") as fh:
                        fh.write("%d,%.2f,%.2f,%.5f\n" % row)
            return np.array(results)

        preds = [None] * len(trainsets)
        by_size = {}
        for i, t in enumerate(trainsets):
            by_size.setdefault(len(t), []).append(i)
        for idxs in by_size.values():
            group = self.fit_predict_batched([trainsets[i] for i in idxs],
                                             labels)
            for i, pred in zip(idxs, group):
                preds[i] = pred

        results = []
        for train_ind, pred in zip(trainsets, preds):
            acc = ssl_accuracy(pred, labels, train_ind)
            results.append((len(train_ind), acc))
            if outfile is not None:
                with open(outfile, "a") as fh:
                    fh.write(f"{len(train_ind)},{acc:.2f}\n")
        return np.array(results)

    def trials_statistics(self, tag=""):
        """``(num_train, acc_mean, acc_stddev, num_trials)`` of the saved
        trials, ``acc_mean`` and ``acc_stddev`` ``(m, c)`` by label count:
        ``c = 1``, or 3 for class-priors files."""
        outfile = os.path.join(results_dir, tag + self.get_accuracy_filename())
        X = np.atleast_2d(utils.csvread(outfile))
        num_train = np.unique(X[:, 0])
        acc_mean, acc_std = [], []
        for m in num_train:
            Y = X[X[:, 0] == m, 1:]
            acc_mean.append(np.mean(Y, axis=0))
            acc_std.append(np.std(Y, axis=0))
        num_trials = int(len(X) / max(1, len(num_train)))
        return num_train, np.array(acc_mean), np.array(acc_std), num_trials


def _as_numpy(u):
    """``u`` on the host; a tensor's copy counts in
    ``counters["host_reads"]``."""
    if not torch.is_tensor(u):
        return np.asarray(u)
    _obs.counters.add("host_reads")
    return u.cpu().numpy()


def _rounds_gap(model, all_labels):
    """What of an MBO fit's rounds the mesh refuses: a checkpoint, which
    the JAX package's sharded fit drops without a word (its sharded
    rounds return before they read it)."""
    if getattr(model, "_ckpt", None) is not None:
        return ("a checkpoint is refused (the JAX package drops it on a "
                "mesh; the port will not drop it silently)")
    return None


def _poisson_mbo_report(all_labels, train_ind):
    """PoissonMBO's ``on_round(i, labels)`` with ``all_labels``: each
    round's accuracy, in the reference's words; None without them."""
    if all_labels is None:
        return None

    def report(i, labels):
        print("%d, Accuracy = %.2f"
              % (i, ssl_accuracy(labels, all_labels, train_ind)))

    return report


def _volume_mbo_report(all_labels, train_ind):
    """VolumeMBO's ``on_round(it, changed, labels)`` with ``all_labels``:
    each iteration's changed labels and accuracy; None without them."""
    if all_labels is None:
        return None

    def report(it, changed, labels):
        print("%d, changed=%d, Accuracy = %.2f"
              % (it, changed, ssl_accuracy(labels, all_labels, train_ind)))

    return report


def warmup(model, num_classes=2, num_train=None, seed=0):
    """Run one ``fit_predict`` of ``model`` on its own graph with synthetic
    labels (``num_train`` nodes from ``seed``, ``num_classes`` classes),
    then reset its fitted state, so that the graph's one-time costs (the
    band's plan and build, the zero-diagonal copy) are paid before the
    real fit.  Returns the model: ``gl.warmup(gl.ssl.poisson(W),
    10).fit_predict(ti, tl)``."""
    rs = np.random.RandomState(seed)
    n = model.graph.num_nodes
    m = num_train if num_train is not None else min(
        max(10, 2 * num_classes), n)
    ti = np.sort(rs.choice(n, m, replace=False))
    model.fit_predict(ti, np.arange(m) % num_classes)
    model.prob = None
    model.fitted = False
    return model


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
        fname = "_laplace"
        self.name = "Laplace Learning"
        if reweighting != "none":
            fname += "_" + reweighting
            self.name += ": " + reweighting + " reweighted"
        if normalization != "combinatorial":
            fname += "_" + normalization
            self.name += " " + normalization
        if mean_shift:
            fname += "_meanshift"
        if self.order > 1:
            fname += "_order%d" % self.order
        if np.max(np.atleast_1d(tau)) > 0:
            fname += "_tau_%.3f" % np.max(np.atleast_1d(tau))
        self.accuracy_filename = fname

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
        with _obs.span("ssl.sources", group=1):
            F = utils.labels_to_onehot(train_labels, k)
            mask = np.zeros(n, dtype=bool)
            mask[train_ind] = True
            bdy = np.zeros((n, k))
            bdy[train_ind] = F
            tau = np.broadcast_to(np.atleast_1d(self.tau), (n,)).astype(float)
            as_t = lambda a: torch.as_tensor(a, device=dev).to(dtype)
            tau_t, bdy_t = as_t(tau), as_t(bdy)
            mask_t = torch.as_tensor(mask, device=dev)
            u0 = self._warm_start(n, k, dev, dtype)

        if self._dist is not None:
            from graphlearning_tpu_torch.parallel import execute as _exec

            u, self.iters = _exec.laplace_fit_sharded(
                self._dist, G.weight_matrix, mask, bdy, tau, self.tol,
                self.normalization, self.order,
                u0=None if u0 is None else u0.cpu().numpy())
            if self.mean_shift:
                u = u - np.mean(u, axis=0)
            return u

        # a reweighted graph's accel rides on its own W, not on the model
        acc = _accel.maybe_build(
            G.weight_matrix,
            cache_obj=self if self.reweighting == "none" else None,
            device=dev)
        if acc is not None:
            u, self.iters = _laplace_accel(
                acc, G.sparse, tau_t, mask_t, bdy_t, self.tol,
                self.normalization, self.order, u0=u0)
        else:
            u, self.iters = _laplace_constrained(
                G.sparse, tau_t, mask_t, bdy_t, self.tol,
                normalization=self.normalization, order=self.order, u0=u0)
        if self.mean_shift:
            u = u - torch.mean(u, dim=0)
        return u

    def _fit_batched(self, trainsets, labels):
        """The trials' predicted labels by :meth:`_solve_batched` (the
        reweighted fits take one ``fit_predict`` a trial: each rebuilds
        its graph)."""
        labels = np.asarray(labels)
        if self.reweighting != "none":
            return [self.fit_predict(t, labels[t]) for t in trainsets]
        return self._predict_batched(trainsets, labels)

    def _solve_batched(self, trainsets, labels):
        """Masked Jacobi CG of the trials (``(T, m)`` train indices), a
        group at a time (:func:`_batch_groups`), by
        :func:`solvers.cg.constrained_solve_batched` over
        :meth:`graph.laplacian_op` on the plain ELL, as the JAX package's
        vmapped solve.  Yields ``(indices, u (G, n, C), iters)``."""
        G = self.graph
        dev = G.device
        dtype = config.float_dtype(dev)
        n = G.num_nodes
        classes, remap = _trial_classes(labels)
        k = len(classes)
        tau = np.broadcast_to(np.atleast_1d(self.tau), (n,)).astype(float)
        tau_t = torch.as_tensor(tau, device=dev).to(dtype)
        matvec, diag = G.laplacian_op(self.normalization)
        order = self.order

        def L(X):
            Y = X
            for _ in range(order):
                Y = tau_t[:, None] * Y + matvec(Y)
            return Y

        Ldiag = (tau_t + diag) ** order
        for idx in _batch_groups(len(trainsets), G.sparse, k, dtype):
            with _obs.span("ssl.sources", group=len(idx)):
                masks = np.zeros((len(idx), n), dtype=bool)
                bdy = np.zeros((len(idx), n, k))
                for t, i in enumerate(idx):
                    ti = np.asarray(trainsets[i])
                    masks[t, ti] = True
                    bdy[t, ti, remap[labels[ti]]] = 1.0
                masks = torch.as_tensor(masks, device=dev)
                bdy = torch.as_tensor(bdy, device=dev).to(dtype)
            with config.exact_matmul():          # d = trials x classes
                u, iters, _ = _cg.constrained_solve_batched(
                    L, Ldiag, masks, bdy, tol=self.tol, max_iter=10**5)
            if self.mean_shift:
                u = u - torch.mean(u, dim=1, keepdim=True)
            yield idx, u, iters


class randomwalk(ssl):
    """Lazy random-walk learning: CG solve of
    ``((1 + tau) I - alpha D^-1/2 W D^-1/2) u = F``."""

    def __init__(self, W=None, class_priors=None, alpha=0.95, tau=0,
                 device=None):
        super().__init__(W, class_priors, device=device)
        self.alpha = alpha
        self.tau = tau
        self.name = "Random Walk"
        self.accuracy_filename = "_randomwalk"

    def _fit(self, train_ind, train_labels, all_labels=None):
        G = self.graph
        dev = G.device
        n = G.num_nodes
        k = len(np.unique(train_labels))
        F = np.zeros((n, k))
        F[train_ind] = utils.labels_to_onehot(train_labels, k)
        if self._dist is not None:
            from graphlearning_tpu_torch.parallel import execute as _exec

            u, self.iters = _exec.randomwalk_fit_sharded(
                self._dist, G.weight_matrix, F, self.alpha, self.tau)
            return u
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
    Laplacian CG with ``D^{+-1/2}`` conjugation), 'gradient_descent'
    (``u <- D^-1 b + D^-1 W u`` until the random walk from the labels
    mixes) and 'spectral' (``u = V ((V^T b) / lambda^p)`` over the first
    ``spectral_cutoff`` nontrivial eigenpairs of the randomwalk Laplacian,
    from :meth:`graph.eigen_decomp_device`, on the f32 band or the gather
    where it takes one).  The parameters are the JAX package's, in its
    order, with ``device`` last: ``p`` and ``spectral_cutoff`` are read by
    the spectral solver only, and ``use_cuda`` is accepted and ignored
    (the device comes from ``device``)."""

    def __init__(self, W=None, class_priors=None, solver="conjugate_gradient",
                 p=1, use_cuda=False, min_iter=50, max_iter=1000, tol=1e-3,
                 spectral_cutoff=10, device=None):
        if solver not in ("conjugate_gradient", "gradient_descent",
                          "spectral"):
            raise ValueError(f"invalid Poisson solver {solver!r}")
        super().__init__(W, class_priors, device=device)
        self.solver = solver
        self.p = p
        self.min_iter = min_iter
        self.max_iter = max_iter
        self.tol = tol
        self.spectral_cutoff = spectral_cutoff
        self.name = "Poisson Learning"
        fname = "_poisson"
        if solver == "spectral":
            fname += "_N%d" % spectral_cutoff
            self.requires_eig = True
        self.accuracy_filename = fname

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
        if self._dist is not None:
            from graphlearning_tpu_torch.parallel import execute as _exec

            if self.solver == "conjugate_gradient":
                warm = getattr(self, "_warm_u", None)
                if warm is not None and np.shape(warm) != (n, k):
                    warm = None
                u, self.iters = _exec.poisson_cg_fit_sharded(
                    self._dist, W, source, self.tol, u0=warm)
            elif self.solver == "spectral":
                info = {}
                vals, vecs = _exec.eigen_decomp_sharded(
                    self._dist, W, normalization="randomwalk",
                    k=self.spectral_cutoff + 1, info=info)
                self.iters = info["iters"]
                b = torch.as_tensor(source, device=dev).to(dtype)
                V = torch.as_tensor(vecs[:, 1:], device=dev).to(dtype)
                lam = torch.as_tensor(vals[1:], device=dev).to(dtype)
                if self.p != 1:
                    lam = lam ** self.p
                with config.exact_matmul():
                    return V @ ((V.T @ b) / lam[:, None])
            else:
                u, self.iters = _exec.poisson_gd_fit_sharded(
                    self._dist, W, source, train_ind, self.min_iter,
                    self.max_iter)
            return u
        b = torch.as_tensor(source, device=dev).to(dtype)
        deg = _ops.degree_vector(g)

        if self.solver == "spectral":
            vals, vecs = G0.eigen_decomp_device(
                normalization="randomwalk", k=self.spectral_cutoff + 1)
            V, lam = vecs[:, 1:], vals[1:]
            if self.p != 1:
                lam = lam ** self.p
            with config.exact_matmul():
                return V @ ((V.T @ b) / lam[:, None])

        if self.solver == "conjugate_gradient":
            s = 1.0 / torch.sqrt(deg)
            # an active learner's warm start u seeds the scaled iterate
            # v = u / s
            x0 = self._warm_start(n, k, dev, dtype)
            if x0 is not None:
                x0 = x0 * torch.sqrt(deg)[:, None]
            acc = _accel.maybe_build(W, cache_obj=self, device=dev)
            if acc is not None:
                u, self.iters = _poisson_accel(acc, s, b, self.tol, x0=x0)
                return u
            v, self.iters = _cg_scaled_solve(g, s, s[:, None] * b, 1.0, 1.0,
                                             self.tol, x0=x0)
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

    def _fit_batched(self, trainsets, labels):
        """The trials' predicted labels by :meth:`_solve_batched` (solvers
        other than conjugate_gradient take one ``fit_predict`` a trial)."""
        labels = np.asarray(labels)
        if self.solver != "conjugate_gradient":
            return [self.fit_predict(t, labels[t]) for t in trainsets]
        return self._predict_batched(trainsets, labels)

    def _solve_batched(self, trainsets, labels):
        """CG on the normalized Laplacian of the zero-diagonal graph for the
        trials (``(T, m)`` train indices), a group at a time
        (:func:`_batch_groups`), by :func:`solvers.cg.conjgrad_batched` on
        the plain ELL, as the JAX package's vmapped solve, each trial's
        kernel component projected out.  Yields ``(indices, u (G, n, C),
        iters)``."""
        dev = self.graph.device
        dtype = config.float_dtype(dev)
        n = self.graph.num_nodes
        _, G0 = self._nodiag_graph()
        g = G0.sparse
        classes, remap = _trial_classes(labels)
        k = len(classes)
        deg = _ops.degree_vector(g)
        s = 1.0 / torch.sqrt(deg)

        def Lnorm(X):
            return X - s[:, None] * _ops.spmm(g, s[:, None] * X)

        for idx in _batch_groups(len(trainsets), g, k, dtype):
            with _obs.span("ssl.sources", group=len(idx)):
                sources = np.zeros((len(idx), n, k))
                for t, i in enumerate(idx):
                    ti = np.asarray(trainsets[i])
                    onehot = np.zeros((len(ti), k))
                    onehot[np.arange(len(ti)), remap[labels[ti]]] = 1.0
                    sources[t, ti] = onehot - onehot.mean(0)
                b = torch.as_tensor(sources, device=dev).to(dtype)
            with config.exact_matmul():          # d = trials x classes
                v, iters, _ = _cg.conjgrad_batched(
                    Lnorm, s[None, :, None] * b, tol=self.tol,
                    max_iter=10**5)
            u = torch.stack([s[:, None] * _project_out_nlap_kernel(vt, deg)
                             for vt in v])
            yield idx, u, iters


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
    device comes from ``device``).  ``solver`` and ``spectral_cutoff`` go
    to the Poisson fit of the start (:class:`poisson`).  The heat steps run
    on the bf16 band or the gather where :func:`~ops.accel.maybe_build`
    takes one (a threshold follows them, so the bf16 band's rounding does
    not matter), else on the plain ELL path; the projection loops stay on
    the device.  With ``all_labels`` the fit prints each round's
    accuracy."""

    def __init__(self, W=None, class_priors=None, solver="conjugate_gradient",
                 use_cuda=False, min_iter=50, max_iter=1000, tol=1e-3,
                 spectral_cutoff=10, Ns=40, mu=1, T=20, device=None):
        super().__init__(W, class_priors, device=device)
        self.poisson_model = poisson(W, solver=solver, min_iter=min_iter,
                                     max_iter=max_iter, tol=tol,
                                     spectral_cutoff=spectral_cutoff,
                                     device=device)
        self.Ns = Ns
        self.mu = mu
        self.T = T
        fname = "_poisson_mbo"
        if solver == "spectral":
            fname += "_N%d" % spectral_cutoff
            self.requires_eig = True
        fname += "_Ns_%d_mu_%.2f_T_%d" % (Ns, mu, T)
        self.accuracy_filename = fname
        self.name = "Poisson MBO"

    def _dist_gap(self, all_labels=None):
        return _rounds_gap(self, all_labels)

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
        report = _poisson_mbo_report(all_labels, train_ind)
        if self._dist is not None:
            from graphlearning_tpu_torch.parallel import execute as _exec

            u, w, err = _exec.poisson_mbo_fit_sharded(
                self._dist, W, self.mu * dt * source,
                utils.labels_to_onehot(labels, k), self.weights,
                self.class_priors, dt, self.Ns, self.T, on_round=report)
            self.weights = w.astype(float)
            self.class_priors_error = err
            return u
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

        on_round = None
        if report is not None:
            def on_round(i, state):
                report(i, torch.argmax(state[0], dim=1).cpu().numpy())
        # with all_labels the checkpoint goes unused, as the JAX package's
        ckpt = None if report is not None else getattr(self, "_ckpt", None)
        u, w, err = _volume.poisson_mbo_loop(
            heat_steps, u, as_t(self.weights), as_t(self.class_priors),
            self.T, ckpt=ckpt, on_round=on_round)
        self.weights = w.cpu().numpy().astype(float)
        self.class_priors_error = float(err)
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
        self.accuracy_filename = "_volume_mbo_temp_%.2f_vol_%.2f" % (
            temperature, volume_constraint)
        self.name = "Volume MBO (T=%.2f, V=%.2f)" % (temperature,
                                                     volume_constraint)

    def _dist_gap(self, all_labels=None):
        return _rounds_gap(self, all_labels)

    def _fit(self, train_ind, train_labels, all_labels=None):
        n = self.graph.num_nodes
        dev = self.graph.device
        dtype = config.float_dtype(dev)
        k = len(np.unique(train_labels))
        W, G = self._nodiag_graph()
        g = G.sparse
        self.voronoi_info = {}
        acc = None
        if self._dist is not None:
            from graphlearning_tpu_torch.parallel import execute as _exec

            # the Voronoi start on the mesh too: K7 over the halo
            _, cp, rounds = _exec.dijkstra_fit_sharded(
                self._dist, W, train_ind, np.zeros(len(train_ind)), 1,
                return_cp=True)
            self.voronoi_info.update(iters=rounds, path="sharded")
        else:
            acc = _accel.maybe_build(W, cache_obj=self, attr="_accel_vmbo",
                                     device=dev, mode="bf16")
            _, cp = _eik.dijkstra(g, train_ind,
                                  bdy_val=np.zeros(len(train_ind)),
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
        seed = (int(np.random.randint(2**31)) if self.seed is None
                else int(self.seed))
        if self._dist is not None:
            # every rank draws the one-device fit's noise
            gen = torch.Generator(device=self._dist.device).manual_seed(seed)
            draw = _volume.gumbel(gen, self._dist._dtype())
            labels, self.iters = _exec.volume_mbo_fit_sharded(
                self._dist, W, labels, fixed, fixed_labels,
                np.floor(vc * self.class_counts),
                np.ceil((2 - vc) * self.class_counts), self.temperature,
                draw, k, self.max_iters,
                on_round=_volume_mbo_report(all_labels, train_ind))
            labels[train_ind] = train_labels
            return utils.labels_to_onehot(labels, k)
        gen = torch.Generator(device=dev).manual_seed(seed)
        draw = _volume.gumbel(gen, dtype)
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

        temp = self.temperature
        report = _volume_mbo_report(all_labels, train_ind)
        on_round = None
        if report is not None:
            def on_round(old, state):
                report(state[1] - 1, int(torch.sum(state[0] != old)),
                       state[0].cpu().numpy())
        labels, self.iters = _volume.mbo_loop(
            dual_conv, as_t(labels), fixed, fixed_labels, lower, upper, temp,
            draw, n_true=n, max_iters=self.max_iters, on_round=on_round,
            ckpt=getattr(self, "_ckpt", None), generator=gen)
        labels = labels.cpu().numpy()
        labels[train_ind] = train_labels
        return utils.labels_to_onehot(labels, k)


# -- the eigenbasis MBO models and the centered kernel method ----------------


class multiclass_mbo(ssl):
    """Multiclass MBO: T rounds of ``Ns`` diffusion steps in the truncated
    eigenbasis of the normalized Laplacian, ``u <- X (V X^T (u - (dt / Ns)
    mu J (u - K)))`` with ``V = 1 / (1 + (dt / Ns) lambda)``, ``J`` the
    labeled rows and ``K`` their one-hot labels, each round ending in the
    one-hot threshold.  The ``num_eig`` eigenpairs come from
    :meth:`graph.eigen_decomp_device` (the f32 band or the gather where it
    takes one); the rounds are dense products on the device.  The random
    start is drawn as the JAX package draws it: from
    ``np.random.RandomState(seed)``, or numpy's global state when ``seed``
    is None.  The parameters are the JAX package's, in its order, with
    ``device`` last.  With ``all_labels`` the fit prints each round's
    accuracy."""

    def __init__(self, W=None, class_priors=None, Ns=6, T=10, dt=0.15, mu=50,
                 num_eig=50, seed=None, device=None):
        super().__init__(W, class_priors, device=device)
        self.Ns, self.T, self.dt, self.mu = Ns, T, dt, mu
        self.num_eig = num_eig
        self.seed = seed
        self.requires_eig = True
        self.accuracy_filename = (
            "_multiclass_mbo_Ns_%d_T_%d_dt_%.3f_mu_%.2f" % (Ns, T, dt, mu))
        self.name = "Multiclass MBO"

    def _fit(self, train_ind, train_labels, all_labels=None):
        Ns, T, dt, mu = self.Ns, self.T, self.dt, self.mu
        n = self.graph.num_nodes
        dev = self.graph.device
        dtype = config.float_dtype(dev)
        k = len(np.unique(train_labels))
        if self._dist is not None:
            from graphlearning_tpu_torch.parallel import execute as _exec

            info = {}
            eigvals, X = (torch.as_tensor(a, device=dev) for a in
                          _exec.eigen_decomp_sharded(
                              self._dist, self.graph.weight_matrix,
                              normalization="normalized", k=self.num_eig,
                              info=info))
            self.iters = info["iters"]       # LOBPCG's steps (0: kept)
        else:
            eigvals, X = self.graph.eigen_decomp_device(
                normalization="normalized", k=self.num_eig)
        X = X.to(dtype)
        V = (1.0 / (1.0 + (dt / Ns) * eigvals)).to(dtype)

        rs = np.random if self.seed is None else np.random.RandomState(
            self.seed)
        u0 = utils.labels_to_onehot(rs.rand(n, k).argmax(axis=1), k)
        u0[train_ind] = utils.labels_to_onehot(train_labels, k)
        J = np.zeros((n, 1))
        J[train_ind] = 1
        K = np.zeros((n, k))
        K[train_ind] = utils.labels_to_onehot(train_labels, k)
        as_t = lambda a: torch.as_tensor(a, device=dev).to(dtype)
        J, K, u = as_t(J), as_t(K), as_t(u0)
        c = (dt / Ns) * mu
        for _ in range(T):
            with config.exact_matmul():
                for _ in range(Ns):
                    Z = u - c * J * (u - K)
                    u = X @ (V[:, None] * (X.T @ Z))
            u = _volume._onehot(torch.argmax(u, dim=1), k, dtype)
            if all_labels is not None:
                self.prob = u.cpu().numpy()
                print("Accuracy = %.2f" % ssl_accuracy(
                    self.predict(), all_labels, train_ind))
        return u


class modularity_mbo(ssl):
    """Modularity MBO: T rounds of the diffusion ``u <- V exp(-D dt) V^T u``
    in the low spectrum ``(D, V)`` of the combinatorial Laplacian plus the
    modularity term (``5 k`` pairs, :meth:`graph.eigen_decomp_device` with
    ``gamma``, on the plain path as in the JAX package), then ``Ns``
    fidelity steps on the labeled rows (``lamb > 0``) and the one-hot
    threshold.  ``dt`` is the JAX package's: the geometric mean of ``0.15 /
    ((gamma + 1) max deg)`` and ``log(|u0| / epsilon) / D[0]``.  The
    parameters are the JAX package's, in its order, with ``device`` last.
    With ``all_labels`` the fit prints each round's accuracy."""

    def __init__(self, W=None, class_priors=None, gamma=0.5, epsilon=1,
                 lamb=1, T=20, Ns=5, device=None):
        super().__init__(W, class_priors, device=device)
        self.gamma, self.epsilon, self.lamb = gamma, epsilon, lamb
        self.T, self.Ns = T, Ns
        self.requires_eig = True
        self.accuracy_filename = (
            "_modularity_mbo_gamma_%.2f_epsilon_%.2f_lamb_%.2f"
            % (gamma, epsilon, lamb))
        self.name = "Modularity MBO"

    def _fit(self, train_ind, train_labels, all_labels=None):
        gamma, eps, lamb, T, Ns = (self.gamma, self.epsilon, self.lamb,
                                   self.T, self.Ns)
        n = self.graph.num_nodes
        dev = self.graph.device
        dtype = config.float_dtype(dev)
        k = len(np.unique(train_labels))
        train_onehot = utils.labels_to_onehot(train_labels, k)
        u0 = np.zeros((n, k))
        u0[train_ind] = train_onehot

        if self._dist is not None:
            from graphlearning_tpu_torch.parallel import execute as _exec

            info = {}
            D, V = _exec.eigen_decomp_mod_sharded(
                self._dist, self.graph.weight_matrix, k=5 * k, gamma=gamma,
                info=info)
            V = torch.as_tensor(V, device=dev)
            self.iters = info["iters"]       # LOBPCG's steps (0: kept)
        else:
            D, V = self.graph.eigen_decomp_device(
                normalization="combinatorial", k=5 * k, gamma=gamma)
            D = D.cpu().numpy()
        deg = self.graph.degree_vector()
        dtlow = 0.15 / ((gamma + 1) * np.max(deg))
        dthigh = np.log(np.linalg.norm(u0) / eps) / max(D[0], 1e-12)
        dt = np.sqrt(dtlow * max(dthigh, dtlow))

        as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(dtype)
        V = V.to(dtype)
        expD = as_t(np.exp(-D * dt))
        ti = torch.as_tensor(np.asarray(train_ind), device=dev)
        onehot = as_t(train_onehot)
        u = as_t(u0)
        for _ in range(T):
            with config.exact_matmul():
                u = V @ (expD[:, None] * (V.T @ u))
            if lamb > 0:
                for _ in range(Ns):
                    u[ti] = u[ti] - (dt / Ns) * lamb * (u[ti] - onehot)
            u = _volume._onehot(torch.argmax(u, dim=1), k, dtype)
            if all_labels is not None:
                self.prob = u.cpu().numpy()
                print("Accuracy = %.2f" % ssl_accuracy(
                    self.predict(), all_labels, train_ind))
        return u


class centered_kernel(ssl):
    """The centered kernel method: the top eigenvalue ``l`` of the centered
    operator ``C W C`` by ``power_it`` power iterations, then the fixed
    point ``u <- u + (C W C u / (alpha l) - u)`` off the labeled rows from
    the centered one-hot labels, until its step is at most ``tol`` (at
    least ``100 eps`` of the dtype) (:func:`solvers.centered.solve`).  The
    operator runs on the f32 band or the gather where
    :func:`~ops.accel.maybe_build` takes one, the column means over the
    true rows.  The power iteration starts from a normal draw seeded by
    ``seed``, in node order on every path (the JAX package draws the
    accels' start in their permuted space).  The parameters are the JAX
    package's, in its order, with ``device`` last; ``self.iters`` holds
    the fixed point's steps."""

    def __init__(self, W=None, class_priors=None, tol=1e-10, power_it=100,
                 alpha=1.05, seed=0, device=None):
        super().__init__(W, class_priors, device=device)
        self.tol = tol
        self.power_it = power_it
        self.alpha = alpha
        self.seed = seed
        self.accuracy_filename = "_centered_kernel"
        self.name = "Centered Kernel"

    def _fit(self, train_ind, train_labels, all_labels=None):
        n = self.graph.num_nodes
        dev = self.graph.device
        dtype = config.float_dtype(dev)
        k = len(np.unique(train_labels))
        W, G = self._nodiag_graph()
        K = np.zeros((n, k))
        K[train_ind] = utils.labels_to_onehot(train_labels, k)
        K[train_ind] -= np.sum(K, axis=0) / len(train_ind)
        mask = np.zeros(n, dtype=bool)
        mask[train_ind] = True
        K = torch.as_tensor(K, device=dev).to(dtype)
        mask = torch.as_tensor(mask, device=dev)
        tol = max(self.tol, 100 * torch.finfo(dtype).eps)
        if self._dist is not None:
            from graphlearning_tpu_torch.parallel import execute as _exec

            u, self.iters = _exec.centered_kernel_fit_sharded(
                self._dist, W, K.cpu().numpy(), mask.cpu().numpy(),
                self.alpha, tol, self.power_it, self.seed)
            return u
        e0 = _centered.start(n, self.seed, dtype, dev)
        info = {}
        acc = _accel.maybe_build(W, cache_obj=self, attr="_accel_ck",
                                 device=dev, mode="f32")
        if acc is not None:
            u = acc.from_perm(acc.centered_kernel(
                acc.to_perm(K), acc.to_perm(mask, fill=True), self.alpha,
                tol, acc.to_perm(e0), self.power_it, n, info=info))
        else:
            g = G.sparse
            u = _centered.solve(lambda X: _ops.spmm(g, X), K, mask,
                                self.alpha, tol, e0, self.power_it, n,
                                info=info)
        self.iters = info["iters"]
        return u


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
        self.accuracy_filename = ("_graph_nearest_neighbor_alpha%.2f"
                                  % self.alpha)
        self.name = "Graph NN (alpha=%.2f)" % self.alpha

    def _fit(self, train_ind, train_labels, all_labels=None):
        g = self.graph.sparse
        info = {}
        if self._dist is not None:
            from graphlearning_tpu_torch.parallel import execute as _exec

            W = self.graph.weight_matrix
            if self.onevsrest:
                u, self.iters = _exec.dijkstra_fit_sharded(
                    self._dist, W, train_ind[train_labels], 0, self.f)
                return u
            _, cp, self.iters = _exec.dijkstra_fit_sharded(
                self._dist, W, train_ind, np.zeros(len(train_ind)), self.f,
                return_cp=True)
        elif self.onevsrest:
            u = _eik.dijkstra(g, train_ind[train_labels], bdy_val=0,
                              f=self.f, info=info)
            self.iters = info["iters"]
            return u
        else:
            _, cp = _eik.dijkstra(g, train_ind,
                                  bdy_val=np.zeros(len(train_ind)), f=self.f,
                                  return_cp=True, info=info)
            self.iters = info["iters"]
        lab_of = np.zeros(self.graph.num_nodes, dtype=int)
        lab_of[train_ind] = train_labels
        k = len(np.unique(train_labels))
        return utils.labels_to_onehot(lab_of[cp], k)


def _onehot_bdy(train_labels, unique_labels):
    return (train_labels[:, None] == unique_labels[None, :]).astype(float)


def _lip_sharded(model, train_ind, bdy_vals, alpha, beta, weighted, tol):
    """A Lipschitz fit on the mesh (``parallel.execute.lip_fit_sharded``)
    from the Voronoi start, the closest labeled node's values by the
    sharded Bellman-Ford (K7 over the halo on the band).  Sets the
    model's ``iters``, ``path`` and ``info`` (with the start's rounds,
    "voronoi_iters")."""
    from graphlearning_tpu_torch.parallel import execute as _exec

    W = model.graph.weight_matrix
    _, cp, voronoi = _exec.dijkstra_fit_sharded(
        model._dist, W, train_ind, np.zeros(len(train_ind)), 1,
        return_cp=True)
    u, model.iters = _exec.lip_fit_sharded(
        model._dist, W, train_ind, bdy_vals, alpha=alpha, beta=beta,
        weighted=weighted, tol=tol, max_num_it=model.max_num_it,
        u0=_pl.voronoi_values(cp, train_ind, bdy_vals))
    model.path = "sharded"
    model.info = {"iters": model.iters, "voronoi_iters": voronoi,
                  "path": model.path}
    return u


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
        self.accuracy_filename = "_amle" + ("" if weighted else "_unweighted")
        self.name = "AMLE"

    def _fit(self, train_ind, train_labels, all_labels=None):
        return self.graph.amle(train_ind, train_labels.astype(float),
                               tol=self.tol, max_num_it=self.max_num_it,
                               weighted=self.weighted)

    def _fit_onevsrest(self, train_ind, train_labels, unique_labels):
        if self._dist is not None:
            return _lip_sharded(self, train_ind,
                                _onehot_bdy(train_labels, unique_labels),
                                0.0, 1.0, self.weighted, self.tol)
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
        self.accuracy_filename = "_peikonal_p%.2f_alpha%.2f" % (self.p,
                                                                self.alpha)
        self.name = "p-eikonal (p=%.2f, alpha=%.2f)" % (self.p, self.alpha)

    def _fit(self, train_ind, train_labels, all_labels=None):
        return self.graph.peikonal(train_ind[train_labels], bdy_val=0,
                                   f=self.f, p=self.p,
                                   max_num_it=self.max_num_it, tol=self.tol,
                                   num_bisection_it=self.num_bisection_it)

    def _fit_onevsrest(self, train_ind, train_labels, unique_labels):
        if self._dist is not None:
            from graphlearning_tpu_torch.parallel import execute as _exec

            n = self.graph.num_nodes
            bdy_mask = np.zeros((n, len(unique_labels)), dtype=bool)
            for c, l in enumerate(unique_labels):
                bdy_mask[train_ind[train_labels == l], c] = True
            u, self.iters = _exec.peikonal_fit_sharded(
                self._dist, self.graph.weight_matrix, bdy_mask,
                _eik._speed(self.f, n), self.p, self.tol, self.max_num_it,
                self.num_bisection_it)
            return u
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
        self.accuracy_filename = "_plaplace_p%.2f" % self.p
        self.name = "p-Laplace (p=%.2f)" % self.p

    def _fit(self, train_ind, train_labels, all_labels=None):
        return self.graph.plaplace(train_ind, train_labels.astype(float),
                                   self.p, max_num_it=self.max_num_it,
                                   tol=self.tol)

    def _fit_onevsrest(self, train_ind, train_labels, unique_labels):
        if self._dist is not None and self.fast:
            # the two-sided sandwich (fast=False) fits on one device, as
            # the JAX package's does
            alpha = 1.0 / (self.p - 1.0)
            return _lip_sharded(self, train_ind,
                                _onehot_bdy(train_labels, unique_labels),
                                alpha, 1.0 - alpha, False,
                                self.tol if self.tol < 1e-1 else 1e-5)
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


# -- dynamic and sparse label propagation -------------------------------------


class dynamic_label_propagation(ssl):
    """Dynamic label propagation: ``T`` rounds of ``u <- P_t u`` (the
    labels reset on the labeled rows) and ``P_t <- P P_t P^T + alpha v v^T
    + lam I`` (``v = P u``), with ``P`` the dense row-normalised weight
    matrix of the zero-diagonal graph: dense products on the device, in
    full f32 on CUDA.  The graph must have at most 5000 nodes; above that
    the fit prints so and returns zeros, as the JAX package does.  The
    parameters are the JAX package's, in its order, with ``device`` last.
    With ``all_labels`` the fit prints each round's accuracy."""

    _sharded_supported = False

    def __init__(self, W=None, class_priors=None, alpha=0.05, lam=0.1, T=2,
                 device=None):
        super().__init__(W, class_priors, device=device)
        self.alpha, self.lam, self.T = alpha, lam, T
        self.accuracy_filename = "_dynamic_label_propagation"
        self.name = "Dynamic Label Propagation"

    def _fit(self, train_ind, train_labels, all_labels=None):
        n = self.graph.num_nodes
        k = len(np.unique(train_labels))
        if n > 5000:
            print("Cannot use Dynamic Label Propagation on large datasets.")
            return np.zeros((n, k))
        dev = self.graph.device
        dtype = config.float_dtype(dev)
        W = self.graph.weight_matrix.copy()
        W.setdiag(0)
        W.eliminate_zeros()
        d = np.asarray(W.sum(1)).ravel()
        as_t = lambda a: torch.as_tensor(a, device=dev).to(dtype)
        P = as_t(np.asarray(W.todense()) / d[:, None])
        K = utils.labels_to_onehot(train_labels, k)
        k = K.shape[1]       # one-hot widens k for non-consecutive label ids
        u = np.zeros((n, k))
        u[train_ind] = K
        u, K = as_t(u), as_t(K)
        ti = torch.as_tensor(np.asarray(train_ind), device=dev)
        eye = torch.eye(n, dtype=dtype, device=dev)
        Pt = P
        for _ in range(self.T):
            with config.exact_matmul():
                v = P @ u
                u = Pt @ u
                u[ti] = K
                Pt = P @ Pt @ P.T + self.alpha * (v @ v.T) + self.lam * eye
            if all_labels is not None:
                self.prob = u.cpu().numpy()
                print("Accuracy = %.2f" % ssl_accuracy(
                    self.predict(), all_labels, train_ind))
        return u


class sparse_label_propagation(ssl):
    """Sparse label propagation: ``T`` rounds of the primal-dual TV
    iteration on the graph's flat edge list (:meth:`_edge_list`), the
    classes batched: the dual field ``Y`` on the edges, the divergence
    summed per row by :func:`core.sparse.segment_reduce` (sorted rows, the
    same sums in every run), the labels reset on the labeled rows.  The
    parameters are the JAX package's, in its order, with ``device``
    last."""

    def __init__(self, W=None, class_priors=None, T=100, device=None):
        super().__init__(W, class_priors, device=device)
        self.T = T
        self.accuracy_filename = "_sparse_label_propagation"
        self.name = "Sparse LP"

    def _edge_list(self):
        """``(erow, ecol, ew, emir)`` on the graph's device: the stored
        entries in row order, padded to a multiple of 256 with rows at
        ``n`` and zero weights, and the position of each edge's mirror
        ``(col, row)`` (a pad, or an edge with no mirror, its own).  Built
        once and kept on the scipy matrix, a copy per device."""
        W0 = self.graph.weight_matrix
        dev = self.graph.device
        cache = getattr(W0, "_gltt_edges", None)
        if not isinstance(cache, dict):
            cache = W0._gltt_edges = {}
        key = str(dev)
        if key not in cache:
            coo = W0.tocoo()
            m = coo.nnz
            n = W0.shape[0]
            mp = max(256, ((m + 255) // 256) * 256)
            erow = np.full(mp, n, np.int64)
            ecol = np.zeros(mp, np.int64)
            ew = np.zeros(mp, np.float64)
            erow[:m] = coo.row
            ecol[:m] = coo.col
            ew[:m] = coo.data
            ekey = erow * (n + 1) + ecol
            mkey = ecol * (n + 1) + erow
            mkey[m:] = ekey[m:]                 # pads mirror themselves
            order = np.argsort(ekey, kind="stable")
            pos = np.clip(np.searchsorted(ekey[order], mkey), 0, mp - 1)
            emir = np.where(ekey[order][pos] == mkey, order[pos],
                            np.arange(mp))
            as_t = lambda a: torch.as_tensor(a, device=dev)
            cache[key] = (as_t(erow), as_t(ecol),
                          as_t(ew).to(config.float_dtype(dev)), as_t(emir))
        return cache[key]

    def _fit(self, train_ind, train_labels, all_labels=None):
        if self._dist is not None:
            from graphlearning_tpu_torch.parallel import execute as _exec

            return _exec.sparse_lp_fit_sharded(self._dist, self, train_ind,
                                               train_labels)
        n = self.graph.num_nodes
        dev = self.graph.device
        dtype = config.float_dtype(dev)
        kc = len(np.unique(train_labels))
        onehot = utils.labels_to_onehot(train_labels, kc)
        if onehot.shape[1] != kc:
            raise ValueError("sparse_label_propagation takes the label ids "
                             f"0..{kc - 1}, not {np.unique(train_labels)}")
        onehot = torch.as_tensor(onehot, device=dev).to(dtype)
        erow, ecol, ew, emir = self._edge_list()
        ti = torch.as_tensor(np.asarray(train_ind), device=dev)
        gamma = 1.0 / _ops.degree_vector(self.graph.sparse).to(dtype)
        return _sparse_lp_run(erow, ecol, ew, emir, gamma, ti, onehot, n, kc,
                              self.T)


def _sparse_lp_run(erow, ecol, ew, emir, gamma, ti, onehot, n, kc, T,
                   reduce=None, gather=None):
    """The primal-dual TV iteration of :class:`sparse_label_propagation`,
    ``lam_e = 1 / (2 w_e + 1e-10)``; zero-weight pads add nothing to the
    gradient or the divergence.  On a mesh the edges are the rank's slice
    (``emir`` global positions): ``gather`` all-gathers the dual field for
    the mirrors and ``reduce`` sums the divergence over the ranks."""
    from graphlearning_tpu_torch.core.sparse import segment_reduce

    lam = 1.0 / (2.0 * ew + 1e-10)
    rows = torch.clamp(erow, max=n - 1)
    u = torch.zeros((n, kc), dtype=gamma.dtype, device=gamma.device)
    Y = torch.zeros((erow.shape[0], kc), dtype=gamma.dtype,
                    device=gamma.device)
    for _ in range(T):
        u_prev = u
        Yall = Y if gather is None else gather(Y)
        contrib = ew[:, None] * (Y - Yall[emir])
        div = segment_reduce(
            torch.zeros((n + 1, kc), dtype=u.dtype, device=u.device), erow,
            contrib, "sum")
        if reduce is not None:
            div = reduce(div)
        div = 0.5 * div[:n]
        u = u_prev - gamma[:, None] * (2.0 * div)
        u[ti] = onehot
        u_tilde = 2.0 * u - u_prev
        Gu = -(ew[:, None] * (u_tilde[ecol] - u_tilde[rows]))
        Y = torch.clamp(Y + Gu * lam[:, None], -1.0, 1.0)
    return u


# -- report generators ------------------------------------------------------


def accuracy_plot(model_list, tag="", testerror=False, savefile=None,
                  title=None, errorbars=False, loglog=False, ylim=None,
                  fontsize=16, legend_fontsize=16, label_fontsize=16):
    """Plot each model's mean accuracy (or test error) against the number
    of labels from its :meth:`ssl.ssl_trials` file, class-priors runs with
    a second '+CP' series, on a new matplotlib figure (saved to
    ``savefile``, else shown).  Needs matplotlib, imported here."""
    import matplotlib
    import matplotlib.pyplot as plt

    if errorbars:
        matplotlib.rcParams.update({"errorbar.capsize": 5})
    matplotlib.rcParams.update({"font.size": fontsize})
    styles = ["^b-", "or-", "dg-", "sk-", "pm-", "xc-", "*y-"]
    plt.figure()
    si = -1
    for model in model_list:
        num_train, acc_mean, acc_std, _ = model.trials_statistics(tag=tag)
        if testerror:
            acc_mean = 100.0 - acc_mean
        series = [(acc_mean[:, 0], acc_std[:, 0], model.name)]
        if acc_mean.shape[1] > 1:
            series.append((acc_mean[:, 1], acc_std[:, 1],
                           model.name + "+CP"))
        for y, yerr, name in series:
            si = (si + 1) % len(styles)
            style = styles[si]
            if errorbars:
                plt.errorbar(num_train, y, fmt=style, yerr=yerr, label=name)
            elif loglog:
                plt.loglog(num_train, y, style, label=name)
            else:
                plt.plot(num_train, y, style, label=name)
    plt.xlabel("Number of labels", fontsize=label_fontsize)
    if testerror:
        plt.ylabel("Test error (%)", fontsize=label_fontsize)
        plt.legend(loc="upper right", fontsize=legend_fontsize)
    else:
        plt.ylabel("Accuracy (%)", fontsize=label_fontsize)
        plt.legend(loc="lower right", fontsize=legend_fontsize)
    if title is not None:
        plt.title(title)
    plt.tight_layout()
    plt.grid(True)
    if ylim is not None:
        plt.ylim(ylim)
    if savefile is not None:
        plt.savefig(savefile)
    else:
        plt.show()


def accuracy_table(model_list, tag="", testerror=False, savefile="table.tex",
                   title="", fontsize="small", append=False, two_column=False,
                   small_caps=True):
    """Write a LaTeX table of each model's mean (standard deviation)
    accuracy by label count from its :meth:`ssl.ssl_trials` file, the best
    of each column in bold (class-priors runs add a '+CP' row and compete
    for it); ``testerror`` reports 100 less the accuracy."""
    stats = [m.trials_statistics(tag=tag) for m in model_list]
    num_train = stats[0][0]
    ncols = len(num_train)
    num_trials = int(stats[0][3])

    best = [None] * ncols
    class_priors_best = [False] * ncols
    best_score = [-np.inf] * ncols
    for i, (_, acc_mean, _, _) in enumerate(stats):
        for j in range(ncols):
            if acc_mean[j, 0] > best_score[j]:
                best_score[j] = acc_mean[j, 0]
                best[j] = i
                class_priors_best[j] = False
        if acc_mean.shape[1] > 1:
            for j in range(ncols):
                if acc_mean[j, 1] > best_score[j]:
                    best_score[j] = acc_mean[j, 1]
                    best[j] = i
                    class_priors_best[j] = True

    env = "table*" if two_column else "table"
    lines = []
    if not append:
        lines += ["\\documentclass{article}", "\\usepackage[T1]{fontenc}",
                  "\\usepackage{booktabs}",
                  "\\usepackage[margin=1in]{geometry}",
                  "\\begin{document}"]
    lines += [
        "", f"\\begin{{{env}}}[t!]", "\\vspace{-3mm}",
        ("\\caption{%s: Average (standard deviation) %s over %d trials.}"
         % (title, "test error" if testerror else "classification accuracy",
            num_trials)),
        "\\vspace{-3mm}", "\\label{tab:%s}" % title, "\\vskip 0.15in",
        "\\begin{center}", f"\\begin{{{fontsize}}}",
    ]
    if small_caps:
        lines.append("\\begin{sc}")
    lines.append("\\begin{tabular}{l" + "l" * ncols + "}")
    lines.append("\\toprule")
    lines.append("\\# Labels" + "".join(
        "&\\textbf{%d}" % int(m) for m in num_train) + "\\\\")
    lines.append("\\midrule")

    def emit_row(name, vals, errs, is_best):
        row = name.ljust(15)
        for j in range(ncols):
            v = 100.0 - vals[j] if testerror else vals[j]
            cell = "%.1f (%.1f)" % (v, errs[j])
            row += "&{\\bf %s}" % cell if is_best(j) else "&%s      " % cell
        lines.append(row + "\\\\")

    for i, model in enumerate(model_list):
        _, acc_mean, acc_std, _ = stats[i]
        emit_row(model.name, acc_mean[:, 0], acc_std[:, 0],
                 lambda j, i=i: best[j] == i and not class_priors_best[j])
        if acc_mean.shape[1] > 1:
            emit_row(model.name + "+CP", acc_mean[:, 1], acc_std[:, 1],
                     lambda j, i=i: best[j] == i and class_priors_best[j])
    lines += ["\\bottomrule", "\\end{tabular}"]
    if small_caps:
        lines.append("\\end{sc}")
    lines += [f"\\end{{{fontsize}}}", "\\end{center}", "\\vskip -0.1in",
              f"\\end{{{env}}}", "", "\\end{document}", ""]

    if append and os.path.exists(savefile):
        with open(savefile) as fh:
            old = [ln for ln in fh.read().splitlines()
                   if ln != "\\end{document}"]
        lines = old + lines
    with open(savefile, "w") as fh:
        fh.write("\n".join(lines))
