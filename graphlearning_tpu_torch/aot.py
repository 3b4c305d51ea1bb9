"""Fit packs: a graph's Poisson, Laplace or spectral-clustering fit on the
segmented gather, saved once and loaded in a fresh process.

Counterpart of ``graphlearning_tpu/aot.py``.  The JAX package's pack
serializes a compiled XLA executable, so that a fresh process skips
tracing and compiling.  The port compiles nothing at run time: its pack
is a ``torch.save`` file of plain metadata and tensors, the kind, ``n``,
``nnz``, the gather's degree segments, the fit's statics (``tol``,
``normalization``, ``order``, ``tau``, ``n_init``, ``km_iter``) and, for
spectral clustering, LOBPCG's start.  Loading it
builds the :class:`~graphlearning_tpu_torch.ops.gather.GatherAccel` of
the ``W`` it is given (the fit is always W's own, as the JAX package's
load builds its operator from W), refuses a graph of another geometry or
a pack of another kind, and returns ``fit_predict``.

Each fit computes what the JAX package's pack program computes, on the
gather, by the model path's own solve and from its starts and seeds, so
a pack and ``ssl.poisson(W)`` / ``ssl.laplace(W)`` /
``clustering.spectral(W)`` agree where ``ops.accel.maybe_build`` sends
the graph to the gather:

* Poisson: CG on the normalized Laplacian, the ``D^{1/2} 1`` kernel
  projected out (``ssl._poisson_accel``, ``ssl.poisson``'s
  conjugate-gradient fit);
* Laplace: the masked Jacobi CG on ``tau + L^order``
  (``ssl._laplace_accel``, ``ssl.laplace``'s fit);
* spectral: ``solvers.eig.eigen_decomp`` of the normalized Laplacian on
  the gather from the saved start, with ``graph.eigen_decomp_device``'s
  guard vectors, the row-normalized eigenvectors, then the device k-means
  with ``n_init`` restarts.

A pack holds CPU tensors only: it loads on any device.  The JAX
package's recompiling fallback for XLA:CPU's deserializer has no
counterpart: there is no executable to deserialize.

.. warning:: SECURITY: loading a pack runs ``torch.load(path,
   weights_only=True)``, which unpickles tensors and plain containers
   only and refuses any other object; still, load only packs that you
   saved or that come from a trusted source, as with any ``torch.load``
   checkpoint.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from graphlearning_tpu_torch import config
from graphlearning_tpu_torch import ssl as _ssl
from graphlearning_tpu_torch.core.sparse import SparseGraph
from graphlearning_tpu_torch.ops import graphops as _ops
from graphlearning_tpu_torch.ops.gather import GatherAccel, degree_segments
from graphlearning_tpu_torch.solvers import eig as _eig


def _nodiag(W):
    """Zero-diagonal copy (``ssl.poisson``'s fit graph)."""
    W = sp.csr_matrix(W).copy()
    W.setdiag(0)
    W.eliminate_zeros()
    return W


def _graph(W, device) -> SparseGraph:
    """``W``'s device ELL, whose degrees and diagonal the model paths read
    (:func:`ops.graphops.degree_vector`): a pack's fit starts from the
    same vectors, bit for bit."""
    return SparseGraph.from_scipy(W, device=device)


def _save(path, meta):
    torch.save(meta, path)
    return path


def _load(W, path, kind, device):
    """The pack at ``path`` (which must be a ``kind`` pack) and the gather
    of ``W`` on ``device``, whose geometry must be the pack's."""
    meta = torch.load(path, map_location="cpu", weights_only=True)
    if meta.get("kind") != kind:
        raise ValueError(f"not a {kind} pack: {meta.get('kind')}")
    acc = GatherAccel(W, prec="f32", device=device)
    segs = [tuple(s) for s in meta["segs"]]
    if [tuple(s) for s in acc.segs] != segs or acc.n != meta["n"]:
        raise ValueError(
            "AOT pack graph geometry mismatch: the pack was built for a "
            f"graph with segments {segs} (n={meta['n']}); this graph has "
            f"{acc.segs} (n={acc.n})")
    return meta, acc


def _meta(kind, W, **statics):
    """A pack's metadata: its kind, ``W``'s size and gather geometry
    (:func:`ops.gather.degree_segments`, host arithmetic) and the
    statics."""
    W = sp.csr_matrix(W)
    _, segs = degree_segments(np.diff(W.indptr))
    return {"kind": kind, "n": W.shape[0], "nnz": int(W.nnz),
            "segs": [tuple(int(v) for v in s) for s in segs],
            "prec": "f32", **statics}


def _classes(train_labels, C):
    classes = np.unique(train_labels)
    if len(classes) != C:
        raise ValueError(f"pack was built for {C} classes, "
                         f"got {len(classes)}")
    return classes


# -- Poisson ------------------------------------------------------------------


def save_poisson_pack(W, num_classes: int, path: str, tol: float = 1e-3):
    """Save the Poisson fit of ``W`` for ``num_classes`` classes to
    ``path``: once per graph geometry (right after the kNN graph is built,
    before labels exist: the pack holds no labels).  Host work only: no
    device is touched.  Returns ``path``."""
    return _save(path, _meta("poisson", _nodiag(W),
                             num_classes=int(num_classes), tol=float(tol)))


def load_poisson_pack(W, path: str, warm: bool = True, device=None):
    """Load a pack saved by :func:`save_poisson_pack` for a graph of the
    same geometry and return ``fit_predict(train_ind, train_labels) ->
    labels``, the Poisson fit of ``W`` on its gather on ``device``
    (:func:`config.device`).  ``warm`` runs one zero-source fit now, so
    that the device's one-time costs are paid at load."""
    dev = config.device(device)
    W = _nodiag(W)
    meta, acc = _load(W, path, "poisson", dev)
    s = 1.0 / torch.sqrt(_ops.degree_vector(_graph(W, dev)))
    n, C, tol = meta["n"], meta["num_classes"], meta["tol"]
    dtype = config.float_dtype(dev)

    def solve(b):
        return _ssl._poisson_accel(acc, s, b, tol)[0]

    if warm:
        solve(torch.zeros((n, C), dtype=dtype, device=dev))

    def fit_predict(train_ind, train_labels):
        train_ind = np.asarray(train_ind)
        train_labels = np.asarray(train_labels)
        classes = _classes(train_labels, C)
        onehot = (train_labels[:, None] == classes[None, :]).astype(float)
        b = np.zeros((n, C))
        b[train_ind] = onehot - onehot.mean(0)
        u = solve(torch.as_tensor(b, device=dev).to(dtype))
        return classes[torch.argmax(u, dim=1).cpu().numpy()]

    fit_predict.num_classes = C
    return fit_predict


# -- Laplace ------------------------------------------------------------------


def save_laplace_pack(W, num_classes: int, path: str, tol: float = 1e-5,
                      normalization: str = "combinatorial", order: int = 1,
                      tau: float = 0.0):
    """Save the Laplace-learning fit of ``W`` (``ssl.laplace`` with no
    reweighting) for ``num_classes`` classes to ``path``, the companion of
    :func:`save_poisson_pack`.  Returns ``path``."""
    return _save(path, _meta(
        "laplace", W, num_classes=int(num_classes), tol=float(tol),
        normalization=normalization, order=int(order), tau=float(tau)))


def load_laplace_pack(W, path: str, warm: bool = True, device=None):
    """Load a pack saved by :func:`save_laplace_pack` for a graph of the
    same geometry and return ``fit_predict(train_ind, train_labels) ->
    labels`` on ``device``; ``warm`` as :func:`load_poisson_pack`."""
    dev = config.device(device)
    meta, acc = _load(sp.csr_matrix(W), path, "laplace", dev)
    g = _graph(W, dev)
    n, C = meta["n"], meta["num_classes"]
    dtype = config.float_dtype(dev)
    tau = torch.full((n,), meta["tau"], dtype=dtype, device=dev)

    def solve(mask, bdy):
        return _ssl._laplace_accel(acc, g, tau, mask, bdy, meta["tol"],
                                   meta["normalization"], meta["order"])[0]

    if warm:
        solve(torch.zeros(n, dtype=torch.bool, device=dev),
              torch.zeros((n, C), dtype=dtype, device=dev))

    def fit_predict(train_ind, train_labels):
        train_ind = np.asarray(train_ind)
        train_labels = np.asarray(train_labels)
        classes = _classes(train_labels, C)
        mask = np.zeros(n, bool)
        mask[train_ind] = True
        bdy = np.zeros((n, C))
        bdy[train_ind] = train_labels[:, None] == classes[None, :]
        u = solve(torch.as_tensor(mask, device=dev),
                  torch.as_tensor(bdy, device=dev).to(dtype))
        return classes[torch.argmax(u, dim=1).cpu().numpy()]

    fit_predict.num_classes = C
    return fit_predict


# -- spectral clustering --------------------------------------------------------


def _spectral_fit_aot(acc, g, X0, *, k, kcl, n_init, km_iter):
    """NgJordanWeiss spectral clustering on the gather ``acc`` (the model
    path's steps): :func:`solvers.eig.eigen_decomp` of the normalized
    Laplacian of ``g`` from the start ``X0`` (n, k + guard) in node order,
    the ``k`` lowest pairs kept, the eigenvectors' rows normalized, then
    the device k-means into ``kcl`` clusters (``n_init`` restarts of
    ``km_iter`` steps at most, seed 0).  Returns int32 labels in node
    order."""
    from graphlearning_tpu_torch.clustering import _unit_rows
    from graphlearning_tpu_torch.solvers.kmeans import kmeans

    _, U = _eig.eigen_decomp(g, normalization="normalized", k=X0.shape[1],
                             accel=acc, X0=X0)
    return kmeans(_unit_rows(U[:, :k]), kcl, n_init=n_init,
                  max_iter=km_iter, seed=0)


def save_spectral_pack(W, num_clusters: int, path: str, extra_dim: int = 0,
                       n_init: int = 10, km_iter: int = 50, device=None):
    """Save NgJordanWeiss spectral clustering of ``W`` into
    ``num_clusters`` clusters to ``path``, with LOBPCG's start: the model
    path's draw on ``device`` (:func:`config.device`), so that a pack
    loaded there starts where ``clustering.spectral`` does.  Returns
    ``path``."""
    dev = config.device(device)
    dtype = config.float_dtype(dev)
    n = W.shape[0]
    k = int(num_clusters) + int(extra_dim)
    # the k pairs and graph.eigen_decomp_device's guard vectors
    X0 = _eig._start(n, k + _eig.guard_count(n, k), None, dtype, dev)
    return _save(path, _meta(
        "spectral", W, num_clusters=int(num_clusters),
        extra_dim=int(extra_dim), n_init=int(n_init), km_iter=int(km_iter),
        start=X0.cpu()))


def load_spectral_pack(W, path: str, warm: bool = True, device=None):
    """Load a pack saved by :func:`save_spectral_pack` for a graph of the
    same geometry and return ``fit_predict() -> labels`` on ``device``.
    ``warm`` runs the fit now and keeps its labels, which ``fit_predict``
    returns: the fit depends on nothing but the graph and the pack."""
    dev = config.device(device)
    W = sp.csr_matrix(W)
    meta, acc = _load(W, path, "spectral", dev)
    dtype = config.float_dtype(dev)
    g = _graph(W, dev)
    X0 = meta["start"].to(dev).to(dtype)
    kw = dict(k=meta["num_clusters"] + meta["extra_dim"],
              kcl=meta["num_clusters"], n_init=meta["n_init"],
              km_iter=meta["km_iter"])
    kept = {}

    def run():
        return _spectral_fit_aot(acc, g, X0, **kw).cpu().numpy()

    if warm:
        kept["labels"] = run()

    def fit_predict():
        labels = kept["labels"] if "labels" in kept else run()
        return labels.copy()

    fit_predict.num_clusters = meta["num_clusters"]
    return fit_predict
