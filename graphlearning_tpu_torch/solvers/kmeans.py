"""k-means on the device: greedy k-means++ seeding and Lloyd iterations
(counterpart of ``graphlearning_tpu/solvers/kmeans.py``).

The ``n_init`` restarts run together on a leading axis.  Seeding is
sklearn's greedy k-means++: at each step ``L = 2 + int(log k)`` candidates
drawn with probability proportional to the squared distance to the nearest
center (a Gumbel-max draw over ``log d^2``, as ``jax.random.categorical``
draws), keeping the one that lowers the total potential most.  Lloyd's
iterations then run to convergence (no label moves) or ``max_iter``; a
restart that has converged stays frozen while the others go on, and an
empty cluster keeps its center.  The restart of least inertia wins, the
first on ties.  The host reads the restarts' convergence once a Lloyd
iteration.  The draws come from a ``torch.Generator``, so they are not the
JAX package's; :func:`_kmeans_all` also takes given starting centers.
"""

from __future__ import annotations

import math

import torch

from graphlearning_tpu_torch import config
from graphlearning_tpu_torch.solvers.volume import gumbel


def _sqdist(X, Xsq, C):
    """Squared distances ``(r, n, j)`` of the rows of ``X`` (n, d) to the
    centers ``C`` (r, j, d), by one product (rounding may leave them
    slightly negative)."""
    return (Xsq[None, :, None] - 2.0 * (X @ C.transpose(1, 2))
            + torch.sum(C * C, dim=2)[:, None, :])


def _plus_plus(X, Xsq, k: int, n_init: int, gen):
    """Greedy k-means++ centers ``(n_init, k, d)``."""
    n, d = X.shape
    L = 2 + int(math.log(max(k, 2)))
    draw = gumbel(gen, X.dtype)
    rows = torch.arange(n_init, device=X.device)
    first = torch.randint(0, n, (n_init,), generator=gen, device=X.device)
    C = torch.zeros((n_init, k, d), dtype=X.dtype, device=X.device)
    C[:, 0] = X[first]
    d2 = torch.clamp(_sqdist(X, Xsq, C[:, :1])[:, :, 0], min=0.0)  # (r, n)
    for i in range(1, k):
        logits = torch.where(d2 > 0, torch.log(d2),
                             torch.full_like(d2, -math.inf))
        idx = torch.argmax(logits[:, None, :] + draw((n_init, L, n)), dim=2)
        cand = X[idx]                                           # (r, L, d)
        d2c = torch.clamp(_sqdist(X, Xsq, cand), min=0.0).transpose(1, 2)
        pot = torch.sum(torch.minimum(d2[:, None, :], d2c), dim=2)
        best = torch.argmin(pot, dim=1)
        C[:, i] = cand[rows, best]
        d2 = torch.minimum(d2, d2c[rows, best])
    return C


def _assign(X, Xsq, C):
    """Labels ``(r, n)`` of the nearest centers and the inertias (r,)."""
    Dmin, lab = torch.min(_sqdist(X, Xsq, C), dim=2)
    return lab, torch.sum(Dmin, dim=1)


def _kmeans_all(X, k: int, n_init: int, max_iter: int, gen=None, C0=None):
    """The ``n_init`` restarts of k-means on the rows of ``X`` from the
    centers ``C0`` (n_init, k, d), else from greedy k-means++ drawn from
    ``gen``.  Returns the best restart's ``(labels, inertia)``: int32
    labels (n,) and a 0-d tensor, on ``X``'s device."""
    with config.exact_matmul():
        Xsq = torch.sum(X * X, dim=1)
        C = _plus_plus(X, Xsq, k, n_init, gen) if C0 is None else C0
        lab, _ = _assign(X, Xsq, C)
        done = torch.zeros(n_init, dtype=torch.bool, device=X.device)
        it = 0
        while it < max_iter and not bool(done.all()):
            onehot = torch.nn.functional.one_hot(lab, k).to(X.dtype)
            counts = torch.sum(onehot, dim=1)                   # (r, k)
            sums = onehot.transpose(1, 2) @ X                   # (r, k, d)
            Cnew = torch.where(counts[:, :, None] > 0, sums / torch.clamp(
                counts, min=1.0)[:, :, None], C)
            new_lab, _ = _assign(X, Xsq, Cnew)
            moved = torch.any(new_lab != lab, dim=1)
            C = torch.where(done[:, None, None], C, Cnew)
            lab = torch.where(done[:, None], lab, new_lab)
            done = done | ~moved
            it += 1
        _, inertia = _assign(X, Xsq, C)
    best = torch.argmin(inertia)
    return lab[best].to(torch.int32), inertia[best]


def kmeans(X, k: int, n_init: int = 10, max_iter: int = 300, seed=0,
           device=None):
    """Cluster the rows of ``X`` (a tensor, on its own device, or an
    array, moved to ``device``) into ``k`` clusters: the best inertia of
    ``n_init`` restarts, seeded from ``seed`` (an integer or a
    ``torch.Generator``).  Returns int32 labels on the device."""
    if not torch.is_tensor(X):
        dev = config.device(device)
        X = torch.as_tensor(X, device=dev).to(config.float_dtype(dev))
    lab, _ = _kmeans_all(X, int(k), int(n_init), int(max_iter),
                         gen=config.generator(seed, X.device))
    return lab
