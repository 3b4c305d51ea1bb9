"""The centered kernel method's solve (counterpart of the loop of
``graphlearning_tpu/ssl.py:1527-1611`` ``centered_kernel`` and of its
accel versions, ``ops/accel.py:1011-1052`` and ``ops/gather.py:513``).

The operator is ``A X = C W C X``, ``C`` the centering of the columns over
the graph's true rows.  A power iteration from a normal start estimates
its largest eigenvalue ``l``; then, with ``alpha = alpha_factor l``, the
fixed point ``u <- u + (A u / alpha - u)`` off the labeled rows runs from
``u = K`` until its step's largest entry is at most ``tol``.  The fixed
point stays on the device (:func:`solvers.volume._while`).
"""

from __future__ import annotations

import torch

from graphlearning_tpu_torch import config
from graphlearning_tpu_torch.solvers.volume import _while


def start(n: int, seed, dtype, device):
    """The power iteration's start ``(n, 1)``: a normal draw from ``seed``
    (an integer or a ``torch.Generator``), in the graph's node order."""
    return torch.randn((n, 1), generator=config.generator(seed, device),
                       dtype=dtype, device=device)


def solve(spmm, K, mask, alpha_factor, tol, e0, power_it: int, n_true: int,
          valid=None, max_iter: int = 10**5, info=None):
    """The centered kernel solution ``u`` (n, k) for ``spmm`` (``W @ X``),
    the centered one-hot labels ``K`` (n, k) on the labeled rows
    ``mask`` (n,), and the start ``e0`` (n, 1).  ``valid`` (n,) marks the
    true rows of a padded space (their column means are over ``n_true``
    rows, padding rows stay 0); None means every row.  ``info`` gets the
    fixed point's steps ("iters")."""
    if valid is None:
        def center(X):
            return X - torch.mean(X, dim=0, keepdim=True)
    else:
        v2 = valid[:, None]

        def center(X):
            s = torch.sum(torch.where(v2, X, 0.0), dim=0, keepdim=True)
            return torch.where(v2, X - s / n_true, 0.0)

    def A(X):
        return center(spmm(center(X)))

    e = e0 if valid is None else torch.where(valid[:, None], e0, 0.0)
    for _ in range(int(power_it)):
        w = A(e)
        e = w / torch.linalg.vector_norm(w)
    lam = torch.abs(torch.sum(e * A(e)) / torch.sum(e * e))
    alpha = alpha_factor * lam
    m2 = mask[:, None]

    def body(state):
        u, _, it = state
        w = torch.where(m2, 0.0, A(u) / alpha - u)
        return u + w, torch.max(torch.abs(w)), it + 1

    u, _, it = _while(
        lambda s: (s[1] > tol) & (s[2] < max_iter), body,
        (K, torch.tensor(float("inf"), dtype=K.dtype, device=K.device),
         torch.zeros((), dtype=torch.int64, device=K.device)))
    if info is not None:
        info["iters"] = int(it)
    return u
