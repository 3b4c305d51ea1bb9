"""INCRES clustering's rounds (counterpart of
``graphlearning_tpu/clustering.py:269-305`` ``_incres_loop_xla`` and of its
accel versions, ``ops/accel.py:1055-1100`` and ``ops/gather.py:469``).

Each of the ``T`` rounds plants ``m = 1 + i Dm`` seeds in each cluster,
the ``m`` members of highest score in that round's ``(k, n)`` uniform
scores (every node where a cluster is empty; ties to the lower index, as
``lax.top_k``), grows them by the random walk ``F <- W D^-1 F`` until every
cluster's diffusion has reached every true node (``min F > 0``; at most
``n`` steps), and relabels each node by its largest column.  The grow
loop stays on the device (:func:`solvers.volume._while`).  How many steps
a round takes depends on when the diffusion front's values, near
``10^-t`` after ``t`` steps, stop underflowing to zero in the working
dtype, so f64, f32 and a bf16 band take different counts.
"""

from __future__ import annotations

import torch

from graphlearning_tpu_torch.solvers.volume import _while


def uniform(generator, dtype):
    """The default scores: ``draw(shape)`` gives uniforms in ``[0, 1)``
    from ``generator``, on its device, one call a round."""
    def draw(shape):
        return torch.rand(shape, generator=generator, dtype=dtype,
                          device=generator.device)

    return draw


def grow(step, F, n_cap: int, valid=None):
    """``F <- step(F)`` (the walk ``W D^-1 F``) until ``min F > 0`` over
    the ``valid`` rows (every row when None), at most ``n_cap`` steps.
    Returns ``(F, steps)``, ``steps`` a 0-d tensor."""
    if valid is None:
        unreached = lambda F: torch.min(F) == 0
    else:
        v2 = valid[:, None]
        unreached = lambda F: torch.min(torch.where(v2, F, 1.0)) == 0
    return _while(
        lambda s: unreached(s[0]) & (s[1] < n_cap),
        lambda s: (step(s[0]), s[1] + 1),
        (F, torch.zeros((), dtype=torch.int64, device=F.device)))


def rounds(spmm, dinv, u0, draw, k: int, T: int, Dm: int, n_cap: int,
           to_perm=None, from_perm=None, valid=None, info=None):
    """INCRES's ``T`` rounds from the labels ``u0`` (n,), the diffusion in
    the space of ``spmm`` (``W @ X``) and ``dinv`` (``D^-1`` there; padding
    rows 0), reached by ``to_perm`` / ``from_perm`` (identity when None),
    ``valid`` its true rows.  ``draw((k, n))`` gives each round's scores.
    Returns the int64 labels (n,); ``info`` gets each round's grow steps
    ("steps")."""
    n = u0.shape[0]
    dev, dtype = dinv.device, dinv.dtype
    max_m = min(1 + (T - 1) * Dm, n)
    ar_k = torch.arange(k, device=dev)
    ranks = torch.arange(max_m, device=dev)[None, :]
    d2 = dinv[:, None]
    step = lambda F: spmm(d2 * F)
    u = u0.long()
    steps = []
    for i in range(int(T)):
        scores = draw((k, n))
        member = u[None, :] == ar_k[:, None]
        member = member | ~torch.any(member, dim=1, keepdim=True)
        s = torch.where(member, scores, float("-inf"))
        top_vals, top_idx = torch.sort(s, dim=1, descending=True,
                                       stable=True)
        top_vals, top_idx = top_vals[:, :max_m], top_idx[:, :max_m]
        take = ((ranks < 1 + i * Dm) & (top_vals > float("-inf"))).to(dtype)
        F = torch.zeros((n, k), dtype=dtype, device=dev)
        F.index_put_((top_idx, ar_k[:, None].expand_as(top_idx)), take,
                     accumulate=True)
        if to_perm is not None:
            F = to_perm(F)
        F, it = grow(step, F, n_cap, valid)
        steps.append(it)
        if from_perm is not None:
            F = from_perm(F)
        u = torch.argmax(F, dim=1)
    if info is not None:
        info["steps"] = [int(s) for s in steps]
    return u
