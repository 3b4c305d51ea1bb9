"""PageRank by power iteration (counterpart of
``graphlearning_tpu/solvers/pagerank.py``).

``u <- alpha W^T D^-1 u + (1 - alpha) v`` from the uniform vector until
``max|u_new - u| <= tol``, the tolerance clamped to ``100 eps`` of the
dtype as the JAX package clamps it (float32 cannot reach 1e-10).  The loop
stays on the device (:func:`solvers.volume._while`); ``W^T`` is
:func:`ops.graphops.spmm_t`, whose sums are the same in every run.
"""

from __future__ import annotations

import torch

from graphlearning_tpu_torch.core.sparse import SparseGraph
from graphlearning_tpu_torch.ops.graphops import degree_vector, spmm_t
from graphlearning_tpu_torch.solvers.volume import _while


def page_rank(g: SparseGraph, alpha=0.85, v=None, tol=1e-10,
              max_iter: int = 10**5, info=None):
    """The PageRank vector of ``g`` (a tensor on its device) for the
    teleport vector ``v`` (uniform by default).  ``info`` gets the steps
    taken ("iters")."""
    dtype, dev = g.vals.dtype, g.device
    n = g.n
    if v is None:
        v = torch.full((n,), 1.0 / n, dtype=dtype, device=dev)
    else:
        v = torch.as_tensor(v, device=dev).to(dtype)
    tol = max(float(tol), 100.0 * torch.finfo(dtype).eps)
    alpha = torch.tensor(alpha, dtype=dtype, device=dev)
    deg = degree_vector(g)

    def body(state):
        u, _, i = state
        w = alpha * spmm_t(g, u / deg) + (1.0 - alpha) * v
        return w, torch.max(torch.abs(w - u)), i + 1

    u, _, it = _while(
        lambda s: (s[1] > tol) & (s[2] < max_iter), body,
        (torch.full((n,), 1.0 / n, dtype=dtype, device=dev),
         torch.tensor(float("inf"), dtype=dtype, device=dev),
         torch.zeros((), dtype=torch.int64, device=dev)))
    if info is not None:
        info["iters"] = int(it)
    return u
