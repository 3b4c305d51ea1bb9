#!/usr/bin/env python3
"""Times of the plain ELL matvec's two forms on the card, on the smoke's
moons graph (n=65536, k=10, its ELL 19 slots wide): the multiply and sum
over k against one batched product (``torch.einsum``), and
``graphops.spmm_t`` against the scatter-add it replaced.

    python3 tools/plain_spmm_time.py

Each time is ``chip_smoke``'s ``ms`` / ``chain_ms`` / ``graph_ms``, at d in
{1, 2, 10, 16, 24, 32, 40, 57, 171}: ``graphops._SUM_DMAX`` is chosen
from them.  Needs a CUDA device; well under a minute.
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import chip_smoke as cs
    import graphlearning_tpu_torch as gl
    from graphlearning_tpu_torch.ops import graphops

    X, _ = cs.two_moons(65536, 0.1, seed=0)
    g = gl.graph(gl.weightmatrix.knn(X, 10)).sparse
    print(cs.card_line(), g, flush=True)

    def mul_sum(Y):
        return torch.sum(g.vals[:, :, None] * Y[g.cols], dim=1)

    def product(Y):
        return torch.einsum("nk,nkd->nd", g.vals, Y[g.cols])

    def scatter(Y):
        c = g.vals[:, :, None] * Y[:, None, :]
        out = torch.zeros_like(Y)
        out.index_add_(0, g.cols.reshape(-1), c.reshape(g.n * g.k, -1))
        return out

    forms = {"sum": mul_sum, "einsum": product,
             "spmm_t": lambda Y: graphops.spmm_t(g, Y), "scatter": scatter}
    for d in (1, 2, 10, 16, 24, 32, 40, 57, 171):
        Y = torch.randn((g.n, d), device="cuda")
        err = float((mul_sum(Y) - product(Y)).abs().max())
        row = {name: [round(t, 4) for t in (
            cs.time_ms(torch, lambda f=f: f(Y)),
            cs.chain_ms(torch, lambda f=f: f(Y)),
            cs.graph_ms(torch, lambda f=f: f(Y), library=True))]
            for name, f in forms.items()}
        print(f"d={d} max|sum - einsum| {err:.3e} ms / chain / graph {row}",
              flush=True)


if __name__ == "__main__":
    main()
