#!/usr/bin/env python3
"""Times of the plain ELL matvec on the card: the CUDA kernel
(``graphops.plain_ell_spmm``) against the two torch forms it replaced
there, the multiply and sum over k and one batched product
(``torch.einsum``, the form the CPU keeps), each over the gather of every
padded slot; and
``graphops.spmm_t`` against the scatter-add it replaced.

    python3 tools/plain_spmm_time.py

Two graphs: the smoke's moons (n=65536, k=10, its ELL 19 slots wide) and
the trials' ten-cluster graph (n=70000, k=10 on the 20-d points of seed 4,
its ELL padded to the largest degree, 125).  Each time is ``chip_smoke``'s
``ms`` / ``chain_ms`` / ``graph_ms``, at d in {1, 2, 10, 16, 20, 30, 57,
171}, beside the product's least time (``bound_ms``: the real slots'
values and columns, the row pointers, X and Y once, over 3.35 TB/s).  A
torch form whose gather exceeds ``GRAPH_GATHER_BYTES`` has no ``graph_ms``
(20 of its gathers would be held at once).  Needs a CUDA device; about
two minutes.
"""

import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WIDTHS = (1, 2, 10, 16, 20, 30, 57, 171)
GRAPH_GATHER_BYTES = 2 << 30


def main():
    import chip_smoke as cs
    import graphlearning_tpu_torch as gl
    from graphlearning_tpu_torch.bench import ten_cluster_points
    from graphlearning_tpu_torch.ops import graphops

    print(cs.card_line(), flush=True)
    moons, _ = cs.two_moons(65536, 0.1, seed=0)
    # the benchmark's trials graph is seed 4's draw
    graphs = {"moons": moons, "trials": ten_cluster_points(70000, 4)[0]}
    for tag, pts in graphs.items():
        g = gl.graph(gl.weightmatrix.knn(pts, 10)).sparse
        nnz = g.nnz
        print(f"== {tag}: {g}, mean degree {nnz / g.n:.2f}", flush=True)

        def mul_sum(Y):
            return torch.sum(g.vals[:, :, None] * Y[g.cols], dim=1)

        def product(Y):
            return torch.einsum("nk,nkd->nd", g.vals, Y[g.cols])

        def kernel(Y):
            return graphops.plain_ell_spmm(g.cols, g.vals, g.deg, Y)

        def scatter(Y):
            c = g.vals[:, :, None] * Y[:, None, :]
            out = torch.zeros_like(Y)
            out.index_add_(0, g.cols.reshape(-1), c.reshape(g.n * g.k, -1))
            return out

        forms = {"kernel": kernel, "sum": mul_sum, "einsum": product,
                 "spmm_t": lambda Y: graphops.spmm_t(g, Y),
                 "scatter": scatter}
        for d in WIDTHS:
            Y = torch.randn((g.n, d), device="cuda")
            ref = product(Y)
            err = float((kernel(Y) - ref).abs().max() / ref.abs().max())
            gather = g.n * g.k * d * 4
            least = (8 * nnz + 4 * (g.n + 1) + 2 * g.n * d * 4) / cs.HBM_BPS
            row = {}
            for name, f in forms.items():
                graph = name in ("kernel", "spmm_t") \
                    or gather <= GRAPH_GATHER_BYTES
                row[name] = [round(t, 4) if t is not None else None for t in (
                    cs.time_ms(torch, lambda f=f: f(Y)),
                    cs.chain_ms(torch, lambda f=f: f(Y)),
                    cs.graph_ms(torch, lambda f=f: f(Y), library=True)
                    if graph else None)]
                torch.cuda.empty_cache()
            share = 100 * least * 1e3 / row["kernel"][2]
            print(f"{tag} d={d} bound_ms {least * 1e3:.4f} kernel graph "
                  f"share {share:.2f} % max|kernel - einsum| / max|einsum| "
                  f"{err:.3e} ms / chain / graph {row}", flush=True)


if __name__ == "__main__":
    main()
