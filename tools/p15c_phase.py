#!/usr/bin/env python3
"""Phase 4i of ``chip_smoke.py`` alone, with K1 at the bench geometry, on
the card.

    python3 tools/p15c_phase.py

Builds the kernels, holds K1 (f32 and bf16) against its twin on the
packed plan of the bench geometry (uniform 2-D, n=262144, k=16) with its
``ms``, ``chain_ms`` and ``graph_ms``, then runs ``chip_smoke.p15c_phase``
on the smoke's fit input (two moons, n=65536, k=10, 5 labels a class):
the fit packs of the ten-cluster input, the bench's sharded mode and the
``all_labels`` fits on a one-rank NCCL group.  A failed check exits
non-zero.  About four minutes, most of it processes starting.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch

    import chip_smoke as sm
    import graphlearning_tpu_torch as gl
    from graphlearning_tpu_torch.ops import _build, accel
    from graphlearning_tpu_torch.ops import band_spmm as bs

    print(sm.card_line(), flush=True)
    _build.build()
    W = sm.bench_graph(1 << 18, 16, seed=0)
    acc = accel.AccelSpMM(W, device="cuda")
    for dt in (torch.float32, torch.bfloat16):
        sm.k1_entry(torch, bs, f"bench/packed/{str(dt).split('.')[-1]}",
                    acc.band_inputs(), dt)
    del acc, W
    torch.cuda.empty_cache()
    X, labels = sm.two_moons(65536, 0.1, seed=0)
    W = gl.weightmatrix.knn(X, 10)
    ti = gl.trainsets.generate(labels, rate=5, seed=0)
    sm.p15c_phase(torch, gl, bs, W, labels, ti)
    return 0


if __name__ == "__main__":
    sys.exit(main())
