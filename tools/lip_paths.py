#!/usr/bin/env python3
"""The one-vs-rest Lipschitz fits (p-Laplace, unweighted AMLE) of
graphlearning_tpu_torch on the band path, in an f32 and a bf16 band, and
on the plain path, at several tolerances, on ``chip_smoke.py``'s fit input
(two moons, n=65536, k=10, 5 labels per class, seed 0), on one GPU.

    python3 tools/lip_paths.py

For each run it prints the path, the band's dtype, the tolerance, the
sweeps (band) or Jacobi rounds (plain), the seconds of the solve, the
accuracy and the agreement with the plain path at the same tolerance.
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import torch

    if not torch.cuda.is_available():
        print("lip_paths: no CUDA device", file=sys.stderr)
        return 1
    import graphlearning_tpu_torch as gl
    from graphlearning_tpu_torch.ops import accel
    from graphlearning_tpu_torch.solvers import plaplace as pl
    from chip_smoke import LIP_MAX_NUM_IT, two_moons

    X, y = two_moons(65536, 0.1, seed=0)
    W = gl.weightmatrix.knn(X, 10)
    ti = gl.trainsets.generate(y, rate=5, seed=0)
    G = gl.graph(W)
    g, bucketed = G.sparse, G.bucketed()
    classes = np.unique(y[ti])
    bdy = (y[ti][:, None] == classes[None, :]).astype(float)
    accs = {mode: accel.maybe_build(W, device="cuda", mode=mode)
            for mode in ("f32", "bf16")}
    for mode, a in accs.items():
        print(f"band {mode}: n_pad {a.n_pad}, R {a.R}, Wr "
              f"{a._rect_plan[3]}, rect band {a.rect_band_bytes():.3g} B",
              flush=True)

    def run(name, tol, acc):
        info = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        if name == "plaplace":
            u = pl.plaplace_mc(g, ti, bdy, 10, max_num_it=LIP_MAX_NUM_IT,
                               tol=tol, accel=acc, bucketed=bucketed,
                               info=info)
        else:
            u = pl.amle_mc(g, ti, bdy, tol=tol, max_num_it=LIP_MAX_NUM_IT,
                           weighted=False, accel=acc, bucketed=bucketed,
                           info=info)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        pred = classes[np.argmax(u, axis=1)]
        return pred, info, secs

    for name, tols, modes in (("amle", (1e-3, 1e-4, 1.2e-5), ("f32",)),
                              ("plaplace", (1e-5,), ("f32", "bf16"))):
        for tol in tols:
            ref, info, secs = run(name, tol, None)
            print(f"{name} tol {tol:g} plain: {info['iters']} rounds, "
                  f"{secs:.3f} s, accuracy "
                  f"{gl.ssl.ssl_accuracy(ref, y, ti):.4f} %", flush=True)
            for mode in modes:
                pred, info, secs = run(name, tol, accs[mode])
                print(f"{name} tol {tol:g} band {mode}: {info['iters']} "
                      f"sweeps ({info.get('sweep_seconds', 0):.3f} s of "
                      f"sweeps), {secs:.3f} s, accuracy "
                      f"{gl.ssl.ssl_accuracy(pred, y, ti):.4f} %, agreement "
                      f"{np.mean(pred == ref):.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
