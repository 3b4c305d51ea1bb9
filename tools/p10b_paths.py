#!/usr/bin/env python3
"""The port's own float32 figures for ``chip_smoke.py``'s phase 4d on the
CPU: the plain path with every tensor in float32, as on the card (the
band's and the gather's own figures come only from the card).

    python3 tools/p10b_paths.py [moons] [ten] [incres]

* ``moons``: the smoke's fit input (two moons, n=65536): each fit of
  ``chip_smoke.P10B_FITS``, its accuracy, seconds and LOBPCG steps, and
  the eigenvalues' largest error against scipy's float64 ``eigsh``
  (Multiclass MBO's 50 normalized, the smoke's d=171 widths).
* ``ten``: the same fits on the ten-cluster input (n=70000).
* ``incres``: INCRES on the moons, seed 0, on the plain path and on the
  bf16 band forced on the CPU (the kernels' twins: bf16 operands, float32
  sums), on the same draws: accuracy, each round's grow steps, and the
  two paths' agreement.

The figures predict the smoke's; the smoke holds the port to the JAX
package's (``tools/p10b_reference.py``).  Some minutes each.
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run_fits(gl, name, W, y, ti):
    from chip_smoke import P10B_FITS

    priors = gl.utils.class_priors(y)
    for fit, make in P10B_FITS.items():
        t = time.perf_counter()
        m = make(gl, W, priors, device="cpu")
        pred = m.fit_predict(ti, y[ti])
        G = m.graph if fit != "poisson_spectral" else m._nodiag_graph()[1]
        steps = {k[:3]: v.get("iters") for k, v in G.eigen_info.items()}
        print(f"{name} {fit}: port (float32, plain) "
              f"{gl.ssl.ssl_accuracy(pred, y, ti):.4f} % "
              f"({time.perf_counter() - t:.1f} s; LOBPCG steps {steps})",
              flush=True)


def main(argv):
    import torch

    import graphlearning_tpu_torch as gl
    from chip_smoke import two_moons
    from tools.p10b_reference import eigsh_pairs, ten_cluster_points

    torch.set_num_threads(int(os.environ.get("GLT_THREADS", "4")))
    gl.config.float_dtype = lambda dev: torch.float32
    cases = argv or ["moons", "ten", "incres"]
    if {"moons", "incres"} & set(cases):
        X, y = two_moons(65536, 0.1, seed=0)
        W = gl.weightmatrix.knn(X, 10, device="cpu")
        ti = gl.trainsets.generate(y, rate=5, seed=0)
    if "moons" in cases:
        run_fits(gl, "moons", W, y, ti)
        G = gl.graph(W, device="cpu")
        vals, _ = G.eigen_decomp(normalization="normalized", k=50)
        ref, _ = eigsh_pairs(W, "normalized", 50, 0)
        err = np.abs(vals.astype(np.float64) - ref)
        print(f"moons eigen_decomp(normalized, k=50): max |lambda - "
              f"lambda_eigsh| {err.max():.4e} at {int(err.argmax())}; "
              f"first ten {err[:10].max():.4e}", flush=True)
    if "ten" in cases:
        X10, y10 = ten_cluster_points(70000)
        W10 = gl.weightmatrix.knn(X10, 10, device="cpu")
        ti10 = gl.trainsets.generate(y10, rate=1, seed=0)
        run_fits(gl, "ten", W10, y10, ti10)
    if "incres" in cases:
        from graphlearning_tpu_torch.ops import accel

        preds = {}
        for path in ("plain", "bf16 band"):
            accel.enabled = lambda device, path=path: path != "plain"
            accel._MIN_N = 1
            t = time.perf_counter()
            m = gl.clustering.incres(W.copy(), 2, seed=0, device="cpu")
            preds[path] = m.fit_predict()
            s = np.asarray(m.steps)
            print(f"moons incres seed 0: port (float32, {path}) "
                  f"{gl.clustering.clustering_accuracy(preds[path], y):.4f} "
                  f"% ({time.perf_counter() - t:.1f} s); grow steps "
                  f"{s.sum()} in {len(s)} rounds, first {s[:5].tolist()}, "
                  f"last {s[-5:].tolist()}", flush=True)
        agree = gl.clustering.clustering_accuracy(preds["plain"],
                                                  preds["bf16 band"])
        print(f"moons incres: the bf16 band agrees with the plain path on "
              f"{agree / 100:.4f} up to a permutation", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
