#!/usr/bin/env python3
"""Accuracy of the JAX package, and of the torch port, on the two-moons fit
input of ``chip_smoke.py`` (n=65536, noise 0.1, k=10, 5 labels per class,
seed 0), on the CPU.

    JAX_PLATFORMS=cpu python3 tools/moons_reference.py            # float64
    JAX_PLATFORMS=cpu python3 tools/moons_reference.py --float32  # JAX only
    JAX_PLATFORMS=cpu python3 tools/moons_reference.py --float32 amle

The fits are ``chip_smoke.FITS``: laplace, poisson (CG and gradient
descent), graph nearest neighbor, p-Laplace, AMLE and p-eikonal, with the
smoke's settings; names given on the command line select some.  In
float64 it runs both packages and prints their accuracies, the port's
iteration count (rounds or sweeps) and how often their predictions
agree.  With ``--float32`` it runs the JAX package alone with x64 off,
the working dtype of both packages on an accelerator: these are the
reference accuracies that ``chip_smoke.py`` holds the port's GPU fits to.
JAX takes its plain path here, since its band path runs only on a TPU.
A run takes several minutes.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv):
    import jax

    x64 = "--float32" not in argv
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)
    import graphlearning_tpu as jgl
    from chip_smoke import FITS, two_moons

    X, y = two_moons(65536, 0.1, seed=0)
    ti = jgl.trainsets.generate(y, rate=5, seed=0)
    W = jgl.weightmatrix.knn(X, 10)
    names = [a for a in argv if not a.startswith("--")]
    fits = {name: FITS[name] for name in (names or FITS)}
    if not x64:
        for name, make in fits.items():
            pj = make(jgl, W).fit_predict(ti, y[ti])
            print(f"{name}: jax (float32) "
                  f"{jgl.ssl.ssl_accuracy(pj, y, ti):.4f} %", flush=True)
        return
    import torch

    import graphlearning_tpu_torch as tgl

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    Wt = tgl.weightmatrix.knn(X, 10, device="cpu")
    for name, make in fits.items():
        pj = make(jgl, W).fit_predict(ti, y[ti])
        model = make(tgl, Wt, device="cpu")
        pt = model.fit_predict(ti, y[ti])
        print(f"{name}: jax {jgl.ssl.ssl_accuracy(pj, y, ti):.4f} %, "
              f"torch {tgl.ssl.ssl_accuracy(pt, y, ti):.4f} % "
              f"({model.iters} iterations), "
              f"agreement {np.mean(pj == pt):.6f}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
