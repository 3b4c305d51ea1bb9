#!/usr/bin/env python3
"""The JAX package's float32 VAE figures for phase 4g of
``chip_smoke.py``, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/vae_reference.py

For each seed of ``chip_smoke.VAE_SEEDS``: ``graphlearning_tpu.
weightmatrix.vae`` at its defaults (widths (400, 20), batch 128, lr 1e-3)
for ``chip_smoke.VAE_EPOCHS`` epochs on the MNIST-shaped input
(``chip_smoke.mnist_shaped`` of the ten-cluster points, n=70000, 784
values a row), then ``knn(Z, 10)`` and Laplace and Poisson learning at one
label a class (``trainsets.generate(labels, rate=1, seed=0)``): their
accuracies.  ``chip_smoke.VAE_REFERENCE`` holds each fit's accuracies over
the seeds.  JAX runs in float32 (x64 off).  A run takes a few minutes.
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    import graphlearning_tpu as jgl
    from chip_smoke import VAE_EPOCHS, VAE_SEEDS, mnist_shaped, ten_points

    pts, y = ten_points(70000)
    X = mnist_shaped(pts)
    ti = jgl.trainsets.generate(y, rate=1, seed=0)
    accs = {"laplace": [], "poisson": []}
    for seed in VAE_SEEDS:
        t = time.perf_counter()
        Z = jgl.weightmatrix.vae(X, epochs=VAE_EPOCHS, seed=seed)
        secs = time.perf_counter() - t
        if not np.isfinite(Z).all():
            # a graph of NaN rows means nothing, and building one and
            # fitting on it took tens of GB of host memory
            print(f"seed {seed}: the latent means are not finite",
                  flush=True)
            continue
        W = jgl.weightmatrix.knn(Z, 10)
        for name in accs:
            pred = getattr(jgl.ssl, name)(W).fit_predict(ti, y[ti])
            accs[name].append(round(float(
                jgl.ssl.ssl_accuracy(pred, y, ti)), 4))
        print(f"seed {seed}: {VAE_EPOCHS} epochs in {secs:.1f} s; laplace "
              f"{accs['laplace'][-1]}, poisson {accs['poisson'][-1]}",
              flush=True)
    print(f"vae_reference: {accs}", flush=True)


if __name__ == "__main__":
    main()
