#!/usr/bin/env python3
"""Accuracy of the JAX package in float32 on the two-moons fit input of
``chip_smoke.py`` (n=65536, noise 0.1, k=10, 5 labels per class, seed 0)
for the fits of its MBO phase (``chip_smoke.MBO_FITS``), on the CPU.

    JAX_PLATFORMS=cpu python3 tools/mbo_reference.py [fit names]

The class priors are those of the full labels (``utils.class_priors``).
The temperature-0.1 VolumeMBO fit prints each of the seeds
``chip_smoke.MBO_SEEDS`` and their mean: JAX's noise comes from its own
PRNG, which the port does not reproduce, so the smoke holds the port's
seeded fit to that mean.  JAX takes its plain path here (its band path
runs only on a TPU), in float32 as both packages run on an accelerator:
``chip_smoke.MBO_REFERENCE`` holds these numbers.  A run takes some
minutes.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    import graphlearning_tpu as jgl
    from chip_smoke import MBO_FITS, MBO_SEEDS, two_moons

    X, y = two_moons(65536, 0.1, seed=0)
    ti = jgl.trainsets.generate(y, rate=5, seed=0)
    W = jgl.weightmatrix.knn(X, 10)
    priors = jgl.utils.class_priors(y)
    for name in argv or MBO_FITS:
        make = MBO_FITS[name]
        seeds = MBO_SEEDS if name == "volume_mbo_t0.1" else (None,)
        accs = []
        for seed in seeds:
            kw = {} if seed is None else {"seed": seed}
            pred = make(jgl, W, priors, X, **kw).fit_predict(ti, y[ti])
            accs.append(jgl.ssl.ssl_accuracy(pred, y, ti))
            if seed is not None:
                print(f"{name} seed {seed}: jax (float32) {accs[-1]:.4f} %",
                      flush=True)
        print(f"{name}: jax (float32) {np.mean(accs):.4f} %", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
