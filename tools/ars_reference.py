#!/usr/bin/env python3
"""The JAX package's float32 ARS figure for phase 4g of ``chip_smoke.py``,
on the CPU.

    JAX_PLATFORMS=cpu python3 tools/ars_reference.py

``graphlearning_tpu.ars.ars`` at its defaults (dim 2, perplexity 30,
chunk 1024) for ``chip_smoke.ARS_ITERS`` iterations on the first
``chip_smoke.ARS_SUBSET`` of the ten-cluster points
(``chip_smoke.ten_points``, 20-d): the 10-NN label accuracy in the
embedding (``chip_smoke.knn_label_accuracy``), which
``chip_smoke.ARS_REFERENCE["knn_accuracy"]`` holds, and the embedding's
largest column mean.  JAX runs in float32 (x64 off), as both packages
run ARS.  A run takes a few minutes.
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
    from graphlearning_tpu import ars
    from chip_smoke import (ARS_ITERS, ARS_SUBSET, knn_label_accuracy,
                            ten_points)

    pts, y = ten_points(70000)
    X, y = pts[:ARS_SUBSET], y[:ARS_SUBSET]
    t = time.perf_counter()
    Y = ars.ars(X, iters=ARS_ITERS)
    print(f"ars: n={ARS_SUBSET}, {ARS_ITERS} iterations, "
          f"{time.perf_counter() - t:.1f} s on the CPU", flush=True)
    print(f"max |mean|: {np.abs(Y.mean(0)).max():.3e}")
    print(f"knn_accuracy: {knn_label_accuracy(Y, y):.4f}", flush=True)


if __name__ == "__main__":
    main()
