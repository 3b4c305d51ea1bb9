#!/usr/bin/env python3
"""Spectral accuracy and eigenvalue error of the JAX package in float32 on
the two inputs of ``chip_smoke.py``'s eig phase, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/spectral_reference.py [moons] [ten]

* ``moons``: two moons, n=65536, noise 0.1, k=10, seed 0 (the smoke's fit
  input): ``graph(W).eigen_decomp(normalization="normalized", k=10)``
  against scipy's float64 ``eigsh`` of the same W
  (``chip_smoke.eigsh_reference``), the Fiedler value's error, and
  ``clustering.spectral(W, 2)`` (NgJordanWeiss).
* ``ten``: the ten-cluster 20-d mixture, n=70000, k=10, seed 0 (the points
  of ``graphlearning_tpu_torch.bench.ten_cluster_case``):
  ``clustering.spectral(W, 10)`` and its eigenvalues (normalized, k=10)
  against ``eigsh``.

JAX takes its plain path here (its band path runs only on a TPU), in
float32, as both packages run on an accelerator; each eigenvalue error is
``max |lambda - lambda_eigsh|`` over the k values.  ``chip_smoke.
EIG_REFERENCE`` holds these numbers and the smoke's eigenvalue tolerance
derives from them.  A run takes some minutes.
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def ten_cluster_points(n):
    """The points and labels of ``bench.ten_cluster_case``."""
    rs = np.random.RandomState(0)
    centers = rs.randn(10, 20)
    labels = rs.randint(0, 10, n)
    return centers[labels] + rs.randn(n, 20), labels


def run(jgl, name, X, y, W, num_clusters, shift_invert):
    from chip_smoke import eigsh_reference

    t = time.perf_counter()
    ref = eigsh_reference(W, 10, shift_invert=shift_invert)
    t_ref = time.perf_counter() - t
    G = jgl.graph(W)
    t = time.perf_counter()
    vals, _ = G.eigen_decomp(normalization="normalized", k=10)
    t_eig = time.perf_counter() - t
    err = np.abs(np.asarray(vals, dtype=np.float64) - ref)
    print(f"{name}: eigsh (float64, {t_ref:.1f} s) {ref.tolist()}",
          flush=True)
    print(f"{name}: jax (float32) eigen_decomp(normalized, k=10) "
          f"{np.asarray(vals).tolist()} in {t_eig:.1f} s; max |err| "
          f"{err.max():.4e} (per value {err.tolist()})", flush=True)
    if num_clusters == 2:
        lam2, _ = jgl.graph(W).fiedler_vector(return_value=True)[::-1]
        print(f"{name}: jax (float32) fiedler value {float(lam2):.6e}, "
              f"|err| {abs(float(lam2) - ref[1]):.4e}", flush=True)
    t = time.perf_counter()
    pred = jgl.clustering.spectral(G, num_clusters).fit_predict()
    acc = jgl.clustering.clustering_accuracy(pred, y)
    print(f"{name}: jax (float32) spectral(W, {num_clusters}) accuracy "
          f"{acc:.4f} % ({time.perf_counter() - t:.1f} s)", flush=True)


def main(argv):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    import graphlearning_tpu as jgl
    from chip_smoke import two_moons

    names = argv or ["moons", "ten"]
    if "moons" in names:
        X, y = two_moons(65536, 0.1, seed=0)
        W = jgl.weightmatrix.knn(X, 10)
        run(jgl, "moons", X, y, W, 2, shift_invert=True)
    if "ten" in names:
        X, y = ten_cluster_points(70000)
        W = jgl.weightmatrix.knn(X, 10)
        run(jgl, "ten clusters", X, y, W, 10, shift_invert=False)


if __name__ == "__main__":
    main(sys.argv[1:])
