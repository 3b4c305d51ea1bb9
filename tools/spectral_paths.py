#!/usr/bin/env python3
"""The port's float32 eigensolve on the CPU, on the two-moons fit input of
``chip_smoke.py`` (n=65536, noise 0.1, k=10, seed 0): the numbers behind
the eig phase's limits (``chip_smoke.EIG_TOL``, ``EIG_AGREEMENT``).

    python3 tools/spectral_paths.py

* ``eigen_decomp(normalization="normalized", k=10)`` on the plain path in
  float32 against scipy's float64 ``eigsh`` (``chip_smoke.eigsh_reference``),
  under the port's per-pair tolerance and under the JAX package's, which
  grows with n (``lobpcg_standard``'s own rule), with the steps taken;
* ``spectral(W, 2)`` on the plain path and on the band (its kernels'
  plain twins, the band path forced on the CPU), their accuracies and
  their agreement up to a permutation of the labels;
* the accuracy of spectral clustering on ``eigsh``'s own float64
  eigenvectors, clustered by the port's k-means as ``spectral`` does.

It runs on the CPU threads it is given and takes about ten minutes.
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    import scipy.sparse as sp
    import scipy.sparse.linalg as sla
    import torch

    import graphlearning_tpu_torch as gl
    from chip_smoke import eigsh_reference, two_moons
    from graphlearning_tpu_torch.core.sparse import SparseGraph
    from graphlearning_tpu_torch.ops import accel
    from graphlearning_tpu_torch.solvers import eig
    from graphlearning_tpu_torch.solvers.kmeans import kmeans

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    X, y = two_moons(65536, 0.1, seed=0)
    W = gl.weightmatrix.knn(X, 10, device="cpu")
    ref = eigsh_reference(W, 10)

    def graph():
        G = gl.graph(SparseGraph.from_scipy(W, dtype=torch.float32,
                                            device="cpu"))
        G._scipy = W.copy()
        return G

    key = ("normalized", "exact", 10, None, 0, 0, 1)
    per_pair = eig.per_pair_tol
    for rule in ("JAX's", "per-pair"):
        eig.per_pair_tol = (lambda tol, X: tol if tol else None) \
            if rule == "JAX's" else per_pair
        t = time.perf_counter()
        G = graph()
        vals, _ = G.eigen_decomp(normalization="normalized", k=10)
        print(f"plain float32 eigen_decomp(k=10), {rule} tolerance: "
              f"{G.eigen_info[key]['iters']} steps, max |lambda - "
              f"lambda_eigsh| {np.max(np.abs(vals.astype(float) - ref)):.4e}"
              f" ({time.perf_counter() - t:.1f} s)", flush=True)

    preds = {}
    for path in ("plain", "band"):
        accel.enabled = (lambda device: True) if path == "band" else (
            lambda device: False)
        accel._MIN_N = 1
        G = graph()
        preds[path] = gl.clustering.spectral(G, 2).fit_predict()
        key = ("normalized", "exact", 2, None, 0, 0, 1)
        print(f"{path} float32 spectral(W, 2): accuracy "
              f"{gl.clustering.clustering_accuracy(preds[path], y):.4f} %, "
              f"{G.eigen_info[key]}", flush=True)
    agree = gl.clustering.clustering_accuracy(preds["band"],
                                              preds["plain"]) / 100.0
    print(f"band against plain: agreement {agree:.4f}", flush=True)

    deg = np.asarray(W.sum(axis=1)).ravel()
    s = sp.diags(deg ** -0.5)
    L = (sp.identity(W.shape[0]) - s @ W @ s).tocsc()
    ev, vecs = sla.eigsh(L, k=4, sigma=-1e-3, which="LM")
    V = vecs[:, np.argsort(ev)][:, :2]
    V = V / np.linalg.norm(V, axis=1, keepdims=True)
    pred = kmeans(torch.as_tensor(V), 2, n_init=10, seed=0).numpy()
    print(f"eigsh's float64 eigenvectors, NgJordanWeiss: accuracy "
          f"{gl.clustering.clustering_accuracy(pred, y):.4f} %", flush=True)


if __name__ == "__main__":
    main()
