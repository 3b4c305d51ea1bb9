#!/usr/bin/env python3
"""Accuracy of the JAX package in float32 on the two inputs of
``chip_smoke.py``'s phase 4d (the eigenbasis SSL models, the centered
kernel method, INCRES and Fokker-Planck), on the CPU.

    JAX_PLATFORMS=cpu python3 tools/p10b_reference.py [moons] [eigsh] [ten] [fp]

* ``moons``: two moons, n=65536, noise 0.1, k=10, 5 labels a class, seed 0
  (the smoke's fit input): each fit of ``chip_smoke.P10B_FITS`` (SSL
  accuracy, the training nodes left out) and INCRES over
  ``chip_smoke.MBO_SEEDS`` and their mean (clustering accuracy).
* ``eigsh``: the same input, each eigenbasis fit of ``P10B_FITS``
  (``chip_smoke.P10B_EIGSH``) run by the JAX package in float32 on scipy's
  float64 ``eigsh`` eigenpairs in place of its own (``graph.eigen_decomp``
  replaced): on the moons JAX's float32 LOBPCG stops after two steps
  (``tools/spectral_reference.py``), so its own figures there are no
  target, and the smoke holds the port to these.
* ``ten``: the ten-cluster 20-d mixture, n=70000, k=10, one label a class
  (``graphlearning_tpu_torch.bench.ten_cluster_case``): the same fits and
  INCRES with ten clusters.
* ``fp``: Fokker-Planck clustering (seed 0) of two moons cut to
  ``chip_smoke.FP_N`` nodes (noise 0.1, k=10, seed 0): a dense n x n
  matrix exponential.

JAX takes its plain path here (its band path runs only on a TPU), in
float32 as both packages run on an accelerator.  ``chip_smoke.
P10B_REFERENCE`` holds these numbers.  The INCRES runs take most of the
time, some minutes a seed on the moons.
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


def eigsh_pairs(W, normalization, k, gamma):
    """The ``k`` smallest eigenpairs of the Laplacian of ``W`` that
    ``graph.eigen_decomp`` solves for, by scipy's float64 ``eigsh`` in
    shift-invert mode: "normalized" (unit eigenvectors), "randomwalk"
    (``D^-1/2`` times them) or "combinatorial" with the modularity term
    ``(gamma / m) d d^T`` (``m`` half the total degree; the inverse by
    Sherman-Morrison over the LU of ``L - sigma I``)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as sla

    W = sp.csr_matrix(W, dtype=np.float64)
    n = W.shape[0]
    d = np.asarray(W.sum(axis=1)).ravel()
    if normalization in ("normalized", "randomwalk") and gamma == 0:
        s = d ** -0.5
        L = (sp.identity(n) - sp.diags(s) @ W @ sp.diags(s)).tocsc()
        vals, vecs = sla.eigsh(L, k=k, sigma=-1e-3, which="LM")
        if normalization == "randomwalk":
            vecs = s[:, None] * vecs
    elif normalization == "combinatorial":
        sigma = -1e-2
        c = gamma / (d.sum() / 2)
        lu = sla.splu((sp.diags(d) - W - sigma * sp.identity(n)).tocsc())
        Bd = lu.solve(d)
        denom = 1.0 + c * d @ Bd

        def inv(b):
            Bb = lu.solve(np.asarray(b, dtype=np.float64).ravel())
            return Bb - Bd * (c * (d @ Bb) / denom)

        M = sla.LinearOperator((n, n), matvec=lambda x: (
            d * x - W @ x + c * d * (d @ x)), dtype=np.float64)
        vals, vecs = sla.eigsh(M, k=k, sigma=sigma, which="LM",
                               OPinv=sla.LinearOperator(
                                   (n, n), matvec=inv, dtype=np.float64))
    else:
        raise ValueError(f"no eigsh reference for {normalization}, "
                         f"gamma={gamma}")
    order = np.argsort(vals)
    return vals[order], vecs[:, order]


def fits(jgl, name, W, y, ti, priors):
    """Each fit of P10B_FITS on ``(W, y, ti)``: its accuracy, printed."""
    from chip_smoke import P10B_FITS

    for fit, make in P10B_FITS.items():
        t = time.perf_counter()
        pred = make(jgl, W, priors).fit_predict(ti, y[ti])
        acc = jgl.ssl.ssl_accuracy(pred, y, ti)
        print(f"{name} {fit}: jax (float32) {acc:.4f} % "
              f"({time.perf_counter() - t:.1f} s)", flush=True)


def incres(jgl, name, W, y, k):
    from chip_smoke import MBO_SEEDS

    accs = []
    for seed in MBO_SEEDS:
        t = time.perf_counter()
        pred = jgl.clustering.incres(W, k, seed=seed).fit_predict()
        accs.append(jgl.clustering.clustering_accuracy(pred, y))
        print(f"{name} incres seed {seed}: jax (float32) {accs[-1]:.4f} % "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    print(f"{name} incres: jax (float32) {np.mean(accs):.4f} % (mean), "
          f"min {np.min(accs):.4f}, max {np.max(accs):.4f}", flush=True)


def main(argv):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    import graphlearning_tpu as jgl
    from chip_smoke import FP_N, P10B_EIGSH, P10B_FITS, two_moons

    cases = argv or ["moons", "eigsh", "ten", "fp"]
    if {"moons", "eigsh"} & set(cases):
        X, y = two_moons(65536, 0.1, seed=0)
        ti = jgl.trainsets.generate(y, rate=5, seed=0)
        W = jgl.weightmatrix.knn(X, 10)
        priors = jgl.utils.class_priors(y)
    if "moons" in cases:
        fits(jgl, "moons", W, y, ti, priors)
        incres(jgl, "moons", W, y, 2)
    if "eigsh" in cases:
        memo = {}

        def eigen_decomp(self, normalization="combinatorial",
                         method="exact", k=10, c=None, gamma=0, tol=0, q=1):
            key = (id(self.weight_matrix), normalization, k, gamma)
            if key not in memo:
                t = time.perf_counter()
                memo[key] = eigsh_pairs(self.weight_matrix, normalization,
                                        k, gamma)
                print(f"  eigsh {normalization} k={k} gamma={gamma}: "
                      f"{time.perf_counter() - t:.1f} s; eigenvalues "
                      f"{memo[key][0].tolist()}", flush=True)
            return memo[key]

        jgl.graph.eigen_decomp = eigen_decomp
        for fit in P10B_EIGSH:
            t = time.perf_counter()
            pred = P10B_FITS[fit](jgl, W, priors).fit_predict(ti, y[ti])
            acc = jgl.ssl.ssl_accuracy(pred, y, ti)
            print(f"moons {fit}: jax (float32) on eigsh's float64 "
                  f"eigenpairs {acc:.4f} % ({time.perf_counter() - t:.1f} "
                  "s)", flush=True)
    if "ten" in cases:
        X10, y10 = ten_cluster_points(70000)
        ti10 = jgl.trainsets.generate(y10, rate=1, seed=0)
        W10 = jgl.weightmatrix.knn(X10, 10)
        fits(jgl, "ten", W10, y10, ti10, jgl.utils.class_priors(y10))
        incres(jgl, "ten", W10, y10, 10)
    if "fp" in cases:
        Xf, yf = two_moons(FP_N, 0.1, seed=0)
        Wf = jgl.weightmatrix.knn(Xf, 10)
        t = time.perf_counter()
        pred = jgl.clustering.fokker_planck(Wf, 2, seed=0).fit_predict()
        print(f"fp n={FP_N}: jax (float32) "
              f"{jgl.clustering.clustering_accuracy(pred, yf):.4f} % "
              f"({time.perf_counter() - t:.1f} s)", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
