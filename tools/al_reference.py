#!/usr/bin/env python3
"""The JAX package's float32 figures for phase 4f of ``chip_smoke.py``
(active learning), on the CPU.

    JAX_PLATFORMS=cpu python3 tools/al_reference.py [moons] [ten] [gmres]

* ``moons``: the two moons of the fit phase (n=65536, noise 0.1, k=10),
  one label a class (seed 0), ``active_learning.var_opt`` over the
  covariance of scipy's float64 ``eigsh`` (``chip_smoke.eigsh_pairs``, 20
  pairs, tau 0.11) and a Laplace learner: the 10 nodes it queries, one a
  round, and its accuracy (the labeled nodes left out) after each.
  ``var_opt`` does not read the fit, so the queries follow from the
  covariance alone: ``chip_smoke.AL_REFERENCE["moons_queries"]``.
* ``ten``: the ten-cluster input of ``bench.ten_cluster_case`` (n=70000,
  20-d, k=10, one label a class): the recall of ``knnsearch(X, 10,
  method="ivf")`` against the brute search, and a warm-started Poisson
  learner on ``model_change`` over ``spectral_covariance(model, k=20)``,
  10 rounds of 5 queries: its final accuracy.
* ``gmres``: ``utils.constrained_solve_gmres`` on the moons' Laplacian at
  5 labels a class (seed 0) and tol ``chip_smoke.GMRES_STALL_TOL``, where
  the float32 solve stalls and runs all its 1000 restarts: the
  preconditioned residual ``||(A x - b) / diag||`` of its answer, in
  float64 on the host (``chip_smoke.gmres_residual``).

JAX takes its plain path here, in float32 (x64 off) as both packages run
on an accelerator.  A run takes some minutes.
"""

import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def moons(jgl, jal):
    from chip_smoke import AL_QUERIES, AL_TAU, eigsh_pairs, two_moons

    X, y = two_moons(65536, 0.1, seed=0)
    W = jgl.weightmatrix.knn(X, 10)
    ti = jgl.trainsets.generate(y, rate=1, seed=0)
    vals, V = eigsh_pairs(W, 20)
    C0 = np.diag(1.0 / (vals + AL_TAU))
    learner = jal.active_learner(jgl.ssl.laplace(W), jal.var_opt, ti, y[ti],
                                 C=C0, V=V)
    queries, accs = [], []
    for _ in range(AL_QUERIES):
        q = learner.select_queries()
        learner.update(q, y[q])
        queries += [int(i) for i in np.atleast_1d(q)]
        pred = np.argmax(np.asarray(learner.u), axis=1)
        accs.append(round(float(jgl.ssl.ssl_accuracy(
            pred, y, learner.labeled_ind)), 4))
        print(f"moons: query {queries[-1]}, accuracy {accs[-1]:.4f} %",
              flush=True)
    print(f"moons_queries: {queries}")
    print(f"moons_accuracy: {accs}", flush=True)


def ten(jgl, jal):
    from chip_smoke import AL_TEN_BATCH, AL_TEN_ROUNDS

    rs = np.random.RandomState(0)           # bench.ten_cluster_points
    centers = rs.randn(10, 20)
    y = rs.randint(0, 10, 70000)
    X = centers[y] + rs.randn(70000, 20)
    J, _ = jgl.weightmatrix.knnsearch(X, 10, method="ivf")
    Jb, _ = jgl.weightmatrix.knnsearch(X, 10, method="brute")
    recall = np.mean([len(np.intersect1d(Jb[i], J[i])) / 10
                      for i in range(len(X))])
    print(f"ten_ivf_recall: {recall:.4f}", flush=True)
    W = jgl.weightmatrix.knn(X, 10)
    ti = jgl.trainsets.generate(y, rate=1, seed=0)
    model = jgl.ssl.poisson(W)
    t = time.perf_counter()
    C0, V = jal.spectral_covariance(model, k=20)
    print(f"ten: spectral_covariance {time.perf_counter() - t:.1f} s",
          flush=True)
    learner = jal.active_learner(model, jal.model_change, ti, y[ti],
                                 warm_start=True, C=C0, V=V)
    for r in range(AL_TEN_ROUNDS):
        q = learner.select_queries(batch_size=AL_TEN_BATCH)
        learner.update(q, y[q])
    pred = np.argmax(np.asarray(learner.u), axis=1)
    acc = jgl.ssl.ssl_accuracy(pred, y, learner.labeled_ind)
    print(f"ten_accuracy: {acc:.4f}", flush=True)


def gmres(jgl):
    import scipy.sparse as sp
    from chip_smoke import GMRES_STALL_TOL, gmres_residual, two_moons

    X, y = two_moons(65536, 0.1, seed=0)
    W = jgl.weightmatrix.knn(X, 10)
    L = jgl.graph(W).laplacian()
    ti = np.sort(jgl.trainsets.generate(y, rate=5, seed=0))
    bdy = np.zeros(len(y))
    bdy[ti] = y[ti]
    t = time.perf_counter()
    x = np.asarray(jgl.utils.constrained_solve_gmres(
        L, np.zeros(len(y)), sp.identity(len(y), format="csr"), bdy, ti,
        tol=GMRES_STALL_TOL))
    print(f"gmres: {time.perf_counter() - t:.1f} s", flush=True)
    print(f"gmres_stall_residual: {gmres_residual(L, ti, bdy, x):.4e}",
          flush=True)


def main(argv):
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    import graphlearning_tpu as jgl
    from graphlearning_tpu import active_learning as jal

    cases = argv or ["moons", "ten", "gmres"]
    if "moons" in cases:
        moons(jgl, jal)
    if "ten" in cases:
        ten(jgl, jal)
    if "gmres" in cases:
        gmres(jgl)


if __name__ == "__main__":
    main(sys.argv[1:])
