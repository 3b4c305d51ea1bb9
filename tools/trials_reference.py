#!/usr/bin/env python3
"""Accuracy of the JAX package in float32 on the inputs of
``chip_smoke.py``'s phase 4e (the experiment harness and label
propagation), on the CPU.

    JAX_PLATFORMS=cpu python3 tools/trials_reference.py \
        [trials] [slp] [dlp] [priors] [--float64]

* ``trials``: the ten-cluster 20-d mixture, n=70000, k=10
  (``graphlearning_tpu_torch.bench.ten_cluster_points``), with the trials
  of ``chip_smoke.trial_sets`` (5 a rate at the rates of
  ``chip_smoke.TRIAL_RATES``): ``ssl_trials`` of Laplace and Poisson
  learning (JAX's vmapped batched fits), each rate's mean accuracy.
* ``slp``: sparse label propagation on the same graph, one label a class
  (``bench.ten_cluster_case``'s train set).
* ``dlp``: dynamic label propagation on two moons cut to
  ``chip_smoke.FP_N`` nodes (noise 0.1, k=10, seed 0, 5 labels a class).
* ``priors``: ``ssl_trials`` of Laplace learning with class priors on the
  smoke's fit input (two moons, n=65536, noise 0.1, k=10) over the
  trials of ``chip_smoke.PRIOR_TRIALS``: each trial's accuracy without
  and with the priors.

JAX takes its plain path here, in float32 as both packages run on an
accelerator (``--float64`` for the same figures in float64, to see how
far rounding moves them).  ``chip_smoke.TRIALS_REFERENCE`` holds these
numbers.  About three minutes for ``trials``, one for ``priors``.
"""

import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv):
    import jax

    x64 = "--float64" in argv
    argv = [a for a in argv if a != "--float64"]
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", x64)
    import graphlearning_tpu as jgl
    from chip_smoke import FP_N, PRIOR_TRIALS, trial_sets, two_moons
    from graphlearning_tpu_torch.bench import ten_cluster_points

    dtype = "float64" if x64 else "float32"
    cases = argv or ["trials", "slp", "dlp", "priors"]
    if {"trials", "slp"} & set(cases):
        X, y = ten_cluster_points(70000)
        t = time.perf_counter()
        W = jgl.weightmatrix.knn(X, 10)
        print(f"ten clusters: knn {time.perf_counter() - t:.1f} s, nnz "
              f"{W.nnz}", flush=True)
    if "trials" in cases:
        trials = trial_sets(jgl, y)
        with tempfile.TemporaryDirectory() as tmp:
            jgl.ssl.results_dir = tmp
            for name in ("laplace", "poisson"):
                t = time.perf_counter()
                rows = getattr(jgl.ssl, name)(W).ssl_trials(trials, y)
                secs = time.perf_counter() - t
                for m in np.unique(rows[:, 0]):
                    accs = rows[rows[:, 0] == m, 1]
                    print(f"ten {name} {int(m)} labels: jax ({dtype}) mean "
                          f"{accs.mean():.4f} %, trials {accs.tolist()}",
                          flush=True)
                print(f"ten {name}: {secs:.1f} s", flush=True)
    if "slp" in cases:
        ti = jgl.trainsets.generate(y, rate=1, seed=0)
        t = time.perf_counter()
        pred = jgl.ssl.sparse_label_propagation(W).fit_predict(ti, y[ti])
        print(f"ten sparse_label_propagation: jax ({dtype}) "
              f"{jgl.ssl.ssl_accuracy(pred, y, ti):.4f} % "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    if "dlp" in cases:
        Xf, yf = two_moons(FP_N, 0.1, seed=0)
        Wf = jgl.weightmatrix.knn(Xf, 10)
        tif = jgl.trainsets.generate(yf, rate=5, seed=0)
        t = time.perf_counter()
        pred = jgl.ssl.dynamic_label_propagation(Wf).fit_predict(tif,
                                                                 yf[tif])
        print(f"fp n={FP_N} dynamic_label_propagation: jax ({dtype}) "
              f"{jgl.ssl.ssl_accuracy(pred, yf, tif):.4f} % "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    if "priors" in cases:
        Xm, ym = two_moons(65536, 0.1, seed=0)
        Wm = jgl.weightmatrix.knn(Xm, 10)
        trials = jgl.trainsets.generate(ym, **PRIOR_TRIALS)
        with tempfile.TemporaryDirectory() as tmp:
            jgl.ssl.results_dir = tmp
            t = time.perf_counter()
            rows = jgl.ssl.laplace(
                Wm, class_priors=jgl.utils.class_priors(ym)).ssl_trials(
                    trials, ym)
        for row in rows:
            print(f"moons laplace with class priors, {int(row[0])} labels: "
                  f"jax ({dtype}) {row[1]:.4f} % without, {row[2]:.4f} % "
                  "with the priors", flush=True)
        print(f"moons priors: {time.perf_counter() - t:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
