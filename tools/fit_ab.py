#!/usr/bin/env python3
"""The fit phases' fits of two trees of the port, timed in turns on one
GPU, for comparing a change with its parent.

    python3 tools/fit_ab.py TREE_A TREE_B [--pairs 4] [--reps 5]
        [--set fits|p10b]

Runs ``--pairs`` rounds of A, B, B, A, one process a run, each importing
``graphlearning_tpu_torch`` and ``chip_smoke`` from its tree.  A run
builds the kernels and the fit input of ``chip_smoke.py`` (two moons,
n=65536, noise 0.1, k=10, 5 labels a class, seed 0) and times
``--reps`` + 1 rounds of fits, the first left out; it prints each fit's
median in seconds.  ``fits``: Laplace, Poisson (CG and GD), PoissonMBO
and VolumeMBO at temperature 0.1 on the band and on the plain path
(``GLT_NO_ACCEL=1``), a new model a fit.  ``p10b``: as phase 4d of the
smoke on the band, on a fresh copy of the graph each round (so each
round builds its bands and eigenpairs), Poisson and PoissonMBO on the
spectral solver, then INCRES with 2 clusters, seed 0.
Then, for each fit, every run's median of both trees, the median of those
medians, and whether every run of one tree was slower than every run of
the other.  Prints the card's name and power limit first.  Needs a CUDA
device.
"""

import argparse
import json
import os
import subprocess
import sys


def one_run(root, reps, kind):
    import time

    import numpy as np

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    import graphlearning_tpu_torch as gl
    from graphlearning_tpu_torch.ops import _build

    _build.build()
    X, y = cs.two_moons(65536, 0.1, seed=0)
    W = gl.weightmatrix.knn(X, 10)
    ti = gl.trainsets.generate(y, rate=5, seed=0)
    priors = gl.utils.class_priors(y)
    secs = {}

    def timed(name, fit):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fit()
        torch.cuda.synchronize()
        secs.setdefault(name, []).append(time.perf_counter() - t)

    if kind == "fits":
        fits = {n: (lambda n=n: cs.FITS[n](gl, W))
                for n in ("laplace", "poisson_cg", "poisson_gd")}
        fits.update({n: (lambda n=n: cs.MBO_FITS[n](gl, W, priors, X))
                     for n in ("poisson_mbo", "volume_mbo")})
        for path in ("band", "plain"):
            if path == "plain":
                os.environ["GLT_NO_ACCEL"] = "1"
            for name, make in fits.items():
                for _ in range(reps + 1):
                    m = make()
                    timed(f"{path}/{name}", lambda: m.fit_predict(ti, y[ti]))
    else:
        for _ in range(reps + 1):
            We = W.copy()
            for name in ("poisson_spectral", "poisson_mbo_spectral"):
                m = cs.P10B_FITS[name](gl, We, priors)
                timed(f"band/{name}", lambda: m.fit_predict(ti, y[ti]))
            m = gl.clustering.incres(We, 2, seed=0)
            timed("band/incres", m.fit_predict)
    out = {name: float(np.median(x[1:])) for name, x in secs.items()}
    print("RESULT " + json.dumps(out), flush=True)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs=2)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--set", default="fits", choices=("fits", "p10b"))
    ap.add_argument("--run", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.run:
        one_run(args.run, args.reps, args.set)
        return 0
    import numpy as np

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
        .strip(), flush=True)
    a, b = args.trees
    runs = {a: [], b: []}
    for _ in range(args.pairs):
        for tree in (a, b, b, a):
            p = subprocess.run(
                [sys.executable, os.path.abspath(__file__), a, b,
                 "--reps", str(args.reps), "--set", args.set,
                 "--run", tree],
                capture_output=True, text=True)
            line = [ln for ln in p.stdout.splitlines()
                    if ln.startswith("RESULT ")]
            if p.returncode or not line:
                sys.stderr.write(p.stdout[-4000:] + p.stderr[-4000:])
                raise SystemExit(f"the run of {tree} failed")
            runs[tree].append(json.loads(line[-1][7:]))
            print(f"{tree}: {line[-1][7:]}", flush=True)
    summary = {}
    for fit in runs[a][0]:
        xa = [r[fit] for r in runs[a]]
        xb = [r[fit] for r in runs[b]]
        summary[fit] = {
            "a": xa, "b": xb, "median_a": float(np.median(xa)),
            "median_b": float(np.median(xb)),
            "b_over_a": float(np.median(xb) / np.median(xa)),
            "every_b_slower": min(xb) > max(xa),
            "every_b_faster": max(xb) < min(xa)}
        print(f"{fit}: median {summary[fit]['median_a']:.4f} s ({a}) "
              f"against {summary[fit]['median_b']:.4f} s ({b}), ratio "
              f"{summary[fit]['b_over_a']:.4f}; every run of {b} slower "
              f"{summary[fit]['every_b_slower']}, faster "
              f"{summary[fit]['every_b_faster']}", flush=True)
    print("SUMMARY " + json.dumps({"a": a, "b": b, "fits": summary}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
