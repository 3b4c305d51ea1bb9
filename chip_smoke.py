#!/usr/bin/env python3
"""Drive graphlearning_tpu_torch's main path on one NVIDIA GPU and hold its
CUDA kernels against their plain torch twins.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. build: compile the kernels of ``graphlearning_tpu_torch/csrc`` with nvcc,
   one process per source, all at once;
2. kernels at the bench geometry (uniform 2-D points, n=262144, k=16,
   Hilbert order): K1, K2 and K3 against their twins, f32 and bf16, at
   d in {10, 128}, timed with CUDA events beside ``torch.sparse.mm``; K7
   (min-plus, Hopf-Lax, reciprocal, with and without the argmin) and K9
   (C in {2, 10}, f32 and bf16) on the unpacked tiles' live chunks, and
   K4 where the rectangular band fits the budget;
2b. the plain ELL product (``graphops.plain_ell_spmm``, no TPU
   counterpart) on the moons graph of phase 3 at d=2 and on the
   ten-cluster graph (n=70000, 20-d, k=10; its ELL padded to the largest
   degree) at d=30 and d=10, against its twin (the gather of every slot
   and one batched product), with the multiply-and-sum torch form as its
   library call; its launches are counted on the main path, in phase 3's
   plain fits and phase 4e's Poisson trials, each at least one a CG step;
3. fits on two moons (n=65536, noise 0.1, k=10, 5 labels per class):
   Laplace, Poisson (CG) and Poisson (gradient descent) through the public
   entry points on the packed band path (K1 + K2), Laplace again on the
   unpacked fallback path (K1 + K3), and all of them on the plain ELL path
   for comparison (accuracy, agreement, and the band fits' iteration
   counts within 1 % of the plain path's); then the kernels against their
   twins at the fits' own shapes, the masked Laplace solve on K2 and K3
   within SOLVE_MARGIN of the plain path's error against scipy's f64
   solve, and the time of one whole matvec (band kernel plus residual)
   beside the plain ELL gather;
4. the distance and Lipschitz path on the same graph: ``graph.dijkstra``
   (plain, reciprocal) and ``dijkstra_hl`` on the band (K1 + K7),
   ``ssl.plaplace`` and ``ssl.amle`` on the band (K2 warm start, K4 band,
   block-Gauss-Seidel sweeps), ``AccelSpMM.lip_iterate_mc`` (K9), each
   held to the plain ELL path; graph nearest neighbor and p-eikonal on the
   plain path (no kernel); then K4, K7 (the plain, reciprocal and
   Hopf-Lax rounds the path launches) and K9 (C in {2, 10}) against their
   twins at these shapes, with the time of the tiles band's live-chunk
   list;
4b. the MBO and reweighted Laplace fits on the same graph:
   ``ssl.poisson_mbo`` (T=20, Ns=40), ``ssl.volume_mbo`` at temperature 0
   and at 0.1 (seed 0, twice) and ``ssl.laplace`` with the "wnll",
   "poisson" and "properly" reweightings, on the band (the MBO fits on
   the bf16 band: K1, K2 bf16 at d=2, K7 for VolumeMBO's Voronoi start;
   the reweighted fits on K2 f32) and on the plain path (accuracy within
   a point of the JAX package's float32 accuracy, two at temperature 0.1;
   agreement; VolumeMBO's class counts within their bounds), and
   ``volume.gumbel`` on a CUDA generator (same seed same draws, Gumbel's
   mean and variance); then
   PoissonMBO and VolumeMBO on the ten-cluster Poisson input (n=70000),
   which must take the gather (its ``bellman_ford`` for the Voronoi
   start), held to the same fits under ``GLT_NO_GATHER``; then K2 bf16 at
   the MBO fits' shape against its twin, with the launches K2 made on the
   bf16 band (the f32 CG solves inside the fits not counted);
4c. the eigensolver and spectral clustering: on a fresh copy of the moons
   graph ``graph.eigen_decomp(normalization="normalized", k=10)``,
   ``fiedler_vector`` and ``clustering.spectral(W, 2)`` on the band (K1,
   then K2 in every application of LOBPCG's operator, at d = 3(k+b) and
   k+b; its launches held to the solves' steps) and under
   ``GLT_NO_ACCEL``, the eigenvalues held to scipy's float64 ``eigsh``
   (``EIG_TOL``) and to each other (``EIG_BAND_TOL``), the clusterings
   to the accuracy of ``eigsh``'s float64 eigenvectors and to each other;
   then ``clustering.spectral(W, 10)`` on the ten-cluster input through
   the gather and under ``GLT_NO_GATHER``, held to JAX's float32 accuracy
   and to each other; then K2 at LOBPCG's widths (d = 12 and 39) against
   its twin, with the launches K2 made at each width in the band's
   solves;
4d. the eigenbasis SSL models, the centered kernel method, INCRES,
   PageRank and Fokker-Planck: the plain Poisson GD fit twice and
   personalized PageRank twice, each bit-equal (PageRank also against
   scipy's float64 iteration of as many steps); on a fresh copy of the
   moons graph ``ssl.poisson(solver="spectral")``,
   ``ssl.poisson_mbo(solver="spectral")``, ``ssl.multiclass_mbo``,
   ``ssl.centered_kernel`` and ``clustering.incres`` on the band (K1 for
   an f32 and a bf16 band; K2 f32 in the eigensolves at d = 14 / 42 and
   57 / 171 and in the centered kernel's operator at d = 1 and 2, K2 bf16
   in the heat steps and INCRES's walk at d = 2; every count held to the
   fits' own steps) and under ``GLT_NO_ACCEL`` with
   ``ssl.modularity_mbo`` (the plain path by design), each held to its
   target (on the moons the JAX package's accuracy on scipy's float64
   eigsh eigenpairs for the eigenbasis models) and to the plain path;
   Multiclass MBO's 50 eigenvalues against eigsh; the same on the
   ten-cluster input through the gather and under ``GLT_NO_GATHER``,
   held to JAX's float32 accuracy; Fokker-Planck on two moons cut to
   ``FP_N`` nodes (its float32 matrix exponential against the float64
   one); then K2 at the new widths against its twin;
4e. the experiment harness and label propagation, in a temporary
   directory: the ten-cluster input (n=70000) through ``datasets.save`` /
   ``load``, ``weightmatrix.knnsearch(..., dataset=)`` and ``knn(name,
   10)`` (equal to ``knn(points, 10)``), ``trainsets.generate(...,
   dataset=, trainset_name=)`` and ``load`` (TRIAL_NUM trials at each of
   TRIAL_RATES labels a class); ``ssl_trials`` of Laplace and Poisson
   learning over them (batched by size on the plain ELL),
   ``trials_statistics`` and ``accuracy_table``, each rate's mean held to
   the JAX package's float32 accuracy and one batched trial a rate to its
   sequential fit on the plain path; sparse label propagation twice,
   bit-equal; on a fresh copy of the moons graph ``gl.warmup`` (K1) and a
   fit after it that launches no K1 and its CG steps' K2, ``ssl_trials``
   with class priors (sequential on the band, K2 held to the fits' CG
   steps) and ``poisson.fit_device`` (a CUDA tensor); dynamic label
   propagation on the ``FP_N`` cut;
4f. active learning, the IVF search, the ``utils`` solvers and
   checkpoints: on a fresh copy of the moons graph
   ``active_learning.spectral_covariance(laplace(W), k=20)`` on the band
   (K1 once, K2 by width held to LOBPCG's steps, eigenvalues to scipy's
   float64 eigsh), then a cold and a warm ``var_opt`` learner over
   eigsh's covariance from one label a class (JAX's queries, K2 = CG
   steps + 2 a refit, fewer warm steps, each accuracy within a point of
   JAX's); on the ten-cluster input ``knnsearch(method="ivf")`` twice
   (bit-equal, JAX's recall) and on JAX's recall input, and a warm
   and a cold Poisson learner on ``model_change`` over
   ``spectral_covariance`` on the gather (the same queries, JAX's
   accuracy); ``utils.constrained_solve`` against scipy's f64 solve,
   ``utils.constrained_solve_gmres`` to its tolerance and, where it
   stalls, to JAX's residual; PoissonMBO and
   VolumeMBO killed after a checkpoint and resumed bit-equal;
4g. the embedding trainers, the host oracles and observability:
   ``graph.ars`` on the ten-cluster points at n=70000 (cut to
   ARS_FULL_ITERS iterations) and on ARS_SUBSET of them for ARS_ITERS,
   the plan's seconds and an iteration's ms, the 10-NN label accuracy
   held to the JAX package's float32 figure, then ARS_REPLAY_ITERS
   iterations on the card against the CPU; ``weightmatrix.vae`` on an
   MNIST-shaped input (n=70000, 784 values a row) for VAE_EPOCHS
   epochs, its loss falling, Laplace and Poisson on its latent means'
   kNN graph held to the JAX package's float32 accuracies, and
   VAE_REPLAY_STEPS steps on the card against the CPU;
   ``native.dijkstra_host`` against the band (K7) and plain distances on
   the moons graph, ``hostpath.laplace_host`` against a Laplace fit; a
   band Laplace fit inside ``observability.trace`` (K2 launched, the
   trace written) and timed by ``Timer`` and by CUDA events;
4h. the distribution layer (P15a, P15b) on a one-rank NCCL group: the
   moons graph's Laplace, Poisson CG and GD, random-walk and PoissonMBO
   fits through ``distribute(GLTConfig(sharded_kernel="banded"))``, each
   twice (the first builds the operator: RCM, the partition, K1), with
   its route, iterations and K3 launches (one a product), held to the JAX
   package's float32 accuracy less a point, to the plain fit (0.99; GD's
   steps within 1 %) and to its K3 count; Laplace on the "gspmd" (ELL)
   route; then graph NN, p-Laplace, AMLE, p-eikonal, VolumeMBO (at
   temperature 0, and 0.1 with seed 0's noise), the eigenbasis models, the centered kernel, sparse LP,
   ``clustering.spectral``, ``clustering.incres``, the sharded Dijkstra
   and ``spectral_covariance`` the same way, each beside its plain
   one-device fit and held to its K3, K7 and K9 launches
   (``p15b_launches``); then the graph's P=4 partition in one process:
   K1, K3 (d=2), K7 (argmin, reciprocal, Hopf-Lax) and K9 (C in {2, 10})
   over each block's halo-extended input, wrapped as the ring does,
   against their twins, and the blocks plus the residual against ``W @
   X`` and the one-device K7 and K9 rounds on the ELL;
4i. the last of the distribution layer: the fit packs (``aot``) of the
   ten-cluster input (n=70000, the gather): Poisson, Laplace and spectral
   clustering saved, loaded and fitted in-process, Poisson's also in two
   fresh processes (each one's seconds from its start to its first
   prediction, with the pack and with the model path), each held to its
   model path, another graph and another kind refused; the bench's sharded mode
   (``GLT_BENCH_MODE=sharded``) on each route at the JAX bench's defaults
   (n=65536, d=64, chains of 20 products timed for a second after a warm
   one) on NCCL ranks, one card each, its chain held to the scipy f64
   chain and, banded at P=1, K1 once and K3 once a product; PoissonMBO, VolumeMBO and INCRES with ``all_labels`` on a
   one-rank NCCL group (banded) beside their one-device fits: as many
   rounds printed, the predictions agreeing, K3 and K7 held to their
   formulas;
5. the rectangular route: the same graph under ``GLT_NO_BAND=1``
   (Laplace and Poisson on the unstored band, K6; ``graph.dijkstra`` on
   the plain path), then ``AccelSpMM(W, materialize=True)`` (K4 band; the
   masked Laplace solve on K5, the distances on K8, both on the band's
   live chunks), then two moons with n=1310720, over the size gate, where
   ``maybe_build`` itself takes the unstored band (K6); each fit held to
   the plain ELL path; then K5, K6 and K8 against their twins at these
   shapes;
6. the bench (``graphlearning_tpu_torch.bench``) at the JAX bench's
   geometry: the 2-D spmm modes (n=262144, k=16, d=128: bf16 and f32 on
   K2, rowq2_int8 and rowq1_int8 on K10, bf16i8 on K11, each held to its
   error grade against the scipy f64 chain), the band-hostile 30-d graph
   on the segmented gather (f32 and bf16 tables), and the Poisson fit at
   n=70000 (20-d, ten clusters), which must take the gather and agree
   with the scipy reference on >= 0.99 of the nodes, and again under
   ``GLT_NO_GATHER`` on the plain ELL path; then K10 and K11
   against their twins on the bench's packed plan at d in {10, 128}.

Each kernel entry has ``ms`` (the median of single calls, each between two
CUDA events, the host's time in the call included), ``chain_ms`` (20
calls back to back between two events, over 20: the device's time where
it exceeds the host's, else the host's) and, but for K4's band build,
``graph_ms`` (20 calls captured in a CUDA graph and replayed between two
events, over 20: the device's time alone), and the same three for its
library call.  ``bound_ms`` counts what the function needs of this run's
data (:func:`needed_bytes`); the band matvecs and min-plus rounds also
give ``dense_bound_ms`` (every cell of the band, or of its real tiles),
K5, K7, K8 and K9 ``live_bound_ms`` (the bytes their live-chunk design
reads), and K7 and K9 ``list_ms``, the time of their list's build.

It prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

HBM_BPS = 3.35e12                     # H100 SXM data sheet
PEAK_OPS = {"float32": 67e12,         # f32 outside the tensor cores
            "bfloat16": 989e12,       # dense bf16 tensor cores
            # the exact grade (K2/K3 f32, K10 planes=2, K11) in 3xTF32 on
            # the TF32 tensor cores: three TF32 products per product
            "tf32x3": 495e12 / 3}
REPS = 20
SOURCE = "graphlearning_tpu_torch/csrc/"
REPLACES = {
    "materialize_band_tiles": "graphlearning_tpu/ops/pallas_spmm.py:681",
    "band_tiles_spmm_packed": "graphlearning_tpu/ops/pallas_spmm.py:1099",
    "band_tiles_spmm": "graphlearning_tpu/ops/pallas_spmm.py:762",
    "materialize_band": "graphlearning_tpu/ops/pallas_spmm.py:221",
    "band_tiles_minplus": "graphlearning_tpu/ops/pallas_spmm.py:842",
    "band_tiles_lip": "graphlearning_tpu/ops/pallas_spmm.py:915",
    "band_spmm": "graphlearning_tpu/ops/pallas_spmm.py:288",
    "banded_spmm": "graphlearning_tpu/ops/pallas_spmm.py:136",
    "band_minplus": "graphlearning_tpu/ops/pallas_spmm.py:384",
    "band_tiles_spmm_packed_rowq": "graphlearning_tpu/ops/pallas_spmm.py:1324",
    "band_tiles_spmm_packed_i8": "graphlearning_tpu/ops/pallas_spmm.py:1204",
    "plain_ell_spmm": "none: graphlearning_tpu/ops/graphops.py spmm, "
                      "XLA's gather and product",
}
CU_FILE = {
    "materialize_band_tiles": SOURCE + "band_tiles_build.cu",
    "band_tiles_spmm_packed": SOURCE + "band_tiles_spmm.cu",
    "band_tiles_spmm": SOURCE + "band_tiles_spmm.cu",
    "materialize_band": SOURCE + "band_rect_build.cu",
    "band_tiles_minplus": SOURCE + "band_tiles_minplus.cu",
    "band_tiles_lip": SOURCE + "band_tiles_lip.cu",
    "band_spmm": SOURCE + "band_tiles_spmm.cu",
    "banded_spmm": SOURCE + "band_ell_spmm.cu",
    "band_minplus": SOURCE + "band_rect_minplus.cu",
    "band_tiles_spmm_packed_rowq": SOURCE + "band_tiles_spmm.cu",
    "band_tiles_spmm_packed_i8": SOURCE + "band_tiles_spmm.cu",
    "plain_ell_spmm": SOURCE + "plain_ell_spmm.cu",
}
TOL = {"float32": 1e-5, "bfloat16": 1e-2}   # of max|ref|, per band dtype
# Iteration caps of the Lipschitz and p-eikonal fits: each fit fails the
# smoke when it reaches its cap, so a fit that does not converge stops
# here instead of spinning.  On this input the Lipschitz fits take about
# 2800 Jacobi rounds or 2100 block-Gauss-Seidel sweeps, p-eikonal about
# 200 Jacobi rounds.
LIP_MAX_NUM_IT = 20000
PEIKONAL_MAX_NUM_IT = 5000
K9_ROUNDS = 300          # lip_iterate_mc against the plain rounds, tol 0
FITS = {
    "laplace": lambda gl, W, **kw: gl.ssl.laplace(W, **kw),
    "poisson_cg": lambda gl, W, **kw: gl.ssl.poisson(W, **kw),
    "poisson_gd": lambda gl, W, **kw: gl.ssl.poisson(
        W, solver="gradient_descent", **kw),
    "graph_nn": lambda gl, W, **kw: gl.ssl.graph_nearest_neighbor(W, **kw),
    "plaplace": lambda gl, W, **kw: gl.ssl.plaplace(
        W, max_num_it=LIP_MAX_NUM_IT, **kw),
    # tol 1e-5 (AMLE's own solver default; f32 floors it at 1.19e-5):
    # at the SSL default 1e-3 the iteration stops far from its fixed
    # point, and the band path's harmonic start and the plain path's
    # Voronoi start agree on 0.8612 of the nodes (tools/lip_paths.py)
    "amle": lambda gl, W, **kw: gl.ssl.amle(
        W, max_num_it=LIP_MAX_NUM_IT, tol=1e-5, **kw),
    "peikonal": lambda gl, W, **kw: gl.ssl.peikonal(
        W, max_num_it=PEIKONAL_MAX_NUM_IT, **kw),
}
# The fits of the MBO phase, each from ``(gl, W, priors, X)``: PoissonMBO
# and VolumeMBO at the library's defaults (VolumeMBO at temperature 0, and
# at 0.1 with a seed), and the reweighted Laplace fits.
MBO_FITS = {
    "poisson_mbo": lambda gl, W, priors, X, **kw: gl.ssl.poisson_mbo(
        W, priors, **kw),
    "volume_mbo": lambda gl, W, priors, X, **kw: gl.ssl.volume_mbo(
        W, priors, temperature=0.0, **kw),
    "volume_mbo_t0.1": lambda gl, W, priors, X, seed=0, **kw:
        gl.ssl.volume_mbo(W, priors, temperature=0.1, seed=seed, **kw),
    "laplace_wnll": lambda gl, W, priors, X, **kw: gl.ssl.laplace(
        W, reweighting="wnll", **kw),
    "laplace_poisson": lambda gl, W, priors, X, **kw: gl.ssl.laplace(
        W, reweighting="poisson", **kw),
    "laplace_properly": lambda gl, W, priors, X, **kw: gl.ssl.laplace(
        W, X=X, reweighting="properly", **kw),
}
MBO_SEEDS = (0, 1, 2, 3, 4)   # JAX's mean of the temperature-0.1 fit
# Accuracy (%) of the JAX package in float32 on the fit input for
# MBO_FITS (the temperature-0.1 fit: the mean over MBO_SEEDS), from
# ``JAX_PLATFORMS=cpu python3 tools/mbo_reference.py``.  The port must come
# within MBO_MARGIN points of it, of the mean at temperature 0.1.
MBO_REFERENCE = {"poisson_mbo": 94.2572, "volume_mbo": 81.3006,
                 "volume_mbo_t0.1": 81.3006, "laplace_wnll": 99.6459,
                 "laplace_poisson": 99.8169, "laplace_properly": 69.9585}
MBO_MARGIN = {"volume_mbo_t0.1": 2.0}
# Agreement of the band fits with the plain path: the JAX package's own
# bounds for the bf16 MBO fits (tests/test_accel.py), 0.99 for the f32
# reweighted Laplace fits.
MBO_AGREEMENT = {"poisson_mbo": 0.98, "volume_mbo": 0.97,
                 "volume_mbo_t0.1": 0.97}
# Accuracy (%) of the JAX package in float32 on the fit input below (its
# plain path, with the FITS settings), from
# ``JAX_PLATFORMS=cpu python3 tools/moons_reference.py --float32``.  The
# port must come within ACCURACY_MARGIN points of it.  Poisson stays under
# 95 % on this input in the reference too, and its gradient descent scores
# less in float32 than in float64 (91.84 %, the same script without
# ``--float32``), in both packages.
REFERENCE_ACCURACY = {"laplace": 99.1957, "poisson_cg": 94.2695,
                      "poisson_gd": 89.1326, "graph_nn": 81.2532,
                      "plaplace": 93.8391, "amle": 92.3069,
                      "peikonal": 89.6926}
ACCURACY_MARGIN = 1.0
ITERS_MARGIN = 0.01      # band fits' iterations against the plain path's
# A band path's masked Laplace solve (the f32 CG to the fit's tol, d = 2)
# against scipy's f64 solve, at most this many times the plain f32 path's
# error.  The exact grade sums by FFMA at d <= 16, rounded to nearest; its
# 3xTF32 tensor-core sums measured about 10x (PERF.md), 40x before they
# were added by FADD.
SOLVE_MARGIN = 3.0


# The eig phase (phase 4c).  JAX's float32 figures on its two inputs, from
# ``JAX_PLATFORMS=cpu python3 tools/spectral_reference.py``: the spectral
# accuracy (%) and the largest error of eigen_decomp(normalized, k=10)
# against scipy's float64 eigsh.  On the moons JAX's LOBPCG stops after two
# steps (its threshold grows with n), so its figures there are no target
# (any labelling of two classes scores 50 %): the port's float32 tolerance
# is per pair (solvers/lobpcg.py, per_pair_tol), and its spectral accuracy
# is held to that of eigsh's float64 eigenvectors clustered as spectral
# does ("eigsh_accuracy", ``python3 tools/spectral_paths.py``), less
# ACCURACY_MARGIN.
EIG_REFERENCE = {"moons": {"accuracy": 50.7767, "max_err": 3.8453e-2,
                           "eigsh_accuracy": 79.3091},
                 "ten": {"accuracy": 98.4286, "max_err": 2.1583e-4}}
# Stated before the first chip run, each tighter than 3x JAX's error: the
# largest |lambda - lambda_eigsh| of the k=10 spectrum, the band's against
# the plain path's (the bound of JAX's test_eigen_decomp_accel_matches_
# plain), and the spectral fits' agreement with the plain path up to a
# permutation of the labels.  On the moons 200 LOBPCG steps leave the k=2
# solve unconverged (its eigenvalues 5e-6 apart; the phase prints the
# residual norms it ends with): a run-to-run variation of the band's sums
# moved its labels, and the band agreed on 0.9882-0.9901 of the nodes
# until the residual spill was summed in order (0.9952 since).
EIG_TOL = {"moons": 2e-5, "ten": 3 * 2.1583e-4}
EIG_BAND_TOL = 1e-5
EIG_AGREEMENT = {"moons": 0.99, "ten": 0.99}


# Phase 4d: the eigenbasis SSL models and the centered kernel method, each
# from ``(gl, W, priors)`` at the library's defaults (Multiclass MBO with a
# seed), and Fokker-Planck's cut of the moons (a dense n x n matrix
# exponential; ``tools/p10b_reference.py`` computes JAX's figure at it).
P10B_FITS = {
    "poisson_spectral": lambda gl, W, priors, **kw: gl.ssl.poisson(
        W, solver="spectral", **kw),
    "poisson_mbo_spectral": lambda gl, W, priors, **kw: gl.ssl.poisson_mbo(
        W, priors, solver="spectral", **kw),
    "multiclass_mbo": lambda gl, W, priors, **kw: gl.ssl.multiclass_mbo(
        W, seed=0, **kw),
    "modularity_mbo": lambda gl, W, priors, **kw: gl.ssl.modularity_mbo(
        W, **kw),
    "centered_kernel": lambda gl, W, priors, **kw: gl.ssl.centered_kernel(
        W, **kw),
}
# The fits of P10B_FITS that read eigenpairs: on the moons they are held to
# the JAX package's accuracy on scipy's float64 eigsh eigenpairs.
P10B_EIGSH = ("poisson_spectral", "poisson_mbo_spectral", "multiclass_mbo",
              "modularity_mbo")
# Fokker-Planck's cut: a dense (n, n) matrix exponential, so the graph is
# cut from 65536 to 4096 nodes (the CPU reference's expm takes 30 s there).
FP_N = 4096
# Accuracy (%) of the JAX package in float32 on phase 4d's inputs, from
# ``JAX_PLATFORMS=cpu python3 tools/p10b_reference.py``: each fit of
# P10B_FITS, INCRES's mean over MBO_SEEDS (its draws are not the port's),
# and on the moons, where JAX's float32 LOBPCG stops after two steps,
# "<fit>_eigsh", the same fit on scipy's float64 eigsh eigenpairs: the
# targets there.  Each fit is held to its target less its margin.
P10B_REFERENCE = {
    "moons": {"poisson_spectral": 49.3468, "poisson_mbo_spectral": 49.2415,
              "multiclass_mbo": 50.2640, "modularity_mbo": 48.2663,
              "centered_kernel": 50.4533, "incres": 72.1231,
              "poisson_spectral_eigsh": 94.3976,
              "poisson_mbo_spectral_eigsh": 94.3915,
              "multiclass_mbo_eigsh": 59.9213,
              "modularity_mbo_eigsh": 81.5478},
    "ten": {"poisson_spectral": 98.1069, "poisson_mbo_spectral": 98.4112,
            "multiclass_mbo": 24.7492, "modularity_mbo": 10.6744,
            "centered_kernel": 96.9596, "incres": 76.0423},
    "fokker_planck": 50.4150,
}
# The margins, stated before the first chip run.  On the moons the port's
# float32 eigensolves stop unconverged after 200 LOBPCG steps: its plain
# path in float32 on the CPU (``python3 tools/p10b_paths.py moons``) came
# 2.66, 1.21, -0.16 and 1.24 points under the eigsh targets of Poisson,
# PoissonMBO, Multiclass MBO and Modularity MBO, hence those shortfalls
# rounded up to half a point, plus 1.5 points.  On the ten clusters Multiclass MBO (one
# label a class, V >= 0.95, so it thresholds the projection of numpy's
# random start onto the 50 eigenvectors) follows eigenvectors 11-50, which
# neither package converges: 5 points.  INCRES: JAX's five seeds spread
# from 54.9988 to 81.6971 % on the moons (mean 72.1231) and from 69.5971 to
# 83.9971 % on the ten clusters (mean 76.0423), so the port's one seed is
# held to JAX's lowest seed less a point.  The rest: ACCURACY_MARGIN.
P10B_MARGIN = {"moons": {"poisson_spectral": 4.5,
                         "poisson_mbo_spectral": 3.0,
                         "multiclass_mbo": 1.5, "modularity_mbo": 3.0,
                         "incres": 72.1231 - 54.9988 + 1.0},
               "ten": {"multiclass_mbo": 5.0,
                       "incres": 76.0423 - 69.5971 + 1.0}}
# Agreement with the plain path (INCRES up to a permutation of the
# clusters), stated before the first chip run: the unconverged moons
# eigensolves 0.95 (Multiclass MBO, whose threshold follows all 50
# eigenvectors, 0.90 on both inputs); PoissonMBO's heat steps on the bf16
# band at JAX's own bound (MBO_AGREEMENT); INCRES's walk on the bf16 band
# 0.95; the rest 0.99.
P10B_AGREEMENT = {"moons": {"poisson_spectral": 0.95,
                            "poisson_mbo_spectral": 0.95,
                            "multiclass_mbo": 0.90, "incres": 0.95},
                  "ten": {"poisson_mbo_spectral": 0.98,
                          "multiclass_mbo": 0.90, "incres": 0.95}}
# Multiclass MBO's 50 eigenvalues against eigsh's, the largest error.
MULTICLASS_EIG_TOL = 2e-5
# Personalized PageRank against scipy's float64 iteration of as many steps,
# of the largest entry; Fokker-Planck's float32 expm against float64, of
# the largest entry.
PAGERANK_TOL = 1e-4
FP_EXPM_TOL = 1e-5

# Phase 4e, the experiment harness on the ten-cluster input: TRIAL_NUM
# trials a rate at each rate (labels a class), the trials of a rate drawn
# with the rate as seed (``trial_sets``).
TRIAL_RATES = (1, 2, 4)
TRIAL_NUM = 5
# The class-priors trials of phase 4e on the moons band, as
# ``trainsets.generate`` takes them.
PRIOR_TRIALS = {"rate": 5, "num_trials": 3, "seed": 7}
# Accuracy (%) of the JAX package in float32 on phase 4e's inputs, from
# ``JAX_PLATFORMS=cpu python3 tools/trials_reference.py``: the mean over
# the trials of each rate of ``ssl_trials`` of Laplace and Poisson
# learning, sparse label propagation on the ten clusters (one label a
# class), dynamic label propagation on the FP_N cut of the moons, and each
# PRIOR_TRIALS trial's accuracy with class priors on the moons.
TRIALS_REFERENCE = {"laplace_1": 19.9689, "laplace_2": 15.8897,
                    "laplace_4": 42.5883, "poisson_1": 97.8291,
                    "poisson_2": 97.9057, "poisson_4": 97.9828,
                    "sparse_label_propagation": 9.9514,
                    "dynamic_label_propagation": 62.5061,
                    "laplace_priors": (93.9841, 99.8642, 96.2412)}
# The margin under each target, stated before the first chip run:
# ACCURACY_MARGIN, but 4 points for Laplace's means.  Laplace learning is
# degenerate at these rates in 20-d: JAX's trials score near multiples of
# 10 % (whole classes lost), so one trial losing one more class moves its
# rate's mean by 2 points; the margin allows two.  The agreement of one
# batched trial a rate with its sequential fit on the plain path:
# TRIALS_AGREEMENT.
TRIALS_MARGIN = {"laplace": 4.0}
TRIALS_AGREEMENT = 0.999

# Phase 4f (active learning).  The moons learners run AL_QUERIES rounds of
# one query each on var_opt over eigsh's covariance (AL_TAU); the
# ten-cluster learner AL_TEN_ROUNDS rounds of AL_TEN_BATCH.  AL_REFERENCE
# holds the JAX package's float32 figures on these inputs, from
# ``JAX_PLATFORMS=cpu python3 tools/al_reference.py``: the moons queries
# (var_opt reads no fit, so they follow from the covariance), the moons
# accuracy after each query, the ten-cluster learner's final accuracy and
# the stalled GMRES solve's residual (GMRES_STALL_TOL below).
AL_QUERIES = 10
AL_TAU = 0.11
AL_TEN_ROUNDS = 10
AL_TEN_BATCH = 5
AL_AGREEMENT = 0.999       # cold against warm learner, final argmax
AL_REFERENCE = {
    "moons_queries": [6145, 39715, 1953, 58491, 33846, 27501, 2178, 14598,
                      16467, 12243],
    "moons_accuracy": [82.096, 84.02, 75.4834, 86.2155, 98.9287, 99.8108,
                       99.5208, 99.7802, 99.8504, 99.8062],
    "ten_accuracy": 98.0555, "ten_ivf_recall": 0.5393,
    "gmres_stall_residual": 3.5708e-4}
# The IVF search's recall against the brute search: on the ten clusters
# within IVF_RECALL_MARGIN of JAX's (its defaults probe 16 of 1093
# clusters there, and 20-d unit gaussians spread a point's neighbours
# over many cells: the port's indices equal JAX's on the CPU, recall
# 0.5393 both), and at least IVF_RECALL on the clustered input of JAX's
# recall test (tests/test_weightmatrix.py: n=4000, 30-d).
IVF_RECALL_MARGIN = 0.01
IVF_RECALL = 0.95
# GMRES on the moons Laplacian (utils.constrained_solve_gmres) at JAX's
# default tolerance, GMRES_RATE labels a class.  At the fits' 5 a class
# the float32 solve stalls near 1.7 times its tolerance, in both packages
# (JAX's Gram-Schmidt repeats its pass only where the overlaps are small,
# so the rotated residual runs ahead of the true one; each restart then
# ends after a step or two): PERF.md, PR 14.
GMRES_TOL = 1e-5
GMRES_RATE = 1000
# Where it stalls, at 5 labels a class and GMRES_STALL_TOL, the solve runs
# all its 1000 restarts; the preconditioned residual of its answer
# (gmres_residual, float64 on the host) is held to the JAX package's
# float32 figure (AL_REFERENCE["gmres_stall_residual"], tools/
# al_reference.py) within GMRES_STALL_MARGIN, relative, both ways: the
# stall's level is set by float32 rounding, which the card and the CPU
# order differently.
GMRES_STALL_TOL = 1e-4
GMRES_STALL_MARGIN = 0.10

# Phase 4g (the embedding trainers, the host oracles, observability).
# ARS at its defaults (dim 2, perplexity 30, chunk 1024; use_pca is moot
# at 20 < 200 columns) on the ten-cluster points: at n=70000 cut to
# ARS_FULL_ITERS iterations (about 0.19 s each on the card, so 1000 would
# take over three minutes), and in full, ARS_ITERS, on the first
# ARS_SUBSET points, where the 10-NN label accuracy in the embedding
# (knn_label_accuracy) is held to the JAX package's float32 figure
# (ARS_REFERENCE, ``tools/ars_reference.py``) less ACCURACY_MARGIN.
# ARS_REPLAY_N points replay ARS_REPLAY_ITERS iterations on the card and
# on the CPU from the same P and start: within ARS_REPLAY_TOL of max|Y|.
ARS_FULL_ITERS = 250
ARS_ITERS = 1000
ARS_SUBSET = 8192
ARS_KNN = 10
ARS_REPLAY_N = 2048
ARS_REPLAY_ITERS = 20
ARS_REPLAY_TOL = 1e-4
ARS_REFERENCE = {"knn_accuracy": 97.9736}
# The VAE on an MNIST-shaped input (mnist_shaped: n=70000 rows of 784
# values in [0, 1]) at JAX's defaults (widths (400, 20), batch 128, lr
# 1e-3), cut from 100 epochs to VAE_EPOCHS (about 1.6 s an epoch on the
# card).  knn(Z, 10) and Laplace and Poisson at one label a class, each
# held to the lowest of the JAX package's float32 accuracies over
# VAE_SEEDS (VAE_REFERENCE, ``tools/vae_reference.py``) less
# ACCURACY_MARGIN: the spread of JAX's seeds widens the margin to it.
# VAE_REPLAY_STEPS steps replay on the card and on the CPU from the same
# carried-across parameters and CPU-drawn noise: the latent means within
# VAE_REPLAY_TOL of their largest.  Laplace at one label a class is
# degenerate on this graph, as on the raw points (JAX's seeds 10-19 %).
# At VAE_SCALE 4 the JAX package's training loss turned infinite at step
# 221 of seed 0 (its latent means NaN), where the port, replaying JAX's
# parameters and noise, stayed finite (PERF.md, section 7).
VAE_SCALE = 2.0
VAE_EPOCHS = 20
VAE_SEEDS = (0, 1, 2)
VAE_REPLAY_STEPS = 20
VAE_REPLAY_TOL = 1e-4
VAE_REFERENCE = {"laplace": [10.4086, 19.0627, 10.3358],
                 "poisson": [93.7091, 93.109, 93.1304]}
# native: the laplace_host check's moons cut.
NATIVE_LAPLACE_N = 4096
# observability: the traced band Laplace fit's CG tolerance (a looser one
# than the fits' keeps the trace to some hundred CG steps).
OBS_TOL = 1e-3


class SmokeFailure(RuntimeError):
    pass


def say(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def env(name, value):
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def time_ms(torch, fn, reps=REPS):
    """Median over ``reps`` runs of one call, each timed by CUDA events.
    The start event is recorded before the call's Python runs, so a call
    whose device time is near its host time reads its host time too."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def chain_ms(torch, fn, reps=REPS):
    """One pair of CUDA events around ``reps`` calls back to back, after a
    warm-up, over ``reps``: a call's time in a stream of them, where the
    host enqueues the next call while the device runs this one."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps=REPS, library=False):
    """The device's time of one call, with no host time in it: ``reps``
    calls captured in one CUDA graph after a warm-up, replayed between two
    CUDA events, over ``reps``.  A ``library`` call that cannot be captured
    (one that waits on the host) gives None; a kernel of the port that
    cannot be captured fails the smoke."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
    except RuntimeError as e:
        if not library:
            raise SmokeFailure(f"a kernel not captured in a CUDA graph: "
                               f"{str(e).splitlines()[0]}") from e
        say(f"  library call not captured in a CUDA graph: "
            f"{str(e).splitlines()[0]}")
        return None
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def timings(torch, run, plain, library=None, graph=True):
    """The kernel's ``ms``, ``chain_ms`` and (with ``graph``; K4's
    rectangular band is too large to hold 20 of) ``graph_ms``, its twin's
    ``plain_ms``, and the same three of the library call (None without
    one)."""
    lib = {"library_ms": None, "library_chain_ms": None,
           "library_graph_ms": None}
    if library:
        lib = {"library_ms": time_ms(torch, library),
               "library_chain_ms": chain_ms(torch, library),
               "library_graph_ms": graph_ms(torch, library, library=True)}
    return {"ms": time_ms(torch, run), "chain_ms": chain_ms(torch, run),
            "graph_ms": graph_ms(torch, run) if graph else None,
            "plain_ms": time_ms(torch, plain), **lib}


def bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BPS
    t_ops = ops / PEAK_OPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def compare(label, out, ref, tol):
    torch = sys.modules["torch"]
    if out.shape != ref.shape:
        raise SmokeFailure(f"{label}: shape {tuple(out.shape)} != "
                           f"{tuple(ref.shape)}")
    out, ref = out.double(), ref.double()
    if not bool(torch.isfinite(out).all()):
        raise SmokeFailure(f"{label}: non-finite output")
    err = float((out - ref).abs().max())
    scale = float(ref.abs().max())
    if err > tol * max(scale, 1e-30):
        raise SmokeFailure(f"{label}: max|err| {err:.3e} > {tol:g} * "
                           f"max|ref| {scale:.3e}")
    say(f"  {label}: max|err| {err:.3e} (max|ref| {scale:.3e}, "
        f"tol {tol:g} of it)")
    return err


def report(entry):
    say("  " + json.dumps({k: entry[k] for k in (
        "variant", "ms", "chain_ms", "graph_ms", "plain_ms", "bound_ms",
        "bound_by", "live_bound_ms", "dense_bound_ms", "live_share",
        "list_ms", "library_ms", "library_chain_ms", "library_graph_ms",
        "sums_library_ms", "sums_library_chain_ms", "sums_library_graph_ms",
        "gb_s", "bound_share") if k in entry}))
    return entry


def k1_entry(torch, bs, label, inputs, out_dtype):
    cols, vals, tb, ts, R, WT = inputs
    run = lambda: bs.materialize_band_tiles(cols, vals, tb, ts, R, WT,
                                            out_dtype)
    plain = lambda: bs._materialize_band_tiles_plain(cols, vals, tb, ts, R,
                                                     WT, out_dtype)
    out = run()
    torch.cuda.synchronize()
    dname = str(out_dtype).split(".")[-1]
    err = compare(label, out, plain(), 1e-6 if dname == "float32" else 4e-3)
    nbytes = (cols.numel() * 4 + vals.numel() * 4 + tb.numel() * 8
              + out.numel() * out.element_size())
    b_ms, b_by = bound(nbytes, 0, dname)
    return report({
        "name": "materialize_band_tiles", "variant": label,
        "max_abs_err": err, **timings(torch, run, plain),
        "bound_ms": b_ms, "bound_by": b_by,
        "shapes": {"ell": list(cols.shape), "tiles": int(tb.numel()),
                   "R": R, "WT": WT, "out": list(out.shape),
                   "dtype": dname}})


def spmm_entry(torch, bs, name, label, band, plan, X, library):
    wrapper = bs.KERNELS[name]
    run = lambda: wrapper(band, plan, X)
    plain = lambda: bs._tiles_spmm_plain(band, plan, X)
    out = run()
    torch.cuda.synchronize()
    dname = str(band.dtype).split(".")[-1]
    err = compare(label, out, plain(), TOL[dname])
    real_cells = int(plan.slab_ntiles.sum()) * plan.R * plan.WT
    nnz_band = int((band != 0).sum())
    d = X.shape[1]
    ops = 2 * nnz_band * d
    peak = "tf32x3" if dname == "float32" else dname
    nbytes, sectors = needed_bytes(torch, bs, band, plan,
                                   d * X.element_size())
    nbytes += out.numel() * 4
    b_ms, b_by = bound(nbytes, ops, peak)
    dense_bytes = (real_cells * band.element_size()
                   + X.numel() * X.element_size() + out.numel() * 4
                   + (plan.slab_starts.numel() + plan.slab_ntiles.numel()
                      + plan.block_ptr.numel()) * 4)
    t = timings(torch, run, plain, library)
    return report({
        "name": name, "variant": label, "max_abs_err": err, **t,
        "bound_ms": b_ms, "bound_by": b_by,
        "dense_bound_ms": bound(dense_bytes, ops, peak)[0],
        # the needed bytes over the kernel's time, and bound / time
        "gb_s": nbytes / t["ms"] * 1e-6, "bound_share": b_ms / t["ms"],
        "shapes": {"band": list(band.shape), "X": list(X.shape),
                   "slabs": int(plan.slab_block.numel()),
                   "real_tiles": int(plan.slab_ntiles.sum()),
                   "band_nnz": nnz_band, "band_sectors": sectors,
                   "R": plan.R, "WT": plan.WT, "S": plan.S,
                   "dtype": dname}})


def _real_cells(plan):
    return int(plan.slab_block.numel()) * plan.R * plan.WT


def k4_entry(torch, bs, label, acc, dtype):
    """K4 on ``acc``'s rectangular plan: exact in f32, one rounding in
    bf16 (4e-3 of max|ref|, as K1)."""
    winstart, _, _, Wr, kcap = acc._rect_plan
    cols = acc.g.cols[:, :kcap].contiguous()
    vals = acc.g.vals[:, :kcap].contiguous()
    ws = torch.as_tensor(winstart, device=cols.device)
    run = lambda: bs.materialize_band(cols, vals, ws, Wr, R=acc.R,
                                      WT=acc.WT, out_dtype=dtype)
    plain = lambda: bs._materialize_band_plain(cols, vals, ws, Wr, acc.R,
                                               dtype)
    out = run()
    torch.cuda.synchronize()
    dname = str(dtype).split(".")[-1]
    err = compare(label, out, plain(), 0.0 if dname == "float32" else 4e-3)
    del out
    nbytes = (cols.numel() * 4 + vals.numel() * 4 + ws.numel() * 4
              + acc.n_pad * Wr * torch.finfo(dtype).bits // 8)
    b_ms, b_by = bound(nbytes, 0, dname)
    return report({
        "name": "materialize_band", "variant": label, "max_abs_err": err,
        **timings(torch, run, plain, graph=False), "bound_ms": b_ms,
        "bound_by": b_by,
        "shapes": {"ell": list(cols.shape), "R": acc.R, "Wr": int(Wr),
                   "out": [acc.n_pad, int(Wr)], "dtype": dname}})


def coo_of(torch, acc):
    """Rows, columns and weights of the permuted graph's edges on the
    card: the yardstick's inputs."""
    Wp = acc.g.to_scipy().tocoo()
    as_t = lambda a, dt: torch.as_tensor(a, device=acc.device).to(dt)
    return (as_t(Wp.row.astype(np.int64), torch.int64),
            as_t(Wp.col.astype(np.int64), torch.int64),
            as_t(Wp.data, torch.float32))


def minplus_entry(torch, bs, name, label, run, plain, band, d, f, track,
                  coo, shapes, bounds, recip=False):
    """A min-plus kernel (K7 or K8) against its twin: min and argmin
    identical.  ``coo`` gives the yardstick of the plain (or ``recip``)
    min-plus round: one ``addcmul`` (``addcdiv``) forms the candidates of
    the COO edges (their d and f gathered beforehand) and one
    ``scatter_reduce(amin)`` reduces them per row, timed together.
    ``bounds``: the entry's bounds and live-chunk counts
    (:func:`chunk_bounds`)."""
    m, a = run()
    torch.cuda.synchronize()
    rm, ra = plain()
    if not torch.equal(m, rm) or (track and not torch.equal(a, ra)):
        raise SmokeFailure(f"{label}: {name} differs from its twin (min "
                           f"{float((m - rm).abs().max()):.3e})")
    reached = int((m < bs.MINPLUS_BIG).sum())
    say(f"  {label}: min{' and argmin' if track else ''} identical to the "
        f"twin ({reached} of {m.numel()} rows with a candidate)")
    library = None
    if coo is not None:
        row, col, w = coo
        dcol, fcol = d[col], f[col]
        base = torch.full_like(d, bs.MINPLUS_BIG)
        cand = ((lambda: torch.addcdiv(dcol, fcol, w)) if recip
                else (lambda: torch.addcmul(dcol, w, fcol)))
        library = lambda: base.scatter_reduce(0, row, cand(), "amin")
    return report({
        "name": name, "variant": label, "max_abs_err": 0.0,
        **timings(torch, run, plain, library),
        "library": (f"{'addcdiv' if recip else 'addcmul'} + "
                    "scatter_reduce(amin) over the COO edges"
                    if library else None),
        **bounds,
        "shapes": dict(shapes, track_arg=track,
                       dtype=str(band.dtype).split(".")[-1])})


def chunk_bounds(torch, bs, band, plan, chunks, row_bytes, out_bytes, ops,
                 dense_bytes):
    """``bound_ms`` of a live-chunk kernel from its function (the bytes
    :func:`needed_bytes` counts, the outputs and ``ops`` f32 operations),
    its ``live_bound_ms`` (the bytes of :func:`live_bytes`, what the design
    reads) and ``dense_bound_ms`` (``dense_bytes``: every cell of the band
    read once), with the live chunks' count and share; and the shapes'
    keys of the band's nonzero sectors and chunks."""
    nbytes, sectors = needed_bytes(torch, bs, band, plan, row_bytes)
    lbytes, live, n_chunks = live_bytes(torch, bs, band, plan, chunks,
                                        row_bytes)
    b_ms, b_by = bound(nbytes + out_bytes, ops, "float32")
    return ({"bound_ms": b_ms, "bound_by": b_by,
             "live_bound_ms": bound(lbytes + out_bytes, ops, "float32")[0],
             "dense_bound_ms": bound(dense_bytes + out_bytes, ops,
                                     "float32")[0],
             "live_chunks": live, "live_share": live / n_chunks},
            {"band_sectors": sectors, "chunks": n_chunks})


def k7_entry(torch, bs, label, band, plan, chunks, d, f, hopf, recip, track,
             coo=None, list_ms=None):
    """K7 on the tiles band's live chunks against its twin
    (:func:`minplus_entry`); ``coo``: the permuted graph's edges.  Bounds
    as :func:`chunk_bounds`: the function's bytes with their d and f, the
    live 16 x 32 chunks', and the dense tiles' (the bound of PRs 2-7).
    ``list_ms``: the time of the list's build, for the record."""
    G = int(plan.slab_block.numel())
    nnz_band = int((band != 0).sum())
    bounds, counts = chunk_bounds(
        torch, bs, band, plan, chunks, 8, plan.n * (8 if track else 4),
        nnz_band * (8 if hopf else 3),
        _real_cells(plan) * band.element_size() + G * plan.WT * 8
        + (plan.slab_starts.numel() + plan.block_ptr.numel()) * 4)
    return minplus_entry(
        torch, bs, "band_tiles_minplus", label,
        lambda: bs.band_tiles_minplus(band, plan, d, f, hopf_lax=hopf,
                                      track_arg=track, recip=recip,
                                      chunks=chunks),
        lambda: bs._tiles_minplus_plain(band, plan, d, f, hopf, track,
                                        recip),
        band, d, f, track, coo,
        dict(counts, tiles=G, R=plan.R, WT=plan.WT, hopf_lax=hopf,
             recip=recip, band=list(band.shape), band_nnz=nnz_band),
        dict(bounds, list_ms=list_ms), recip=recip)


def k9_entry(torch, bs, label, band, plan, chunks, U, csr=None,
             list_ms=None):
    """K9 on the tiles band's live chunks against its twin: sums within TOL
    of max|ref|, min and max identical.  No PyTorch call computes K9's
    function (the sums with the neighbors' min and max), so ``library_ms``
    is None; ``csr`` gives ``sums_library_ms``, ``torch.sparse.mm`` on the
    permuted graph, which computes the sums alone.  Bounds as
    :func:`chunk_bounds`, with U's C values a column."""
    run = lambda: bs.band_tiles_lip(band, plan, U, chunks)
    plain = lambda: bs._tiles_lip_plain(band, plan, U)
    out = run()
    torch.cuda.synchronize()
    ref = plain()
    dname = str(band.dtype).split(".")[-1]
    err = compare(label + "/sums", out[0], ref[0], TOL[dname])
    if not (torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])):
        raise SmokeFailure(f"{label}: K9 min or max differs from its twin")
    say(f"  {label}: min and max identical to the twin")
    C = U.shape[1]
    nnz_band = int((band != 0).sum())
    G = int(plan.slab_block.numel())
    bounds, counts = chunk_bounds(
        torch, bs, band, plan, chunks, C * 4, 3 * plan.n * C * 4,
        4 * nnz_band * C,
        _real_cells(plan) * band.element_size() + G * plan.WT * C * 4
        + (plan.slab_starts.numel() + plan.block_ptr.numel()) * 4)
    sums = (lambda: torch.sparse.mm(csr, U)) if csr is not None else None
    return report({
        "name": "band_tiles_lip", "variant": label, "max_abs_err": err,
        **timings(torch, run, plain), **bounds,
        "sums_library_ms": time_ms(torch, sums) if sums else None,
        "sums_library_chain_ms": chain_ms(torch, sums) if sums else None,
        "sums_library_graph_ms": (graph_ms(torch, sums, library=True)
                                  if sums else None),
        "list_ms": list_ms,
        "shapes": dict(counts, band=list(band.shape), tiles=G, R=plan.R,
                       WT=plan.WT, C=C, band_nnz=nnz_band, dtype=dname)})


def list_build_ms(torch, bs, band, plan, label):
    """The time of ``tiles_live_chunks`` on ``band`` (median of single
    calls between CUDA events: it waits on the host for its nonzero
    count), printed; returns ``(chunks, ms)``."""
    ms = time_ms(torch, lambda: bs.tiles_live_chunks(band, plan), reps=5)
    chunks = bs.tiles_live_chunks(band, plan)
    say(f"  {label}: tiles_live_chunks {ms:.4f} ms, {chunks[1].numel()} "
        f"live 16 x 32 chunks")
    return chunks, ms


def permuted_csr(torch, acc):
    """The permuted matrix of ``acc`` as a torch CSR on its device: the
    yardstick for a whole band-plus-residual SpMM."""
    Wp = acc.g.to_scipy().astype(np.float32)
    return torch.sparse_csr_tensor(
        torch.as_tensor(Wp.indptr.astype(np.int64)),
        torch.as_tensor(Wp.indices.astype(np.int64)),
        torch.as_tensor(Wp.data), size=Wp.shape).to(acc.device)


def eigsh_reference(W, k, shift_invert=True):
    """The ``k`` smallest eigenvalues of the normalized Laplacian of ``W``
    by scipy's float64 ``eigsh``, ascending: in shift-invert mode about
    ``-1e-3`` (a sparse LU, cheap on a 2-D kNN graph), else as the largest
    of ``D^-1/2 W D^-1/2`` (Lanczos, no fill)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as sla

    W = sp.csr_matrix(W, dtype=np.float64)
    s = sp.diags(np.asarray(W.sum(axis=1)).ravel() ** -0.5)
    A = (s @ W @ s).tocsr()
    if shift_invert:
        L = (sp.identity(W.shape[0]) - A).tocsc()
        vals = sla.eigsh(L, k=k, sigma=-1e-3, which="LM",
                         return_eigenvectors=False)
    else:
        vals = 1.0 - sla.eigsh(A, k=k, which="LA", tol=1e-12,
                               return_eigenvectors=False)
    return np.sort(vals)


def eigsh_pairs(W, k):
    """The ``k`` lowest eigenpairs of the normalized Laplacian of ``W`` by
    scipy's float64 ``eigsh`` in shift-invert mode about ``-1e-3``, from a
    seeded start: increasing eigenvalues, eigenvectors as columns."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as sla

    W = sp.csr_matrix(W, dtype=np.float64)
    n = W.shape[0]
    s = sp.diags(np.asarray(W.sum(axis=1)).ravel() ** -0.5)
    L = (sp.identity(n) - s @ W @ s).tocsc()
    vals, vecs = sla.eigsh(L, k=k, sigma=-1e-3, which="LM",
                           v0=np.random.RandomState(0).rand(n))
    order = np.argsort(vals)
    return vals[order], vecs[:, order]


def two_moons(n, noise, seed):
    rs = np.random.RandomState(seed)
    n_out = n // 2
    n_in = n - n_out
    t_out = np.linspace(0, np.pi, n_out)
    t_in = np.linspace(0, np.pi, n_in)
    X = np.vstack([np.stack([np.cos(t_out), np.sin(t_out)], 1),
                   np.stack([1 - np.cos(t_in), 1 - np.sin(t_in) - 0.5], 1)])
    y = np.hstack([np.zeros(n_out, int), np.ones(n_in, int)])
    perm = rs.permutation(n)
    X, y = X[perm], y[perm]
    return X + rs.normal(scale=noise, size=X.shape), y


def trial_sets(gl, labels, dataset=None):
    """The trials of phase 4e: TRIAL_NUM at each of TRIAL_RATES, seeded by
    the rate, each rate's written to ``trainset_dir`` under ``_rate<r>``
    when ``dataset`` is given."""
    out = []
    for r in TRIAL_RATES:
        kw = {} if dataset is None else {"dataset": dataset,
                                         "trainset_name": f"_rate{r}"}
        out += gl.trainsets.generate(labels, rate=r, num_trials=TRIAL_NUM,
                                     seed=r, **kw)
    return out


def ten_points(n):
    """``bench.ten_cluster_points(n)`` in numpy alone: ``n`` points of a
    20-d mixture of ten unit gaussians and their labels."""
    rs = np.random.RandomState(0)
    centers = rs.randn(10, 20)
    labels = rs.randint(0, 10, n)
    return centers[labels] + rs.randn(n, 20), labels


def mnist_shaped(pts):
    """Phase 4g's VAE input: the 20-d points through a fixed random
    ``20 -> 784`` map scaled by VAE_SCALE and a sigmoid, rows of 784
    values in [0, 1], as MNIST's pixels."""
    M = np.random.RandomState(1).randn(pts.shape[1], 784) / np.sqrt(
        pts.shape[1])
    return 1.0 / (1.0 + np.exp(-VAE_SCALE * (pts @ M)))


def knn_label_accuracy(Y, labels, k=ARS_KNN):
    """Percent of points whose label is the most common among their ``k``
    nearest other points in the embedding ``Y`` (ties to the smaller
    label)."""
    from scipy import spatial

    _, J = spatial.cKDTree(Y).query(Y, k=k + 1)
    votes = labels[J[:, 1:]]
    C = int(labels.max()) + 1
    counts = np.stack([(votes == c).sum(1) for c in range(C)], axis=1)
    return 100.0 * float(np.mean(np.argmax(counts, axis=1) == labels))


def bench_graph(n, k, seed):
    """Uniform 2-D points, exact kNN, self-tuned gaussian weights,
    symmetrized; the points ride along for the Hilbert ordering."""
    import scipy.sparse as sp
    from scipy.spatial import cKDTree

    rs = np.random.RandomState(seed)
    pts = rs.rand(n, 2)
    dist, ind = cKDTree(pts).query(pts, k=k + 1)
    dist, ind = dist[:, 1:], ind[:, 1:]
    eps = np.maximum(dist[:, -1:] ** 2, 1e-12)
    w = np.exp(-4 * dist ** 2 / eps)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    W = sp.csr_matrix((w.ravel(), (rows, ind.ravel())), shape=(n, n))
    W = ((W + W.T) / 2).tocsr()
    W._glt_points = pts
    return W


def kernel_phase(torch, accel, bs):
    say("== kernels at the bench geometry (uniform 2-D, n=262144, k=16)")
    t0 = time.perf_counter()
    W = bench_graph(1 << 18, 16, seed=0)
    acc = accel.AccelSpMM(W, device="cuda")
    acc_u = accel.AccelSpMM(W, device="cuda", packed=False)
    if not acc.packed or acc_u.packed:
        raise SmokeFailure("expected a packed and an unpacked plan")
    say(f"  graph + two plans: {time.perf_counter() - t0:.1f} s; nnz "
        f"{W.nnz}, n_pad {acc.n_pad}, packed slabs "
        f"{acc.plan.slab_block.numel()} ({int(acc.plan.slab_ntiles.sum())} "
        f"tiles), unpacked tiles {acc_u.plan.slab_block.numel()}, residual "
        f"{acc.n_resid} / {acc_u.n_resid}")
    del W
    entries = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    csr = permuted_csr(torch, acc)
    for a, name in ((acc, "band_tiles_spmm_packed"),
                    (acc_u, "band_tiles_spmm")):
        for dt in (torch.float32, torch.bfloat16):
            dname = str(dt).split(".")[-1]
            tag = "packed" if a.packed else "unpacked"
            entries.append(k1_entry(torch, bs, f"bench/{tag}/{dname}",
                                    a.band_inputs(), dt))
            band = a.build_band(dt)
            for d in (10, 128):
                X = torch.randn((a.n_pad, d), generator=gen, device="cuda")
                lib = None
                if dt == torch.float32:
                    lib = lambda X=X: torch.sparse.mm(csr, X)
                entries.append(spmm_entry(
                    torch, bs, name, f"bench/{dname}/d={d}", band, a.plan,
                    X.to(dt), lib))
            del band
            torch.cuda.empty_cache()
    del acc
    torch.cuda.empty_cache()

    # the distance kernels on the unpacked tiles (acc_u's matvec band)
    plan = acc_u.tiles_plan
    n_pad = acc_u.n_pad
    d = torch.rand(n_pad, generator=gen, device="cuda") * 3
    d[torch.rand(n_pad, generator=gen, device="cuda") < 0.3] = bs.MINPLUS_BIG
    f = torch.rand(n_pad, generator=gen, device="cuda") + 0.5
    coo = coo_of(torch, acc_u)
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        band = acc_u.build_band(dt, tiles=True)
        chunks, list_ms = list_build_ms(torch, bs, band, plan,
                                        f"bench/{dname}")
        variants = ((False, False, False), (False, False, True),
                    (True, False, True), (False, True, True))
        if dt == torch.bfloat16:
            variants = ((False, False, True),)
        for hopf, recip, track in variants:
            tag = ("hopf_lax" if hopf else "recip" if recip else "plain") \
                + ("/arg" if track else "")
            entries.append(k7_entry(
                torch, bs, f"bench/{dname}/{tag}", band, plan, chunks, d, f,
                hopf, recip, track, None if hopf else coo, list_ms))
        for C in (2, 10):
            U = torch.randn((n_pad, C), generator=gen, device="cuda")
            entries.append(k9_entry(torch, bs, f"bench/{dname}/C={C}", band,
                                    plan, chunks, U,
                                    csr if dt == torch.float32 else None,
                                    list_ms))
        del band, chunks
        torch.cuda.empty_cache()
    del csr, coo
    torch.cuda.empty_cache()
    if acc_u.rect_band_ok():
        for dt in (torch.float32, torch.bfloat16):
            entries.append(k4_entry(torch, bs,
                                    f"bench/{str(dt).split('.')[-1]}",
                                    acc_u, dt))
    else:
        say(f"  K4 at the bench geometry: the rectangular band "
            f"({acc_u.rect_band_bytes():.3g} B, Wr={acc_u._rect_plan[3]}) "
            f"and the resident tiles ({acc_u.matvec_band_bytes:.3g} B) "
            f"exceed the band budget ({acc_u._budget:.3g} B): K4 runs at "
            "the fit geometry only")
    return entries


def plain_ell_entry(torch, graphops, label, g, X):
    """The plain ELL kernel against its twin, within TOL of max|ref|, one
    launch a product.  The bound counts the real slots' values and
    columns, the row pointers, X and ``out`` once.  The entry's launches
    are the main path's, counted in the plain fits and the Poisson
    trials (``fit_phase``, ``harness_ten``)."""
    run = lambda: graphops.plain_ell_spmm(g.cols, g.vals, g.deg, X)
    plain = lambda: graphops._plain_ell_spmm_twin(g.cols, g.vals, X)
    n0 = graphops.plain_ell_spmm.launches
    out = run()
    torch.cuda.synchronize()
    if graphops.plain_ell_spmm.launches != n0 + 1:
        raise SmokeFailure(f"plain_ell_spmm[{label}]: not one launch a "
                           "product")
    err = compare(label, out, plain(), TOL["float32"])
    nnz, d = g.nnz, X.shape[1]
    nbytes = 8 * nnz + 4 * (g.n + 1) + 2 * g.n * d * 4
    b_ms, b_by = bound(nbytes, 2 * nnz * d, "float32")
    library = lambda: torch.sum(g.vals[:, :, None] * X[g.cols], dim=1)
    return report({
        "name": "plain_ell_spmm", "variant": label, "max_abs_err": err,
        **timings(torch, run, plain, library),
        "bound_ms": b_ms, "bound_by": b_by,
        "library": "torch multiply and sum over the gather of every slot",
        "shapes": {"ell": [g.n, g.k], "nnz": nnz, "X": list(X.shape),
                   "dtype": "float32"}})


def plain_ell_phase(torch, gl):
    """Phase 2b: the plain ELL kernel on the moons graph at the fits'
    d=2, and on the ten-cluster graph at the batched trials' d=30 and
    d=10."""
    from graphlearning_tpu_torch.ops import graphops

    say("== the plain ELL product (graphops.plain_ell_spmm)")
    gen = torch.Generator(device="cuda").manual_seed(0)
    moons, _ = two_moons(65536, 0.1, seed=0)
    ten, _ = ten_points(70000)
    entries = []
    for tag, pts, widths in (("moons", moons, (2,)),
                             ("ten", ten, (30, 10))):
        g = gl.graph(gl.weightmatrix.knn(pts, 10)).sparse
        for d in widths:
            X = torch.randn((g.n, d), generator=gen, device="cuda")
            entries.append(plain_ell_entry(torch, graphops, f"{tag}/d={d}",
                                           g, X))
        del g
        torch.cuda.empty_cache()
    return entries


def fitter(torch, gl, labels, ti):
    """``fit(label, make) -> (pred, accuracy, model)``: one timed
    ``fit_predict``, printed."""
    def fit(label, make):
        m = make()
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred = m.fit_predict(ti, labels[ti])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        accuracy = gl.ssl.ssl_accuracy(pred, labels, ti)
        path = getattr(m, "path", None)
        say(f"  {label}: accuracy {accuracy:.4f} %, {m.iters} "
            f"{'sweeps' if path == 'band' else 'iterations'}, {secs:.3f} s")
        return pred, accuracy, m
    return fit


def fit_phase(torch, gl, accel, bs):
    from graphlearning_tpu_torch.ops import graphops

    say("== fits on two moons (n=65536, noise 0.1, k=10, 5 labels/class)")
    X, labels = two_moons(65536, 0.1, seed=0)
    t0 = time.perf_counter()
    W = gl.weightmatrix.knn(X, 10)
    say(f"  knn: {time.perf_counter() - t0:.2f} s, nnz {W.nnz}")
    ti = gl.trainsets.generate(labels, rate=5, seed=0)
    models = {name: (lambda name=name: FITS[name](gl, W))
              for name in ("laplace", "poisson_cg", "poisson_gd")}
    fit = fitter(torch, gl, labels, ti)

    # The host-side reordering and tile plans, once per graph; the fits
    # below find them in the cache on W (K1 builds the band in the first
    # fit of each path).
    for packed in (True, False):
        t = time.perf_counter()
        accel.maybe_build(W, device="cuda", packed=packed)
        say(f"  band plan ({'packed' if packed else 'unpacked'}, host): "
            f"{time.perf_counter() - t:.2f} s")

    # path A, the main path: packed band (K1 + K2)
    bs.reset_launches()
    band_fits = {name: fit(f"band/{name}", make)
                 for name, make in models.items()}
    band_path = {name: r[:2] for name, r in band_fits.items()}
    launches_a = bs.launches()
    say(f"  launches on the packed band path: {launches_a}")
    # path B, the fallback: unpacked tiles (K1 + K3)
    bs.reset_launches()
    with env("GLT_NO_PACKED", "1"):
        tiles_pred, _, tiles_m = fit("tiles/laplace", models["laplace"])
    launches_b = bs.launches()
    say(f"  launches on the unpacked fallback path: {launches_b}")
    # path C, the plain ELL: the kernel (plain_ell_spmm) at least once a
    # CG step of the Laplace and Poisson fits
    graphops.plain_ell_spmm.launches = 0
    with env("GLT_NO_ACCEL", "1"):
        plain_fits = {name: fit(f"plain/{name}", make)
                      for name, make in models.items()}
    plain = {name: r[:2] for name, r in plain_fits.items()}
    launches_c = graphops.plain_ell_spmm.launches
    steps_c = sum(plain_fits[name][2].iters
                  for name in ("laplace", "poisson_cg"))
    say(f"  plain ELL kernel launches on the plain path: {launches_c} "
        f"(CG steps {steps_c})")
    if launches_c < steps_c:
        raise SmokeFailure(f"the plain fits launched the plain ELL kernel "
                           f"{launches_c} times in {steps_c} CG steps")

    if launches_a["materialize_band_tiles"] < 1 \
            or launches_a["band_tiles_spmm_packed"] < 1:
        raise SmokeFailure(f"the fits did not take the band path: "
                           f"{launches_a}")
    if launches_b["materialize_band_tiles"] < 1 \
            or launches_b["band_tiles_spmm"] < 1:
        raise SmokeFailure(f"the fallback fit did not take the unpacked "
                           f"tiles: {launches_b}")
    # the exact f32 mode stays exact: its CG and GD iteration counts stay
    # within ITERS_MARGIN of the plain path's
    iters = [(f"band/{name}", m, name) for name, (_, _, m)
             in band_fits.items()] + [("tiles/laplace", tiles_m, "laplace")]
    for label, m, name in iters:
        ref_iters = plain_fits[name][2].iters
        if abs(m.iters - ref_iters) > ITERS_MARGIN * ref_iters:
            raise SmokeFailure(f"{label}: {m.iters} iterations against "
                               f"the plain path's {ref_iters}")
        say(f"  {label}: {m.iters} iterations, plain {ref_iters}")
    for name, (_, accuracy) in band_path.items():
        floor = REFERENCE_ACCURACY[name] - ACCURACY_MARGIN
        if accuracy < floor:
            raise SmokeFailure(f"{name} accuracy {accuracy:.2f} % < "
                               f"{floor:.2f} %")
    pairs = [(f"band/{n}", band_path[n][0], plain[n][0]) for n in models]
    pairs.append(("tiles/laplace", tiles_pred, plain["laplace"][0]))
    for label, pred, ref in pairs:
        agree = float(np.mean(pred == ref))
        say(f"  {label} agrees with the plain path on {agree:.4f}")
        if agree < 0.99:
            raise SmokeFailure(f"{label}: agreement {agree:.4f} < 0.99")

    say("== kernels at the fits' shapes")
    entries = []
    acc = accel.maybe_build(W, device="cuda")
    acc_u = accel.maybe_build(W, device="cuda", packed=False)
    check_solves(torch, gl, W, labels, ti, {"K2": acc, "K3": acc_u})
    entries.append(k1_entry(torch, bs, "fit/packed/float32",
                            acc.band_inputs(), torch.float32))
    entries.append(k1_entry(torch, bs, "fit/unpacked/float32",
                            acc_u.band_inputs(), torch.float32))
    gen = torch.Generator(device="cuda").manual_seed(1)
    csr = permuted_csr(torch, acc)
    for d, what in ((2, "laplace/poisson_cg"), (3, "poisson_gd")):
        Xd = torch.randn((acc.n_pad, d), generator=gen, device="cuda")
        entries.append(spmm_entry(
            torch, bs, "band_tiles_spmm_packed", f"fit/{what}/d={d}",
            acc.band(), acc.plan, Xd, lambda Xd=Xd: torch.sparse.mm(csr, Xd)))
    Xd = torch.randn((acc_u.n_pad, 2), generator=gen, device="cuda")
    entries.append(spmm_entry(
        torch, bs, "band_tiles_spmm", "fit/laplace/d=2", acc_u.band(),
        acc_u.plan, Xd, lambda: torch.sparse.mm(csr, Xd)))

    # the whole matvec of a CG iteration (band kernel + residual gather)
    # beside the plain ELL product of the same permuted graph
    for a, tag in ((acc, "packed band (K2)"), (acc_u, "unpacked band (K3)")):
        Xa = torch.randn((a.n_pad, 2), generator=gen, device="cuda")
        ms = time_ms(torch, lambda a=a, Xa=Xa: a.spmm(Xa))
        say(f"  whole matvec, d=2, {tag} + residual: {ms:.4f} ms (chain "
            f"{chain_ms(torch, lambda a=a, Xa=Xa: a.spmm(Xa)):.4f}), "
            f"{W.nnz / ms * 1e3:.4g} edges/s")
    Xa = torch.randn((acc.n_pad, 2), generator=gen, device="cuda")
    ms = time_ms(torch, lambda: graphops.spmm(acc.g, Xa))
    say(f"  whole matvec, d=2, plain ELL gather: {ms:.4f} ms (chain "
        f"{chain_ms(torch, lambda: graphops.spmm(acc.g, Xa)):.4f}), "
        f"{W.nnz / ms * 1e3:.4g} edges/s")
    launches = {"materialize_band_tiles":
                launches_a["materialize_band_tiles"],
                "band_tiles_spmm_packed": launches_a["band_tiles_spmm_packed"],
                "band_tiles_spmm": launches_b["band_tiles_spmm"],
                "plain_ell_spmm": launches_c}
    return entries, launches, (W, X, labels, ti,
                               {name: pred for name, (pred, _) in plain.items()})


def check_accuracy(name, accuracy):
    floor = REFERENCE_ACCURACY[name] - ACCURACY_MARGIN
    if accuracy < floor:
        raise SmokeFailure(f"{name} accuracy {accuracy:.4f} % < {floor:.4f} %")


def check_agreement(label, pred, ref, limit, against="the plain path"):
    agree = float(np.mean(pred == ref))
    say(f"  {label} agrees with {against} on {agree:.4f}")
    if agree < limit:
        raise SmokeFailure(f"{label}: agreement {agree:.4f} < {limit}")


def check_cap(label, m, cap):
    if m.iters >= cap:
        raise SmokeFailure(f"{label} reached its cap of {cap} iterations")


def distance_phase(torch, gl, accel, bs, W, labels, ti):
    """The distance and Lipschitz path (counts from 0 around it), then its
    plain-path references and its kernels at these shapes."""
    from graphlearning_tpu_torch.solvers import plaplace as pl

    say("== distance and Lipschitz path (the same moons graph)")
    fit = fitter(torch, gl, labels, ti)
    G = gl.graph(W)
    t = time.perf_counter()
    # one f32 band plan serves the distances and the Lipschitz fits
    acc = G._accel_exact()
    say(f"  band plan (f32, host): {time.perf_counter() - t:.2f} s")
    if acc is None:
        raise SmokeFailure("the distance path has no band plan")
    n = W.shape[0]
    C = 2
    mask = np.zeros(n, bool)
    mask[ti] = True
    gvals = np.zeros((n, C))
    gvals[ti] = np.eye(C)[labels[ti]]
    alpha = 1.0 / 9.0                          # p = 10, as ssl.plaplace
    calls = {
        "dijkstra": lambda G: G.dijkstra(ti, bdy_val=0, return_cp=True),
        "dijkstra_recip": lambda G: G.dijkstra(ti, bdy_val=0, return_cp=True,
                                               reciprocal_weights=True),
        "dijkstra_hl": lambda G: G.dijkstra_hl(ti, bdy_val=0,
                                               return_cp=True),
    }

    # the path of this slice, with the launch counts from 0
    bs.reset_launches()
    dist = {}
    for label, call in calls.items():
        n0 = bs.band_tiles_minplus.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        dist[label] = call(G)
        torch.cuda.synchronize()
        say(f"  band/{label}: {time.perf_counter() - t:.3f} s, "
            f"{bs.band_tiles_minplus.launches - n0} K7 launches "
            "(rounds + 1)")
    lip = {name: fit(f"band/{name}", lambda name=name: FITS[name](gl, W))
           for name in ("plaplace", "amle")}
    torch.cuda.synchronize()
    t = time.perf_counter()
    u_k9, rounds = acc.lip_iterate_mc(np.zeros((n, C)), mask, gvals, alpha,
                                      1.0 - alpha, 0.0, K9_ROUNDS)
    torch.cuda.synchronize()
    say(f"  band/lip_iterate_mc (K9, C={C}, from zeros): {rounds} rounds, "
        f"{time.perf_counter() - t:.3f} s")
    launches = bs.launches()
    say(f"  launches on the distance and Lipschitz path: {launches}")
    for name in ("materialize_band_tiles", "band_tiles_minplus",
                 "band_tiles_spmm_packed", "materialize_band",
                 "band_tiles_lip"):
        if launches[name] < 1:
            raise SmokeFailure(f"the distance and Lipschitz path did not "
                               f"launch {name}: {launches}")
    for name, (_, accuracy, m) in lip.items():
        if m.path != "band":
            raise SmokeFailure(f"{name} did not take the band path")
        check_cap(name, m, LIP_MAX_NUM_IT)
        check_accuracy(name, accuracy)
        info = m.info
        say(f"  {name}: warm start {info['init_iters']} CG iterations; "
            f"block-Gauss-Seidel {info['iters']} sweeps in "
            f"{info['sweep_seconds']:.3f} s, "
            f"{info['sweep_seconds'] / info['iters'] * 1e3:.2f} ms a sweep")

    # the plain path: the same calls with the band off
    with env("GLT_NO_ACCEL", "1"):
        G2 = gl.graph(W)
        for label, call in calls.items():
            torch.cuda.synchronize()
            t = time.perf_counter()
            d_p, cp_p = call(G2)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            ndiff = check_distances(label, dist[label], (d_p, cp_p), G2)
            say(f"  plain/{label}: {secs:.3f} s; band distances within "
                f"1e-5 relative, {ndiff} closest points differ between "
                "equidistant seeds")
        gnn_pred, gnn_acc, m = fit("plain/graph_nn",
                                   lambda: FITS["graph_nn"](gl, W))
        check_accuracy("graph_nn", gnn_acc)
        check_agreement("band/dijkstra Voronoi labels (graph NN)",
                        labels[dist["dijkstra"][1]], gnn_pred, 0.999)
        for name in ("plaplace", "amle"):
            pred, _, m = fit(f"plain/{name}",
                             lambda name=name: FITS[name](gl, W))
            check_cap(f"plain/{name}", m, LIP_MAX_NUM_IT)
            check_agreement(f"band/{name}", lip[name][0], pred, 0.99)
        _, peik_acc, m = fit("plain/peikonal",
                             lambda: FITS["peikonal"](gl, W))
        check_cap("plain/peikonal", m, PEIKONAL_MAX_NUM_IT)
        check_accuracy("peikonal", peik_acc)
    g = G.sparse
    u_pl, _ = pl._lip_iterate_mc(
        g, torch.zeros((n, C), device="cuda"),
        torch.as_tensor(mask, device="cuda"),
        torch.as_tensor(gvals, dtype=torch.float32, device="cuda"), alpha,
        1.0 - alpha, 0.0, K9_ROUNDS)
    if not np.allclose(u_k9.cpu().numpy(), u_pl.cpu().numpy(), rtol=2e-3,
                       atol=2e-4):
        raise SmokeFailure("lip_iterate_mc (K9) differs from the plain "
                           "_lip_iterate_mc beyond rtol 2e-3, atol 2e-4")
    say(f"  lip_iterate_mc agrees with plain _lip_iterate_mc after "
        f"{K9_ROUNDS} rounds: max|diff| "
        f"{float((u_k9 - u_pl).abs().max()):.3e}")

    say("== K4, K7, K9 at the shapes of this path")
    entries = []
    d_p = acc.to_perm(torch.as_tensor(np.minimum(dist["dijkstra"][0], 1e30),
                                      dtype=torch.float32, device="cuda"),
                      fill=bs.MINPLUS_BIG)
    f_p = acc.to_perm(torch.ones(n, device="cuda"))
    band, plan = acc.tiles_band(), acc.tiles_plan
    _, list_ms = list_build_ms(torch, bs, band, plan, "fit/float32")
    chunks = acc.live_chunks(band)          # the list the path ran on
    coo = coo_of(torch, acc)
    # the variants the path launches: each fit's rounds without the
    # argmin, then one with it
    for hopf, recip in ((False, False), (False, True), (True, False)):
        for track in (True, False):
            tag = ("hopf_lax" if hopf else "recip" if recip else "plain") \
                + ("/arg" if track else "")
            entries.append(k7_entry(
                torch, bs, f"fit/float32/{tag}", band, plan, chunks, d_p,
                f_p, hopf, recip, track, None if hopf else coo, list_ms))
    U = acc.to_perm(u_k9.contiguous())
    csr = permuted_csr(torch, acc)
    entries.append(k9_entry(torch, bs, "fit/float32/C=2", band, plan,
                            chunks, U, csr, list_ms))
    U = torch.randn((acc.n_pad, 10), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(9))
    entries.append(k9_entry(torch, bs, "fit/float32/C=10", band, plan,
                            chunks, U, csr, list_ms))
    del coo, csr
    for dt in (torch.bfloat16, torch.float32):
        entries.append(k4_entry(torch, bs, f"fit/{str(dt).split('.')[-1]}",
                                acc, dt))
    return entries, {k: launches[k] for k in ("materialize_band",
                                              "band_tiles_minplus",
                                              "band_tiles_lip")}


def mbo_fit(torch, gl, label, make, labels, ti):
    """One timed ``fit_predict`` of an MBO phase fit, printed with its
    seconds, rounds (PoissonMBO's T; VolumeMBO's iterations and its
    Voronoi start's rounds; CG iterations) and path.  Returns ``(pred,
    accuracy, model)``."""
    from graphlearning_tpu_torch.ops import accel

    m = make()
    torch.cuda.synchronize()
    t = time.perf_counter()
    pred = m.fit_predict(ti, labels[ti])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    accuracy = gl.ssl.ssl_accuracy(pred, labels, ti)
    if isinstance(m, gl.ssl.poisson_mbo):
        rounds = (f"{m.T} rounds of {m.Ns} heat steps after "
                  f"{m.poisson_model.iters} Poisson CG iterations")
    elif isinstance(m, gl.ssl.volume_mbo):
        rounds = (f"{m.iters} MBO iterations after a {m.voronoi_info['path']}"
                  f" Voronoi start of {m.voronoi_info['iters']} rounds")
    else:
        rounds = f"{m.iters} CG iterations"
    say(f"  {label}: accuracy {accuracy:.4f} %, {rounds}, {secs:.3f} s, "
        f"{accel.path_name(mbo_accel(m))}")
    return pred, accuracy, m


def mbo_accel(m):
    """The accel an MBO phase fit ran on (None on the plain path)."""
    if hasattr(m, "_reweight_G"):
        W = m._reweight_G.weight_matrix
        cache = getattr(W, "_gltt_accel_cache", None) or {}
        live = [a for a in cache.values() if hasattr(a, "spmm")]
        return live[0] if live else None
    acc = getattr(m, "_accel_mbo", getattr(m, "_accel_vmbo", None))
    return acc if hasattr(acc, "spmm") else None


def check_counts(label, m, pred):
    """VolumeMBO's class counts within its bounds."""
    counts = np.bincount(pred, minlength=len(m.class_counts))
    vc = m.volume_constraint
    lower = np.floor(vc * m.class_counts)
    upper = np.ceil((2 - vc) * m.class_counts)
    if np.any(counts < lower) or np.any(counts > upper):
        raise SmokeFailure(f"{label}: class counts {counts.tolist()} "
                           f"outside [{lower.tolist()}, {upper.tolist()}]")
    say(f"  {label}: class counts {counts.tolist()} within "
        f"[{lower.tolist()}, {upper.tolist()}]")


def check_gumbel(torch):
    """VolumeMBO's noise on the card, which its temperature-0.1 fit on the
    moons cannot show (the noise there moves no label): ``volume.gumbel``
    on a CUDA generator draws the same 2^22 values from one seed and
    others from another, finite, with Gumbel's mean (Euler's constant)
    within 0.01 and variance (pi^2 / 6) within 0.03, about 16 and 18 of
    their standard errors."""
    from graphlearning_tpu_torch.solvers import volume

    def draws(seed):
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return volume.gumbel(gen, torch.float32)((1 << 22,))

    a, b, c = draws(0), draws(0), draws(1)
    if not bool(torch.isfinite(a).all()):
        raise SmokeFailure("volume.gumbel: a non-finite draw")
    if not torch.equal(a, b):
        raise SmokeFailure("volume.gumbel: one seed, two different draws")
    same = float((a == c).double().mean())
    if same > 1e-3:
        raise SmokeFailure(f"volume.gumbel: seeds 0 and 1 agree on {same} "
                           "of the draws")
    mean, var = float(a.double().mean()), float(a.double().var())
    if (abs(mean - 0.5772156649015329) > 0.01
            or abs(var - math.pi ** 2 / 6) > 0.03):
        raise SmokeFailure(f"volume.gumbel: mean {mean:.5f}, variance "
                           f"{var:.5f}, not Gumbel's 0.57722 and 1.64493")
    say(f"  volume.gumbel on the card: seed 0 twice identical, seed 1 "
        f"agrees on {same} of 2^22; mean {mean:.5f} (0.57722), variance "
        f"{var:.5f} (1.64493)")


def mbo_phase(torch, gl, accel, bs, W, X, labels, ti):
    """Phase 4b: PoissonMBO, VolumeMBO (temperature 0, and 0.1 twice with
    seed 0) and the reweighted Laplace fits on the moons graph through the
    public entry points, on the band (the launch counts from 0 around
    them) and on the plain path; then PoissonMBO and VolumeMBO on the
    ten-cluster input through the gather and under ``GLT_NO_GATHER``; then
    K2 bf16 at the MBO fits' shape.  Returns ``(entries, launches)``."""
    from graphlearning_tpu_torch import bench

    say("== MBO and reweighted Laplace fits (the same moons graph)")
    t0 = time.perf_counter()
    priors = gl.utils.class_priors(labels)
    make = lambda name, gl=gl, W=W: (
        lambda: MBO_FITS[name](gl, W, priors, X))
    k2 = bs.band_tiles_spmm_packed
    bs.reset_launches()
    band = {}
    for name in MBO_FITS:
        n2 = k2.bf16_launches
        band[name] = mbo_fit(torch, gl, f"band/{name}", make(name), labels,
                             ti)
        if name == "poisson_mbo":
            m = band[name][2]
            heat = k2.bf16_launches - n2
            if heat < m.T * m.Ns:
                raise SmokeFailure(f"band/poisson_mbo: {heat} K2 launches "
                                   f"on the bf16 band, not the "
                                   f"{m.T * m.Ns} heat steps")
    again = mbo_fit(torch, gl, "band/volume_mbo_t0.1 (again)",
                    make("volume_mbo_t0.1"), labels, ti)
    launches = bs.launches()
    # the heat steps and dual convolutions: K2 on the bf16 band, at d=2
    k2_bf16 = k2.bf16_launches
    say(f"  launches on the MBO band path: {launches}, of them K2 on the "
        f"bf16 band {k2_bf16}")
    for name in ("materialize_band_tiles", "band_tiles_minplus"):
        if launches[name] < 1:
            raise SmokeFailure(f"the MBO band path did not launch {name}: "
                               f"{launches}")
    if k2_bf16 < 1:
        raise SmokeFailure("the MBO band path did not launch K2 on the "
                           "bf16 band")
    if not np.array_equal(band["volume_mbo_t0.1"][0], again[0]):
        raise SmokeFailure("band/volume_mbo_t0.1: two fits with seed 0 "
                           "differ")
    say("  band/volume_mbo_t0.1: the two seed-0 fits are identical")
    check_gumbel(torch)
    with env("GLT_NO_ACCEL", "1"):
        plain = {name: mbo_fit(torch, gl, f"plain/{name}", make(name),
                               labels, ti) for name in MBO_FITS}
    for name, (pred, _, m) in band.items():
        ref, _, mp = plain[name]
        acc = mbo_accel(m)
        if not isinstance(acc, accel.AccelSpMM):
            raise SmokeFailure(f"band/{name} ran on {accel.path_name(acc)}, "
                               "not the band")
        if name in MBO_AGREEMENT and acc.mode != "bf16":
            raise SmokeFailure(f"band/{name}: a {acc.mode} band, not bf16")
        check_agreement(f"band/{name}", pred, ref,
                        MBO_AGREEMENT.get(name, 0.99))
        if isinstance(m, gl.ssl.volume_mbo):
            check_counts(f"band/{name}", m, pred)
            check_counts(f"plain/{name}", mp, ref)
    for path, fits in (("band", band), ("plain", plain)):
        for name, (_, accuracy, _) in fits.items():
            ref = MBO_REFERENCE[name]
            margin = MBO_MARGIN.get(name, ACCURACY_MARGIN)
            if abs(accuracy - ref) > margin:
                raise SmokeFailure(f"{path}/{name}: accuracy {accuracy:.4f} "
                                   f"% against JAX's {ref:.4f} % (float32), "
                                   f"limit {margin} points")

    say("== PoissonMBO and VolumeMBO on the ten-cluster input (n=70000, "
        "20-d, k=10, one label a class)")
    W10, y10, ti10 = bench.ten_cluster_case(70000, 10, "cuda")
    priors10 = gl.utils.class_priors(y10)
    make10 = lambda name: (lambda: MBO_FITS[name](gl, W10, priors10, None))
    ten = {}
    for name in ("poisson_mbo", "volume_mbo"):
        ten[name] = mbo_fit(torch, gl, f"gather/{name}", make10(name), y10,
                            ti10)
        acc = mbo_accel(ten[name][2])
        if not isinstance(acc, accel.GatherAccel):
            raise SmokeFailure(f"ten clusters, {name}: maybe_build took "
                               f"{accel.path_name(acc)}, not the gather")
    if ten["volume_mbo"][2].voronoi_info["path"] != "gather":
        raise SmokeFailure("ten clusters: the Voronoi start did not run the "
                           "gather's bellman_ford")
    with env("GLT_NO_GATHER", "1"):
        for name in ("poisson_mbo", "volume_mbo"):
            ref, _, mp = mbo_fit(torch, gl, f"plain/{name}", make10(name),
                                 y10, ti10)
            if mbo_accel(mp) is not None:
                raise SmokeFailure(f"GLT_NO_GATHER: {name} took an accel")
            pred, _, m = ten[name]
            check_agreement(f"gather/{name} (ten clusters)", pred, ref,
                            MBO_AGREEMENT[name])
            if name == "volume_mbo":
                check_counts("gather/volume_mbo (ten clusters)", m, pred)
                check_counts("plain/volume_mbo (ten clusters)", mp, ref)
    del W10
    say(f"== the MBO phase: {time.perf_counter() - t0:.1f} s")

    say("== K2 bf16 at the MBO fits' shape")
    acc = mbo_accel(band["poisson_mbo"][2])
    gen = torch.Generator(device="cuda").manual_seed(4)
    csr = permuted_csr(torch, acc)
    Xd = torch.randn((acc.n_pad, 2), generator=gen, device="cuda")
    entry = spmm_entry(torch, bs, "band_tiles_spmm_packed",
                       "mbo/bfloat16/d=2", acc.band(), acc.plan,
                       Xd.to(torch.bfloat16),
                       lambda: torch.sparse.mm(csr, Xd))
    entry["launches"] = k2_bf16
    return [entry], launches


def eig_fits(torch, gl, W, num_clusters, fiedler):
    """``graph(W).eigen_decomp(normalization="normalized", k=10)``, with
    ``fiedler`` its ``fiedler_vector``, and ``clustering.spectral(W,
    num_clusters)`` on the same graph, each timed.  Returns ``(vals,
    fiedler value, labels, solves)``, ``solves`` the (label, LOBPCG steps,
    block width, path) of each solve."""
    G = gl.graph(W)
    out, solves = {}, []

    def timed(label, fn, key):
        cached = key in G.eigen_info
        torch.cuda.synchronize()
        t = time.perf_counter()
        out[label] = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        info = G.eigen_info[key]
        if cached:
            say(f"  {label}: {secs:.3f} s on the cached spectrum")
            return
        solves.append((label, info["iters"], key[2], info["path"]))
        say(f"  {label}: {info['iters']} LOBPCG steps, {secs:.3f} s, "
            f"{info['path']}")

    timed("eigen_decomp(k=10)", lambda: G.eigen_decomp(
        normalization="normalized", k=10), ("normalized", "exact", 10, None,
                                           0, 0, 1))
    if fiedler:
        timed("fiedler_vector", lambda: G.fiedler_vector(return_value=True),
              ("normalized", "exact", 2, None, 0, 1e-8, 1))
    timed(f"spectral(W, {num_clusters})", lambda: gl.clustering.spectral(
        G, num_clusters).fit_predict(), ("normalized", "exact",
                                         num_clusters, None, 0, 0, 1))
    vals_k, vecs_k = G.eigen_decomp(normalization="normalized",
                                    k=num_clusters)
    say(f"  spectral(W, {num_clusters}): residual norms |L v - lambda v| of "
        f"its eigenpairs (float64, host) "
        f"{residual_norms(W, vals_k, vecs_k).tolist()}")
    vals = out["eigen_decomp(k=10)"][0]
    lam2 = out["fiedler_vector"][1] if fiedler else None
    return vals, lam2, out[f"spectral(W, {num_clusters})"], solves


def residual_norms(W, vals, vecs):
    """``|L v - lambda v|`` of each unit eigenpair of the normalized
    Laplacian of ``W``, in float64 on the host."""
    import scipy.sparse as sp

    W = sp.csr_matrix(W, dtype=np.float64)
    s = np.asarray(W.sum(axis=1)).ravel() ** -0.5
    V = vecs.astype(np.float64)
    V = V / np.linalg.norm(V, axis=0)
    LV = V - s[:, None] * (W @ (s[:, None] * V))
    return np.linalg.norm(LV - V * vals.astype(np.float64)[None, :], axis=0)


def check_spectrum(label, vals, ref, tol):
    if vals.shape != ref.shape or not np.all(np.isfinite(vals)):
        raise SmokeFailure(f"{label}: eigenvalues of shape {vals.shape}, "
                           "or not finite")
    err = float(np.max(np.abs(vals - ref)))
    say(f"  {label}: max |lambda - lambda_eigsh| {err:.4e} (limit {tol:g})")
    if err > tol:
        raise SmokeFailure(f"{label}: eigenvalues {err:.4e} from eigsh's, "
                           f"limit {tol:g}")


def check_spectral(gl, label, pred, labels, case, ref_pred=None):
    """The accuracy at most ACCURACY_MARGIN under the case's target (eigsh's
    eigenvectors' accuracy where JAX's float32 solve stops early, else
    JAX's float32 accuracy) and, given the plain path's labels, the
    agreement with them."""
    ref = EIG_REFERENCE[case]
    target = ref.get("eigsh_accuracy", ref["accuracy"])
    accuracy = gl.clustering.clustering_accuracy(pred, labels)
    floor = target - ACCURACY_MARGIN
    say(f"  {label}: accuracy {accuracy:.4f} % (target {target:.4f} %; "
        f"JAX float32 {ref['accuracy']:.4f} %)")
    if accuracy < floor:
        raise SmokeFailure(f"{label}: accuracy {accuracy:.4f} % < "
                           f"{floor:.4f} %")
    if ref_pred is not None:
        agree = gl.clustering.clustering_accuracy(pred, ref_pred) / 100.0
        say(f"  {label} agrees with the plain path on {agree:.4f} up to a "
            "permutation")
        if agree < EIG_AGREEMENT[case]:
            raise SmokeFailure(f"{label}: agreement {agree:.4f} < "
                               f"{EIG_AGREEMENT[case]}")


def eig_phase(torch, gl, accel, bs, W, labels):
    """Phase 4c: the eigensolver and spectral clustering on the moons graph
    through the public entry points, on the band (a fresh copy of W, so
    the phase builds its band: K1, then K2 in every LOBPCG operator
    application; the launch counts from 0 around it) and under
    ``GLT_NO_ACCEL``, held to scipy's float64 eigsh and to each other;
    then spectral(W, 10) on the ten-cluster input on the gather and under
    ``GLT_NO_GATHER``; then K2 at LOBPCG's two widths on the moons band.
    Returns ``(entries, launches)``."""
    from graphlearning_tpu_torch import bench
    from graphlearning_tpu_torch.solvers import eig

    say("== eigensolver and spectral clustering (the same moons graph)")
    t0 = time.perf_counter()
    t = time.perf_counter()
    ref = eigsh_reference(W, 10)
    say(f"  eigsh (float64, host, {time.perf_counter() - t:.1f} s): "
        f"{ref.tolist()}")
    We = W.copy()
    We._glt_points = W._glt_points
    bs.reset_launches()
    vals_b, lam2_b, pred_b, solves = eig_fits(torch, gl, We, 2, True)
    launches = bs.launches()
    by_d = dict(bs.band_tiles_spmm_packed.launches_by_d)
    say(f"  launches on the eig band path: {launches}; K2 by X's columns: "
        f"{dict(sorted(by_d.items()))}")
    for label, _, _, path in solves:
        if path != "packed tiles (K2)":
            raise SmokeFailure(f"band/{label} ran on {path}")
    for name in ("materialize_band_tiles", "band_tiles_spmm_packed"):
        if launches[name] < 1:
            raise SmokeFailure(f"the eig band path did not launch {name}")
    # one K2 launch a product in LOBPCG's operator, its 8th power in f32:
    # p to check the start, p for the start, 2p a step, 1 for the Rayleigh
    # quotients
    p = eig._default_power(gl.config.float_dtype(gl.config.device()))
    want = sum(p + p + 2 * p * it + 1 for _, it, _, _ in solves)
    if launches["band_tiles_spmm_packed"] != want:
        raise SmokeFailure(f"K2 launched {launches['band_tiles_spmm_packed']}"
                           f" times, the solves' steps give {want}")
    with env("GLT_NO_ACCEL", "1"):
        vals_p, lam2_p, pred_p, _ = eig_fits(torch, gl, W, 2, True)
    check_spectrum("band/eigen_decomp", vals_b, ref, EIG_TOL["moons"])
    check_spectrum("plain/eigen_decomp", vals_p, ref, EIG_TOL["moons"])
    check_spectrum("band against plain", vals_b, vals_p, EIG_BAND_TOL)
    check_spectrum("band/fiedler value", np.array([lam2_b]), ref[1:2],
                   EIG_TOL["moons"])
    check_spectrum("fiedler value, band against plain", np.array([lam2_b]),
                   np.array([lam2_p]), EIG_BAND_TOL)
    check_spectral(gl, "band/spectral(W, 2)", pred_b, labels, "moons",
                   pred_p)
    check_spectral(gl, "plain/spectral(W, 2)", pred_p, labels, "moons")

    say("== spectral(W, 10) on the ten-cluster input (n=70000, 20-d, k=10)")
    W10, y10, _ = bench.ten_cluster_case(70000, 10, "cuda")
    t = time.perf_counter()
    ref10 = eigsh_reference(W10, 10, shift_invert=False)
    say(f"  eigsh (float64, host, {time.perf_counter() - t:.1f} s)")
    vals_g, _, pred_g, solves10 = eig_fits(torch, gl, W10, 10, False)
    if any("GatherAccel" not in path for _, _, _, path in solves10):
        raise SmokeFailure(f"ten clusters: not on the gather: {solves10}")
    with env("GLT_NO_GATHER", "1"):
        vals_q, _, pred_q, solves_q = eig_fits(torch, gl, W10, 10, False)
    if any(path != "plain ELL" for _, _, _, path in solves_q):
        raise SmokeFailure(f"GLT_NO_GATHER: {solves_q}")
    check_spectrum("gather/eigen_decomp", vals_g, ref10, EIG_TOL["ten"])
    check_spectrum("plain/eigen_decomp", vals_q, ref10, EIG_TOL["ten"])
    check_spectrum("gather against plain", vals_g, vals_q, EIG_BAND_TOL)
    check_spectral(gl, "gather/spectral(W, 10)", pred_g, y10, "ten", pred_q)
    check_spectral(gl, "plain/spectral(W, 10)", pred_q, y10, "ten")
    del W10
    say(f"== the eig phase: {time.perf_counter() - t0:.1f} s")

    say("== K2 at LOBPCG's widths on the moons band")
    acc = accel.maybe_build(We, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(5)
    csr = permuted_csr(torch, acc)
    entries = []
    for d in (12, 39):
        Xd = torch.randn((acc.n_pad, d), generator=gen, device="cuda")
        entry = spmm_entry(torch, bs, "band_tiles_spmm_packed",
                           f"eig/float32/d={d}", acc.band(), acc.plan, Xd,
                           lambda Xd=Xd: torch.sparse.mm(csr, Xd))
        # the K2 launches at this width in the band's solves, as counted
        entry["launches"] = by_d.get(d, 0)
        if entry["launches"] < 1:
            raise SmokeFailure(f"the eig band path launched no K2 at d={d}: "
                               f"{by_d}")
        entries.append(entry)
    return entries, launches


def while_calls(steps):
    """The body calls of ``solvers.volume._while`` for a loop whose
    condition held ``steps`` times: the host reads the condition after
    bursts of 1, 2, 4, ... then ``_CHECK_EVERY`` calls, so the last burst
    may run past the last step (its state frozen)."""
    from graphlearning_tpu_torch.solvers import volume

    calls, burst = 0, 1
    while calls < steps:
        calls += burst
        burst = min(2 * burst, volume._CHECK_EVERY)
    return calls


def lobpcg_launches(K, steps, p):
    """K2's launches by X's width in one LOBPCG solve of ``K`` vectors on
    the operator's ``p``-th power: ``p`` on one column to check the
    operator, ``p`` on the start, ``p`` a step on the ``3K`` columns ``[X,
    P, R]`` and ``p`` on the ``K`` of the residuals, and one for the
    Rayleigh quotients.  A launch covers 128 columns: wider X goes in
    several, each counted under X's width."""
    from graphlearning_tpu_torch.ops import band_spmm as bs

    per = lambda d: -(-d // bs._TILES_DMAX)
    return {1: p, 3 * K: per(3 * K) * p * steps,
            K: per(K) * (p * (1 + steps) + 1)}


def eig_graph(m):
    """The graph whose eigendata memo an SSL model of phase 4d reads: the
    zero-diagonal graph for the Poisson fits, else the model's."""
    if hasattr(m, "poisson_model"):
        m = m.poisson_model
    return m._nodiag_graph()[1] if hasattr(m, "solver") else m.graph


def p10b_fit(torch, gl, label, make, labels, ti=None):
    """One timed fit of phase 4d: an SSL model's ``fit_predict(ti, ...)``
    (its accuracy without the training nodes), or a clustering's
    ``fit_predict()`` when ``ti`` is None (its clustering accuracy).
    Returns ``(pred, accuracy, model)``."""
    from graphlearning_tpu_torch.ops import accel

    m = make()
    torch.cuda.synchronize()
    t = time.perf_counter()
    pred = m.fit_predict() if ti is None else m.fit_predict(ti, labels[ti])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    if ti is None:
        accuracy = gl.clustering.clustering_accuracy(pred, labels)
        what = ""
        if hasattr(m, "steps"):      # INCRES
            what = (f"{sum(m.steps)} grow steps in {len(m.steps)} rounds "
                    f"(first {m.steps[:3]}, last {m.steps[-3:]}), "
                    f"{accel.path_name(getattr(m, '_accel_incres', None))}")
    else:
        accuracy = gl.ssl.ssl_accuracy(pred, labels, ti)
        solves = [f"{info['iters']} LOBPCG steps at k={key[2]} "
                  f"({info['path']})"
                  for key, info in eig_graph(m).eigen_info.items()]
        what = "; ".join(solves) or (
            f"{m.iters} iterations, "
            f"{accel.path_name(getattr(m, '_accel_ck', None))}")
    say(f"  {label}: accuracy {accuracy:.4f} %, {secs:.3f} s, {what}")
    return pred, accuracy, m


def p10b_fits(torch, gl, W, labels, ti, k, tag, modularity=True):
    """The fits of phase 4d on ``W``: P10B_FITS (Modularity MBO only with
    ``modularity``) and INCRES with ``k`` clusters, seed 0.  Returns
    ``{name: (pred, accuracy, model)}``."""
    priors = gl.utils.class_priors(labels)
    out = {}
    for name, make in P10B_FITS.items():
        if name == "modularity_mbo" and not modularity:
            continue
        out[name] = p10b_fit(torch, gl, f"{tag}/{name}",
                             lambda make=make: make(gl, W, priors), labels,
                             ti)
    out["incres"] = p10b_fit(torch, gl, f"{tag}/incres", lambda: (
        gl.clustering.incres(W, k, seed=0)), labels)
    return out


def check_p10b(gl, case, fits, ref_fits=None):
    """Each fit's accuracy against its target less its margin
    (P10B_MARGIN; the eigsh target on the moons for the fits of
    P10B_EIGSH, else JAX's float32, INCRES's JAX's mean) and, given the
    plain path's fits, their agreement (P10B_AGREEMENT; up to a
    permutation for INCRES)."""
    ref = P10B_REFERENCE[case]
    for name, (pred, accuracy, _) in fits.items():
        target = ref.get(f"{name}_eigsh", ref[name])
        margin = P10B_MARGIN[case].get(name, ACCURACY_MARGIN)
        say(f"  {case}/{name}: accuracy {accuracy:.4f} % (target "
            f"{target:.4f} %, less {margin:.4g}; JAX float32 {ref[name]:.4f} %)")
        if accuracy < target - margin:
            raise SmokeFailure(f"{case}/{name}: accuracy {accuracy:.4f} % < "
                               f"{target - margin:.4f} %")
        if ref_fits is None or name not in ref_fits:
            continue
        other = ref_fits[name][0]
        agree = (gl.clustering.clustering_accuracy(pred, other) / 100.0
                 if name == "incres" else float(np.mean(pred == other)))
        limit = P10B_AGREEMENT[case].get(name, 0.99)
        say(f"  {case}/{name} agrees with the plain path on {agree:.4f}")
        if agree < limit:
            raise SmokeFailure(f"{case}/{name}: agreement {agree:.4f} < "
                               f"{limit}")


def determinism_checks(torch, gl, W, labels, ti):
    """The plain Poisson GD fit twice (and once on the scatter-add
    ``spmm_t`` this PR replaced, for its seconds), and personalized
    PageRank twice: bit-equal, and PageRank allclose to scipy's float64
    power iteration run for the same steps."""
    import scipy.sparse as sp

    from graphlearning_tpu_torch.ops import graphops
    from graphlearning_tpu_torch.solvers import pagerank

    def scatter_spmm_t(g, X):
        X2 = X[:, None] if X.dim() == 1 else X
        contrib = g.vals.to(X2.dtype)[:, :, None] * X2[:, None, :]
        out = torch.zeros_like(X2)
        out.index_add_(0, g.cols.reshape(-1), contrib.reshape(g.n * g.k, -1))
        return out[:, 0] if X.dim() == 1 else out

    say("== determinism: the plain Poisson GD fit and PageRank")
    gd = lambda: FITS["poisson_gd"](gl, W)
    with env("GLT_NO_ACCEL", "1"):
        runs = [p10b_fit(torch, gl, f"plain/poisson_gd, run {i}", gd,
                         labels, ti)[2].prob for i in (1, 2)]
        new = graphops.spmm_t
        graphops.spmm_t = scatter_spmm_t
        try:
            old = [p10b_fit(torch, gl, f"plain/poisson_gd on the scatter-add "
                            f"spmm_t, run {i}", gd, labels, ti)[2].prob
                   for i in (1, 2)]
        finally:
            graphops.spmm_t = new
    if not np.array_equal(runs[0], runs[1]):
        raise SmokeFailure("plain/poisson_gd: two fits differ")
    say(f"  plain/poisson_gd: the two fits are bit-equal; on the scatter-add "
        f"spmm_t the two fits are {'' if np.array_equal(*old) else 'not '}"
        f"bit-equal (max |diff| {np.abs(old[0] - old[1]).max():.3e})")

    G = gl.graph(W)
    v = np.zeros(W.shape[0])
    v[ti] = 1.0 / len(ti)
    info = {}
    pr = [pagerank.page_rank(G.sparse, v=v, info=info).cpu().numpy()
          for _ in range(2)]
    if not np.array_equal(pr[0], pr[1]):
        raise SmokeFailure("page_rank: two runs differ")
    deg = np.asarray(W.sum(axis=1)).ravel()
    WT = sp.csr_matrix(W, dtype=np.float64).T.tocsr()
    u = np.full(W.shape[0], 1.0 / W.shape[0])
    for _ in range(info["iters"]):
        u = 0.85 * (WT @ (u / deg)) + 0.15 * v
    err = float(np.abs(pr[0] - u).max())
    say(f"  page_rank (personalized to the {len(ti)} labels): bit-equal in "
        f"two runs, {info['iters']} steps, max |u - u_scipy| {err:.3e} "
        f"(max u {u.max():.3e}), sum {pr[0].sum():.6f}")
    if err > PAGERANK_TOL * u.max():
        raise SmokeFailure(f"page_rank: {err:.3e} from scipy's float64 "
                           f"iteration, limit {PAGERANK_TOL:g} of max u")
    if gl.graph(W).page_rank().shape != (W.shape[0],):
        raise SmokeFailure("graph.page_rank: wrong shape")


def fokker_planck_check(torch, gl):
    """Fokker-Planck on two moons cut to FP_N nodes: its float32 matrix
    exponential against the float64 one on the card, and its accuracy."""
    Xf, yf = two_moons(FP_N, 0.1, seed=0)
    Wf = gl.weightmatrix.knn(Xf, 10)
    make = lambda: gl.clustering.fokker_planck(Wf, 2, seed=0)
    Q = torch.as_tensor(make().generator().toarray(), device="cuda")
    with gl.config.exact_matmul():
        e32 = torch.linalg.matrix_exp(Q.float()).double()
    e64 = torch.linalg.matrix_exp(Q)
    err = float((e32 - e64).abs().max() / e64.abs().max())
    say(f"  fokker_planck n={FP_N}: expm float32 against float64 on the "
        f"card, max |err| {err:.3e} of max|expm|")
    if not math.isfinite(err) or err > FP_EXPM_TOL:
        raise SmokeFailure(f"fokker_planck: expm error {err:.3e} > "
                           f"{FP_EXPM_TOL:g}")
    pred, accuracy, _ = p10b_fit(torch, gl, f"fokker_planck (n={FP_N})",
                                 make, yf)
    target = P10B_REFERENCE["fokker_planck"]
    if accuracy < target - ACCURACY_MARGIN:
        raise SmokeFailure(f"fokker_planck: accuracy {accuracy:.4f} % < "
                           f"{target - ACCURACY_MARGIN:.4f} %")


def p10b_phase(torch, gl, accel, bs, W, labels, ti):
    """Phase 4d: the eigenbasis SSL models, the centered kernel method,
    INCRES, PageRank and Fokker-Planck through the public entry points.
    The determinism checks; then on a fresh copy of the moons graph the
    fits on the band (the launch counts from 0 around them, held to the
    fits' formulas) and under ``GLT_NO_ACCEL``; Multiclass MBO's
    eigenvalues against scipy's float64 eigsh; the ten-cluster input on
    the gather and under ``GLT_NO_GATHER``; Fokker-Planck; then K2 at the
    new widths.  Returns ``(entries, launches)``."""
    from graphlearning_tpu_torch import bench
    from graphlearning_tpu_torch.solvers import eig

    t0 = time.perf_counter()
    determinism_checks(torch, gl, W, labels, ti)

    say("== eigenbasis models, centered kernel and INCRES (the moons graph)")
    We = W.copy()
    We._glt_points = W._glt_points
    bs.reset_launches()
    band = p10b_fits(torch, gl, We, labels, ti, 2, "band", modularity=False)
    launches = bs.launches()
    k2 = bs.band_tiles_spmm_packed
    by_d = dict(k2.launches_by_d)
    say(f"  launches on the band: {launches}; K2 by X's columns "
        f"{dict(sorted(by_d.items()))}, on the bf16 band {k2.bf16_launches}")
    with env("GLT_NO_ACCEL", "1"):
        plain = p10b_fits(torch, gl, W, labels, ti, 2, "plain")

    # the launches each fit's loops make, against the counts
    p = eig._default_power(torch.float32)
    want = {}

    def add(counts):
        for d, c in counts.items():
            want[d] = want.get(d, 0) + c

    for name, K in (("poisson_spectral", 14), ("multiclass_mbo", 57)):
        (info,) = eig_graph(band[name][2]).eigen_info.values()
        if info["path"] != "packed tiles (K2)":
            raise SmokeFailure(f"band/{name}: its eigensolve ran on "
                               f"{info['path']}")
        add(lobpcg_launches(K, info["iters"], p))
    ck = band["centered_kernel"][2]
    if not isinstance(getattr(ck, "_accel_ck", None), accel.AccelSpMM):
        raise SmokeFailure("band/centered_kernel: not on the band")
    add({1: ck.power_it + 1, 2: while_calls(ck.iters)})
    mbo = band["poisson_mbo_spectral"][2]
    inc = band["incres"][2]
    if inc._accel_incres.mode != "bf16" or mbo._accel_mbo.mode != "bf16":
        raise SmokeFailure("band: INCRES or PoissonMBO not on the bf16 band")
    bf16 = mbo.T * mbo.Ns + sum(while_calls(s) for s in inc.steps)
    add({2: bf16})
    if by_d != want or k2.bf16_launches != bf16:
        raise SmokeFailure(f"K2 launches {by_d} (bf16 {k2.bf16_launches}), "
                           f"the fits' loops give {want} (bf16 {bf16})")
    if launches["materialize_band_tiles"] != 2:
        raise SmokeFailure(f"K1 built {launches['materialize_band_tiles']} "
                           "bands, not the f32 and the bf16 band")
    say(f"  K2 launches as the fits' loops give them: {want}, bf16 {bf16}")
    check_p10b(gl, "moons", band, plain)
    check_p10b(gl, "moons", plain)

    t = time.perf_counter()
    ref50 = eigsh_reference(W, 50)
    say(f"  eigsh k=50 (float64, host, {time.perf_counter() - t:.1f} s)")
    for tag, fits in (("band", band), ("plain", plain)):
        G = fits["multiclass_mbo"][2].graph
        vals, _ = G.eigen_decomp(normalization="normalized", k=50)
        err = np.abs(vals.astype(np.float64) - ref50)
        say(f"  {tag}/multiclass_mbo eigenvalues (k=50): max |lambda - "
            f"lambda_eigsh| {err.max():.4e} at "
            f"{int(err.argmax())}, first ten {err[:10].max():.4e}")
        if err.max() > MULTICLASS_EIG_TOL:
            raise SmokeFailure(f"{tag}/multiclass_mbo: eigenvalues "
                               f"{err.max():.4e} from eigsh's, limit "
                               f"{MULTICLASS_EIG_TOL:g}")

    say("== the same on the ten-cluster input (n=70000, 20-d, k=10)")
    W10, y10, ti10 = bench.ten_cluster_case(70000, 10, "cuda")
    # the gather's fits on a copy: the eigendata memo rides on the graph
    gather = p10b_fits(torch, gl, W10.copy(), y10, ti10, 10, "gather")
    for name, (_, _, m) in gather.items():
        if name == "modularity_mbo":          # the plain path by design
            continue
        if name in ("centered_kernel", "incres"):
            acc = getattr(m, "_accel_ck", None) or m._accel_incres
            paths = [accel.path_name(acc)]
        else:
            paths = [i["path"] for i in eig_graph(m).eigen_info.values()]
        if not all("GatherAccel" in path for path in paths):
            raise SmokeFailure(f"ten clusters, {name}: on {paths}, not the "
                               "gather")
    with env("GLT_NO_GATHER", "1"):
        plain10 = p10b_fits(torch, gl, W10, y10, ti10, 10, "plain",
                            modularity=False)
    check_p10b(gl, "ten", gather, plain10)
    check_p10b(gl, "ten", plain10)
    del W10
    fokker_planck_check(torch, gl)
    say(f"== phase 4d: {time.perf_counter() - t0:.1f} s")

    say("== K2 at the widths of phase 4d on the moons band")
    acc = accel.maybe_build(We, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(6)
    csr = permuted_csr(torch, acc)
    entries = []
    for d in (1, 14, 42, 57, 171):
        Xd = torch.randn((acc.n_pad, d), generator=gen, device="cuda")
        entry = spmm_entry(torch, bs, "band_tiles_spmm_packed",
                           f"p10b/float32/d={d}", acc.band(), acc.plan, Xd,
                           lambda Xd=Xd: torch.sparse.mm(csr, Xd))
        entry["launches"] = by_d.get(d, 0)
        entries.append(entry)
    return entries, launches


@contextlib.contextmanager
def store_dirs(gl, root):
    """Every store directory of the port (datasets, train sets, kNN data,
    trial results) under ``root`` inside the block."""
    attrs = [(gl.datasets, "data_dir"), (gl.trainsets, "trainset_dir"),
             (gl.weightmatrix, "knn_dir"), (gl.ssl, "results_dir")]
    old = [getattr(mod, a) for mod, a in attrs]
    for mod, a in attrs:
        setattr(mod, a, os.path.join(root, a))
    try:
        yield
    finally:
        for (mod, a), v in zip(attrs, old):
            setattr(mod, a, v)


def timed(torch, label, fn):
    """``fn()``, its seconds printed under ``label``."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    say(f"  {label}: {time.perf_counter() - t:.3f} s")
    return out


def check_target(label, accuracy, target, margin=ACCURACY_MARGIN):
    say(f"  {label}: accuracy {accuracy:.4f} % (JAX float32 {target:.4f} %, "
        f"less {margin:g})")
    if accuracy < target - margin:
        raise SmokeFailure(f"{label}: accuracy {accuracy:.4f} % < "
                           f"{target - margin:.4f} %")


def harness_ten(torch, gl, root):
    """Phase 4e on the ten-cluster input: the round trips through the
    dataset, kNN and train-set files, ``ssl_trials`` of Laplace and
    Poisson learning over the trials (batched by rate), their statistics
    and table, one trial a rate against its sequential fit on the plain
    path, and sparse label propagation twice.  Returns the plain ELL
    kernel's launches in Poisson's ``ssl_trials``, at least one a CG step
    of each batch (the batches' products run on the plain ELL)."""
    from graphlearning_tpu_torch import bench
    from graphlearning_tpu_torch.ops import graphops

    pts, y = bench.ten_cluster_points(70000)
    data, lab = timed(torch, "datasets.save / load", lambda: (
        gl.datasets.save(pts, y, "TenClusters"),
        gl.datasets.load("tenclusters"))[1])
    if not (np.array_equal(data, pts) and np.array_equal(lab, y)):
        raise SmokeFailure("datasets: the loaded data differ from the saved")
    timed(torch, "knnsearch(..., dataset=)", lambda: gl.weightmatrix.knnsearch(
        data, 11, dataset="TenClusters"))
    W = timed(torch, "knn(name, 10)",
              lambda: gl.weightmatrix.knn("TenClusters", 10))
    Wp = timed(torch, "knn(points, 10)", lambda: gl.weightmatrix.knn(pts, 10))
    if W.nnz != Wp.nnz or abs(W - Wp).max() != 0:
        raise SmokeFailure("knn of the stored kNN data differs from knn of "
                           "the points")
    made = timed(torch, "trainsets.generate(..., dataset=, trainset_name=)",
                 lambda: trial_sets(gl, lab, dataset="TenClusters"))
    trials = timed(torch, "trainsets.load", lambda: [
        np.asarray(t, dtype=int) for r in TRIAL_RATES
        for t in gl.trainsets.load("TenClusters", f"_rate{r}")])
    if len(trials) != len(made) or not all(
            np.array_equal(a, b) for a, b in zip(trials, made)):
        raise SmokeFailure("trainsets: the loaded trials differ")
    say(f"  {len(trials)} trials of {sorted({len(t) for t in trials})} "
        f"labels, W nnz {W.nnz}")

    models = []
    for name in ("laplace", "poisson"):
        m = getattr(gl.ssl, name)(W)
        preds, batched, steps = {}, m.fit_predict_batched, []

        def record(ts, labels, batched=batched, preds=preds, steps=steps):
            out = batched(ts, labels)
            preds.update({np.asarray(t).tobytes(): p
                          for t, p in zip(ts, out)})
            steps.append(int(np.max(m.iters)))
            say(f"  {name}: {len(ts)} trials of {len(ts[0])} labels in one "
                f"batch, CG steps {np.asarray(m.iters).tolist()}")
            return out

        m.fit_predict_batched = record
        graphops.plain_ell_spmm.launches = 0
        rows = timed(torch, f"{name}.ssl_trials ({len(trials)} trials)",
                     lambda: m.ssl_trials(trials, lab, tag="smoke_"))
        if name == "poisson":
            launches = graphops.plain_ell_spmm.launches
            say(f"  poisson.ssl_trials: {launches} plain ELL kernel "
                f"launches, the batches' CG steps {sum(steps)}")
            if launches < sum(steps):
                raise SmokeFailure(f"poisson.ssl_trials launched the plain "
                                   f"ELL kernel {launches} times in "
                                   f"{sum(steps)} CG steps")
        if rows is None or rows.shape != (len(trials), 2):
            raise SmokeFailure(f"{name}.ssl_trials: rows {rows}")
        num_train, mean, std, num = m.trials_statistics(tag="smoke_")
        if num != TRIAL_NUM or num_train.tolist() != [
                10 * r for r in TRIAL_RATES]:
            raise SmokeFailure(f"{name}.trials_statistics: {num_train}, "
                               f"{num} trials")
        for r, acc, sd in zip(TRIAL_RATES, mean[:, 0], std[:, 0]):
            check_target(f"ten/{name}, {10 * r} labels, mean of {num} "
                         f"(std {sd:.4f})", acc,
                         TRIALS_REFERENCE[f"{name}_{r}"],
                         TRIALS_MARGIN.get(name, ACCURACY_MARGIN))
        with env("GLT_NO_ACCEL", "1"):
            for r in TRIAL_RATES:
                t = trials[TRIAL_RATES.index(r) * TRIAL_NUM]
                seq = getattr(gl.ssl, name)(W)
                pred = timed(torch, f"{name}, {len(t)} labels, sequential "
                             "plain fit", lambda: seq.fit_predict(t, lab[t]))
                agree = float(np.mean(pred == preds[t.tobytes()]))
                say(f"  {name}, {len(t)} labels: the batched trial agrees "
                    f"with its sequential fit ({seq.iters} CG steps) on "
                    f"{agree:.4f}")
                if agree < TRIALS_AGREEMENT:
                    raise SmokeFailure(f"{name}: batched against sequential "
                                       f"{agree:.4f} < {TRIALS_AGREEMENT}")
        models.append(m)
    table = os.path.join(root, "table.tex")
    timed(torch, "accuracy_table", lambda: gl.ssl.accuracy_table(
        models, tag="smoke_", savefile=table, title="TenClusters"))
    with open(table) as fh:
        text = fh.read()
    if text.count("\\\\") != 1 + len(models):
        raise SmokeFailure("accuracy_table: not a row a model")

    ti = gl.trainsets.generate(lab, rate=1, seed=0)
    runs = []
    for i in (1, 2):
        m = gl.ssl.sparse_label_propagation(W)
        pred = timed(torch, f"sparse_label_propagation, run {i}",
                     lambda: m.fit_predict(ti, lab[ti]))
        runs.append(m.prob)
    if not np.array_equal(runs[0], runs[1]):
        raise SmokeFailure("sparse_label_propagation: two fits differ")
    check_target("ten/sparse_label_propagation (bit-equal in two runs)",
                 gl.ssl.ssl_accuracy(pred, lab, ti),
                 TRIALS_REFERENCE["sparse_label_propagation"])
    return launches


def harness_moons(torch, gl, bs, W, labels, ti):
    """Phase 4e on the moons band: ``gl.warmup`` and a fit that builds no
    band, ``ssl_trials`` with class priors (sequential, on the band; K2's
    launches held to the fits' CG steps) and ``poisson.fit_device``."""
    We = W.copy()
    We._glt_points = W._glt_points
    bs.reset_launches()
    m = timed(torch, "gl.warmup(laplace, 2) (the band's plan and K1)",
              lambda: gl.warmup(gl.ssl.laplace(We), 2))
    warm = bs.launches()
    if warm["materialize_band_tiles"] != 1 or m.fitted:
        raise SmokeFailure(f"warmup: launches {warm}, fitted {m.fitted}")
    bs.reset_launches()
    pred = timed(torch, "laplace fit after warmup",
                 lambda: m.fit_predict(ti, labels[ti]))
    after = bs.launches()
    say(f"  launches: warmup {warm}, the fit after it {after} "
        f"({m.iters} CG steps)")
    if (after["materialize_band_tiles"] != 0
            or after["band_tiles_spmm_packed"] != m.iters + 2):
        raise SmokeFailure(f"the fit after warmup launched {after}, its "
                           f"{m.iters} CG steps need no K1 and "
                           f"{m.iters + 2} K2")
    check_target("moons/laplace after warmup",
                 gl.ssl.ssl_accuracy(pred, labels, ti),
                 REFERENCE_ACCURACY["laplace"])

    mp = gl.ssl.laplace(We, class_priors=gl.utils.class_priors(labels))
    steps, fit = [], mp._fit

    def record(*a, **k):
        u = fit(*a, **k)
        steps.append(mp.iters)
        return u

    mp._fit = record
    trials = gl.trainsets.generate(labels, **PRIOR_TRIALS)
    bs.reset_launches()
    rows = timed(torch, "laplace(class_priors).ssl_trials (3 trials)",
                 lambda: mp.ssl_trials(trials, labels, tag="moons_"))
    priors = bs.launches()
    say(f"  launches {priors}; CG steps {steps}; rows {rows.tolist()}")
    if rows.shape != (3, 4) or priors["band_tiles_spmm_packed"] != sum(
            s + 2 for s in steps) or len(steps) != 3:
        raise SmokeFailure(f"laplace(class_priors).ssl_trials: launches "
                           f"{priors}, CG steps {steps}")
    for i, (row, target) in enumerate(zip(
            rows, TRIALS_REFERENCE["laplace_priors"])):
        check_target(f"moons/laplace with class priors, trial {i}", row[2],
                     target)

    bs.reset_launches()
    u = timed(torch, "poisson.fit_device",
              lambda: gl.ssl.poisson(We).fit_device(ti, labels[ti]))
    dev = bs.launches()
    ref = gl.ssl.poisson(We).fit_predict(ti, labels[ti])
    if (not u.is_cuda or tuple(u.shape) != (W.shape[0], 2)
            or not np.array_equal(torch.argmax(u, 1).cpu().numpy(), ref)
            or dev["band_tiles_spmm_packed"] < 1):
        raise SmokeFailure(f"poisson.fit_device: {u.device}, {u.shape}, "
                           f"launches {dev}")
    say(f"  poisson.fit_device: a {tuple(u.shape)} tensor on {u.device}, "
        f"its argmax fit_predict's; launches {dev}")


def trials_phase(torch, gl, bs, W, labels, ti):
    """Phase 4e: the experiment harness (datasets, stored kNN data, train
    set files, batched ``ssl_trials``) and label propagation.  Returns
    :func:`harness_ten`'s count of plain ELL kernel launches."""
    import tempfile

    t0 = time.perf_counter()
    say("== phase 4e: the experiment harness on the ten-cluster input "
        "(n=70000, 20-d, k=10)")
    with tempfile.TemporaryDirectory() as root, store_dirs(gl, root):
        launches = harness_ten(torch, gl, root)
        say("== phase 4e on the moons band (n=65536)")
        harness_moons(torch, gl, bs, W, labels, ti)
    say(f"== dynamic label propagation (two moons, n={FP_N})")
    Xf, yf = two_moons(FP_N, 0.1, seed=0)
    Wf = gl.weightmatrix.knn(Xf, 10)
    tif = gl.trainsets.generate(yf, rate=5, seed=0)
    pred = timed(torch, "dynamic_label_propagation", lambda: (
        gl.ssl.dynamic_label_propagation(Wf).fit_predict(tif, yf[tif])))
    check_target(f"fp n={FP_N}/dynamic_label_propagation",
                 gl.ssl.ssl_accuracy(pred, yf, tif),
                 TRIALS_REFERENCE["dynamic_label_propagation"])
    say(f"== phase 4e: {time.perf_counter() - t0:.1f} s")
    return launches


def window_coo(torch, acc):
    """Rows, columns and weights of the in-window edges of ``acc``'s
    rectangular plan (its first kcap slots whose column lies in the row's
    window), row-major on the card: the yardsticks' inputs."""
    p = acc.plan
    cols = acc.g.cols[:, :p.kcap].long()
    vals = acc.g.vals[:, :p.kcap].float()
    lo = torch.repeat_interleave(p.winstart.long(), p.R)[:, None]
    keep = (cols >= lo) & (cols < lo + p.W) & (vals != 0)
    rows = torch.arange(p.n, device=cols.device)[:, None].expand_as(cols)
    return rows[keep], cols[keep], vals[keep]


def band_coo(torch, band, plan):
    """Rows, absolute columns and f32 values of the nonzero cells of a
    rectangular ``band``, row-major on the card: the yardsticks' inputs for
    a bf16 band, whose rounded values the ELL does not hold (in f32 they
    are exact, so the library computes the kernel's function)."""
    row, c = (band != 0).nonzero(as_tuple=True)
    col = plan.winstart.long()[row // plan.R] + c
    return row, col, band[row, c].float()


def window_csr(torch, acc, coo=None):
    """The in-window edges of ``acc``'s plan (or the edges ``coo``) as a
    torch CSR on the card."""
    row, col, val = coo if coo is not None else window_coo(torch, acc)
    n = acc.plan.n
    crow = torch.zeros(n + 1, dtype=torch.int64, device=row.device)
    crow[1:] = torch.cumsum(torch.bincount(row, minlength=n), 0)
    return torch.sparse_csr_tensor(crow, col, val, size=(n, n))


def needed_bytes(torch, bs, band, plan, row_bytes, cell_sizes=None):
    """The bytes that the function of a band kernel (K5 or K8 on a
    ``RectPlan``'s band; K2, K10 or K11 on a ``PackedPlan``'s; K3, K7 or
    K9 on a ``TilesPlan``'s) needs, whatever the design reads: each 32-byte
    sector of ``band`` that holds a nonzero cell (the card's least read)
    and each X (d and f, or U) row of ``row_bytes`` that a nonzero cell
    multiplies, once.  ``cell_sizes``: the bytes a cell takes in each
    plane that stores the band (K10's int8 planes, K11's bf16 and int8),
    else ``band``'s own.  Returns ``(bytes, sectors)``."""
    sizes = cell_sizes or (band.element_size(),)
    dev = band.device
    if isinstance(plan, bs._SlabPlan):
        # a slab row holds its S tiles side by side
        width = plan.S * plan.WT
        pieces = bs._tile_chunks(plan, plan.R * width)
        columns = lambda p0, p1: (
            plan.slab_starts[p0:p1, :, None].long()
            + torch.arange(plan.WT, device=dev)).reshape(p1 - p0, width)
    else:
        width, pieces = plan.W, bs._block_chunks(plan, plan.R * plan.W)
        columns = lambda p0, p1: bs._window_index(plan, p0, p1)
    sectors = 0
    used = torch.zeros(plan.x_rows, dtype=torch.bool, device=dev)
    for p0, p1 in pieces:
        nz = (band[p0 * plan.R:p1 * plan.R] != 0).reshape(p1 - p0, plan.R,
                                                          width)
        for per in (32 // e for e in sizes):
            sectors += int(nz.reshape(p1 - p0, plan.R, width // per, per)
                           .any(dim=3).sum())
        used[columns(p0, p1)[nz.any(dim=1)]] = True
    return sectors * 32 + int(used.sum()) * row_bytes, sectors


def live_bytes(torch, bs, band, plan, chunks, row_bytes):
    """The bytes that reading only the live chunks of ``band`` needs: each
    live chunk's cells (64 x 64 on a ``RectPlan``'s band, 16 x 32 on a
    ``TilesPlan``'s), each X (d and f, or U) chunk of ``row_bytes`` a row
    that a live chunk multiplies once (the rows are absolute, so row
    groups whose columns overlap share them), and the list.  Returns
    ``(bytes, live chunks, all chunks)``."""
    chunk_ptr, chunk_id = chunks
    live = int(chunk_id.numel())
    ids = chunk_id.long()
    if isinstance(plan, bs.TilesPlan):
        rows, kc = bs._LIVE_ROWS, bs._LIVE_KC
        cpt = plan.WT // kc
        x_chunk = plan.slab_starts[ids // cpt, 0].long() // kc + ids % cpt
        n_chunks = band.numel() // (rows * kc)
        plan_bytes = plan.slab_starts.numel() * 4
    else:
        rows, kc = bs._TILES_ROWS, bs._TILES_KC
        group = torch.repeat_interleave(
            torch.arange(plan.n // rows, device=band.device),
            (chunk_ptr[1:] - chunk_ptr[:-1]).long())
        x_chunk = plan.winstart[group * rows // plan.R].long() // kc + ids
        n_chunks = (plan.n // rows) * (plan.W // kc)
        plan_bytes = plan.winstart.numel() * 4
    x_chunks = int(torch.unique(x_chunk).numel())
    nbytes = (live * rows * kc * band.element_size()
              + x_chunks * kc * row_bytes
              + (chunk_ptr.numel() + live) * 4 + plan_bytes)
    return nbytes, live, n_chunks


def k5_entry(torch, bs, label, band, plan, X, chunks, csr=None):
    """K5 on the band's live chunks against its twin, within TOL of
    max|ref|; ``csr`` (the in-window edges, in f32) gives the
    ``torch.sparse.mm`` yardstick, on X in f32.  ``bound_ms``: the bytes
    the function needs (:func:`needed_bytes`) and ``out``;
    ``live_bound_ms``: the live chunks' bytes (:func:`live_bytes`), what
    this design reads, and ``out``; ``dense_bound_ms``: every cell of the
    band read once."""
    run = lambda: bs.band_spmm(band, plan, X, chunks)
    plain = lambda: bs._rect_spmm_plain(band, plan, X)
    out = run()
    torch.cuda.synchronize()
    dname = str(band.dtype).split(".")[-1]
    err = compare(label, out, plain(), TOL[dname])
    nnz_band = int((band != 0).sum())
    d = X.shape[1]
    nblocks = plan.n // plan.R
    nbytes, sectors = needed_bytes(torch, bs, band, plan,
                                   d * X.element_size())
    lbytes, live, n_chunks = live_bytes(torch, bs, band, plan, chunks,
                                        d * X.element_size())
    peak = "tf32x3" if dname == "float32" else dname
    b_ms, b_by = bound(nbytes + out.numel() * 4, 2 * nnz_band * d, peak)
    live_ms, _ = bound(lbytes + out.numel() * 4, 2 * nnz_band * d, peak)
    dense_ms, _ = bound(band.numel() * band.element_size()
                        + nblocks * plan.W * d * X.element_size()
                        + out.numel() * 4 + nblocks * 4, 2 * nnz_band * d,
                        peak)
    Xf = X.float()
    library = ((lambda: torch.sparse.mm(csr, Xf)) if csr is not None
               else None)
    return report({
        "name": "band_spmm", "variant": label, "max_abs_err": err,
        **timings(torch, run, plain, library),
        "bound_ms": b_ms, "bound_by": b_by, "live_bound_ms": live_ms,
        "dense_bound_ms": dense_ms, "live_chunks": live,
        "live_share": live / n_chunks,
        "library": ("torch.sparse.mm, in-window CSR in f32" if csr is not None
                    else None),
        "shapes": {"band": list(band.shape), "X": list(X.shape),
                   "R": plan.R, "W": plan.W, "band_nnz": nnz_band,
                   "band_sectors": sectors, "chunks": n_chunks,
                   "dtype": dname}})


def k6_entry(torch, bs, label, cols, vals, plan, X, csr=None):
    """K6 against its twin, within TOL of max|ref|; ``csr`` as for K5.
    The bound counts the slots read once, X read once and ``out``."""
    run = lambda: bs.banded_spmm(cols, vals, plan, X)
    plain = lambda: bs._banded_spmm_plain(cols, vals, plan, X)
    out = run()
    torch.cuda.synchronize()
    dname = str(vals.dtype).split(".")[-1]
    err = compare(label, out, plain(), TOL[dname])
    lo = torch.repeat_interleave(plan.winstart.long(), plan.R)[:, None]
    slots = int(((cols >= lo) & (cols < lo + plan.W) & (vals != 0)).sum())
    d = X.shape[1]
    nbytes = (cols.numel() * 4 + vals.numel() * vals.element_size()
              + X.numel() * X.element_size() + out.numel() * 4
              + plan.winstart.numel() * 4)
    b_ms, b_by = bound(nbytes, 2 * slots * d, dname)
    library = (lambda: torch.sparse.mm(csr, X)) if csr is not None else None
    return report({
        "name": "banded_spmm", "variant": label, "max_abs_err": err,
        **timings(torch, run, plain, library),
        "bound_ms": b_ms, "bound_by": b_by,
        "library": ("torch.sparse.mm, in-window CSR" if csr is not None
                    else None),
        "shapes": {"ell": list(cols.shape), "X": list(X.shape),
                   "R": plan.R, "W": plan.W, "in_window_slots": slots,
                   "dtype": dname}})


def k8_entry(torch, bs, label, band, plan, chunks, d, f, hopf, recip,
             track, coo=None):
    """K8 on the band's live chunks against its twin
    (:func:`minplus_entry`); ``coo``: the in-window edges.  Bounds as
    :func:`chunk_bounds`: the function's bytes with their d and f, the
    live 64 x 64 chunks', and the dense band's."""
    nblocks = plan.n // plan.R
    nnz_band = int((band != 0).sum())
    bounds, counts = chunk_bounds(
        torch, bs, band, plan, chunks, 8, plan.n * (8 if track else 4),
        nnz_band * (8 if hopf else 3),
        band.numel() * band.element_size() + nblocks * plan.W * 8
        + nblocks * 4)
    return minplus_entry(
        torch, bs, "band_minplus", label,
        lambda: bs.band_minplus(band, plan, d, f, hopf_lax=hopf,
                                track_arg=track, recip=recip, chunks=chunks),
        lambda: bs._rect_minplus_plain(band, plan, d, f, hopf, track,
                                       recip),
        band, d, f, track, coo,
        dict(counts, R=plan.R, W=plan.W, hopf_lax=hopf, recip=recip,
             band=list(band.shape), band_nnz=nnz_band),
        bounds, recip=recip)


def harmonic_reference(W, mask, bdy):
    """The masked Laplace solve ``L u = 0`` with ``u = bdy`` on ``mask``
    (L = D - W), in f64 by scipy's sparse LU: the reference of the f32 CG
    solves."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import splu

    L = (sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W).tocsr()
    free = ~mask
    u = np.array(bdy, dtype=np.float64)
    u[free] = splu(L[free][:, free].tocsc()).solve(
        -(L[free][:, mask] @ u[mask]))
    return u


def rel_to(u, ref):
    """max|u - ref| / max|ref| of a tensor against a numpy array."""
    return float(np.abs(u.double().cpu().numpy() - ref).max()
                 / np.abs(ref).max())


def gmres_residual(L, ind, bdy, x):
    """The preconditioned residual ``||(A x - b) / diag||`` of
    ``utils.constrained_solve_gmres(L, 0, I, bdy, ind)``'s answer ``x``, in
    float64 on the host: ``A`` the rows of ``L`` with those of ``ind``
    replaced by the identity's, ``diag`` its diagonal."""
    mask = np.zeros(L.shape[0], bool)
    mask[ind] = True
    diag = np.where(mask, 1.0, L.diagonal())
    return float(np.linalg.norm((np.where(mask, x, L @ x) - bdy) / diag))


def check_solve(label, u, u_plain, u_ref):
    """A band path's masked Laplace solve within SOLVE_MARGIN of the plain
    path's error against scipy's f64 solve."""
    err, err_p = rel_to(u, u_ref), rel_to(u_plain, u_ref)
    say(f"  laplace_constrained on {label} against scipy's f64 solve: "
        f"max|u - u_ref| / max|u_ref| {err:.3e}, plain path {err_p:.3e}")
    if err > SOLVE_MARGIN * err_p:
        raise SmokeFailure(f"{label}: the solve is {err / err_p:.1f}x "
                           f"further from scipy's f64 solve than the "
                           f"plain path's (limit {SOLVE_MARGIN:g}x)")


def check_solves(torch, gl, W, labels, ti, accs):
    """The Laplace fit's masked solve (its tol) on each band of ``accs``
    and on the plain path, each held to scipy's f64 solve
    (:func:`check_solve`)."""
    from graphlearning_tpu_torch import ssl as tssl
    from graphlearning_tpu_torch.solvers import plaplace

    n = W.shape[0]
    mask = np.zeros(n, bool)
    mask[ti] = True
    bdy = np.zeros((n, 2))
    bdy[ti] = np.eye(2)[labels[ti]]
    tol = FITS["laplace"](gl, W).tol
    g = gl.graph(W).sparse
    as_t = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    u_p, _ = tssl._laplace_constrained(
        g, as_t(np.zeros(n)), torch.as_tensor(mask, device="cuda"),
        as_t(bdy), tol)
    u_ref = harmonic_reference(W, mask, bdy)
    for label, acc in accs.items():
        u, _ = plaplace._laplace_init(acc, g, mask, bdy, tol=tol)
        check_solve(label, u, u_p, u_ref)


def rect_phase(torch, gl, accel, bs, W, labels, ti, plain_pred):
    """Phase 5, the rectangular route (counts from 0 around its three
    steps), then K5, K6 and K8 against their twins at its shapes."""
    from graphlearning_tpu_torch import ssl as tssl
    from graphlearning_tpu_torch.solvers import eikonal, plaplace

    say("== the rectangular route: the same moons graph, GLT_NO_BAND=1")
    fit = fitter(torch, gl, labels, ti)
    n = W.shape[0]
    bs.reset_launches()
    with env("GLT_NO_BAND", "1"):
        t = time.perf_counter()
        acc_b = accel.maybe_build(W, device="cuda")
        if acc_b is None or not isinstance(acc_b.plan, bs.BandedPlan):
            raise SmokeFailure(f"GLT_NO_BAND: expected a BandedPlan, got "
                               f"{acc_b and type(acc_b.plan).__name__}")
        say(f"  band plan (BandedPlan, host): {time.perf_counter() - t:.2f}"
            f" s; n_pad {acc_b.n_pad}, W {acc_b.plan.W}, kcap "
            f"{acc_b.plan.kcap}, {acc_b.n_resid} residual edges")
        for name in ("laplace", "poisson_cg"):
            pred, accuracy, m = fit(f"banded/{name}",
                                    lambda name=name: FITS[name](gl, W))
            if m._accel_cache is not acc_b:
                raise SmokeFailure(f"banded/{name} did not take the "
                                   "BandedPlan")
            check_accuracy(name, accuracy)
            check_agreement(f"banded/{name}", pred, plain_pred[name], 0.99)
        step1 = bs.launches()
        say(f"  launches: {step1}")
        if step1["banded_spmm"] < 1 or step1["band_spmm"] \
                or step1["band_minplus"]:
            raise SmokeFailure(f"the BandedPlan fits did not run on K6 "
                               f"alone: {step1}")
        G = gl.graph(W)
        t = time.perf_counter()
        d_g, cp_g = G.dijkstra(ti, bdy_val=0, return_cp=True)
        secs = time.perf_counter() - t
        after = bs.launches()
        if (after["band_tiles_minplus"] != step1["band_tiles_minplus"]
                or after["band_minplus"] != step1["band_minplus"]):
            raise SmokeFailure("graph.dijkstra on a BandedPlan graph "
                               f"launched a min-plus kernel: {after}")
        d_p, cp_p = eikonal.dijkstra(G.sparse, ti, bdy_val=0,
                                     return_cp=True)
        if not (np.array_equal(d_g, d_p) and np.array_equal(cp_g, cp_p)):
            raise SmokeFailure("graph.dijkstra on a BandedPlan graph is "
                               "not the plain path's")
        say(f"  graph.dijkstra: plain path, {secs:.3f} s, no K7 or K8 "
            "launch")

        say("== AccelSpMM(W, materialize=True) under GLT_NO_BAND=1")
        t = time.perf_counter()
        acc_r = accel.AccelSpMM(W, device="cuda", materialize=True)
        if not isinstance(acc_r.plan, bs.RectPlan):
            raise SmokeFailure("materialize=True did not give a RectPlan")
        say(f"  band plan (RectPlan, host): {time.perf_counter() - t:.2f} s;"
            f" W {acc_r.plan.W}, band {acc_r.band_bytes:.4g} B, "
            f"{acc_r.n_resid} residual edges")
        g = G.sparse
        mask = np.zeros(n, bool)
        mask[ti] = True
        bdy = np.zeros((n, 2))
        bdy[ti] = np.eye(2)[labels[ti]]
        tol = FITS["laplace"](gl, W).tol
        torch.cuda.synchronize()
        t = time.perf_counter()
        u_r, iters = plaplace._laplace_init(acc_r, g, mask, bdy, tol=tol)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float32,
                                         device="cuda")
        u_p, iters_p = tssl._laplace_constrained(
            g, as_t(np.zeros(n)), torch.as_tensor(mask, device="cuda"),
            as_t(bdy), tol)
        rel = float((u_r - u_p).abs().max() / u_p.abs().max())
        say(f"  laplace_constrained on K5: {iters} iterations, {secs:.3f} "
            f"s (plain {iters_p}); max|u - u_plain| / max|u_plain| "
            f"{rel:.3e}")
        check_solve("K5", u_r, u_p, harmonic_reference(W, mask, bdy))
        check_agreement("rect/laplace_constrained",
                        u_r.argmax(1).cpu().numpy(),
                        u_p.argmax(1).cpu().numpy(), 0.99)
        G2 = gl.graph(W)
        with env("GLT_NO_ACCEL", "1"):
            for label in ("dijkstra", "dijkstra_recip", "dijkstra_hl"):
                recip = {"reciprocal_weights": True} \
                    if label == "dijkstra_recip" else {}
                solve = (eikonal.dijkstra_hl if label == "dijkstra_hl"
                         else eikonal.dijkstra)
                n8 = bs.band_minplus.launches
                torch.cuda.synchronize()
                t = time.perf_counter()
                res = solve(g, ti, bdy_val=0, return_cp=True, accel=acc_r,
                            **recip)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t
                if bs.band_minplus.launches == n8:
                    raise SmokeFailure(f"rect/{label} did not launch K8")
                ndiff = check_distances(
                    label, res, solve(g, ti, bdy_val=0, return_cp=True,
                                      **recip), G2)
                say(f"  rect/{label}: {secs:.3f} s, "
                    f"{bs.band_minplus.launches - n8} K8 launches; within "
                    f"1e-5 relative of the plain path, {ndiff} closest "
                    "points differ between equidistant seeds")
        step2 = bs.launches()
        for name in ("materialize_band", "band_spmm", "band_minplus"):
            if step2[name] < 1:
                raise SmokeFailure(f"the RectPlan did not launch {name}: "
                                   f"{step2}")

    say("== two moons, n=1310720 (noise 0.1, k=10, 5 labels/class), no "
        "knob")
    X, y_big = two_moons(1310720, 0.1, seed=0)
    t = time.perf_counter()
    W_big = gl.weightmatrix.knn(X, 10)
    say(f"  knn (host cKDTree): {time.perf_counter() - t:.2f} s, nnz "
        f"{W_big.nnz}")
    ti_big = gl.trainsets.generate(y_big, rate=5, seed=0)
    t = time.perf_counter()
    acc_big = accel.maybe_build(W_big, device="cuda")
    if acc_big is None or not isinstance(acc_big.plan, bs.BandedPlan):
        raise SmokeFailure(f"n=1310720: maybe_build gave "
                           f"{acc_big and type(acc_big.plan).__name__}, "
                           "not a BandedPlan")
    say(f"  maybe_build (host): {time.perf_counter() - t:.2f} s; "
        f"BandedPlan, n_pad {acc_big.n_pad}, W {acc_big.plan.W}, kcap "
        f"{acc_big.plan.kcap}, {acc_big.n_resid} residual edges "
        f"(n * 5120 * 4 = {1310720 * 5120 * 4:.4g} B over the budget of "
        f"{acc_big._budget:.4g} B)")
    fit_big = fitter(torch, gl, y_big, ti_big)
    before = bs.launches()
    big = {name: fit_big(f"banded/{name}",
                         lambda name=name: FITS[name](gl, W_big))
           for name in ("laplace", "poisson_cg")}
    launches = bs.launches()
    if (launches["banded_spmm"] == before["banded_spmm"]
            or launches["band_spmm"] != before["band_spmm"]
            or launches["band_minplus"] != before["band_minplus"]):
        raise SmokeFailure(f"the n=1310720 fits did not run on K6 alone: "
                           f"{before} -> {launches}")
    say(f"  launches on the rectangular route: {launches}")
    with env("GLT_NO_ACCEL", "1"):
        for name, (pred, accuracy, _) in big.items():
            ref, ref_acc, _ = fit_big(f"plain/{name}",
                                      lambda name=name: FITS[name](gl, W_big))
            check_agreement(f"banded/{name} (n=1310720)", pred, ref, 0.99)
            if abs(accuracy - ref_acc) > ACCURACY_MARGIN:
                raise SmokeFailure(f"{name} (n=1310720): accuracy "
                                   f"{accuracy:.4f} % against the plain "
                                   f"path's {ref_acc:.4f} %")
    # the whole matvec (kernel plus residual) beside the plain ELL gather,
    # after the launch counts of the path were read
    from graphlearning_tpu_torch.ops import graphops
    Xa = torch.randn((acc_b.n_pad, 2), device="cuda")
    for a, tag in ((acc_b, "BandedPlan (K6)"), (acc_r, "RectPlan (K5)")):
        fn = lambda a=a: a.spmm(Xa)
        say(f"  whole matvec, d=2, n=65536, {tag} + residual: "
            f"{time_ms(torch, fn):.4f} ms (chain {chain_ms(torch, fn):.4f})")
    fn = lambda: graphops.spmm(acc_b.g, Xa)
    say(f"  whole matvec, d=2, n=65536, plain ELL gather: "
        f"{time_ms(torch, fn):.4f} ms (chain {chain_ms(torch, fn):.4f})")
    Xa = torch.randn((acc_big.n_pad, 2), device="cuda")
    ms = time_ms(torch, lambda: acc_big.spmm(Xa))
    say(f"  whole matvec, d=2, n=1310720, K6 + residual: {ms:.4f} ms")
    ms = time_ms(torch, lambda: graphops.spmm(acc_big.g, Xa))
    say(f"  whole matvec, d=2, n=1310720, plain ELL gather: {ms:.4f} ms")
    del X, Xa

    say("== K5, K6, K8 at the shapes of the rectangular route")
    entries = []
    gen = torch.Generator(device="cuda").manual_seed(2)
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[-1]
        band = acc_r.band() if dt == torch.float32 else acc_r.build_band(dt)
        Xd = torch.randn((acc_r.n_pad, 2), generator=gen, device="cuda")
        chunks = acc_r.live_chunks(band)
        # the yardsticks' edges: the ELL's in-window slots, or the bf16
        # band's own (rounded) cells
        coo = (window_coo(torch, acc_r) if dt == torch.float32
               else band_coo(torch, band, acc_r.plan))
        entries.append(k5_entry(
            torch, bs, f"rect/laplace/{dname}/d=2", band, acc_r.plan,
            Xd.to(dt), chunks, window_csr(torch, acc_r, coo)))
        d_p = acc_r.to_perm(torch.as_tensor(
            np.minimum(d_g, 1e30), dtype=torch.float32, device="cuda"),
            fill=bs.MINPLUS_BIG)
        f_p = acc_r.to_perm(torch.ones(n, device="cuda"))
        for hopf in (False, True):
            for recip in (False, True):
                for track in (False, True):
                    tag = ("hopf_lax" if hopf else "plain") \
                        + ("/recip" if recip else "") \
                        + ("/arg" if track else "")
                    entries.append(k8_entry(
                        torch, bs, f"rect/{dname}/{tag}", band, acc_r.plan,
                        chunks, d_p, f_p, hopf, recip, track,
                        coo if not (hopf or recip) else None))
        del band, chunks, coo
        torch.cuda.empty_cache()
    for a, tag in ((acc_b, "n=65536"), (acc_big, "n=1310720")):
        csr = window_csr(torch, a)
        for dt, ds in ((torch.float32, (2, 3)), (torch.bfloat16, (2,))):
            dname = str(dt).split(".")[-1]
            cols, vals = a.ell_operands()
            vals = vals.to(dt)
            for d in ds:
                Xd = torch.randn((a.n_pad, d), generator=gen, device="cuda")
                entries.append(k6_entry(
                    torch, bs, f"banded/{tag}/{dname}/d={d}", cols, vals,
                    a.plan, Xd.to(dt),
                    csr if dt == torch.float32 else None))
        del csr
        torch.cuda.empty_cache()
    return entries, {k: launches[k] for k in ("band_spmm", "banded_spmm",
                                              "band_minplus")}


# The JAX bench's geometry; its 50 chained products cut to 10, since the
# scipy f64 reference chains on the host took most of this phase's 340 s
# at 50 (phase 6 alone, PERF.md).
BENCH_N, BENCH_K, BENCH_D, BENCH_ITERS = 1 << 18, 16, 128, 10
# Error grade of each bench mode against the scipy f64 chain, as
# tests/test_pallas_spmm.py holds the JAX kernels.
BENCH_GRADES = {"f32": ("rel_err_chain", 1e-4),
                "rowq2_int8": ("rel_err_single", 1e-4),
                "bf16i8": ("rel_err_single", 1e-4),
                "rowq1_int8": ("rel_err_single", 2e-2),
                "bf16": ("rel_err_single", 2e-2)}
# The gather against scipy f64: (single product, chain of BENCH_ITERS).
# The single product as tests/test_gather.py holds the JAX package's bf16
# table.  Each product of the chain rounds the table to bf16 again, so its
# error grows with the chain: 3.0e-3 at 10 products and 2.1e-2 at 50 on
# the card (PERF.md); 1e-2 holds the 10-product chain.
HIGHDIM_GRADES = {"f32": (1e-4, 1e-4), "bf16": (2e-2, 1e-2)}
Q_KERNELS = ("band_tiles_spmm_packed_rowq", "band_tiles_spmm_packed_i8")


def q_entry(torch, bs, label, kind, band, plan, X, csr):
    """K10 (``kind`` rowq2 / rowq1) or K11 (i8) against its twin on the
    bench's packed plan, within 1e-5 of max|ref|.  The bound: the bytes
    the function needs (:func:`needed_bytes`, each plane's sectors holding
    a nonzero cell), ``out`` and ``srow``; ``2 nnz d`` operations on the
    bf16 tensor cores (rowq1), a third of the TF32 tensor cores' rate for
    the exact grade (3xTF32).  ``dense_bound_ms``: the real tiles' cells
    at 1, 2 or 3 bytes, X once, ``out``, ``srow`` and the plan."""
    X32 = X
    if kind == "i8":
        hi, q = bs.quantize_band_i8(band)
        name, cell, grade = "band_tiles_spmm_packed_i8", 3, "tf32x3"
        sizes = (2, 1)
        run = lambda: bs.band_tiles_spmm_packed_i8(hi, q, plan, X)
        plain = lambda: bs._tiles_spmm_i8_plain(hi, q, plan, X)
        srow_bytes = 0
    else:
        planes = int(kind[-1])
        qband, srow = bs.quantize_band_rowq(band, plan, plan.n, planes)
        Xk = X if planes == 2 else X.to(torch.bfloat16)
        name, cell = "band_tiles_spmm_packed_rowq", planes
        sizes = (1,) * planes
        grade = "tf32x3" if planes == 2 else "bfloat16"
        run = lambda: bs.band_tiles_spmm_packed_rowq(
            qband, srow, plan, Xk, planes)
        plain = lambda: bs._tiles_spmm_rowq_plain(qband, srow, plan, Xk,
                                                  planes)
        srow_bytes = srow.numel() * 4
        X = Xk
    out = run()
    torch.cuda.synchronize()
    err = compare(label, out, plain(), TOL["float32"])
    nnz_band = int((band != 0).sum())
    d = X.shape[1]
    ops = 2 * nnz_band * d
    nbytes, sectors = needed_bytes(torch, bs, band, plan,
                                   d * X.element_size(), sizes)
    nbytes += out.numel() * 4 + srow_bytes
    b_ms, b_by = bound(nbytes, ops, grade)
    dense_bytes = (int(plan.slab_ntiles.sum()) * plan.R * plan.WT * cell
                   + X.numel() * X.element_size() + out.numel() * 4
                   + srow_bytes
                   + (plan.slab_starts.numel() + plan.slab_ntiles.numel()
                      + plan.block_ptr.numel()) * 4)
    t = timings(torch, run, plain, lambda: torch.sparse.mm(csr, X32))
    return report({
        "name": name, "variant": label, "max_abs_err": err, **t,
        "bound_ms": b_ms, "bound_by": b_by,
        "dense_bound_ms": bound(dense_bytes, ops, grade)[0],
        "library": "torch.sparse.mm, permuted f32 CSR",
        # the needed bytes over the kernel's time, and bound / time
        "gb_s": nbytes / t["ms"] * 1e-6, "bound_share": b_ms / t["ms"],
        "shapes": {"band": list(band.shape), "X": list(X.shape),
                   "slabs": int(plan.slab_block.numel()),
                   "real_tiles": int(plan.slab_ntiles.sum()),
                   "band_nnz": nnz_band, "band_sectors": sectors,
                   "R": plan.R, "WT": plan.WT,
                   "S": plan.S, "bytes_per_cell": cell, "peak": grade,
                   "cta_rows": (bs._TILES_QROWS
                                if plan.R % bs._TILES_QROWS == 0
                                else bs._TILES_ROWS)}})


def bench_phase(torch, accel, bs):
    """Phase 6: the bench's three modes in-process (counts from 0 around
    them), each held to its limits, then K10 and K11 against their twins
    on the bench's packed plan."""
    from graphlearning_tpu_torch import bench

    say(f"== the bench: spmm 2-D (n={BENCH_N}, k={BENCH_K}, d={BENCH_D}, "
        f"iters={BENCH_ITERS}), highdim (f32, bf16 tables), poisson "
        "(n=70000)")
    common = dict(n=BENCH_N, k=BENCH_K, d=BENCH_D, iters=BENCH_ITERS,
                  dim=30, band_kernels=True, stored_band=True)
    bs.reset_launches()
    t = time.perf_counter()
    line = bench.main(device="cuda", mode="spmm", geom="2d", prec=None,
                      **common)
    say(f"  spmm 2-D: {time.perf_counter() - t:.1f} s")
    hd_cfg = bench.settings(mode="spmm", geom="highdim", **common)
    t = time.perf_counter()
    case = bench.highdim_case(hd_cfg, torch.device("cuda"))
    say(f"  highdim graph and reference chain: "
        f"{time.perf_counter() - t:.1f} s")
    highdim = {}
    for prec in HIGHDIM_GRADES:
        t = time.perf_counter()
        highdim[prec] = bench.highdim_bench(dict(hd_cfg, prec=prec),
                                            torch.device("cuda"), case)
        say(json.dumps(highdim[prec]))
        say(f"  spmm highdim/{prec}: {time.perf_counter() - t:.1f} s")
    del case
    t = time.perf_counter()
    pois = bench.main(device="cuda", mode="poisson", n=70000, k=10)
    say(f"  poisson: {time.perf_counter() - t:.1f} s")
    with env("GLT_NO_GATHER", "1"):
        pois_plain = bench.main(device="cuda", mode="poisson", n=70000,
                                k=10)
    say(f"  poisson fit: {pois['value']} s on the gather, "
        f"{pois_plain['value']} s on the plain ELL path (GLT_NO_GATHER)")
    launches = bs.launches()
    say(f"  launches on the bench: {launches}")

    modes = line["config"]["modes"]
    if set(modes) != set(bench.SPMM_MODES):
        raise SmokeFailure(f"the bench ran modes {sorted(modes)}, not "
                           f"{bench.SPMM_MODES}")
    for mode, (key, limit) in BENCH_GRADES.items():
        if not modes[mode][key] <= limit:
            raise SmokeFailure(f"bench mode {mode}: {key} "
                               f"{modes[mode][key]:.3e} > {limit:g}")
    for prec, limits in HIGHDIM_GRADES.items():
        for key, limit in zip(("rel_err_single", "rel_err"), limits):
            err = highdim[prec]["config"][key]
            if not err <= limit:
                raise SmokeFailure(f"highdim/{prec}: {key} {err:.3e} > "
                                   f"{limit:g}")
    for fit, path in ((pois, "GatherAccel"), (pois_plain, "plain ELL")):
        took = fit["config"]["path"]
        agree = fit["config"]["agreement_with_reference_path"]
        if path not in took:
            raise SmokeFailure(f"the poisson fit took {took}, not {path}")
        if agree < 0.99:
            raise SmokeFailure(f"the poisson fit on {path} agrees with the "
                               f"scipy reference on {agree} < 0.99 of the "
                               "nodes")
    for name in Q_KERNELS + ("band_tiles_spmm_packed",):
        if launches[name] < 1:
            raise SmokeFailure(f"the bench did not launch {name}: "
                               f"{launches}")

    say("== K10, K11 on the bench's packed plan")
    W = bench.bench_graph_2d(BENCH_N, BENCH_K, np.random.RandomState(0))
    acc = accel.AccelSpMM(W, device="cuda")
    del W
    if not acc.packed:
        raise SmokeFailure("the bench graph did not give a packed plan")
    band = acc.build_band(torch.float32)
    csr = permuted_csr(torch, acc)
    gen = torch.Generator(device="cuda").manual_seed(3)
    entries = []
    for d in (10, 128):
        X = torch.randn((acc.n_pad, d), generator=gen, device="cuda")
        for kind in ("rowq2", "rowq1", "i8"):
            entries.append(q_entry(torch, bs, f"bench/{kind}/d={d}", kind,
                                   band, acc.plan, X, csr))
            torch.cuda.empty_cache()
    del band, csr, acc
    torch.cuda.empty_cache()
    return entries, {k: launches[k] for k in Q_KERNELS}


@contextlib.contextmanager
def killed_after(gl, saves):
    """``gl.checkpoint.save`` raising after ``saves`` saves inside the block:
    a fit that dies mid-run with some of its state on disk."""
    real, left = gl.checkpoint.save, [saves]

    def save(path, state, step=0):
        real(path, state, step)
        left[0] -= 1
        if left[0] == 0:
            raise KilledFit(f"killed after save {saves}")

    gl.checkpoint.save = save
    try:
        yield
    finally:
        gl.checkpoint.save = real


class KilledFit(RuntimeError):
    """The simulated kill of :func:`killed_after`."""


def recorded(bs, m):
    """Wrap ``m._fit`` to record each fit's CG steps and its K1 and K2
    launches (counted from 0 around the fit).  Returns the record."""
    rec = {"steps": [], "k1": [], "k2": []}
    fit = m._fit

    def run(*a, **k):
        bs.reset_launches()
        out = fit(*a, **k)
        got = bs.launches()
        rec["steps"].append(int(m.iters))
        rec["k1"].append(got["materialize_band_tiles"])
        rec["k2"].append(got["band_tiles_spmm_packed"])
        return out

    m._fit = run
    return rec


def al_learners(torch, gl, bs, W, labels, ti, C0, V):
    """The cold and the warm Laplace learner on ``var_opt`` over ``(C0, V)``,
    AL_QUERIES queries of one node each.  Returns ``{warm: (learner,
    queries, accuracies, record)}``."""
    from graphlearning_tpu_torch import active_learning as al

    runs = {}
    for warm in (False, True):
        m = gl.ssl.laplace(W)
        rec = recorded(bs, m)
        label = "warm" if warm else "cold"
        t = time.perf_counter()
        learner = al.active_learner(m, al.var_opt, ti, labels[ti],
                                    warm_start=warm, C=C0, V=V)
        queries, accs = [], []
        for _ in range(AL_QUERIES):
            q = learner.select_queries()
            learner.update(q, labels[q])
            queries += [int(i) for i in np.atleast_1d(q)]
            u = learner.u
            u = u.cpu().numpy() if isinstance(u, torch.Tensor) else u
            accs.append(float(gl.ssl.ssl_accuracy(
                np.argmax(u, axis=1), labels, learner.labeled_ind)))
        torch.cuda.synchronize()
        say(f"  {label} learner: {time.perf_counter() - t:.3f} s for "
            f"{AL_QUERIES} queries, CG steps {rec['steps']}, K2 launches "
            f"{rec['k2']}, K1 {rec['k1']}; queries {queries}; accuracy "
            f"{[round(a, 4) for a in accs]}")
        runs[warm] = (learner, queries, accs, rec)
    return runs


def al_moons(torch, gl, bs, W, labels):
    """Phase 4f on the moons band: ``spectral_covariance`` of a Laplace
    model (K1 once, K2 held to LOBPCG's steps, eigenvalues to eigsh), then
    the cold and warm learners on eigsh's covariance (the same queries,
    JAX's queries, fewer warm CG steps, K2 = CG steps + 2 a refit, no K1,
    the accuracy after each query within ACCURACY_MARGIN of JAX's)."""
    from graphlearning_tpu_torch import active_learning as al
    from graphlearning_tpu_torch.solvers import eig

    ti = gl.trainsets.generate(labels, rate=1, seed=0)
    vals, V = timed(torch, "eigsh (float64, host, 20 pairs)",
                    lambda: eigsh_pairs(W, 20))
    C0 = np.diag(1.0 / (vals + AL_TAU))
    We = W.copy()
    We._glt_points = W._glt_points
    model = gl.ssl.laplace(We)
    bs.reset_launches()
    Cs, Vs = timed(torch, "spectral_covariance(laplace(W), k=20) on the band",
                   lambda: al.spectral_covariance(model, k=20, tau=AL_TAU))
    launches = bs.launches()
    by_d = dict(bs.band_tiles_spmm_packed.launches_by_d)
    (key, info), = model.graph.eigen_info.items()
    p = eig._default_power(gl.config.float_dtype(gl.config.device()))
    K = key[2] + min(2 + key[2] // 10, max(We.shape[0] // 4 - key[2], 0))
    want = lobpcg_launches(K, info["iters"], p)
    say(f"  {info['iters']} LOBPCG steps of {K} vectors on "
        f"{info['path']}; launches {launches}; K2 by X's columns "
        f"{dict(sorted(by_d.items()))}, want {dict(sorted(want.items()))}")
    if info["path"] != "packed tiles (K2)":
        raise SmokeFailure(f"spectral_covariance ran on {info['path']}")
    if launches["materialize_band_tiles"] != 1 or by_d != want:
        raise SmokeFailure(f"spectral_covariance: launches {launches}, K2 "
                           f"by width {by_d}, its steps give {want}")
    check_spectrum("band/spectral_covariance", 1.0 / np.diag(Cs) - AL_TAU,
                   vals, EIG_TOL["moons"])
    if Vs.shape != V.shape or not np.isfinite(Vs).all():
        raise SmokeFailure(f"spectral_covariance: V {Vs.shape}")

    runs = al_learners(torch, gl, bs, We, labels, ti, C0, V)
    (cold, qc, ac, rc), (warm, qw, aw, rw) = runs[False], runs[True]
    if qw != qc:
        raise SmokeFailure(f"warm queries {qw} differ from cold {qc}")
    if qc != AL_REFERENCE["moons_queries"]:
        raise SmokeFailure(f"queries {qc} differ from JAX's "
                           f"{AL_REFERENCE['moons_queries']}")
    say(f"  the queries are JAX's: {qc}")
    if not isinstance(warm.u, torch.Tensor) or not warm.u.is_cuda:
        raise SmokeFailure("the warm learner's scores left the card")
    agree = float(np.mean(torch.argmax(warm.u, 1).cpu().numpy()
                          == np.argmax(cold.u, axis=1)))
    say(f"  cold and warm final argmax agree on {agree:.6f}; CG steps "
        f"after the first fit cold {sum(rc['steps'][1:])}, warm "
        f"{sum(rw['steps'][1:])}")
    if agree < AL_AGREEMENT:
        raise SmokeFailure(f"cold against warm {agree} < {AL_AGREEMENT}")
    if sum(rw["steps"][1:]) >= sum(rc["steps"][1:]):
        raise SmokeFailure("the warm learner took no fewer CG steps")
    for rec in (rc, rw):
        if any(rec["k1"]) or rec["k2"] != [s + 2 for s in rec["steps"]]:
            raise SmokeFailure(f"refit launches: K1 {rec['k1']}, K2 "
                               f"{rec['k2']}, CG steps {rec['steps']}")
    ref = AL_REFERENCE["moons_accuracy"]
    for label, accs in (("cold", ac), ("warm", aw)):
        for i, (a, target) in enumerate(zip(accs, ref)):
            if abs(a - target) > ACCURACY_MARGIN:
                raise SmokeFailure(f"{label} learner, query {i + 1}: "
                                   f"accuracy {a:.4f} % against JAX's "
                                   f"{target:.4f} %")
    say(f"  accuracy after each query within {ACCURACY_MARGIN} of JAX's "
        f"{ref}")


def ivf_recall(J, D, Jb, Db):
    """The IVF search's recall against the brute search's neighbours, and
    the largest relative difference of the distances where both found the
    same neighbour in the same place."""
    k = J.shape[1]
    recall = float(np.mean([len(np.intersect1d(Jb[i], J[i])) / k
                            for i in range(len(J))]))
    hit = J == Jb
    rel = float(np.max(np.abs(D[hit] - Db[hit])
                       / np.maximum(np.abs(Db[hit]), 1e-30)))
    return recall, rel


def al_ten(torch, gl):
    """Phase 4f on the ten-cluster input: the IVF search (recall, exact
    hits, two runs bit-equal, beside the brute search), then a cold and a
    warm Poisson learner on ``model_change`` over ``spectral_covariance``
    on the gather: the same queries, argmax agreement AL_AGREEMENT, each
    final accuracy within ACCURACY_MARGIN of JAX's."""
    from graphlearning_tpu_torch import active_learning as al
    from graphlearning_tpu_torch import bench

    pts, y = bench.ten_cluster_points(70000)
    Jb, Db = timed(torch, "knnsearch(pts, 10, method='brute')",
                   lambda: gl.weightmatrix.knnsearch(pts, 10, method="brute"))
    runs = [timed(torch, f"knnsearch(pts, 10, method='ivf'), run {i}",
                  lambda: gl.weightmatrix.knnsearch(pts, 10, method="ivf"))
            for i in (1, 2)]
    (J, D), (J2, D2) = runs
    if not (np.array_equal(J, J2) and np.array_equal(D, D2)):
        raise SmokeFailure("ivf: two searches differ")
    recall, rel = ivf_recall(J, D, Jb, Db)
    ref = AL_REFERENCE["ten_ivf_recall"]
    say(f"  ivf: recall {recall:.4f} against brute (JAX float32 {ref}), "
        f"the hits' distances within {rel:.3e} relative, two runs "
        f"bit-equal")
    if abs(recall - ref) > IVF_RECALL_MARGIN or rel > 1e-5:
        raise SmokeFailure(f"ivf: recall {recall}, distances {rel}")
    rs = np.random.RandomState(3)             # JAX's recall test input
    centers = rs.randn(10, 30) * 2.0
    Xr = centers[rs.randint(0, 10, 4000)] + rs.randn(4000, 30) * 0.5
    recall_r, rel_r = ivf_recall(
        *gl.weightmatrix.knnsearch(Xr, 10, method="ivf"),
        *gl.weightmatrix.knnsearch(Xr, 10, method="brute"))
    say(f"  ivf on JAX's recall input (n=4000, 30-d): recall "
        f"{recall_r:.4f}, hits within {rel_r:.3e}")
    if recall_r < IVF_RECALL or rel_r > 1e-5:
        raise SmokeFailure(f"ivf on JAX's recall input: {recall_r}")

    W = timed(torch, "knn(pts, 10)", lambda: gl.weightmatrix.knn(pts, 10))
    ti = gl.trainsets.generate(y, rate=1, seed=0)
    model = gl.ssl.poisson(W)
    C0, V = timed(torch, "spectral_covariance(poisson(W), k=20)",
                  lambda: al.spectral_covariance(model, k=20))
    (info,) = model.graph.eigen_info.values()
    say(f"  {info['iters']} LOBPCG steps on {info['path']}")
    if "GatherAccel" not in info["path"]:
        raise SmokeFailure(f"ten clusters: the covariance ran on "
                           f"{info['path']}, not the gather")
    runs = {}
    for warm in (False, True):
        name = "warm" if warm else "cold"
        t = time.perf_counter()
        learner = al.active_learner(model, al.model_change, ti, y[ti],
                                    warm_start=warm, C=C0, V=V)
        steps, queries = [model.iters], []
        for _ in range(AL_TEN_ROUNDS):
            q = learner.select_queries(batch_size=AL_TEN_BATCH)
            learner.update(q, y[q])
            steps.append(model.iters)
            queries.append(np.sort(np.atleast_1d(q)))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        u = torch.as_tensor(learner.u)
        if warm and not u.is_cuda:
            raise SmokeFailure("ten clusters: the scores left the card")
        pred = torch.argmax(u, 1).cpu().numpy()
        acc = gl.ssl.ssl_accuracy(pred, y, learner.labeled_ind)
        runs[name] = (queries, pred)
        say(f"  {name} poisson learner on model_change: {secs:.3f} s for "
            f"{AL_TEN_ROUNDS} rounds of {AL_TEN_BATCH}, CG steps {steps} "
            f"(sum after the first fit {sum(steps[1:])}), final accuracy "
            f"{acc:.4f} % (JAX float32 {AL_REFERENCE['ten_accuracy']} %)")
        if abs(acc - AL_REFERENCE["ten_accuracy"]) > ACCURACY_MARGIN:
            raise SmokeFailure(
                f"ten/active learning ({name}): accuracy {acc:.4f} % "
                f"against JAX's {AL_REFERENCE['ten_accuracy']} %")
    (qc, pc), (qw, pw) = runs["cold"], runs["warm"]
    agree = float(np.mean(pc == pw))
    same = all(np.array_equal(a, b) for a, b in zip(qc, qw))
    say(f"  ten/active learning: warm and cold pick the same queries: "
        f"{same}; argmax agreement {agree:.6f}")
    if not same or agree < AL_AGREEMENT:
        raise SmokeFailure(f"ten/active learning: warm and cold differ "
                           f"(same queries {same}, agreement {agree})")


def al_solvers(torch, gl, W, labels, ti):
    """Phase 4f's ``utils`` solvers on the moons Laplacian:
    ``constrained_solve`` at the labels ``ti`` against scipy's f64 solve
    (at most SOLVE_MARGIN times the plain f32 masked solve's error) and
    ``constrained_solve_gmres`` at GMRES_RATE labels a class to
    GMRES_TOL, then at 5 labels a class and GMRES_STALL_TOL, where it
    stalls, its residual held to JAX's within GMRES_STALL_MARGIN."""
    import scipy.sparse as sp
    from graphlearning_tpu_torch import ssl as tssl
    from graphlearning_tpu_torch.solvers import gmres

    n = W.shape[0]
    L = gl.graph(W).laplacian()
    ti = np.sort(ti)           # g is read in the order of the mask
    g = labels[ti].astype(float)
    mask = np.zeros(n, bool)
    mask[ti] = True
    bdy = np.zeros(n)
    bdy[ti] = g
    u_ref = harmonic_reference(W, mask, bdy)
    u = timed(torch, "utils.constrained_solve(L, ti, g)",
              lambda: gl.utils.constrained_solve(L, ti, g))
    dev = gl.config.device()
    as_t = lambda a: torch.as_tensor(a, device=dev).to(
        gl.config.float_dtype(dev))
    u_p, _ = tssl._laplace_constrained(
        gl.graph(W).sparse, as_t(np.zeros(n)),
        torch.as_tensor(mask, device=dev), as_t(bdy), 1e-10)
    check_solve("utils.constrained_solve", torch.as_tensor(u), u_p, u_ref)

    R = sp.identity(n, format="csr")

    def solve(rate, tol):
        ind = np.sort(gl.trainsets.generate(labels, rate=rate, seed=0))
        bdy = np.zeros(n)
        bdy[ind] = labels[ind]
        info, real = {}, gmres.gmres

        def kept(*a, **k):             # keep the solver's own record
            return real(*a, **{**k, "info": info})

        gmres.gmres = kept
        try:
            x = timed(torch, f"utils.constrained_solve_gmres(L, 0, I, g, "
                      f"ti), {rate} labels a class, tol {tol:g}",
                      lambda: gl.utils.constrained_solve_gmres(
                          L, np.zeros(n), R, bdy, ind, tol=tol))
        finally:
            gmres.gmres = real
        res64 = gmres_residual(L, ind, bdy, x)
        say(f"  gmres: {info['restarts']} restarts, {info['steps']} steps, "
            f"preconditioned residual {info['residual']:.3e} (float64 on "
            f"the host: {res64:.4e}), tolerance "
            f"{tol * np.linalg.norm(bdy):.3e}")
        if not np.isfinite(x).all():
            raise SmokeFailure(f"gmres gave non-finite values: {info}")
        return x, bdy, ind, info, res64

    x, bdy, ind, info, _ = solve(GMRES_RATE, GMRES_TOL)
    mask = np.zeros(n, bool)
    mask[ind] = True
    say(f"  max|x - u_ref| "
        f"{np.abs(x - harmonic_reference(W, mask, bdy)).max():.3e}")
    if info["residual"] > GMRES_TOL * np.linalg.norm(bdy):
        raise SmokeFailure(f"gmres did not reach its tolerance: {info}")
    _, _, _, info, res64 = solve(5, GMRES_STALL_TOL)
    ref = AL_REFERENCE["gmres_stall_residual"]
    say(f"  gmres stalled: {res64:.4e} against JAX's float32 {ref:.4e} "
        f"({res64 / ref - 1:+.4f} relative, margin {GMRES_STALL_MARGIN})")
    if abs(res64 / ref - 1) > GMRES_STALL_MARGIN:
        raise SmokeFailure(f"stalled gmres residual {res64:.4e} not within "
                           f"{GMRES_STALL_MARGIN} of JAX's {ref:.4e}")


def al_checkpoints(torch, gl, bs, W, labels, ti):
    """Phase 4f's checkpoints on phase 4b's moons fits (the bf16 band),
    ``checkpoint_every=5`` in a temporary directory: PoissonMBO killed
    after its second save and run again, bit-equal to the fused fit and
    running only the rounds it had not saved (K2 bf16 launches); VolumeMBO
    at temperature 0.1 likewise, bit-equal to an uninterrupted
    checkpointed fit."""
    import tempfile

    priors = gl.utils.class_priors(labels)
    k2 = bs.band_tiles_spmm_packed
    with tempfile.TemporaryDirectory() as root:
        path = os.path.join(root, "poisson_mbo")

        def pmbo(**kw):
            m = MBO_FITS["poisson_mbo"](gl, W, priors, None)
            n0 = k2.bf16_launches
            pred = m.fit_predict(ti, labels[ti], **kw)
            return pred, m, k2.bf16_launches - n0

        pred0, m0, heat0 = timed(torch, "poisson_mbo, fused", pmbo)
        with killed_after(gl, 2):
            try:
                pmbo(checkpoint_path=path, checkpoint_every=5)
                raise SmokeFailure("poisson_mbo: the kill did not happen")
            except KilledFit:
                say("  poisson_mbo, checkpointed: killed after its second "
                    "save")
        saved = gl.checkpoint.load(path)[1]
        pred2, m2, heat2 = timed(torch, "poisson_mbo, resumed", lambda: pmbo(
            checkpoint_path=path, checkpoint_every=5))
        per = heat0 // m0.T
        say(f"  poisson_mbo: saved at round {saved} of {m0.T}; K2 bf16 "
            f"launches fused {heat0}, resumed {heat2} ({per} a round)")
        if heat0 != per * m0.T or heat2 != per * (m0.T - saved):
            raise SmokeFailure("poisson_mbo: the resumed fit ran rounds it "
                               "had saved")
        if not (np.array_equal(pred2, pred0)
                and np.array_equal(m2.prob, m0.prob)):
            raise SmokeFailure("poisson_mbo: the resumed fit differs from "
                               "the fused fit")
        say("  poisson_mbo: resumed bit-equal to the fused fit")

        def vmbo(path):
            m = MBO_FITS["volume_mbo_t0.1"](gl, W, priors, None)
            return m.fit_predict(ti, labels[ti], checkpoint_path=path,
                                 checkpoint_every=5), m

        ref, mref = timed(torch, "volume_mbo_t0.1, checkpointed", lambda: vmbo(
            os.path.join(root, "vmbo_ref")))
        vpath = os.path.join(root, "vmbo")
        with killed_after(gl, 2):
            try:
                vmbo(vpath)
                raise SmokeFailure("volume_mbo: the kill did not happen")
            except KilledFit:
                say("  volume_mbo_t0.1, checkpointed: killed after its "
                    "second save")
        saved = gl.checkpoint.load(vpath)[1]
        pred, m = timed(torch, "volume_mbo_t0.1, resumed", lambda: vmbo(vpath))
        say(f"  volume_mbo_t0.1: {mref.iters} iterations, resumed from "
            f"iteration {saved}")
        if not np.array_equal(pred, ref) or m.iters != mref.iters:
            raise SmokeFailure("volume_mbo_t0.1: the resumed fit differs "
                               "from the uninterrupted one")
        say("  volume_mbo_t0.1: resumed bit-equal to the uninterrupted "
            "checkpointed fit")


def al_phase(torch, gl, bs, W, labels, ti):
    """Phase 4f: active learning, the IVF search, the ``utils`` solvers and
    checkpointed fits."""
    t0 = time.perf_counter()
    say("== phase 4f: active learning on the moons band (n=65536, one label "
        "a class)")
    al_moons(torch, gl, bs, W, labels)
    say("== phase 4f on the ten-cluster input (n=70000, 20-d): the IVF "
        "search and a warm Poisson learner")
    al_ten(torch, gl)
    say("== phase 4f: the utils solvers on the moons Laplacian")
    al_solvers(torch, gl, W, labels, ti)
    say("== phase 4f: checkpointed MBO fits on the moons (bf16 band)")
    al_checkpoints(torch, gl, bs, W, labels, ti)
    say(f"== phase 4f: {time.perf_counter() - t0:.1f} s")


@contextlib.contextmanager
def wrapped(module, name, record):
    """``module.name`` timed and its result kept while inside the block:
    ``record`` gets one ``(seconds, result)`` a call, the seconds closed by
    a CUDA synchronize."""
    import torch

    real = getattr(module, name)

    def run(*a, **k):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        record.append((time.perf_counter() - t, out))
        return out

    setattr(module, name, run)
    try:
        yield
    finally:
        setattr(module, name, real)


def check_zero_mean(label, Y):
    m = float(np.abs(Y.mean(0)).max())
    say(f"  {label}: max |column mean| {m:.3e}, max |Y| "
        f"{float(np.abs(Y).max()):.4f}")
    if not np.isfinite(Y).all() or m > 1e-5 * float(np.abs(Y).max()):
        raise SmokeFailure(f"{label}: the embedding is not finite and "
                           f"zero-mean (max |mean| {m})")


def embed_ars(torch, gl, card):
    """Phase 4g's ARS: ``graph.ars`` on the ten-cluster points at n=70000
    (ARS_FULL_ITERS iterations) and on ARS_SUBSET of them (ARS_ITERS), the
    plan's seconds and an iteration's ms, the 10-NN label accuracy against
    JAX's, then ARS_REPLAY_ITERS iterations on the card and the CPU from
    the same P and start."""
    from graphlearning_tpu_torch import ars

    pts, y = ten_points(70000)
    for n, iters in ((len(pts), ARS_FULL_ITERS), (ARS_SUBSET, ARS_ITERS)):
        plans, loops = [], []
        t = time.perf_counter()
        with wrapped(ars, "_build_P", plans), \
                wrapped(ars, "_ars_iterate", loops):
            Y = gl.graph.ars(pts[:n], iters=iters)
        secs = time.perf_counter() - t
        (plan_s, P), = plans
        (loop_s, _), = loops
        acc = knn_label_accuracy(Y, y[:n])
        say(f"  graph.ars, n={n}, {iters} iterations: {secs:.3f} s; "
            f"_build_P {plan_s:.3f} s (P's ELL k={P.k}, nnz {P.nnz}), "
            f"{1000 * loop_s / iters:.3f} ms an iteration ({card}); "
            f"{ARS_KNN}-NN label accuracy {acc:.4f} %")
        check_zero_mean(f"graph.ars n={n}", Y)
        if Y.shape != (n, 2):
            raise SmokeFailure(f"graph.ars gave the shape {Y.shape}")
    ref = ARS_REFERENCE["knn_accuracy"]
    say(f"  n={ARS_SUBSET}: accuracy {acc:.4f} % against JAX's float32 "
        f"{ref} %")
    check_target(f"ars n={ARS_SUBSET}", acc, ref)

    X, Y0 = ars._preprocess(pts[:ARS_REPLAY_N], 2, True, 200, "pca")
    P = ars._build_P(X, 30)
    kw = dict(iters=ARS_REPLAY_ITERS, num_early=ARS_REPLAY_ITERS // 2,
              time_step=1.0, theta1=2.0, theta2=3.0, alpha=10.0, chunk=1024)
    Y0 = Y0.astype(np.float32)
    Yg = ars._ars_iterate(torch.as_tensor(Y0, device=P.device), P.cols,
                          P.vals, **kw).cpu().numpy()
    Yc = ars._ars_iterate(torch.as_tensor(Y0), P.cols.cpu(), P.vals.cpu(),
                          **kw).numpy()
    err = float(np.abs(Yg - Yc).max() / np.abs(Yc).max())
    say(f"  ars replay, n={ARS_REPLAY_N}, {ARS_REPLAY_ITERS} iterations, "
        f"card against CPU: {err:.3e} of max|Y| (tolerance "
        f"{ARS_REPLAY_TOL})")
    if not err <= ARS_REPLAY_TOL:
        raise SmokeFailure(f"ars replay: {err:.3e} > {ARS_REPLAY_TOL}")


def vae_replay(torch, wm, X, dev, draws, params):
    """VAE_REPLAY_STEPS steps on ``dev`` from ``params`` with the noise
    ``draws``; the latent means and the mean loss."""
    it = iter(draws)
    batch = draws[0].shape[0]
    model, hist = wm._vae_train(
        X, (400, 20), wm.vae_params_from_flax(params),
        lambda shape: next(it).to(dev), batch, 1, 1e-3, 0, dev)
    return wm._vae_encode(model, X, dev), hist[0]["loss"]


def embed_vae(torch, gl, card):
    """Phase 4g's VAE: ``weightmatrix.vae`` on the MNIST-shaped input for
    VAE_EPOCHS epochs (seconds and loss an epoch; the loss must fall), its
    latent means' kNN graph under Laplace and Poisson at one label a class
    against JAX's accuracies, then VAE_REPLAY_STEPS steps on the card and
    the CPU from carried-across parameters and CPU-drawn noise."""
    from graphlearning_tpu_torch import weightmatrix as wm

    pts, y = ten_points(70000)
    X = mnist_shaped(pts)
    runs = []
    t = time.perf_counter()
    with wrapped(wm, "_vae_train", runs):
        Z = gl.weightmatrix.vae(X, epochs=VAE_EPOCHS)
    secs = time.perf_counter() - t
    (train_s, (_, hist)), = runs
    say(f"  weightmatrix.vae(X, epochs={VAE_EPOCHS}), n={X.shape[0]}, "
        f"784 -> 400 -> 20: {secs:.3f} s, training {train_s:.3f} s, "
        f"{train_s / VAE_EPOCHS:.3f} s an epoch ({card})")
    prev = 0.0
    for e, h in enumerate(hist):
        say(f"    epoch {e + 1}: loss {h['loss']:.4f}, "
            f"{h['seconds'] - prev:.3f} s")
        prev = h["seconds"]
    if Z.shape != (X.shape[0], 20) or Z.dtype != np.float32 \
            or not np.isfinite(Z).all():
        raise SmokeFailure(f"vae: latent means {Z.shape} {Z.dtype}")
    if not hist[-1]["loss"] < hist[0]["loss"]:
        raise SmokeFailure("vae: the loss did not fall")
    W = timed(torch, "knn(Z, 10)", lambda: gl.weightmatrix.knn(Z, 10))
    ti = gl.trainsets.generate(y, rate=1, seed=0)
    for name in ("laplace", "poisson"):
        pred = getattr(gl.ssl, name)(W).fit_predict(ti, y[ti])
        acc = gl.ssl.ssl_accuracy(pred, y, ti)
        ref = VAE_REFERENCE[name]
        say(f"  {name} on knn(Z, 10), one label a class: {acc:.4f} % "
            f"(JAX float32 over seeds {VAE_SEEDS}: {ref})")
        check_target(f"vae/{name}", acc, min(ref))

    rs = np.random.RandomState(7)
    params = {"params": {
        name: {"kernel": rs.randn(i, o) / np.sqrt(i),
               "bias": rs.randn(o) * 0.01}
        for name, (i, o) in zip(
            ("Dense_0", "Dense_1", "Dense_2", "Dense_3", "Dense_4"),
            ((784, 400), (400, 20), (400, 20), (20, 400), (400, 784)))}}
    gen = torch.Generator().manual_seed(3)
    draws = [torch.randn((128, 20), generator=gen)
             for _ in range(VAE_REPLAY_STEPS)]
    Xr = wm._vae_data(X[:128 * VAE_REPLAY_STEPS])
    Zg, lg = vae_replay(torch, wm, Xr, gl.config.device(), draws, params)
    Zc, lc = vae_replay(torch, wm, Xr, torch.device("cpu"), draws, params)
    err = float(np.abs(Zg - Zc).max() / np.abs(Zc).max())
    say(f"  vae replay, {VAE_REPLAY_STEPS} steps from carried-across "
        f"parameters: card against CPU {err:.3e} of max|mu| (tolerance "
        f"{VAE_REPLAY_TOL}); mean loss {lg:.6f} / {lc:.6f}")
    if not err <= VAE_REPLAY_TOL:
        raise SmokeFailure(f"vae replay: {err:.3e} > {VAE_REPLAY_TOL}")


def embed_native(torch, gl, bs, W, labels, ti):
    """Phase 4g's oracles: ``native.dijkstra_host`` against
    ``graph.dijkstra`` on the band (K7) and on the plain path, 1e-5
    relative; ``hostpath.laplace_host`` against the Laplace fit on a
    NATIVE_LAPLACE_N-node moons graph, the same predictions."""
    from graphlearning_tpu_torch import native
    from graphlearning_tpu_torch.native import hostpath

    t = time.perf_counter()
    built = native.build()
    say(f"  native.build(): {time.perf_counter() - t:.3f} s "
        f"({'compiled' if built else 'up to date'})")
    d_host, _ = timed(torch, "native.dijkstra_host(W, ti)",
                      lambda: native.dijkstra_host(W, ti))
    G = gl.graph(W)
    n0 = bs.band_tiles_minplus.launches
    d_band = timed(torch, "band graph.dijkstra(ti)",
                   lambda: G.dijkstra(ti, bdy_val=0))
    k7 = bs.band_tiles_minplus.launches - n0
    with env("GLT_NO_ACCEL", "1"):
        d_plain = timed(torch, "plain graph.dijkstra(ti)",
                        lambda: gl.graph(W).dijkstra(ti, bdy_val=0))
    for label, d in (("band", d_band), ("plain", d_plain)):
        fin = np.isfinite(d_host)
        rel = float(np.max(np.abs(d[fin] - d_host[fin])
                           / np.maximum(np.abs(d_host[fin]), 1e-30)))
        say(f"  dijkstra_host against {label} graph.dijkstra: {rel:.3e} "
            f"relative" + (f", {k7} K7 launches" if label == "band" else ""))
        if not (np.array_equal(np.isinf(d), ~fin) and rel <= 1e-5):
            raise SmokeFailure(f"dijkstra_host against {label}: {rel}")
    if k7 < 1:
        raise SmokeFailure("the band dijkstra launched no K7")

    X4, y4 = two_moons(NATIVE_LAPLACE_N, 0.1, seed=0)
    W4 = gl.weightmatrix.knn(X4, 10)
    t4 = gl.trainsets.generate(y4, rate=5, seed=0)
    pred = gl.ssl.laplace(W4).fit_predict(t4, y4[t4])
    mask = np.zeros(NATIVE_LAPLACE_N, bool)
    mask[t4] = True
    bdy = np.zeros((NATIVE_LAPLACE_N, 2))
    bdy[t4] = np.eye(2)[y4[t4]]
    u = timed(torch, f"hostpath.laplace_host, n={NATIVE_LAPLACE_N}",
              lambda: hostpath.laplace_host(W4, mask, bdy, 0.0))
    differ = int(np.sum(np.argmax(u, 1) != pred))
    say(f"  laplace_host against ssl.laplace on the card: {differ} of "
        f"{NATIVE_LAPLACE_N} predictions differ")
    if differ:
        raise SmokeFailure(f"laplace_host: {differ} predictions differ")


def embed_observability(torch, gl, bs, W, labels, ti):
    """Phase 4g's ``observability``: one band Laplace fit inside ``trace``
    (a trace file must be written; whether it names K2's kernel is
    printed, not checked), then the same fit timed by ``Timer`` and by
    CUDA events."""
    import tempfile

    obs = gl.observability
    model = gl.ssl.laplace(W, tol=OBS_TOL)
    model.fit_predict(ti, labels[ti])            # the plan, K1
    with tempfile.TemporaryDirectory() as logdir:
        bs.reset_launches()
        t = time.perf_counter()
        with obs.trace(logdir) as prof:
            model.fit_predict(ti, labels[ti])
        secs = time.perf_counter() - t
        k2 = bs.launches()["band_tiles_spmm_packed"]
        files = os.listdir(logdir)
        if len(files) != 1:
            raise SmokeFailure(f"trace wrote {files}")
        with open(os.path.join(logdir, files[0])) as fh:
            events = json.load(fh).get("traceEvents", [])
        size = os.path.getsize(os.path.join(logdir, files[0]))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    named = [e for e in kernels if "tiles_spmm_kernel" in e.get("name", "")]
    busy = sum(e.get("dur", 0) for e in kernels) / 1e6
    say(f"  observability.trace around a band laplace fit (tol {OBS_TOL:g}, "
        f"{model.iters} CG steps): {secs:.3f} s, "
        f"{size} bytes, {len(events)} events, {len(kernels)} kernel "
        f"events ({busy:.4f} s of device time); K2 launches {k2}, K2 "
        f"(tiles_spmm_kernel) events {len(named)}")
    avg = [a for a in prof.key_averages() if "tiles_spmm_kernel" in a.key]
    say(f"  key_averages names K2: {bool(avg)}")
    if k2 < 1:
        raise SmokeFailure("the traced fit launched no K2")
    s0, e0 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with obs.Timer() as t:
        s0.record()
        pred = model.fit_predict(ti, labels[ti])
        e0.record()
        torch.cuda.synchronize()
    say(f"  the same fit: Timer {t.seconds:.4f} s, CUDA events "
        f"{s0.elapsed_time(e0) / 1000:.4f} s")
    res = obs.benchmark(lambda: model.fit_predict(ti, labels[ti]), iters=2)
    say(f"  observability.benchmark of the fit: {res}")
    if not np.isfinite(pred).all():
        raise SmokeFailure("the timed fit gave no prediction")


def embed_phase(torch, gl, bs, W, labels, ti):
    """Phase 4g: the embedding trainers, the host oracles and
    observability."""
    t0 = time.perf_counter()
    card = card_line()
    say("== phase 4g: ARS t-SNE on the ten-cluster points (20-d)")
    embed_ars(torch, gl, card)
    say("== phase 4g: the VAE on the MNIST-shaped input (n=70000, 784)")
    embed_vae(torch, gl, card)
    say("== phase 4g: the host oracles against the moons fits")
    embed_native(torch, gl, bs, W, labels, ti)
    say("== phase 4g: observability on a band Laplace fit")
    embed_observability(torch, gl, bs, W, labels, ti)
    say(f"== phase 4g: {time.perf_counter() - t0:.1f} s")


# Phase 4h (P15a): the sharded fits through ``model.distribute`` on a
# one-rank NCCL group, on the moons fit input at full width.  Each is held
# to the JAX package's float32 accuracy (REFERENCE_ACCURACY,
# MBO_REFERENCE; random walk has none) less ACCURACY_MARGIN, to the plain
# single-device fit (DIST_AGREEMENT; gradient descent's steps within
# ITERS_MARGIN), and its K3 launches to ``dist_k3_launches``.  Then the
# P=4 partition (DIST_P) of the same graph in one process: K1 and K3 of
# each block against their twins and the plain product.
DIST_FITS = {
    "laplace": lambda gl, W, priors: gl.ssl.laplace(W),
    "poisson_cg": lambda gl, W, priors: gl.ssl.poisson(W),
    "poisson_gd": lambda gl, W, priors: gl.ssl.poisson(
        W, solver="gradient_descent"),
    "randomwalk": lambda gl, W, priors: gl.ssl.randomwalk(W),
    "poisson_mbo": lambda gl, W, priors: gl.ssl.poisson_mbo(W, priors),
}
DIST_REFERENCE = {"laplace": REFERENCE_ACCURACY["laplace"],
                  "poisson_cg": REFERENCE_ACCURACY["poisson_cg"],
                  "poisson_gd": REFERENCE_ACCURACY["poisson_gd"],
                  "poisson_mbo": MBO_REFERENCE["poisson_mbo"]}
DIST_AGREEMENT = 0.99
DIST_P = 4
DIST_RW = 512            # the band geometry on CUDA: R = WT = 512


def dist_k3_launches(name, m):
    """K3's launches in one banded sharded fit: one a product of the
    solver, d <= 128 (the Laplace CG also applies L to the boundary
    values; PoissonMBO starts from a Poisson CG fit, then T rounds of Ns
    heat steps)."""
    if name == "laplace":
        return m.iters + 2
    if name in ("poisson_cg", "randomwalk"):
        return m.iters + 1
    if name == "poisson_gd":
        return 2 * m.iters
    return m.poisson_model.iters + 1 + m.T * m.Ns


# Phase 4h (P15b): every other family through ``distribute`` on the banded
# route in the same one-rank NCCL group, then K7 and K9 over the P=4
# partition's halos.  Each fit is held to its JAX float32 accuracy
# (REFERENCE_ACCURACY, MBO_REFERENCE; the eigenbasis models, the centered
# kernel and INCRES to P10B_REFERENCE's moons targets less P10B_MARGIN;
# spectral clustering to eigsh's accuracy, EIG_REFERENCE), to its plain
# one-device fit (DIST_AGREEMENT, graph NN DIST_NN_AGREEMENT, the
# eigenbasis models and INCRES P10B_AGREEMENT's bounds: unconverged
# solves, the walk's f32 sums on the band), and its K3, K7 and K9
# launches to
# ``p15b_launches``.  Sparse LP, one edge slice at world size 1, sums as
# the one-device fit does: bit-equal.
DIST_P15B_FITS = {
    "graph_nn": lambda gl, W, priors: FITS["graph_nn"](gl, W),
    "plaplace": lambda gl, W, priors: FITS["plaplace"](gl, W),
    "amle": lambda gl, W, priors: FITS["amle"](gl, W),
    "peikonal": lambda gl, W, priors: FITS["peikonal"](gl, W),
    "volume_mbo": lambda gl, W, priors: MBO_FITS["volume_mbo"](
        gl, W, priors, None),
    # the Gumbel noise of seed 0, drawn alike on every rank and one device
    "volume_mbo_t0.1": lambda gl, W, priors: MBO_FITS["volume_mbo_t0.1"](
        gl, W, priors, None),
    **{name: (lambda gl, W, priors, make=make: make(gl, W, priors))
       for name, make in P10B_FITS.items()},
    "sparse_lp": lambda gl, W, priors: gl.ssl.sparse_label_propagation(W),
}
DIST_NN_AGREEMENT = 0.999
DIST_COV_K = 20           # spectral_covariance of a distributed Laplace
DIST_COV_TOL = 2e-5       # its eigenvalues against the one-device solve's
HALO_SUM_TOL = 1e-6       # K9's sums over a halo block against its twin


def p15b_target(name):
    """``(target, margin)`` of a P15b fit's accuracy (%)."""
    if name in REFERENCE_ACCURACY:
        return REFERENCE_ACCURACY[name], ACCURACY_MARGIN
    if name in MBO_REFERENCE:
        return MBO_REFERENCE[name], MBO_MARGIN.get(name, ACCURACY_MARGIN)
    ref = P10B_REFERENCE["moons"]
    return (ref.get(f"{name}_eigsh", ref.get(name)),
            P10B_MARGIN["moons"].get(name, ACCURACY_MARGIN))


def lobpcg_total(m, K, steps):
    """K3's launches of one sharded LOBPCG solve of model ``m``
    (``lobpcg_launches`` on the power of its mesh's dtype, 8 in float32),
    0 when the operator kept the pairs (``steps`` 0)."""
    from graphlearning_tpu_torch.solvers import eig

    p = eig._default_power(m._dist._dtype())
    return sum(lobpcg_launches(K, steps, p).values()) if steps else 0


def guarded(gl, n, k):
    """The vectors a sharded solve of ``k`` pairs runs (the guard ones
    too, ``solvers.eig.guard_count``)."""
    from graphlearning_tpu_torch.solvers import eig

    return k + eig.guard_count(n, k)


def p15b_launches(gl, name, m, n):
    """``{kernel: launches}`` of one P15b fit on the banded route, from the
    code: K7 one a Bellman-Ford round (graph NN, the Lipschitz fits' and
    VolumeMBO's Voronoi starts), K9 one a Lipschitz Jacobi round (C = 2,
    one column block), K3 one a product of d <= 128 (VolumeMBO's dual
    convolution two an iteration; PoissonMBO's 800 heat steps; LOBPCG as
    ``lobpcg_total``, the modularity shift's 101 power
    steps before it; the centered kernel's 101 power steps and a product
    a fixed-point call of ``_while``; INCRES's grow calls).  p-eikonal
    and sparse LP launch none (the halo gather, the edge list)."""
    zero = {"band_tiles_minplus": 0, "band_tiles_lip": 0,
            "band_tiles_spmm": 0}
    if name == "graph_nn":
        return dict(zero, band_tiles_minplus=m.iters)
    if name in ("plaplace", "amle"):
        return dict(zero, band_tiles_minplus=m.info["voronoi_iters"],
                    band_tiles_lip=m.iters)
    if name.startswith("volume_mbo"):
        return dict(zero, band_tiles_minplus=m.voronoi_info["iters"],
                    band_tiles_spmm=2 * m.iters)
    if name == "poisson_spectral":
        return dict(zero, band_tiles_spmm=lobpcg_total(
            m, guarded(gl, n, m.spectral_cutoff + 1), m.iters))
    if name == "poisson_mbo_spectral":
        pm = m.poisson_model
        return dict(zero, band_tiles_spmm=m.T * m.Ns + lobpcg_total(
            pm, guarded(gl, n, pm.spectral_cutoff + 1), pm.iters))
    if name == "multiclass_mbo":
        return dict(zero, band_tiles_spmm=lobpcg_total(
            m, guarded(gl, n, m.num_eig), m.iters))
    if name == "modularity_mbo":
        return dict(zero, band_tiles_spmm=(101 + lobpcg_total(
            m, guarded(gl, n, 5 * 2), m.iters)) if m.iters else 0)
    if name == "centered_kernel":
        return dict(zero, band_tiles_spmm=m.power_it + 1
                    + while_calls(m.iters))
    if name == "spectral":
        return dict(zero, band_tiles_spmm=lobpcg_total(
            m, guarded(gl, n, m.num_clusters + m.extra_dim), m.iters))
    if name == "incres":
        return dict(zero, band_tiles_spmm=sum(while_calls(s)
                                              for s in m.steps))
    return zero


def p15b_fits(torch, gl, bs, W, labels, ti):
    """The P15b families on a one-rank NCCL group (already joined), on the
    banded route, each against its plain one-device fit; then the
    sharded Dijkstra distances and ``spectral_covariance`` of a
    distributed Laplace model.  Returns the launches of K3, K7 and K9 in
    these fits."""
    priors = gl.utils.class_priors(labels)
    n = W.shape[0]
    plain = {}
    with env("GLT_NO_ACCEL", "1"):
        for name, make in DIST_P15B_FITS.items():
            m = make(gl, W, priors)
            pred, accuracy, secs = dist_fit(torch, gl, name, m, labels, ti)
            say(f"  plain/{name}: {secs:.3f} s, accuracy {accuracy:.4f} %")
            plain[name] = (pred, m)
        for name, make in (("spectral", lambda: gl.clustering.spectral(W, 2)),
                           ("incres", lambda: gl.clustering.incres(
                               W, 2, seed=0))):
            m = make()
            t = time.perf_counter()
            pred = m.fit_predict()
            torch.cuda.synchronize()
            say(f"  plain/{name}: {time.perf_counter() - t:.3f} s, accuracy "
                f"{gl.clustering.clustering_accuracy(pred, labels):.4f} %")
            plain[name] = (pred, m)
        G = gl.graph(W)
        plain_d = G.dijkstra(ti, bdy_val=0, return_cp=True)
        plain_cov = gl.active_learning.spectral_covariance(
            gl.ssl.laplace(W), k=DIST_COV_K)
    cfg = gl.GLTConfig(sharded_kernel="banded")
    counted = ("band_tiles_minplus", "band_tiles_lip", "band_tiles_spmm")
    total = dict.fromkeys(counted, 0)

    def run(label, name, fit, m):
        before = bs.launches()
        torch.cuda.synchronize()
        t = time.perf_counter()
        pred = fit()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        got = {k: bs.launches()[k] - before[k] for k in counted}
        want = p15b_launches(gl, name, m, n)
        route = m._dist.route
        say(f"  {label}: {secs:.3f} s, route {route}, "
            f"{getattr(m, 'iters', None)} iterations, K3 "
            f"{got['band_tiles_spmm']}, K7 "
            f"{got['band_tiles_minplus']}, K9 {got['band_tiles_lip']}")
        if name != "sparse_lp" and route != "banded":
            raise SmokeFailure(f"{label} took the {route} route")
        if got != want:
            raise SmokeFailure(f"{label}: launches {got}, not {want}")
        for k in counted:
            total[k] += got[k]
        return pred

    for name, make in DIST_P15B_FITS.items():
        label = f"banded/{name}"
        m = make(gl, W, priors).distribute(cfg)
        pred = run(label, name, lambda: m.fit_predict(ti, labels[ti]), m)
        accuracy = gl.ssl.ssl_accuracy(pred, labels, ti)
        if name == "sparse_lp":
            diff = float(np.abs(m.prob - plain[name][1].prob).max())
            say(f"  {label}: accuracy {accuracy:.4f} %, max |u - plain u| "
                f"{diff:.3e}")
            if diff != 0.0:
                raise SmokeFailure(f"{label}: not bit-equal to the plain "
                                   "fit at world size 1")
            continue
        target, margin = p15b_target(name)
        check_target(label, accuracy, target, margin)
        limit = (DIST_NN_AGREEMENT if name == "graph_nn"
                 else P10B_AGREEMENT["moons"].get(name, DIST_AGREEMENT))
        check_agreement(label, pred, plain[name][0], limit)
    for name, make in (("spectral", lambda: gl.clustering.spectral(W, 2)),
                       ("incres", lambda: gl.clustering.incres(W, 2,
                                                               seed=0))):
        label = f"banded/{name}"
        m = make().distribute(cfg)
        pred = run(label, name, m.fit_predict, m)
        accuracy = gl.clustering.clustering_accuracy(pred, labels)
        if name == "spectral":
            check_target(label, accuracy,
                         EIG_REFERENCE["moons"]["eigsh_accuracy"])
            limit = EIG_AGREEMENT["moons"]
        else:
            # the one-device fit's draws: agreement as the band's (4d)
            say(f"  {label}: {sum(m.steps)} grow steps in {len(m.steps)} "
                f"rounds (plain {sum(plain[name][1].steps)})")
            target, margin = p15b_target("incres")
            check_target(label, accuracy, target, margin)
            limit = P10B_AGREEMENT["moons"]["incres"]
        agree = gl.clustering.clustering_accuracy(pred,
                                                  plain[name][0]) / 100.0
        say(f"  {label} agrees with the plain path on {agree:.4f} (up to a "
            "permutation)")
        if agree < limit:
            raise SmokeFailure(f"{label}: agreement {agree:.4f} < {limit}")

    from graphlearning_tpu_torch.parallel import execute

    dist = execute.Distributor(cfg)
    before = bs.launches()["band_tiles_minplus"]
    d, cp, rounds = execute.dijkstra_fit_sharded(dist, W, ti, 0, 1,
                                                 return_cp=True)
    got = bs.launches()["band_tiles_minplus"] - before
    total["band_tiles_minplus"] += got
    say(f"  banded/dijkstra: {rounds} rounds, K7 {got}")
    if got != rounds:
        raise SmokeFailure(f"banded/dijkstra: K7 {got} != {rounds} rounds")
    diff = check_distances("banded/dijkstra", (d, cp), plain_d, G)
    say(f"  banded/dijkstra: distances within 1e-5 relative of the "
        f"one-device fit, {diff} closest points differ (as close)")

    m = gl.ssl.laplace(W).distribute(cfg)
    before = bs.launches()["band_tiles_spmm"]
    t = time.perf_counter()
    C0, V = gl.active_learning.spectral_covariance(m, k=DIST_COV_K)
    secs = time.perf_counter() - t
    op = m._dist.operator(W)[0]
    steps = op._eig_memo[("normalized", DIST_COV_K, 0.0, 0)][2]
    got = bs.launches()["band_tiles_spmm"] - before
    total["band_tiles_spmm"] += got
    want = lobpcg_total(m, guarded(gl, n, DIST_COV_K), steps)
    err = float(np.abs(np.diag(C0) ** -1 - np.diag(plain_cov[0]) ** -1)
                .max())
    say(f"  banded/spectral_covariance(k={DIST_COV_K}): {secs:.3f} s, "
        f"{steps} LOBPCG steps, K3 {got}, eigenvalues within {err:.3e} of "
        "the one-device solve")
    if got != want:
        raise SmokeFailure(f"spectral_covariance: K3 {got}, not {want}")
    if err > DIST_COV_TOL:
        raise SmokeFailure(f"spectral_covariance: eigenvalues {err:.3e} "
                           f"off the one-device solve's")
    return total


def dist_fit(torch, gl, label, m, labels, ti):
    """One timed ``fit_predict`` of phase 4h: ``(pred, accuracy, s)``."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    pred = m.fit_predict(ti, labels[ti])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    accuracy = gl.ssl.ssl_accuracy(pred, labels, ti)
    return pred, accuracy, secs


def dist_fits(torch, gl, bs, W, labels, ti):
    """The banded and the ELL route on a one-rank NCCL group, then the
    P15b families (:func:`p15b_fits`): returns the launches of K1 and K3
    in the P15a banded fits, and of K3, K7 and K9 in the P15b fits."""
    import tempfile

    import torch.distributed as dist

    priors = gl.utils.class_priors(labels)
    plain = {}
    with env("GLT_NO_ACCEL", "1"):
        for name, make in DIST_FITS.items():
            m = make(gl, W, priors)
            pred, accuracy, secs = dist_fit(torch, gl, name, m, labels, ti)
            say(f"  plain/{name}: {secs:.3f} s, {m.iters} iterations, "
                f"accuracy {accuracy:.4f} %")
            plain[name] = (pred, m.iters)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            say(f"  process group: backend {dist.get_backend()}, world "
                f"size {dist.get_world_size()}")
            cfg = gl.GLTConfig(sharded_kernel="banded")
            bs.reset_launches()
            # each fit twice: the first builds the operator (RCM, the
            # plan, K1) and pays NCCL's first collective
            for name, make in DIST_FITS.items():
                for run in (1, 2):
                    label = f"banded/{name} (run {run})"
                    before = bs.launches()
                    m = make(gl, W, priors).distribute(cfg)
                    pred, accuracy, secs = dist_fit(torch, gl, name, m,
                                                    labels, ti)
                    got = {k: bs.launches()[k] - before[k] for k in (
                        "materialize_band_tiles", "band_tiles_spmm")}
                    op = m._dist.last_op
                    steps = (f"{m.iters} iterations" if name != "poisson_mbo"
                             else f"{m.poisson_model.iters} CG iterations + "
                             f"{m.T * m.Ns} heat steps")
                    say(f"  {label}: {secs:.3f} s, route {m._dist.route}, "
                        f"{steps}, accuracy {accuracy:.4f} %, K1 "
                        f"{got['materialize_band_tiles']}, K3 "
                        f"{got['band_tiles_spmm']} (B {op.n}, H {op.H}, "
                        f"{op.plan.slab_block.numel()} tiles, "
                        f"{op.n_residual} residual edges)")
                    if m._dist.route != "banded":
                        raise SmokeFailure(f"{label} took the "
                                           f"{m._dist.route} route")
                    want = dist_k3_launches(name, m)
                    if got["band_tiles_spmm"] != want:
                        raise SmokeFailure(f"{label}: "
                                           f"{got['band_tiles_spmm']} K3 "
                                           f"launches, not {want}")
                    if name in DIST_REFERENCE:
                        check_target(label, accuracy, DIST_REFERENCE[name])
                    check_agreement(label, pred, plain[name][0],
                                    DIST_AGREEMENT)
                    ref_iters = plain[name][1]
                    if (name == "poisson_gd" and abs(m.iters - ref_iters)
                            > ITERS_MARGIN * ref_iters):
                        raise SmokeFailure(
                            f"{label}: {m.iters} iterations against the "
                            f"plain path's {ref_iters}")
            launches = bs.launches()
            if launches["materialize_band_tiles"] < 1:
                raise SmokeFailure("the banded fits launched no K1")
            for run in (1, 2):
                label = f"gspmd/laplace (run {run})"
                before = bs.launches()
                m = DIST_FITS["laplace"](gl, W, priors).distribute(
                    gl.GLTConfig(sharded_kernel="gspmd"))
                pred, accuracy, secs = dist_fit(torch, gl, "laplace", m,
                                                labels, ti)
                say(f"  {label}: {secs:.3f} s, route {m._dist.route}, "
                    f"{m.iters} iterations, accuracy {accuracy:.4f} %")
                if (m._dist.route != "gspmd"
                        or bs.launches()["band_tiles_spmm"]
                        != before["band_tiles_spmm"]):
                    raise SmokeFailure(f"{label} did not take the ELL "
                                       "route")
                check_agreement(label, pred, plain["laplace"][0],
                                DIST_AGREEMENT)
            say("== phase 4h: the P15b families, banded, one rank")
            p15b = p15b_fits(torch, gl, bs, W, labels, ti)
        finally:
            dist.destroy_process_group()
    return launches, p15b


def partition_entries(torch, bs, W, launches, p15b):
    """The P=4 partition of the RCM-ordered moons graph in one process:
    K1 and K3 (d=2, over each block's halo-extended X, wrapped as the
    ring does) against their twins, the blocks' products with the
    residual edges against the plain product; the kernels' entries on the
    block with the most tiles; then K7 and K9 (:func:`halo_entries`)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from graphlearning_tpu_torch.parallel.band_shard import (
        build_band_partition)

    perm = np.asarray(reverse_cuthill_mckee(W, symmetric_mode=True))
    Wp = W[perm][:, perm].tocsr()
    n = Wp.shape[0]
    torch.cuda.synchronize()
    t = time.perf_counter()
    part = build_band_partition(Wp, DIST_P, R=DIST_RW, WT=DIST_RW,
                                device="cuda")
    torch.cuda.synchronize()
    tiles = [len(pl[0]) for pl in part.plans]
    say(f"  partition P={DIST_P}: {time.perf_counter() - t:.2f} s (host "
        f"plan and {DIST_P} K1), B {part.B}, H {part.H}, tiles {tiles}, "
        f"{len(part.res_rows)} residual edges")
    B, H = part.B, part.H
    gen = torch.Generator(device="cuda").manual_seed(16)
    X = torch.randn((part.n_pad, 2), generator=gen, device="cuda")
    X[n:] = 0.0
    out = torch.zeros_like(X)
    for p in range(DIST_P):
        cols, vals, tb, ts, R, WT = part.k1_inputs(p, "cuda")
        compare(f"K1 block {p}", part.bands[p],
                bs._materialize_band_tiles_plain(cols, vals, tb, ts, R, WT,
                                                 torch.float32), 1e-6)
        rows = (torch.arange(B + 2 * H, device="cuda") + p * B - H) \
            % part.n_pad
        plan = part.tiles_plan(p, "cuda")
        o = bs.band_tiles_spmm(part.bands[p], plan, X[rows])
        compare(f"K3 block {p} over its halo", o,
                bs._tiles_spmm_plain(part.bands[p], plan, X[rows]),
                TOL["float32"])
        out[p * B:(p + 1) * B] = o
    Xh = X.double().cpu().numpy()
    full = out.double().cpu().numpy()
    np.add.at(full, part.res_rows, part.res_vals[:, None]
              * Xh[part.res_cols])
    compare("the blocks and the residual against W @ X",
            torch.as_tensor(full[:n]), torch.as_tensor(Wp @ Xh[:n]),
            TOL["float32"])

    big = int(np.argmax(tiles))
    k1 = k1_entry(torch, bs, f"partition P={DIST_P}",
                  part.k1_inputs(big, "cuda"), torch.float32)
    k1["launches"] = launches["materialize_band_tiles"]
    sl = slice(big * B, (big + 1) * B)
    lc, bv = part.lcols[sl], part.band_vals[sl]
    keep = bv != 0
    local = sp.csr_matrix((bv[keep].astype(np.float32),
                           (np.nonzero(keep)[0], lc[keep])),
                          shape=(B, B + 2 * H))
    csr = torch.sparse_csr_tensor(
        torch.as_tensor(local.indptr.astype(np.int64)),
        torch.as_tensor(local.indices.astype(np.int64)),
        torch.as_tensor(local.data), size=local.shape).to("cuda")
    rows = (torch.arange(B + 2 * H, device="cuda") + big * B - H) \
        % part.n_pad
    Xloc = X[rows].contiguous()
    k3 = spmm_entry(torch, bs, "band_tiles_spmm", "sharded halo d=2",
                    part.bands[big], part.tiles_plan(big, "cuda"), Xloc,
                    lambda: torch.sparse.mm(csr, Xloc))
    # the products of phase 4h's fits, P15a's and P15b's
    k3["launches"] = launches["band_tiles_spmm"] + p15b["band_tiles_spmm"]
    return [k1, k3] + halo_entries(torch, bs, part, Wp, big, csr, p15b)


def halo_entries(torch, bs, part, Wp, big, csr, p15b):
    """K7 (the argmin, reciprocal and Hopf-Lax rounds) and K9 (C = 2 and
    10) on each block of the partition over its halo-extended d, f and U
    (wrapped as the ring does), against their twins: min and argmin
    equal, K9's sums within HALO_SUM_TOL of max|ref| and its min and max
    equal; the blocks' rounds with the residual edges against the
    one-device round on the ELL; the entries on the block with the most
    tiles, their launches those of the P15b fits (``p15b``)."""
    from graphlearning_tpu_torch.core.sparse import SparseGraph

    n, B, H, n_pad = part.n, part.B, part.H, part.n_pad
    gen = torch.Generator(device="cuda").manual_seed(17)
    d = torch.rand(n_pad, generator=gen, device="cuda") * 3.0
    f = torch.rand(n_pad, generator=gen, device="cuda") + 0.5
    U = torch.randn((n_pad, 10), generator=gen, device="cuda")
    for t in (d, f, U):
        t[n:] = 0.0
    spill = bs.residual_to_device(
        (np.zeros(0, np.int64), np.zeros((0, 1), np.int64),
         np.zeros((0, 1)), part.res_rows, part.res_cols, part.res_vals),
        "cuda", torch.float32)
    cols, vals, deg = SparseGraph.ell_from_scipy(Wp)
    cols = torch.as_tensor(cols.astype(np.int64), device="cuda")
    vals = torch.as_tensor(vals, device="cuda").float()
    mask = torch.arange(cols.shape[1], device="cuda")[None, :] < \
        torch.as_tensor(deg, device="cuda")[:, None]
    plans, chunks, rows_of = [], [], []
    for p in range(DIST_P):
        plans.append(part.tiles_plan(p, "cuda"))
        chunks.append(bs.tiles_live_chunks(part.bands[p], plans[p]))
        rows_of.append((torch.arange(B + 2 * H, device="cuda") + p * B - H)
                       % n_pad)
    for hopf, recip in ((False, False), (False, True), (True, False)):
        best = torch.full((n_pad,), bs.MINPLUS_BIG, device="cuda")
        arg = torch.full((n_pad,), -1, dtype=torch.int32, device="cuda")
        for p in range(DIST_P):
            r = rows_of[p]
            m, a = bs.band_tiles_minplus(part.bands[p], plans[p], d[r], f[r],
                                         hopf_lax=hopf, track_arg=True,
                                         recip=recip, chunks=chunks[p])
            rm, ra = bs._tiles_minplus_plain(part.bands[p], plans[p], d[r],
                                             f[r], hopf, True, recip)
            if not (torch.equal(m, rm) and torch.equal(a, ra)):
                raise SmokeFailure(f"K7 block {p} (hopf_lax={hopf}, "
                                   f"recip={recip}) differs from its twin")
            best[p * B:(p + 1) * B] = m
            arg[p * B:(p + 1) * B] = torch.where(
                a >= 0, ((a.long() + p * B - H) % n_pad).int(), -1)
        m_r, a_r = bs.residual_minplus(d, f, spill, hopf_lax=hopf,
                                       track_arg=True, recip=recip)
        better = m_r < best
        best = torch.where(better, m_r, best)[:n]
        arg = torch.where(better, a_r, arg)[:n]
        w = torch.where(vals > 0, 1.0 / torch.where(vals == 0, 1.0, vals),
                        0.0) if recip else vals
        dn, fn = d[cols], f[cols]
        if hopf:
            fw = w * fn
            cand = 0.5 * (fw + torch.sqrt(fw * fw + 4.0 * dn * dn))
        else:
            cand = dn + w * fn
        cand = torch.where(mask & (w > 0), cand, bs.MINPLUS_BIG)
        ref, slot = torch.min(cand, dim=1)
        ref_arg = torch.gather(cols, 1, slot[:, None])[:, 0].int()
        if not (torch.equal(best, ref) and torch.equal(arg, ref_arg)):
            raise SmokeFailure(f"K7's blocks and residual (hopf_lax={hopf}, "
                               f"recip={recip}) differ from the ELL round")
        say(f"  K7 over the {DIST_P} blocks' halos (hopf_lax={hopf}, "
            f"recip={recip}): min and argmin equal to the twins and, with "
            "the residual, to the one-device ELL round")
    for C in (2, 10):
        Uc = U[:, :C].contiguous()
        sums = torch.zeros((n_pad, C), device="cuda")
        mins, maxs = torch.zeros_like(sums), torch.zeros_like(sums)
        for p in range(DIST_P):
            Ur = Uc[rows_of[p]].contiguous()
            out = bs.band_tiles_lip(part.bands[p], plans[p], Ur, chunks[p])
            ref = bs._tiles_lip_plain(part.bands[p], plans[p], Ur)
            compare(f"K9 block {p} C={C} sums", out[0], ref[0],
                    HALO_SUM_TOL)
            if not (torch.equal(out[1], ref[1])
                    and torch.equal(out[2], ref[2])):
                raise SmokeFailure(f"K9 block {p} C={C}: min or max "
                                   "differs from its twin")
            sl = slice(p * B, (p + 1) * B)
            sums[sl], mins[sl], maxs[sl] = out
        s_r, mn_r, mx_r = bs.residual_lip(Uc, spill, n_pad)
        un = Uc[cols]
        m3 = mask[:, :, None]
        compare(f"K9's blocks and residual C={C} sums against W @ U",
                (sums + s_r)[:n].cpu(),
                torch.as_tensor(Wp @ Uc.double().cpu().numpy()[:n]),
                TOL["float32"])
        if not (torch.equal(torch.minimum(mins, mn_r)[:n], torch.amin(
                torch.where(m3, un, bs.LIP_BIG), dim=1))
                and torch.equal(torch.maximum(maxs, mx_r)[:n], torch.amax(
                    torch.where(m3, un, -bs.LIP_BIG), dim=1))):
            raise SmokeFailure(f"K9's blocks and residual C={C}: min or max "
                               "differs from the ELL round")
        say(f"  K9 over the blocks' halos C={C}: min and max equal to the "
            "twins and the ELL round")

    band, plan, r = part.bands[big], plans[big], rows_of[big]
    lchunks, list_ms = list_build_ms(torch, bs, band, plan,
                                     f"partition block {big}")
    sl = slice(big * B, (big + 1) * B)
    lc, bv = part.lcols[sl], part.band_vals[sl]
    keep = bv != 0
    coo = (torch.as_tensor(np.nonzero(keep)[0].astype(np.int64),
                           device="cuda"),
           torch.as_tensor(lc[keep].astype(np.int64), device="cuda"),
           torch.as_tensor(bv[keep], device="cuda").float())
    d_ext, f_ext = d[r].contiguous(), f[r].contiguous()
    k7 = k7_entry(torch, bs, "partition halo argmin", band, plan, lchunks,
                  d_ext, f_ext, False, False, True, coo=coo,
                  list_ms=list_ms)
    k7["launches"] = p15b["band_tiles_minplus"]
    out = [k7]
    for C in (2, 10):
        k9 = k9_entry(torch, bs, f"partition halo C={C}", band, plan,
                      lchunks, U[r][:, :C].contiguous(), csr=csr,
                      list_ms=list_ms)
        k9["launches"] = p15b["band_tiles_lip"]
        out.append(k9)
    return out


def dist_phase(torch, gl, bs, W, labels, ti):
    """Phase 4h: the sharded fits (P15a, P15b) on a one-rank NCCL group,
    then the P=4 partition's kernels.  Returns the K1, K3, K7 and K9
    entries."""
    t0 = time.perf_counter()
    say("== phase 4h: sharded fits on a one-rank NCCL group (the moons, "
        "n=65536)")
    launches, p15b = dist_fits(torch, gl, bs, W, labels, ti)
    say(f"== phase 4h: the P={DIST_P} partition's kernels, one process")
    entries = partition_entries(torch, bs, W, launches, p15b)
    say(f"== phase 4h: {time.perf_counter() - t0:.1f} s")
    return entries


# Phase 4i (P15c): the fit packs, the bench's sharded mode and the verbose
# MBO and INCRES fits on a mesh.
#
# The packs (``aot``) on the Poisson bench's ten-cluster input (n=70000,
# 20-d, one label a class), which ``maybe_build`` sends to the gather: each
# held to its model path (Poisson and Laplace agreeing on AOT_AGREEMENT,
# spectral clustering's labels at a clustering accuracy above AOT_SPECTRAL
# against the model path's), in-process and, for AOT_FRESH_KINDS, in a
# fresh process; another graph refused.  A fresh process's seconds from its start to its first
# prediction, with the pack and with the model path (the two processes
# started together), are printed, not gated.
AOT_N = 70000
AOT_AGREEMENT = 0.99
AOT_SPECTRAL = 95.0
# The sharded bench at the JAX bench's defaults (n=65536, k=10, d=64, 20
# chained products) on NCCL ranks, one card each: every route's chain
# within the exact grade of the scipy f64 chain, and at P=1 on the banded
# route K1 once and K3 once a product of every chain (the warm chain
# too), on the others no band kernel.
SHARDED_CHAIN_TOL = 1e-4
# PoissonMBO (T=20), VolumeMBO (temperature 0) and INCRES (seed 0, T =
# ALL_LABELS_INCRES_T rounds of the reference's host loop) with
# ``all_labels`` on the moons, banded, on a one-rank NCCL group, beside
# their one-device ``all_labels`` fits: as many rounds printed, the
# predictions agreeing on ALL_LABELS_AGREEMENT (INCRES by clustering
# accuracy), the launches by ``dist_k3_launches`` and ``p15b_launches``.
ALL_LABELS_AGREEMENT = 0.99
ALL_LABELS_INCRES_T = 50

# A fresh process's first prediction: ``python -c AOT_CHILD kind route
# dir`` loads W and the labels from ``dir``, fits by the pack or the
# model path, saves the prediction and prints its seconds from start.
AOT_CHILD = r"""
import sys, time
t0 = time.perf_counter()
import numpy as np
import scipy.sparse as sp
import torch
import graphlearning_tpu_torch as gl
kind, route, root = sys.argv[1:4]
W = sp.load_npz(root + "/W.npz")
z = np.load(root + "/labels.npz")
labels, ti = z["labels"], z["ti"]
if kind == "spectral":
    fit = (gl.aot.load_spectral_pack(W, root + "/spectral.pack")
           if route == "pack" else gl.clustering.spectral(W, 10).fit_predict)
    pred = fit()
elif route == "pack":
    load = getattr(gl.aot, "load_%s_pack" % kind)
    pred = load(W, root + "/%s.pack" % kind)(ti, labels[ti])
else:
    pred = getattr(gl.ssl, kind)(W).fit_predict(ti, labels[ti])
torch.cuda.synchronize()
secs = time.perf_counter() - t0
np.save(root + "/%s_%s.npy" % (kind, route), np.asarray(pred))
print(secs)
"""
AOT_KINDS = ("poisson", "laplace", "spectral")
# The kinds whose pack a fresh process loads beside the model path: its
# seconds are imports and the card's start, the same for every kind.
AOT_FRESH_KINDS = ("poisson",)


def aot_check(gl, label, against, kind, pred, ref):
    """A pack's prediction against another (``AOT_AGREEMENT``, or for
    spectral clustering a clustering accuracy above ``AOT_SPECTRAL``)."""
    if kind == "spectral":
        acc = gl.clustering.clustering_accuracy(pred, ref)
        say(f"  {label}: clustering accuracy {acc:.4f} % against {against}")
        if acc <= AOT_SPECTRAL:
            raise SmokeFailure(f"{label}: {acc:.4f} % <= {AOT_SPECTRAL} %")
        return
    check_agreement(label, pred, ref, AOT_AGREEMENT, against)


def aot_fresh(root, kind):
    """The first predictions of two fresh processes (``AOT_CHILD``) started
    together, one by the pack and one by the model path, so that they meet
    the same load: ``{route: prediction}``, each process's seconds from
    its start to its first prediction printed."""
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.abspath(__file__)))
    procs = {route: subprocess.Popen(
        [sys.executable, "-c", AOT_CHILD, kind, route, root],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for route in ("pack", "model")}
    preds = {}
    for route, proc in procs.items():
        out, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise SmokeFailure(f"fresh {route} {kind}: exit "
                               f"{proc.returncode}\n{out[-2000:]}"
                               f"{err[-4000:]}")
        secs = float(out.strip().splitlines()[-1])
        say(f"  fresh process, {route} {kind}: {secs:.3f} s from start to "
            "the first prediction")
        preds[route] = np.load(os.path.join(root, f"{kind}_{route}.npy"))
    return preds


def aot_phase(torch, gl):
    """The three packs of the ten-cluster input: saved, loaded and fitted
    in-process and (``AOT_FRESH_KINDS``) in fresh processes, each against
    its model path; another geometry and another kind refused."""
    import tempfile

    import scipy.sparse as sp

    from graphlearning_tpu_torch import bench
    from graphlearning_tpu_torch.ops import accel

    W, labels, ti = bench.ten_cluster_case(AOT_N, 10,
                                           torch.device("cuda"))
    ref = {}
    for kind in ("poisson", "laplace"):
        m = getattr(gl.ssl, kind)(W)
        ref[kind] = timed(torch, f"model path {kind}",
                          lambda: m.fit_predict(ti, labels[ti]))
        path = accel.path_name(m._accel_cache)
        say(f"  model path {kind}: {path}, accuracy "
            f"{gl.ssl.ssl_accuracy(ref[kind], labels, ti):.4f} %")
        if "gather" not in path:
            raise SmokeFailure(f"model path {kind} took {path}")
    sc = gl.clustering.spectral(W, 10)
    ref["spectral"] = timed(torch, "model path spectral", sc.fit_predict)
    if "gather" not in accel.path_name(sc.graph._accel_eig):
        raise SmokeFailure("model path spectral did not take the gather")
    pts, _ = bench.ten_cluster_points(AOT_N)
    W_half = gl.weightmatrix.knn(pts[:AOT_N // 2], 10)
    with tempfile.TemporaryDirectory() as root:
        packs = {kind: os.path.join(root, f"{kind}.pack")
                 for kind in AOT_KINDS}
        timed(torch, "save_poisson_pack",
              lambda: gl.aot.save_poisson_pack(W, 10, packs["poisson"]))
        timed(torch, "save_laplace_pack",
              lambda: gl.aot.save_laplace_pack(W, 10, packs["laplace"]))
        timed(torch, "save_spectral_pack",
              lambda: gl.aot.save_spectral_pack(W, 10, packs["spectral"]))
        sp.save_npz(os.path.join(root, "W.npz"), W)
        np.savez(os.path.join(root, "labels.npz"), labels=labels, ti=ti)
        in_proc = {}
        for kind in AOT_KINDS:
            load = getattr(gl.aot, f"load_{kind}_pack")
            fit = timed(torch, f"load_{kind}_pack (warm)",
                        lambda: load(W, packs[kind]))
            in_proc[kind] = timed(
                torch, f"pack {kind} fit",
                (lambda: fit()) if kind == "spectral"
                else (lambda: fit(ti, labels[ti])))
            aot_check(gl, f"pack {kind}", "the model path", kind,
                      in_proc[kind], ref[kind])
            try:
                load(W_half, packs[kind])
            except ValueError as e:
                if "geometry mismatch" not in str(e):
                    raise
                say(f"  pack {kind} refuses another graph: "
                    f"{str(e)[:60]}...")
            else:
                raise SmokeFailure(f"pack {kind} took another graph")
            other = packs["laplace" if kind != "laplace" else "poisson"]
            try:
                load(W, other)
            except ValueError as e:
                if f"not a {kind} pack" not in str(e):
                    raise
            else:
                raise SmokeFailure(f"load_{kind}_pack took another kind")
        for kind in AOT_FRESH_KINDS:
            fresh = aot_fresh(root, kind)
            aot_check(gl, f"fresh pack {kind}", "the fresh model path",
                      kind, fresh["pack"], fresh["model"])
            aot_check(gl, f"fresh pack {kind}", "the in-process pack", kind,
                      fresh["pack"], in_proc[kind])


def sharded_bench_phase(torch):
    """The bench's sharded mode on each route (``bench.sharded_bench``,
    NCCL ranks spawned, one card each), its line printed and held."""
    from graphlearning_tpu_torch import bench

    torch.cuda.empty_cache()
    for kernel in bench.SHARDED_KERNELS:
        cfg = bench.settings(mode="sharded", sharded_kernel=kernel)
        line = timed(torch, f"sharded bench, {kernel}",
                     lambda: bench.sharded_bench(cfg, torch.device("cuda")))
        say("  " + json.dumps(line))
        c = line["config"]
        if (c["n"], c["k"], c["d"], c["iters"]) != (65536, 10, 64, 20):
            raise SmokeFailure(f"sharded bench {kernel}: not the JAX "
                               f"bench's defaults: {c}")
        for P, err in c["rel_err_chain"].items():
            if not err <= SHARDED_CHAIN_TOL:
                raise SmokeFailure(f"sharded bench {kernel}, P={P}: chain "
                                   f"error {err:.3e} > {SHARDED_CHAIN_TOL}")
        # K3 once a product of every chain, the warm one too
        want = ({"materialize_band_tiles": 1,
                 "band_tiles_spmm": c["iters"] * len(c["chain_ms"]["1"])}
                if kernel == "banded" else {})
        if c["launches"]["1"] != want:
            raise SmokeFailure(f"sharded bench {kernel}, P=1: launches "
                               f"{c['launches']['1']}, not {want}")
        say(f"  sharded bench {kernel}, P=1: launches {want or 'none'}")


def all_labels_fit(torch, gl, name, m, labels, ti):
    """``(prediction, printed lines, seconds)`` of a fit with
    ``all_labels``."""
    import io

    buf = io.StringIO()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        if name == "incres":
            pred = m.fit_predict(all_labels=labels)
        else:
            pred = m.fit_predict(ti, labels[ti], all_labels=labels)
    torch.cuda.synchronize()
    return np.asarray(pred), buf.getvalue().splitlines(), (
        time.perf_counter() - t)


def all_labels_phase(torch, gl, bs, W, labels, ti):
    """PoissonMBO, VolumeMBO and INCRES with ``all_labels`` on a one-rank
    NCCL group, banded, on a fresh copy of the moons graph, beside their
    one-device fits."""
    import tempfile

    import torch.distributed as dist

    W = W.copy()
    priors = gl.utils.class_priors(labels)
    makes = {
        "poisson_mbo": lambda: MBO_FITS["poisson_mbo"](gl, W, priors, None),
        "volume_mbo": lambda: MBO_FITS["volume_mbo"](gl, W, priors, None),
        "incres": lambda: gl.clustering.incres(W, 2, T=ALL_LABELS_INCRES_T,
                                               seed=0)}
    one = {}
    for name, make in makes.items():
        pred, lines, secs = all_labels_fit(torch, gl, name, make(), labels,
                                           ti)
        say(f"  one device/{name}: {secs:.3f} s, {len(lines)} rounds "
            f"printed, the last: {lines[-1]!r}")
        one[name] = (pred, lines)
    kernels = ("materialize_band_tiles", "band_tiles_spmm",
               "band_tiles_minplus", "band_tiles_lip")
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            cfg = gl.GLTConfig(sharded_kernel="banded")
            start = bs.launches()
            for name, make in makes.items():
                before = bs.launches()
                m = make().distribute(cfg)
                pred, lines, secs = all_labels_fit(torch, gl, name, m,
                                                   labels, ti)
                got = {k: bs.launches()[k] - before[k] for k in kernels}
                say(f"  banded/{name}: {secs:.3f} s, route "
                    f"{m._dist.route}, {len(lines)} rounds printed, the "
                    f"last: {lines[-1]!r}; launches {got}")
                if m._dist.route != "banded":
                    raise SmokeFailure(f"{name} took {m._dist.route}")
                if len(lines) != len(one[name][1]):
                    raise SmokeFailure(f"banded/{name}: {len(lines)} rounds "
                                       f"printed, one device "
                                       f"{len(one[name][1])}")
                if name == "incres":
                    acc = gl.clustering.clustering_accuracy(pred,
                                                            one[name][0])
                    say(f"  banded/incres agrees with one device by "
                        f"clustering accuracy {acc:.4f} %")
                    if acc < 100 * ALL_LABELS_AGREEMENT:
                        raise SmokeFailure(f"banded/incres: {acc:.4f} %")
                    want = {"band_tiles_spmm": sum(
                        while_calls(s) for s in m.steps)}
                elif name == "poisson_mbo":
                    check_agreement(f"banded/{name}", pred, one[name][0],
                                    ALL_LABELS_AGREEMENT, "one device")
                    want = {"band_tiles_spmm": dist_k3_launches(name, m)}
                else:
                    check_agreement(f"banded/{name}", pred, one[name][0],
                                    ALL_LABELS_AGREEMENT, "one device")
                    want = p15b_launches(gl, name, m, W.shape[0])
                for k, v in want.items():
                    if got[k] != v:
                        raise SmokeFailure(f"banded/{name}: {got[k]} {k} "
                                           f"launches, not {v}")
            k1 = bs.launches()["materialize_band_tiles"] - start[
                "materialize_band_tiles"]
            if k1 != 1:
                raise SmokeFailure(f"the three fits launched K1 {k1} times, "
                                   "not once (one operator)")
        finally:
            dist.destroy_process_group()


def p15c_phase(torch, gl, bs, W, labels, ti):
    """Phase 4i: the packs, the sharded bench, the verbose fits on a
    mesh."""
    t0 = time.perf_counter()
    say("== phase 4i: fit packs on the ten-cluster input (n=70000, the "
        "gather)")
    aot_phase(torch, gl)
    say(f"== phase 4i: the sharded bench (n=65536, d=64, 20 products), "
        f"{torch.cuda.device_count()} card(s)")
    sharded_bench_phase(torch)
    say("== phase 4i: PoissonMBO, VolumeMBO and INCRES with all_labels, "
        "banded, one rank (the moons)")
    all_labels_phase(torch, gl, bs, W, labels, ti)
    say(f"== phase 4i: {time.perf_counter() - t0:.1f} s")


def card_line():
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def check_distances(label, band, plain, G_plain):
    """Distances within 1e-5 relative of the plain path's, unreached alike;
    where the closest points differ, the two seeds are equally close.
    Returns the number of closest points that differ."""
    (d_b, cp_b), (d_p, cp_p) = band, plain
    if not (np.array_equal(np.isinf(d_b), np.isinf(d_p))
            and np.allclose(d_b, d_p, rtol=1e-5, atol=0)):
        raise SmokeFailure(f"{label}: band distances differ from the plain "
                           "path beyond 1e-5 relative")
    diff = np.nonzero(cp_b != cp_p)[0]
    if len(diff):
        seeds = np.unique(np.concatenate([cp_b[diff], cp_p[diff]]))
        single = {s: call_single(G_plain, label, s) for s in seeds}
        db = np.array([single[s][i] for s, i in zip(cp_b[diff], diff)])
        dp = np.array([single[s][i] for s, i in zip(cp_p[diff], diff)])
        if not np.allclose(db, dp, rtol=1e-5, atol=0):
            raise SmokeFailure(f"{label}: a closest point differs and is "
                               "farther")
    return len(diff)


def call_single(G, label, seed):
    """Distances from one seed by the variant ``label`` of the calls."""
    if label == "dijkstra_hl":
        return G.dijkstra_hl([seed], bdy_val=0)
    return G.dijkstra([seed], bdy_val=0,
                      reciprocal_weights=label == "dijkstra_recip")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import graphlearning_tpu_torch as gl
    from graphlearning_tpu_torch.ops import _build, accel
    from graphlearning_tpu_torch.ops import band_spmm as bs

    say(f"== torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    reports = _build.build()
    say(f"== build: {time.perf_counter() - t0:.1f} s ({sorted(reports)})")
    for name, report in reports.items():
        for line in report.splitlines():
            # every instantiation of the K2/K3/K10/K11 CTA with its
            # registers and spills; the others' register and spill lines
            if ("registers" in line or "spill" in line
                    or (name == "band_tiles_spmm"
                        and "Compiling entry function" in line)):
                say(f"  {name}: {line.strip()}")

    t0 = time.perf_counter()
    entries = kernel_phase(torch, accel, bs)
    entries += plain_ell_phase(torch, gl)
    fit_entries, launches, (W, X, labels, ti, plain_pred) = fit_phase(
        torch, gl, accel, bs)
    dist_entries, dist_launches = distance_phase(torch, gl, accel, bs, W,
                                                 labels, ti)
    launches.update(dist_launches)
    mbo_entries, _ = mbo_phase(torch, gl, accel, bs, W, X, labels, ti)
    eig_entries, _ = eig_phase(torch, gl, accel, bs, W, labels)
    p10b_entries, _ = p10b_phase(torch, gl, accel, bs, W, labels, ti)
    # the plain ELL kernel's launches: the plain fits' and the trials'
    launches["plain_ell_spmm"] += trials_phase(torch, gl, bs, W, labels, ti)
    al_phase(torch, gl, bs, W, labels, ti)
    embed_phase(torch, gl, bs, W, labels, ti)
    shard_entries = dist_phase(torch, gl, bs, W, labels, ti)
    p15c_phase(torch, gl, bs, W, labels, ti)
    rect_entries, rect_launches = rect_phase(torch, gl, accel, bs, W, labels,
                                             ti, plain_pred)
    launches.update(rect_launches)
    say(f"== phases 2-5: {time.perf_counter() - t0:.1f} s")
    bench_entries, bench_launches = bench_phase(torch, accel, bs)
    launches.update(bench_launches)
    entries = (fit_entries + dist_entries + mbo_entries + eig_entries
               + p10b_entries + shard_entries + rect_entries + bench_entries
               + entries)
    for e in entries:
        # an entry of the MBO, eig or 4d phase carries that phase's count
        e.setdefault("launches", launches[e["name"]])
        e["route"] = "cuda"
        e["source"] = CU_FILE[e["name"]]
        e["replaces"] = REPLACES[e["name"]]
        e["name"] = f"{e['name']}[{e.pop('variant')}]"
    print(card_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
