"""graphlearning_tpu_torch: the PyTorch/CUDA port of graphlearning_tpu.

The same flat namespace on torch tensors, running on an NVIDIA GPU by
default (see :mod:`config`).  Ported so far:

* the main path of semi-supervised learning on a kNN graph:
  ``weightmatrix.knn`` -> ``trainsets.generate`` -> ``ssl.laplace`` /
  ``ssl.poisson`` / ``ssl.randomwalk`` -> ``ssl.ssl_accuracy``, with the
  band SpMM on hand-written CUDA kernels (``ops/band_spmm.py``,
  ``csrc/``);
* graph distances and Lipschitz learning: ``graph.dijkstra`` /
  ``dijkstra_hl`` / ``distance_matrix`` / ``peikonal`` / ``plaplace`` /
  ``amle`` and ``ssl.graph_nearest_neighbor`` / ``ssl.plaplace`` /
  ``ssl.amle`` / ``ssl.peikonal`` (``solvers/eikonal.py``,
  ``solvers/plaplace.py``), on the band's min-plus and Lipschitz kernels
  where it applies;
* the low-label-rate models: ``ssl.poisson_mbo``, ``ssl.volume_mbo``
  (``solvers/volume.py``, with ``utils.class_priors``) and the
  reweighted Laplace fits, ``ssl.laplace(reweighting=...)`` over
  ``graph.reweight``, on the bf16 band or the segmented gather where
  ``ops.accel.maybe_build`` takes one;
* the eigensolvers and spectral clustering: ``graph.eigen_decomp`` /
  ``eigen_decomp_device`` / ``fiedler_vector`` / ``diffusion_map``
  (LOBPCG, ``solvers/lobpcg.py`` and ``solvers/eig.py``, its operator on
  the band or the gather where ``maybe_build`` takes one),
  ``utils.randomized_svd`` / ``dirichlet_eigenvectors``, and
  ``clustering.spectral`` with the device k-means (``solvers/kmeans.py``),
  ``clustering.clustering_accuracy`` and ``purity``;
* the eigenbasis models and the rest of clustering: ``ssl.poisson`` /
  ``ssl.poisson_mbo`` with ``solver="spectral"``, ``ssl.multiclass_mbo``,
  ``ssl.modularity_mbo``, ``ssl.centered_kernel``, ``clustering.incres``
  / ``fokker_planck`` / ``withinss`` / ``RP1D`` and ``graph.page_rank``;
* label propagation (``ssl.dynamic_label_propagation``,
  ``ssl.sparse_label_propagation``) and the experiment harness:
  ``datasets``, ``trainsets.load``, the stored kNN data of
  ``weightmatrix.knnsearch`` / ``load_knn_data`` / ``knn(name, k)``, the
  host methods of ``graph``, ``warmup`` and ``ssl_trials`` with its
  batched Laplace and Poisson fits, ``trials_statistics``,
  ``ssl.accuracy_table`` and ``ssl.accuracy_plot``;
* active learning (``active_learning``: the query loop with warm-started
  Laplace and Poisson refits, uncertainty sampling and the covariance
  acquisitions over ``spectral_covariance``), solver-state checkpoints
  (``checkpoint``; ``fit(..., checkpoint_path=, checkpoint_every=)`` of
  PoissonMBO and VolumeMBO), the epsilon-ball and grid graphs,
  ``weightmatrix.knn_graph`` and the approximate kNN search
  (``knnsearch(method="ivf")``), and the ``utils`` solvers (CG, the
  constrained solves, GMRES), samplers, boundary statistic and image
  helpers;
* the embedding trainers: ARS t-SNE (``ars.ars``, ``graph.ars``; exact
  all-pairs repulsion in row chunks) and ``weightmatrix.vae`` (autograd
  and the JAX package's Adam), the exact serial host oracles of
  ``native`` (built from the port's own ``native/oracles.cpp`` with g++)
  and ``native.hostpath.laplace_host``, and ``observability`` (``trace``
  over ``torch.profiler``, ``Timer``, ``benchmark``, ``Counters``, and
  ``span``, fed at the fit path's layer boundaries);
* the distribution layer: ``GLTConfig``, ``parallel`` (the mesh over
  ``torch.distributed`` with its node and batch axes, row-sharded
  graphs, the partitioned band on K1, K3, K7 and K9 with a ring halo, the
  ``Distributor``) and ``model.distribute(...)`` of every SSL family but
  dynamic label propagation, of spectral clustering and of INCRES, and
  the bench's sharded mode (``GLT_BENCH_MODE=sharded``);
* fit packs (``aot``): the Poisson, Laplace and spectral-clustering fits
  of a graph on the segmented gather, saved once and loaded in a fresh
  process.

    import graphlearning_tpu_torch as gl
    W = gl.weightmatrix.knn(X, 10)
    train_ind = gl.trainsets.generate(labels, rate=5)
    pred = gl.ssl.laplace(W).fit_predict(train_ind, labels[train_ind])
"""

from graphlearning_tpu_torch import config
from graphlearning_tpu_torch.config import GLTConfig
from graphlearning_tpu_torch.core.sparse import BucketedELL, SparseGraph
from graphlearning_tpu_torch.core.graphclass import graph
from graphlearning_tpu_torch import ops, solvers, utils, weightmatrix
from graphlearning_tpu_torch import clustering, datasets, ssl, trainsets
from graphlearning_tpu_torch import active_learning, checkpoint
from graphlearning_tpu_torch import ars, native, observability, parallel
from graphlearning_tpu_torch import aot
from graphlearning_tpu_torch.ssl import warmup

__version__ = "0.1.0"

__all__ = [
    "BucketedELL",
    "SparseGraph",
    "graph",
    "GLTConfig",
    "warmup",
    "config",
    "ops",
    "solvers",
    "utils",
    "weightmatrix",
    "ssl",
    "clustering",
    "datasets",
    "trainsets",
    "active_learning",
    "checkpoint",
    "ars",
    "native",
    "observability",
    "parallel",
    "aot",
]
