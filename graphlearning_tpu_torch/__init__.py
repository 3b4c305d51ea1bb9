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
  / ``fokker_planck`` / ``withinss`` / ``RP1D`` and ``graph.page_rank``.

    import graphlearning_tpu_torch as gl
    W = gl.weightmatrix.knn(X, 10)
    train_ind = gl.trainsets.generate(labels, rate=5)
    pred = gl.ssl.laplace(W).fit_predict(train_ind, labels[train_ind])
"""

from graphlearning_tpu_torch import config
from graphlearning_tpu_torch.core.sparse import BucketedELL, SparseGraph
from graphlearning_tpu_torch.core.graphclass import graph
from graphlearning_tpu_torch import ops, solvers, utils, weightmatrix
from graphlearning_tpu_torch import clustering, ssl, trainsets

__version__ = "0.1.0"

__all__ = [
    "BucketedELL",
    "SparseGraph",
    "graph",
    "config",
    "ops",
    "solvers",
    "utils",
    "weightmatrix",
    "ssl",
    "clustering",
    "trainsets",
]
