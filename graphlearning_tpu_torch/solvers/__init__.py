"""Iterative solvers of graphlearning_tpu_torch: conjugate gradients
(``cg``), graph distances and p-eikonal (``eikonal``), p-Laplace and AMLE
(``plaplace``), the volume-constrained assignment and MBO loops
(``volume``), LOBPCG (``lobpcg``) and the Laplacian eigensolvers over it
(``eig``), k-means (``kmeans``), the centered kernel method's solve
(``centered``), INCRES's rounds (``incres``) and PageRank
(``pagerank``)."""
from graphlearning_tpu_torch.solvers.cg import conjgrad, constrained_solve

__all__ = ["conjgrad", "constrained_solve"]
