"""Iterative solvers of graphlearning_tpu_torch: conjugate gradients
(``cg``), graph distances and p-eikonal (``eikonal``), p-Laplace and AMLE
(``plaplace``), and the volume-constrained assignment and MBO loops
(``volume``)."""
