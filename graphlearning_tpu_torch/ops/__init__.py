"""Graph operators and the band SpMM kernels of graphlearning_tpu_torch.

The package re-exports the plain operators of :mod:`ops.graphops`, as the
JAX package's ``ops`` does; the kernel modules (``band_spmm``, ``accel``,
``gather``) build their CUDA code at first launch, not on import.
"""
from graphlearning_tpu_torch.ops.graphops import (
    spmm,
    spmm_t,
    degree_vector,
    degree_vector_p,
    diagonal,
    laplacian_matvec,
    laplacian_diag,
    gradient,
    divergence,
    build_mirror,
    neighbor_min,
    neighbor_max,
    infinity_laplacian,
)

__all__ = [
    "spmm",
    "spmm_t",
    "degree_vector",
    "degree_vector_p",
    "diagonal",
    "laplacian_matvec",
    "laplacian_diag",
    "gradient",
    "divergence",
    "build_mirror",
    "neighbor_min",
    "neighbor_max",
    "infinity_laplacian",
]
