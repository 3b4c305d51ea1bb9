"""What the harness takes from the program (``graphlearning_tpu_torch``):
the weight matrix as users build it from stored kNN data, and the modules
that the call shapes (:mod:`benchmark.calls`) drive.  The harness reaches
the program through this module alone, and it refuses a program loaded
from outside the checkout it runs in."""

from pathlib import Path

import graphlearning_tpu_torch as gl
from benchmark.lib.manifest import ROOT
from graphlearning_tpu_torch import config as gl_config
from graphlearning_tpu_torch import ssl as gl_ssl
from graphlearning_tpu_torch.ops import accel as gl_accel
from graphlearning_tpu_torch.ops import graphops as gl_graphops

if Path(gl.__file__).resolve().parents[1] != ROOT:
    raise ImportError(f"graphlearning_tpu_torch is loaded from {gl.__file__}, "
                      f"not from the checkout the benchmark runs in ({ROOT})")

__all__ = ["gl", "gl_accel", "gl_config", "gl_ssl", "plain_product",
           "weight_matrix"]


def weight_matrix(points, k, knn_data, device):
    return gl.weightmatrix.knn(points, k, knn_data=knn_data, device=device)


def plain_product(W, device):
    """``graphlearning_tpu_torch.ops.graphops.spmm`` on the graph's ELL,
    as the plain route runs it."""
    g = gl.graph(W, device=device).sparse

    def product(X):
        with gl_config.exact_matmul():
            return gl_graphops.spmm(g, X)

    return product
