"""A mixture of ten unit Gaussians in 20 dimensions.

Frozen copy of ``graphlearning_tpu_torch/bench.py:423-429``
(``ten_cluster_points``), with the seed an argument in place of 0; ``dim``
and ``classes`` keep that function's 20 and 10 unless a configuration
states otherwise."""

import numpy as np


def points(n, seed, dim=20, classes=10):
    rs = np.random.RandomState(seed)
    centers = rs.randn(classes, dim)
    labels = rs.randint(0, classes, n)
    return centers[labels] + rs.randn(n, dim), labels
