"""Two interleaved half circles with Gaussian noise (sklearn's
``make_moons`` layout, points along each moon evenly spaced, then shuffled).

Frozen copy of ``chip_smoke.py:959-970`` (``two_moons``)."""

import numpy as np


def points(n, seed, noise=0.1):
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
