"""Exact k-nearest-neighbour data, as GraphLearning stores it (``kNNData``):
``(ind, dist)``, each ``(n, k + 1)``, each row's own node first at
distance 0, then its k nearest others by increasing Euclidean distance.

:func:`kdtree` searches on the host (``scipy.spatial.cKDTree``), for
points of a few dimensions; :func:`brute` searches on a torch device by
blocked float64 distances, for points of many dimensions."""

import numpy as np
import torch


def kdtree(points, k, workers=4):
    from scipy import spatial

    dist, ind = spatial.cKDTree(points).query(points, k + 1, workers=workers)
    return ind.astype(np.int64), dist


def brute(points, k, device, block=2048):
    X = torch.as_tensor(np.asarray(points), dtype=torch.float64, device=device)
    n = X.shape[0]
    sq = torch.sum(X * X, dim=1)
    ind = torch.empty((n, k + 1), dtype=torch.int64, device=device)
    dist = torch.empty((n, k + 1), dtype=torch.float64, device=device)
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        d2 = sq[r0:r1, None] + sq[None, :] - 2.0 * (X[r0:r1] @ X.T)
        d2.clamp_(min=0.0)
        rows = torch.arange(r0, r1, device=device)
        d2[rows - r0, rows] = -1.0                 # the node itself first
        val, idx = torch.topk(d2, k + 1, dim=1, largest=False, sorted=True)
        ind[r0:r1] = idx
        dist[r0:r1] = torch.sqrt(val.clamp(min=0.0))
    return ind.cpu().numpy(), dist.cpu().numpy()
