"""Graph construction and the VAE embedding (counterpart of
``graphlearning_tpu/weightmatrix.py``): kNN, epsilon-ball and grid graphs,
and ``vae``.

Brute-force search is a chunked distance matmul plus ``torch.topk`` on the
device; low-dimensional data takes a host cKDTree; the approximate search
("ivf", and "annoy", which routes to it) is an inverted-file search on the
device.  Kernel weights are computed on the device.  ``knn``,
``epsilon_ball`` and ``grid_graph`` return scipy CSR matrices, as the JAX
package does; ``knn_graph`` returns the device :class:`SparseGraph`.  The
kNN data of a named dataset is kept in ``knn_dir`` (a module attribute the
caller may reassign) as ``<dataset>_<metric>.npz`` with fields ``J``
(indices) and ``D`` (distances), the JAX package's files.  ``vae`` trains
the JAX package's VAE with autograd and the JAX package's Adam, in float32.
"""

from __future__ import annotations

import math
import os
import time

import numpy as np
import scipy.sparse as sparse
import torch

from graphlearning_tpu_torch import config, utils
from graphlearning_tpu_torch import observability as _obs
from graphlearning_tpu_torch.core.sparse import SparseGraph, segment_reduce

knn_dir = os.path.abspath(os.path.join(os.getcwd(), "knn_data"))


def _chunk_topk(Q, X, Xsq, k: int, similarity: str):
    """Top-k nearest of each query row in Q against all of X (one chunk).
    Returns ``(idx, dist)``."""
    if similarity in ("euclidean", "angular"):
        Qsq = torch.sum(Q * Q, dim=1)
        d2 = Qsq[:, None] - 2.0 * Q @ X.T + Xsq[None, :]
        score, idx = torch.topk(-d2, k, dim=1)
        dist = torch.sqrt(torch.clamp(-score, min=0.0))
    elif similarity == "dot":
        score, idx = torch.topk(Q @ X.T, k, dim=1)
        dist = -score                   # annoy 'dot' convention
    elif similarity == "hamming":
        q1 = torch.sum(Q, dim=1)
        x1 = torch.sum(X, dim=1)
        d = q1[:, None] + x1[None, :] - 2.0 * Q @ X.T
        score, idx = torch.topk(-d, k, dim=1)
        dist = -score
    elif similarity == "manhattan":
        d = torch.sum(torch.abs(Q[:, None, :] - X[None, :, :]), dim=2)
        score, idx = torch.topk(-d, k, dim=1)
        dist = -score
    else:
        raise ValueError(f"invalid similarity {similarity}")
    return idx, dist


def _brute_knn_device(X, k, similarity="euclidean", chunk_size=2048,
                      device=None):
    """Chunked all-pairs kNN on ``device``.  Returns ``(ind, dist)`` numpy
    arrays of shape (n, k), self first."""
    dev = config.device(device)
    dtype = config.float_dtype(dev)
    Xn = np.asarray(X, dtype=np.float64 if dtype == torch.float64
                    else np.float32)
    if similarity == "angular":
        Xn = Xn / np.maximum(np.linalg.norm(Xn, axis=1, keepdims=True), 1e-30)
    n = Xn.shape[0]
    k = min(k, n)
    Xd = torch.as_tensor(Xn, device=dev)
    Xsq = torch.sum(Xd * Xd, dim=1)
    if similarity == "manhattan":
        # materialises (chunk, n, d): keep its chunks small
        chunk_size = max(1, min(chunk_size,
                                (1 << 24) // max(1, n * Xn.shape[1])))
    inds, dists = [], []
    for s in range(0, n, chunk_size):
        idx, dist = _chunk_topk(Xd[s:s + chunk_size], Xd, Xsq, k, similarity)
        inds.append(idx)
        dists.append(dist)
    return (torch.cat(inds).cpu().numpy(), torch.cat(dists).cpu().numpy())


# The largest (G, M, p M) distance block of one IVF search step, in bytes:
# the clusters are searched G at a time (the JAX package's 1 << 27).
_IVF_BLOCK_BYTES = 1 << 27


def _ivf_knn_device(X, k, num_clusters=None, num_probe=16, kmeans_iters=10,
                    seed=0, device=None):
    """Approximate kNN by an inverted-file search on ``device``, the JAX
    package's replacement for annoy's trees:

    1. a coarse k-means of ``C`` clusters (about 64 points each), its
       starts drawn by ``np.random.RandomState(seed).choice`` as in JAX,
       ``kmeans_iters`` rounds of assignment and mean; the means are sums
       over the sorted assignment (:func:`segment_reduce`), the same in
       every run;
    2. each cluster's members in a table padded to the largest cluster,
       and each cluster's ``num_probe`` nearest clusters by centroid;
    3. every query of a cluster scans the members of its cluster's probes,
       exact distances and a top-k, clusters in groups whose distance
       block stays within ``_IVF_BLOCK_BYTES``.

    Returns numpy ``(ind, dist)`` of shape (n, k), self first."""
    dev = config.device(device)
    dtype = config.float_dtype(dev)
    Xn = np.asarray(X, dtype=np.float64 if dtype == torch.float64
                    else np.float32)
    n, d = Xn.shape
    k = min(k, n)
    C = min(int(num_clusters or max(8, min(4096, n // 64))), n)
    p = int(min(num_probe, C))
    Xd = torch.as_tensor(Xn, device=dev)
    Xsq = torch.sum(Xd * Xd, dim=1)

    with config.exact_matmul():
        cent = Xd[torch.as_tensor(np.random.RandomState(seed).choice(
            n, C, replace=False), device=dev)]

        def assign(cent):
            d2 = (Xsq[:, None] - 2.0 * Xd @ cent.T
                  + torch.sum(cent * cent, dim=1)[None, :])
            return torch.argmin(d2, dim=1)

        ones = torch.ones((n, 1), dtype=dtype, device=dev)
        for _ in range(kmeans_iters):
            a = assign(cent)
            sums = segment_reduce(torch.zeros((C, d + 1), dtype=dtype,
                                              device=dev), a,
                                  torch.cat([Xd, ones], dim=1), "sum")
            cnts = sums[:, d:]
            cent = torch.where(cnts > 0, sums[:, :d] / torch.clamp(cnts, 1.0),
                               cent)
        a = assign(cent).cpu().numpy()

    # member tables: cluster c's members in ascending index order, padded
    # with -1 to the largest cluster
    counts = np.bincount(a, minlength=C)
    M = int(counts.max())
    order = np.argsort(a, kind="stable")
    starts = np.cumsum(counts) - counts
    members = np.full((C, M), -1, np.int64)
    members[a[order], np.arange(n) - starts[a[order]]] = order
    cent_np = cent.cpu().numpy()
    cd2 = ((cent_np[:, None, :] - cent_np[None, :, :]) ** 2).sum(-1)
    probes = np.argsort(cd2, axis=1)[:, :p]

    members_t = torch.as_tensor(members, device=dev)
    probes_t = torch.as_tensor(probes, device=dev)
    ind_out = torch.zeros((n, k), dtype=torch.int64, device=dev)
    dist_out = torch.zeros((n, k), dtype=dtype, device=dev)
    G = max(1, _IVF_BLOCK_BYTES // max(1, M * p * M * Xd.element_size()))
    with config.exact_matmul():
        for s in range(0, C, G):
            cs = torch.arange(s, min(s + G, C), device=dev)
            q_idx = members_t[cs]                               # (G, M)
            cand = members_t[probes_t[cs]].reshape(len(cs), -1)  # (G, pM)
            cand_valid = cand >= 0
            cand_c = torch.clamp(cand, min=0)
            Q = Xd[torch.clamp(q_idx, min=0)]                   # (G, M, d)
            Cd = Xd[cand_c]                                     # (G, pM, d)
            d2 = (torch.sum(Q * Q, 2)[:, :, None]
                  - 2.0 * torch.bmm(Q, Cd.transpose(1, 2))
                  + torch.sum(Cd * Cd, 2)[:, None, :])
            d2 = torch.where(cand_valid[:, None, :], d2,
                             torch.full((), float("inf"), dtype=dtype,
                                        device=dev))
            score, local = torch.topk(-d2, k, dim=2)
            idx = torch.gather(cand_c[:, None, :].expand(-1, M, -1), 2,
                               local)
            valid = q_idx >= 0
            rows = q_idx[valid]              # each query once: no collisions
            ind_out[rows] = idx[valid]
            dist_out[rows] = torch.sqrt(torch.clamp(-score, min=0.0))[valid]
    return ind_out.cpu().numpy(), dist_out.cpu().numpy()


def knnsearch(X, k, method=None, similarity="euclidean", dataset=None,
              metric="raw", device=None):
    """kNN search: ``method`` is 'kdtree' (host cKDTree, the default for
    dim <= 5), 'brute' (device matmul + top-k, the default above), 'ivf'
    (the approximate inverted-file search on the device,
    :func:`_ivf_knn_device`, euclidean or angular) or 'annoy' (routed to
    'ivf', as in the JAX package).  The parameters are the JAX package's,
    in its order, with ``device`` last.
    With ``dataset`` the result is also written to
    ``knn_dir/<dataset>_<metric>.npz`` for :func:`load_knn_data`."""
    X = np.asarray(X)
    n, m = X.shape
    k = min(k, n)
    if method is None:
        method = "kdtree" if m <= 5 else "brute"
    if method == "annoy":
        method = "ivf"
    if method == "ivf":
        if similarity == "angular":
            X = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-30)
        elif similarity != "euclidean":
            raise ValueError("ivf knnsearch supports euclidean/angular "
                             "similarity")
        knn_ind, knn_dist = _ivf_knn_device(X, k, device=device)
    elif method == "kdtree":
        from scipy import spatial

        if similarity not in ("euclidean", "angular"):
            raise ValueError("Invalid choice of similarity " + similarity)
        Y = X
        if similarity == "angular":
            Y = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-30)
        knn_dist, knn_ind = spatial.cKDTree(Y).query(Y, k=k)
        if k == 1:
            knn_dist = knn_dist[:, None]
            knn_ind = knn_ind[:, None]
    elif method == "brute":
        knn_ind, knn_dist = _brute_knn_device(X, k, similarity=similarity,
                                              device=device)
    else:
        raise ValueError("Invalid choice of knnsearch method " + method)
    if dataset is not None:
        os.makedirs(knn_dir, exist_ok=True)
        np.savez_compressed(
            os.path.join(knn_dir, dataset.lower() + "_" + metric.lower()
                         + ".npz"), J=knn_ind, D=knn_dist)
    return knn_ind, knn_dist


def load_knn_data(dataset, metric="raw"):
    """``(J, D)``, the kNN indices and distances that :func:`knnsearch`
    stored for ``dataset`` and ``metric``, fetched from the GraphLearning
    repository when ``knn_dir`` lacks them."""
    fname = dataset.lower() + "_" + metric.lower() + ".npz"
    path = os.path.join(knn_dir, fname)
    if not os.path.exists(path):
        os.makedirs(knn_dir, exist_ok=True)
        utils.download_file(
            "https://github.com/jwcalder/GraphLearning/raw/master/kNNData/"
            + fname, path)
    return utils.numpy_load(path, "J"), utils.numpy_load(path, "D")


def _knn_weights_device(knn_ind, knn_dist, kernel: str):
    """Self-tuning kernel weights from kNN distances (tensors)."""
    k = knn_dist.shape[1]
    if kernel == "uniform":
        return torch.ones_like(knn_dist)
    if kernel == "gaussian":
        D = knn_dist * knn_dist
        eps = D[:, k - 1]
        return torch.exp(-4.0 * D / torch.clamp(eps[:, None], min=1e-30))
    if kernel == "symgaussian":
        eps = knn_dist[:, k - 1]
        return torch.exp(-4.0 * knn_dist * knn_dist
                         / torch.clamp(eps[:, None] * eps[knn_ind], min=1e-30))
    if kernel == "distance":
        return knn_dist
    if kernel == "singular":
        return 1.0 / torch.where(knn_dist == 0, torch.ones_like(knn_dist),
                                 knn_dist)
    raise ValueError("Invalid choice of kernel: " + kernel)


def knn(data, k, kernel="gaussian", eta=None, symmetrize=True, metric="raw",
        similarity="euclidean", knn_data=None, device=None):
    """kNN weight matrix as scipy CSR.  The parameters are the JAX
    package's, in its order, with ``device`` last.  Symmetrization per
    kernel as in the JAX package.  With ``data`` a dataset name, the kNN
    data stored for it under ``metric`` (:func:`load_knn_data`) is read in
    place of a search.  Low-dimensional (<= 3) point coordinates ride along as
    ``W._glt_points`` for the space-filling-curve ordering of
    ``ops.accel.AccelSpMM``."""
    with _obs.span("knn.build") as span:
        dev = config.device(device)
        k = k + 1                               # self counted in knn data
        if knn_data is not None:
            knn_ind, knn_dist = knn_data
        elif isinstance(data, str):
            knn_ind, knn_dist = load_knn_data(data, metric=metric)
        else:
            knn_ind, knn_dist = knnsearch(data, k, similarity=similarity,
                                          device=dev)
        n = knn_ind.shape[0]
        k = min(knn_ind.shape[1], k)
        knn_ind = np.asarray(knn_ind)[:, :k]
        knn_dist = np.asarray(knn_dist)[:, :k]

        if eta is None:
            weights = _knn_weights_device(
                torch.as_tensor(knn_ind.astype(np.int64), device=dev),
                torch.as_tensor(knn_dist, device=dev).to(
                    config.float_dtype(dev)),
                kernel).cpu().numpy()
        else:
            D = knn_dist * knn_dist
            eps = D[:, k - 1]
            weights = eta(D / np.maximum(eps[:, None], 1e-30))

        self_ind = np.repeat(np.arange(n), k)
        W = sparse.coo_matrix(
            (weights.flatten(), (self_ind, knn_ind.flatten())),
            shape=(n, n)).tocsr()
        if symmetrize:
            if kernel in ("distance", "uniform", "singular"):
                W = utils.sparse_max(W, W.T.tocsr())
            elif kernel == "symgaussian":
                WT = W.T.tocsr()
                W = W + WT.multiply(WT > W) - W.multiply(WT > W)
            else:
                W = (W + W.T) / 2
        W = sparse.csr_matrix(W)
        W.setdiag(0)
        W.eliminate_zeros()
        if np.ndim(data) == 2 and np.shape(data)[1] <= 3:
            W._glt_points = np.asarray(data)
        span.set(n=n, nnz=int(W.nnz))
    return W


def knn_graph(data, k, kernel="gaussian", similarity="euclidean",
              symmetrize=True, dtype=None, device=None):
    """:func:`knn` as the device :class:`SparseGraph` (padded ELL) on
    ``device``."""
    dev = config.device(device)
    W = knn(data, k, kernel=kernel, similarity=similarity,
            symmetrize=symmetrize, device=dev)
    return SparseGraph.from_scipy(W, dtype=dtype, device=dev)


# -- epsilon-ball and grid graphs ---------------------------------------------


def _ball_weights(dists2, epsilon, kernel, eta):
    """The weights of squared distances ``dists2`` in an ``epsilon`` ball,
    and the weight of a node with itself (0 for "distance")."""
    if eta is None:
        if kernel == "uniform":
            return np.ones_like(dists2), 1.0
        if kernel == "gaussian":
            return np.exp(-4 * dists2 / (epsilon * epsilon)), 1.0
        if kernel == "distance":
            return np.sqrt(dists2), 0.0
        if kernel == "singular":
            w = np.sqrt(dists2)
            w[dists2 == 0] = 1
            return 1 / w, 1.0
        raise ValueError("Invalid choice of kernel: " + kernel)
    return eta(dists2 / (epsilon * epsilon)), eta(0)


def epsilon_ball(data, epsilon, kernel="gaussian", features=None, epsilon_f=1,
                 eta=None):
    """The epsilon-ball weight matrix (scipy CSR, zero diagonal) from the
    pairs of a host cKDTree: weights by ``kernel`` or by ``eta`` of
    ``|x - y|^2 / epsilon^2``, times the same of the ``features`` at scale
    ``epsilon_f`` when given.  Data of 3 columns or fewer rides along as
    ``W._glt_points`` for the curve order of ``ops.accel.AccelSpMM``."""
    from scipy import spatial

    data = np.asarray(data)
    n = data.shape[0]
    M = np.array(list(spatial.cKDTree(data).query_pairs(epsilon)))
    if len(M) == 0:
        return sparse.csr_matrix((n, n))
    V = data[M[:, 0], :] - data[M[:, 1], :]
    weights, fzero = _ball_weights(np.sum(V * V, axis=1), epsilon, kernel,
                                   eta)
    if features is not None:
        VF = features[M[:, 0], :] - features[M[:, 1], :]
        fw, _ = _ball_weights(np.sum(VF * VF, axis=1), epsilon_f, kernel, eta)
        weights = weights * fw
        fzero = fzero**2
    weights = np.concatenate((weights, weights, fzero * np.ones(n)))
    M1 = np.concatenate((M[:, 0], M[:, 1], np.arange(n)))
    M2 = np.concatenate((M[:, 1], M[:, 0], np.arange(n)))
    W = sparse.csr_matrix(sparse.coo_matrix((weights, (M1, M2)),
                                            shape=(n, n)))
    W.setdiag(0)
    W.eliminate_zeros()
    if data.ndim == 2 and data.shape[1] <= 3:
        W._glt_points = data
    return W


def grid_graph(n, m=None, return_xy=False):
    """The 4-neighbour graph of an ``n`` by ``m`` grid (of an image's
    shape when ``m`` is None and ``n`` is the image), nodes row-major;
    with ``return_xy`` also each node's ``(x, y)``."""
    if m is None:
        s = np.asarray(n).shape
        m, n = s[1], s[0]
    xm, ym = np.meshgrid(np.arange(m), np.arange(n))
    c = (xm + m * ym).flatten()
    nbrs = [
        (np.clip(xm + 1, 0, m - 1) + m * ym).flatten(),
        (np.clip(xm - 1, 0, m - 1) + m * ym).flatten(),
        (xm + m * np.clip(ym + 1, 0, n - 1)).flatten(),
        (xm + m * np.clip(ym - 1, 0, n - 1)).flatten(),
    ]
    edges = np.vstack([np.vstack((c, nb)).T for nb in nbrs])
    edges = edges[edges[:, 0] != edges[:, 1]]
    W = sparse.coo_matrix((np.ones(len(edges)), (edges[:, 0], edges[:, 1])),
                          shape=(m * n, m * n)).tocsr()
    if return_xy:
        X = np.vstack((xm.flatten(), ym.flatten())).T.astype(float)
        return W, X
    return W


# -- VAE embedding (reference weightmatrix.py:467-646; JAX package
# weightmatrix.py:434-495) ---------------------------------------------------

# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def _lecun_normal(fan_in: int, fan_out: int, generator):
    """A (fan_out, fan_in) weight drawn as flax's ``lecun_normal`` draws a
    kernel (``jax.random.truncated_normal``): ``sqrt(2) erfinv(u)`` for ``u``
    uniform between ``erf(-sqrt(2))`` and ``erf(sqrt(2))``, a unit normal
    truncated at two standard deviations, scaled to variance
    ``1 / fan_in``."""
    b = math.erf(math.sqrt(2.0))
    u = torch.rand((fan_out, fan_in), generator=generator,
                   device=generator.device, dtype=torch.float32)
    z = (math.sqrt(2.0) * torch.erfinv(u * (2.0 * b) - b)).clamp_(-2.0, 2.0)
    return z * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)


class VAE(torch.nn.Module):
    """The JAX package's two-layer VAE: ``d -> h`` (relu), ``h -> z`` twice
    (mean and log-variance), ``z -> h`` (relu), ``h -> d`` (sigmoid).
    Layer names follow the reference's torch VAE."""

    def __init__(self, d: int, h: int, z: int, device=None):
        super().__init__()
        kw = {"device": device}
        self.fc1 = torch.nn.Linear(d, h, **kw)
        self.fc21 = torch.nn.Linear(h, z, **kw)
        self.fc22 = torch.nn.Linear(h, z, **kw)
        self.fc3 = torch.nn.Linear(z, h, **kw)
        self.fc4 = torch.nn.Linear(h, d, **kw)

    def encode(self, x):
        e = torch.relu(self.fc1(x))
        return self.fc21(e), self.fc22(e)

    def forward(self, x, eps):
        """``(out, mu, logvar)`` with the noise ``eps`` of shape (b, z)."""
        mu, logvar = self.encode(x)
        zs = mu + torch.exp(0.5 * logvar) * eps
        return torch.sigmoid(self.fc4(torch.relu(self.fc3(zs)))), mu, logvar


# flax's auto-named Dense layers, in call order, and the port's names
_FLAX_LAYERS = (("Dense_0", "fc1"), ("Dense_1", "fc21"), ("Dense_2", "fc22"),
                ("Dense_3", "fc3"), ("Dense_4", "fc4"))


def vae_params_from_flax(params):
    """The :class:`VAE` ``state_dict`` of the JAX package's flax parameter
    tree (numpy arrays; ``{"params": {...}}`` or its inner dict), kernels
    ``(in, out)`` turned into weights ``(out, in)``."""
    p = params.get("params", params)
    sd = {}
    for flax_name, name in _FLAX_LAYERS:
        sd[f"{name}.weight"] = torch.as_tensor(
            np.ascontiguousarray(np.asarray(p[flax_name]["kernel"]).T,
                                 dtype=np.float32))
        sd[f"{name}.bias"] = torch.as_tensor(
            np.array(p[flax_name]["bias"], dtype=np.float32))
    return sd


def _vae_init(d: int, h: int, z: int, generator):
    """Initial parameters as flax initializes ``nn.Dense``: LeCun-normal
    kernels and zero biases, drawn from ``generator`` in layer order."""
    sd = {}
    for (_, name), (fan_in, fan_out) in zip(
            _FLAX_LAYERS, ((d, h), (h, z), (h, z), (z, h), (h, d))):
        sd[f"{name}.weight"] = _lecun_normal(fan_in, fan_out, generator)
        sd[f"{name}.bias"] = torch.zeros(fan_out, dtype=torch.float32,
                                         device=generator.device)
    return sd


def _vae_loss(model, xb, eps):
    """The JAX package's loss: the BCE sum (1e-8 inside the logs) plus the
    KL divergence."""
    out, mu, logvar = model(xb, eps)
    bce = -torch.sum(xb * torch.log(out + 1e-8)
                     + (1 - xb) * torch.log(1 - out + 1e-8))
    kld = -0.5 * torch.sum(1 + logvar - mu**2 - torch.exp(logvar))
    return bce + kld


def _vae_train(X, layer_widths, params, noise, batch_size, epochs,
               learning_rate, seed, dev):
    """Train :class:`VAE` on the rows of ``X`` (float32 numpy, scaled) from
    the ``state_dict`` ``params``, with ``noise(shape)`` giving each step's
    (batch, z) draw.  The JAX package's batches (``RandomState(seed)``, one
    permutation an epoch, ``max(1, n // batch_size)`` steps) and Adam with
    optax's defaults and order of operations.  Returns ``(model,
    history)``, one ``{"loss", "seconds"}`` an epoch (the mean loss of its
    steps, and the seconds since the start, read after the loss)."""
    n, d = X.shape
    h, z = int(layer_widths[0]), int(layer_widths[1])
    # built on the meta device: nn.Linear's own init draws nothing
    model = VAE(d, h, z, device="meta").to_empty(device=dev)
    model.load_state_dict(params)
    Xd = torch.as_tensor(X, device=dev)
    ps = list(model.parameters())
    mu = [torch.zeros_like(p) for p in ps]
    nu = [torch.zeros_like(p) for p in ps]
    b1, b2, eps = 0.9, 0.999, 1e-8
    steps_per_epoch = max(1, n // batch_size)
    rs = np.random.RandomState(seed)
    history, t0, count = [], time.perf_counter(), 0
    for _ in range(epochs):
        perm = torch.as_tensor(rs.permutation(n), device=dev)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(steps_per_epoch):
            xb = Xd[perm[i * batch_size:(i + 1) * batch_size]]
            loss = _vae_loss(model, xb, noise((xb.shape[0], z)))
            grads = torch.autograd.grad(loss, ps)
            count += 1
            # optax.adam's update, op for op, over all tensors at once
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
            g2 = torch._foreach_mul(grads, grads)
            torch._foreach_mul_(g2, 1.0 - b2)
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, g2)
            den = torch._foreach_div(nu, 1.0 - b2**count)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, eps)
            upd = torch._foreach_div(torch._foreach_div(mu, 1.0 - b1**count),
                                     den)
            torch._foreach_mul_(upd, -learning_rate)
            with torch.no_grad():
                torch._foreach_add_(ps, upd)
            total += loss.detach()
        history.append({"loss": float(total) / steps_per_epoch,
                        "seconds": time.perf_counter() - t0})
    return model, history


def _vae_encode(model, X, dev):
    """The latent means of the rows of ``X``, in blocks of 4096, as
    float32 numpy."""
    with torch.no_grad():
        return np.concatenate([
            model.encode(torch.as_tensor(X[s:s + 4096], device=dev))[0]
            .cpu().numpy() for s in range(0, X.shape[0], 4096)], axis=0)


def _vae_data(data):
    """The training rows: float32, scaled by the largest value."""
    X = np.asarray(data, dtype=np.float32)
    return X / max(1e-12, X.max())


def vae(data, layer_widths=(400, 20), no_cuda=False, batch_size=128,
        epochs=100, learning_rate=1e-3, seed=0, device=None):
    """Train a two-layer VAE on raw data and return the latent means, used
    to build ``metric='vae'`` graphs.  The parameters of the JAX package's
    ``vae`` in its order, with ``device`` last; ``no_cuda=True`` asks for
    the CPU, as in the reference.  The initial parameters and each step's
    noise come from one ``torch.Generator`` on the device seeded by
    ``seed``; the batches from ``RandomState(seed)`` on the host, as in
    the JAX package.  Trains in float32; returns float32 numpy (n, z)."""
    dev = config.device("cpu" if no_cuda else device)
    X = _vae_data(data)
    n, d = X.shape
    h, z = int(layer_widths[0]), int(layer_widths[1])
    gen = config.generator(seed, dev)
    params = _vae_init(d, h, z, gen)
    noise = lambda shape: torch.randn(shape, generator=gen, device=dev,
                                      dtype=torch.float32)
    model, _ = _vae_train(X, (h, z), params, noise, batch_size, epochs,
                          learning_rate, seed, dev)
    return _vae_encode(model, X, dev)
