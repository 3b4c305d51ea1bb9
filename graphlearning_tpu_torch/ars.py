"""Attraction-Repulsion Swarming t-SNE (ARS), counterpart of
``graphlearning_tpu/ars.py``.

The reference's C ARS t-SNE (``c_code/tsne.cpp``, ``c_code/sptree.cpp``;
entry point ``graph.py:1494-1609``), as the JAX package computes it:

* perplexity calibration = batched bisection over all points at once, a
  fixed trip count (reference: serial per-point binary search,
  ``tsne.cpp:489-589``);
* attraction = edge-wise force over the padded-ELL graph of ``P``, summed
  over the fixed k axis (reference: CSR edge loop ``sptree.cpp:381-408``);
* repulsion = **exact** all-pairs computation in row chunks (reference:
  Barnes-Hut quadtree, ``sptree.cpp:340-378``).

Math (``tsne.cpp:271-295``):

  pos_f[i] = sum_j P_ij (y_i - y_j) / (1 + |y_i - y_j|^theta1)
  neg_f[i] = sum_{j != i} q_ij psi_ij (y_i - y_j) / sum_{j != i} q_ij
             with q = 1/(1+D2), psi = 1/(1+D2^(theta2/2))
  dC = alpha * pos_f - neg_f     (early exaggeration; alpha=1 after)
  Y <- Y - dt * dC / alpha       (early;  Y - dt * dC after)
  Y <- Y - mean(Y)

The iterate runs in float32 on every device, as the JAX package's does;
the calibration follows its input's dtype.  Unlike the JAX package, which
pads n to a multiple of ``chunk`` for ``lax.map``'s static shapes, the
repulsion loops over the chunks with a shorter last one.
"""

from __future__ import annotations

import numpy as np
import torch

from graphlearning_tpu_torch import config


def _calibrate_perplexity(knn_d2, perplexity, num_iter=64):
    """Per-row Gaussian bandwidth bisection: find beta_i with
    H_i(beta) = log(perplexity), H = beta*<d2, p>/sum p + log sum p
    (reference ``tsne.cpp:536-588``), for all rows at once in a fixed
    number of steps.  ``knn_d2``: an (n, K) tensor; returns the
    row-normalized P of its shape and dtype."""
    d2 = knn_d2
    logU = float(np.log(perplexity))
    n = d2.shape[0]
    beta = torch.ones((n,), dtype=d2.dtype, device=d2.device)
    lo = torch.zeros_like(beta)
    hi = torch.full_like(beta, float("inf"))

    def H_of(beta):
        P = torch.exp(-beta[:, None] * d2)
        sumP = torch.clamp(P.sum(1), min=1e-35)
        H = beta * (d2 * P).sum(1) / sumP + torch.log(sumP)
        return H, P, sumP

    for _ in range(num_iter):
        H, _, _ = H_of(beta)
        too_high = H > logU          # entropy too high -> increase beta
        lo = torch.where(too_high, beta, lo)
        hi = torch.where(too_high, hi, beta)
        beta = torch.where(torch.isinf(hi), beta * 2.0, (lo + hi) / 2.0)
    _, P, sumP = H_of(beta)
    return P / sumP[:, None]


def _build_P(X, perplexity, device=None):
    """kNN (K = 3*perplexity) -> calibrated similarities -> symmetrize
    P + P^T -> row-normalize (reference ``tsne.cpp:138-156,589-660``).
    Returns the float32 :class:`SparseGraph` of P on ``device``."""
    import scipy.sparse as sp
    from graphlearning_tpu_torch import weightmatrix
    from graphlearning_tpu_torch.core.sparse import SparseGraph

    dev = config.device(device)
    n = X.shape[0]
    K = min(int(3 * perplexity), n - 1)
    knn_ind, knn_dist = weightmatrix.knnsearch(X, K + 1, device=dev)
    knn_ind, knn_dist = knn_ind[:, 1:], knn_dist[:, 1:]   # drop self
    P = _calibrate_perplexity(torch.as_tensor(knn_dist**2, device=dev),
                              perplexity)
    P = P.cpu().numpy().astype(np.float64)
    rows = np.repeat(np.arange(n), K)
    Psp = sp.coo_matrix((P.ravel(), (rows, knn_ind.ravel())),
                        shape=(n, n)).tocsr()
    Psp = Psp + Psp.T                      # symmetrize (sum; row-norm next)
    rowsum = np.maximum(np.asarray(Psp.sum(1)).ravel(), 1e-35)
    Psp = sp.diags(1.0 / rowsum) @ Psp
    return SparseGraph.from_scipy(Psp, dtype=torch.float32, device=dev)


def _pow_static_(x, e: float):
    """``x ** e`` in place, with exact forms for the common static exponents
    (theta1=2 -> e=1, theta2=3 -> e=1.5 in the reference ARS kernels,
    sptree.cpp:366,400), as the JAX package computes them."""
    if e == 1.0:
        return x
    if e == 0.5:
        return x.sqrt_()
    if e == 1.5:
        return x.mul_(torch.sqrt(x))
    if e == 2.0:
        return x.mul_(x)
    if float(e).is_integer() and 0 < e <= 8:
        return x.pow_(int(e))
    return x.pow_(e)


def _repulsion_chunk(Y, ysq, s: int, chunk: int, theta2: float):
    """``neg_f`` of rows ``s:s+chunk``: the exact all-pairs force on the
    (rows, n) block, in the JAX package's Gram form ``|y_i|^2 + |y_j|^2 -
    2 y_i . y_j``, clamped at 0.  The block is transformed in place: a
    chunk holds at most three (rows, n) buffers at once."""
    Yc = Y[s:s + chunk]
    D2 = ysq[s:s + chunk, None] + ysq[None, :]
    D2.addmm_(Yc, Y.T, alpha=-2.0)
    D2.clamp_(min=0.0)
    psi = _pow_static_(torch.clamp(D2, min=1e-35), theta2 / 2.0)
    psi.add_(1.0).reciprocal_()
    q = D2.add_(1.0).reciprocal_()          # 1/(1+D2), in D2's buffer
    q.diagonal(offset=s).zero_()            # j != i
    qpsi = psi.mul_(q)
    # sum_j q psi (y_i - y_j) = y_i * sum_j qpsi - qpsi @ Y
    num = Yc * qpsi.sum(1)[:, None] - qpsi @ Y
    den = torch.clamp(q.sum(1), min=1e-35)
    return num / den[:, None]


def _ars_forces(Y, cols, vals, theta1: float, theta2: float, chunk: int):
    """One gradient evaluation at ``Y`` (n, dim): ``(pos_f, neg_f)``.
    ``cols``, ``vals``: the padded ELL of P."""
    n, dim = Y.shape
    k = cols.shape[1]
    # attraction over the ELL graph of P: gather neighbour positions,
    # per-edge kernel, reduce over the fixed k axis
    Yj = Y.index_select(0, cols.reshape(-1)).view(n, k, dim)
    diff = Y[:, None, :] - Yj
    D2 = torch.sum(diff * diff, dim=2)
    coef = vals / (1.0 + _pow_static_(torch.clamp(D2, min=1e-35),
                                      theta1 / 2.0))
    pos_f = torch.sum(coef[:, :, None] * diff, dim=1)

    ysq = torch.sum(Y * Y, dim=1)
    with config.exact_matmul():
        neg_f = torch.cat([_repulsion_chunk(Y, ysq, s, chunk, theta2)
                           for s in range(0, n, chunk)])
    return pos_f, neg_f


def _ars_iterate(Y, cols, vals, *, iters: int, num_early: int,
                 time_step: float, theta1: float, theta2: float,
                 alpha: float, chunk: int, prog: bool = False,
                 dump: bool = False):
    """``iters`` ARS steps from ``Y``: the early-exaggeration factor
    applies while the step's index is below ``num_early``.  Every 50
    steps, and after the last, ``prog`` prints the count and ``dump``
    writes ``ars_<i>.npy`` (i = 0, 1, ...), from this same loop."""
    n = Y.shape[0]
    for it in range(iters):
        pos_f, neg_f = _ars_forces(Y, cols, vals, theta1, theta2, chunk)
        early = it < num_early
        dC = (alpha if early else 1.0) * pos_f - neg_f
        Y = Y - (time_step / alpha if early else time_step) * dC
        Y = Y - (torch.sum(Y, dim=0) / n)[None, :]       # zero mean
        done = it + 1
        if (prog or dump) and (done % 50 == 0 or done == iters):
            if prog:
                print(f"ARS iteration {done}/{iters}", flush=True)
            if dump:
                np.save(f"ars_{(done - 1) // 50}.npy", Y.cpu().numpy())
    return Y


def _preprocess(X, dim, use_pca, init_dim, init):
    """The JAX package's host preprocessing: PCA by ``eigsh`` to
    ``init_dim`` when ``use_pca`` and the data are wider, zero mean, the
    max-abs scale (``tsne.cpp:100-105``), and the start ``Y0`` ("pca", an
    array, or ``RandomState(0)`` noise).  Returns ``(X, Y0)``."""
    X = np.asarray(X, dtype=np.float64)
    n = X.shape[0]
    if use_pca and X.shape[1] > init_dim:
        import scipy.sparse.linalg as spla

        Xc = X - X.mean(0)
        _, Q = spla.eigsh(Xc.T @ Xc, k=init_dim, which="LM")
        X = Xc @ Q
    X = X - X.mean(0)
    X = X / np.maximum(np.abs(X).max(), 1e-35)
    if isinstance(init, np.ndarray):
        Y0 = np.array(init, dtype=np.float64)
    elif init == "pca":
        Xc = X - X.mean(0)
        U, S, _ = np.linalg.svd(Xc, full_matrices=False)
        Y0 = U[:, :dim] * S[:dim]
        Y0 = Y0 / max(np.std(Y0[:, 0]), 1e-35) * 1e-4
    else:
        rs = np.random.RandomState(0)
        Y0 = rs.randn(n, dim) * 1e-4
    return X, Y0


def ars(X, dim=2, perplexity=30, kappa=0.5, iters=1000, time_step=1,
        theta1=2, theta2=3, alpha=10, num_early=250, use_pca=True,
        init_dim=200, init="pca", prog=False, dump=False, chunk=1024,
        device=None):
    """Attraction-Repulsion Swarming t-SNE embedding (Lu-Calder).

    The parameters of the JAX package's ``ars.ars`` in its order, with
    ``device`` last.  ``kappa`` (the Barnes-Hut opening angle) is accepted
    and unused: the repulsion is exact.  ``prog`` prints and ``dump``
    writes ``ars_<i>.npy`` every 50 iterations.  Returns the (n, dim)
    embedding as float64 numpy."""
    dev = config.device(device)
    X, Y0 = _preprocess(X, dim, use_pca, init_dim, init)
    P = _build_P(X, perplexity, device=dev)
    Y = _ars_iterate(
        torch.as_tensor(Y0.astype(np.float32), device=dev), P.cols, P.vals,
        iters=int(iters), num_early=int(num_early),
        time_step=float(time_step), theta1=float(theta1),
        theta2=float(theta2), alpha=float(alpha),
        chunk=min(int(chunk), X.shape[0]), prog=prog, dump=dump)
    return Y.cpu().numpy().astype(np.float64)
