"""The linear solvers (CG, the constrained solves, GMRES), label encodings,
class priors, sparse helpers, the boundary statistic, the randomized SVD,
the Dirichlet eigenvectors, the samplers, the image helpers and the file
helpers (counterpart of ``graphlearning_tpu/utils.py``).

The solvers run on a device (``device``, last, as every entry point of the
port); the samplers, ``mesh`` and the image helpers are host numpy, drawing
from numpy's global state where the JAX package does, so a seed gives both
packages the same points.  The plots of ``image_grid`` and
``color_image_grid`` import matplotlib when they are drawn, and only then.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from graphlearning_tpu_torch import config
from graphlearning_tpu_torch.core.sparse import SparseGraph
from graphlearning_tpu_torch.ops import graphops as _ops


def _as_matvec(A, device):
    """A callable on ``(n, j)`` tensors from a callable (as it is), a
    :class:`SparseGraph`, a dense numpy array or a scipy sparse matrix (on
    ``device``, in its working dtype: a padded ELL when square, a torch
    CSR otherwise)."""
    if callable(A):
        return A
    if isinstance(A, SparseGraph):
        return lambda X: _ops.spmm(A, X)
    if isinstance(A, np.ndarray):
        At = torch.as_tensor(A, device=device).to(config.float_dtype(device))
        return lambda X: At @ X
    A = sp.csr_matrix(A)
    if A.shape[0] == A.shape[1]:
        g = SparseGraph.from_scipy(A, device=device)
        return lambda X: _ops.spmm(g, X)
    At = torch.sparse_csr_tensor(
        torch.as_tensor(A.indptr.astype(np.int64)),
        torch.as_tensor(A.indices.astype(np.int64)),
        torch.as_tensor(A.data), size=A.shape).to(
            device=device, dtype=config.float_dtype(device))
    return lambda X: torch.sparse.mm(At, X)


def _diag_of(A, device):
    """The diagonal of ``A`` (a :class:`SparseGraph`, a dense numpy array or
    a scipy sparse matrix) as a tensor on ``device`` in its working
    dtype."""
    if isinstance(A, SparseGraph):
        return _ops.diagonal(A)
    d = np.diag(A) if isinstance(A, np.ndarray) else A.diagonal()
    return torch.as_tensor(np.array(d), device=device).to(
        config.float_dtype(device))


def _operator_device(A, device):
    """A :class:`SparseGraph` runs on its own device; anything else on
    ``config.device(device)``."""
    return A.device if isinstance(A, SparseGraph) else config.device(device)


# -- solvers ------------------------------------------------------------------


def conjgrad(A, b, x0=None, max_iter=10**5, tol=1e-10, device=None):
    """Multi-right-hand-side CG for an SPD ``A`` (a scipy sparse matrix, a
    dense numpy array, a :class:`SparseGraph` or a callable on ``(n, m)``
    tensors of ``device``), on the plain ELL product
    (:func:`solvers.cg.conjgrad`): stops at ``||r||_F < tol``.  Returns
    numpy."""
    from graphlearning_tpu_torch.solvers import cg as _cg

    dev = _operator_device(A, device)
    dtype = config.float_dtype(dev)
    b = torch.as_tensor(np.asarray(b), device=dev).to(dtype)
    if x0 is not None:
        x0 = torch.as_tensor(np.asarray(x0), device=dev).to(dtype)
    x, _, _ = _cg.conjgrad(_as_matvec(A, dev), b, x0=x0,
                           max_iter=int(max_iter), tol=tol)
    return x.cpu().numpy()


def _constraint_mask(I, n):
    """A boolean (n,) mask from a boolean mask or an index list."""
    I = np.asarray(I)
    if I.dtype == bool:
        return I
    mask = np.zeros(n, dtype=bool)
    mask[I] = True
    return mask


def constrained_solve(L, I, g, f=None, x0=None, tol=1e-10, device=None):
    """Solve ``L x = f`` subject to ``x = g`` on the constraint set ``I``
    (an index list or a boolean mask; ``g`` its values, in its order) by
    masked Jacobi-preconditioned CG on the whole system
    (:func:`solvers.cg.constrained_solve`), on the plain ELL product.
    ``x0`` is not read, as in the JAX package.  Returns numpy."""
    from graphlearning_tpu_torch.solvers import cg as _cg

    if not hasattr(L, "shape"):
        raise ValueError("L must have a shape")
    n = L.shape[0]
    dev = _operator_device(L, device)
    dtype = config.float_dtype(dev)
    as_t = lambda a: torch.as_tensor(np.asarray(a), device=dev).to(dtype)
    mask = _constraint_mask(I, n)
    gv = np.zeros(n)
    gv[mask] = np.asarray(g).ravel()
    u, _, _ = _cg.constrained_solve(
        _as_matvec(L, dev), _diag_of(L, dev), torch.as_tensor(mask,
                                                              device=dev),
        as_t(gv), f=None if f is None else as_t(f), tol=tol, max_iter=10**5)
    return u.cpu().numpy()


def constrained_solve_gmres(L, f, R, g, ind, tol=1e-5, device=None):
    """Solve ``L x = f`` with the rows ``ind`` (an index list or a boolean
    mask) replaced by those of the constraint matrix ``R`` and their
    right-hand side by ``g[ind]``, by GMRES (:func:`solvers.gmres.gmres`:
    restarts of 20, at most 1000, ``atol = 0``) with the Jacobi
    preconditioner of the mixed rows, as the JAX package calls
    ``jax.scipy.sparse.linalg.gmres``.  Returns numpy."""
    from graphlearning_tpu_torch.solvers import gmres as _gmres

    n = L.shape[0]
    dev = _operator_device(L, device)
    dtype = config.float_dtype(dev)
    mask = _constraint_mask(ind, n)
    mask_t = torch.as_tensor(mask, device=dev)
    Lmv, Rmv = _as_matvec(L, dev), _as_matvec(R, dev)
    b = np.asarray(f, dtype=float).copy()
    b[mask] = np.asarray(g)[mask]
    diag = np.where(mask, _diag_of(R, dev).cpu().numpy(),
                    _diag_of(L, dev).cpu().numpy())
    diag = torch.as_tensor(np.where(diag == 0, 1.0, diag), device=dev).to(
        dtype)
    b = torch.as_tensor(b, device=dev).to(dtype)
    rows = (n,) + (1,) * (b.dim() - 1)
    mask_t, diag = mask_t.reshape(rows), diag.reshape(rows)

    def A(x):
        return torch.where(mask_t, Rmv(x), Lmv(x))

    def M(x):
        return x / diag

    u = _gmres.gmres(A, b, tol=tol,
                     atol=0.0, restart=20, maxiter=1000, M=M)
    return u.cpu().numpy()


def dirichlet_eigenvectors(L, ind, k):
    """Smallest Dirichlet eigenpairs: ``L x = lambda x`` off ``ind``, ``x =
    0`` on ``ind``, by scipy's ``eigsh`` of the interior block on the host,
    as the JAX package computes them.  Returns numpy ``(vals, vecs)``,
    ``vecs`` flat when ``k == 1``."""
    import scipy.sparse.linalg as splinalg

    L = sp.csr_matrix(L)
    n = L.shape[0]
    idx = np.full((n,), True, dtype=bool)
    idx[ind] = False
    A = L[idx, :][:, idx]
    vals, vec = splinalg.eigsh(A, k=k, which="SM")
    vecs = np.zeros((n, k))
    vecs[idx, :] = vec
    if k == 1:
        vecs = vecs.flatten()
    return vals, vecs


def randomized_svd(A, k=10, c=None, q=1, key=None, device=None):
    """Halko-Martinsson-Tropp randomized SVD on ``device``: a Gaussian
    sketch of ``c`` columns (``2 k`` by default) drawn from ``key`` (a
    seed, 0 by default, or a ``torch.Generator``), ``q`` power iterations,
    QR and a small dense SVD.  ``A`` is a scipy sparse matrix, a numpy
    array, a :class:`SparseGraph` or a symmetric operator (a callable with
    a ``shape``).  Returns numpy ``(u, s, vt)`` of the top ``k``."""
    if c is None:
        c = 2 * k
    n = A.shape[1] if hasattr(A, "shape") else None
    if n is None:
        raise ValueError("A must have .shape for randomized_svd")
    dev = A.device if isinstance(A, SparseGraph) else config.device(device)
    matvec = _as_matvec(A, dev)
    if isinstance(A, SparseGraph) or callable(A):
        rmatvec = matvec         # the symmetric operators of the graphs
    else:
        rmatvec = _as_matvec(A.T if isinstance(A, np.ndarray)
                             else sp.csr_matrix(A).T.tocsr(), dev)
    dtype = config.float_dtype(dev)
    Omega = torch.randn((n, c), generator=config.generator(
        0 if key is None else key, dev), dtype=dtype, device=dev)
    return _randomized_svd(matvec, rmatvec, Omega, k, q)


def _randomized_svd(matvec, rmatvec, Omega, k, q):
    """:func:`randomized_svd` from its sketch ``Omega``."""
    with config.exact_matmul():
        Y = matvec(Omega)
        for _ in range(q):
            Y = matvec(rmatvec(Y))
        Q, _ = torch.linalg.qr(Y)
        B = rmatvec(Q).T                         # Q^T A
        u2, s, vt = torch.linalg.svd(B, full_matrices=False)
        u = Q @ u2
    order = torch.argsort(-s)[:k]
    return (u[:, order].cpu().numpy(), s[order].cpu().numpy(),
            vt[order, :].cpu().numpy())


def labels_to_onehot(labels, k=None, standardize=False):
    labels = np.asarray(labels).astype(int)
    n = labels.shape[0]
    if standardize:
        _, labels = np.unique(labels, return_inverse=True)
    kk = int(np.max(labels)) + 1 if n > 0 else 0
    k = max(kk, k if k is not None else 0)
    onehot = np.zeros((n, k))
    onehot[np.arange(n), labels] = 1
    return onehot


def class_priors(labels):
    """The share of each class among the nonnegative ``labels``, classes
    in ascending order."""
    labels = np.asarray(labels)
    L = np.unique(labels)
    L = L[L >= 0]
    n = np.sum(labels >= 0)
    return np.array([np.sum(labels == l) / n for l in L])


def sparse_max(A, B):
    """Elementwise max of two nonnegative scipy sparse matrices."""
    I = (A + B) > 0
    IB = B > A
    IA = I - IB
    return A.multiply(IA) + B.multiply(IB)


def torch_sparse(A, device=None):
    """A scipy sparse matrix as a float32 sparse COO tensor on
    ``device``."""
    A = A.tocoo()
    i = torch.as_tensor(np.vstack((A.row, A.col)).astype(np.int64))
    v = torch.as_tensor(A.data, dtype=torch.float32)
    return torch.sparse_coo_tensor(i, v, tuple(A.shape),
                                   device=config.device(device))


# -- the boundary statistic ---------------------------------------------------


def boundary_statistic(X, r, knn=False, return_normals=False,
                       second_order=True, cutoff=True, knn_data=None,
                       device=None):
    """The Calder-Park-Slepcev boundary test statistic of a point cloud:
    on the ``r``-ball graph, or with ``knn`` on the ``r``-nearest-neighbour
    graph (``knn_data`` its ``(J, D)`` when already searched).  The inner
    normals are ``-L X`` (on the graph reweighted by ``D^-1`` with
    ``second_order``), normalised; with ``cutoff`` a neighbour whose normal
    points away is paired with the node's own.  Returns ``T`` (and the
    normals with ``return_normals``)."""
    from graphlearning_tpu_torch import weightmatrix
    from graphlearning_tpu_torch.core.graphclass import graph as _graph

    dev = config.device(device)
    X = np.asarray(X, dtype=float)
    n = X.shape[0]
    if knn:
        k = r
        if knn_data is None:
            J, D = weightmatrix.knnsearch(X, k, device=dev)
        else:
            J, D = knn_data
        W = weightmatrix.knn(X, k, kernel="uniform", symmetrize=False,
                             knn_data=(J, D), device=dev)
    else:
        W = weightmatrix.epsilon_ball(X, r, kernel="uniform")

    deg = W @ np.ones(n)
    if np.min(deg) == 1:
        print("\nWarning: Some points have no neighbors!!!\n")

    if second_order:
        theta = _graph(W, device=dev).degree_matrix(p=-1)
        nu = -(_graph(W @ theta, device=dev).laplacian() @ X)
    else:
        nu = -(_graph(W, device=dev).laplacian() @ X)
    norms = np.sqrt(np.sum(nu * nu, axis=1))
    nu = nu / norms[:, None]

    if not knn:
        k = int(np.max(W @ np.ones(n)))
        J, D = weightmatrix.knnsearch(X, k, device=dev)
        J = J[:, 1:]
        D = D[:, 1:]

    V = X[:, None, :] - X[J]
    if second_order:
        nu2 = (nu[:, None, :] + nu[J]) / 2
        if cutoff:
            nn_mask = (np.sum(nu[:, None, :] * nu[J], axis=2) > 0)[:, :, None]
            nu2 = nn_mask * nu2 + (1 - nn_mask) * nu[:, None, :]
        xd = np.sum(V * nu2, axis=2)
    else:
        xd = np.sum(V * nu[:, None, :], axis=2)

    T = np.max(xd, axis=1) if knn else np.max(xd * (D <= r), axis=1)
    return (T, nu) if return_normals else T


# -- samplers (host numpy) ----------------------------------------------------


def rand_ball(n, d, rng=None):
    """``n`` uniform points of the unit ball in ``d`` dimensions, by
    rejection from the cube, drawn from ``rng`` (numpy's global state by
    default)."""
    rng = rng or np.random
    X = np.zeros((0, d))
    while X.shape[0] < n:
        Y = 2 * rng.rand(n, d) - 1
        X = np.vstack((X, Y[np.sum(Y * Y, axis=1) < 1]))
    return X[:n]


def rand_annulus(n, d, r1, r2, rng=None):
    """``n`` uniform points of the annulus ``r1 < |x| < r2`` in ``d``
    dimensions, by rejection, drawn from ``rng``."""
    rng = rng or np.random
    X = np.zeros((0, d))
    while X.shape[0] < n:
        Y = r2 * (2 * rng.rand(n, d) - 1)
        dist2 = np.sum(Y * Y, axis=1)
        X = np.vstack((X, Y[(dist2 < r2 * r2) & (dist2 > r1 * r1)]))
    return X[:n]


def bean_data(n, h, rng=None):
    """Up to ``n`` uniform points of the bean-shaped domain of neck ``h``
    (from ``3 n`` draws of ``rng``; fewer, with a message, when too few
    fall inside)."""
    rng = rng or np.random
    x = -1 + 2 * rng.rand(3 * n)
    y = -0.6 + 1.2 * rng.rand(3 * n)
    X = np.vstack((x, y)).T
    dist = 0.4 * np.sqrt(1 - x**2) * (1 + h - np.cos(3 * x))
    X = X[np.abs(y) <= dist]
    if X.shape[0] < n:
        print("Not enough samples")
    return X[:n]


def mesh(X, boundary_improvement=False):
    """The Delaunay triangles of the first two coordinates of ``X``.  With
    ``boundary_improvement`` the points are scaled to the unit square and
    padded with four strips of uniform points (drawn from numpy's global
    state), and only the triangles of ``X``'s own points are kept."""
    from scipy import spatial

    X = np.asarray(X)
    if boundary_improvement:
        n = X.shape[0]
        Xn = X[:, :2].astype(float).copy()
        x1, x2 = Xn[:, 0].min(), Xn[:, 0].max()
        y1, y2 = Xn[:, 1].min(), Xn[:, 1].max()
        Xn -= [x1, y1]
        Xn[:, 0] /= x2 - x1
        Xn[:, 1] /= y2 - y1
        pad = 10 / np.sqrt(n)
        m = int(pad * n)
        Z = Xn
        for axis, off in ((0, -pad), (0, 1.0), (1, -pad), (1, 1.0)):
            Y = np.random.rand(m, 2)
            Y[:, axis] = Y[:, axis] * pad + off
            Z = np.vstack((Z, Y))
        Tri = spatial.Delaunay(Z).simplices
        return Tri[np.sum(Tri >= n, axis=1) == 0, :]
    return spatial.Delaunay(X[:, :2]).simplices


# -- image helpers (host numpy) -----------------------------------------------


def image_to_patches(I, patch_size=(16, 16)):
    """The non-overlapping ``patch_size`` patches of a grayscale image
    ``(H, W)`` or of a stack ``(B, H, W[, C])``, each flattened: ``(P, ph
    pw)`` or ``(B, P, ph pw C)``, row-major over the patch grid."""
    I = np.asarray(I)
    squeeze = I.ndim == 2
    if squeeze:
        I = I[None, ...]
    B, H, W = I.shape[:3]
    ph, pw = patch_size
    nh, nw = H // ph, W // pw
    I = I[:, : nh * ph, : nw * pw, ...]
    rest = I.shape[3:]
    P = I.reshape(B, nh, ph, nw, pw, *rest).swapaxes(2, 3)
    P = P.reshape(B, nh * nw, ph * pw * int(np.prod(rest)) if rest else ph * pw)
    return P[0] if squeeze else P


def patches_to_image(patches, image_shape, patch_size=(16, 16)):
    """The image of ``image_shape`` (cut to whole patches) from the patches
    of :func:`image_to_patches`."""
    patches = np.asarray(patches)
    H, W = image_shape[:2]
    ph, pw = patch_size
    nh, nw = H // ph, W // pw
    rest = patches.shape[-1] // (ph * pw)
    if rest > 1:
        P = patches.reshape(nh, nw, ph, pw, rest)
        return P.swapaxes(1, 2).reshape(nh * ph, nw * pw, rest)
    P = patches.reshape(nh, nw, ph, pw)
    return P.swapaxes(1, 2).reshape(nh * ph, nw * pw)


def _grid_canvas(imgs, n_rows, n_cols, padding, channels):
    """The images laid out row by row on a white canvas, ``padding``
    pixels apart."""
    s = imgs.shape[1]
    H = n_rows * (s + padding) + padding
    Wd = n_cols * (s + padding) + padding
    canvas = np.ones((H, Wd) + channels)
    for idx, img in enumerate(imgs[: n_rows * n_cols]):
        r, c = divmod(idx, n_cols)
        rr = padding + r * (s + padding)
        cc = padding + c * (s + padding)
        canvas[rr: rr + s, cc: cc + s] = img
    return canvas


def _show(canvas, title, fontsize, **kw):
    import matplotlib.pyplot as plt

    plt.figure()
    plt.imshow(canvas, **kw)
    plt.axis("off")
    if title:
        plt.title(title, fontsize=fontsize)


def image_grid(X, n_rows=10, n_cols=10, padding=2, title=None,
               normalize=False, fontsize=None, transpose=False,
               return_image=False):
    """A grid of the grayscale images in the rows of ``X`` (square, side
    ``sqrt(X.shape[1])``), each transposed with ``transpose`` and scaled to
    [0, 1] with ``normalize``.  Returns the canvas; without
    ``return_image`` it is also plotted (matplotlib)."""
    X = np.asarray(X)
    s = int(np.sqrt(X.shape[1]))
    imgs = X[: n_rows * n_cols].reshape(-1, s, s)
    if normalize:
        mn = imgs.min(axis=(1, 2), keepdims=True)
        mx = imgs.max(axis=(1, 2), keepdims=True)
        imgs = (imgs - mn) / np.maximum(mx - mn, 1e-12)
    if transpose:
        imgs = imgs.transpose(0, 2, 1)
    canvas = _grid_canvas(imgs, n_rows, n_cols, padding, ())
    if not return_image:
        _show(canvas, title, fontsize, cmap="gray")
    return canvas


def color_image_grid(X, n_rows=10, n_cols=10, padding=2, title=None,
                     normalize=False, fontsize=None, transpose=True,
                     return_image=False):
    """:func:`image_grid` of color images: each row of ``X`` holds ``3 s
    s`` values, channel-major with ``transpose`` (the default), else
    channel-last."""
    X = np.asarray(X)
    s = int(np.sqrt(X.shape[1] // 3))
    imgs = X[: n_rows * n_cols]
    if transpose:
        imgs = imgs.reshape(-1, 3, s, s).transpose(0, 2, 3, 1)
    else:
        imgs = imgs.reshape(-1, s, s, 3)
    if normalize:
        mn = imgs.min(axis=(1, 2, 3), keepdims=True)
        mx = imgs.max(axis=(1, 2, 3), keepdims=True)
        imgs = (imgs - mn) / np.maximum(mx - mn, 1e-12)
    canvas = _grid_canvas(imgs, n_rows, n_cols, padding, (3,))
    if not return_image:
        _show(canvas, title, fontsize)
    return canvas


# -- file helpers -------------------------------------------------------------


def csvread(filename):
    """The rows of a CSV file after its header line, as a float array
    (empty rows skipped; ``np.zeros((0,))`` when there is no data row)."""
    import csv

    with open(filename) as fh:
        rows = [r for r in csv.reader(fh) if r]
    return np.array(rows[1:], dtype=float) if len(rows) > 1 else np.zeros((0,))


def numpy_load(file, field):
    """The array ``field`` of an npz file (object arrays allowed)."""
    return np.load(file, allow_pickle=True)[field]


def download_file(url, file):
    """Fetch ``url`` into ``file``, with TLS certificates verified (the JAX
    package turns verification off).  Raises a ``RuntimeError`` that names
    the URL when the download fails."""
    import urllib.request

    try:
        print(f"Downloading {url} to {file}...")
        with urllib.request.urlopen(url) as resp, open(file, "wb") as out:
            out.write(resp.read())
    except Exception as e:
        raise RuntimeError(f"Could not download {url}: {e}") from e
