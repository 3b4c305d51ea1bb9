"""The ``utils`` solvers, samplers, boundary statistic and image helpers of
graphlearning_tpu_torch against graphlearning_tpu on the CPU, at float64.

* ``conjgrad`` and ``constrained_solve`` on a scipy matrix, a dense array,
  a ``SparseGraph`` and a callable: within 1e-9 of JAX's (both CG to tol
  1e-10 on the same system, summed in other orders).
* ``constrained_solve_gmres`` against JAX's (GMRES, restarts of 20, the
  Jacobi preconditioner): both apply the operator the same number of times
  (counted by a callable operator; 122 on this input) and
  agree within 1e-9, at tol 1e-8.
* ``torch_sparse``, the samplers under ``np.random.seed`` and under a
  ``RandomState``, ``mesh`` with and without ``boundary_improvement``, the
  image helpers (round trips, ``return_image=True``; the plots where
  matplotlib is present) and ``boundary_statistic`` in its kNN and epsilon
  forms: the same host numpy, so equal (the statistic within 1e-12).
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import graphlearning_tpu as jgl
from graphlearning_tpu.core.sparse import SparseGraph as JSparseGraph
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch.core.sparse import SparseGraph

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def system():
    """A 10-NN graph of 300 clustered points: its Laplacian, 6 labels."""
    rs = np.random.RandomState(2)
    X = np.concatenate([rs.randn(150, 3), rs.randn(150, 3) + 4.0])
    W = jgl.weightmatrix.knn(X, 10)
    L = jgl.graph(W).laplacian().tocsr()
    ind = np.array([0, 40, 90, 150, 200, 260])
    return W, L, ind, X


class _Op:
    """A callable operator with the shape and diagonal the constrained
    solves read."""

    def __init__(self, A, matmul):
        self.shape, self._diag, self._mm = A.shape, A.diagonal(), matmul

    def __call__(self, X):
        return self._mm(X)

    def diagonal(self):
        return self._diag


def _operators(A):
    """The four forms of ``A`` for each package: (jax form, port form)."""
    Ad = A.toarray()
    Aj, At = jnp.asarray(Ad), torch.as_tensor(Ad)
    return {
        "scipy": (A, A),
        "dense": (Ad, Ad),
        "sparsegraph": (JSparseGraph.from_scipy(A),
                        SparseGraph.from_scipy(A, device="cpu")),
        "callable": (_Op(A, lambda X: Aj @ X), _Op(A, lambda X: At @ X)),
    }


@pytest.mark.parametrize("form", ["scipy", "dense", "sparsegraph",
                                  "callable"])
def test_conjgrad_matches_jax(system, form):
    W, L, _, _ = system
    A = (L + sp.identity(L.shape[0])).tocsr()
    b = np.random.RandomState(0).randn(L.shape[0], 2)
    Aj, At = _operators(A)[form]
    xj = jgl.utils.conjgrad(Aj, b, tol=1e-10)
    xt = tgl.utils.conjgrad(At, b, tol=1e-10, device="cpu")
    np.testing.assert_allclose(xt, xj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(A @ xt, b, rtol=0, atol=1e-8)


@pytest.mark.parametrize("form", ["scipy", "dense", "sparsegraph",
                                  "callable"])
def test_constrained_solve_matches_jax(system, form):
    W, L, ind, _ = system
    Lj, Lt = _operators(L)[form]
    g = np.arange(len(ind), dtype=float)
    f = np.random.RandomState(1).randn(L.shape[0]) * 1e-2
    uj = jgl.utils.constrained_solve(Lj, ind, g, f=f, tol=1e-10)
    ut = tgl.utils.constrained_solve(Lt, ind, g, f=f, tol=1e-10,
                                     device="cpu")
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(ut[ind], g)
    mask = np.zeros(L.shape[0], bool)
    mask[ind] = True
    ub = tgl.utils.constrained_solve(Lt, mask, g, f=f, tol=1e-10,
                                     device="cpu")
    np.testing.assert_allclose(ub, ut, rtol=0, atol=1e-12)


def test_constrained_solve_needs_a_shape():
    with pytest.raises(ValueError, match="shape"):
        tgl.utils.constrained_solve(lambda X: X, [0], [1.0], device="cpu")


def test_constrained_solve_gmres_matches_jax(system):
    W, L, ind, _ = system
    n = L.shape[0]
    R = sp.identity(n).tocsr()
    f = np.random.RandomState(3).randn(n) * 1e-2
    f -= f.mean()
    g = np.zeros(n)
    g[ind] = np.arange(len(ind), dtype=float)
    calls = {"jax": 0, "torch": 0}

    def bump(_):
        calls["jax"] += 1

    Lj = jnp.asarray(L.toarray())
    Lt = torch.as_tensor(L.toarray())

    def jmm(x):
        jax.debug.callback(bump, x)
        return Lj @ x

    def tmm(x):
        calls["torch"] += 1
        return Lt @ x

    uj = np.asarray(jgl.utils.constrained_solve_gmres(_Op(L, jmm), f, R, g,
                                                      ind, tol=1e-8))
    ut = tgl.utils.constrained_solve_gmres(_Op(L, tmm), f, R, g, ind,
                                           tol=1e-8, device="cpu")
    assert calls["torch"] == calls["jax"] == 122, calls
    np.testing.assert_allclose(ut, uj, rtol=0, atol=1e-9)
    np.testing.assert_allclose(ut[ind], g[ind], rtol=0, atol=1e-6)
    # the scipy matrix itself
    us = tgl.utils.constrained_solve_gmres(L, f, R, g, ind, tol=1e-8,
                                           device="cpu")
    np.testing.assert_allclose(us, ut, rtol=0, atol=1e-9)


@pytest.mark.parametrize("maxiter", [3, 4, 50])
def test_gmres_follows_jax_on_a_nonsymmetric_system(maxiter):
    """Restarts of 7 on a nonsymmetric system, at tol 1e-6: the same
    iterate as JAX's after 3, 4 and 50 restarts.  Neither reaches the
    tolerance: JAX's Gram-Schmidt repeats its pass only where the overlaps
    are small, the rotated residual runs ahead of the true one, each later
    restart takes a step or two, and the residual rises from 1.26e-5 after
    the third to 2.72e-5 after the fourth, in both packages."""
    from graphlearning_tpu_torch.solvers import gmres as tgmres

    rs = np.random.RandomState(7)
    A = np.eye(60) * 4 + rs.randn(60, 60) * 0.3
    b = rs.randn(60)
    xj, _ = jax.scipy.sparse.linalg.gmres(
        jnp.asarray(A), jnp.asarray(b), tol=1e-6, atol=0.0, restart=7,
        maxiter=maxiter, solve_method="incremental")
    info = {}
    xt = tgmres.gmres(lambda x: torch.as_tensor(A) @ x, torch.as_tensor(b),
                      tol=1e-6, restart=7, maxiter=maxiter, info=info)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=0,
                               atol=1e-12)
    assert info["restarts"] == maxiter
    np.testing.assert_allclose(info["residual"],
                               np.linalg.norm(A @ np.asarray(xj) - b),
                               rtol=1e-8)


def test_torch_sparse_on_the_cpu(system):
    W = system[0]
    T = tgl.utils.torch_sparse(W, device="cpu")
    assert T.is_sparse and T.dtype == torch.float32 and T.device.type == "cpu"
    np.testing.assert_allclose(T.to_dense().numpy(),
                               W.toarray().astype(np.float32), rtol=0, atol=0)
    np.testing.assert_array_equal(jgl.utils.torch_sparse(W).to_dense(),
                                  T.to_dense())


@pytest.mark.parametrize("rng", ["global", "state"])
def test_samplers_draw_jax_points(rng):
    out = {}
    for name, gl in (("jax", jgl), ("torch", tgl)):
        np.random.seed(11)
        r = None if rng == "global" else np.random.RandomState(12)
        out[name] = (gl.utils.rand_ball(300, 3, rng=r),
                     gl.utils.rand_annulus(200, 2, 0.5, 1.0, rng=r),
                     gl.utils.bean_data(400, 0.2, rng=r))
    for a, b in zip(out["torch"], out["jax"]):
        np.testing.assert_array_equal(a, b)
    ball, ann, _ = out["torch"]
    assert ball.shape == (300, 3) and np.all(np.sum(ball ** 2, 1) < 1)
    r2 = np.sum(ann ** 2, 1)
    assert ann.shape == (200, 2) and np.all((r2 > 0.25) & (r2 < 1))


@pytest.mark.parametrize("boundary_improvement", [False, True])
def test_mesh_matches_jax(boundary_improvement):
    X = np.random.RandomState(5).rand(120, 2)
    np.random.seed(3)
    Tj = jgl.utils.mesh(X, boundary_improvement=boundary_improvement)
    np.random.seed(3)
    Tt = tgl.utils.mesh(X, boundary_improvement=boundary_improvement)
    np.testing.assert_array_equal(Tt, Tj)
    assert Tt.shape[1] == 3 and Tt.max() < 120


@pytest.mark.parametrize("shape", [(32, 48), (3, 32, 48), (1, 32, 48, 3),
                                   (2, 33, 50, 3)])
def test_image_patches_round_trip(shape):
    I = np.random.RandomState(0).rand(*shape)
    P = tgl.utils.image_to_patches(I, patch_size=(8, 16))
    np.testing.assert_array_equal(P, jgl.utils.image_to_patches(
        I, patch_size=(8, 16)))
    if shape[-2:] == (32, 48) or shape[1:3] == (32, 48):
        img = I if len(shape) == 2 else I[0]
        Pi = P if len(shape) == 2 else P[0]
        back = tgl.utils.patches_to_image(Pi, img.shape, patch_size=(8, 16))
        np.testing.assert_array_equal(back, img)
        np.testing.assert_array_equal(back, jgl.utils.patches_to_image(
            Pi, img.shape, patch_size=(8, 16)))


@pytest.mark.parametrize("kw", [{}, {"normalize": True},
                                {"transpose": True, "padding": 0},
                                {"n_rows": 3, "n_cols": 4}])
def test_image_grids_match_jax(kw):
    rs = np.random.RandomState(1)
    X = rs.rand(30, 64)
    Xc = rs.rand(30, 3 * 64)
    np.testing.assert_array_equal(
        tgl.utils.image_grid(X, return_image=True, **kw),
        jgl.utils.image_grid(X, return_image=True, **kw))
    kc = dict(kw)
    kc["transpose"] = not kc.get("transpose", False)
    for t in (kw, kc):
        np.testing.assert_array_equal(
            tgl.utils.color_image_grid(Xc, return_image=True, **t),
            jgl.utils.color_image_grid(Xc, return_image=True, **t))


def test_image_grids_plot():
    mpl = pytest.importorskip("matplotlib")
    mpl.use("Agg")
    import matplotlib.pyplot as plt

    X = np.random.RandomState(2).rand(12, 3 * 16)
    c = tgl.utils.image_grid(X[:, :16], n_rows=3, n_cols=4, title="g")
    cc = tgl.utils.color_image_grid(X, n_rows=3, n_cols=4, title="c")
    assert c.shape == (3 * 6 + 2, 4 * 6 + 2) and cc.shape[2] == 3
    assert len(plt.get_fignums()) >= 2
    plt.close("all")


@pytest.mark.parametrize("second_order,cutoff", [(True, True), (True, False),
                                                 (False, False)])
@pytest.mark.parametrize("knn", [False, True])
def test_boundary_statistic_matches_jax(knn, second_order, cutoff):
    X = np.random.RandomState(9).rand(250, 2)
    r = 8 if knn else 0.12
    kw = {"knn": knn, "second_order": second_order, "cutoff": cutoff,
          "return_normals": True}
    Tj, nuj = jgl.utils.boundary_statistic(X, r, **kw)
    Tt, nut = tgl.utils.boundary_statistic(X, r, device="cpu", **kw)
    np.testing.assert_allclose(Tt, Tj, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(nut, nuj, rtol=1e-12, atol=1e-12)
    if knn:
        data = jgl.weightmatrix.knnsearch(X, r)
        np.testing.assert_allclose(
            tgl.utils.boundary_statistic(X, r, knn_data=data, device="cpu",
                                         **kw)[0], Tj, rtol=1e-12,
            atol=1e-12)


# The names of this slice, each JAX's signature with ``device`` last.
SLICE = {
    "active_learning": ["active_learner", "spectral_covariance",
                        "acquisition_function", "unc_sampling", "var_opt",
                        "sigma_opt", "model_change", "model_change_var_opt",
                        "active_learner.select_queries",
                        "active_learner.update"],
    "checkpoint": ["save", "load", "run_checkpointed",
                   "run_checkpointed_while"],
    "weightmatrix": ["epsilon_ball", "grid_graph", "knn_graph", "knnsearch"],
    "utils": ["conjgrad", "constrained_solve", "constrained_solve_gmres",
              "torch_sparse", "boundary_statistic", "rand_ball",
              "rand_annulus", "bean_data", "mesh", "image_grid",
              "color_image_grid", "image_to_patches", "patches_to_image"],
    "ssl": ["ssl.fit", "ssl.fit_predict"],
}


@pytest.mark.parametrize("where", sorted(SLICE))
def test_slice_names_bind_as_jax(where):
    def lookup(pkg, path):
        obj = pkg
        for part in path.split("."):
            obj = getattr(obj, part)
        return obj

    for name in SLICE[where]:
        mine = inspect.signature(lookup(tgl, f"{where}.{name}"))
        theirs = inspect.signature(lookup(jgl, f"{where}.{name}"))
        params = list(mine.parameters.values())
        if params and params[-1].name == "device":
            params = params[:-1]
        assert [(p.name, p.kind, p.default) for p in params] == [
            (p.name, p.kind, p.default)
            for p in theirs.parameters.values()], name
