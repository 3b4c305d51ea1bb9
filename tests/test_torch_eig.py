"""The eigensolver stack of graphlearning_tpu_torch against graphlearning_tpu
on the CPU, at float64 (JAX's x64 on) unless stated.

* ``solvers.lobpcg.lobpcg_standard`` against JAX's own on the same start
  and a dense symmetric operator: ``theta`` rtol 1e-10, ``U`` up to sign
  1e-8, the iteration count within one.
* ``solvers.eig.eigen_decomp`` for each normalization, with ``gamma > 0``,
  and "lowrank" fed JAX's sketch: eigenvalues atol 1e-8, eigenvectors 1e-6
  (up to sign, or as a subspace where eigenvalues lie within 1e-6).  These
  run on JAX's start (the ``jax_start`` fixture): neither solve converges
  in 200 steps on every normalization, so two starts end at different
  iterates.  In float64 the port keeps JAX's tolerance.  One float32 case
  at power 8: eigenvalues atol 1e-4.  The port's float32 tolerance, per
  pair (``lobpcg.per_pair_tol``), is held to the dense ``eigh`` where
  JAX's float32 solve stops early.
* ``graph.fiedler_vector`` / ``diffusion_map`` / the eigendata memo,
  ``utils.randomized_svd`` and ``utils.dirichlet_eigenvectors``.
* ``eig_normalized`` on the gather fed JAX's start, and the graph's solve
  on the band (the kernels' twins) and the gather against the plain path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental.sparse.linalg import lobpcg_standard as jlobpcg

import graphlearning_tpu as jgl
from graphlearning_tpu.core.sparse import SparseGraph as JSparseGraph
from graphlearning_tpu.ops import gather as jgather
from graphlearning_tpu.solvers import eig as jeig
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch import utils as tutils
from graphlearning_tpu_torch.core.sparse import SparseGraph
from graphlearning_tpu_torch.ops import accel as taccel
from graphlearning_tpu_torch.ops import gather as tgather
from graphlearning_tpu_torch.solvers import eig as teig
from graphlearning_tpu_torch.solvers import lobpcg as tlobpcg
from test_torch_gather import cpu_accel, hub_graph  # noqa: F401

torch.set_num_threads(2)

NORMS = ("combinatorial", "normalized", "randomwalk", "coifmanlafon")


@pytest.fixture(scope="module")
def moons():
    """``make_moons(400, noise=0.08, random_state=0)``, its 10-NN graph."""
    import sklearn.datasets as datasets

    X, y = datasets.make_moons(n_samples=400, noise=0.08, random_state=0)
    return jgl.weightmatrix.knn(X, 10), y


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_normal(shape, seed=0, dtype=jnp.float64):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        dtype=dtype))


@pytest.fixture
def jax_start(monkeypatch):
    """The port's solves on JAX's starts (``jax.random.normal`` of the same
    key and shape)."""
    def start(n, k, key, dtype, device):
        dt = jnp.float32 if dtype == torch.float32 else jnp.float64
        return _t(_jax_normal((n, k), 0 if key is None else key, dt)).to(
            device)

    monkeypatch.setattr(teig, "_start", start)


def assert_vectors_close(Vt, Vj, vals, atol):
    """Columns equal up to sign, or, for eigenvalues within 1e-6 of each
    other, the same subspace (orthogonal projectors within ``atol``)."""
    Vt, Vj = np.asarray(Vt, dtype=float), np.asarray(Vj, dtype=float)
    vals = np.asarray(vals, dtype=float)
    start = 0
    for i in range(1, len(vals) + 1):
        if i < len(vals) and vals[i] - vals[i - 1] <= 1e-6:
            continue
        a, b = Vt[:, start:i], Vj[:, start:i]
        if i - start == 1:
            sign = np.sign(np.sum(a * b))
            np.testing.assert_allclose(a * sign, b, rtol=0, atol=atol)
        else:
            qa, qb = np.linalg.qr(a)[0], np.linalg.qr(b)[0]
            np.testing.assert_allclose(qa @ qa.T, qb @ qb.T, rtol=0,
                                       atol=atol)
        start = i


# -- LOBPCG -------------------------------------------------------------------


def _dense_operator(n, seed):
    """A dense symmetric matrix with top eigenvalues 4, 3, 2.6, 2.3, 2.1
    and the rest in [0, 1.5)."""
    rs = np.random.RandomState(seed)
    Q, _ = np.linalg.qr(rs.randn(n, n))
    ev = rs.rand(n) * 1.5
    ev[:5] = [4.0, 3.0, 2.6, 2.3, 2.1]
    A = (Q * ev) @ Q.T
    return (A + A.T) / 2


@pytest.mark.parametrize("k,tol", [(5, None), (5, 1e-9), (3, None)])
def test_lobpcg_standard_matches_jax(k, tol):
    n = 300
    A = _dense_operator(n, seed=k)
    X0 = _jax_normal((n, k))
    At = _t(A)
    tj, Uj, ij = jlobpcg(lambda X: jnp.asarray(A) @ X, jnp.asarray(X0),
                         m=200, tol=tol)
    tt, Ut, it = tlobpcg.lobpcg_standard(lambda X: At @ X, _t(X0), m=200,
                                         tol=tol)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-10)
    assert_vectors_close(Ut.numpy(), np.asarray(Uj), -np.asarray(tj), 1e-8)
    assert abs(it - int(ij)) <= 1 and it < 200


def test_lobpcg_standard_on_a_graph_operator_matches_jax(moons):
    """``I + D^-1/2 W D^-1/2`` of the moons graph, JAX's start: the same
    pairs after the same number of steps (the cap of 30)."""
    W = moons[0]
    n, k = W.shape[0], 4
    deg = np.asarray(W.sum(axis=1)).ravel()
    A = np.eye(n) + (W.multiply(np.outer(deg ** -0.5, deg ** -0.5))).toarray()
    X0 = _jax_normal((n, k))
    tj, Uj, ij = jlobpcg(lambda X: jnp.asarray(A) @ X, jnp.asarray(X0), m=30)
    At = _t(A)
    tt, Ut, it = tlobpcg.lobpcg_standard(lambda X: At @ X, _t(X0), m=30)
    assert it == int(ij)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-10)
    assert_vectors_close(Ut.numpy(), np.asarray(Uj), -np.asarray(tj), 1e-8)


def test_lobpcg_standard_refuses_bad_inputs():
    A = lambda X: X
    with pytest.raises(ValueError, match="search dim \\* 5"):
        tlobpcg.lobpcg_standard(A, torch.ones(20, 4, dtype=torch.float64))
    with pytest.raises(ValueError, match="search dim > 0"):
        tlobpcg.lobpcg_standard(A, torch.ones(20, 0, dtype=torch.float64))
    with pytest.raises(ValueError, match="same dtypes"):
        tlobpcg.lobpcg_standard(lambda X: X.float(),
                                torch.ones(20, 2, dtype=torch.float64))
    with pytest.raises(ValueError, match="must be \\(20, 20\\)"):
        tlobpcg.lobpcg_standard(lambda X: X[:10],
                                torch.ones(20, 2, dtype=torch.float64))


def test_per_pair_tol_is_free_of_n():
    """Float32 solves take the per-pair tolerance, float64 ones JAX's."""
    X = torch.zeros(500, 3, dtype=torch.float32)
    assert tlobpcg.per_pair_tol(None, X) == torch.finfo(torch.float32).eps \
        / 500
    assert tlobpcg.per_pair_tol(0, X) == tlobpcg.per_pair_tol(None, X)
    assert tlobpcg.per_pair_tol(1e-8, X) == 1e-8 / 500
    assert teig._lobpcg_tol(1e-8, X) == 1e-8 / 500
    X64 = X.double()
    assert teig._lobpcg_tol(0, X64) is None
    assert teig._lobpcg_tol(1e-8, X64) == 1e-8


@pytest.mark.parametrize("power", [1, 2])
def test_lobpcg_topk_fed_jax_start_matches_jax(moons, power):
    """``_lobpcg_topk`` on JAX's start, under JAX's tolerance (float64)."""
    W = moons[0]
    n, k = W.shape[0], 4
    jg = JSparseGraph.from_scipy(W)
    tg = SparseGraph.from_scipy(W, device="cpu")
    jmv = lambda X: X + jgl.ops.graphops.spmm(jg, X)
    tmv = lambda X: X + tgl.ops.graphops.spmm(tg, X)
    tj, Uj = jeig._lobpcg_topk(jmv, n, k, 1e-13, power=power)
    tt, Ut = teig._lobpcg_topk(tmv, n, k, 1e-13, power=power,
                               X0=_t(_jax_normal((n, k))))
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=1e-10)
    assert_vectors_close(Ut.numpy(), np.asarray(Uj), -np.asarray(tj), 1e-6)


# -- eigen_decomp ---------------------------------------------------------------


@pytest.mark.parametrize("normalization", NORMS)
def test_eigen_decomp_matches_jax(moons, jax_start, normalization):
    W = moons[0]
    vj, Vj = jeig.eigen_decomp(JSparseGraph.from_scipy(W), normalization,
                               k=5)
    info = {}
    vt, Vt = teig.eigen_decomp(SparseGraph.from_scipy(W, device="cpu"),
                               normalization, k=5, info=info)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-8)
    assert_vectors_close(Vt.numpy(), np.asarray(Vj), vt.numpy(), 1e-6)
    assert 0 < info["iters"] <= 200


@pytest.mark.parametrize("normalization,atol",
                         [("combinatorial", 1e-8), ("normalized", 1e-8),
                          ("randomwalk", 2e-5)])
def test_eigen_decomp_modularity_matches_jax(moons, jax_start, normalization,
                                            atol):
    """``gamma > 0``: the modularity operator, its shift from the power
    iteration.  Under "randomwalk" the operator is not symmetric (its rank
    one term is ``deg^1.5 deg^0.5^T``), LOBPCG solves with its symmetric
    part, and the two packages' rounding moves the lowest value by 8.4e-6
    (measured): atol 2e-5 there."""
    W = moons[0]
    vj, Vj = jeig.eigen_decomp(JSparseGraph.from_scipy(W), normalization,
                               k=4, gamma=0.5)
    vt, Vt = teig.eigen_decomp(SparseGraph.from_scipy(W, device="cpu"),
                               normalization, k=4, gamma=0.5)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=atol)
    if normalization != "randomwalk":
        assert_vectors_close(Vt.numpy(), np.asarray(Vj), vt.numpy(), 1e-6)


@pytest.mark.parametrize("normalization",
                         ["combinatorial", "normalized", "randomwalk"])
def test_eigen_decomp_lowrank_fed_jax_sketch_matches_jax(moons, monkeypatch,
                                                         normalization):
    """"lowrank" with ``randomized_svd`` drawing JAX's sketch (PRNGKey(0),
    ``(n, c)``)."""
    W = moons[0]
    k, c = 4, 12

    def fed(A, k=10, c=None, q=1, key=None, device=None):
        Omega = _t(_jax_normal((A.shape[1], c)))
        return tutils._randomized_svd(A, A, Omega, k, q)

    monkeypatch.setattr(tutils, "randomized_svd", fed)
    vj, Vj = jeig.eigen_decomp(JSparseGraph.from_scipy(W), normalization,
                               method="lowrank", k=k, c=c)
    vt, Vt = teig.eigen_decomp(SparseGraph.from_scipy(W, device="cpu"),
                               normalization, method="lowrank", k=k, c=c)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-8)
    assert_vectors_close(Vt.numpy(), np.asarray(Vj), vt.numpy(), 1e-6)


def test_eigen_decomp_refuses_bad_names(moons):
    g = SparseGraph.from_scipy(moons[0], device="cpu")
    with pytest.raises(ValueError, match="normalization"):
        teig.eigen_decomp(g, "bogus", k=3)
    with pytest.raises(ValueError, match="method"):
        teig.eigen_decomp(g, "normalized", method="bogus", k=3)


def test_eigen_decomp_float32_at_power_8_matches_jax(moons, jax_start):
    """Both packages in float32, where LOBPCG runs on the operator's 8th
    power: eigenvalues within 1e-4."""
    W = moons[0]
    jg = JSparseGraph.from_scipy(W, dtype=jnp.float32)
    tg = SparseGraph.from_scipy(W, dtype=torch.float32, device="cpu")
    assert teig._default_power(tg.vals.dtype) == 8
    vj, _ = jeig.eigen_decomp(jg, "normalized", k=5)
    vt, Vt = teig.eigen_decomp(tg, "normalized", k=5)
    assert vt.dtype == torch.float32 and Vt.dtype == torch.float32
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-4)


def test_smallest_eigh_and_power_iteration_match_jax(moons, jax_start):
    """The shifted solve of the combinatorial Laplacian and the power
    iteration of its shift, on JAX's starts."""
    W = moons[0]
    n = W.shape[0]
    jg = JSparseGraph.from_scipy(W)
    tg = SparseGraph.from_scipy(W, device="cpu")
    jL = lambda X: jgl.ops.graphops.laplacian_matvec(jg, X)
    tL = lambda X: tgl.ops.graphops.laplacian_matvec(tg, X)
    lj, _ = jeig.power_iteration(jL, n)
    lt, _ = teig.power_iteration(tL, n, device="cpu")
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-12)
    vj, Uj = jeig.smallest_eigh(jL, n, 4, 1.01 * float(lj))
    vt, Ut = teig.smallest_eigh(tL, n, 4, 1.01 * float(lj), device="cpu")
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-8)
    assert_vectors_close(Ut.numpy(), np.asarray(Uj), vt.numpy(), 1e-6)


# -- graph methods -------------------------------------------------------------


def test_graph_eigen_decomp_memo_and_device(moons, jax_start):
    W = moons[0]
    G = tgl.graph(W, device="cpu")
    vals, vecs = G.eigen_decomp(normalization="normalized", k=4)
    assert isinstance(vals, np.ndarray) and vecs.shape == (400, 4)
    key = ("normalized", "exact", 4, None, 0, 0, 1)
    assert set(G.eigendata["normalized"]) == {key}
    dv, dV = G.eigen_decomp_device(normalization="normalized", k=4)
    assert torch.is_tensor(dV) and dV is G.eigendata["normalized"][key][1]
    np.testing.assert_array_equal(dV.numpy(), vecs)
    assert G.eigen_info[key]["path"] == "plain ELL"
    Gj = jgl.graph(W)
    vj, Vj = Gj.eigen_decomp(normalization="normalized", k=4)
    np.testing.assert_allclose(vals, vj, rtol=0, atol=1e-8)
    assert_vectors_close(vecs, Vj, vals, 1e-6)


@pytest.mark.parametrize("return_value", [False, True])
def test_fiedler_vector_matches_jax(moons, jax_start, return_value):
    W = moons[0]
    out_t = tgl.graph(W, device="cpu").fiedler_vector(
        return_value=return_value)
    out_j = jgl.graph(W).fiedler_vector(return_value=return_value)
    if return_value:
        (vt, lt), (vj, lj) = out_t, out_j
        assert abs(lt - lj) < 1e-8
    else:
        vt, vj = out_t, out_j
    assert_vectors_close(vt[:, None], np.asarray(vj)[:, None], [0.0], 1e-6)


def test_fiedler_vector_per_pair_tol_beats_jax_rule(moons):
    """In float32 at ``tol=0`` (epsilon) the port's per-pair tolerance
    against the dense ``eigh``: the Fiedler pair within 1e-6 (value) and
    2e-4 (vector; 9.0e-5 measured, 78 steps).  JAX's float32 solve of the
    same k + b = 4 pairs, its threshold multiplied by n, stops with the
    vector 5.7e-3 off."""
    W = moons[0]
    deg = np.asarray(W.sum(axis=1)).ravel()
    s = np.diag(deg ** -0.5)
    ref_vals, ref_vecs = np.linalg.eigh(np.eye(400) - s @ W.toarray() @ s)
    G = tgl.graph(SparseGraph.from_scipy(W, dtype=torch.float32,
                                         device="cpu"))
    vec, val = G.fiedler_vector(return_value=True, tol=0)
    assert vec.dtype == np.float32
    assert abs(val - ref_vals[1]) < 1e-6
    assert_vectors_close(vec[:, None], ref_vecs[:, 1:2], [0.0], 2e-4)
    _, Vj = jeig.eigen_decomp(JSparseGraph.from_scipy(W, dtype=jnp.float32),
                              "normalized", k=4, tol=0)
    with pytest.raises(AssertionError):
        assert_vectors_close(np.asarray(Vj)[:, 1:2], ref_vecs[:, 1:2], [0.0],
                             1e-3)


@pytest.mark.parametrize("full", [False, True])
def test_diffusion_map_matches_jax(moons, jax_start, full):
    W = moons[0]
    vt, Et = tgl.graph(W, device="cpu").diffusion_map(k=2, alpha=0.5, d=4,
                                                      full=full)
    vj, Ej = jgl.graph(W).diffusion_map(k=2, alpha=0.5, d=4, full=full)
    assert Et.shape == (400, 4 if full else 3)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=1e-8)
    assert_vectors_close(Et, Ej, vt, 1e-6)


# -- utils ----------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["scipy", "dense", "graph"])
def test_randomized_svd_fed_jax_sketch_matches_jax(moons, kind):
    """The sketch, power iterations, QR and SVD on JAX's sketch, for a
    rectangular scipy matrix, a dense array and a graph (symmetric).  JAX
    takes the rectangular scipy matrix into its padded ELL, which gives
    NaN: it is held to JAX's result on the same matrix made dense."""
    W = moons[0]
    rs = np.random.RandomState(3)
    A = {"scipy": sp.random(300, 200, density=0.05, random_state=rs,
                            format="csr"),
         "dense": rs.randn(120, 80),
         "graph": W}[kind]
    Aj = {"scipy": A.toarray() if kind == "scipy" else None,
          "dense": A, "graph": JSparseGraph.from_scipy(W)}[kind]
    At = SparseGraph.from_scipy(W, device="cpu") if kind == "graph" else A
    k, c, q = 5, 15, 2
    uj, sj, vtj = jgl.utils.randomized_svd(Aj, k=k, c=c, q=q)
    Omega = _t(_jax_normal((A.shape[1], c)))
    cpu = torch.device("cpu")
    mv = tutils._as_matvec(At, cpu)
    rmv = mv if kind == "graph" else tutils._as_matvec(
        A.T if kind == "dense" else A.T.tocsr(), cpu)
    ut, st, vtt = tutils._randomized_svd(mv, rmv, Omega, k, q)
    np.testing.assert_allclose(st, sj, rtol=1e-10, atol=1e-12)
    sign = np.sign(np.sum(ut * uj, axis=0))
    np.testing.assert_allclose(ut * sign, uj, rtol=0, atol=1e-8)
    np.testing.assert_allclose(vtt * sign[:, None], vtj, rtol=0, atol=1e-8)


def test_randomized_svd_seeds_and_exact_rank():
    """A rank-6 matrix is recovered exactly from any sketch of 12 columns:
    the singular values are JAX's; the same seed (or generator state)
    gives the same factors."""
    rs = np.random.RandomState(0)
    A = rs.randn(200, 6) @ rs.randn(6, 150)
    ut, st, vtt = tgl.utils.randomized_svd(A, k=6, c=12, device="cpu")
    _, sj, _ = jgl.utils.randomized_svd(A, k=6, c=12)
    np.testing.assert_allclose(st, sj, rtol=1e-10)
    np.testing.assert_allclose((ut * st) @ vtt, A, rtol=0, atol=1e-10)
    again = tgl.utils.randomized_svd(A, 6, 12, 1, 0, device="cpu")
    np.testing.assert_array_equal(again[0], ut)
    gen = torch.Generator().manual_seed(0)
    np.testing.assert_array_equal(
        tgl.utils.randomized_svd(A, 6, 12, 1, gen, device="cpu")[0], ut)
    other = tgl.utils.randomized_svd(A, 6, 12, 1, 5, device="cpu")
    np.testing.assert_allclose(other[1], st, rtol=1e-10)
    with pytest.raises(ValueError, match="shape"):
        tgl.utils.randomized_svd(lambda X: X, device="cpu")


@pytest.mark.parametrize("k", [1, 3])
def test_dirichlet_eigenvectors_matches_jax(moons, k):
    W = moons[0]
    L = sp.diags(np.asarray(W.sum(axis=1)).ravel()) - W
    ind = np.arange(0, 400, 37)
    vt, Vt = tgl.utils.dirichlet_eigenvectors(L, ind, k)
    vj, Vj = jgl.utils.dirichlet_eigenvectors(L, ind, k)
    np.testing.assert_allclose(vt, vj, rtol=1e-10)
    assert Vt.shape == ((400,) if k == 1 else (400, k))
    np.testing.assert_array_equal(Vt.reshape(400, -1)[ind], 0)
    assert_vectors_close(Vt.reshape(400, -1), Vj.reshape(400, -1), vt, 1e-8)


# -- on the gather and the band -----------------------------------------------


def test_gather_eig_normalized_fed_jax_start_matches_jax(hub_graph):
    """The gather's ``eig_normalized`` (one entry of ``SpmmSolvers``) on
    JAX's start, at JAX's tolerance (float64) and power 1."""
    W = hub_graph[0]
    n, k = W.shape[0], 4
    deg = np.asarray(W.sum(axis=1)).ravel()
    jacc = jgather.GatherAccel(W, prec="f32")
    tacc = tgather.GatherAccel(W, prec="f32", device="cpu")
    vj, Uj = jacc.eig_normalized(jacc.to_perm(jnp.asarray(deg ** -0.5)), k,
                                 power=1)
    info = {}
    vt, Ut = tacc.eig_normalized(tacc.to_perm(_t(deg ** -0.5)), k, power=1,
                                 X0=_t(_jax_normal((n, k))), info=info)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), rtol=0, atol=1e-8)
    assert_vectors_close(tacc.from_perm(Ut).numpy(),
                         np.asarray(jacc.from_perm(Uj)), vt.numpy(), 1e-6)
    assert 0 < info["iters"] <= 200


def test_graph_eigen_decomp_on_the_gather(hub_graph, cpu_accel, jax_start):
    """On the hub graph ``maybe_build`` takes the gather: the solve starts
    from the plain path's draw and gives JAX's spectrum."""
    W = hub_graph[0]
    G = tgl.graph(W.copy(), device="cpu")
    vals, vecs = G.eigen_decomp(normalization="randomwalk", k=4)
    key = ("randomwalk", "exact", 4, None, 0, 0, 1)
    assert "GatherAccel" in G.eigen_info[key]["path"]
    assert isinstance(G._accel_eig, tgather.GatherAccel)
    vj, Vj = jgl.graph(W).eigen_decomp(normalization="randomwalk", k=4)
    np.testing.assert_allclose(vals, vj, rtol=0, atol=1e-8)
    assert_vectors_close(vecs, Vj, vals, 1e-6)


@pytest.mark.parametrize("normalization", ["normalized", "randomwalk"])
def test_graph_eigen_decomp_on_the_band(moons, cpu_accel, monkeypatch,
                                        normalization):
    """On the moons ``maybe_build`` takes the packed band (K1, K2's twin on
    an f32 band): within 1e-5 of the plain path (JAX's bound for its band,
    ``test_eigen_decomp_accel_matches_plain``), the padding rows kept out
    of the vectors; "lowrank" and ``gamma`` build no accel."""
    W = moons[0]
    G = tgl.graph(W.copy(), device="cpu")
    vals, vecs = G.eigen_decomp(normalization=normalization, k=4)
    key = (normalization, "exact", 4, None, 0, 0, 1)
    acc = G._accel_eig
    assert isinstance(acc, taccel.AccelSpMM) and acc.n_pad > 400
    assert G.eigen_info[key]["path"] == "packed tiles (K2)"
    assert vecs.shape == (400, 4) and np.all(np.isfinite(vecs))
    monkeypatch.setattr(taccel, "enabled", lambda device: False)
    plain_vals, plain_vecs = tgl.graph(W, device="cpu").eigen_decomp(
        normalization=normalization, k=4)
    np.testing.assert_allclose(vals, plain_vals, rtol=0, atol=1e-5)
    assert_vectors_close(vecs, plain_vecs, vals, 1e-3)
    monkeypatch.setattr(taccel, "enabled", lambda device: True)
    G2 = tgl.graph(W.copy(), device="cpu")
    G2.eigen_decomp(normalization=normalization, method="lowrank", k=4)
    G2.eigen_decomp(normalization=normalization, k=4, gamma=0.5)
    assert not hasattr(G2, "_accel_eig")
