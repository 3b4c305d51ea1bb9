"""The segmented gather (``ops/gather.py``) of graphlearning_tpu_torch
against graphlearning_tpu, and ``maybe_build``'s fallback to it.

The graph is a 10-d three-cluster mixture with a planted hub of degree
240, so the segment at kcap 256 (>= 128, the JAX package's flat-take
branch) runs.  Both packages run on the CPU at float64 (JAX's x64 on, the
port's CPU dtype): every comparison holds to 1e-10 or tighter.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.spatial import cKDTree

from graphlearning_tpu.ops import gather as jgather
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch.ops import accel as taccel
from graphlearning_tpu_torch.ops import gather as tgather

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def hub_graph():
    """10-d mixture, exact 8-NN gaussian weights, node 0 joined to 240
    random nodes; symmetrized.  Returns ``(W, labels, train_ind)``."""
    rs = np.random.RandomState(0)
    n, dim, k, hub = 1200, 10, 8, 240
    centers = rs.randn(3, dim) * 1.6
    labels = rs.randint(0, 3, n)
    X = centers[labels] + rs.randn(n, dim)
    dist, ind = cKDTree(X).query(X, k=k + 1)
    dist, ind = dist[:, 1:], ind[:, 1:]
    w = np.exp(-4 * dist ** 2 / dist[:, -1:] ** 2)
    W = sp.csr_matrix((w.ravel(), (np.repeat(np.arange(n), k), ind.ravel())),
                      shape=(n, n))
    nb = rs.choice(np.arange(1, n), hub, replace=False)
    W = W + sp.csr_matrix((rs.rand(hub) + 0.1, (np.zeros(hub, int), nb)),
                          shape=(n, n))
    W = ((W + W.T) / 2).tocsr()
    train_ind = np.concatenate([rs.choice(np.where(labels == c)[0], 5,
                                          replace=False) for c in range(3)])
    return W, labels, train_ind


def test_segments_identical_to_jax(hub_graph):
    W, _, _ = hub_graph
    j = jgather.GatherSpMM(W, prec="f32")
    t = tgather.GatherSpMM(W, prec="f32", device="cpu")
    assert t.segs == j.segs and max(kc for _, _, kc in t.segs) >= 128
    np.testing.assert_array_equal(t.order, j.order)
    for tc, tv, jc, jv in zip(t.cols, t.vals, j.cols, j.vals):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert t.slots == sum((e - s) * kc for s, e, kc in j.segs)


def test_mega_hub_gets_its_own_segment():
    """A hub over the table's last boundary (degree 4101 > 4096) gets one
    more segment at its degree rounded up to a multiple of 8, as in JAX;
    isolated rows fold into the first segment.  ``spmm`` is ``W @ X``
    within 1e-12 of max|ref| at f64."""
    rs = np.random.RandomState(5)
    n, hub = 4400, 4101
    ring = np.arange(1, n - 50)                      # rows n-50.. isolated
    nb = rs.choice(np.arange(1, n - 50), hub, replace=False)
    rows = np.concatenate([ring, np.zeros(hub, int)])
    cols = np.concatenate([ring % (n - 51) + 1, nb])
    W = sp.csr_matrix((rs.rand(len(rows)) + 0.1, (rows, cols)),
                      shape=(n, n))
    W = ((W + W.T) / 2).tocsr()
    j = jgather.GatherSpMM(W, prec="f32")
    t = tgather.GatherSpMM(W, prec="f32", device="cpu")
    assert t.segs == j.segs
    assert t.segs[-1] == (n - 1, n, -(-int(np.diff(W.indptr).max()) // 8)
                          * 8) and t.segs[-1][2] > tgather._BOUNDS[-1]
    assert t.segs[0][0] == 0 and t.slots >= W.nnz
    X = np.random.RandomState(3).randn(n, 4)
    out = t.from_perm(t.spmm(t.to_perm(torch.as_tensor(X)))).numpy()
    ref = W @ X
    assert np.abs(out - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("cells", [tgather._GATHER_CELLS, 100])
def test_spmm_matches_jax_and_scipy(hub_graph, monkeypatch, cells):
    """``spmm`` at f64 equals JAX's and ``W @ X`` within 1e-12 of
    max|ref|, whether a segment is gathered whole or in chunks of a few
    rows (``_GATHER_CELLS``)."""
    monkeypatch.setattr(tgather, "_GATHER_CELLS", cells)
    W, _, _ = hub_graph
    X = np.random.RandomState(1).randn(W.shape[0], 7)
    j = jgather.GatherSpMM(W, prec="f32")
    ref_j = np.asarray(j.from_perm(j.spmm(j.to_perm(X))))
    t = tgather.GatherSpMM(W, prec="f32", device="cpu")
    Xt = torch.as_tensor(X)
    out = t.from_perm(t.spmm(t.to_perm(Xt))).numpy()
    ref = W @ X
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= 1e-12 * scale
    assert np.abs(out - ref_j).max() <= 1e-12 * scale
    x1 = t.spmm(t.to_perm(Xt[:, 0]))                    # a vector
    assert x1.shape == (W.shape[0],)
    np.testing.assert_allclose(t.from_perm(x1).numpy(), ref[:, 0],
                               rtol=0, atol=1e-12 * scale)


def test_bf16_and_auto_tables(hub_graph, monkeypatch):
    """bf16 tables within JAX's 2e-2 of ``W @ X``; "auto" keeps the f32
    table under ``_FAST_TABLE_BYTES`` and takes bf16 over it."""
    W, _, _ = hub_graph
    X = torch.as_tensor(np.random.RandomState(2).randn(W.shape[0], 5),
                        dtype=torch.float32)
    ref = W @ X.double().numpy()
    f32 = tgather.GatherSpMM(W, prec="f32", device="cpu")
    bf = tgather.GatherSpMM(W, prec="bf16", device="cpu")
    auto = tgather.GatherSpMM(W, prec="auto", device="cpu")
    out = lambda g: g.from_perm(g.spmm(g.to_perm(X))).double().numpy()
    rel = np.abs(out(bf) - ref).max() / np.abs(ref).max()
    assert 1e-6 < rel < 2e-2, rel
    np.testing.assert_array_equal(out(auto), out(f32))
    monkeypatch.setattr(tgather, "_FAST_TABLE_BYTES", 1)
    np.testing.assert_array_equal(out(auto), out(bf))
    with pytest.raises(ValueError):
        tgather.GatherSpMM(W, prec="f16", device="cpu")


def _solver_inputs(W, labels, train_ind, acc_j, acc_t):
    """Permuted inputs of the three entries for both packages."""
    n = W.shape[0]
    deg = np.asarray(W.sum(1)).ravel()
    rs = np.random.RandomState(4)
    mask = np.zeros(n, bool)
    mask[train_ind] = True
    bdy = np.zeros((n, 3))
    bdy[train_ind] = np.eye(3)[labels[train_ind]]
    b = rs.randn(n, 3)
    v0 = mask / mask.sum()
    arrays = {"deg": deg, "s": deg ** -0.5, "mask": mask, "bdy": bdy,
              "b": b, "Db": b / deg[:, None], "v0": v0,
              "tau": np.zeros(n)}
    jp = {k: acc_j.to_perm(v) for k, v in arrays.items()}
    tp = {k: acc_t.to_perm(torch.as_tensor(v)) for k, v in arrays.items()}
    return jp, tp


@pytest.mark.parametrize("normalization", ["combinatorial", "normalized"])
def test_gather_accel_entries_match_jax(hub_graph, normalization):
    """cg_scaled, laplace_constrained and poisson_gd of GatherAccel against
    JAX's GatherAccel, at f64."""
    W, labels, train_ind = hub_graph
    acc_j = jgather.GatherAccel(W, prec="f32")
    acc_t = tgather.GatherAccel(W, prec="f32", device="cpu")
    assert not acc_t.materialize and not acc_t.rect_band_ok()
    assert acc_t.rect_band_bytes() == 0 and acc_t.n_pad == W.shape[0]
    assert acc_t.n_resid == 0 and acc_t.mode == "f32"
    jp, tp = _solver_inputs(W, labels, train_ind, acc_j, acc_t)

    x_j = acc_j.cg_scaled(jp["s"], jp["b"], c0=1.0, c1=0.9, tol=1e-12)
    x_t, iters = acc_t.cg_scaled(tp["s"], tp["b"], c0=1.0, c1=0.9,
                                 tol=1e-12)
    assert iters > 5
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), rtol=1e-9,
                               atol=1e-10)

    diag = (tp["deg"] if normalization == "combinatorial"
            else torch.ones_like(tp["deg"]))
    u_j = acc_j.laplace_constrained(
        jp["deg"], np.asarray(diag), jp["tau"], jp["mask"], jp["bdy"],
        1e-12, normalization=normalization)
    u_t, iters = acc_t.laplace_constrained(
        tp["deg"], diag, tp["tau"], tp["mask"], tp["bdy"], 1e-12,
        normalization=normalization)
    assert iters > 5
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-9,
                               atol=1e-10)

    g_j = acc_j.poisson_gd(jp["deg"], jp["Db"], jp["v0"], 20, 200,
                           W.shape[0])
    g_t, T = acc_t.poisson_gd(tp["deg"], tp["Db"], tp["v0"], 20, 200,
                              W.shape[0])
    assert 20 <= T <= 200
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-10,
                               atol=1e-10)


@pytest.fixture
def cpu_accel(monkeypatch):
    """maybe_build on the CPU at this size (its band path needs CUDA)."""
    monkeypatch.setattr(taccel, "enabled", lambda device: True)
    monkeypatch.setattr(taccel, "_MIN_N", 1)


def test_maybe_build_takes_the_gather(hub_graph, cpu_accel, monkeypatch):
    """A band-hostile graph gets a GatherAccel (cached on the model and on
    W), and None under GLT_NO_GATHER, which enters the cache key."""
    W = hub_graph[0].copy()
    assert taccel._band_hostile(W)
    holder = type("Holder", (), {})()
    acc = taccel.maybe_build(W, cache_obj=holder, device="cpu")
    assert isinstance(acc, tgather.GatherAccel) and acc.prec == "f32"
    assert holder._accel_cache is acc
    assert taccel.maybe_build(W, device="cpu") is acc
    assert "GatherAccel" in taccel.path_name(acc)
    assert taccel.maybe_build(W, device="cpu", mode="bf16").prec == "auto"
    monkeypatch.setenv("GLT_NO_GATHER", "1")
    assert taccel.maybe_build(W, cache_obj=holder, device="cpu") is None
    assert taccel.path_name(holder._accel_cache) == "plain ELL"
    monkeypatch.delenv("GLT_NO_GATHER")
    assert taccel.maybe_build(W, cache_obj=holder, device="cpu") is acc


def test_maybe_build_gather_on_budget_and_cost(hub_graph, cpu_accel,
                                               monkeypatch):
    """Off the band-hostile gate the gather also takes a stored band over
    the budget (BandPlanUnavailable) and a band the cost model rejects;
    any other error raises."""
    monkeypatch.setattr(taccel, "_band_hostile", lambda W: False)
    monkeypatch.setattr(taccel, "_TILES_R", 128)
    monkeypatch.setattr(taccel, "_TILES_WT", 128)
    W = hub_graph[0]
    monkeypatch.setattr(taccel, "_band_budget_bytes", lambda dev: 1e3)
    acc = taccel.maybe_build(W.copy(), device="cpu", materialize=True)
    assert isinstance(acc, tgather.GatherAccel)
    monkeypatch.setattr(taccel, "_band_budget_bytes", lambda dev: 6e9)
    monkeypatch.setattr(taccel, "_GATHER_NS", 0.0)
    assert isinstance(taccel.maybe_build(W.copy(), device="cpu"),
                      tgather.GatherAccel)

    def broken(*a, **kw):
        raise RuntimeError("not a budget problem")

    monkeypatch.setattr(taccel, "AccelSpMM", broken)
    with pytest.raises(RuntimeError, match="not a budget problem"):
        taccel.maybe_build(W.copy(), device="cpu")


@pytest.mark.parametrize("name", ["laplace", "poisson", "poisson_gd",
                                  "randomwalk"])
def test_fits_through_the_gather_match_plain(hub_graph, cpu_accel,
                                             monkeypatch, name):
    """The fits through GatherAccel predict as the plain ELL path, with
    ``prob`` allclose at f64."""
    W, labels, train_ind = hub_graph
    make = {"laplace": lambda W: tgl.ssl.laplace(W, tol=1e-10,
                                                 device="cpu"),
            "poisson": lambda W: tgl.ssl.poisson(W, tol=1e-10,
                                                 device="cpu"),
            "poisson_gd": lambda W: tgl.ssl.poisson(
                W, solver="gradient_descent", device="cpu"),
            "randomwalk": lambda W: tgl.ssl.randomwalk(W, device="cpu")}[name]
    m = make(W.copy())
    pred = m.fit_predict(train_ind, labels[train_ind])
    acc = m._accel_gd if name == "poisson_gd" else m._accel_cache
    assert isinstance(acc, tgather.GatherAccel)
    monkeypatch.setattr(taccel, "enabled", lambda device: False)
    ref = make(W.copy())
    ref_pred = ref.fit_predict(train_ind, labels[train_ind])
    np.testing.assert_allclose(m.prob, ref.prob, rtol=1e-7, atol=1e-9)
    np.testing.assert_array_equal(pred, ref_pred)


def test_distance_and_lipschitz_gates_refuse_the_gather(hub_graph,
                                                        cpu_accel):
    """The gather stores no band: the Lipschitz fits take their plain path
    with it, as in the JAX package, and dijkstra given it runs the
    gather's own relaxation (``supports_bellman_ford``, in f32 as JAX:
    distances within 1e-6 relative of the plain path's f64).  The
    distance and Lipschitz accels (``gather=False``) build no gather for a
    band-hostile graph, and a later fit on the same W still gets one."""
    from graphlearning_tpu_torch.solvers import eikonal, plaplace

    W, labels, train_ind = hub_graph
    acc = taccel.maybe_build(W.copy(), device="cpu")
    assert isinstance(acc, tgather.GatherAccel)
    g = tgl.SparseGraph.from_scipy(W, device="cpu")
    info = {}
    d = eikonal.dijkstra(g, train_ind, accel=acc, info=info)
    assert info["path"] == "gather"
    d = eikonal.dijkstra(g, train_ind)
    np.testing.assert_allclose(eikonal.dijkstra(g, train_ind, accel=acc), d,
                               rtol=1e-6, atol=0)
    assert not plaplace._use_band(acc, 3)

    Wc = W.copy()
    G = tgl.graph(Wc, device="cpu")
    np.testing.assert_array_equal(G.dijkstra(train_ind), d)
    assert G._accel_exact() is None
    assert G._accel_exact_cache.gather_reason
    assert not any(isinstance(v, tgather.GatherAccel)
                   for v in Wc._gltt_accel_cache.values())
    assert taccel.maybe_build(Wc, device="cpu", gather=False) is None
    built = taccel.maybe_build(Wc, device="cpu")
    assert isinstance(built, tgather.GatherAccel)
    assert taccel.maybe_build(Wc, device="cpu", gather=False) is None
    assert taccel.maybe_build(Wc, device="cpu") is built


def test_gather_needs_a_device_or_a_gpu(hub_graph):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA default applies")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgather.GatherSpMM(hub_graph[0])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgather.GatherAccel(hub_graph[0])
