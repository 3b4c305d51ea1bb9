"""Graph distances and p-eikonal of graphlearning_tpu_torch against
graphlearning_tpu on the CPU, at float64: distances within 1e-10 and
closest points identical on random weights (no ties), the band path held
to JAX's band path in interpret mode at its own tolerance (rtol 1e-5)."""

import numpy as np
import pytest
import torch

import graphlearning_tpu as jgl
from graphlearning_tpu.ops import accel as jaccel
from graphlearning_tpu.solvers import eikonal as jeik
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch.ops import accel as taccel
from graphlearning_tpu_torch.ops import band_spmm as tbs
from graphlearning_tpu_torch.solvers import eikonal as teik

from conftest import random_knn_csr

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture(scope="module")
def W():
    return random_knn_csr(500, 8, seed=11)


@pytest.fixture(scope="module")
def graphs(W):
    cols, vals, deg = jgl.SparseGraph.ell_from_scipy(W)
    return (jgl.SparseGraph.from_ell_np(cols, vals, deg),
            tgl.SparseGraph.from_ell_np(cols, vals, deg, device="cpu"))


SEEDS = np.array([3, 77, 250, 401])


@pytest.mark.parametrize("kw", [
    dict(), dict(reciprocal_weights=True), dict(max_dist=0.3),
    dict(bdy_val=np.array([0.0, 0.5, 1.0, 0.25]), f=2.0),
])
def test_dijkstra_matches_jax(graphs, kw):
    jg, tg = graphs
    kw = dict(kw)
    bdy_val = kw.pop("bdy_val", np.zeros(len(SEEDS)))
    dj, cj = jeik.dijkstra(jg, SEEDS, bdy_val=bdy_val, return_cp=True, **kw)
    dt, ct = teik.dijkstra(tg, SEEDS, bdy_val=bdy_val, return_cp=True, **kw)
    np.testing.assert_allclose(dt, dj, **TOL)
    np.testing.assert_array_equal(ct, cj)
    assert ct.dtype == np.int32 and np.isinf(dt).any() == ("max_dist" in kw)


def test_dijkstra_hl_and_max_iter_match_jax(graphs):
    jg, tg = graphs
    bv = np.array([0.0, 1.0, 2.0, 0.5])
    dj, cj = jeik.dijkstra_hl(jg, SEEDS, bdy_val=bv, return_cp=True)
    dt, ct = teik.dijkstra_hl(tg, SEEDS, bdy_val=bv, return_cp=True)
    np.testing.assert_allclose(dt, dj, **TOL)
    np.testing.assert_array_equal(ct, cj)
    # a capped round count stops both at the same unfinished iterate
    dj = jeik.dijkstra(jg, SEEDS, max_iter=3)
    dt = teik.dijkstra(tg, SEEDS, max_iter=3)
    np.testing.assert_array_equal(np.isinf(dt), np.isinf(dj))
    np.testing.assert_allclose(dt[np.isfinite(dj)], dj[np.isfinite(dj)],
                               **TOL)


@pytest.mark.parametrize("centered", [False, True])
def test_distance_matrix_matches_jax(W, centered):
    Ws = W[:200][:, :200].tocsr()
    jg = jgl.SparseGraph.from_scipy(Ws)
    tg = tgl.SparseGraph.from_scipy(Ws, device="cpu")
    dj = jeik.distance_matrix(jg, centered=centered)
    dt = teik.distance_matrix(tg, centered=centered, panel_bytes=200 * 8 * 8
                              * 16)            # several panels
    np.testing.assert_array_equal(np.isinf(dt), np.isinf(dj))
    fin = np.isfinite(dj)
    np.testing.assert_allclose(dt[fin], dj[fin], **TOL)


@pytest.mark.parametrize("p", [1, 2])
def test_peikonal_matches_jax(graphs, p):
    jg, tg = graphs
    bv = np.array([0.0, 0.1, 0.2, 0.0])
    np.testing.assert_allclose(teik.peikonal(tg, SEEDS, bdy_val=bv, p=p),
                               jeik.peikonal(jg, SEEDS, bdy_val=bv, p=p),
                               **TOL)


@pytest.mark.parametrize("p,prefix", [(1, None), (1, "0"), (2, None)])
def test_peikonal_mc_and_bellman_ford_mc_match_jax(graphs, monkeypatch, p,
                                                   prefix):
    jg, tg = graphs
    if prefix is not None:
        monkeypatch.setenv("GLT_PEIKONAL_PREFIX", prefix)
    sets = [SEEDS[:2], SEEDS[2:3], SEEDS[3:]]
    info = {}
    out = teik.peikonal_mc(tg, sets, p=p, f=1.5, info=info)
    # the p = 1 bisection: a test "op > f" can flip on the last bit of a
    # sum taken in another order, moving the 30-step bracket (2^-30 of its
    # start, about 1e-9 relative here)
    tol = dict(rtol=1e-8, atol=1e-8) if prefix == "0" else TOL
    np.testing.assert_allclose(out, jeik.peikonal_mc(jg, sets, p=p, f=1.5),
                               **tol)
    assert info["iters"] > 0
    D0 = np.full((500, 3), 1e30)
    for c, s in enumerate(sets):
        D0[s, c] = 0.0
    f = np.random.RandomState(0).rand(500) + 0.5
    for recip in (False, True):
        ref = np.asarray(jeik._bellman_ford_mc(
            jg, jnp_f64(D0), jnp_f64(f), recip=recip, max_iter=10**6))
        got = teik._bellman_ford_mc(tg, torch.as_tensor(D0),
                                    torch.as_tensor(f), recip=recip,
                                    max_iter=10**6).numpy()
        np.testing.assert_allclose(got, ref, **TOL)


def jnp_f64(a):
    import jax.numpy as jnp
    return jnp.asarray(a, jnp.float64)


@pytest.fixture(scope="module")
def moons():
    rs = np.random.RandomState(0)
    n = 600
    t = np.linspace(0, np.pi, n // 2)
    X = np.vstack([np.stack([np.cos(t), np.sin(t)], 1),
                   np.stack([1 - np.cos(t), 1 - np.sin(t) - 0.5], 1)])
    y = np.repeat([0, 1], n // 2)
    perm = rs.permutation(n)
    X, y = X[perm] + rs.normal(scale=0.1, size=(n, 2)), y[perm]
    W = jgl.weightmatrix.knn(X, 10)
    return W, y, jgl.trainsets.generate(y, rate=5, seed=0)


@pytest.mark.parametrize("name,kw", [
    ("graph_nearest_neighbor", {}),
    ("graph_nearest_neighbor", {"class_priors": [0.5, 0.5]}),
    ("peikonal", {}),
    ("peikonal", {"p": 2}),
])
def test_distance_models_predict_as_jax(moons, name, kw):
    W, y, ti = moons
    jm = getattr(jgl.ssl, name)(W, **kw)
    tm = getattr(tgl.ssl, name)(W, device="cpu", **kw)
    np.testing.assert_array_equal(tm.fit_predict(ti, y[ti]),
                                  jm.fit_predict(ti, y[ti]))
    np.testing.assert_allclose(tm.prob, jm.prob, **TOL)


def test_graph_methods_match_jax(moons):
    W = moons[0]
    jG, tG = jgl.graph(W), tgl.graph(W, device="cpu")
    np.testing.assert_allclose(tG.dijkstra([5, 9]), jG.dijkstra([5, 9]),
                               **TOL)
    assert tG.distance(5, 20) == pytest.approx(jG.distance(5, 20), rel=1e-12)
    np.testing.assert_allclose(tG.peikonal([5, 9], nl_bdy=True),
                               jG.peikonal([5, 9], nl_bdy=True), **TOL)


@pytest.fixture
def band_forced(monkeypatch):
    """Band path on in both packages, at small tiles for this size."""
    monkeypatch.setattr(jaccel, "_MIN_N", 1)
    monkeypatch.setattr(jaccel, "enabled", lambda: True)
    monkeypatch.setenv("GLT_ACCEL_INTERPRET", "1")
    monkeypatch.setattr(taccel, "_MIN_N", 1)
    monkeypatch.setattr(taccel, "enabled", lambda device: True)
    monkeypatch.setattr(taccel, "_TILES_R", 256)
    monkeypatch.setattr(taccel, "_TILES_WT", 128)


@pytest.mark.parametrize("packed", [True, False])
def test_band_bellman_ford_matches_jax(moons, band_forced, packed):
    """The band path (K7 twin) of graph.dijkstra against JAX's band path
    and the port's plain path; where closest points differ, both seeds
    are equidistant."""
    W = moons[0].copy()
    n = W.shape[0]
    seeds = np.random.RandomState(3).choice(n, 7, replace=False)
    acc = taccel.AccelSpMM(W, device="cpu", packed=packed)
    assert acc.packed == packed and len(acc.tiles_plan.slab_block) > 4
    tg = tgl.SparseGraph.from_scipy(W, device="cpu")
    tbs.reset_launches()
    for hl in (False, True):
        solve = teik.dijkstra_hl if hl else teik.dijkstra
        info = {}
        d_b, cp_b = solve(tg, seeds, bdy_val=np.zeros(7), return_cp=True,
                          accel=acc, info=info)
        assert info["path"] == "band"
        d_p, cp_p = solve(tg, seeds, bdy_val=np.zeros(7), return_cp=True)
        np.testing.assert_allclose(d_b, d_p, rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(cp_b, cp_p)
    jacc = jaccel.AccelSpMM(W, interpret=True, materialize=True)
    d_j, cp_j = jeik.dijkstra(jgl.SparseGraph.from_scipy(W), seeds,
                              bdy_val=np.zeros(7), return_cp=True,
                              accel=jacc)
    d_b, cp_b = teik.dijkstra(tg, seeds, bdy_val=np.zeros(7),
                              return_cp=True, accel=acc)
    np.testing.assert_allclose(d_b, d_j, rtol=1e-5, atol=1e-6)
    dm = np.stack([teik.dijkstra(tg, [s]) for s in seeds])
    pos = {s: i for i, s in enumerate(seeds)}
    for i in np.nonzero(cp_b != cp_j)[0]:
        np.testing.assert_allclose(dm[pos[cp_b[i]], i], dm[pos[cp_j[i]], i],
                                   rtol=1e-5)
    # reciprocal weights on the band
    d_r = teik.dijkstra(tg, seeds, reciprocal_weights=True, accel=acc)
    np.testing.assert_allclose(
        d_r, teik.dijkstra(tg, seeds, reciprocal_weights=True), rtol=1e-12)


def test_graph_dijkstra_takes_the_band(moons, band_forced):
    W = moons[0].copy()
    G = tgl.graph(W, device="cpu")
    d = G.dijkstra([4, 40], return_cp=False)
    assert isinstance(G._accel_exact_cache, taccel.AccelSpMM)
    np.testing.assert_allclose(
        d, teik.dijkstra(G.sparse, [4, 40]), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["graph_nearest_neighbor", "plaplace",
                                  "amle", "peikonal"])
def test_new_models_run_on_cuda_by_default(moons, monkeypatch, name):
    """Without a GPU the new models raise unless the CPU is asked for."""
    from graphlearning_tpu_torch import config

    monkeypatch.setattr(config, "_default_device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tgl.ssl, name)(moons[0])
    model = getattr(tgl.ssl, name)(moons[0], device="cpu")
    assert model.graph.device.type == "cpu"
