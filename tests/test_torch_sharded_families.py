"""The second half of the distribution layer (P15b) on spawned gloo ranks
at P = 2 and 4, on the "gspmd" (ELL rows, all-gathered X) and the
"banded" (K1, K3, K7 and K9 over the ring halo, on the kernels' CPU
twins) routes, on the n = 603 three-cluster kNN graph (n not a multiple
of P), held to the JAX package's sharded fits on its 4-device CPU mesh:

* the halo methods of one partitioned band alone (R = WT = 64, f64, a
  halo cut to force residual edges, n = 997): ``neighbor_take_`` equal
  to the ELL's ``x[cols]``, ``minplus_`` (plain, reciprocal, Hopf-Lax)
  within 1e-14 relative of the ELL round with the same global argmin,
  ``lip_reduce_`` at C = 2 and 40 (two K9 column blocks): sums within
  1e-12 of max|ref|, min and max equal;
* the deterministic families (graph NN, p-Laplace, AMLE weighted and not,
  p-eikonal, sparse label propagation, Dijkstra with its closest points,
  the centered kernel from JAX's power vector, VolumeMBO at temperature
  0): ``u`` within ``ATOL`` of max|u| of JAX's sharded fit (the distance
  and Lipschitz families on each route against JAX's fit on the same
  route; the others against JAX's "gspmd" fit) and the predictions equal
  (VolumeMBO on the band, whose padded row space is not JAX's "gspmd"
  one: agreeing on 0.98 of the nodes, JAX's band);
* the eigensolvers: eigenvalues within 1e-8 of the port's one-device
  solve and of JAX's sharded solve (normalized, randomwalk, combinatorial,
  modularity); the eigenbasis fits within JAX's bands of the JAX
  package's one-device fit (Poisson and PoissonMBO spectral: agreement
  0.95 and accuracy over 80 %; Multiclass and Modularity MBO: agreement
  over 0.9; spectral clustering: accuracy within 2 points and over 85 %);
  ``spectral_covariance`` of a distributed model within 1e-8 of the
  one-device covariance;
* INCRES's rounds fed one set of node-order draws: labels equal to the
  one-device rounds, and on the "gspmd" route fed JAX's draws (its row
  space there is the node order), equal to JAX's sharded labels;
* VolumeMBO at temperature 0.1 (the Gumbel noise drawn on every rank):
  the fit's predictions and rounds equal to the port's one-device fit of
  the same seed, and on the "gspmd" route its loop fed JAX's draws equal
  to JAX's sharded labels;
* JAX's two runner tests: ``ssl_trials`` and ``active_learner`` on a
  distributed model equal to the one-device runs;
* ``clustering.distribute`` warning on a family without a sharded path,
  and the refusal left: a checkpointed PoissonMBO or VolumeMBO fit on a
  mesh (``all_labels`` on a mesh: ``test_torch_batch_and_rounds.py``).

The ranks run ``tests/test_torch_ranks.py`` (no JAX there): four groups,
one a world size and route, spawned at once after the JAX fits.
"""

import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearning_tpu as jgl
from graphlearning_tpu.config import GLTConfig as JConfig
from graphlearning_tpu.parallel import execute as jexec

import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch.solvers import incres as tincres
from tests import test_torch_ranks as ranks
from tests.test_torch_mbo import _mbo_inputs
from tests.test_torch_parallel import _rcm_knn
from tests.test_torch_sharded_models import _clusters

ROUTES = ("gspmd", "banded")
# JAX's fits on its own route: the distance and Lipschitz families, whose
# banded path differs; the others against JAX's "gspmd" fit
JAX_FITS = {
    "graph_nn": (ROUTES, lambda W, p: jgl.ssl.graph_nearest_neighbor(W)),
    "plaplace": (ROUTES, lambda W, p: jgl.ssl.plaplace(W, p=10)),
    "amle": (ROUTES, lambda W, p: jgl.ssl.amle(W, tol=1e-8)),
    "amle_weighted": (ROUTES, lambda W, p: jgl.ssl.amle(W, weighted=True)),
    "peikonal": (ROUTES, lambda W, p: jgl.ssl.peikonal(W)),
    "volume_mbo": (("gspmd",), lambda W, p: jgl.ssl.volume_mbo(
        W, class_priors=p, temperature=0)),
    "sparse_lp": (("gspmd",), lambda W, p: jgl.ssl.sparse_label_propagation(
        W, T=30)),
}
# of max|u|: two Jacobi or Bellman-Ford runs of one map summed in another
# order (f64), the p-Laplace and AMLE rounds to their tolerance
ATOL = {"graph_nn": 0.0, "plaplace": 1e-9, "amle": 1e-9,
        "amle_weighted": 1e-9, "peikonal": 1e-9, "volume_mbo": 0.0,
        "sparse_lp": 1e-12, "centered_kernel": 1e-9}
EIG_TOL = 1e-8
INCRES_T = 8
# The combinatorial Laplacian's solve runs LOBPCG's 200 steps here (its
# top gaps are the smallest) at gloo's 1-3 ms an all-reduce: one group
# holds it; the normalized and modularity solves run in all four.
COMBINATORIAL = (2, "gspmd")
N_HALO = 997
# VolumeMBO's noisy loop fed JAX's draws: its temperature, key and rounds
VOLUME_T, VOLUME_KEY, VOLUME_ITERS = 0.1, 7, 100


def _jax_cfg(route):
    return JConfig(mesh_shape=(4,), devices=jax.devices()[:4],
                   sharded_kernel=route)


@pytest.fixture(scope="module")
def clusters():
    """n = 603, not a multiple of 2 or 4 (mesh padding)."""
    W, labels, ti = _clusters(603, 3, 5, 10, seed=0)
    return W, labels, ti, np.bincount(labels) / len(labels)


@pytest.fixture(scope="module")
def halo_inputs():
    """An RCM kNN graph with an edge beyond any halo, its halo cut to a
    tenth of a block (more residual edges), and the inputs."""
    rs = np.random.RandomState(5)
    W = _rcm_knn(N_HALO, seed=5).tolil()
    W[0, N_HALO - 1] = W[N_HALO - 1, 0] = 0.7
    return {"W": W.tocsr(), "d": rs.rand(N_HALO) * 3.0,
            "f": rs.rand(N_HALO) + 0.5, "x": rs.randn(N_HALO),
            "cp": rs.randint(0, N_HALO, N_HALO).astype(np.int32),
            "U2": rs.randn(N_HALO, 2), "U40": rs.randn(N_HALO, 40),
            "R": 64, "WT": 64, "max_halo_frac": 0.1}


def _jax_incres_draws(seed, n_pad, k=3, T=INCRES_T):
    """JAX's sharded INCRES scores, ``(k, n_pad)`` a round (the key split
    once a round)."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(T):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.uniform(sub, (k, n_pad))))
    return out


def _jax_volume_draws(n_pad, k=3):
    """JAX's sharded VolumeMBO noise, ``(n_pad, k)`` a round (the key split
    once a round)."""
    key, out = jax.random.PRNGKey(VOLUME_KEY), []
    for _ in range(VOLUME_ITERS):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.gumbel(sub, (n_pad, k),
                                                dtype=jnp.float64)))
    return out


def _jax_refs(W, labels, ti, priors, volume_loop):
    """The JAX package's fits: sharded on its 4-device mesh, and the
    eigenbasis fits on one device."""
    n = W.shape[0]
    refs = {}
    for name, (routes, make) in JAX_FITS.items():
        for route in routes:
            m = make(W, priors).distribute(_jax_cfg(route))
            refs[route, name] = (np.asarray(m.fit(ti, labels[ti])),
                                 m.predict())
    m = jgl.ssl.centered_kernel(W).distribute(_jax_cfg("gspmd"))
    refs["centered_kernel"] = np.asarray(m.fit(ti, labels[ti]))
    for route in ROUTES:
        dist = jexec.Distributor(_jax_cfg(route))
        for hopf, recip in ((False, False), (True, False), (False, True)):
            refs[route, "dijkstra", hopf, recip] = jexec.dijkstra_fit_sharded(
                dist, W, ti[:5], 0.0, 1.0, return_cp=True, hopf_lax=hopf,
                reciprocal_weights=recip)
    dist = jexec.Distributor(_jax_cfg("gspmd"))
    u0 = np.random.RandomState(0).randint(0, 3, size=n)
    refs["incres"] = jexec.incres_fit_sharded(dist, W, u0, 0, k=3,
                                              T=INCRES_T, Dm=1)
    v = {k: a for k, a in volume_loop.items() if k != "draws"}
    refs["volume_jax_draws"] = np.asarray(jexec.volume_mbo_fit_sharded(
        dist, key=jax.random.PRNGKey(VOLUME_KEY), **v))
    for norm in ("normalized", "randomwalk", "combinatorial"):
        refs["eig", norm] = np.asarray(jexec.eigen_decomp_sharded(
            dist, W, normalization=norm, k=3)[0])
    refs["eig", "modularity"] = np.asarray(jexec.eigen_decomp_mod_sharded(
        dist, W, k=15, gamma=0.5)[0])
    for name, make in (
            ("poisson_spectral", lambda: jgl.ssl.poisson(
                W, solver="spectral", spectral_cutoff=2)),
            ("poisson_mbo_spectral", lambda: jgl.ssl.poisson_mbo(
                W, class_priors=priors, solver="spectral",
                spectral_cutoff=2, T=2)),
            ("multiclass_mbo", lambda: jgl.ssl.multiclass_mbo(
                W, num_eig=3, seed=0)),
            ("modularity_mbo", lambda: jgl.ssl.modularity_mbo(W))):
        refs[name] = make().fit_predict(ti, labels[ti])
    for method in ("NgJordanWeiss", "combinatorial"):
        refs["spectral", method] = jgl.clustering.clustering_accuracy(
            jgl.clustering.spectral(W, num_clusters=3,
                                    method=method).fit_predict(), labels)
    return refs


@pytest.fixture(scope="module")
def both(clusters, halo_inputs, tmp_path_factory):
    """The ranks' results and the JAX package's.  The JAX fits run first:
    run beside the twelve ranks, XLA's threads and theirs share the cores,
    and both take longer than the two one after the other."""
    W, labels, ti, priors = clusters
    n = W.shape[0]
    e0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (604, 1),
                                      dtype=jnp.float64))[:n, 0]
    draws = [np.random.RandomState(100 + i).rand(3, n)
             for i in range(INCRES_T)]
    Wn, _, labels0, fixed, fixed_labels, lower, upper = _mbo_inputs(
        W, labels, ti, priors)
    volume_loop = {"W": Wn, "labels0": labels0, "fixed_mask": fixed,
                   "fixed_labels": fixed_labels, "lower": lower,
                   "upper": upper, "temp": VOLUME_T, "k": 3,
                   "max_iters": VOLUME_ITERS,
                   "draws": _jax_volume_draws(604)}
    refs = _jax_refs(W, labels, ti, priors, volume_loop)
    # the ranks get copies: the JAX fits leave their caches on W and Wn
    Wr = W.copy()
    rank_volume = dict(volume_loop, W=Wn.copy())

    def families(P, route):
        return (route, ranks.case_families, {
            "W": Wr, "ti": ti, "labels": labels, "priors": priors,
            "kernel": route, "e0": e0, "incres_draws": draws,
            # JAX's "gspmd" row space is the node order, padded
            "jax_draws": ([a[:, :n] for a in _jax_incres_draws(0, 604)]
                          if route == "gspmd" else None),
            "volume_loop": rank_volume if route == "gspmd" else None,
            "combinatorial": (P, route) == COMBINATORIAL})

    halo = ("halo", ranks.case_halo, halo_inputs)
    tmp = tmp_path_factory.mktemp("families")
    runners = ("runners", ranks.case_runners, {
        "W": Wr, "ti": ti, "labels": labels,
        "trainsets": [ti, np.roll(ti, 1)], "results_dir": str(tmp)})
    # four groups spawned at once (twelve ranks), one a world size and
    # route
    running = ranks.Ranks({
        (2, "gspmd"): [families(2, "gspmd"), runners],
        (2, "banded"): [families(2, "banded"), halo],
        (4, "gspmd"): [families(4, "gspmd")],
        (4, "banded"): [families(4, "banded"), halo]}, tmp)
    return running.results(), refs, e0, draws


@pytest.fixture(scope="module")
def ranked(both):
    return both[0]


@pytest.fixture(scope="module")
def jax_refs(both):
    return both[1]


def _each_rank(ranked, P, route, case=None):
    """Each rank's result of ``case`` (the route's fits by default) at
    ``P`` in the group that ran it."""
    for rank_results in ranked[P, route]:
        yield rank_results[case or route]


# -- the halo methods alone ---------------------------------------------------


def _ell_rows(W):
    """Each row's columns and weights of W, in CSR order."""
    W = W.tocsr()
    return [(W.indices[W.indptr[i]:W.indptr[i + 1]],
             W.data[W.indptr[i]:W.indptr[i + 1]]) for i in range(W.shape[0])]


@pytest.mark.parametrize("P", [2, 4])
def test_halo_neighbor_take(ranked, halo_inputs, P):
    from graphlearning_tpu_torch.core.sparse import SparseGraph

    W = halo_inputs["W"]
    cols, _, deg = SparseGraph.ell_from_scipy(W)
    valid = np.arange(cols.shape[1])[None, :] < deg[:, None]
    n = W.shape[0]
    for out in _each_rank(ranked, P, "banded", "halo"):
        assert out["residual"] > 0 and out["geometry"][3]
        for key, x in (("take", halo_inputs["x"]),
                       ("take_int", halo_inputs["cp"])):
            got = out[key][:n]
            np.testing.assert_array_equal(got[valid], x[cols][valid])


def _minplus_ref(W, d, f, hopf, recip):
    best = np.full(W.shape[0], 1e30)
    arg = np.full(W.shape[0], -1)
    for i, (c, w) in enumerate(_ell_rows(W)):
        w = 1.0 / w if recip else w
        if hopf:
            fw = w * f[c]
            cand = 0.5 * (fw + np.sqrt(fw * fw + 4.0 * d[c] * d[c]))
        else:
            cand = d[c] + w * f[c]
        j = int(np.argmin(cand))
        best[i], arg[i] = cand[j], c[j]
    return best, arg


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("hopf,recip", [(False, False), (False, True),
                                        (True, False)])
def test_halo_minplus(ranked, halo_inputs, P, hopf, recip):
    W, d, f = halo_inputs["W"], halo_inputs["d"], halo_inputs["f"]
    best, arg = _minplus_ref(W, d, f, hopf, recip)
    n = W.shape[0]
    for out in _each_rank(ranked, P, "banded", "halo"):
        m, a = out["minplus", hopf, recip]
        np.testing.assert_allclose(m[:n], best, rtol=1e-14, atol=0)
        np.testing.assert_array_equal(a[:n], arg)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("C", [2, 40])
def test_halo_lip_reduce(ranked, halo_inputs, P, C):
    W, U = halo_inputs["W"], halo_inputs[f"U{C}"]
    n = W.shape[0]
    rows = _ell_rows(W)
    sums = W @ U
    mins = np.stack([U[c].min(0) for c, _ in rows])
    maxs = np.stack([U[c].max(0) for c, _ in rows])
    for out in _each_rank(ranked, P, "banded", "halo"):
        s, mn, mx = out[f"lip{C}"]
        np.testing.assert_allclose(s[:n], sums, rtol=0,
                                   atol=1e-12 * np.abs(sums).max())
        np.testing.assert_array_equal(mn[:n], mins)
        np.testing.assert_array_equal(mx[:n], maxs)


# -- the families against the JAX package -------------------------------------


FAMILY_ROUTES = [(name, route) for name, (routes, _) in JAX_FITS.items()
                 for route in ROUTES]


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("name,route", FAMILY_ROUTES)
def test_family_matches_jax(ranked, jax_refs, clusters, P, name, route):
    W, labels, ti, _ = clusters
    ref_route = route if route in JAX_FITS[name][0] else "gspmd"
    ju, jpred = jax_refs[ref_route, name]
    for out in _each_rank(ranked, P, route):
        u, pred, iters, got = out[name]
        assert got == (None if name == "sparse_lp" else route)
        if name == "volume_mbo" and route == "banded":
            assert np.mean(pred == jpred) >= 0.98
            continue
        np.testing.assert_allclose(u, ju, rtol=0,
                                   atol=ATOL[name] * np.abs(ju).max())
        np.testing.assert_array_equal(pred, jpred)


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("route", ROUTES)
def test_dijkstra_and_centered_kernel_match_jax(ranked, jax_refs, P, route):
    for out in _each_rank(ranked, P, route):
        for hopf, recip in ((False, False), (True, False), (False, True)):
            d, cp, rounds = out["dijkstra", hopf, recip]
            jd, jcp = jax_refs[route, "dijkstra", hopf, recip]
            np.testing.assert_allclose(d, jd, rtol=1e-12, atol=0)
            np.testing.assert_array_equal(cp, jcp)
            assert rounds > 0
        ju = jax_refs["centered_kernel"]
        u, iters = out["centered_e0"]
        np.testing.assert_allclose(u, ju, rtol=0,
                                   atol=ATOL["centered_kernel"]
                                   * np.abs(ju).max())


@pytest.fixture(scope="module")
def one_device(clusters):
    """The port's one-device eigenpairs, covariance and centered kernel."""
    W, labels, ti, _ = clusters
    G = tgl.graph(W, device="cpu")
    out = {norm: G.eigen_decomp(normalization=norm, k=3)[0]
           for norm in ("normalized", "randomwalk", "combinatorial")}
    out["modularity"] = G.eigen_decomp(normalization="combinatorial", k=15,
                                       gamma=0.5)[0]
    out["covariance"] = tgl.active_learning.spectral_covariance(
        tgl.ssl.laplace(W, device="cpu"), k=3)
    out["centered_kernel"] = tgl.ssl.centered_kernel(W, device="cpu").fit(
        ti, labels[ti])
    return out


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("route", ROUTES)
def test_eigensolvers_match(ranked, jax_refs, one_device, P, route):
    for out in _each_rank(ranked, P, route):
        norms = ("normalized", "randomwalk", "modularity") + (
            ("combinatorial",) if (P, route) == COMBINATORIAL else ())
        for norm in norms:
            vals, vecs = out["eig", norm]
            np.testing.assert_allclose(vals, one_device[norm], rtol=0,
                                       atol=EIG_TOL)
            np.testing.assert_allclose(vals, jax_refs["eig", norm], rtol=0,
                                       atol=EIG_TOL)
        C0, V = out["covariance"]
        np.testing.assert_allclose(C0, one_device["covariance"][0], rtol=0,
                                   atol=EIG_TOL)
        assert V.shape == one_device["covariance"][1].shape


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("route", ROUTES)
def test_eigenbasis_fits_within_jax_bands(ranked, jax_refs, clusters, P,
                                          route):
    W, labels, ti, _ = clusters
    for out in _each_rank(ranked, P, route):
        for name in ("poisson_spectral", "poisson_mbo_spectral"):
            pred = out[name][1]
            assert out[name][3] == route
            assert np.mean(pred == jax_refs[name]) >= 0.95
            assert tgl.ssl.ssl_accuracy(pred, labels, ti) > 80.0
        for name in ("multiclass_mbo", "modularity_mbo"):
            assert np.mean(out[name][1] == jax_refs[name]) > 0.9
        methods = ("NgJordanWeiss",) + (
            ("combinatorial",) if (P, route) == COMBINATORIAL else ())
        for method in methods:
            acc = tgl.clustering.clustering_accuracy(out["spectral", method],
                                                     labels)
            assert acc > 85.0
            assert abs(acc - jax_refs["spectral", method]) < 2.0


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("route", ROUTES)
def test_centered_kernel_fit_equals_one_device(ranked, one_device, P,
                                               route):
    ref = one_device["centered_kernel"]
    for out in _each_rank(ranked, P, route):
        np.testing.assert_allclose(out["centered_kernel"][0], ref, rtol=0,
                                   atol=ATOL["centered_kernel"]
                                   * np.abs(ref).max())


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("route", ROUTES)
def test_incres_rounds(ranked, jax_refs, both, clusters, P, route):
    """Fed the same node-order draws, the sharded rounds give the
    one-device labels on either route; fed JAX's draws, JAX's sharded
    labels."""
    W, labels, ti, _ = clusters
    draws = both[3]
    n = W.shape[0]
    it = iter(draws)
    deg = torch.as_tensor(np.asarray(W.sum(1)).ravel())
    g = tgl.graph(W, device="cpu").sparse
    u0 = np.random.RandomState(0).randint(0, 3, size=n)
    ref = tincres.rounds(lambda X: tgl.ops.spmm(g, X), 1.0 / deg,
                         torch.as_tensor(u0), lambda shape: torch.as_tensor(
                             next(it)), 3, INCRES_T, 1, n).numpy()
    for out in _each_rank(ranked, P, route):
        np.testing.assert_array_equal(out["incres"], ref)
        if route == "gspmd":
            np.testing.assert_array_equal(out["incres_jax"],
                                          np.asarray(jax_refs["incres"]))


@pytest.fixture(scope="module")
def volume_one_device(clusters):
    W, labels, ti, priors = clusters
    m = tgl.ssl.volume_mbo(W, class_priors=priors, temperature=0.1, seed=0,
                           device="cpu")
    return m.fit_predict(ti, labels[ti]), m.iters


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("route", ROUTES)
def test_noisy_volume_mbo(ranked, jax_refs, volume_one_device, P, route):
    """At temperature 0.1 every rank draws the one-device fit's noise: the
    same predictions and rounds; on the "gspmd" route the loop fed JAX's
    draws gives JAX's sharded labels."""
    pred, iters = volume_one_device
    for out in _each_rank(ranked, P, route):
        _, got, got_iters, got_route = out["volume_mbo_noisy"]
        assert got_route == route and got_iters == iters
        np.testing.assert_array_equal(got, pred)
        if route == "gspmd":
            np.testing.assert_array_equal(out["volume_jax_draws"][0],
                                          jax_refs["volume_jax_draws"])


def test_runners_on_a_distributed_model(ranked, clusters, tmp_path):
    """JAX's ``ssl_trials`` and ``active_learner`` tests on a distributed
    model, equal to the one-device runs."""
    W, labels, ti, _ = clusters
    from graphlearning_tpu_torch import ssl as tssl

    old = tssl.results_dir
    tssl.results_dir = str(tmp_path)
    try:
        trials = tgl.ssl.poisson(W, device="cpu").ssl_trials(
            [ti, np.roll(ti, 1)], labels, overwrite=True)
    finally:
        tssl.results_dir = old
    al = tgl.active_learning.active_learner(
        tgl.ssl.laplace(W, device="cpu"),
        tgl.active_learning.unc_sampling(), ti, labels[ti])
    queries = []
    for _ in range(2):
        q = al.select_queries(batch_size=1)
        al.update(q, labels[q])
        queries.append(np.asarray(q))
    for out in _each_rank(ranked, 2, "gspmd", "runners"):
        assert out["trials"].shape == (2, 2) and out["trials"][:, 1].min() > 80
        np.testing.assert_array_equal(out["trials"], trials)
        for a, b in zip(out["queries"], queries):
            np.testing.assert_array_equal(a, b)
        assert len(out["labeled"]) == len(ti) + 2
        np.testing.assert_allclose(out["u"], al.u, rtol=0,
                                   atol=1e-7 * np.abs(al.u).max())


# -- clustering.distribute and the refusals left -----------------------------


def test_clustering_distribute_warns_without_a_sharded_path(clusters):
    W, _, _, _ = clusters
    cfg = tgl.GLTConfig(devices="cpu")
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        m = tgl.clustering.fokker_planck(W, 3, device="cpu").distribute(cfg)
    assert any("no sharded execution path" in str(w.message) for w in rec)
    assert m._dist is not None and m.distribute(None)._dist is None
    with pytest.raises(NotImplementedError):
        tgl.clustering.fokker_planck(W, 3, device="cpu").distribute(
            cfg, strict=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        s = tgl.clustering.spectral(W, 3, device="cpu").distribute(cfg)
    assert s._dist.P == 1


def test_refusals_left_name_p15c(clusters):
    """The refusals left on a mesh, none of them naming P15c, the slice
    that ported the rest: a checkpointed PoissonMBO or VolumeMBO fit is
    refused with its reason (the JAX package's sharded fit drops the
    checkpoint without a word; the port will not), where the same fits
    with ``all_labels`` now run (their rounds against the one-device
    fits' in ``test_torch_batch_and_rounds.py``), and a batch axis larger
    than the world raises ``ValueError``, as JAX's ``make_mesh``
    asserts."""
    W, labels, ti, priors = clusters
    cfg = tgl.GLTConfig(devices="cpu")
    for make in (lambda: tgl.ssl.poisson_mbo(W, class_priors=priors, T=2,
                                             device="cpu"),
                 lambda: tgl.ssl.volume_mbo(W, class_priors=priors,
                                            temperature=0, device="cpu")):
        with pytest.raises(NotImplementedError,
                           match="checkpoint is refused") as err:
            make().distribute(cfg).fit(ti, labels[ti],
                                       checkpoint_path=os.devnull)
        assert "P15c" not in str(err.value)
    m = tgl.ssl.poisson_mbo(W, class_priors=priors, T=2,
                            device="cpu").distribute(cfg)
    assert m.fit_predict(ti, labels[ti], all_labels=labels).shape == (
        W.shape[0],)
    c = tgl.clustering.incres(W, 3, T=2, seed=0, device="cpu").distribute(
        cfg)
    assert c.fit_predict(all_labels=labels).shape == (W.shape[0],)
    with pytest.raises(ValueError, match="process group has 1"):
        tgl.GLTConfig(mesh_shape=(1, 2), mesh_axes=("nodes", "batch"),
                      devices="cpu").make_mesh()
