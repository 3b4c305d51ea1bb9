"""The host oracles of graphlearning_tpu_torch.native against
graphlearning_tpu.native on the CPU: every oracle bit-equal on a 300-node
moons graph (the same source, built with the same flags),
``hostpath.laplace_host`` within 1e-12; then the oracles against the
port's device solvers on the CPU, as ``tests/test_hostpath.py`` holds the
JAX package's host path to its device path."""

import inspect

import numpy as np
import pytest
import torch
import sklearn.datasets as datasets

import graphlearning_tpu as jgl
from graphlearning_tpu import native as jnat
from graphlearning_tpu.native import hostpath as jhp
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch import native as tnat
from graphlearning_tpu_torch.native import hostpath as thp

torch.set_num_threads(2)

ORACLES = ("dijkstra_host", "peikonal_host", "peikonal_fmm_host",
           "lip_iterate_host", "lip_iterate_host_mc", "auction_host")


@pytest.fixture(scope="module")
def moons300():
    X, y = datasets.make_moons(n_samples=300, noise=0.1, random_state=0)
    return jgl.weightmatrix.knn(X, 10), y


@pytest.fixture(scope="module")
def moons():
    """The input of ``tests/test_hostpath.py``: 400 moons, 5 labels a
    class."""
    X, labels = datasets.make_moons(n_samples=400, noise=0.1, random_state=0)
    W = jgl.weightmatrix.knn(X, 10)
    rs = np.random.RandomState(1)
    train_ind = np.concatenate(
        [rs.choice(np.where(labels == c)[0], 5, replace=False)
         for c in (0, 1)])
    return W, labels, train_ind


BDY = np.array([0, 7, 123])
GV = np.array([0.0, 1.0, 0.5])


@pytest.mark.parametrize("name,kw", [
    ("dijkstra_host", dict(bdy_val=np.array([0.0, 0.1, 0.05]))),
    ("dijkstra_host", dict(f=2.0, max_dist=0.4)),
    ("dijkstra_host", dict(hopf_lax=True)),
    ("peikonal_host", dict(tol=1e-10)),
    ("peikonal_host", dict(bdy_val=GV, p=2.0, tol=1e-8)),
    ("peikonal_fmm_host", dict(p=1.0)),
    ("peikonal_fmm_host", dict(bdy_val=GV, p=2.0)),
    ("lip_iterate_host", dict(bdy_val=GV, alpha=0.2, beta=0.8, tol=1e-9)),
    ("lip_iterate_host", dict(bdy_val=GV, weighted=True, tol=1e-4)),
    ("lip_iterate_host_mc", dict(bdy_vals=np.eye(3), alpha=0.1, beta=0.9)),
])
def test_oracles_bit_equal_to_jax(moons300, name, kw):
    W, _ = moons300
    want = getattr(jnat, name)(W, BDY, **kw)
    got = getattr(tnat, name)(W, BDY, **kw)
    for g, w in zip(*(((got, want) if isinstance(got, tuple)
                       else ((got,), (want,))))):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fixed", [False, True])
def test_auction_bit_equal_to_jax(fixed):
    a = np.random.RandomState(4).rand(300, 3)
    target = np.array([100, 120, 80])
    kw = {}
    if fixed:
        kw["fixed"] = np.where(np.arange(300) < 5, 2, -1)
    got = tnat.auction_host(a, target, eps_min=1e-9, **kw)
    np.testing.assert_array_equal(
        got, jnat.auction_host(a, target, eps_min=1e-9, **kw))
    assert (np.bincount(got, minlength=3) == target).all()
    with pytest.raises(ValueError):
        tnat.auction_host(a, np.array([100, 100, 99]))


def test_oracles_bind_as_jax():
    for name in ORACLES:
        assert (inspect.signature(getattr(tnat, name))
                == inspect.signature(getattr(jnat, name))), name
    assert (inspect.signature(thp.laplace_host)
            == inspect.signature(jhp.laplace_host))


@pytest.mark.parametrize("kw", [
    dict(), dict(normalization="normalized", tau=0.1),
    dict(normalization="randomwalk"), dict(order=2),
    dict(tau=np.linspace(0.0, 0.2, 300)),
])
def test_laplace_host_matches_jax(moons300, kw):
    W, y = moons300
    kw = dict(kw)
    tau = kw.pop("tau", 0.0)
    mask = np.zeros(300, bool)
    mask[BDY] = True
    bdy = np.zeros((300, 2))
    bdy[BDY] = np.eye(2)[y[BDY]]
    want = jhp.laplace_host(W, mask, bdy, tau, **kw)
    got = thp.laplace_host(W, mask, bdy, tau, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_build_is_cached_and_rebuilds_a_stale_library():
    tnat._load()
    assert tnat.LIBRARY.is_file() and not tnat.build()
    src = tnat._SRC.stat().st_mtime
    lib = tnat.LIBRARY.stat().st_mtime
    import os

    os.utime(tnat.LIBRARY, (lib, src - 10))
    assert tnat.build() and not tnat._stale()


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    bad = tmp_path / "oracles.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnat, "_SRC", bad)
    monkeypatch.setattr(tnat, "LIBRARY", tmp_path / "liboracles.so")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed.*error"):
        tnat.build()
    assert not (tmp_path / "liboracles.so").exists()


# -- the oracles against the port's device path on the CPU (the cases of
# tests/test_hostpath.py) ----------------------------------------------------

def test_laplace_host_matches_the_port_fit(moons):
    W, labels, ti = moons
    n = W.shape[0]
    mask = np.zeros(n, bool)
    mask[ti] = True
    bdy = np.zeros((n, 2))
    bdy[ti] = np.eye(2)[labels[ti]]
    for kw, tol in (({}, dict(rtol=1e-5, atol=1e-7)),
                    ({"normalization": "normalized"}, dict(rtol=1e-4,
                                                           atol=1e-6)),
                    ({"tau": 0.1}, dict(rtol=1e-4, atol=1e-6)),
                    ({"order": 2}, dict(rtol=1e-4, atol=1e-6))):
        u_dev = tgl.ssl.laplace(W, tol=1e-10, device="cpu", **kw).fit(
            ti, labels[ti])
        kw = dict(kw)
        tau = kw.pop("tau", 0.0)
        u_host = thp.laplace_host(W, mask, bdy, tau, **kw)
        np.testing.assert_allclose(u_host, u_dev, **tol)


def test_distance_oracles_match_the_port_graph(moons):
    W, labels, ti = moons
    G = tgl.graph(W, device="cpu")
    np.testing.assert_allclose(tnat.dijkstra_host(W, [0, 7])[0],
                               G.dijkstra([0, 7]), rtol=1e-8)
    np.testing.assert_allclose(tnat.dijkstra_host(W, [0], hopf_lax=True)[0],
                               G.dijkstra_hl([0]), rtol=1e-8)
    np.testing.assert_allclose(tnat.peikonal_host(W, [0], tol=1e-8),
                               G.peikonal([0], tol=1e-8), rtol=1e-3,
                               atol=1e-5)
    g = labels[ti].astype(float)
    alpha = 1.0 / 7.0
    np.testing.assert_allclose(
        tnat.lip_iterate_host(W, ti, g, alpha=alpha, beta=1.0 - alpha,
                              tol=1e-6),
        G.plaplace(ti, g, p=8), rtol=1e-2, atol=1e-3)
    np.testing.assert_allclose(
        tnat.lip_iterate_host(W, ti, g, alpha=0.0, beta=1.0, weighted=True,
                              tol=1e-7),
        G.amle(ti, g), rtol=1e-2, atol=1e-3)


def test_ssl_model_predictions_match_the_oracles(moons):
    W, labels, ti = moons
    onehot = np.eye(2)[labels[ti]]
    alpha = 1.0 / 9.0
    host = {
        "plaplace": tnat.lip_iterate_host_mc(W, ti, onehot, alpha=alpha,
                                             beta=1.0 - alpha, tol=1e-6),
        "amle": tnat.lip_iterate_host_mc(W, ti, onehot, alpha=0.0, beta=1.0,
                                         weighted=True, tol=1e-5),
    }
    host = {k: np.argmax(v, axis=1) for k, v in host.items()}
    host["peikonal"] = np.argmin(np.stack(
        [tnat.peikonal_host(W, ti[labels[ti] == c], tol=1e-3)
         for c in (0, 1)], axis=1), axis=1)
    for name, m in (("plaplace", tgl.ssl.plaplace(W, p=10, device="cpu")),
                    ("amle", tgl.ssl.amle(W, device="cpu")),
                    ("peikonal", tgl.ssl.peikonal(W, device="cpu"))):
        pred = m.fit_predict(ti, labels[ti])
        agree = np.mean(pred == host[name])
        assert agree > 0.97, (name, agree)


def test_ctypes_signatures_match_the_source():
    """Each oracle's ctypes argtypes follow its parameters in
    ``oracles.cpp``."""
    import ctypes
    import re

    src = tnat._SRC.read_text()
    kinds = {"int64_t*": ctypes.POINTER(ctypes.c_int64),
             "int32_t*": ctypes.POINTER(ctypes.c_int32),
             "double*": ctypes.POINTER(ctypes.c_double),
             "int32_t": ctypes.c_int32, "double": ctypes.c_double}
    for name, argtypes in tnat.SIGNATURES.items():
        params = re.search(rf"void {name}\((.*?)\)", src, re.S).group(1)
        # "const int64_t* row_ptr" -> "int64_t*"
        types = [re.sub(r"\bconst\b|\s", "", p.rsplit(None, 1)[0])
                 for p in params.split(",")]
        assert [kinds[t] for t in types] == argtypes, name
