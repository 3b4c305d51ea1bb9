"""The port's fit packs (``graphlearning_tpu_torch/aot.py``) on the JAX
package's pack test graph (``tests/test_aot.py``'s ``_cluster_graph``:
n = 700, three clusters, four labels a class):

* the Poisson and Laplace packs (tol 1e-8) against the JAX package's pack
  programs run through plain ``jax.jit`` (as ``tests/test_aot.py`` runs
  its Laplace program: no XLA:CPU deserializer), each given its inputs as
  the JAX package's load builds them: ``u`` within 1e-4 of max|u| of
  JAX's program (fed float32 sources and labels), the predictions
  agreeing on at least 0.99 of the nodes;
* the packs against the port's own model paths (``ssl.poisson``,
  ``ssl.laplace``): agreement at least 0.99; with ``warm`` and without,
  the same predictions;
* the spectral pack: a clustering accuracy above 95 % against the JAX
  package's spectral pack program (plain ``jax.jit``) and against
  ``clustering.spectral``'s labels, and above 80 % against the truth
  (JAX's pack test);
* another geometry and another kind of pack refused with the JAX
  package's words; a pack holds plain metadata and CPU tensors only, so it
  loads on another device (here: its tensors loaded to the ``meta``
  device; on the card, ``tests/test_torch_cuda_kernels.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearning_tpu as jgl
from tests.test_aot import _cluster_graph

import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch import aot

NCLS = 3
TOL = 1e-8
U_TOL = 1e-4


@pytest.fixture(scope="module")
def graph():
    W, labels, ti, _ = _cluster_graph()
    return W, labels, ti


@pytest.fixture(scope="module")
def packs(graph, tmp_path_factory):
    W, _, _ = graph
    d = tmp_path_factory.mktemp("packs")
    return {"poisson": aot.save_poisson_pack(W, NCLS, str(d / "p.pack"),
                                             tol=TOL),
            "laplace": aot.save_laplace_pack(W, NCLS, str(d / "l.pack"),
                                             tol=TOL),
            "spectral": aot.save_spectral_pack(W, NCLS, str(d / "s.pack"),
                                               device="cpu")}


def _onehot(labels, ti):
    classes = np.unique(labels[ti])
    return classes, (labels[ti][:, None] == classes[None, :])


def _jax_poisson(W, labels, ti):
    acc = jgl.ops.gather.GatherAccel(jgl.aot._nodiag(W), prec="f32")
    classes, onehot = _onehot(labels, ti)
    onehot = onehot.astype(np.float32)
    b = np.zeros((acc.n, NCLS), np.float32)
    b[ti] = onehot - onehot.mean(0)
    return np.asarray(jgl.aot._poisson_fit_g(
        acc.cols, acc.vals, acc._order_dev, acc._inv_dev, jnp.asarray(b),
        jnp.float32(TOL), segs=acc._segs, prec=acc.prec))


def _jax_laplace(W, labels, ti):
    acc, args = jgl.aot._laplace_pack_args(W, NCLS, 0.0, "combinatorial")
    classes, onehot = _onehot(labels, ti)
    mask = np.zeros(acc.n, np.int32)
    mask[ti] = 1
    bdy = np.zeros((acc.n, NCLS), np.float32)
    bdy[ti] = onehot
    return np.asarray(jgl.aot._laplace_fit_aot(
        *args[:7], jnp.asarray(mask), jnp.asarray(bdy), jnp.float32(TOL),
        segs=acc._segs, prec=acc.prec, normalization="combinatorial",
        order=1))


def _port_u(kind, W, labels, ti):
    """The port's pack solve ``u``, inputs as its ``fit_predict`` builds
    them."""
    classes, onehot = _onehot(labels, ti)
    n = W.shape[0]
    if kind == "poisson":
        Wn = aot._nodiag(W)
        acc = tgl.ops.gather.GatherAccel(Wn, device="cpu")
        s = 1.0 / torch.sqrt(tgl.ops.degree_vector(aot._graph(Wn, "cpu")))
        b = np.zeros((n, NCLS))
        b[ti] = onehot - onehot.mean(0)
        return tgl.ssl._poisson_accel(acc, s, torch.as_tensor(b),
                                      TOL)[0].numpy()
    acc = tgl.ops.gather.GatherAccel(W, device="cpu")
    mask = np.zeros(n, bool)
    mask[ti] = True
    bdy = np.zeros((n, NCLS))
    bdy[ti] = onehot
    return tgl.ssl._laplace_accel(
        acc, aot._graph(W, "cpu"), torch.zeros(n, dtype=torch.float64),
        torch.as_tensor(mask), torch.as_tensor(bdy), TOL, "combinatorial",
        1)[0].numpy()


JAX_PROGRAM = {"poisson": _jax_poisson, "laplace": _jax_laplace}
LOAD = {"poisson": aot.load_poisson_pack, "laplace": aot.load_laplace_pack}
MODEL = {"poisson": lambda W: tgl.ssl.poisson(W, tol=TOL, device="cpu"),
         "laplace": lambda W: tgl.ssl.laplace(W, tol=TOL, device="cpu")}


@pytest.mark.parametrize("kind", ["poisson", "laplace"])
def test_pack_solve_matches_jax_program(graph, kind):
    W, labels, ti = graph
    u_jax = JAX_PROGRAM[kind](W, labels, ti)
    u = _port_u(kind, W, labels, ti)
    np.testing.assert_allclose(u, u_jax, rtol=0,
                               atol=U_TOL * np.abs(u_jax).max())
    assert np.mean(np.argmax(u, 1) == np.argmax(u_jax, 1)) >= 0.99


@pytest.mark.parametrize("kind", ["poisson", "laplace"])
def test_pack_predicts_as_jax_program_and_model_path(graph, packs, kind):
    W, labels, ti = graph
    fit = LOAD[kind](W, packs[kind], device="cpu")
    assert fit.num_classes == NCLS
    pred = fit(ti, labels[ti])
    classes = np.unique(labels[ti])
    jax_pred = classes[np.argmax(JAX_PROGRAM[kind](W, labels, ti), axis=1)]
    assert np.mean(pred == jax_pred) >= 0.99
    model_pred = MODEL[kind](W).fit_predict(ti, labels[ti])
    assert np.mean(pred == model_pred) >= 0.99
    cold = LOAD[kind](W, packs[kind], warm=False, device="cpu")
    np.testing.assert_array_equal(cold(ti, labels[ti]), pred)
    with pytest.raises(ValueError, match="classes"):
        fit(ti[:8], labels[ti[:8]] % 2)


def _jax_spectral(W):
    """The JAX package's spectral pack program on the inputs its load
    builds (extra_dim 0, 10 restarts of 50 k-means steps)."""
    _, args, kw = jgl.aot._spectral_pack_args(W, NCLS, 0, 10, 50)
    return np.asarray(jgl.aot._spectral_fit_aot(*args, **kw))


def test_spectral_pack_clusters_as_jax_program(graph, packs):
    W, _, _ = graph
    lab = aot.load_spectral_pack(W, packs["spectral"], device="cpu")()
    assert tgl.clustering.clustering_accuracy(lab, _jax_spectral(W)) > 95.0


def test_spectral_pack_clusters_as_the_model_path(graph, packs):
    W, labels, _ = graph
    fit = aot.load_spectral_pack(W, packs["spectral"], device="cpu")
    assert fit.num_clusters == NCLS
    lab = fit()
    ref = tgl.clustering.spectral(W, NCLS, device="cpu").fit_predict()
    assert tgl.clustering.clustering_accuracy(lab, ref) > 95.0
    assert tgl.clustering.clustering_accuracy(lab, labels) > 80.0
    cold = aot.load_spectral_pack(W, packs["spectral"], warm=False,
                                  device="cpu")
    np.testing.assert_array_equal(cold(), lab)


@pytest.mark.parametrize("kind", ["poisson", "laplace", "spectral"])
def test_pack_refuses_another_geometry_and_kind(graph, packs, kind):
    W, _, _ = graph
    load = {**LOAD, "spectral": aot.load_spectral_pack}
    # the JAX package's mismatch: half of the same points' kNN graph
    rs = np.random.RandomState(0)
    centers = rs.randn(NCLS, 8) * 1.2
    lab = rs.randint(0, NCLS, 700)
    X = centers[lab] + rs.randn(700, 8)
    W2 = tgl.weightmatrix.knn(X[:350], 8, device="cpu")
    with pytest.raises(ValueError, match="geometry mismatch"):
        load[kind](W2, packs[kind], device="cpu")
    other = "laplace" if kind != "laplace" else "poisson"
    with pytest.raises(ValueError, match=f"not a {kind} pack: {other}"):
        load[kind](W, packs[other], device="cpu")


def test_pack_is_plain_and_device_free(graph, packs):
    """A pack unpickles under ``weights_only`` (no code runs), its tensors
    lie on the CPU and load onto another device; its geometry is the
    gather's."""
    W, _, _ = graph
    for kind, path in packs.items():
        meta = torch.load(path, map_location="cpu", weights_only=True)
        assert meta["kind"] == kind and meta["n"] == W.shape[0]
        tensors = [v for v in meta.values() if torch.is_tensor(v)]
        assert all(t.device.type == "cpu" for t in tensors)
        moved = torch.load(path, map_location="meta", weights_only=True)
        assert all(moved[k].device.type == "meta"
                   for k, v in meta.items() if torch.is_tensor(v))
        acc = tgl.ops.gather.GatherAccel(
            aot._nodiag(W) if kind == "poisson" else W, device="cpu")
        assert [tuple(s) for s in meta["segs"]] == acc.segs
    start = torch.load(packs["spectral"], weights_only=True)["start"]
    assert start.shape == (W.shape[0],
                           NCLS + tgl.solvers.eig.guard_count(W.shape[0],
                                                              NCLS))
