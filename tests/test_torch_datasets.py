"""The dataset store, train-set files, stored kNN data, graph pickles and
host ``graph`` methods of graphlearning_tpu_torch against graphlearning_tpu
on the CPU: each file written by one package loads in the other, and the
functions bind the JAX package's parameters in its order (``device``
last).  Every directory is a temporary one, and no test reaches the
network: ``urllib.request.urlopen`` is replaced where a fetch is tried."""

import inspect
import pickle
import sys
import types
import urllib.request

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import graphlearning_tpu as jgl
import graphlearning_tpu_torch as tgl

from conftest import random_knn_csr

torch.set_num_threads(2)

TOL = dict(rtol=1e-10, atol=1e-10)


@pytest.fixture
def dirs(tmp_path, monkeypatch):
    """Every store directory of both packages under ``tmp_path``, one
    shared directory a kind."""
    for attr, mod in (("data_dir", "datasets"), ("trainset_dir", "trainsets"),
                      ("knn_dir", "weightmatrix")):
        for pkg in (jgl, tgl):
            monkeypatch.setattr(getattr(pkg, mod), attr,
                                str(tmp_path / attr))
    monkeypatch.setattr(jgl.datasets, "_REFERENCE_DATA",
                        str(tmp_path / "absent"))
    return tmp_path


@pytest.fixture
def no_network(monkeypatch):
    """``urlopen`` fails as a machine without a network fails."""
    calls = []

    def refuse(url, *a, **k):
        calls.append(url)
        raise OSError("network unreachable")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    return calls


@pytest.mark.parametrize("writer,reader", [(tgl, jgl), (jgl, tgl)])
def test_datasets_cross_load(dirs, writer, reader):
    rs = np.random.RandomState(0)
    X, y = rs.rand(50, 3), rs.randint(0, 4, 50)
    writer.datasets.save(X, y, "Toy", metric="VAE")
    data, labels = reader.datasets.load("toy", metric="vae")
    np.testing.assert_array_equal(data, X)
    np.testing.assert_array_equal(labels, y)
    np.testing.assert_array_equal(
        reader.datasets.load("TOY", labels_only=True), y)
    # an existing file is kept unless overwrite
    writer.datasets.save(X + 1, y, "toy", metric="vae")
    np.testing.assert_array_equal(reader.datasets.load("toy", "vae")[0], X)
    writer.datasets.save(X + 1, y, "toy", metric="vae", overwrite=True)
    np.testing.assert_array_equal(reader.datasets.load("toy", "vae")[0],
                                  X + 1)


def test_two_skies_and_images_match_jax(dirs):
    for args in ((101, 0.1, 0.5, 3), (40, 0.15, 0.64, 0)):
        for a, b in zip(tgl.datasets.two_skies(*args),
                        jgl.datasets.two_skies(*args)):
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(
        tgl.datasets.two_skies(60, seed=1, noise=0.3)[0],
        jgl.datasets.two_skies(60, seed=1, noise=0.3)[0])
    img = np.random.RandomState(1).rand(8, 8, 3)
    (dirs / "data_dir").mkdir()
    np.savez(dirs / "data_dir" / "cow.npz", image=img)
    np.testing.assert_array_equal(tgl.datasets.load_image("Cow"), img)
    np.testing.assert_array_equal(jgl.datasets.load_image("Cow"), img)


@pytest.mark.parametrize("writer,reader", [(tgl, jgl), (jgl, tgl)])
def test_trainsets_files_cross_load(dirs, writer, reader):
    """The positional call ``generate(labels, rate, num_trials, mask, seed,
    dataset, trainset_name, name, overwrite)`` binds alike in both
    packages and writes the file the other's ``load`` reads."""
    labels = np.random.RandomState(2).randint(0, 3, 90)
    mask = np.arange(90) % 4 != 0
    args = (labels, 2, 3, mask, 5, "Toy", "_Rate2", None, False)
    mine = writer.trainsets.generate(*args)
    theirs = reader.trainsets.generate(labels, 2, 3, mask, 5)
    for a, b in zip(mine, theirs):
        np.testing.assert_array_equal(a, b)
    assert (dirs / "trainset_dir" / "toy_rate2_permutations.npz").exists()
    loaded = reader.trainsets.load("toy", "_rate2")
    assert loaded.shape == (3, 6)
    for a, b in zip(loaded, mine):
        np.testing.assert_array_equal(np.asarray(a, dtype=int), b)
    # name in place of dataset; an existing file is kept unless overwrite
    writer.trainsets.generate(labels, 1, 2, None, 0, None, "", "Other")
    writer.trainsets.generate(labels, 4, 2, None, 0, None, "", "Other")
    assert reader.trainsets.load("other").shape == (2, 3)
    writer.trainsets.generate(labels, 4, 2, None, 0, None, "", "Other", True)
    assert reader.trainsets.load("other").shape == (2, 12)


def test_trainsets_load_fetches_when_missing(dirs, no_network):
    """A missing file is fetched from the GraphLearning repository; with no
    network that raises a ``RuntimeError`` naming the URL."""
    with pytest.raises(RuntimeError, match="LabelPermutations/"
                       "mnist_permutations.npz"):
        tgl.trainsets.load("MNIST")
    assert no_network == ["https://github.com/jwcalder/GraphLearning/raw/"
                          "master/LabelPermutations/mnist_permutations.npz"]


@pytest.mark.parametrize("writer,reader", [(tgl, jgl), (jgl, tgl)])
def test_knn_data_cross_load(dirs, writer, reader):
    """``knnsearch(..., dataset=)`` stores ``J`` and ``D``; the other
    package's ``load_knn_data`` reads them, and its ``knn(name, k)`` is
    ``knn(X, k)`` as CSR."""
    X = np.random.RandomState(3).rand(300, 8)
    kw = {"device": "cpu"} if writer is tgl else {}
    J, D = writer.weightmatrix.knnsearch(X, 11, None, "euclidean", "Cloud",
                                         "raw", **kw)
    J2, D2 = reader.weightmatrix.load_knn_data("cloud")
    np.testing.assert_array_equal(J2, J)
    np.testing.assert_array_equal(D2, D)
    rkw = {"device": "cpu"} if reader is tgl else {}
    Wn = reader.weightmatrix.knn("Cloud", 10, **rkw)
    Wx = reader.weightmatrix.knn(X, 10, **rkw)
    np.testing.assert_array_equal(Wn.indptr, Wx.indptr)
    np.testing.assert_array_equal(Wn.indices, Wx.indices)
    np.testing.assert_allclose(Wn.data, Wx.data, **TOL)


def test_knn_of_a_missing_dataset_fetches(dirs, no_network):
    with pytest.raises(RuntimeError, match="kNNData/mnist_vae.npz"):
        tgl.weightmatrix.knn("MNIST", 10, metric="VAE", device="cpu")


def test_download_file_raises_naming_the_url(tmp_path, no_network):
    url = "https://example.invalid/data.npz"
    with pytest.raises(RuntimeError, match="example.invalid/data.npz"):
        tgl.utils.download_file(url, str(tmp_path / "data.npz"))
    assert not (tmp_path / "data.npz").exists()
    with pytest.raises(RuntimeError, match="Data/mystery_labels.npz"):
        tgl.datasets.load("mystery")


def test_csvread_and_numpy_load_match_jax(tmp_path):
    path = tmp_path / "r.csv"
    path.write_text("Number of labels,Accuracy\n10,93.50\n\n20,97.25\n")
    np.testing.assert_array_equal(tgl.utils.csvread(str(path)),
                                  jgl.utils.csvread(str(path)))
    path.write_text("header only\n")
    assert tgl.utils.csvread(str(path)).shape == (0,)
    np.savez(tmp_path / "a.npz", perm=np.array([[1, 2], [3, 4]],
                                               dtype=object))
    np.testing.assert_array_equal(
        tgl.utils.numpy_load(str(tmp_path / "a.npz"), "perm"),
        jgl.utils.numpy_load(str(tmp_path / "a.npz"), "perm"))


@pytest.mark.parametrize("writer,reader", [(tgl, jgl), (jgl, tgl)])
def test_graph_pickles_cross_load(tmp_path, writer, reader):
    W = random_knn_csr(120, 5, seed=3)
    kw = {"device": "cpu"}
    G = writer.graph(W, **(kw if writer is tgl else {}))
    G.save(str(tmp_path / "g.pkl"))
    H = reader.graph.load(str(tmp_path / "g.pkl"),
                          **(kw if reader is tgl else {}))
    assert abs(H.weight_matrix - W).max() < 1e-12
    assert H.weight_matrix.nnz == W.nnz


def test_load_graph_reads_reference_pickles(dirs):
    """A pickled GraphLearning graph object (its class stood in for by a
    shim), a dict with ``W`` and a bare matrix, in both packages."""
    W = random_knn_csr(80, 4, seed=4)
    mod = types.ModuleType("graphlearning.graph")

    class graph:                           # the reference's class name
        pass

    graph.__module__ = "graphlearning.graph"
    graph.__qualname__ = "graph"
    mod.graph = graph
    pkg = types.ModuleType("graphlearning")
    pkg.graph = mod
    sys.modules.update({"graphlearning": pkg, "graphlearning.graph": mod})
    try:
        obj = graph()
        obj.weight_matrix = W
        blobs = {"karate": pickle.dumps(obj), "dict": pickle.dumps({"W": W}),
                 "bare": pickle.dumps(W)}
    finally:
        del sys.modules["graphlearning.graph"], sys.modules["graphlearning"]
    (dirs / "data_dir").mkdir()
    for name, blob in blobs.items():
        (dirs / "data_dir" / f"{name}.pkl").write_bytes(blob)
        G = tgl.datasets.load_graph(name.upper(), device="cpu")
        J = jgl.datasets.load_graph(name)
        assert abs(G.weight_matrix - J.weight_matrix).max() == 0
        assert G.device == torch.device("cpu")


def test_host_graph_methods_match_jax():
    W = random_knn_csr(150, 4, seed=5)
    W = W.tolil()
    W[140:, :] = 0
    W[:, 140:] = 0
    W[140, 141] = W[141, 140] = 1.0                # a second component
    W = W.tocsr()
    W.eliminate_zeros()
    G, J = tgl.graph(W, device="cpu"), jgl.graph(W)
    assert abs(G.adjacency() - J.adjacency()).max() == 0
    for seed in (0, 7):
        assert abs(G.rand(seed) - J.rand(seed)).max() == 0
        assert abs(G.randn(seed) - J.randn(seed)).max() == 0
    ind = np.arange(0, 150, 3)
    S = G.subgraph(ind)
    assert isinstance(S, tgl.graph) and S.device == torch.device("cpu")
    assert abs(S.weight_matrix - J.subgraph(ind).weight_matrix).max() == 0
    assert G.isconnected() == J.isconnected() is False
    assert tgl.graph(random_knn_csr(60, 6, seed=1),
                     device="cpu").isconnected()
    for i in (0, 17, 140):
        np.testing.assert_array_equal(G.neighbors(i), J.neighbors(i))
        for a, b in zip(G.neighbors(i, return_weights=True),
                        J.neighbors(i, return_weights=True)):
            np.testing.assert_array_equal(a, b)
    (Gc, mask), (Jc, jmask) = (G.largest_connected_component(),
                               J.largest_connected_component())
    np.testing.assert_array_equal(mask, jmask)
    assert mask.sum() < 150
    assert abs(Gc.weight_matrix - Jc.weight_matrix).max() == 0
    for a, b in zip(G.mirror(), J.mirror()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert G.mirror() is G.mirror()


def test_graph_draw(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    W = random_knn_csr(30, 3, seed=6)
    G = tgl.graph(W, device="cpu")
    X = np.random.RandomState(0).rand(30, 2)
    assert G.draw(X, c=np.arange(30)) is X
    ax = plt.gca()
    assert len(ax.lines) == sp.triu(W, 1).nnz
    np.testing.assert_array_equal(ax.collections[0].get_offsets(), X)
    plt.close("all")
    Xm = G.draw(edges=False)
    Xj = jgl.graph(W).draw(edges=False)
    np.testing.assert_allclose(np.abs(Xm), np.abs(Xj), rtol=1e-8, atol=1e-8)
    plt.close("all")


# The names this slice adds, each JAX's signature with ``device`` last.
PORTED = {
    "utils": ["csvread", "numpy_load", "download_file"],
    "datasets": ["load", "save", "load_graph", "load_image", "two_skies"],
    "trainsets": ["generate", "load"],
    "weightmatrix": ["knnsearch", "load_knn_data", "knn"],
    "graph": ["mirror", "adjacency", "rand", "randn", "subgraph",
              "isconnected", "neighbors", "largest_connected_component",
              "save", "load", "draw"],
    "ssl": ["warmup", "accuracy_plot", "accuracy_table",
            "dynamic_label_propagation", "sparse_label_propagation"],
    "ssl.ssl": ["warmup", "fit_predict_batched", "fit_device",
                "get_accuracy_filename", "ssl_trials", "trials_statistics"],
}


def _lookup(pkg, path):
    obj = pkg
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


@pytest.mark.parametrize("where", sorted(PORTED))
def test_ported_names_bind_as_jax(where):
    for name in PORTED[where]:
        mine = inspect.signature(_lookup(tgl, f"{where}.{name}"))
        theirs = inspect.signature(_lookup(jgl, f"{where}.{name}"))
        params = list(mine.parameters.values())
        if params and params[-1].name == "device":
            params = params[:-1]
        assert [(p.name, p.default) for p in params] == [
            (p.name, p.default) for p in theirs.parameters.values()], name
    assert tgl.warmup is tgl.ssl.warmup
