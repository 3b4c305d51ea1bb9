"""Dataset store (counterpart of ``graphlearning_tpu/datasets.py``): npz
files of features (field ``data``) and labels (field ``labels``) and
pickled graphs, read from ``data_dir`` and fetched from the GraphLearning
repository when missing there.  The files are the JAX package's: a file
written by one package loads in the other.  ``data_dir`` is a module
attribute the caller may reassign; it is the only place looked in."""

from __future__ import annotations

import os
import pickle

import numpy as np

from graphlearning_tpu_torch import utils


class _RefShim:
    """Stands in for a GraphLearning class inside a pickle: keeps the
    pickled ``__dict__`` (its ``weight_matrix``) without that package."""

    def __setstate__(self, state):
        self.__dict__.update(state)


class _RefUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.split(".")[0] == "graphlearning":
            return _RefShim
        return super().find_class(module, name)


data_dir = os.path.abspath(os.path.join(os.getcwd(), "data"))

_GITHUB = "https://github.com/jwcalder/GraphLearning/raw/master/Data/"
_UMN = "http://www-users.math.umn.edu/~jwcalder/Data/"


def _find(fname):
    path = os.path.join(data_dir, fname)
    return path if os.path.exists(path) else None


def _fetch(url, fname):
    """``data_dir/fname``, downloaded from ``url`` first."""
    os.makedirs(data_dir, exist_ok=True)
    path = os.path.join(data_dir, fname)
    utils.download_file(url, path)
    return path


def load(dataset, metric="raw", labels_only=False):
    """``(data, labels)`` of ``dataset`` (``labels`` alone with
    ``labels_only``); ``metric`` ('raw', 'vae', 'vae_old', 'simclr', 'aet')
    names the feature file ``<dataset>_<metric>.npz``."""
    dataset = dataset.lower()
    labels = None
    for cand in (dataset + "_labels.npz", dataset.upper() + "_labels.npz",
                 dataset.capitalize() + "_labels.npz"):
        path = _find(cand)
        if path is not None:
            labels = utils.numpy_load(path, "labels")
            break
    if labels is None:
        fname = dataset + "_labels.npz"
        labels = utils.numpy_load(_fetch(_GITHUB + fname, fname), "labels")
    if labels_only:
        return labels
    fname = dataset + "_" + metric.lower() + ".npz"
    path = _find(fname) or _fetch(_UMN + fname, fname)
    return utils.numpy_load(path, "data"), labels


def save(data, labels, dataset, metric="raw", overwrite=False):
    """Write ``data`` and ``labels`` as :func:`load` reads them; an
    existing file is kept unless ``overwrite``."""
    dataset = dataset.lower()
    os.makedirs(data_dir, exist_ok=True)
    dpath = os.path.join(data_dir, dataset + "_" + metric.lower() + ".npz")
    lpath = os.path.join(data_dir, dataset + "_labels.npz")
    if overwrite or not os.path.exists(dpath):
        np.savez_compressed(dpath, data=data)
    if overwrite or not os.path.exists(lpath):
        np.savez_compressed(lpath, labels=labels)


def load_graph(name, device=None):
    """A pickled graph (karate, cora, citeseer, pubmed, ...) as a
    :class:`graph` on ``device``: a GraphLearning graph object, a dict with
    ``W``, or a matrix."""
    from graphlearning_tpu_torch.core.graphclass import graph

    fname = name.lower() + ".pkl"
    path = _find(fname) or _fetch(_GITHUB + fname, fname)
    with open(path, "rb") as fh:
        obj = _RefUnpickler(fh).load()
    if hasattr(obj, "weight_matrix"):
        return graph(obj.weight_matrix, device=device)
    if isinstance(obj, dict) and "W" in obj:
        return graph(obj["W"], device=device)
    return graph(obj, device=device)


def load_image(name):
    """A demo image (field ``image`` of ``<name>.npz``)."""
    fname = name.lower() + ".npz"
    path = _find(fname) or _fetch(_GITHUB + "Images/" + fname, fname)
    return utils.numpy_load(path, "image")


def two_skies(n, sigma=0.15, sep=0.64, seed=None, noise=None):
    """Two horizontal bands of ``n`` points in the unit square's width,
    ``sep`` apart with standard deviation ``sigma`` (``noise`` a deprecated
    alias), and their labels: the JAX package's draws for a seed."""
    if noise is not None:
        sigma = noise
    rs = np.random.RandomState(seed)
    m = n // 2
    X1 = np.vstack((rs.rand(m), sigma * rs.randn(m) - sep / 2)).T
    X2 = np.vstack((rs.rand(n - m), sigma * rs.randn(n - m) + sep / 2)).T
    X = np.vstack((X1, X2))
    labels = np.hstack((np.zeros(m, dtype=int), np.ones(n - m, dtype=int)))
    return X, labels
