"""Reproducible train sets (counterpart of
``graphlearning_tpu/trainsets.py:19-79``).  The same numpy
``RandomState`` draws give the same indices as the JAX package for the
same seed, and the permutation files are its format (an object array
``perm`` in ``<name><trainset_name>_permutations.npz`` under
``trainset_dir``, a module attribute the caller may reassign), so a file
written by one package loads in the other."""

from __future__ import annotations

import os

import numpy as np

from graphlearning_tpu_torch import utils

trainset_dir = os.path.abspath(os.path.join(os.getcwd(), "label_permutations"))

_URL = ("https://github.com/jwcalder/GraphLearning/raw/master/"
        "LabelPermutations/")


def generate(labels, rate=1, num_trials=1, mask=None, seed=None, dataset=None,
             trainset_name='', name=None, overwrite=False):
    """Per-class sampling.  ``rate``: int = count per class, float in
    (0, 1) = fraction per class, or an array of per-class counts or
    fractions.  With ``dataset`` (or ``name``) the trials are written to
    ``trainset_dir``, unless the file exists and not ``overwrite``."""
    labels = np.asarray(labels)
    rs = np.random.RandomState(seed)
    classes = np.unique(labels)
    classes = classes[classes >= 0]
    perm_list = []
    for _ in range(num_trials):
        train_ind = []
        for i, c in enumerate(classes):
            ind = np.where(labels == c)[0]
            if mask is not None:
                ind = ind[np.asarray(mask)[ind]]
            r = rate if np.isscalar(rate) else np.asarray(rate)[i]
            if isinstance(r, (float, np.floating)) and 0 < r < 1:
                m = int(np.ceil(r * len(ind)))
            else:
                m = int(r)
            train_ind.append(rs.choice(ind, size=min(m, len(ind)),
                                       replace=False))
        perm_list.append(np.concatenate(train_ind))

    if dataset is not None or name is not None:
        os.makedirs(trainset_dir, exist_ok=True)
        fname = ((dataset or name).lower() + trainset_name.lower()
                 + "_permutations.npz")
        path = os.path.join(trainset_dir, fname)
        if not os.path.exists(path) or overwrite:
            np.savez_compressed(path, perm=np.array(perm_list, dtype=object))
    return perm_list if num_trials > 1 else perm_list[0]


def load(dataset, trainset_name='', overwrite=False):
    """The train sets of ``dataset`` from ``trainset_dir`` (the name as
    given, then lowercased), else fetched from the GraphLearning
    repository (always with ``overwrite``)."""
    fnames = [dataset + trainset_name + "_permutations.npz",
              dataset.lower() + trainset_name.lower() + "_permutations.npz"]
    for fname in fnames:
        path = os.path.join(trainset_dir, fname)
        if os.path.exists(path) and not overwrite:
            return utils.numpy_load(path, "perm")
    os.makedirs(trainset_dir, exist_ok=True)
    path = os.path.join(trainset_dir, fnames[1])
    utils.download_file(_URL + fnames[1], path)
    return utils.numpy_load(path, "perm")
