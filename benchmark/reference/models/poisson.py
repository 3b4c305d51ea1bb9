"""Poisson learning by CG (GraphLearning's ``poisson`` with its defaults:
``solver="conjugate_gradient"``, ``tol = 1e-3``): with ``s = D^-1/2``
and the sources ``f`` (each labeled node's one-hot label less their mean,
0 elsewhere), solve ``(I - S W S) v = s f`` by CG, remove from each column
its component along ``D^1/2 1`` (the kernel of the normalized Laplacian),
and return ``u = s v``.  The predicted label of a node is the class of its
largest score.

Trials of one size are judged together: each is its own group of columns
in one CG, and stops on its own."""

import numpy as np
import torch

from benchmark.reference import compare
from benchmark.reference.cg import EPS32, cg

DEFAULTS = {"tol": 1e-3, "max_iter": 10**5, "eps": EPS32}


def sources(n, train_ind, train_labels, classes):
    cols = compare.columns(train_labels, classes)
    onehot = np.zeros((len(train_ind), len(classes)))
    onehot[np.arange(len(train_ind)), cols] = 1.0
    f = np.zeros((n, len(classes)))
    f[train_ind] = onehot - onehot.mean(0)
    return f


def solve(ar, sets, settings):
    """``sets``: list of ``(train_ind, train_labels, classes)``, all with
    as many classes.  Returns ``(candidates, iters)``: a list, a set
    each, of candidate score matrices (n, C), and each set's CG steps."""
    n, k = ar.n, len(sets[0][2])
    f = np.concatenate([sources(n, *s) for s in sets], axis=1)
    s = 1.0 / torch.sqrt(ar.deg)
    q = torch.sqrt(ar.deg)
    A = lambda X: X - s[:, None] * ar.spmm(s[:, None] * X)
    *xs, iters = cg(A, s[:, None] * ar.vec(f), k, settings["tol"],
                    max_iter=settings["max_iter"], eps=settings["eps"])
    out = [[] for _ in sets]
    for v in xs:
        v = v - q[:, None] * ((q @ v) / (q @ q))[None, :]
        u = s[:, None] * v
        for t in range(len(sets)):
            out[t].append(u[:, t * k:(t + 1) * k])
    return out, [int(i) for i in iters]


def _blocks(ar, items, settings, block=32):
    """``(item, candidates, classes, iters)`` of each item, ``block``
    items to a CG."""
    for b0 in range(0, len(items), block):
        chunk = items[b0:b0 + block]
        sets = [(a["train_ind"], a["train_labels"],
                 a.get("classes", np.unique(a["train_labels"])))
                for a in chunk]
        cands, iters = solve(ar, sets, settings)
        yield from zip(chunk, cands, [s[2] for s in sets], iters)


def answers(ar, items, settings):
    """The answers of ``ar``'s precision to ``items`` (train sets): each
    item with the stop's ``scores``, ``labels`` (class values) and CG
    ``iters``."""
    return [{**a, "scores": cand[1].to(torch.float64).cpu().numpy(),
             "labels": np.asarray(classes)[
                 torch.argmax(cand[1], dim=1).cpu().numpy()],
             "iters": iters}
            for a, cand, classes, iters in _blocks(ar, items, settings)]


def judge(ar, answers, settings):
    out = []
    for a, cand, classes, _ in _blocks(ar, answers, settings):
        nums = {"label_gap": compare.label_gap(
            cand, compare.columns(a["labels"], classes))}
        if a.get("scores") is not None:
            nums["score_err"] = compare.score_err(cand, a["scores"])
        out.append(nums)
    return out
