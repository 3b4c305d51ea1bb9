"""Laplace learning: ``L u = 0`` on the unlabeled nodes with ``u`` the
one-hot labels on the labeled ones, ``L = D - W``, by Jacobi-
preconditioned CG on the unlabeled rows (GraphLearning's ``laplace`` with
its defaults: combinatorial, ``tau = 0``, ``order = 1``, ``tol = 1e-5``).
The predicted label of a node is its largest score."""

import numpy as np
import torch

from benchmark.reference import compare
from benchmark.reference.cg import EPS32, cg

DEFAULTS = {"tol": 1e-5, "max_iter": 10**5, "eps": EPS32}


def solve(ar, train_ind, train_labels, settings):
    """``(candidates, iters)``: the score matrices (n, C) of the CG
    iterates around the stop, and the steps to the stop."""
    classes = np.unique(train_labels)
    cols = compare.columns(train_labels, classes)
    n, k = ar.n, len(classes)
    mask = np.zeros(n, dtype=bool)
    mask[train_ind] = True
    bdy = np.zeros((n, k))
    bdy[train_ind, cols] = 1.0
    interior = ar.vec(~mask)[:, None]
    g = ar.vec(bdy)
    L = lambda X: ar.deg[:, None] * X - ar.spmm(X)
    b = -L(g) * interior
    inv = interior[:, 0] / torch.where(ar.deg == 0, 1, ar.deg)
    A = lambda X: L(X * interior) * interior
    M = lambda R: inv[:, None] * R
    *xs, iters = cg(A, b, k, settings["tol"], M=M,
                    max_iter=settings["max_iter"], eps=settings["eps"])
    return [g + x * interior for x in xs], int(iters[0])


def answers(ar, items, settings):
    """The answers of ``ar``'s precision to ``items`` (train sets): each
    item with the stop's ``scores`` and ``labels`` and its CG ``iters``."""
    out = []
    for a in items:
        cand, iters = solve(ar, a["train_ind"], a["train_labels"], settings)
        out.append({**a, "scores": cand[1].to(torch.float64).cpu().numpy(),
                    "labels": torch.argmax(cand[1], dim=1).cpu().numpy(),
                    "iters": iters})
    return out


def judge(ar, answers, settings):
    out = []
    for a in answers:
        cand = solve(ar, a["train_ind"], a["train_labels"], settings)[0]
        out.append({"score_err": compare.score_err(cand, a["scores"]),
                    "label_gap": compare.label_gap(cand, a["labels"])})
    return out
