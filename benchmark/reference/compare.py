"""The numbers an answer is judged by.

* ``label_gap``: the widest gap, over the nodes, by which the reference's
  score of the label the program chose lies below the reference's best
  score there, as a share of the range of the reference's scores (the
  range the program's ``predict`` scales by).  A tie broken the other way
  reads about 0; a wrong label reads its whole margin.
* ``score_err``: the largest difference between the program's scores and
  the reference's, as a share of the same range.

Where the reference gives several candidate iterates (the steps around
its stop, :func:`reference.cg.cg`), an answer reads the nearest."""

import numpy as np
import torch


def _range(u):
    return float(torch.max(u) - torch.min(u)) or 1.0


def label_gap(candidates, cols):
    """``candidates`` list of (n, C) tensors; ``cols`` (n,) the chosen
    column of each node."""
    c = torch.as_tensor(np.asarray(cols), device=candidates[0].device)
    out = []
    for u in candidates:
        u = u.to(torch.float64)
        best = torch.max(u, dim=1).values
        chosen = torch.gather(u, 1, c[:, None].long())[:, 0]
        out.append(float(torch.max(best - chosen)) / _range(u))
    return min(out)


def score_err(candidates, scores):
    s = torch.as_tensor(np.asarray(scores), device=candidates[0].device,
                        dtype=torch.float64)
    return min(float(torch.max(torch.abs(u.to(torch.float64) - s)))
               / _range(u.to(torch.float64)) for u in candidates)


def columns(labels, classes):
    """Class values -> their column among the sorted ``classes``."""
    return np.searchsorted(np.asarray(classes), np.asarray(labels))
