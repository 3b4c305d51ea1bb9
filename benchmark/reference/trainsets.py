"""The per-class train-set draw.

Frozen copy of ``graphlearning_tpu_torch/trainsets.py:29-47``
(``generate`` with an integer ``rate`` and no mask): for each class in
sorted order, ``rate`` distinct nodes of that class by
``RandomState.choice(..., replace=False)``.  The class index lists are
computed once (:class:`Drawer`), so that drawing many trials costs only
the choices; the draws are those of ``generate``."""

import numpy as np


class Drawer:
    def __init__(self, labels):
        labels = np.asarray(labels)
        classes = np.unique(labels)
        self.classes = classes[classes >= 0]
        self.index = [np.where(labels == c)[0] for c in self.classes]

    def draw(self, rs, rate):
        """One train set: ``rate`` nodes of each class, class by class."""
        return np.concatenate([rs.choice(ind, size=min(int(rate), len(ind)),
                                         replace=False)
                               for ind in self.index])
