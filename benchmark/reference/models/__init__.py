"""Plain solvers of the SSL models, one module each, found by the model
name a traffic mix gives.  Each module has ``DEFAULTS`` (the model's
settings as GraphLearning states them); ``answers(ar, items,
settings)``, the answers of ``ar``'s precision (a control's); and
``judge(ar, answers, settings)``, the numbers of each answer (a dict
with ``train_ind``, ``train_labels``, ``labels`` and, where the call
returns them, ``scores``) against the reference solved in ``ar``'s
precision."""

import importlib


def load(name):
    return importlib.import_module(f"benchmark.reference.models.{name}")
