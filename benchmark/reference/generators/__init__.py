"""Point generators, one module each, found by the name a configuration's
``points.generator`` gives.  Each module has ``points(n, seed, **params)``
returning ``(points (n, dim) float64, labels (n,) int64)``."""

import importlib


def load(name):
    return importlib.import_module(f"benchmark.reference.generators.{name}")
