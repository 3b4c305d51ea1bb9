"""cg_iters.fit: the CG steps of a fit, mean over the window's fits, as
the model counts them (``iters``)."""

from benchmark.lib.readings import mean_iters as read  # noqa: F401
