"""cg_iters.trials: the CG steps of a trial, mean over the window's
trials, as the model counts them (``iters``, one a trial)."""

from benchmark.lib.readings import mean_iters as read  # noqa: F401
