"""spmm_roofline.trials: the share of its roofline that one product of the
plain ELL reaches at one trial group's width, its time from the
profiler's device trace of a chain of products (lib.readings.roofline_pct)."""

from benchmark.lib.readings import roofline_pct as read  # noqa: F401
