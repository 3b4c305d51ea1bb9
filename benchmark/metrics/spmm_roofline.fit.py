"""spmm_roofline.fit: the share of its roofline that one product of the
operator the fits used reaches at their width, its time from the
profiler's device trace of a chain of products (lib.readings.roofline_pct)."""

from benchmark.lib.readings import roofline_pct as read  # noqa: F401
