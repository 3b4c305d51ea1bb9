"""device_idle_pct.fit: the share of the traced window in which no kernel,
copy or set ran on the card, from the profiler's timeline
(lib.trace.summarize)."""

from benchmark.lib.readings import idle_pct as read  # noqa: F401
