"""api_self_ms.fit: the fit API's own time a traced fit, in ms: the
``ssl.*`` root span's duration less its outermost ``cg.*``, ``accel.*``,
``graph.*`` and ``knn.*`` spans (the boundary values, the labels' copy,
the accel's permutations), mean over the traced fits
(lib.spans.api_self_ms)."""

from benchmark.lib.spans import api_self_ms as read  # noqa: F401
