"""api_self_ms.trials: the fit API's own time a traced call of trials, in
ms: the ``ssl.*`` root span's duration less its outermost ``cg.*``,
``accel.*``, ``graph.*`` and ``knn.*`` spans (each group's sources and
their copy to the card, the labels' copies), mean over the traced calls
(lib.spans.api_self_ms)."""

from benchmark.lib.spans import api_self_ms as read  # noqa: F401
