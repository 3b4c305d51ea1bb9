"""cg_host_ms.fit: the host's time issuing a CG step of the traced fits,
in ms: the ``cg.solve`` spans less their ``cg.wait`` spans (the host's
reads that wait on the card), over their steps (lib.spans.cg_host_ms)."""

from benchmark.lib.spans import cg_host_ms as read  # noqa: F401
