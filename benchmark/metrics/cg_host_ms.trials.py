"""cg_host_ms.trials: the host's time issuing a batched CG step of the
traced calls' trial groups, in ms: the ``cg.solve`` spans less their
``cg.wait`` spans, over their steps (lib.spans.cg_host_ms)."""

from benchmark.lib.spans import cg_host_ms as read  # noqa: F401
