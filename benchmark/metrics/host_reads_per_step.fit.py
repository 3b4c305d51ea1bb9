"""host_reads_per_step.fit: the traced fits' device-to-host reads
(``counters["host_reads"]``) over their CG steps (``counters["cg.steps"]``),
both counted over each fit's root span (lib.spans.host_reads_per_step)."""

from benchmark.lib.spans import host_reads_per_step as read  # noqa: F401
