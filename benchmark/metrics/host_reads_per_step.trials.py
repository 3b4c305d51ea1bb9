"""host_reads_per_step.trials: the traced calls' device-to-host reads
(``counters["host_reads"]``) over their batched CG steps
(``counters["cg.steps"]``, one a product of a trial group), both counted
over each call's root span (lib.spans.host_reads_per_step)."""

from benchmark.lib.spans import host_reads_per_step as read  # noqa: F401
