"""mfu.trials: the whole window's share of the chip's peak bandwidth, the
peak that bounds a sparse solve (lib.readings.mfu_pct)."""

from benchmark.lib.readings import mfu_pct as read  # noqa: F401
