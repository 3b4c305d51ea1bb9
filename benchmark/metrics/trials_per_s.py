"""trials_per_s: the trials completed in the window over the time from the
window's start to the end of its last whole call, host clock."""


def read(run):
    return sum(c["answers"] for c in run.calls) / run.window_s
