"""fit_s: the time from the window's start to the end of its last whole
fit, over the fits completed, host clock."""


def read(run):
    return run.window_s / len(run.calls)
