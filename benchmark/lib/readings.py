"""Readings shared by several metric readers (``benchmark/metrics``)."""

import numpy as np

from benchmark.lib import roofline


def classes(run):
    return len(np.unique(run.labels[run.labels >= 0]))


def mean_iters(run):
    """The CG steps of an answer, mean over the window's answers."""
    return float(np.mean([i for c in run.calls for i in c["iters"]]))


def roofline_pct(run):
    """The least time of one product of the operator the calls used, at
    their width, over its device time in a chain of products, in per
    cent; None off CUDA or where the trace holds no device time."""
    if run.device.type != "cuda":
        return None
    product, X, d = run.operator()
    t = roofline.device_s(product, X)
    if not t:
        return None
    return 100.0 * roofline.least_s(run.n, run.nnz, d) / t


def idle_pct(run):
    """The share of the traced window in which nothing ran on the card."""
    ts = run.trace_summary
    if ts is None or ts["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ts["busy_s"] / ts["window_s"])


def mfu_pct(run):
    """The whole window's share of the chip's peak: the least bytes that
    its calls' products move (each call shape's ``least_bytes``) over the
    peak bandwidth and the window's time, in per cent."""
    C = classes(run)
    need = sum(run.shape.least_bytes(run.n, run.nnz, C, c["iters"])
               for c in run.calls)
    return 100.0 * need / roofline.PEAK_BYTES_S / run.window_s
