"""The roofline's byte count against a hand count, the trace reduction on
a made-up timeline, and the window's share of the peak."""

import types

import numpy as np
import pytest
import scipy.sparse as sp

from benchmark import calls
from benchmark.lib import readings, roofline
from benchmark.lib import trace as tr


def test_product_bytes_by_hand():
    # a 4-node path graph, symmetric: 6 stored nonzeros
    W = sp.diags([np.ones(3), np.ones(3)], [-1, 1], shape=(4, 4)).tocsr()
    n, nnz, d = 4, W.nnz, 3
    assert nnz == 6
    # values 6 x 4 + columns 6 x 4 + row pointers 5 x 4 + X 4 x 3 x 4 + Y
    hand = 24 + 24 + 20 + 48 + 48
    assert roofline.w_bytes(n, nnz) + roofline.xy_bytes(n, d) == hand
    assert roofline.least_s(n, nnz, d) == pytest.approx(hand / 3.35e12)


def test_trace_busy_union_gaps_and_labels():
    W = tr.WINDOW
    evs = [(W, False, 0.0, 10.0),
           ("host_a", False, 0.5, 3.4),
           ("host_b", False, 6.0, 9.5),
           ("k1", True, 1.0, 2.0),
           ("k2", True, 1.5, 3.0),      # overlaps k1: counted once
           ("k1", True, 4.0, 5.0),
           ("k3", True, 9.0, 11.0),     # clipped to the window's end
           (W, True, 0.0, 10.0)]        # the span mirrored: no device work
    s = tr.summarize(evs)
    assert s["window_s"] == 10.0
    assert s["busy_s"] == pytest.approx(2.0 + 1.0 + 1.0)
    ops = dict(s["device_ops"])
    assert ops["k1"] == pytest.approx(2.0) and ops["k3"] == pytest.approx(1.0)
    gaps = dict(s["idle_gaps"])
    # gaps 0-1 (host_a), 3-4 (none at its middle), 5-9 (host_b)
    assert gaps["host_a"] == pytest.approx(1.0)
    assert gaps["host_b"] == pytest.approx(4.0)
    assert gaps["(host between operations)"] == pytest.approx(1.0)
    assert tr.summarize([(W, False, 0, 1), ("h", False, 0, 1)]) is None


def test_window_share_counts_products():
    run = types.SimpleNamespace(
        n=4, nnz=6, labels=np.array([0, 1, 0, 1]),
        shape=calls.load("fit"), window_s=2.0,
        calls=[{"iters": [15]}])
    need = 15 * (roofline.w_bytes(4, 6) + roofline.xy_bytes(4, 2))
    assert readings.mfu_pct(run) == pytest.approx(
        100 * need / roofline.PEAK_BYTES_S / 2.0)
    run.shape = calls.load("trials")
    run.calls = [{"iters": [3, 5]}]
    need = 5 * roofline.w_bytes(4, 6) + 8 * roofline.xy_bytes(4, 2)
    assert readings.mfu_pct(run) == pytest.approx(
        100 * need / roofline.PEAK_BYTES_S / 2.0)
