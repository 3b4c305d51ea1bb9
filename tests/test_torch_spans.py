"""``observability.span`` of graphlearning_tpu_torch on the CPU: counted
always, recorded only while a profiler records, on the profiler's own
timeline and clock; and the spans and counters of the fit path (the fit
API, the CG loops, the graph build) around a Laplace fit and a batch of
Poisson trials, which they leave unchanged."""

import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import graphlearning_tpu_torch as gl
from graphlearning_tpu_torch import observability as obs
from graphlearning_tpu_torch import ssl as ssl_mod

torch.set_num_threads(2)

N, K = 200, 8


def _profiled(fn):
    """``(fn(), records, {name: [(start_ns, end_ns)]} of the profiler's
    ranges)``."""
    obs.spans(clear=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = {}
    for ev in prof.profiler.kineto_results.events():
        ranges.setdefault(ev.name(), []).append(
            (ev.start_ns(), ev.start_ns() + ev.duration_ns()))
    return out, obs.spans(clear=True), ranges


def _points():
    rs = np.random.RandomState(0)
    X = rs.randn(N, 2)
    X[N // 2:] += 4.0
    return X, (np.arange(N) >= N // 2).astype(int)


def test_unrecorded_span_counts_and_keeps_nothing():
    obs.spans(clear=True)
    before = obs.counters.get("test.unrecorded")
    secs = obs.counters.get("test.unrecorded.s")
    with obs.span("test.unrecorded", a=1) as sp:
        time.sleep(0.002)
        sp.set(b=2)
    assert obs.counters.get("test.unrecorded") == before + 1
    assert obs.counters.get("test.unrecorded.s") >= secs + 0.002
    assert "test.unrecorded: " in obs.counters.summary()
    assert obs.spans() == []


def test_nested_spans_keep_parent_and_root():
    def work():
        with obs.span("test.outer", x=1) as outer:
            with obs.span("test.mid"):
                with obs.span("test.inner"):
                    torch.ones(4).sum()
            with obs.span("test.mid"):
                pass
            outer.set(y=2)
        with obs.span("test.outer"):
            pass

    _, recs, _ = _profiled(work)
    assert [r["name"] for r in recs] == ["test.inner", "test.mid",
                                         "test.mid", "test.outer",
                                         "test.outer"]
    inner, mid1, mid2, outer, outer2 = recs
    assert outer["parent"] is None and outer["root"] == outer["id"]
    assert mid1["parent"] == mid2["parent"] == outer["id"]
    assert inner["parent"] == mid1["id"]
    assert {r["root"] for r in recs[:4]} == {outer["id"]}
    assert outer2["root"] == outer2["id"] != outer["id"]
    assert outer["attrs"] == {"x": 1, "y": 2}
    assert "counts" in outer and "counts" not in mid1
    for r in recs:
        assert r["start_ns"] <= r["end_ns"]
    assert outer["start_ns"] <= inner["start_ns"] <= inner["end_ns"] \
        <= outer["end_ns"]


def test_spans_lie_on_the_profilers_timeline():
    def work():
        for _ in range(3):
            with obs.span("test.timed"):
                with obs.span("test.timed_inner"):
                    time.sleep(0.003)

    _, recs, ranges = _profiled(work)
    for name in ("test.timed", "test.timed_inner"):
        mine = sorted((r["start_ns"], r["end_ns"]) for r in recs
                      if r["name"] == name)
        theirs = sorted(ranges[name])
        assert len(mine) == len(theirs) == 3
        for (s, e), (ps, pe) in zip(mine, theirs):
            assert abs(s - ps) < 500_000 and abs(e - pe) < 500_000, \
                (name, s - ps, e - pe)


def test_root_keeps_its_counter_deltas():
    def work():
        with obs.span("test.root"):
            obs.counters.add("cg.steps", 5)
            obs.counters.add("host_reads", 7)
            with obs.span("test.child"):
                obs.counters.add("host_reads")

    _, recs, _ = _profiled(work)
    root = [r for r in recs if r["name"] == "test.root"][0]
    assert root["counts"] == {"cg.steps": 5.0, "host_reads": 8.0}


def test_spans_buffer_clears_and_is_bounded():
    def work():
        for _ in range(3):
            with obs.span("test.buffered"):
                pass

    _, recs, _ = _profiled(work)
    assert len(recs) == 3 and obs.spans() == []
    assert obs._RECORDS.maxlen == 1 << 16


def test_span_records_on_an_exception():
    def work():
        with pytest.raises(ValueError):
            with obs.span("test.raises"):
                raise ValueError("inside")
        with obs.span("test.after"):
            pass

    _, recs, _ = _profiled(work)
    assert [r["name"] for r in recs] == ["test.raises", "test.after"]
    assert all(r["parent"] is None for r in recs)


def _laplace(W, labels):
    m = gl.ssl.laplace(W, device="cpu")
    ti = np.array([0, 1, 2, N // 2, N // 2 + 1, N // 2 + 2])
    return m, [m.fit_predict(ti, labels[ti])]


def _poisson_trials(W, labels):
    rs = np.random.RandomState(1)
    trials = [rs.choice(N, 6, replace=False) for _ in range(6)]
    m = gl.ssl.poisson(W, device="cpu")
    return m, m.fit_predict_batched(trials, labels)


FITS = {"laplace": _laplace, "poisson_trials": _poisson_trials}


@pytest.fixture
def small_groups(monkeypatch):
    """Groups of 4 trials in the batched fits (6 trials: 4 and 2)."""
    monkeypatch.setattr(ssl_mod, "_batch_groups", lambda T, g, C, dtype: [
        list(range(s, min(s + 4, T))) for s in range(0, T, 4)])


def _children(recs, parent):
    return [r for r in recs if r["parent"] == parent["id"]]


@pytest.mark.parametrize("fit", sorted(FITS))
def test_fit_span_tree(small_groups, fit):
    X, labels = _points()

    def work():
        W = gl.weightmatrix.knn(X, K, device="cpu")
        return FITS[fit](W, labels)

    (m, _), recs, ranges = _profiled(work)
    by_name = {}
    for r in recs:
        by_name.setdefault(r["name"], []).append(r)
    (knn,) = by_name["knn.build"]
    assert knn["parent"] is None and knn["attrs"]["n"] == N
    (ell,) = by_name["graph.ell"]
    assert ell["attrs"] == {"n": N, "k": ell["attrs"]["k"]}
    assert "accel.build" not in by_name        # no route on the CPU
    roots = [r for r in recs if r["parent"] is None
             and r["name"].startswith("ssl.")]
    assert len(roots) == 1
    root = roots[0]
    assert root["attrs"]["model"] == type(m).__name__
    assert root["attrs"]["n"] == N and root["attrs"]["classes"] == 2
    solves = by_name["cg.solve"]
    if fit == "laplace":
        assert root["name"] == "ssl.fit_predict"
        (fit_span,) = _children(recs, root)
        assert fit_span["name"] == "ssl.fit"
        assert [c["name"] for c in _children(recs, fit_span)] == [
            "ssl.sources", "cg.solve", "ssl.labels"]
        (solve,) = solves
        assert solve["attrs"] == {"columns": 2, "trials": 1,
                                  "steps": m.iters}
    else:
        assert root["name"] == "ssl.fit_predict_batched"
        assert root["attrs"]["trials"] == 6
        assert [c["name"] for c in _children(recs, root)] == [
            "ssl.sources", "cg.solve", "ssl.labels"] * 2
        assert [s["attrs"]["trials"] for s in solves] == [4, 2]
        assert [s["attrs"]["columns"] for s in solves] == [8, 4]
        assert [s["attrs"]["steps"] for s in solves] == [
            int(m.iters[:4].max()), int(m.iters[4:].max())]
    for s in solves:
        waits = _children(recs, s)
        assert waits and {w["name"] for w in waits} == {"cg.wait"}
        assert len(waits) >= s["attrs"]["steps"] + 1
    steps = sum(s["attrs"]["steps"] for s in solves)
    assert root["counts"]["cg.steps"] == steps > 0
    assert root["counts"]["host_reads"] >= root["counts"]["cg.steps"]
    for r in recs:
        assert r["root"] in {root["id"], knn["id"]} \
            or r["name"] == "graph.ell"
        assert r["name"] in ranges


@pytest.mark.parametrize("fit", sorted(FITS))
def test_fit_unchanged_under_the_profiler(small_groups, fit):
    X, labels = _points()
    W = gl.weightmatrix.knn(X, K, device="cpu")
    m0, plain = FITS[fit](W, labels)
    (m1, traced), _, _ = _profiled(lambda: FITS[fit](W, labels))
    assert np.array_equal(np.asarray(m0.iters), np.asarray(m1.iters))
    for a, b in zip(plain, traced):
        assert np.array_equal(a, b)


def test_counters_fed_by_a_fit_without_a_profiler():
    X, labels = _points()
    names = ("knn.build", "graph.ell", "ssl.fit_predict", "ssl.fit",
             "ssl.sources", "ssl.labels", "cg.solve", "cg.wait",
             "cg.steps", "host_reads")
    before = {n: obs.counters.get(n) for n in names}
    obs.spans(clear=True)
    W = gl.weightmatrix.knn(X, K, device="cpu")
    m, _ = _laplace(W, labels)
    grew = {n: obs.counters.get(n) - before[n] for n in names}
    assert grew["cg.steps"] == m.iters
    assert grew["cg.solve"] == 1 and grew["ssl.fit_predict"] == 1
    assert grew["cg.wait"] == m.iters + 3      # the stop reads, tol, res
    assert grew["host_reads"] == m.iters + 4   # and the scores' copy
    for n in names:
        assert grew[n] > 0, n
    assert obs.counters.get("cg.solve.s") > 0
    assert obs.spans() == []
