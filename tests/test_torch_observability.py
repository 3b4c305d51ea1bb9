"""``observability`` of graphlearning_tpu_torch against graphlearning_tpu on
the CPU: the cases of ``tests/test_observability.py`` on the port, the
same result keys, and ``Counters.summary()`` equal to JAX's for the same
adds and gauges."""

import inspect
import json
import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from graphlearning_tpu import observability as jobs
from graphlearning_tpu_torch import observability as obs

torch.set_num_threads(2)


def test_timer_and_benchmark():
    f = lambda x: x @ x
    x = torch.ones((64, 64))
    with obs.Timer(sync=f(x)) as t:
        y = f(x)
    assert t.seconds is not None and t.seconds >= 0
    res = obs.benchmark(f, x, iters=3, edges=1000)
    assert res["seconds_per_call"] > 0
    assert res["edges_per_sec"] == 1000 / res["seconds_per_call"]
    jres = jobs.benchmark(jax.jit(lambda x: x @ x), jnp.ones((64, 64)),
                          iters=3, edges=1000)
    assert set(res) == set(jres) and res["iters"] == jres["iters"] == 3


def test_timer_takes_a_tree_of_tensors():
    with obs.Timer(sync={"a": [torch.ones(3), (torch.zeros(2),)],
                         "b": 1.0}) as t:
        pass
    assert t.seconds >= 0
    with obs.Timer() as t:
        pass
    assert t.seconds >= 0


def test_benchmark_chained():
    calls = []

    def f(x):
        calls.append(x)
        return x * 0.5

    x0 = torch.ones((16,))
    res = obs.benchmark(f, x0, iters=4, warmup=2, chain=True)
    assert res["iters"] == 4 and "edges_per_sec" not in res
    # two warm-up calls on x0, then each output fed back
    assert len(calls) == 6 and calls[2] is x0
    assert torch.equal(calls[-1], torch.full((16,), 0.125))


@pytest.mark.parametrize("adds", [
    [("cg_iters", 10), ("cg_iters", 5)],
    [("spmm_edges", 1.5e9), ("a", 1), ("rounds", 3)],
])
def test_counters_match_jax(adds):
    c, jc = obs.Counters(), jobs.Counters()
    for name, v in adds:
        c.add(name, v)
        jc.add(name, v)
    for cnt in (c, jc):
        cnt.gauge("residual", 1e-7)
        cnt.add("steps")
    assert c.summary() == jc.summary()
    for name in {n for n, _ in adds} | {"residual", "missing"}:
        assert c.get(name) == jc.get(name)
    c.reset()
    assert c.get("cg_iters") == 0 and c.summary() == ""
    assert isinstance(obs.counters, obs.Counters)


def test_counters_as_jax():
    c = obs.Counters()
    c.add("cg_iters", 10)
    c.add("cg_iters", 5)
    c.gauge("residual", 1e-7)
    assert c.get("cg_iters") == 15
    assert c.get("residual") == 1e-7
    assert "cg_iters: 15" in c.summary()
    c.reset()
    assert c.get("cg_iters") == 0


def test_trace_writes_dir(tmp_path):
    logdir = str(tmp_path / "trace")
    with obs.trace(logdir):
        torch.ones((8, 8)) @ torch.ones((8, 8))
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(logdir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_signatures_match_jax():
    for name in ("trace", "benchmark"):
        assert (inspect.signature(getattr(obs, name))
                == inspect.signature(getattr(jobs, name))), name
    assert (inspect.signature(obs.Timer)
            == inspect.signature(jobs.Timer))
