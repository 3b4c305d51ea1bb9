"""A whole run at a tiny size on the CPU, past the harness's look for a
card: sound, its check passes under the cells' limits; with the timed
path broken underneath, ``correct`` comes out false, once for each fault
the cell can have."""

import numpy as np
import pytest
import torch
from conftest import CELLS, tiny

import graphlearning_tpu_torch as gl
from benchmark import run as bench_run
from benchmark.lib import manifest as mf
from graphlearning_tpu_torch.solvers import cg as gl_cg


def _measure(name, seed=31):
    cell, cfg, tf = tiny(name)
    return bench_run.measure(cell, cfg, tf, mf.limits(name),
                             mf.metrics(mf.manifest(), name, False), seed,
                             0.2, False, torch.device("cpu"))


def _alter(labels):
    """A hundredth of the nodes (at least one) moved to the next class."""
    labels = np.array(labels)
    m = max(1, len(labels) // 100)
    top = labels.max() + 1
    labels[:m] = (labels[:m] + 1) % top
    return labels


def answer_altered(mp):
    predict, batched = gl.ssl.ssl.predict, gl.ssl.ssl._predict_batched
    mp.setattr(gl.ssl.ssl, "predict",
               lambda self, *a, **k: _alter(predict(self, *a, **k)))
    mp.setattr(gl.ssl.ssl, "_predict_batched",
               lambda self, *a: [_alter(p) for p in batched(self, *a)])


def state_unchanged(mp):
    """Every step of the cell's solver loop returns its state unchanged:
    CG takes no step."""
    conj, conjb = gl_cg.conjgrad, gl_cg.conjgrad_batched
    mp.setattr(gl_cg, "conjgrad",
               lambda A, b, **k: conj(A, b, **{**k, "max_iter": 0}))
    mp.setattr(gl_cg, "conjgrad_batched",
               lambda A, b, **k: conjb(A, b, **{**k, "max_iter": 0}))


def half_left_out(mp):
    """The batched solve solves the first half of its trials and leaves
    the rest at zero."""
    conjb = gl_cg.conjgrad_batched

    def half(A, b, **k):
        T = b.shape[0]
        h = max(1, T // 2)
        x, it, res = conjb(A, b[:h], **k)
        x = torch.cat([x, torch.zeros_like(b[h:])])
        return (x, np.concatenate([it, np.zeros(T - h, it.dtype)]),
                np.concatenate([res, np.zeros(T - h)]))

    mp.setattr(gl_cg, "conjgrad_batched", half)


FAULTS = {
    "mnist70k.poisson.trials": [answer_altered, state_unchanged,
                                half_left_out],
    "moons1m.laplace.fit": [answer_altered, state_unchanged],
}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _measure(name)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]],
                         ids=lambda x: getattr(x, "__name__", x))
def test_fault_is_caught(monkeypatch, name, fault):
    fault(monkeypatch)
    res = _measure(name)
    assert not res["correct"], res["checks"]
