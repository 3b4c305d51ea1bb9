"""Solver-state checkpoints of graphlearning_tpu_torch (``checkpoint`` and
the checkpointed PoissonMBO and VolumeMBO fits), against graphlearning_tpu
on the CPU at float64, on the 500-node three-cluster input of JAX's
``tests/test_checkpoint.py``.

* ``save`` / ``load`` round trips (structure, dtypes, ``like``'s devices).
* A fit killed after a save (a ``save`` that raises, as JAX's test) and
  run again on the same path: PoissonMBO bit-equal to the fused fit, and
  only the rounds it had not saved run; VolumeMBO at temperature 0.1
  (seed 0) bit-equal to an uninterrupted checkpointed fit, the
  generator's state in the saved state.
* VolumeMBO's checkpointed loop against its fused loop at temperature 0
  and at 0.1 (seed 0): JAX's bound is >= 0.99 of the nodes
  (``tests/test_checkpoint.py:101-117``); here both run one loop, saved
  or not, so the labels are equal.
* The checkpointed fits against JAX's checkpointed fits: PoissonMBO and
  VolumeMBO at temperature 0 (no noise) give the same labels.
* ``fit(ti, tl, None, path, 2)`` binds the same in both packages.
"""

import inspect
import os

import numpy as np
import pytest
import torch

import graphlearning_tpu as jgl
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch import checkpoint as tckpt
from graphlearning_tpu_torch.solvers import volume as tvolume

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def clusters():
    rs = np.random.RandomState(3)
    n, ncls = 500, 3
    centers = rs.randn(ncls, 5) * 1.8
    labels = rs.randint(0, ncls, n)
    X = centers[labels] + rs.randn(n, 5)
    W = jgl.weightmatrix.knn(X, 10)
    train_ind = np.concatenate(
        [rs.choice(np.where(labels == c)[0], 5, replace=False)
         for c in range(ncls)])
    return W, labels, train_ind, jgl.utils.class_priors(labels)


class _KillAfter:
    """A ``save`` that lets ``n`` saves through, then raises: a process
    dying mid-fit after some state reached the disk."""

    def __init__(self, n, real):
        self.left = n
        self.real = real

    def __call__(self, path, state, step=0):
        self.real(path, state, step)
        self.left -= 1
        if self.left <= 0:
            raise RuntimeError("simulated kill")


def test_save_load_round_trip(tmp_path):
    path = str(tmp_path / "ck")
    assert tckpt.load(path) is None
    state = (torch.arange(6, dtype=torch.float64).reshape(2, 3),
             (torch.tensor([3, 1], dtype=torch.int64), 2.5), 7, True,
             torch.Generator().manual_seed(3).get_state())
    tckpt.save(path, state, step=4)
    assert os.listdir(path) == ["state.pt"]
    out, step = tckpt.load(path, like=state)
    assert step == 4 and isinstance(out, tuple) and isinstance(out[1], tuple)
    assert torch.equal(out[0], state[0]) and out[0].dtype == torch.float64
    assert torch.equal(out[1][0], state[1][0]) and out[1][1] == 2.5
    assert out[2] == 7 and out[3] is True and torch.equal(out[4], state[4])
    # a list template comes back in tuples; a new save replaces the old
    tckpt.save(path, [torch.ones(2), 1], step=9)
    out, step = tckpt.load(path, like=[torch.zeros(2), 0])
    assert step == 9 and isinstance(out, tuple) and out[1] == 1


def test_run_checkpointed_resumes_after_a_kill(tmp_path, monkeypatch):
    path = str(tmp_path / "count")
    calls = []

    def step(st):
        calls.append(int(st[1]))
        return st[0] * 2.0, st[1] + 1

    start = (torch.ones(3), 0)
    full, n = tckpt.run_checkpointed(step, start, 7, str(tmp_path / "full"),
                                     every=3)
    assert n == 7 and int(full[1]) == 7
    killer = _KillAfter(2, tckpt.save)
    monkeypatch.setattr(tckpt, "save", killer)
    with pytest.raises(RuntimeError, match="simulated kill"):
        tckpt.run_checkpointed(step, start, 7, path, every=3)
    monkeypatch.setattr(tckpt, "save", killer.real)
    calls.clear()
    out, n = tckpt.run_checkpointed(step, start, 7, path, every=3)
    assert calls == [6] and n == 7 and torch.equal(out[0], full[0])
    # a finished run loads and runs nothing
    calls.clear()
    tckpt.run_checkpointed(step, start, 7, path, every=3)
    assert calls == []


def test_run_checkpointed_while_stops_between_segments(tmp_path):
    def step(st):
        x, done = st
        return (x, True) if done else (x + 1, x + 1 >= 5)

    out, n = tckpt.run_checkpointed_while(
        step, (0, False), done_fn=lambda st: st[1], max_steps=100,
        path=str(tmp_path / "w"), every=4)
    assert out == (5, True) and n == 8


def _rounds(monkeypatch):
    """Count PoissonMBO's rounds."""
    count = []
    real = tvolume.poisson_mbo_round

    def counted(*a, **k):
        count.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tvolume, "poisson_mbo_round", counted)
    return count


def test_poisson_mbo_killed_and_resumed_equals_fused(clusters, tmp_path,
                                                      monkeypatch):
    W, labels, ti, priors = clusters
    path = str(tmp_path / "pmbo")
    make = lambda: tgl.ssl.poisson_mbo(W, class_priors=priors, T=8,
                                       device="cpu")
    m0 = make()
    pred0 = m0.fit_predict(ti, labels[ti])
    killer = _KillAfter(2, tckpt.save)
    monkeypatch.setattr(tckpt, "save", killer)
    with pytest.raises(RuntimeError, match="simulated kill"):
        make().fit(ti, labels[ti], checkpoint_path=path, checkpoint_every=2)
    monkeypatch.setattr(tckpt, "save", killer.real)
    assert tckpt.load(path)[1] == 4
    rounds = _rounds(monkeypatch)
    m2 = make()
    pred2 = m2.fit_predict(ti, labels[ti], checkpoint_path=path,
                           checkpoint_every=2)
    assert len(rounds) == 4
    np.testing.assert_array_equal(pred2, pred0)
    np.testing.assert_array_equal(m2.prob, m0.prob)
    np.testing.assert_array_equal(m2.weights, m0.weights)
    assert tgl.ssl.ssl_accuracy(pred2, labels, ti) > 85.0


def test_volume_mbo_killed_and_resumed_equals_uninterrupted(clusters,
                                                            tmp_path,
                                                            monkeypatch):
    W, labels, ti, priors = clusters
    make = lambda: tgl.ssl.volume_mbo(W, class_priors=priors,
                                      temperature=0.1, max_iters=60, seed=0,
                                      device="cpu")
    m0 = make()
    pred0 = m0.fit_predict(ti, labels[ti],
                           checkpoint_path=str(tmp_path / "ref"),
                           checkpoint_every=5)
    path = str(tmp_path / "vmbo")
    killer = _KillAfter(1, tckpt.save)
    monkeypatch.setattr(tckpt, "save", killer)
    with pytest.raises(RuntimeError, match="simulated kill"):
        make().fit(ti, labels[ti], checkpoint_path=path, checkpoint_every=5)
    monkeypatch.setattr(tckpt, "save", killer.real)
    saved, step = tckpt.load(path)
    assert step == 5 and saved[1] == 5 and not saved[2]
    m2 = make()
    pred2 = m2.fit_predict(ti, labels[ti], checkpoint_path=path,
                           checkpoint_every=5)
    np.testing.assert_array_equal(pred2, pred0)
    assert m2.iters == m0.iters > 10


@pytest.mark.parametrize("temperature", [0.0, 0.1])
def test_volume_mbo_checkpointed_agrees_with_fused(clusters, tmp_path,
                                                   temperature):
    W, labels, ti, priors = clusters
    make = lambda: tgl.ssl.volume_mbo(W, class_priors=priors,
                                      temperature=temperature, max_iters=60,
                                      seed=0, device="cpu")
    m0 = make()
    fused = m0.fit_predict(ti, labels[ti])
    m1 = make()
    ck = m1.fit_predict(ti, labels[ti], checkpoint_path=str(tmp_path / "v0"),
                        checkpoint_every=7)
    assert np.mean(fused == ck) > 0.99
    np.testing.assert_array_equal(ck, fused)
    assert m1.iters == m0.iters


@pytest.mark.parametrize("name", ["poisson_mbo", "volume_mbo"])
def test_checkpointed_fits_match_jax(clusters, tmp_path, name):
    W, labels, ti, priors = clusters
    kw = ({"T": 8} if name == "poisson_mbo"
          else {"temperature": 0.0, "max_iters": 60})
    jm = getattr(jgl.ssl, name)(W, class_priors=priors, **kw)
    tm = getattr(tgl.ssl, name)(W, class_priors=priors, device="cpu", **kw)
    pj = jm.fit_predict(ti, labels[ti], checkpoint_path=str(tmp_path / "j"),
                        checkpoint_every=3)
    pt = tm.fit_predict(ti, labels[ti], checkpoint_path=str(tmp_path / "t"),
                        checkpoint_every=3)
    np.testing.assert_array_equal(pt, pj)


def test_fit_binds_the_checkpoint_parameters_positionally(clusters,
                                                          tmp_path):
    W, labels, ti, priors = clusters
    for meth in ("fit", "fit_predict"):
        assert (list(inspect.signature(getattr(tgl.ssl.ssl, meth)).parameters)
                == list(inspect.signature(getattr(jgl.ssl.ssl,
                                                  meth)).parameters))
    path = str(tmp_path / "pos")
    jm = jgl.ssl.poisson_mbo(W, class_priors=priors, T=4)
    tm = tgl.ssl.poisson_mbo(W, class_priors=priors, T=4, device="cpu")
    jm.fit(ti, labels[ti], None, path + "_j", 2)
    tm.fit(ti, labels[ti], None, path + "_t", 2)
    assert tm._ckpt == (os.path.abspath(path + "_t"), 2)
    assert jm._ckpt == (os.path.abspath(path + "_j"), 2)
    assert tckpt.load(path + "_t")[1] == 4
    # a model with no segmented loop ignores them
    lm = tgl.ssl.laplace(W, device="cpu")
    pred = lm.fit_predict(ti, labels[ti], None, path + "_l", 2)
    assert not os.path.exists(path + "_l")
    np.testing.assert_array_equal(
        pred, tgl.ssl.laplace(W, device="cpu").fit_predict(ti, labels[ti]))
    lm.fit_device(ti, labels[ti])
    assert lm._ckpt is None
