"""INCRES clustering of graphlearning_tpu_torch against graphlearning_tpu on
the CPU, at float64 (JAX's x64 on).

JAX draws each round's scores from its PRNG keys, the port from a
``torch.Generator``; here the port is fed JAX's draws (the key split once
a round, ``jax_draws``), so the rounds are the same:

* ``clustering.incres`` on the plain path: labels equal to JAX's
  (``_incres_loop_xla``);
* the accel entries on the CPU, the band (f32 mode, the kernels' f64
  twins) and the gather: labels equal to JAX's plain loop, and the gather's
  to JAX's gather entry;
* the fit on the bf16 band forced on the CPU: labels on at least 0.95 of
  the nodes as the plain path's, up to a permutation;
* the ``all_labels`` host loop (numpy plants the seeds): JAX's labels and
  printed lines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphlearning_tpu as jgl
from graphlearning_tpu import clustering as jcl
from graphlearning_tpu.core.sparse import SparseGraph as JSparseGraph
from graphlearning_tpu.ops import gather as jgather
import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch.ops import accel as taccel
from graphlearning_tpu_torch.ops import gather as tgather
from graphlearning_tpu_torch.solvers import incres as tincres
from test_torch_centered_kernel import mixture  # noqa: F401
from test_torch_gather import cpu_accel  # noqa: F401
from test_torch_mbo import moons  # noqa: F401

torch.set_num_threads(2)
T = 25


def jax_scores(seed):
    """``draw((k, n))``: JAX's uniform scores of each round, in order."""
    key = [jax.random.PRNGKey(seed)]

    def draw(shape):
        key[0], sub = jax.random.split(key[0])
        return torch.tensor(np.asarray(jax.random.uniform(sub, tuple(shape))))

    return draw


@pytest.fixture
def jax_draws(monkeypatch):
    monkeypatch.setattr(tincres, "uniform",
                        lambda gen, dtype: jax_scores(int(gen.initial_seed())))


def _jax_loop(W, k, T, seed):
    """JAX's plain loop and its inputs: ``(labels, u0, Dm, deg)``."""
    n = W.shape[0]
    Dm = max(int(5 * 1e-4 * n / k), 1)
    u0 = np.random.RandomState(seed).randint(0, k, size=n)
    deg = np.asarray(W.sum(axis=1)).ravel()
    lab = jcl._incres_loop_xla(JSparseGraph.from_scipy(W), jnp.asarray(deg),
                               jnp.asarray(u0, jnp.int32),
                               jax.random.PRNGKey(seed), k=k, T=T, Dm=Dm)
    return np.asarray(lab), u0, Dm, deg


def test_plain_fit_matches_jax(moons, jax_draws):
    W = moons[0]
    pj = jgl.clustering.incres(W, 2, T=T, seed=0).fit_predict()
    m = tgl.clustering.incres(W, 2, T=T, seed=0, device="cpu")
    pt = m.fit_predict()
    np.testing.assert_array_equal(pt, pj)
    assert len(m.steps) == T and min(m.steps) >= 1
    assert getattr(m, "_accel_incres", None) is None
    assert tgl.clustering.clustering_accuracy(pt, moons[1]) > 70


@pytest.mark.parametrize("case", ["band", "gather"])
def test_accel_entries_match_jax(moons, mixture, case):
    """The entry on the f32 band (padding rows out of the stop test) and on
    the gather, fed JAX's scores: JAX's plain labels."""
    if case == "band":
        W, k = moons[0], 2
        acc = taccel.AccelSpMM(W, device="cpu")
        assert acc.n_pad > W.shape[0]
    else:
        W, k = mixture[0], 3
        acc = tgather.GatherAccel(W, device="cpu")
    ref, u0, Dm, deg = _jax_loop(W, k, T, seed=1)
    deg_p = acc.to_perm(torch.as_tensor(deg))
    dinv_p = torch.where(deg_p > 0, 1.0 / torch.where(
        deg_p == 0, torch.ones_like(deg_p), deg_p), torch.zeros_like(deg_p))
    info = {}
    lab = acc.incres(dinv_p, torch.as_tensor(u0), jax_scores(1), k, T, Dm,
                     W.shape[0], info=info)
    np.testing.assert_array_equal(lab.numpy(), ref)
    assert len(info["steps"]) == T
    if case == "gather":
        ja = jgather.GatherAccel(W, prec="f32")
        lj = ja.incres(ja.to_perm(jnp.asarray(deg)) ** -1.0,
                       jnp.asarray(u0), jax.random.PRNGKey(1), k=k, T=T,
                       Dm=Dm, n_true=W.shape[0])
        np.testing.assert_array_equal(lab.numpy(), np.asarray(lj))


def test_bf16_band_fit_agrees_with_plain(moons, jax_draws, cpu_accel,
                                         monkeypatch):
    """The fit takes the bf16 band (as JAX's inexact mode) and, on the same
    draws, agrees with the plain path up to a permutation on >= 0.95 of
    the nodes (bf16 operands move the diffusion and the grow steps)."""
    W, y = moons[0], moons[1]
    m = tgl.clustering.incres(W.copy(), 2, T=T, seed=2, device="cpu")
    pred = m.fit_predict()
    assert isinstance(m._accel_incres, taccel.AccelSpMM)
    assert m._accel_incres.mode == "bf16"
    monkeypatch.setattr(taccel, "enabled", lambda device: False)
    ref = tgl.clustering.incres(W, 2, T=T, seed=2,
                                device="cpu").fit_predict()
    assert tgl.clustering.clustering_accuracy(pred, ref) >= 95.0


def test_all_labels_host_loop_matches_jax(moons, capsys):
    W, y = moons[0], moons[1]
    pj = jgl.clustering.incres(W, 2, T=6, seed=3).fit(all_labels=y)
    out_j = capsys.readouterr().out
    m = tgl.clustering.incres(W, 2, T=6, seed=3, device="cpu")
    pt = m.fit(all_labels=y)
    out_t = capsys.readouterr().out
    np.testing.assert_array_equal(pt, pj)
    assert out_t == out_j and out_t.count("Iteration") == 6
    assert len(m.steps) == 6


def test_seeded_draws(moons):
    """The port's own draws: a seed gives the same labels, and a seed drawn
    from numpy's global state (as JAX draws its key) too."""
    W = moons[0]
    fit = lambda seed: tgl.clustering.incres(W, 2, T=8, seed=seed,
                                             device="cpu").fit_predict()
    np.testing.assert_array_equal(fit(4), fit(4))
    np.random.seed(9)
    a = fit(None)
    np.random.seed(9)
    np.testing.assert_array_equal(fit(None), a)
