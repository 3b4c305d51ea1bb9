"""``weightmatrix.vae`` of graphlearning_tpu_torch against graphlearning_tpu
on the CPU.  JAX's initial parameters (as ``optax.adam``'s ``init``
receives them) and its noise (each ``jax.random.normal`` draw, read back
by a debug callback) are recorded in the test, carried across and
replayed: the forward pass and loss within 1e-5 relative, the latent
means after 10 steps within 1e-5 of their largest.  The port's own init
has flax's mean and variance, and the JAX package's separation test holds
on the port."""

import inspect

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from graphlearning_tpu import weightmatrix as jwm
from graphlearning_tpu_torch import weightmatrix as twm

torch.set_num_threads(2)

CPU = torch.device("cpu")


def jax_vae(X, **kw):
    """``graphlearning_tpu.weightmatrix.vae(X, **kw)`` with its initial
    parameters and its noise draws recorded.  Returns ``(Z, params,
    draws)``; the first draw is ``model.init``'s, one a step follows."""
    draws, inits = [], []
    real_normal, real_adam = jax.random.normal, optax.adam

    def normal(key, shape=(), dtype=float):
        out = real_normal(key, shape, dtype)
        jax.debug.callback(lambda v: draws.append(np.array(v)), out,
                           ordered=True)
        return out

    def adam(*a, **k):
        tx = real_adam(*a, **k)

        def init(params):
            inits.append(jax.tree.map(np.array, params))
            return tx.init(params)
        return optax.GradientTransformation(init, tx.update)

    jax.random.normal, optax.adam = normal, adam
    try:
        Z = jwm.vae(X, **kw)
        jax.effects_barrier()
    finally:
        jax.random.normal, optax.adam = real_normal, real_adam
    return Z, inits[0], draws


@pytest.fixture(scope="module")
def data():
    rs = np.random.RandomState(0)
    X = np.abs(rs.randn(80, 30))
    X[40:] += 3.0
    return X


@pytest.fixture(scope="module")
def replay(data):
    """JAX's run of 10 steps (batch 8, one epoch) at widths (16, 4)."""
    return jax_vae(data, layer_widths=(16, 4), batch_size=8, epochs=1,
                   seed=0)


def test_carried_weights_give_jax_forward_and_loss(data, replay):
    import flax.linen as nn

    _, params, draws = replay
    X = twm._vae_data(data)[:8]
    eps = draws[1]
    p = params["params"]

    def dense(name, x):
        return x @ p[name]["kernel"] + p[name]["bias"]

    e = nn.relu(dense("Dense_0", jnp.asarray(X)))
    mu, logvar = dense("Dense_1", e), dense("Dense_2", e)
    zs = mu + jnp.exp(0.5 * logvar) * eps
    out = nn.sigmoid(dense("Dense_4", nn.relu(dense("Dense_3", zs))))
    bce = -jnp.sum(X * jnp.log(out + 1e-8)
                   + (1 - X) * jnp.log(1 - out + 1e-8))
    kld = -0.5 * jnp.sum(1 + logvar - mu**2 - jnp.exp(logvar))

    model = twm.VAE(30, 16, 4)
    model.load_state_dict(twm.vae_params_from_flax(params))
    xt, et = torch.as_tensor(X), torch.as_tensor(eps)
    with torch.no_grad():
        tout, tmu, tlogvar = model(xt, et)
        loss = twm._vae_loss(model, xt, et)
    for got, want in ((tout, out), (tmu, mu), (tlogvar, logvar)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(float(loss), float(bce + kld), rtol=1e-5)


def test_replay_of_jax_init_and_noise_gives_jax_latent_means(data, replay):
    Zj, params, draws = replay
    assert len(draws) == 1 + 10 + 1          # init, 10 steps, encode
    steps = iter(draws[1:11])
    X = twm._vae_data(data)
    model, history = twm._vae_train(
        X, (16, 4), twm.vae_params_from_flax(params),
        lambda shape: torch.as_tensor(next(steps)), 8, 1, 1e-3, 0, CPU)
    Zt = twm._vae_encode(model, X, CPU)
    assert Zt.dtype == np.float32 and Zt.shape == Zj.shape == (80, 4)
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    np.testing.assert_allclose(Zt, Zj, rtol=0,
                               atol=1e-5 * np.abs(Zj).max())


def test_init_matches_flax_statistics():
    """The LeCun-normal init: flax's mean, variance and truncation at two
    standard deviations, for a 784 x 400 kernel."""
    import flax.linen as nn

    fan_in, fan_out = 784, 400
    k = np.asarray(nn.initializers.lecun_normal()(
        jax.random.PRNGKey(0), (fan_in, fan_out), jnp.float32))
    w = twm._lecun_normal(fan_in, fan_out,
                          torch.Generator().manual_seed(0)).numpy()
    assert w.shape == (fan_out, fan_in) and w.dtype == np.float32
    std = np.sqrt(1.0 / fan_in)
    se = std / np.sqrt(w.size)
    assert abs(w.mean()) < 5 * se and abs(k.mean()) < 5 * se
    assert abs(w.var() / std**2 - 1) < 0.01
    assert abs(w.var() / k.var() - 1) < 0.01
    limit = 2 * std / twm._TRUNC_STD
    assert np.abs(w).max() <= limit * (1 + 1e-6)
    assert np.abs(k).max() <= limit * (1 + 1e-6)
    sd = twm._vae_init(30, 16, 4, torch.Generator().manual_seed(0))
    assert all(not v.any() for n, v in sd.items() if n.endswith("bias"))


def test_vae_binds_as_jax():
    assert list(inspect.signature(twm.vae).parameters) == (
        list(inspect.signature(jwm.vae).parameters) + ["device"])


def test_vae_embedding_separates(data):
    """The JAX package's separation test, on the port; ``no_cuda=True``
    asks for the CPU."""
    rs = np.random.RandomState(0)
    A = np.abs(rs.randn(80, 30))
    B = np.abs(rs.randn(80, 30)) + 4.0
    X = np.vstack([A, B])
    Z = twm.vae(X, layer_widths=(32, 4), epochs=15, seed=0, no_cuda=True)
    assert Z.shape == (160, 4) and Z.dtype == np.float32
    mA, mB = Z[:80].mean(0), Z[80:].mean(0)
    spread = 0.5 * (Z[:80].std() + Z[80:].std())
    assert np.linalg.norm(mA - mB) > spread
    np.testing.assert_array_equal(
        twm.vae(X, layer_widths=(32, 4), epochs=15, seed=0, device="cpu"), Z)
