"""Volume-constrained label assignment and the MBO loops (counterpart of
``graphlearning_tpu/solvers/volume.py``).

* :func:`assign_labels`: labels ``argmax_c (a_ic + p_c)`` whose class
  counts lie in ``[lower, upper]``, by a batched dual price ascent, then
  an exact repair that moves the nodes losing least score.
* :func:`projection_weights`: the class-size gradient loop of the
  ``ssl`` models' volume projection.
* :func:`poisson_mbo_loop` / :func:`poisson_mbo_round`: PoissonMBO's
  outer rounds (heat diffusion, volume projection, threshold).
* :func:`mbo_loop` / :func:`mbo_round`: VolumeMBO's fixed point (dual
  convolution, annealed Gumbel noise, assignment).

Both outer loops optionally save their state every few rounds
(:mod:`checkpoint`); saved or not, they run the same rounds.

The JAX package runs each loop as a ``lax.while_loop`` on the device.
Here the loops keep their state on the device too (:func:`_while`): each
step computes its successor and keeps it only where the loop's condition
held, so the state freezes once the condition fails, and the host reads
the condition after 1, 2, 4, ... and then every ``_CHECK_EVERY`` steps.
The results are those of a loop that stops at once, with few host
synchronisations (the price ascent alone may take 500 steps in each of
300 MBO iterations).  On a sharded solve (``parallel.execute``) the
PoissonMBO loop takes ``valid``, the mask of real rows (mesh padding
stays out of the class sizes and the score scaling), and ``reduce``, the
sum (or max) over the ranks; every rank then reads the same condition.
The VolumeMBO loop there runs whole on every rank, in the operator's
padded row space, on the all-gathered dual convolution: ``valid`` keeps
the padding rows out of the class counts and frozen, as the JAX package's
sharded loop does.
"""

from __future__ import annotations

import torch

from graphlearning_tpu_torch import checkpoint as _checkpoint

_CHECK_EVERY = 16


def _while(cond, body, state):
    """``while cond(state): state = body(state)`` for a tuple of device
    tensors.  ``cond`` gives a 0-d bool tensor, false again for a state
    it rejected (each loop counts its steps in its state).  Returns the
    state at which ``cond`` first failed."""
    if not bool(cond(state)):
        return state
    burst = 1
    while True:
        for _ in range(burst):
            active = cond(state)
            state = tuple(torch.where(active, new, old)
                          for new, old in zip(body(state), state))
        if not bool(cond(state)):
            return state
        burst = min(2 * burst, _CHECK_EVERY)


def _counts(labels, k, dtype, valid=None):
    """Class counts of ``labels``, the rows outside ``valid`` left out."""
    if valid is None:
        return torch.bincount(labels, minlength=k).to(dtype)
    labels = torch.where(valid, labels, torch.full_like(labels, k))
    return torch.bincount(labels, minlength=k + 1)[:k].to(dtype)


def assign_labels(a, fixed_mask, fixed_labels, lower, upper,
                  max_price_it: int = 500, valid=None):
    """Volume-constrained assignment of the (n, k) affinities ``a``:
    int64 labels of shape (n,) with ``lower <= counts <= upper``, the
    nodes of ``fixed_mask`` pinned to ``fixed_labels``.  Price ascent
    (prices frozen once feasible, so the final argmax reproduces the
    feasible labeling), then the repair: each round moves up to
    ``min(over, under, 128)`` movable nodes of the most over-full class to
    the most under-full one, those losing least score first (ties to the
    lower index, as ``lax.top_k``).  Rows outside ``valid`` (mesh padding)
    are left out of the counts and never moved."""
    n, k = a.shape
    dev, dt = a.device, a.dtype
    scale = torch.max(a) - torch.min(a) + 1e-8
    neg_big = torch.finfo(dt).min
    fixed_labels = fixed_labels.long()
    count = lambda labels: _counts(labels, k, dt, valid)

    def pbody(state):
        p, it, done = state
        labels = torch.where(fixed_mask, fixed_labels,
                             torch.argmax(a + p[None, :], dim=1))
        counts = count(labels)
        over = torch.clamp(counts - upper, min=0.0)
        under = torch.clamp(lower - counts, min=0.0)
        done = torch.max(over + under) == 0
        p_new = p + scale * 0.5 * ((under - over) / n)
        p_new = p_new - torch.mean(p_new)
        return torch.where(done, p, p_new), it + 1, done

    p, _, _ = _while(
        lambda s: ~s[2] & (s[1] < max_price_it), pbody,
        (torch.zeros(k, dtype=dt, device=dev),
         torch.zeros((), dtype=torch.int64, device=dev),
         torch.zeros((), dtype=torch.bool, device=dev)))
    labels = torch.where(fixed_mask, fixed_labels,
                         torch.argmax(a + p[None, :], dim=1))

    krep = int(min(128, n))
    ranks = torch.arange(krep, device=dev)

    def bad(labels):
        counts = count(labels)
        return torch.any(counts > upper) | torch.any(counts < lower)

    def rbody(state):
        labels, it = state
        counts = count(labels)
        co = torch.argmax(counts - upper)          # most over-full
        cu = torch.argmax(lower - counts)          # most under-full
        both = torch.minimum(torch.clamp(counts[co] - upper[co], min=0.0),
                             torch.clamp(lower[cu] - counts[cu], min=0.0))
        t = torch.clamp(both, 1.0, float(krep)).long()
        movable = (labels == co) & ~fixed_mask
        if valid is not None:
            movable = movable & valid
        margin = torch.where(movable, a.index_select(1, cu.view(1))[:, 0]
                             - a.index_select(1, co.view(1))[:, 0], neg_big)
        vals, idx = torch.sort(margin, descending=True, stable=True)
        vals, idx = vals[:krep], idx[:krep]
        take = (ranks < t) & (vals > neg_big)
        labels = labels.clone()
        labels[idx] = torch.where(take, cu, labels[idx])
        return labels, it + 1

    labels, _ = _while(lambda s: bad(s[0]) & (s[1] < n), rbody,
                       (labels, torch.zeros((), dtype=torch.int64,
                                            device=dev)))
    return labels


def _reducer(reduce):
    return (lambda t, op="sum": t) if reduce is None else reduce


def projection_weights(scores, weights, priors, dt, *, similarity: bool,
                       valid=None, reduce=None):
    """The class-size gradient loop: ``w += dt (class_size(w) - priors)``,
    ``w /= w[0]`` until ``max|grad| <= 1e-3`` or 1e4 steps, the class of
    a node being the argmax (``similarity``) or argmin of ``scores * w``.
    ``scores`` are normalized to [0, 1] by the caller.  ``valid`` leaves
    rows out of the class sizes; ``reduce`` sums them over the ranks.
    Returns ``(w, err)``, ``err`` a 0-d tensor."""
    n, k = scores.shape
    pick = torch.argmax if similarity else torch.argmin
    red = _reducer(reduce)
    if valid is not None:
        n = red(torch.sum(valid).to(scores.dtype))

    def class_counts(pred):
        if valid is None:
            return red(_counts(pred, k, scores.dtype))
        pred = torch.where(valid, pred, torch.full_like(pred, k))
        return red(_counts(pred, k + 1, scores.dtype)[:k])

    def body(state):
        w, err, i = state
        pred = pick(scores * w[None, :], dim=1)
        grad = class_counts(pred) / n - priors
        w = w + dt * grad
        return w / w[0], torch.max(torch.abs(grad)), i + 1

    w, err, _ = _while(
        lambda s: (s[2] < 10**4) & (s[1] > 1e-3), body,
        (weights, torch.ones((), dtype=scores.dtype, device=scores.device),
         torch.zeros((), dtype=torch.int64, device=scores.device)))
    return w, err


def _onehot(labels, k, dtype):
    return torch.nn.functional.one_hot(labels.long(), k).to(dtype)


def poisson_mbo_round(heat_steps, state, priors, valid=None, reduce=None):
    """One PoissonMBO round on a ``(u, w, err)`` state: ``heat_steps``
    ((n, k) -> (n, k)), the scores normalized to [0, 1], the projection
    weights warm-started from ``w``, and the one-hot threshold.  Rows
    outside ``valid`` stay 0 and out of the scaling and the class sizes;
    ``reduce`` takes the sums and extremes over the ranks."""
    u, w, err = state
    u = heat_steps(u)
    red = _reducer(reduce)
    if valid is None:
        s = u - torch.min(u)
    else:
        v = valid[:, None]
        u = torch.where(v, u, torch.zeros((), dtype=u.dtype,
                                          device=u.device))
        inf = torch.full_like(u, float("inf"))
        umin = -red(-torch.min(torch.where(v, u, inf)), "max")
        s = torch.where(v, u - umin, torch.zeros_like(u))
    m = red(torch.max(s), "max")
    s = torch.where(m > 0, s / m, s)
    w, err = projection_weights(s, w, priors, -0.1, similarity=True,
                                valid=valid, reduce=reduce)
    oh = _onehot(torch.argmax(s * w[None, :], dim=1), u.shape[1], u.dtype)
    if valid is not None:
        oh = torch.where(valid[:, None], oh, torch.zeros_like(oh))
    return oh, w, err


def poisson_mbo_loop(heat_steps, u0, w0, priors, T: int, ckpt=None,
                     valid=None, reduce=None, on_round=None):
    """T PoissonMBO rounds (:func:`poisson_mbo_round`) from ``(u0, w0)``;
    the projection weights thread through the rounds.  With ``ckpt =
    (path, every)`` the state is saved every ``every`` rounds and a run
    restarted on ``path`` goes on from its last save
    (:func:`checkpoint.run_checkpointed`).  ``valid`` and ``reduce``: a
    sharded loop's (:func:`poisson_mbo_round`).  ``on_round(i, state)``,
    when given, is called after round ``i`` (not with ``ckpt``).  Returns
    ``(u, w, err)``."""
    state = (u0, w0, torch.ones((), dtype=u0.dtype, device=u0.device))

    def step(state):
        return poisson_mbo_round(heat_steps, state, priors, valid=valid,
                                 reduce=reduce)

    if ckpt is not None:
        path, every = ckpt
        return _checkpoint.run_checkpointed(step, state, int(T), path,
                                            every=every)[0]
    for i in range(int(T)):
        state = step(state)
        if on_round is not None:
            on_round(i, state)
    return state


def gumbel(generator, dtype):
    """The default noise of :func:`mbo_round`: ``draw(shape)`` gives
    standard Gumbel variates from ``generator``, on its device.  The
    uniform is clamped to the smallest normal, as ``jax.random.gumbel``
    draws it from ``[tiny, 1)``: ``torch.rand`` may return 0."""
    tiny = torch.finfo(dtype).tiny

    def draw(shape):
        u = torch.rand(shape, generator=generator, dtype=dtype,
                       device=generator.device)
        return -torch.log(-torch.log(torch.clamp(u, min=tiny)))

    return draw


def mbo_round(dual_conv, state, fixed_mask, fixed_labels, lower, upper,
              temp, draw, n_true: int, max_price_it: int = 500, valid=None):
    """One VolumeMBO iteration on a ``(labels, it, stop)`` state: the dual
    convolution of the labels, with ``temp > 0`` the annealed noise
    ``temp / (it + 1) * draw(shape) / n_true`` added, and the
    volume-constrained assignment.  ``stop`` once no label changed (past
    ten iterations with noise).  ``draw`` is called once per iteration
    with noise, in order.  Rows outside ``valid`` keep their labels."""
    labels, it, _ = state
    a = dual_conv(labels)
    if temp > 0:
        a = a + (temp / (it + 1.0)) * draw(a.shape) / n_true
    new_labels = assign_labels(a, fixed_mask, fixed_labels, lower, upper,
                               max_price_it=max_price_it, valid=valid)
    if valid is not None:
        new_labels = torch.where(valid, new_labels, labels)
    changed = int(torch.sum(new_labels != labels))
    return new_labels, it + 1, changed == 0 and (temp == 0 or it > 10)


def mbo_loop(dual_conv, labels0, fixed_mask, fixed_labels, lower, upper,
             temp, draw, n_true: int, max_iters: int,
             max_price_it: int = 500, on_round=None, ckpt=None,
             generator=None, valid=None):
    """The VolumeMBO fixed point: :func:`mbo_round` from ``labels0`` until
    it stops or ``max_iters`` iterations.  ``dual_conv``: (n,) labels ->
    (n, k) affinities.  ``on_round(old labels, state)``, when given, is
    called after each iteration.  With ``ckpt = (path, every)`` the state
    is saved every ``every`` iterations with the state of ``generator``
    (the one ``draw`` reads), and a run restarted on ``path`` goes on from
    its last save with the same noise
    (:func:`checkpoint.run_checkpointed_while`).  ``valid``: the rows that
    count and move (:func:`mbo_round`).  Returns ``(labels, iters)``."""

    def step(state):
        if state[2]:
            return state            # a stopped state is left as it is
        if ckpt is not None:
            generator.set_state(state[3])
        new = mbo_round(dual_conv, state[:3], fixed_mask, fixed_labels,
                        lower, upper, temp, draw, n_true=n_true,
                        max_price_it=max_price_it, valid=valid)
        if on_round is not None:
            on_round(state[0], new)
        return new if ckpt is None else new + (generator.get_state(),)

    state = (labels0.long(), 0, False)
    if ckpt is not None:
        path, every = ckpt
        state, _ = _checkpoint.run_checkpointed_while(
            step, state + (generator.get_state(),), lambda st: st[2],
            max_iters, path, every=every)
    else:
        while not state[2] and state[1] < max_iters:
            state = step(state)
    return state[0], state[1]
