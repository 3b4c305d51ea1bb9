"""Solver-state checkpoint and resume (counterpart of
``graphlearning_tpu/checkpoint.py``).

A state is a tuple (possibly nested) of tensors, ints, floats and bools.
:func:`save` writes it with ``torch.save`` to one file in the directory at
``path`` (the JAX package writes an orbax directory there), its tensors
copied to the host first; :func:`load` reads it back with
``weights_only=True``.  :func:`run_checkpointed` and
:func:`run_checkpointed_while` run a ``state -> state`` iteration in
segments, saving after each, and a run restarted on the same path goes on
from the last save.
"""

from __future__ import annotations

import os
from typing import Any, Callable

import torch

_FILE = "state.pt"


def _ckpt_dir(path: str) -> str:
    return os.path.abspath(path)


def _map(fn, tree):
    """``fn`` over the leaves of nested tuples and lists, keeping the
    structure as tuples."""
    if isinstance(tree, (tuple, list)):
        return tuple(_map(fn, t) for t in tree)
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [leaf for t in tree for leaf in _leaves(t)]
    return [tree]


def _unflatten(like, leaves):
    """``leaves`` (in order) in the tuple structure of ``like``."""
    it = iter(leaves)

    def put(t):
        if isinstance(t, (tuple, list)):
            return tuple(put(s) for s in t)
        return next(it)

    return put(like)


def _sync(state):
    """Wait for the card's work on ``state`` (the JAX package's
    ``block_until_ready``)."""
    if any(isinstance(leaf, torch.Tensor) and leaf.is_cuda
           for leaf in _leaves(state)):
        torch.cuda.synchronize()


def save(path: str, state: Any, step: int = 0) -> None:
    """Save a solver state (and its step) in the directory ``path``.  The
    file is written under another name and renamed, so a kill during the
    write leaves the last save whole."""
    d = _ckpt_dir(path)
    os.makedirs(d, exist_ok=True)
    host = _map(lambda x: x.detach().cpu() if isinstance(x, torch.Tensor)
                else x, state)
    tmp = os.path.join(d, _FILE + ".tmp")
    torch.save({"state": host, "step": int(step)}, tmp)
    os.replace(tmp, os.path.join(d, _FILE))


def load(path: str, like: Any = None):
    """``(state, step)`` saved by :func:`save` in ``path``, or None when
    nothing is there.  With ``like`` (a state of the same structure) the
    leaves come back in its structure, each tensor on the device of
    ``like``'s leaf at its place."""
    f = os.path.join(_ckpt_dir(path), _FILE)
    if not os.path.exists(f):
        return None
    saved = torch.load(f, weights_only=True)
    state = saved["state"]
    if like is not None:
        leaves = [x.to(ref.device) if isinstance(x, torch.Tensor)
                  and isinstance(ref, torch.Tensor) else x
                  for x, ref in zip(_leaves(state), _leaves(like))]
        state = _unflatten(like, leaves)
    return state, int(saved["step"])


def run_checkpointed(step_fn: Callable, state: Any, num_steps: int,
                     path: str, every: int = 100, resume: bool = True):
    """Run ``state = step_fn(state)`` ``num_steps`` times, saving the state
    every ``every`` steps; with ``resume`` a run restarted on the same
    ``path`` goes on from its last save.  Returns ``(final_state,
    steps_run)``."""
    start = 0
    if resume:
        restored = load(path, like=state)
        if restored is not None:
            state, start = restored
    step = start
    while step < num_steps:
        seg = min(every, num_steps - step)
        for _ in range(seg):
            state = step_fn(state)
        _sync(state)
        step += seg
        save(path, state, step)
    return state, step


def run_checkpointed_while(step_fn: Callable, state: Any, done_fn: Callable,
                           max_steps: int, path: str, every: int = 10,
                           resume: bool = True):
    """:func:`run_checkpointed` for a loop that ends on its data: run
    ``state = step_fn(state)`` until ``done_fn(state)`` is truthy, which is
    read between segments, so a segment may run up to ``every - 1`` steps
    past the end: ``step_fn`` must leave a finished state as it is.
    Returns ``(final_state, steps_run)``."""
    start = 0
    if resume:
        restored = load(path, like=state)
        if restored is not None:
            state, start = restored
    step = start
    while step < max_steps and not bool(done_fn(state)):
        seg = min(every, max_steps - step)
        for _ in range(seg):
            state = step_fn(state)
        _sync(state)
        step += seg
        save(path, state, step)
    return state, step
