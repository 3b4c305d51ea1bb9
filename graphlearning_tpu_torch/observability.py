"""Tracing, timing and throughput counters (counterpart of
``graphlearning_tpu/observability.py``).

* :func:`trace` -- context manager around ``torch.profiler`` (CPU and, where
  a GPU is present, CUDA activity) writing a Chrome-format trace that
  TensorBoard and Perfetto read.
* :class:`Timer` -- wall-clock timer that synchronizes the CUDA device of
  the tensors it is given before reading the clock.
* :func:`benchmark` -- warm-up-then-measure harness reporting seconds per
  call and, for graph operations, edges per second.
* :class:`Counters` -- process-global named counters and gauges with a
  printable summary.
* :class:`span` -- a named interval at a layer boundary of the program:
  always counted in :data:`counters` (``<name>`` and ``<name>.s``); while
  a ``torch.profiler`` records, also kept (:func:`spans`) and shown as a
  range of its own name on the profiler's timeline.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from typing import Callable, Optional

import torch


def _cuda_devices(tree):
    """The CUDA devices of the tensors in ``tree`` (nested lists, tuples
    and dicts), in first-seen order."""
    found = []
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.is_cuda and x.device not in found:
                found.append(x.device)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return found


def _block_until_ready(tree):
    """Wait for the work that produces the CUDA tensors of ``tree`` (the
    counterpart of ``jax.block_until_ready``)."""
    for dev in _cuda_devices(tree):
        torch.cuda.synchronize(dev)
    return tree


@contextlib.contextmanager
def trace(logdir: str, create_perfetto_link: bool = False):
    """Profile the enclosed block with ``torch.profiler`` and write its
    trace to ``logdir/trace_<pid>_<ns>.json``.

    View it with TensorBoard or open it in ui.perfetto.dev.
    ``create_perfetto_link`` is accepted, as in the JAX package, and does
    nothing: a link would need the network."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


class Timer:
    """Device-synchronized timer: ``with Timer(sync=out) as t: ...;
    t.seconds``.  ``sync`` is a tensor or a tree of tensors; on leaving the
    block their CUDA devices are synchronized before the clock is read."""

    def __init__(self, sync=None):
        self._sync = sync

    def __enter__(self):
        self.seconds = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync is not None:
            _block_until_ready(self._sync)
        self.seconds = time.perf_counter() - self._t0
        return False


def benchmark(fn: Callable, *args, iters: int = 10, warmup: int = 1,
              edges: Optional[int] = None, chain: bool = False):
    """Time ``fn(*args)``: ``warmup`` calls, then ``iters`` timed ones.

    ``chain=True`` feeds each output back as the first argument (pure
    iteration kernels run back to back).  Each phase ends with a CUDA
    synchronize of its outputs' devices.  Returns ``{"seconds_per_call",
    "iters"}`` and, when ``edges`` is given, ``"edges_per_sec"``."""
    _block_until_ready(fn(*args))
    for _ in range(warmup - 1):
        _block_until_ready(fn(*args))
    t0 = time.perf_counter()
    if chain:
        y = args[0]
        for _ in range(iters):
            y = fn(y, *args[1:])
        _block_until_ready(y)
    else:
        for _ in range(iters):
            out = fn(*args)
        _block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    result = {"seconds_per_call": dt, "iters": iters}
    if edges is not None:
        result["edges_per_sec"] = edges / dt
    return result


class Counters:
    """Named scalar counters (monotonic adds) + gauges (last value)."""

    def __init__(self):
        self._counts = collections.defaultdict(float)
        self._gauges = {}

    def add(self, name: str, value: float = 1.0):
        self._counts[name] += float(value)

    def gauge(self, name: str, value: float):
        self._gauges[name] = float(value)

    def get(self, name: str) -> float:
        if name in self._counts:
            return self._counts[name]
        return self._gauges.get(name, 0.0)

    def summary(self) -> str:
        lines = [f"{k}: {v:g}" for k, v in sorted(self._counts.items())]
        lines += [f"{k}: {v:g} (gauge)" for k, v in sorted(self._gauges.items())]
        return "\n".join(lines)

    def reset(self):
        self._counts.clear()
        self._gauges.clear()


#: process-global counter registry
counters = Counters()


#: the counters whose change over its life a recorded root span keeps
ROOT_COUNTERS = ("cg.steps", "host_reads")

_RECORDS = collections.deque(maxlen=1 << 16)
_IDS = itertools.count(1)
_OPEN = threading.local()
_profiling = torch.autograd._profiler_enabled
_clock = time.perf_counter_ns


class span:
    """``with span(name, **attrs) as sp: ...`` -- one interval of the
    program's work.

    Always: adds 1 to ``counters[name]`` and the seconds it lasted to
    ``counters[name + ".s"]``.  While a torch profiler records
    (``torch.autograd._profiler_enabled()``), it also opens
    ``torch.profiler.record_function(name)``, so that it sits on the
    profiler's timeline, and on leaving keeps a record (:func:`spans`):
    ``name``, ``id``, ``parent`` (the enclosing recorded span's id, or
    None), ``root`` (the outermost's id, shared by a whole call),
    ``start_ns`` and ``end_ns`` on the profiler's clock (Unix time, read
    around the range), ``attrs``, and for a root the change of each of
    :data:`ROOT_COUNTERS` over its life (``counts``).  ``sp.set(**attrs)``
    adds attributes known only inside the block."""

    __slots__ = ("name", "attrs", "_t0", "_rec", "_rf", "_base")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs
        self._rec = None

    def set(self, **attrs):
        self.attrs.update(attrs)

    def __enter__(self):
        if _profiling():
            stack = getattr(_OPEN, "stack", None)
            if stack is None:
                stack = _OPEN.stack = []
            sid = next(_IDS)
            parent = stack[-1] if stack else None
            self._rec = {"name": self.name, "id": sid,
                         "parent": None if parent is None else parent["id"],
                         "root": sid if parent is None else parent["root"]}
            if parent is None:
                self._base = [counters.get(c) for c in ROOT_COUNTERS]
            stack.append(self._rec)
            self._rf = torch.profiler.record_function(self.name)
            self._rec["start_ns"] = time.time_ns()
            self._rf.__enter__()
        self._t0 = _clock()
        return self

    def __exit__(self, exc_type, exc, tb):
        dt = _clock() - self._t0
        counts = counters._counts
        counts[self.name] += 1.0
        counts[self.name + ".s"] += dt * 1e-9
        rec = self._rec
        if rec is not None:
            self._rf.__exit__(exc_type, exc, tb)
            rec["end_ns"] = time.time_ns()
            rec["attrs"] = self.attrs
            if rec["parent"] is None:
                rec["counts"] = {c: counters.get(c) - b for c, b in
                                 zip(ROOT_COUNTERS, self._base)}
            _OPEN.stack.pop()
            _RECORDS.append(rec)
        return False


def spans(clear: bool = False) -> list:
    """The records of the spans that ended while a profiler recorded,
    oldest first (the last 65536 kept); ``clear`` empties the buffer."""
    out = list(_RECORDS)
    if clear:
        _RECORDS.clear()
    return out
