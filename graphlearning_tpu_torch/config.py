"""Device and dtype policy for graphlearning_tpu_torch.

The port runs on CUDA. It never falls back to the CPU on its own: with no
GPU present, an entry point raises unless the caller asked for the CPU,
either by passing ``device="cpu"`` or by calling ``set_device("cpu")``
once (the tests do the former).

The working float dtype follows the device, mirroring
``graphlearning_tpu.config.float_dtype`` (x64 on for CPU parity tests, f32
on the accelerator): float64 on the CPU, float32 on CUDA.
"""

from __future__ import annotations

import contextlib

import torch

# Index dtype of graph columns and plans (the kernels take int32).
index_dtype = torch.int32

_default_device: torch.device | None = None


def set_device(dev) -> None:
    """Set the device that entry points use when none is passed
    (``None`` restores the CUDA default)."""
    global _default_device
    _default_device = None if dev is None else torch.device(dev)


def device(dev=None) -> torch.device:
    """Resolve the device an entry point runs on: ``dev`` if given, else
    the ``set_device`` choice, else ``cuda``.  Raises when that is CUDA and
    no GPU is present.  A CUDA device comes back with its index (``cuda``
    names the current one), so equal devices compare and print equal."""
    if dev is not None:
        d = torch.device(dev)
    elif _default_device is not None:
        d = _default_device
    else:
        d = torch.device("cuda")
    if d.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "graphlearning_tpu_torch runs on CUDA and no CUDA device is "
                "available; pass device='cpu' or call "
                "graphlearning_tpu_torch.config.set_device('cpu') to run on "
                "the CPU")
        if d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
    return d


def float_dtype(dev) -> torch.dtype:
    """Working float dtype on ``dev``: float64 on the CPU (parity with the
    JAX package under x64), float32 on CUDA."""
    return torch.float64 if torch.device(dev).type == "cpu" else torch.float32


def generator(key, dev) -> torch.Generator:
    """The ``torch.Generator`` that stands where the JAX package takes a
    PRNG key: ``key`` itself when it is one, else one on ``dev`` seeded
    with the integer ``key``."""
    if isinstance(key, torch.Generator):
        return key
    return torch.Generator(device=dev).manual_seed(int(key))


@contextlib.contextmanager
def exact_matmul():
    """Float32 matrix products in full f32 (no TF32) inside the block,
    whatever the caller's ``torch.set_float32_matmul_precision``: the
    counterpart of the JAX package's ``Precision.HIGHEST`` products."""
    old = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old)
