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
import dataclasses
from typing import Any, Optional, Tuple

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


def is_tpu() -> bool:
    """Always False: the port runs on CUDA or the CPU (the JAX package's
    ``config.is_tpu`` asks its backend)."""
    return False


_SHARDED_KERNELS = ("auto", "banded", "gspmd")
_BAND_MODES = ("f64", "f32", "bf16")


@dataclasses.dataclass(frozen=True)
class GLTConfig:
    """Execution config of the distribution layer, with the JAX package's
    fields and defaults (``graphlearning_tpu/config.py:55-104``).

    * ``mesh_shape``, ``mesh_axes``, ``node_axis``, ``devices``: the mesh
      (:meth:`parallel.mesh.Mesh.from_config`): the ranks of the process
      group in row-major order over ``mesh_shape`` (None: all of them
      along the first axis), e.g. ``(Pn, Pb)`` over ``("nodes",
      "batch")``; the graphs are sharded over ``node_axis`` and
      replicated over the other axis.  ``devices`` is this rank's device,
      or a sequence indexed by the rank; None takes the default device
      (:func:`device`), on CUDA the card of the rank's ``LOCAL_RANK``.
    * ``sharded_kernel``: "auto", "banded" or "gspmd"
      (:meth:`parallel.execute.Distributor.operator`).
    * ``band_R``, ``band_WT``: the partitioned band's geometry, None for
      512 on CUDA and 64 on the CPU.
    * ``band_mode``: None for "f64" on the CPU and "f32" on CUDA (the
      exact grade: K3's f32 sums by FFMA at d <= 16), or "bf16" (a bf16
      band and X, f32 sums).  The JAX package's "bf16x3" emulates f32 on
      the TPU's matrix unit and is not ported: it raises ``ValueError``.
    * ``band_max_residual``: "auto" takes the band only while the edges
      outside the halos are at most this share.
    * ``dtype``: the sharded fits' float dtype, None for the device's
      :func:`float_dtype`.  ``cg_tol`` and ``cg_max_iter`` are the JAX
      package's fields, which no fit reads there or here: each model keeps
      its own tolerance.
    """

    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axes: Tuple[str, ...] = ("nodes",)
    node_axis: str = "nodes"
    devices: Any = None

    sharded_kernel: str = "auto"
    band_R: Optional[int] = None
    band_WT: Optional[int] = None
    band_mode: Optional[str] = None
    band_max_residual: float = 0.02

    dtype: Any = None
    cg_tol: Optional[float] = None
    cg_max_iter: int = 10**5

    def __post_init__(self):
        if self.sharded_kernel not in _SHARDED_KERNELS:
            raise ValueError(f"sharded_kernel must be one of "
                             f"{_SHARDED_KERNELS}, not "
                             f"{self.sharded_kernel!r}")
        if self.band_mode == "bf16x3":
            raise ValueError("band_mode 'bf16x3' (f32 emulated on the TPU's "
                             "matrix unit) is not ported; 'f32' is the "
                             "exact grade on CUDA")
        if self.band_mode is not None and self.band_mode not in _BAND_MODES:
            raise ValueError(f"band_mode must be None or one of "
                             f"{_BAND_MODES}, not {self.band_mode!r}")

    def resolve_dtype(self, dev=None):
        """``dtype``, else the working float dtype on ``dev`` (the default
        device when None)."""
        return self.dtype if self.dtype is not None else float_dtype(
            device(dev))

    def make_mesh(self):
        """The :class:`parallel.mesh.Mesh` this config describes."""
        from graphlearning_tpu_torch.parallel.mesh import Mesh

        return Mesh.from_config(self)
