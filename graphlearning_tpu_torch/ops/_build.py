"""Build and load the CUDA kernels of ``graphlearning_tpu_torch/csrc``.

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface under ``graphlearning_tpu_torch/build/`` (listed
in ``.gitignore``) on first use, and loaded with ctypes.  :func:`build`
starts one ``nvcc`` per stale source, all at once.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# library -> {C function: argtypes}; every function returns a cudaError_t.
SIGNATURES = {
    "band_tiles_build": {
        "glt_tiles_build": [_P, _P, _I, _P, _P, _L, _I, _I, _P, _I, _P]},
    "band_tiles_spmm": {
        "glt_tiles_spmm":
            [_P, _I, _L, _I, _P, _P, _P, _I, _I, _L, _P, _I, _P, _L, _P],
        "glt_tiles_spmm_rowq":
            [_P, _I, _P, _I, _P, _P, _P, _I, _I, _L, _P, _I, _P, _L, _P],
        "glt_tiles_spmm_i8":
            [_P, _P, _I, _P, _P, _P, _I, _I, _L, _P, _I, _P, _L, _P],
        "glt_rect_spmm":
            [_P, _I, _I, _I, _P, _P, _P, _L, _P, _I, _P, _L, _P]},
    "band_rect_build": {
        "glt_rect_build": [_P, _P, _I, _P, _L, _I, _I, _I, _P, _I, _P]},
    "band_tiles_minplus": {
        "glt_tiles_minplus":
            [_P, _I, _I, _I, _P, _P, _P, _L, _P, _P, _P, _P, _I, _I, _I,
             _P]},
    "band_tiles_lip": {
        "glt_tiles_lip":
            [_P, _I, _I, _I, _P, _P, _P, _L, _P, _I, _P, _P, _P, _P]},
    "band_ell_spmm": {
        "glt_ell_spmm": [_P, _P, _I, _I, _P, _L, _I, _I, _P, _I, _P, _P]},
    "band_rect_minplus": {
        "glt_rect_minplus":
            [_P, _I, _I, _I, _P, _P, _P, _L, _P, _P, _P, _P, _I, _I, _I,
             _P]},
}

_loaded: dict = {}


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "graphlearning_tpu_torch need the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    src = CSRC / f"{name}.cu"
    return not lib.is_file() or lib.stat().st_mtime < src.stat().st_mtime


def build(names=tuple(SIGNATURES)) -> dict:
    """Compile the stale sources among ``names`` in parallel.  Returns
    ``{name: ptxas report}`` for what was built; raises with the compiler
    output on failure."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.{os.getpid()}.{time.time_ns()}.so"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{output}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, library_path(name))     # atomic: concurrent builds
        reports[name] = output
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def load(name: str):
    """The ctypes library of source ``name``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        for fname, argtypes in SIGNATURES[name].items():
            fn = getattr(lib, fname)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded[name] = lib
    return lib
