"""The exact serial host oracles (counterpart of
``graphlearning_tpu/native/__init__.py``).

``oracles.cpp`` is compiled by ``g++ -O3 -shared -fPIC -std=c++17`` on
first use into ``graphlearning_tpu_torch/build/liboracles.so`` (listed in
``.gitignore``), again whenever the source is newer than the library, and
loaded with ctypes.  A failed build raises with the compiler's output;
nothing falls back.  The wrappers take and return numpy arrays on the
host, with the JAX package's parameters and defaults: they are the
references that the device solvers are held to, not a path of any fit.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "oracles.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
LIBRARY = BUILD_DIR / "liboracles.so"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_lock = threading.Lock()

_P64 = ctypes.POINTER(ctypes.c_int64)
_P32 = ctypes.POINTER(ctypes.c_int32)
_PD = ctypes.POINTER(ctypes.c_double)
_I, _D = ctypes.c_int32, ctypes.c_double
_CSR = [_P64, _P32, _PD, _I]             # row_ptr, col_idx, weights, n

# C function -> argtypes, as ``oracles.cpp`` declares them (all void)
SIGNATURES = {
    "dijkstra_oracle": _CSR + [_P32, _PD, _I, _PD, _D, _I, _PD, _P32],
    "peikonal_oracle": _CSR + [_P32, _PD, _I, _PD, _D, _I, _D, _I, _PD],
    "peikonal_fmm_oracle": _CSR + [_P32, _PD, _I, _PD, _D, _I, _PD],
    "lip_iterate_oracle": _CSR + [_P32, _PD, _I, _D, _D, _I, _I, _D, _I,
                                  _PD],
    "auction_oracle": [_PD, _I, _I, _P32, _P32, _D, _D, _D, _P32],
}


def _stale() -> bool:
    return (not LIBRARY.is_file()
            or LIBRARY.stat().st_mtime < _SRC.stat().st_mtime)


def build() -> bool:
    """Compile ``oracles.cpp`` when the library is missing or older than
    the source.  Returns whether it compiled; raises ``RuntimeError`` with
    the compiler's output when ``g++`` fails."""
    if not _stale():
        return False
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"liboracles.{os.getpid()}.{time.time_ns()}.so"
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", str(tmp)],
                              capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"g++ could not run to build {_SRC}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {_SRC}:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, LIBRARY)                # atomic: concurrent builds
    return True


def _load():
    """The ctypes library, built on first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(LIBRARY))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = None
            _lib = lib
    return _lib


def _csr_parts(W):
    import scipy.sparse as sp

    W = sp.csr_matrix(W)
    return (np.ascontiguousarray(W.indptr, dtype=np.int64),
            np.ascontiguousarray(W.indices, dtype=np.int32),
            np.ascontiguousarray(W.data, dtype=np.float64),
            W.shape[0])


def _graph_args(W, bdy_set):
    """The CSR pointers, ``n``, the boundary pointer and ``m``."""
    indptr, indices, data, n = _csr_parts(W)
    bdy_set = np.ascontiguousarray(np.asarray(bdy_set), dtype=np.int32)
    keep = (indptr, indices, data, bdy_set)     # alive through the call
    args = (indptr.ctypes.data_as(_P64), indices.ctypes.data_as(_P32),
            data.ctypes.data_as(_PD), ctypes.c_int32(n),
            bdy_set.ctypes.data_as(_P32))
    return keep, args, n, len(bdy_set)


def _per_node(f, n):
    if np.isscalar(f) or np.ndim(f) == 0:
        f = np.full(n, float(f))
    return np.ascontiguousarray(f, dtype=np.float64)


def _per_seed(v, m):
    if np.isscalar(v) or np.ndim(v) == 0:
        v = np.full(m, float(v))
    return np.ascontiguousarray(np.asarray(v), dtype=np.float64)


def dijkstra_host(W, bdy_set, bdy_val=None, f=1, max_dist=np.inf,
                  hopf_lax=False):
    """Exact serial Dijkstra on the host (oracle for the device
    Bellman-Ford iteration).  Returns ``(dist, cp)``."""
    keep, args, n, m = _graph_args(W, bdy_set)
    bdy_val = _per_seed(0.0 if bdy_val is None else bdy_val, m)
    f = _per_node(f, n)
    dist = np.full(n, np.inf)
    cp = np.full(n, -1, dtype=np.int32)
    _load().dijkstra_oracle(
        *args, bdy_val.ctypes.data_as(_PD), ctypes.c_int32(m),
        f.ctypes.data_as(_PD), ctypes.c_double(max_dist),
        ctypes.c_int32(1 if hopf_lax else 0), dist.ctypes.data_as(_PD),
        cp.ctypes.data_as(_P32))
    del keep
    return dist, cp


def peikonal_host(W, bdy_set, bdy_val=0, f=1, p=1.0, max_num_it=10**5,
                  tol=1e-3, num_bisection_it=30):
    """Exact serial Gauss-Seidel p-eikonal oracle."""
    keep, args, n, m = _graph_args(W, bdy_set)
    bdy_val = _per_seed(bdy_val, m)
    f = _per_node(f, n)
    u = np.zeros(n)
    _load().peikonal_oracle(
        *args, bdy_val.ctypes.data_as(_PD), ctypes.c_int32(m),
        f.ctypes.data_as(_PD), ctypes.c_double(p),
        ctypes.c_int32(int(max_num_it)), ctypes.c_double(tol),
        ctypes.c_int32(num_bisection_it), u.ctypes.data_as(_PD))
    del keep
    return u


def peikonal_fmm_host(W, bdy_set, bdy_val=0, f=1, p=1.0,
                      num_bisection_it=30):
    """Exact serial fast-marching p-eikonal oracle (heap-ordered
    single pass; reference intent ``c_code/hjsolvers.cpp:342-420``)."""
    keep, args, n, m = _graph_args(W, bdy_set)
    bdy_val = _per_seed(bdy_val, m)
    f = _per_node(f, n)
    u = np.full(n, np.inf)
    _load().peikonal_fmm_oracle(
        *args, bdy_val.ctypes.data_as(_PD), ctypes.c_int32(m),
        f.ctypes.data_as(_PD), ctypes.c_double(p),
        ctypes.c_int32(num_bisection_it), u.ctypes.data_as(_PD))
    del keep
    return u


def lip_iterate_host_mc(W, bdy_set, bdy_vals, alpha=0.0, beta=1.0,
                        weighted=False, max_num_it=10**5, tol=1e-6,
                        num_bisection_it=30):
    """One-vs-rest host Gauss-Seidel Lipschitz iteration, the C classes
    solved in parallel threads (ctypes releases the GIL during the C
    call).  ``bdy_vals``: (m, C); returns (n, C)."""
    from concurrent.futures import ThreadPoolExecutor

    bdy_vals = np.asarray(bdy_vals, dtype=float)
    C = bdy_vals.shape[1]
    _load()                       # build once before the threads start
    with ThreadPoolExecutor(max_workers=min(C, os.cpu_count() or 1)) as ex:
        cols = list(ex.map(
            lambda c: lip_iterate_host(
                W, bdy_set, bdy_vals[:, c], alpha=alpha, beta=beta,
                weighted=weighted, max_num_it=max_num_it, tol=tol,
                num_bisection_it=num_bisection_it),
            range(C)))
    return np.stack(cols, axis=1)


def lip_iterate_host(W, bdy_set, bdy_val, alpha=0.0, beta=1.0,
                     weighted=False, max_num_it=10**5, tol=1e-6,
                     num_bisection_it=30):
    """Exact serial Gauss-Seidel AMLE / game-theoretic p-Laplace oracle
    (reference intent ``c_code/lp_iterate.cpp:129-259``).  weighted=True
    solves ``min_j w(t-u_j) + max_j w(t-u_j) = 0`` per node by bisection;
    otherwise ``u = alpha*avg + beta*(min+max)/2``."""
    keep, args, n, m = _graph_args(W, bdy_set)
    bdy_val = _per_seed(bdy_val, m)
    u = np.zeros(n)
    _load().lip_iterate_oracle(
        *args, bdy_val.ctypes.data_as(_PD), ctypes.c_int32(m),
        ctypes.c_double(alpha), ctypes.c_double(beta),
        ctypes.c_int32(1 if weighted else 0),
        ctypes.c_int32(int(max_num_it)), ctypes.c_double(tol),
        ctypes.c_int32(num_bisection_it), u.ctypes.data_as(_PD))
    del keep
    return u


def auction_host(a, target, fixed=None, eps0=None, eps_min=1e-6, scale=4.0):
    """Volume-constrained assignment oracle: Bertsekas forward auction with
    eps-scaling and per-class capacities (reference intent
    ``c_code/mbo_convolution.cpp:248-316``).  Maximizes ``sum_i a[i, c_i]``
    subject to exact class counts ``target``, which must sum to n (the
    JAX package asserts it; this raises ``ValueError``).  ``fixed`` pins
    nodes (-1 = free).  Returns int32 labels."""
    a = np.ascontiguousarray(np.asarray(a, dtype=np.float64))
    n, kcls = a.shape
    target = np.ascontiguousarray(np.asarray(target), dtype=np.int32)
    if target.sum() != n:
        raise ValueError(f"the class counts sum to {target.sum()}, not "
                         f"n = {n}")
    if fixed is None:
        fixed = np.full(n, -1, dtype=np.int32)
    fixed = np.ascontiguousarray(np.asarray(fixed), dtype=np.int32)
    if eps0 is None:
        spread = float(a.max() - a.min()) if n else 1.0
        eps0 = max(spread / 4.0, eps_min)
    labels = np.full(n, -1, dtype=np.int32)
    _load().auction_oracle(
        a.ctypes.data_as(_PD), ctypes.c_int32(n), ctypes.c_int32(kcls),
        target.ctypes.data_as(_P32), fixed.ctypes.data_as(_P32),
        ctypes.c_double(eps0), ctypes.c_double(eps_min),
        ctypes.c_double(scale), labels.ctypes.data_as(_P32))
    return labels
