"""The port's bench: SpMM edges/s on one GPU, the Poisson fit, and the
sharded SpMM's scaling over ranks.

Counterpart of the JAX package's ``bench.py``.  It prints one JSON line
with the JAX bench's keys and returns it as a dict.

    python -m graphlearning_tpu_torch.bench

Settings from the environment, or from keyword arguments of :func:`main`
(the tests pass ``device="cpu"`` and small sizes):

* ``GLT_BENCH_MODE``: ``spmm`` (default), ``poisson`` or ``sharded``
  (:func:`sharded_bench`: ``GLT_BENCH_SHARDED_KERNEL`` ``gspmd``,
  ``ring`` or ``banded``; on the CPU up to ``GLT_BENCH_DEVICES`` gloo
  ranks);
* ``GLT_BENCH_N``, ``GLT_BENCH_K``, ``GLT_BENCH_D``, ``GLT_BENCH_ITERS``:
  the graph's nodes and neighbors, X's columns, the chained products;
* ``GLT_BENCH_GEOM``: ``2d`` (uniform points, the band's geometry) or
  ``highdim`` (a ``GLT_BENCH_DIM``-d ten-cluster mixture, the segmented
  gather's);
* ``GLT_BENCH_PREC``: the gather's table (``f32``, ``bf16``, ``auto``) on
  ``highdim``; the headline mode on ``2d``;
* ``GLT_BENCH_PALLAS=0``: no band kernel, the plain ELL gather;
  ``GLT_BENCH_BAND=0``: the unstored band (K6, as ``GLT_NO_BAND``);
  ``GLT_NO_PACKED``: the unpacked tiles (K3).

On the 2-D geometry the packed plan runs five modes, each timed over
``iters`` chained products and held to the scipy f64 chain:

========== ======================================
``bf16``   K2, bf16 band and X (the headline)
``f32``    K2, exact f32 (JAX's ``bf16x3`` row)
rowq2_int8 K10, two int8 planes, f32 X
rowq1_int8 K10, one int8 plane, bf16 X
``bf16i8`` K11, bf16 hi and int8 lo planes
========== ======================================

Every mode adds the plan's residual edges.  A mode that fails fails the
bench.
"""

from __future__ import annotations

import inspect
import json
import os
import time

import numpy as np
import scipy.sparse as sp
import torch

from graphlearning_tpu_torch import config, ssl, trainsets, weightmatrix
from graphlearning_tpu_torch.core.sparse import SparseGraph
from graphlearning_tpu_torch.ops import accel as _accel
from graphlearning_tpu_torch.ops import band_spmm as _bs
from graphlearning_tpu_torch.ops import graphops
from graphlearning_tpu_torch.ops.gather import GatherSpMM

HBM_BPS = 3.35e12            # H100 SXM device memory, NVIDIA data sheet
SPMM_MODES = ("bf16", "f32", "rowq2_int8", "rowq1_int8", "bf16i8")
# Bytes a band cell and an X element stream in each mode.
_BAND_BYTES = {"bf16": 2, "f32": 4, "rowq2_int8": 2, "rowq1_int8": 1,
               "bf16i8": 3}
_X_BYTES = {"bf16": 2, "f32": 4, "rowq2_int8": 4, "rowq1_int8": 2,
            "bf16i8": 4}
BASELINE = "scipy CSR SpMM f64 host"


def settings(**overrides) -> dict:
    """The bench's settings: keyword overrides, else ``GLT_BENCH_*``."""
    env = os.environ.get
    mode = overrides.get("mode", env("GLT_BENCH_MODE", "spmm"))
    poisson, sharded = mode == "poisson", mode == "sharded"
    cfg = {
        "mode": mode,
        "n": int(env("GLT_BENCH_N", 70000 if poisson else
                     1 << 16 if sharded else 1 << 18)),
        "k": int(env("GLT_BENCH_K", 10 if poisson or sharded else 16)),
        "d": int(env("GLT_BENCH_D", 64 if sharded else 128)),
        "iters": int(env("GLT_BENCH_ITERS", 20 if sharded else 50)),
        "geom": env("GLT_BENCH_GEOM", "2d"),
        "dim": int(env("GLT_BENCH_DIM", 30)),
        "prec": env("GLT_BENCH_PREC"),
        "band_kernels": env("GLT_BENCH_PALLAS", "1") != "0",
        "stored_band": env("GLT_BENCH_BAND", "1") != "0",
        "sharded_kernel": env("GLT_BENCH_SHARDED_KERNEL", "gspmd"),
        "devices": int(env("GLT_BENCH_DEVICES", 8)),
    }
    unknown = set(overrides) - set(cfg)
    if unknown:
        raise TypeError(f"unknown bench settings {sorted(unknown)}")
    cfg.update(overrides)
    return cfg


def main(device=None, **overrides) -> dict:
    """Run the bench on ``device`` (:func:`config.device`: CUDA unless the
    CPU is asked for), print its JSON line and return it."""
    cfg = settings(**overrides)
    dev = config.device(device)
    if cfg["mode"] == "poisson":
        result = poisson_bench(cfg, dev)
    elif cfg["mode"] == "sharded":
        result = sharded_bench(cfg, dev)
    elif cfg["mode"] != "spmm":
        raise ValueError(f"GLT_BENCH_MODE={cfg['mode']!r}: 'spmm', "
                         "'poisson' or 'sharded'")
    elif cfg["geom"] == "highdim":
        result = highdim_bench(cfg, dev)
    elif cfg["geom"] == "2d":
        result = spmm_bench(cfg, dev)
    else:
        raise ValueError(f"GLT_BENCH_GEOM={cfg['geom']!r}: '2d' or "
                         "'highdim'")
    print(json.dumps(result), flush=True)
    return result


# -- shared pieces -------------------------------------------------------------


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _device_name(dev) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _row_stochastic(W):
    """``D^-1 W``: chained products stay bounded."""
    return (sp.diags(1.0 / np.asarray(W.sum(1)).ravel()) @ W).tocsr()


def measure(f, X, iters: int, dev):
    """``(seconds, final iterate)`` of ``iters`` chained ``f`` after one
    warm call and 3 settling calls, closed by a device synchronize."""
    f(X)
    _sync(dev)
    out = X
    for _ in range(3):
        out = f(out)
    _sync(dev)
    t0 = time.perf_counter()
    Y = X
    for _ in range(iters):
        Y = f(Y)
    _sync(dev)
    return time.perf_counter() - t0, Y


def _reference_chain(W, X_np, iters: int):
    """The scipy f64 chain ``W^iters X`` and one product ``W X``."""
    Y = X_np.astype(np.float64)
    for _ in range(iters):
        Y = W @ Y
    return Y, W @ X_np.astype(np.float64)


def _baseline_edges_per_s(W, X_np, iters: int) -> float:
    """Edges/s of the reference's compute path: scipy CSR SpMM in f64 on
    the host, ``max(1, iters // 10)`` chained products after a warm one."""
    Xc = X_np.astype(np.float64)
    W @ Xc
    base_iters = max(1, iters // 10)
    t0 = time.perf_counter()
    Y = Xc
    for _ in range(base_iters):
        Y = W @ Y
    return W.nnz * base_iters / (time.perf_counter() - t0)


def _rel_err(Y, ref) -> float:
    Yh = Y.double().cpu().numpy()
    return float(np.abs(Yh - ref).max() / np.abs(ref).max())


# -- spmm on the 2-D geometry: the band kernels -----------------------------------


def bench_graph_2d(n: int, k: int, rs):
    """Uniform 2-D points, exact kNN (cKDTree), self-tuned gaussian
    weights, symmetrized, then row-stochastic; the points ride along
    (``_glt_points``) for the space-filling-curve order."""
    from scipy.spatial import cKDTree

    pts = rs.rand(n, 2)
    dist, ind = cKDTree(pts).query(pts, k=k + 1)
    dist, ind = dist[:, 1:], ind[:, 1:]
    eps = np.maximum(dist[:, -1:] ** 2, 1e-12)
    w = np.exp(-4 * dist ** 2 / eps)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    W = sp.csr_matrix((w.ravel(), (rows, ind.ravel())), shape=(n, n))
    W = _row_stochastic((W + W.T) / 2)
    W._glt_points = pts
    return W


def _resid_edges(resid) -> int:
    if resid is None:
        return 0
    _, _, rvals, sp_r, _, _ = resid
    return int((rvals != 0).sum()) + int(sp_r.shape[0])


def mode_matvec(acc, mode: str):
    """``Xp -> Wp @ Xp`` of one mode on ``acc``'s matvec plan (its band
    built here, in the mode's format), plus the plan's residual edges."""
    plan, resid = acc.plan, acc._resid
    if mode in ("bf16", "f32"):
        dt = torch.bfloat16 if mode == "bf16" else torch.float32
        if isinstance(plan, _bs.BandedPlan):
            cols = acc.g.cols[:, :plan.kcap].contiguous()
            vals = acc.g.vals[:, :plan.kcap].to(dt).contiguous()
            band_fn = lambda X: _bs.banded_spmm(cols, vals, plan, X.to(dt))
        else:
            band = acc.build_band(dt)
            kern = (_bs.band_tiles_spmm_packed if acc.packed
                    else _bs.band_tiles_spmm)
            band_fn = lambda X: kern(band, plan, X.to(dt))
    elif not acc.packed:
        raise ValueError(f"mode {mode} needs the packed plan, not a "
                         f"{type(plan).__name__}")
    elif mode in ("rowq2_int8", "rowq1_int8"):
        planes = int(mode[4])
        qband, srow = _bs.quantize_band_rowq(acc.build_band(torch.float32),
                                             plan, acc.n_pad, planes)
        xdt = torch.float32 if planes == 2 else torch.bfloat16
        band_fn = lambda X: _bs.band_tiles_spmm_packed_rowq(
            qband, srow, plan, X.to(xdt), planes)
    elif mode == "bf16i8":
        hi, q = _bs.quantize_band_i8(acc.build_band(torch.float32))
        band_fn = lambda X: _bs.band_tiles_spmm_packed_i8(hi, q, plan, X)
    else:
        raise ValueError(f"unknown mode {mode!r}; modes: {SPMM_MODES}")
    return lambda X: _bs.apply_residual(band_fn(X), X, resid)


def _kernel_name(acc, dev) -> str:
    """The band kernel's name: ``cuda_*`` on the card, ``torch_*`` where
    the wrappers run their torch twins (the CPU)."""
    if acc is None:
        return "torch_ell_gather"
    route = "cuda" if dev.type == "cuda" else "torch"
    if isinstance(acc.plan, _bs.BandedPlan):
        return f"{route}_banded_ell"
    return (f"{route}_tiles_packed_s{acc.plan.S}" if acc.packed
            else f"{route}_tiles")


def _roofline(acc, mode, d, seconds) -> dict:
    """Bytes one product of the tiles plan must move (the real tiles'
    cells and their X windows once each, the output once) against the
    H100's data-sheet rate."""
    if acc is None or isinstance(acc.plan, _bs.BandedPlan):
        return {}
    plan = acc.plan
    tiles = int(plan.slab_ntiles.sum())
    traffic = (tiles * plan.WT * (plan.R * _BAND_BYTES[mode]
                                  + d * _X_BYTES[mode])
               + acc.n_pad * d * 4)
    return {"bytes_per_edge": round(traffic / acc.nnz, 1),
            "traffic_GB_per_spmm": round(traffic / 1e9, 3),
            "achieved_GBps": round(traffic / seconds / 1e9, 1),
            "hbm_frac_of_3350GBps": round(traffic / seconds / HBM_BPS, 3)}


def spmm_bench(cfg, dev) -> dict:
    """Edges/s of ``iters`` chained SpMMs on the 2-D geometry, each mode of
    the plan beside the scipy f64 chain."""
    n, k, d, iters = cfg["n"], cfg["k"], cfg["d"], cfg["iters"]
    rs = np.random.RandomState(0)
    W = bench_graph_2d(n, k, rs)
    X_np = rs.randn(n, d).astype(np.float32)
    X = torch.as_tensor(X_np, device=dev)
    t0 = time.perf_counter()
    if cfg["band_kernels"]:
        acc = _accel.AccelSpMM(W, device=dev, materialize=(
            None if cfg["stored_band"] else False))
        modes = (SPMM_MODES if acc.packed else ("bf16", "f32"))
        Xp = acc.to_perm(X)
        back = lambda Y: acc.from_perm(Y)
    else:
        acc = None
        g = SparseGraph.from_scipy(W, dtype=torch.float32, device=dev)
        modes = ("f32",)
        Xp = X
        back = lambda Y: Y
    plan_s = time.perf_counter() - t0
    headline = cfg["prec"] or modes[0]
    if headline not in modes:
        raise ValueError(f"GLT_BENCH_PREC={headline!r}: this plan runs "
                         f"{modes}")

    Y_ref, Y1_ref = _reference_chain(W, X_np, iters)
    out = {}
    for mode in (headline,) + tuple(m for m in modes if m != headline):
        _sync(dev)
        t = time.perf_counter()
        fn = (mode_matvec(acc, mode) if acc is not None
              else lambda X: graphops.spmm(g, X))
        _sync(dev)
        build_s = time.perf_counter() - t
        dt, Y = measure(fn, Xp, iters, dev)
        out[mode] = {"edges_per_s": round(W.nnz * iters / dt, 1),
                     "rel_err_chain": _rel_err(back(Y), Y_ref),
                     "rel_err_single": _rel_err(back(fn(Xp)), Y1_ref),
                     "_seconds": dt, "_build_s": build_s}
        del fn, Y                   # free this mode's band before the next
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    head = out[headline]
    base = _baseline_edges_per_s(W, X_np, iters)
    if acc is None:
        plan_cfg = {"residual_frac": 0.0, "window": 0, "kcap": 0}
    else:
        plan = acc.plan
        if isinstance(plan, _bs.BandedPlan):
            window, kcap = plan.W, plan.kcap
        else:
            window = (int(plan.slab_ntiles.sum()) * plan.WT * plan.R
                      // acc.n_pad)
            kcap = acc._build_args[2]
        plan_cfg = {"residual_frac": round(_resid_edges(acc._resid)
                                           / max(1, W.nnz), 5),
                    "window": int(window), "kcap": int(kcap)}
    return {
        "metric": "spmm_edges_per_sec_per_chip",
        "value": head["edges_per_s"],
        "unit": "edges/s",
        "vs_baseline": round(head["edges_per_s"] / base, 3),
        "config": {
            "n": n, "k": k, "d": d, "iters": iters, "nnz": int(W.nnz),
            "backend": dev.type, "device": _device_name(dev),
            "kernel": _kernel_name(acc, dev), **plan_cfg, "mode": headline,
            "plan_s": round(plan_s, 4),
            "band_build_s": round(head["_build_s"], 4),
            "baseline": BASELINE,
            "rel_err_chain": head["rel_err_chain"],
            "rel_err_single": head["rel_err_single"],
            "modes": {m: {key: v for key, v in r.items()
                          if not key.startswith("_")}
                      for m, r in out.items()},
            **_roofline(acc, headline, d, head["_seconds"] / iters),
        },
        "baseline_edges_per_sec": round(base, 1),
    }


# -- spmm on the high-dimensional geometry: the segmented gather -------------------


def highdim_graph(n: int, k: int, dim: int, rs, dev):
    """The band-hostile graph: a ``dim``-d mixture of ten unit gaussians
    around ``randn`` centers, kNN on ``dev`` (``weightmatrix.knn``),
    row-stochastic."""
    centers = rs.randn(10, dim)
    labels = rs.randint(0, 10, n)
    pts = (centers[labels] + rs.randn(n, dim)).astype(np.float32)
    return _row_stochastic(weightmatrix.knn(pts, k, device=dev))


def highdim_case(cfg, dev):
    """``(W, X, W^iters X, W X)`` of the band-hostile bench at ``cfg``'s
    sizes: the graph, X, and the scipy f64 chain and product."""
    n, k, d, iters, dim = (cfg["n"], cfg["k"], cfg["d"], cfg["iters"],
                           cfg["dim"])
    rs = np.random.RandomState(0)
    W = highdim_graph(n, k, dim, rs, dev)
    X_np = rs.randn(n, d).astype(np.float32)
    return (W, X_np, *_reference_chain(W, X_np, iters))


def highdim_bench(cfg, dev, case=None) -> dict:
    """Edges/s of ``iters`` chained segmented-gather SpMMs on the
    band-hostile graph, with the table precision ``GLT_BENCH_PREC``;
    ``case`` (from :func:`highdim_case` at the same sizes) saves building
    the graph and its reference chain again for another table."""
    n, k, d, iters, dim = (cfg["n"], cfg["k"], cfg["d"], cfg["iters"],
                           cfg["dim"])
    prec = cfg["prec"] or "auto"
    W, X_np, Y_ref, Y1_ref = (highdim_case(cfg, dev) if case is None
                              else case)
    gs = GatherSpMM(W, prec=prec, device=dev)
    Xp = gs.to_perm(torch.as_tensor(X_np, device=dev))
    dt, Y = measure(gs.spmm, Xp, iters, dev)
    edges_per_s = W.nnz * iters / dt
    base = _baseline_edges_per_s(W, X_np, iters)
    return {
        "metric": "spmm_edges_per_sec_per_chip_band_hostile",
        "value": round(edges_per_s, 1),
        "unit": "edges/s",
        "vs_baseline": round(edges_per_s / base, 3),
        "config": {
            "n": n, "k": k, "d": d, "dim": dim, "iters": iters,
            "nnz": int(W.nnz), "backend": dev.type,
            "device": _device_name(dev),
            "kernel": f"gather_segmented_{prec}",
            "slots": int(gs.slots),
            "slot_pad": round(gs.slots / W.nnz, 3),
            "ns_per_edge": round(dt / iters / W.nnz * 1e9, 2),
            "rel_err": _rel_err(gs.from_perm(Y), Y_ref),
            "rel_err_single": _rel_err(gs.from_perm(gs.spmm(Xp)), Y1_ref),
            "baseline": BASELINE,
        },
        "baseline_edges_per_sec": round(base, 1),
    }


# -- poisson: a full fit -------------------------------------------------------------


def _cg_tol_kw():
    """scipy's name for CG's relative tolerance (``rtol`` from 1.12)."""
    import scipy.sparse.linalg as spla

    return ("rtol" if "rtol" in inspect.signature(spla.cg).parameters
            else "tol")


def ten_cluster_points(n: int):
    """``(points, labels)``: ``n`` points of a 20-d mixture of ten unit
    gaussians, seeded."""
    rs = np.random.RandomState(0)
    centers = rs.randn(10, 20)
    labels = rs.randint(0, 10, n)
    return centers[labels] + rs.randn(n, 20), labels


def ten_cluster_case(n: int, k: int, dev):
    """The Poisson bench's input: :func:`ten_cluster_points`, its kNN
    graph on ``dev`` and one label a class.  Returns ``(W, labels,
    train_ind)``."""
    pts, labels = ten_cluster_points(n)
    W = weightmatrix.knn(pts, k, device=dev)
    return W, labels, trainsets.generate(labels, rate=1, seed=0)


def poisson_bench(cfg, dev) -> dict:
    """Seconds of a warm ``ssl.poisson(W).fit_predict`` on a 20-d
    ten-cluster kNN graph with one label a class, beside the reference's
    compute path (scipy f64 CG on the normalized Laplacian on the host),
    and the accel the fit took (``path``)."""
    import scipy.sparse.linalg as spla

    n, k = cfg["n"], cfg["k"]
    ncls = 10
    W, labels, train_ind = ten_cluster_case(n, k, dev)

    model = ssl.poisson(W, device=dev)
    model.fit_predict(train_ind, labels[train_ind])      # plan + warm
    _sync(dev)
    t0 = time.perf_counter()
    pred = model.fit_predict(train_ind, labels[train_ind])
    _sync(dev)
    dt = time.perf_counter() - t0
    accuracy = ssl.ssl_accuracy(pred, labels, train_ind)

    W64 = model.graph.weight_matrix.astype(np.float64)
    W64.setdiag(0)
    W64.eliminate_zeros()
    s = 1.0 / np.sqrt(np.asarray(W64.sum(1)).ravel())
    L = sp.eye(n) - sp.diags(s) @ W64 @ sp.diags(s)
    onehot = np.zeros((len(train_ind), ncls))
    onehot[np.arange(len(train_ind)), labels[train_ind]] = 1
    b = np.zeros((n, ncls))
    b[train_ind] = onehot - onehot.mean(0)
    tol = {_cg_tol_kw(): 1e-6}
    t0 = time.perf_counter()
    u_ref = np.stack([spla.cg(L, s * b[:, c], **tol)[0]
                      for c in range(ncls)], axis=1)
    dt_ref = time.perf_counter() - t0
    agree = float(np.mean(pred == np.argmax(s[:, None] * u_ref, axis=1)))
    return {
        "metric": "poisson_mnist_scale_solve_seconds",
        "value": round(dt, 4),
        "unit": "s",
        "vs_baseline": round(dt_ref / dt, 3),
        "config": {"n": n, "k": k, "accuracy_pct": round(float(accuracy), 2),
                   "agreement_with_reference_path": round(agree, 4),
                   "reference_seconds": round(dt_ref, 4),
                   "backend": dev.type, "device": _device_name(dev),
                   "iters": int(model.iters),
                   "path": _accel.path_name(model._accel_cache)},
    }


# -- sharded: the SpMM over 1, 2, 4, ... ranks ------------------------------------

SHARDED_KERNELS = ("gspmd", "ring", "banded")
RANK_COUNTS = (1, 2, 4, 8, 16, 32)
SHARDED_TIMEOUT = 900.0         # seconds the ranks of one bench may take
# Seconds of timed chains a rank count: a chain of the JAX bench's 20
# products takes 7-22 ms on one H100, too short a window alone.
SHARDED_WINDOW_S = 1.0


def _sharded_operator(kernel, W, X_np, mesh, dev):
    """``(fn, X, back)`` of one rank: ``fn`` its rows of ``W @ X`` on the
    ``kernel`` route, ``X`` its rows of ``X_np`` and ``back(Y)`` the
    gathered chain in node order.  "banded": the partitioned band of W's
    RCM order (K1 for the rank's block; K3 over the ring halo), R = WT =
    512 at f32 on CUDA, 128 at f64 on the CPU."""
    from graphlearning_tpu_torch import parallel
    from graphlearning_tpu_torch.parallel.band_shard import ShardedBandPlan

    n = W.shape[0]
    if kernel == "banded":
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        perm = np.asarray(reverse_cuthill_mckee(W, symmetric_mode=True))
        Wb = W[perm, :][:, perm].tocsr()
        cuda = dev.type == "cuda"
        R = 512 if cuda else 128
        plan = ShardedBandPlan(Wb, mesh, R=R, WT=R,
                               mode="f32" if cuda else "f64")

        def back(Y):
            out = np.empty_like(Y[:n])
            out[perm] = Y[:n]
            return out

        return plan.spmm, plan.put_rows(X_np[perm]), back
    g = parallel.shard_graph(W, mesh, dtype=config.float_dtype(dev))
    spmm = (parallel.sharded_spmm_ring if kernel == "ring"
            else parallel.sharded_spmm)
    return (lambda X: spmm(g, X, mesh), parallel.put_features(X_np, mesh),
            lambda Y: Y[:n])


def _timed_chains(fn, X, iters: int, mesh, dev, window: float):
    """``(seconds of each chain, the last chain)``: chains of ``iters``
    products ``fn`` from ``X``, the first one warm, then until the timed
    ones add up to ``window`` seconds.  Each chain starts after an
    all-reduce and ends at a device synchronize; the ranks run as many
    chains as the slowest one needs."""
    seconds = []
    while True:
        mesh.all_reduce(torch.zeros((), device=dev))
        _sync(dev)
        t0 = time.perf_counter()
        Y = X
        for _ in range(iters):
            Y = fn(Y)
        _sync(dev)
        seconds.append(time.perf_counter() - t0)
        more = len(seconds) < 2 or sum(seconds[1:]) < window
        if not mesh.all_reduce(torch.tensor(float(more), device=dev),
                               op="max").item():
            return seconds, Y


def _sharded_rank(rank, world, store, cfg, counts, out_dir):
    """One rank of :func:`sharded_bench`: joins the process group (NCCL
    on its card, gloo on the CPU), then for each rank count P the first P
    ranks run chains of ``iters`` products on a P-rank node mesh
    (:func:`_timed_chains`).  Rank 0 saves each P's chain seconds, last
    gathered chain and band kernel launches to ``out_dir``."""
    import torch.distributed as dist

    from graphlearning_tpu_torch.parallel.mesh import Mesh

    cuda = cfg["backend"] == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    config.set_device(dev)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=store,
                            rank=rank, world_size=world)
    try:
        rs = np.random.RandomState(0)
        W = bench_graph_2d(cfg["n"], cfg["k"], rs)
        X_np = rs.randn(cfg["n"], cfg["d"]).astype(np.float32)
        out = {}
        for P in counts:
            group = (None if P == 1 else dist.group.WORLD if P == world
                     else dist.new_group(ranks=list(range(P))))
            if rank < P:
                mesh = Mesh(group, P, rank, dev, ("nodes", "batch"),
                            sizes=(P, 1))
                before = _bs.launches()
                fn, X, back = _sharded_operator(cfg["sharded_kernel"], W,
                                                X_np, mesh, dev)
                seconds, Y = _timed_chains(fn, X, cfg["iters"], mesh, dev,
                                           SHARDED_WINDOW_S)
                Y = mesh.all_gather(Y)
                after = _bs.launches()
                if rank == 0:
                    out[P] = {"seconds": seconds,
                              "chain": back(Y.double().cpu().numpy()),
                              "launches": {k: after[k] - before[k]
                                           for k in after
                                           if after[k] != before[k]}}
            dist.barrier()
        if rank == 0:
            torch.save(out, os.path.join(out_dir, "rank0.pt"))
    finally:
        dist.destroy_process_group()


def sharded_bench(cfg, dev, chains=None) -> dict:
    """Edges/s of ``iters`` chained sharded SpMMs at 1, 2, 4, ... ranks and
    the scaling efficiency, on the JAX bench's graph (uniform 2-D points,
    kNN, symmetrized, row-stochastic) with d columns: the mean of the
    chains timed after a warm one (``chains_timed`` of them, at least
    ``SHARDED_WINDOW_S`` seconds together; ``chain_ms`` lists every
    chain, the warm one first).  The ranks are
    processes (``torch.multiprocessing``, spawned): on CUDA one card each
    on NCCL, up to ``torch.cuda.device_count()``; on the CPU gloo ranks up
    to ``cfg["devices"]``, which share the host's cores, so the efficiency
    is the throughput retained at the most ranks (``virtual_mesh``), as on
    the JAX package's virtual CPU mesh.  Each P's chain is held to the
    scipy f64 chain (``rel_err_chain``); ``launches`` counts rank 0's band
    kernels at each P.  ``chains``, a dict, gets each P's gathered chain
    in node order.  A P that fails fails the bench."""
    import shutil
    import tempfile

    import torch.multiprocessing as tmp

    kernel = cfg["sharded_kernel"]
    if kernel not in SHARDED_KERNELS:
        raise ValueError(f"GLT_BENCH_SHARDED_KERNEL={kernel!r}: one of "
                         f"{SHARDED_KERNELS}")
    n, k, d, iters = cfg["n"], cfg["k"], cfg["d"], cfg["iters"]
    virtual = dev.type != "cuda"
    avail = cfg["devices"] if virtual else torch.cuda.device_count()
    counts = [p for p in RANK_COUNTS if p <= avail]
    rs = np.random.RandomState(0)
    W = bench_graph_2d(n, k, rs)
    X_np = rs.randn(n, d).astype(np.float32)
    Y_ref, _ = _reference_chain(W, X_np, iters)
    work = tempfile.mkdtemp(prefix="glt_sharded_")
    try:
        ctx = tmp.start_processes(
            _sharded_rank, nprocs=counts[-1], join=False,
            start_method="spawn",
            args=(counts[-1], "file://" + os.path.join(work, "store"),
                  dict(cfg, backend=dev.type), counts, work))
        deadline = time.monotonic() + SHARDED_TIMEOUT
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                raise RuntimeError(f"sharded bench: the ranks ran over "
                                   f"{SHARDED_TIMEOUT:.0f} s")
        runs = torch.load(os.path.join(work, "rank0.pt"), weights_only=False)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    nnz = W.nnz
    timed = {p: runs[p]["seconds"][1:] for p in counts}
    table = {p: nnz * iters * len(timed[p]) / sum(timed[p]) for p in counts}
    if chains is not None:
        chains.update({p: runs[p]["chain"] for p in counts})
    base, pmax = table[counts[0]], counts[-1]
    if virtual:
        eff = table[pmax] / base if pmax > 1 else 1.0
        unit = f"% throughput retained sharded {pmax}-way (virtual mesh)"
    else:
        eff = table[pmax] / (pmax * base) if pmax > 1 else 1.0
        unit = f"% of linear at {pmax} devices"
    return {
        "metric": "sharded_spmm_scaling_efficiency",
        "value": round(eff * 100, 1),
        "unit": unit,
        "vs_baseline": round(eff / 0.80, 3),
        "config": {
            "n": n, "k": k, "d": d, "iters": iters, "nnz": int(nnz),
            "d_effective": d, "kernel": kernel, "virtual_mesh": virtual,
            "backend": dev.type, "device": _device_name(dev),
            "edges_per_sec": {str(p): round(v, 1) for p, v in table.items()},
            "throughput_ratio": {str(p): round(table[p] / base, 2)
                                 for p in counts},
            "rel_err_chain": {str(p): float(
                np.abs(runs[p]["chain"] - Y_ref).max()
                / np.abs(Y_ref).max()) for p in counts},
            "launches": {str(p): runs[p]["launches"] for p in counts},
            "window_s": SHARDED_WINDOW_S,
            "chains_timed": {str(p): len(timed[p]) for p in counts},
            "chain_ms": {str(p): [round(t * 1e3, 4)
                                  for t in runs[p]["seconds"]]
                         for p in counts},
        },
    }


if __name__ == "__main__":
    main()
