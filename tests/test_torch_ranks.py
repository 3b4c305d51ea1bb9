"""Spawned gloo ranks on the CPU for the distribution layer's tests, and
the mesh without a process group.

This file imports no JAX: the ranks that :func:`run_ranks` spawns import
it (and the port), never ``tests/conftest.py``.  Each rank is a fresh
process (the ``spawn`` start method, one torch thread) that joins a gloo
group on a ``file://`` store under the test's ``tmp_path``, runs its
cases and puts its results on a queue.  The parent waits at most
``timeout`` seconds, so a hung collective fails the test instead of
eating the suite's time.  The JAX comparisons live in the files that
call :func:`run_ranks` (``test_torch_parallel.py``,
``test_torch_sharded_models.py``, ``test_torch_sharded_families.py``).
"""

import multiprocessing as mp
import os
import queue
import traceback

import numpy as np
import pytest
import scipy.sparse as sp

RANK_TIMEOUT = 120.0


def _rank_main(rank, world, init, cases, out):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from graphlearning_tpu_torch import config

    config.set_device("cpu")
    results = {}
    try:
        if init is not None:
            dist.init_process_group("gloo", init_method=init, rank=rank,
                                    world_size=world)
        for name, fn, kwargs in cases:
            if init is None:                 # the case joins a group itself
                kwargs = dict(kwargs, rank=rank, world=world)
            results[name] = fn(**kwargs)
        if init is not None:
            dist.destroy_process_group()
    except Exception:
        results["__error__"] = traceback.format_exc()
    out.put((rank, results))


def _world(key):
    """A group's world size: its key, or the key's first item."""
    return key[0] if isinstance(key, tuple) else key


class Ranks:
    """Spawned gloo ranks running their cases: each group's ranks start at
    once (``groups`` maps a world size, or a ``(world size, tag)`` pair
    where one size has several groups, to its cases, ``(name, fn,
    kwargs)``, ``fn`` a module-level function of a JAX-free module), and
    :meth:`results` waits for them.  ``init``: "file" (a ``file://``
    store a group) or None (the cases join a group themselves)."""

    def __init__(self, groups, tmp_path, init="file"):
        ctx = mp.get_context("spawn")
        self.groups = groups
        self.out = {key: ctx.Queue() for key in groups}
        self.procs = {}
        for i, (key, cases) in enumerate(groups.items()):
            world = _world(key)
            store = None
            if init == "file":
                store = "file://" + os.path.join(str(tmp_path),
                                                 f"store{i}")
            for r in range(world):
                p = ctx.Process(target=_rank_main,
                                args=(r, world, store, cases,
                                      self.out[key]), daemon=True)
                p.start()
                self.procs[key, r] = p

    def results(self, timeout=RANK_TIMEOUT):
        """``{key: [each rank's {name: result}]}``, within ``timeout``
        seconds; fails the test on a rank's error or a hang."""
        got = {key: {} for key in self.groups}
        try:
            for key in self.groups:
                for _ in range(_world(key)):
                    rank, res = self.out[key].get(timeout=timeout)
                    got[key][rank] = res
        except queue.Empty:
            pytest.fail(f"no result within {timeout} s: "
                        f"{ {k: sorted(g) for k, g in got.items()} }")
        finally:
            for p in self.procs.values():
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        for (key, rank), p in self.procs.items():
            assert not p.is_alive()
            if "__error__" in got[key][rank]:
                pytest.fail(f"rank {rank} of {key}:\n"
                            f"{got[key][rank]['__error__']}")
        return {key: [got[key][r] for r in range(_world(key))]
                for key in self.groups}


def run_ranks(groups, tmp_path, timeout=RANK_TIMEOUT, init="file"):
    """:class:`Ranks` started and waited for."""
    return Ranks(groups, tmp_path, init=init).results(timeout)


# -- cases (run on every rank) -------------------------------------------------


def case_collectives(n):
    """The mesh's collectives on rank-dependent rows: all_reduce (sum,
    max), all_gather, the halo and the ring shift."""
    import torch

    import graphlearning_tpu_torch as gl

    mesh = gl.parallel.make_mesh()
    p = mesh.rank
    X = torch.arange(n, dtype=torch.float64)[:, None] + 100.0 * p
    left, right = mesh.halo(X, 2)
    return {"rank": p, "size": mesh.size, "device": str(mesh.device),
            "sum": float(mesh.all_reduce(torch.tensor(p + 1.0))),
            "max": float(mesh.all_reduce(torch.tensor(float(p)), "max")),
            "gather": mesh.all_gather(X).numpy(),
            "left": left.numpy(), "right": right.numpy(),
            "shift": mesh.ring_shift(X).numpy()}


def case_initialize(port, rank, world):
    """``initialize_distributed`` over ``tcp://`` loopback (twice: the
    second call is a no-op), a sum over the ranks and the mesh."""
    import torch
    import torch.distributed as dist

    import graphlearning_tpu_torch as gl

    addr = f"localhost:{port}"
    try:
        gl.parallel.initialize_distributed(addr, world, rank, device="cpu")
    except (RuntimeError, OSError) as e:
        return {"skip": str(e)[:300]}
    gl.parallel.initialize_distributed(addr, world, rank, device="cpu")
    mesh = gl.parallel.make_mesh()
    out = {"backend": dist.get_backend(), "rank": mesh.rank,
           "size": mesh.size,
           "sum": float(mesh.all_reduce(torch.tensor(rank + 1.0))),
           "again": dist.is_initialized()}
    dist.destroy_process_group()
    return out


def ring_graph(n, seed=0):
    """A weighted ring with random chords: every rank's rows reach its
    neighbours' blocks."""
    rs = np.random.RandomState(seed)
    rows = np.concatenate([np.arange(n), np.arange(n),
                           rs.randint(0, n, n // 4)])
    cols = np.concatenate([(np.arange(n) + 1) % n, (np.arange(n) - 1) % n,
                           rs.randint(0, n, n // 4)])
    W = sp.coo_matrix((rs.rand(len(rows)) + 0.1, (rows, cols)),
                      shape=(n, n)).tocsr()
    return (W + W.T).tocsr()


def _gather(mesh, t):
    return mesh.all_gather(t).cpu().numpy()


def case_spmm(W, X, W_band, X_band, W_hub, X_hub, R, WT, max_halo_frac):
    """Every sharded product of the ranks, gathered: the ELL route's
    all-gather and ring forms on ``W``, the partitioned band (K1, K3 and
    the halo; ``W_band`` in a banded order) and the capped ELL plus spill
    of the hub graph ``W_hub``, each with its degree and diagonal
    hooks."""
    import torch

    import graphlearning_tpu_torch as gl
    from graphlearning_tpu_torch.ops import graphops
    from graphlearning_tpu_torch.parallel import band_shard, shard

    mesh = gl.parallel.make_mesh()
    g = gl.parallel.shard_graph(W, mesh)
    Xl = gl.parallel.put_features(X, mesh)
    out = {"gspmd": _gather(mesh, gl.parallel.sharded_spmm(g, Xl, mesh)),
           "ring": _gather(mesh, gl.parallel.sharded_spmm_ring(g, Xl, mesh)),
           "diag": _gather(mesh, graphops.diagonal(g)),
           "deg": _gather(mesh, graphops.degree_vector(g))}
    plan = band_shard.ShardedBandPlan(W_band, mesh, R=R, WT=WT, mode="f64",
                                      max_halo_frac=max_halo_frac)
    op = plan.op
    out["band"] = _gather(mesh, graphops.spmm(op, plan.put_rows(X_band)))
    out["band_1d"] = _gather(mesh, graphops.spmm(
        op, plan.put_rows(X_band[:, 0])))
    out["band_diag"] = _gather(mesh, graphops.diagonal(op))
    out["band_residual"] = int(mesh.all_reduce(
        torch.tensor(op.n_residual)))
    out["band_geometry"] = (plan.B, plan.H, plan.n_pad, op.has_res)
    gb, n = shard.build_sharded_bucketed(W_hub, mesh)
    Xh = gl.parallel.put_features(X_hub, mesh)
    out["bucketed"] = _gather(mesh, graphops.spmm(gb, Xh))
    out["bucketed_deg"] = _gather(mesh, graphops.degree_vector(gb))
    out["bucketed_diag"] = _gather(mesh, graphops.diagonal(gb))
    out["bucketed_kcap"] = (gb.k, int(gb.sp_rows.shape[0]))
    return out


FITS = {
    "laplace": lambda gl, W, priors: gl.ssl.laplace(W, tol=1e-10,
                                                    device="cpu"),
    "laplace_normalized": lambda gl, W, priors: gl.ssl.laplace(
        W, normalization="normalized", tol=1e-10, device="cpu"),
    "randomwalk": lambda gl, W, priors: gl.ssl.randomwalk(W, device="cpu"),
    "poisson": lambda gl, W, priors: gl.ssl.poisson(W, tol=1e-10,
                                                    device="cpu"),
    "poisson_gd": lambda gl, W, priors: gl.ssl.poisson(
        W, solver="gradient_descent", device="cpu"),
    "poisson_mbo": lambda gl, W, priors: gl.ssl.poisson_mbo(
        W, class_priors=priors, device="cpu"),
}


def case_fits(W, ti, labels, priors, kernel, names=tuple(FITS)):
    """The five families' sharded fits on the ``kernel`` route: each
    one's ``(u, prediction, iterations, route)``."""
    import graphlearning_tpu_torch as gl

    cfg = gl.GLTConfig(sharded_kernel=kernel, devices="cpu")
    out = {}
    for name in names:
        m = FITS[name](gl, W, priors).distribute(cfg)
        u = m.fit(ti, labels[ti])
        out[name] = (u, m.predict(), m.iters, m._dist.route)
    return out


# -- the second half of the distribution layer (P15b) --------------------------


def case_halo(W, d, f, x, cp, U2, U40, R, WT, max_halo_frac):
    """The halo methods of one partitioned band, gathered: ``neighbor_take_``
    (float and int32), ``minplus_`` (plain, reciprocal, Hopf-Lax; min and
    global argmin) and ``lip_reduce_`` at C = 2 and 40 (two K9 column
    blocks), with the partition's geometry and residual count."""
    import torch

    import graphlearning_tpu_torch as gl
    from graphlearning_tpu_torch.parallel import band_shard

    mesh = gl.parallel.make_mesh()
    plan = band_shard.ShardedBandPlan(W, mesh, R=R, WT=WT, mode="f64",
                                      max_halo_frac=max_halo_frac)
    op = plan.op
    r0 = mesh.rank * plan.B
    cp_pad = np.concatenate([cp, np.full(plan.n_pad - len(cp), -1)])
    cp_rows = torch.as_tensor(cp_pad[r0:r0 + plan.B].astype(np.int32))
    out = {"take": _gather(mesh, op.neighbor_take_(plan.put_rows(x))),
           "take_int": _gather(mesh, op.neighbor_take_(cp_rows)),
           "geometry": (plan.B, plan.H, plan.n_pad, op.has_res),
           "residual": int(mesh.all_reduce(torch.tensor(op.n_residual))),
           "chunks": op.chunks is op.chunks and op.chunks[1].numel()}
    dl, fl = plan.put_rows(d), plan.put_rows(f)
    for hopf, recip in ((False, False), (False, True), (True, False)):
        m, a = op.minplus_(dl, fl, hopf_lax=hopf, recip=recip)
        out["minplus", hopf, recip] = (_gather(mesh, m), _gather(mesh, a))
    for name, U in (("lip2", U2), ("lip40", U40)):
        s, mn, mx = op.lip_reduce_(plan.put_rows(U))
        out[name] = tuple(_gather(mesh, t) for t in (s, mn, mx))
    return out


FAMILIES = {
    "graph_nn": lambda gl, W, priors: gl.ssl.graph_nearest_neighbor(
        W, device="cpu"),
    "plaplace": lambda gl, W, priors: gl.ssl.plaplace(W, p=10,
                                                      device="cpu"),
    "amle": lambda gl, W, priors: gl.ssl.amle(W, tol=1e-8, device="cpu"),
    "amle_weighted": lambda gl, W, priors: gl.ssl.amle(W, weighted=True,
                                                       device="cpu"),
    "peikonal": lambda gl, W, priors: gl.ssl.peikonal(W, device="cpu"),
    "volume_mbo": lambda gl, W, priors: gl.ssl.volume_mbo(
        W, class_priors=priors, temperature=0, device="cpu"),
    "volume_mbo_noisy": lambda gl, W, priors: gl.ssl.volume_mbo(
        W, class_priors=priors, temperature=0.1, seed=0, device="cpu"),
    "sparse_lp": lambda gl, W, priors: gl.ssl.sparse_label_propagation(
        W, T=30, device="cpu"),
    "centered_kernel": lambda gl, W, priors: gl.ssl.centered_kernel(
        W, device="cpu"),
    # the eigenbasis fits share one normalized solve (k = 3) on the mesh
    "poisson_spectral": lambda gl, W, priors: gl.ssl.poisson(
        W, solver="spectral", spectral_cutoff=2, device="cpu"),
    "poisson_mbo_spectral": lambda gl, W, priors: gl.ssl.poisson_mbo(
        W, class_priors=priors, solver="spectral", spectral_cutoff=2, T=2,
        device="cpu"),
    "multiclass_mbo": lambda gl, W, priors: gl.ssl.multiclass_mbo(
        W, num_eig=3, seed=0, device="cpu"),
    "modularity_mbo": lambda gl, W, priors: gl.ssl.modularity_mbo(
        W, device="cpu"),
}


def case_families(W, ti, labels, priors, kernel, e0, incres_draws,
                  jax_draws=None, volume_loop=None, names=tuple(FAMILIES),
                  combinatorial=True):
    """Every P15b family's sharded fit on the ``kernel`` route (``(u,
    prediction, iterations, route)``), Dijkstra with its closest points
    (plain, Hopf-Lax, reciprocal), the centered kernel from the power
    vector ``e0`` (node order), the eigensolvers, spectral clustering,
    ``spectral_covariance`` of a distributed Laplace model, INCRES's
    rounds fed ``incres_draws`` and ``jax_draws`` (``(k, n)`` node-order
    scores, one a round), and VolumeMBO's loop on ``volume_loop``'s
    inputs fed its ``draws`` (node-order Gumbel noise, one a round).
    ``combinatorial``: also the combinatorial Laplacian's solve (LOBPCG's
    slowest here) and its clustering."""
    import torch

    import graphlearning_tpu_torch as gl
    from graphlearning_tpu_torch.parallel import execute as ex

    cfg = gl.GLTConfig(sharded_kernel=kernel, devices="cpu")
    out = {}
    for name in names:
        m = FAMILIES[name](gl, W, priors).distribute(cfg)
        u = m.fit(ti, labels[ti])
        out[name] = (u, m.predict(), m.iters, m._dist.route)
    dist = ex.Distributor(cfg)
    for hopf, recip in ((False, False), (True, False), (False, True)):
        out["dijkstra", hopf, recip] = ex.dijkstra_fit_sharded(
            dist, W, ti[:5], 0.0, 1.0, return_cp=True, hopf_lax=hopf,
            reciprocal_weights=recip)
    n, k = W.shape[0], 3
    K = np.zeros((n, k))
    K[ti] = np.eye(k)[labels[ti]]
    K[ti] -= K.sum(0) / len(ti)
    mask = np.zeros(n, bool)
    mask[ti] = True
    Wn = W.copy()
    Wn.setdiag(0)
    Wn.eliminate_zeros()
    out["centered_e0"] = ex.centered_kernel_fit_sharded(
        dist, Wn, K, mask, 1.05, 1e-10, 100, 0, e0=e0)
    norms = ("normalized", "randomwalk") + (
        ("combinatorial",) if combinatorial else ())
    for norm in norms:
        out["eig", norm] = ex.eigen_decomp_sharded(dist, W, norm, k=3)
    out["eig", "modularity"] = ex.eigen_decomp_mod_sharded(dist, W, k=15,
                                                           gamma=0.5)
    methods = ("NgJordanWeiss",) + (("combinatorial",) if combinatorial
                                    else ())
    for method in methods:
        out["spectral", method] = gl.clustering.spectral(
            W, 3, method=method, device="cpu").distribute(cfg).fit_predict()
    out["covariance"] = gl.active_learning.spectral_covariance(
        gl.ssl.laplace(W, device="cpu").distribute(cfg), k=3)
    u0 = np.random.RandomState(0).randint(0, 3, size=n)
    for key, draws in (("incres", incres_draws), ("incres_jax", jax_draws)):
        if draws is not None:
            it = iter(draws)
            out[key] = ex.incres_fit_sharded(
                dist, W, u0, lambda shape: torch.as_tensor(next(it)), k=3,
                T=8, Dm=1)
    if volume_loop is not None:
        v = dict(volume_loop)
        it = iter(v.pop("draws"))
        out["volume_jax_draws"] = ex.volume_mbo_fit_sharded(
            dist, draw=lambda shape: torch.as_tensor(next(it)[:shape[0]]),
            **v)
    return out


def case_runners(W, ti, labels, trainsets, results_dir):
    """JAX's two runner tests on a distributed model: ``ssl_trials`` of a
    Poisson model (its CSV under ``results_dir``, rank 0 writing) and an
    ``active_learner`` over a Laplace model (two queries)."""
    import graphlearning_tpu_torch as gl
    from graphlearning_tpu_torch import ssl as tssl

    cfg = gl.GLTConfig(devices="cpu")
    mesh = gl.parallel.make_mesh()
    tssl.results_dir = os.path.join(results_dir, f"rank{mesh.rank}")
    model = gl.ssl.poisson(W, device="cpu").distribute(cfg)
    trials = model.ssl_trials(trainsets, labels, overwrite=True)
    model = gl.ssl.laplace(W, device="cpu").distribute(cfg)
    al = gl.active_learning.active_learner(
        model, gl.active_learning.unc_sampling(), ti, labels[ti])
    queries = []
    for _ in range(2):
        q = al.select_queries(batch_size=1)
        al.update(q, labels[q])
        queries.append(np.asarray(q))
    return {"trials": trials, "queries": queries,
            "labeled": np.asarray(al.labeled_ind), "u": np.asarray(al.u)}


# -- the last of the distribution layer (P15c) ---------------------------------


def case_batch_fits(W, ti, labels, shape, axes):
    """Laplace and Poisson CG (tol 1e-10) on both routes on the mesh of
    ``shape`` over ``axes`` (``GLTConfig``), each one's ``(u, prediction,
    route)``, with the mesh's shape, node-axis size and index, and
    ``make_mesh``'s of the same shape."""
    import graphlearning_tpu_torch as gl

    out = {}
    for kernel in ("gspmd", "banded"):
        cfg = gl.GLTConfig(mesh_shape=shape, mesh_axes=axes,
                           sharded_kernel=kernel, devices="cpu")
        for name in ("laplace", "poisson"):
            m = FITS[name](gl, W, None).distribute(cfg)
            u = m.fit(ti, labels[ti])
            out[kernel, name] = (u, m.predict(), m._dist.route)
    mesh = m._dist.mesh
    out["mesh"] = (mesh.shape, mesh.size, mesh.rank)
    made = gl.parallel.make_mesh(*shape, devices="cpu")
    out["make_mesh"] = (made.shape, made.size, made.rank)
    return out


ALL_LABELS_FITS = {
    "poisson_mbo": lambda gl, W, priors: gl.ssl.poisson_mbo(
        W, class_priors=priors, T=5, device="cpu"),
    "volume_mbo": lambda gl, W, priors: gl.ssl.volume_mbo(
        W, class_priors=priors, temperature=0.1, seed=0, device="cpu"),
    "incres": lambda gl, W, priors: gl.clustering.incres(
        W, 3, T=6, seed=0, device="cpu"),
}


def fit_all_labels(gl, name, W, ti, labels, priors, cfg=None):
    """``(prediction, printed rounds)`` of an ``ALL_LABELS_FITS`` fit with
    ``all_labels``, distributed on ``cfg`` when given."""
    import contextlib
    import io

    m = ALL_LABELS_FITS[name](gl, W, priors)
    if cfg is not None:
        m.distribute(cfg)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if name == "incres":
            pred = m.fit_predict(all_labels=labels)
        else:
            pred = m.fit_predict(ti, labels[ti], all_labels=labels)
    return np.asarray(pred), buf.getvalue()


def case_all_labels(W, ti, labels, priors, kernel):
    """PoissonMBO, VolumeMBO (temperature 0.1, seed 0) and INCRES with
    ``all_labels`` on the ``kernel`` route: each one's prediction and
    printed rounds."""
    import graphlearning_tpu_torch as gl

    cfg = gl.GLTConfig(sharded_kernel=kernel, devices="cpu")
    return {name: fit_all_labels(gl, name, W, ti, labels, priors, cfg)
            for name in ALL_LABELS_FITS}


# -- the mesh without a process group -----------------------------------------


def test_world_size_one_mesh_is_local():
    """Without a process group the mesh's collectives are the identity and
    the halo wraps to the rank itself.  A mesh of more ranks than the
    world, along either axis, raises ``ValueError`` (JAX's ``make_mesh``
    asserts)."""
    import torch

    import graphlearning_tpu_torch as gl

    mesh = gl.parallel.make_mesh(devices="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.shape == {"nodes": 1, "batch": 1}
    X = torch.arange(6.0)[:, None]
    left, right = mesh.halo(X, 2)
    assert torch.equal(left, X[-2:]) and torch.equal(right, X[:2])
    assert mesh.all_reduce(X) is X and mesh.all_gather(X) is X
    assert mesh.ring_shift(X) is X
    with pytest.raises(ValueError, match="batch_axis=2"):
        gl.parallel.make_mesh(batch_axis=2, devices="cpu")
    with pytest.raises(ValueError):
        gl.parallel.make_mesh(n_nodes_axis=2, devices="cpu")
