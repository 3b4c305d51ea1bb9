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
``test_torch_sharded_models.py``).
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


class Ranks:
    """Spawned gloo ranks running their cases: each group's ranks start at
    once (``groups`` maps a world size to its cases, ``(name, fn,
    kwargs)``, ``fn`` a module-level function of a JAX-free module), and
    :meth:`results` waits for them.  ``init``: "file" (a ``file://``
    store a group) or None (the cases join a group themselves)."""

    def __init__(self, groups, tmp_path, init="file"):
        ctx = mp.get_context("spawn")
        self.groups = groups
        self.out = {world: ctx.Queue() for world in groups}
        self.procs = {}
        for world, cases in groups.items():
            store = None
            if init == "file":
                store = "file://" + os.path.join(str(tmp_path),
                                                 f"store{world}")
            for r in range(world):
                p = ctx.Process(target=_rank_main,
                                args=(r, world, store, cases,
                                      self.out[world]), daemon=True)
                p.start()
                self.procs[world, r] = p

    def results(self, timeout=RANK_TIMEOUT):
        """``{world: [each rank's {name: result}]}``, within ``timeout``
        seconds; fails the test on a rank's error or a hang."""
        got = {world: {} for world in self.groups}
        try:
            for world in self.groups:
                for _ in range(world):
                    rank, res = self.out[world].get(timeout=timeout)
                    got[world][rank] = res
        except queue.Empty:
            pytest.fail(f"no result within {timeout} s: "
                        f"{ {w: sorted(g) for w, g in got.items()} }")
        finally:
            for p in self.procs.values():
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
        for (world, rank), p in self.procs.items():
            assert not p.is_alive()
            if "__error__" in got[world][rank]:
                pytest.fail(f"rank {rank} of {world}:\n"
                            f"{got[world][rank]['__error__']}")
        return {world: [got[world][r] for r in range(world)]
                for world in self.groups}


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


# -- the mesh without a process group -----------------------------------------


def test_world_size_one_mesh_is_local():
    """Without a process group the mesh's collectives are the identity and
    the halo wraps to the rank itself."""
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
    with pytest.raises(NotImplementedError, match="P15b"):
        gl.parallel.make_mesh(batch_axis=2, devices="cpu")
    with pytest.raises(ValueError):
        gl.parallel.make_mesh(n_nodes_axis=2, devices="cpu")
