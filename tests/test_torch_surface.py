"""The port's public surface against the JAX package's, by ``inspect``: the
module tree, every module's ``__all__``, the functions and classes each
module defines, and the public methods and attributes of each class.
What the port lacks is allowed only where ``ALLOWED`` says why; the next
gap fails here.  Then ``GLTConfig``'s fields and defaults, and the
methods and hooks this surface added, against the JAX package on the
same inputs."""

import dataclasses
import importlib
import inspect
import pkgutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import graphlearning_tpu as jgl
from graphlearning_tpu.core.sparse import SparseGraph as JSparseGraph
from graphlearning_tpu.ops import graphops as jops
from graphlearning_tpu.parallel import execute as jexec
from graphlearning_tpu.parallel.shard import build_sharded_bucketed as jbuck

import graphlearning_tpu_torch as tgl
from graphlearning_tpu_torch.core.sparse import SparseGraph
from graphlearning_tpu_torch.ops import graphops as tops
from graphlearning_tpu_torch.ops.accel import AccelSpMM
from tests.conftest import random_knn_csr

# The JAX package's module of Pallas kernels is ops/band_spmm.py in the
# port, with its own wrappers (held to the JAX kernels by
# tests/test_torch_band_spmm.py and the PERF.md table), so it is not
# compared name by name.
RENAMED = {"ops.pallas_spmm": "ops.band_spmm"}
ALLOWED = {
    "native.hostpath.use_host": "the remote-TPU dispatch gate: the port "
                                "runs on no TPU (native/hostpath.py)",
    "native.hostpath.use_host_lip": "the remote-TPU dispatch gate, as "
                                    "use_host",
    "native.hostpath.small_n_threshold": "the remote-TPU dispatch gate, as "
                                         "use_host",
    "native.hostpath.jnp_bf16": "a JAX dtype alias",
    "ops.gather.GatherAccel.interpret": "Pallas interpret mode: the port's "
                                        "CPU path is the twins",
    "ops.gather.GatherAccel.Wwin": "the TPU kernel's window width; the "
                                   "port's gather has no window",
    "parallel.band_shard.band_tiles_spmm_xla": "the CPU mesh's XLA form of "
                                               "K3: the port's CPU path is "
                                               "K3's twin",
    "parallel.band_shard.band_tiles_minplus_xla": "the CPU mesh's XLA form "
                                                  "of K7: the port's CPU "
                                                  "path is K7's twin",
    "parallel.band_shard.band_tiles_lip_xla": "the CPU mesh's XLA form of "
                                              "K9: the port's CPU path is "
                                              "K9's twin",
}


def _modules(pkg):
    """``{dotted name under the package: module}`` of its Python modules
    (built libraries left out)."""
    out = {"": pkg}
    for info in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        spec = info.module_finder.find_spec(info.name)
        if spec is None or not str(spec.origin).endswith(".py"):
            continue
        out[info.name[len(pkg.__name__) + 1:]] = importlib.import_module(
            info.name)
    return out


def _defined(mod):
    return {k: v for k, v in vars(mod).items()
            if not k.startswith("_")
            and (inspect.isfunction(v) or inspect.isclass(v))
            and getattr(v, "__module__", None) == mod.__name__}


@pytest.fixture(scope="module")
def gaps():
    jm, tm = _modules(jgl), _modules(tgl)
    found = []
    for name, jmod in jm.items():
        tname = RENAMED.get(name, name)
        if tname not in tm:
            found.append(name)
            continue
        if name in RENAMED:
            continue
        tmod = tm[tname]
        found += [f"{name}.{a}" for a in getattr(jmod, "__all__", ())
                  if a not in getattr(tmod, "__all__", ())]
        for attr, jobj in _defined(jmod).items():
            tobj = getattr(tmod, attr, None)
            if tobj is None:
                found.append(f"{name}.{attr}")
            elif inspect.isclass(jobj) and inspect.isclass(tobj):
                found += [f"{name}.{attr}.{m}" for m in dir(jobj)
                          if not m.startswith("_") and not hasattr(tobj, m)]
    return {g.lstrip(".") for g in found}


def test_no_gap_beyond_the_allowlist(gaps):
    assert sorted(gaps - set(ALLOWED)) == []


def test_the_allowlist_has_no_stale_entry(gaps):
    assert sorted(set(ALLOWED) - gaps) == []


def test_public_names_resolve():
    assert tgl.ops.spmm is tops.spmm
    assert tgl.solvers.conjgrad.__module__.endswith("solvers.cg")
    assert tgl.core.SparseGraph is SparseGraph
    assert tgl.GLTConfig is tgl.config.GLTConfig
    assert tgl.parallel.Distributor.__module__.endswith("parallel.execute")
    assert tgl.config.is_tpu() is False
    assert tgl.ops.__all__ == jgl.ops.__all__
    assert tgl.solvers.__all__ == jgl.solvers.__all__
    assert tgl.core.__all__ == jgl.core.__all__
    assert tgl.parallel.__all__ == jgl.parallel.__all__


def test_gltconfig_fields_and_defaults():
    jf = {f.name: f.default for f in dataclasses.fields(jgl.GLTConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(tgl.GLTConfig)}
    assert tf == jf
    cfg = tgl.GLTConfig()
    with pytest.raises(dataclasses.FrozenInstanceError):
        cfg.sharded_kernel = "banded"
    assert cfg.resolve_dtype("cpu") == torch.float64
    assert tgl.GLTConfig(dtype=torch.float32).resolve_dtype("cpu") == \
        torch.float32
    assert tgl.GLTConfig(band_mode="bf16").band_mode == "bf16"
    with pytest.raises(ValueError, match="bf16x3"):
        tgl.GLTConfig(band_mode="bf16x3")
    with pytest.raises(ValueError):
        tgl.GLTConfig(sharded_kernel="pallas")
    mesh = tgl.GLTConfig(devices="cpu").make_mesh()
    assert (mesh.size, mesh.axis_names, str(mesh.device)) == (
        1, ("nodes",), "cpu")
    # a batch axis: a (1, 1) grid here; more ranks than the world raise,
    # as JAX's reshape of too few devices does
    mesh = tgl.GLTConfig(mesh_shape=(1, 1), mesh_axes=("nodes", "batch"),
                         devices="cpu").make_mesh()
    assert mesh.shape == {"nodes": 1, "batch": 1} and mesh.size == 1
    with pytest.raises(ValueError, match="process group has 1"):
        tgl.GLTConfig(mesh_shape=(1, 2), mesh_axes=("nodes", "batch"),
                      devices="cpu").make_mesh()


@pytest.fixture(scope="module")
def W():
    return random_knn_csr(150, 6, seed=4)


def test_sparse_graph_methods(W):
    coo = W.tocoo()
    tg = SparseGraph.from_coo(coo.row, coo.col, coo.data, W.shape[0],
                              device="cpu")
    jg = JSparseGraph.from_coo(coo.row, coo.col, coo.data, W.shape[0])
    for a in ("cols", "vals", "deg"):
        np.testing.assert_array_equal(getattr(tg, a).numpy(),
                                      np.asarray(getattr(jg, a)))
    np.testing.assert_array_equal(tg.todense(), jg.todense())
    (tr, tperm), (jr, jperm) = tg.reorder_rcm(), jg.reorder_rcm()
    np.testing.assert_array_equal(tperm, jperm)
    np.testing.assert_array_equal(tr.todense(), jr.todense())
    assert tr.vals.dtype == tg.vals.dtype and tr.device == tg.device
    t32, j32 = tg.astype(np.float32), jg.astype(jnp.float32)
    assert t32.vals.dtype == torch.float32
    np.testing.assert_array_equal(t32.vals.numpy(), np.asarray(j32.vals))
    assert tg.astype(torch.float32).vals.dtype == torch.float32


class _Hooked:
    """A graph-like object with every hook, for both packages."""

    def __init__(self, lib):
        self.lib = lib

    def spmm_(self, X):
        return 2.0 * X + 1.0

    def neighbor_take_(self, x):
        return self.lib.stack([x, -x], 1)

    def deg_(self):
        return self.lib.asarray([3.0, 4.0])

    def diag_(self):
        return self.lib.asarray([5.0, 6.0])


def test_graphops_hooks_dispatch_as_jax():
    x = np.array([1.0, -2.0])
    tg, jg = _Hooked(torch), _Hooked(jnp)
    tx, jx = torch.as_tensor(x), jnp.asarray(x)
    for f in ("spmm", "neighbor_take"):
        for a, b in ((tx, jx), (tx[:, None], jx[:, None])):
            t = getattr(tops, f)(tg, a).numpy()
            np.testing.assert_array_equal(t, np.asarray(getattr(jops, f)(
                jg, b)))
    for f in ("degree_vector", "diagonal"):
        np.testing.assert_array_equal(getattr(tops, f)(tg).numpy(),
                                      np.asarray(getattr(jops, f)(jg)))


def test_graphops_hooks_on_the_hub_graph():
    """Degree, diagonal and product of the capped ELL plus spill at one
    rank against the JAX package's on its 4-device mesh."""
    from graphlearning_tpu_torch.parallel.shard import build_sharded_bucketed

    rs = np.random.RandomState(2)
    W = random_knn_csr(120, 5, seed=6).tolil()
    for j in rs.choice(120, 50, replace=False):
        W[0, j] = W[j, 0] = 1.0 + rs.rand()
    W.setdiag(0.25)
    W = W.tocsr()
    X = rs.randn(120, 3)
    tg, n = build_sharded_bucketed(W, tgl.parallel.make_mesh(devices="cpu"))
    jmesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]), ("nodes",))
    jg, _ = jbuck(W, jmesh, "nodes", 4)
    jX = jnp.asarray(np.pad(X, ((0, jg.n - n), (0, 0))))
    np.testing.assert_allclose(tops.spmm(tg, torch.as_tensor(X)).numpy(),
                               np.asarray(jops.spmm(jg, jX))[:n], rtol=1e-13)
    np.testing.assert_allclose(tops.degree_vector(tg).numpy(),
                               np.asarray(jops.degree_vector(jg))[:n],
                               rtol=1e-14)
    np.testing.assert_array_equal(tops.diagonal(tg).numpy(),
                                  np.asarray(jops.diagonal(jg))[:n])


@pytest.mark.parametrize("norm", ["combinatorial", "randomwalk",
                                  "normalized"])
def test_accel_laplacian_matvec(norm):
    """In permuted space, back in the original order: equal to the JAX
    package's ``ops.laplacian_matvec`` on the plain graph within 1e-10 of
    max|L X| (the CPU twins in float64)."""
    from sklearn.datasets import make_moons

    pts, _ = make_moons(5000, noise=0.1, random_state=0)
    W = tgl.weightmatrix.knn(pts, 10, device="cpu")
    acc = AccelSpMM(W, device="cpu")
    deg = torch.as_tensor(np.asarray(W.sum(1)).ravel())
    X = np.random.RandomState(0).randn(5000, 2)
    Lp = acc.laplacian_matvec(norm, acc.to_perm(deg))
    out = acc.from_perm(Lp(acc.to_perm(torch.as_tensor(X)))).numpy()
    ref = np.asarray(jops.laplacian_matvec(JSparseGraph.from_scipy(W),
                                           jnp.asarray(X), norm))
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())
    with pytest.raises(ValueError):
        acc.laplacian_matvec("signless", acc.to_perm(deg))


def test_accel_packed_band():
    """``packed_band`` is the packed plan's band, the port's own slab
    layout with no lane padding: its product is the band matvec; an
    unpacked plan has none."""
    from sklearn.datasets import make_moons

    from graphlearning_tpu_torch.ops import band_spmm as bs

    pts, _ = make_moons(5000, noise=0.1, random_state=1)
    W = tgl.weightmatrix.knn(pts, 10, device="cpu")
    acc = AccelSpMM(W, device="cpu")
    band = acc.packed_band()
    assert band is acc.band()
    assert band.shape[1] == acc.plan.S * acc.plan.WT
    Xp = acc.to_perm(torch.as_tensor(np.random.RandomState(1).randn(5000, 3)))
    out = bs.band_tiles_spmm_packed(band, acc.plan, Xp)
    bs.apply_residual(out, Xp, acc._resid)
    np.testing.assert_allclose(acc.from_perm(out).numpy(),
                               W @ acc.from_perm(Xp).numpy(), rtol=0,
                               atol=1e-12)
    with pytest.raises(ValueError, match="no packed band"):
        AccelSpMM(W, device="cpu", packed=False).packed_band()


def test_distributor_from_every_spec():
    cfg = tgl.GLTConfig(devices="cpu")
    d = tgl.parallel.Distributor(cfg)
    assert d.P == 1 and d.config is cfg and str(d.device) == "cpu"
    assert tgl.parallel.Distributor(d).mesh is d.mesh
    assert tgl.parallel.Distributor(d.mesh).config.node_axis == "nodes"
    with pytest.raises(TypeError):
        tgl.parallel.Distributor(3)
    # the JAX package's Distributor has the same public methods
    pub = lambda c: {m for m in dir(c) if not m.startswith("_")}
    assert pub(jexec.Distributor) <= pub(tgl.parallel.Distributor)
