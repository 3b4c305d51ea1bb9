"""The band SpMM of graphlearning_tpu_torch against graphlearning_tpu.

Host planners must give identical arrays.  The plain torch twins of the
kernels K1-K9 are held against the Pallas kernels in interpret mode; the
CUDA kernels are held against the twins in ``test_torch_cuda_kernels.py``.
"""

import ctypes
import re
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp
from scipy.sparse.csgraph import reverse_cuthill_mckee
from scipy.spatial import cKDTree

from graphlearning_tpu.core.sparse import SparseGraph as JSparseGraph
from graphlearning_tpu.ops import pallas_spmm as jps
from graphlearning_tpu.ops.accel import AccelSpMM as JAccelSpMM
from graphlearning_tpu_torch.ops import _build
from graphlearning_tpu_torch.ops import band_spmm as bs
from graphlearning_tpu_torch.ops.accel import AccelSpMM

torch.set_num_threads(2)


def _knn_csr(n, k, seed):
    rs = np.random.RandomState(seed)
    pts = rs.rand(n, 2)
    dist, ind = cKDTree(pts).query(pts, k=k + 1)
    dist, ind = dist[:, 1:], ind[:, 1:]
    w = np.exp(-4 * dist ** 2 / np.maximum(dist[:, -1:] ** 2, 1e-12))
    W = sp.csr_matrix((w.ravel(), (np.repeat(np.arange(n), k), ind.ravel())),
                      shape=(n, n))
    return ((W + W.T) / 2).tocsr(), pts


@pytest.fixture(scope="module")
def banded_ell():
    """RCM-ordered kNN graph padded to 1024 rows, as JAX's host ELL."""
    W, _ = _knn_csr(1000, 10, seed=0)
    perm = np.asarray(reverse_cuthill_mckee(W, symmetric_mode=True))
    Wp = W[perm][:, perm].tocsr()
    Wp.resize((1024, 1024))
    cols, vals, deg = JSparseGraph.ell_from_scipy(Wp)
    return cols, vals, deg, Wp


def _assert_same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("R,WT,min_edges", [(128, 128, 8), (256, 64, 20)])
def test_plan_tiles_and_pack_tiles_identical(banded_ell, R, WT, min_edges):
    cols, _, deg, _ = banded_ell
    ref = jps.plan_tiles(cols, R=R, WT=WT, deg=deg, kcap_max=32,
                         min_edges_per_tile=min_edges)
    out = bs.plan_tiles(cols, R=R, WT=WT, deg=deg, kcap_max=32,
                        min_edges_per_tile=min_edges)
    for a, b in zip(out, ref):
        _assert_same(a, b)
    tb, ts, bf = ref[:3]
    for a, b in zip(bs.pack_tiles(tb, ts, bf, 4),
                    jps.pack_tiles(tb, ts, bf, 4)):
        _assert_same(a, b)


def test_plan_banded_identical(banded_ell):
    cols, _, deg, _ = banded_ell
    for gain in (None, 50):
        ref = jps.plan_banded(cols, R=128, WT=128, deg=deg, kcap_max=32,
                              gain_per_tile=gain)
        out = bs.plan_banded(cols, R=128, WT=128, deg=deg, kcap_max=32,
                             gain_per_tile=gain)
        for a, b in zip(out, ref):
            _assert_same(a, b)


def test_build_residual_ell_identical(banded_ell):
    cols, vals, deg, _ = banded_ell
    _, _, _, rrows, rslots, _ = jps.plan_tiles(
        cols, R=128, WT=128, deg=deg, kcap_max=4, min_edges_per_tile=64)
    assert len(rrows) > 100
    vals32 = vals.astype(np.float32)
    ref = jps.build_residual_ell(rrows, rslots, cols, vals32, 1024, rb=3)
    out = bs.build_residual_ell(rrows, rslots, cols, vals32, 1024, rb=3)
    urows, rcols, rvals, _inv_map, sp_r, sp_c, sp_v = ref
    assert len(np.asarray(sp_r)) > 0             # the spill is exercised
    for a, b in zip(out, (urows, rcols, rvals, sp_r, sp_c, sp_v)):
        _assert_same(a, b)


def _tiles(banded_ell, R, WT):
    cols, vals, deg, _ = banded_ell
    tb, ts, bf, rr, rs_, kcap = jps.plan_tiles(
        cols, R=R, WT=WT, deg=deg, kcap=cols.shape[1], min_edges_per_tile=1,
        hbm_budget_bytes=float("inf"))
    assert len(rr) == 0
    return cols, vals, tb, ts, bf


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k1_twin_matches_pallas(banded_ell, dtype):
    R, WT = 128, 128
    cols, vals, tb, ts, _ = _tiles(banded_ell, R, WT)
    ref = jps.materialize_band_tiles(
        jnp.asarray(cols), jnp.asarray(vals, dtype), jnp.asarray(tb),
        jnp.asarray(ts), R=R, WT=WT, interpret=True,
        out_dtype=getattr(jnp, dtype))
    out = bs.materialize_band_tiles(
        torch.as_tensor(cols), torch.as_tensor(vals.astype(dtype)),
        torch.as_tensor(tb), torch.as_tensor(ts), R=R, WT=WT,
        out_dtype=getattr(torch, dtype))
    assert out.dtype == getattr(torch, dtype)
    # same slot-order sums in the same dtype
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _packed(banded_ell, R, WT, S, dtype):
    cols, vals, tb, ts, bf = _tiles(banded_ell, R, WT)
    band = bs.materialize_band_tiles(
        torch.as_tensor(cols), torch.as_tensor(vals), torch.as_tensor(tb),
        torch.as_tensor(ts), R=R, WT=WT, out_dtype=dtype)
    sb, sts, sbf, src = bs.pack_tiles(tb, ts, bf, S)
    packed = bs.pack_band(band, src, R=R, WT=WT)
    ref_packed = jps.pack_band(jnp.asarray(band.float().numpy()), src, R=R,
                               WT=WT)
    np.testing.assert_array_equal(packed.float().numpy(),
                                  np.asarray(ref_packed))
    plan = bs.PackedPlan.from_slabs(sb, sts, src, 1024, R, WT, "cpu")
    return packed, plan, (sb, sts, sbf)


@pytest.mark.parametrize("mode,rtol", [("f32", 1e-5), ("bf16", 1e-2)])
def test_k2_twin_matches_pallas(banded_ell, mode, rtol):
    R, WT, S = 128, 64, 4
    tdt = torch.float32 if mode == "f32" else torch.bfloat16
    jdt = jnp.float32 if mode == "f32" else jnp.bfloat16
    packed, plan, (sb, sts, sbf) = _packed(banded_ell, R, WT, S, tdt)
    rs = np.random.RandomState(1)
    X = rs.randn(1024, 5).astype(np.float32)
    Xpad = np.pad(X, ((0, 0), (0, 123)))         # the TPU's 128 lanes
    ref = np.asarray(jps.band_tiles_spmm_packed(
        jnp.asarray(packed.float().numpy()).astype(jdt), jnp.asarray(sb),
        jnp.asarray(sts.reshape(-1)), jnp.asarray(sbf),
        jnp.asarray(Xpad).astype(jdt), n=1024, R=R, WT=WT, S=S,
        interpret=True, mode=mode))[:, :5]
    out = bs.band_tiles_spmm_packed(packed, plan,
                                    torch.as_tensor(X).to(tdt))
    assert out.dtype == torch.float32 and out.shape == (1024, 5)
    np.testing.assert_allclose(out.numpy(), ref,
                               atol=rtol * np.abs(ref).max(), rtol=0)


def test_k3_twin_matches_pallas_f64_rectangular(banded_ell):
    R, WT = 128, 128
    cols, vals, tb, ts, bf = _tiles(banded_ell, R, WT)
    band = bs.materialize_band_tiles(
        torch.as_tensor(cols), torch.as_tensor(vals), torch.as_tensor(tb),
        torch.as_tensor(ts), R=R, WT=WT, out_dtype=torch.float64)
    rs = np.random.RandomState(2)
    X = rs.randn(1024 + 256, 3)                  # more X rows than outputs
    ref = np.asarray(jps.band_tiles_spmm(
        jnp.asarray(band.numpy()), jnp.asarray(tb), jnp.asarray(ts),
        jnp.asarray(bf), jnp.asarray(np.pad(X, ((0, 0), (0, 125)))), 1024,
        R=R, WT=WT, interpret=True, mode="f64"))[:, :3]
    plan = bs.TilesPlan.from_tiles(tb, ts, 1024, R, WT, "cpu")
    out = bs.band_tiles_spmm(band, plan, torch.as_tensor(X))
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)
    Wp = banded_ell[3]
    np.testing.assert_allclose(out.numpy(), Wp @ X[:1024], rtol=1e-12,
                               atol=1e-12)


def test_plan_rejects_unsorted_slabs():
    with pytest.raises(ValueError):
        bs.TilesPlan.from_tiles(np.array([1, 0]), np.array([0, 0]), 256, 128,
                                128, "cpu")


@pytest.fixture(scope="module")
def knn_900():
    W, pts = _knn_csr(900, 10, seed=3)
    W._glt_points = pts
    return W


@pytest.mark.parametrize("packed,mode", [(True, "f32"), (False, "f32"),
                                         (True, "bf16")])
def test_accel_spmm_matches_jax_and_scipy(knn_900, packed, mode):
    """f32 mode runs the twins in f64 on the CPU (1e-10 of scipy; JAX's
    band is f32: 2e-4).  bf16 rounds the band and X to bf16 in both
    packages: 1e-2 of max|W @ X|."""
    W = knn_900
    rs = np.random.RandomState(4)
    X = rs.randn(900, 6)
    acc = AccelSpMM(W, device="cpu", packed=packed, mode=mode)
    assert acc.packed == packed
    out = acc.from_perm(acc.spmm(acc.to_perm(torch.as_tensor(X)))).numpy()
    ref_np = W @ X
    jacc = JAccelSpMM(W, interpret=True, mode=mode)
    ref = np.asarray(jacc.from_perm(jacc.spmm(jacc.to_perm(
        jnp.asarray(X, jnp.float32)))))
    if mode == "f32":
        np.testing.assert_allclose(out, ref_np, rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
    else:
        atol = 1e-2 * np.abs(ref_np).max()
        np.testing.assert_allclose(out, ref_np, rtol=0, atol=atol)
        np.testing.assert_allclose(out, ref, rtol=0, atol=atol)


def test_accel_band_budget_drops_packed_plan(knn_900, monkeypatch):
    """Packed and unpacked bands share one budget: when both do not fit,
    the packed plan is dropped with a warning, not silently."""
    from graphlearning_tpu_torch.ops import accel

    acc = AccelSpMM(knn_900, device="cpu")
    packed_bytes = acc.band().numel() * acc.band().element_size()
    budget = 900 * 5120 * 4 + 1        # the smallest that admits a band
    assert acc.band_bytes < budget < acc.band_bytes + packed_bytes
    monkeypatch.setattr(accel, "_band_budget_bytes", lambda dev: budget)
    with pytest.warns(RuntimeWarning, match="packed band"):
        acc2 = AccelSpMM(knn_900, device="cpu")
    assert not acc2.packed and acc2.band_bytes == acc.band_bytes


# -- K4, K7, K9 and the residual rounds ------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k4_twin_matches_pallas(banded_ell, dtype):
    """The rectangular band: exact in f32 and f64 (the same slot-order
    sums)."""
    cols, vals, deg, _ = banded_ell
    R, WT = 128, 128
    winstart, _, _, W, kcap = jps.plan_banded(cols, R=R, WT=WT, deg=deg,
                                              kcap_max=32)
    assert W < 1024
    c, v = cols[:, :kcap], vals[:, :kcap].astype(dtype)
    ref = jps.materialize_band(jnp.asarray(c), jnp.asarray(v),
                               jnp.asarray(winstart), W, R=R, WT=WT,
                               interpret=True, out_dtype=getattr(jnp, dtype))
    out = bs.materialize_band(torch.as_tensor(c), torch.as_tensor(v),
                              torch.as_tensor(winstart), W, R=R, WT=WT,
                              out_dtype=getattr(torch, dtype))
    assert out.dtype == getattr(torch, dtype) and out.shape == (1024, W)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _minplus_inputs(banded_ell, dtype):
    cols, vals, tb, ts, bf = _tiles(banded_ell, 128, 128)
    band = bs.materialize_band_tiles(
        torch.as_tensor(cols), torch.as_tensor(vals.astype(np.float32)),
        torch.as_tensor(tb), torch.as_tensor(ts), R=128, WT=128,
        out_dtype=dtype)
    rs = np.random.RandomState(5)
    d = (rs.rand(1024) * 3).astype(np.float32)
    d[rs.rand(1024) < 0.3] = 1e30                  # unreached nodes
    f = (rs.rand(1024) + 0.5).astype(np.float32)
    plan = bs.TilesPlan.from_tiles(tb, ts, 1024, 128, 128, "cpu")
    return band, plan, (tb, ts, bf), d, f


def _cand64(A, d, f, hopf_lax, recip):
    """One relaxation candidate in f64 from f32 inputs."""
    A = 1.0 / np.float64(A) if recip else np.float64(A)
    fw = A * np.float64(f)
    if hopf_lax:
        return 0.5 * (fw + np.sqrt(fw * fw + 4.0 * np.float64(d) ** 2))
    return np.float64(d) + fw


def _assert_minplus_matches_jax(m, arg, ref_min, ref_arg, dense, d, f,
                                hopf_lax, recip, rtol=1e-6):
    """The port's min-plus round against JAX's on the CPU, tie-tolerant:
    the min within ``rtol``; -1 where JAX finds no candidate; and where the
    port's argmin differs from JAX's, the candidate at the port's column,
    computed in f64 from the same band value ``dense[row, col]``, ``d`` and
    ``f``, equals JAX's row minimum within ``rtol``.  The two frameworks
    round the Hopf-Lax candidate in their own ways (XLA:CPU may contract
    or vectorise it), so a near-tie between two columns may fall either
    way; the exact argmin is held between kernel and twin on the card
    (``test_torch_cuda_kernels.py``, ``chip_smoke.py``)."""
    m, arg = m.numpy(), arg.numpy()
    np.testing.assert_allclose(m, ref_min, rtol=rtol)
    has = ref_min < 1e30
    assert has.any() and (~has).any()
    assert np.all(arg[~has] == -1)
    ref_arg = np.where(has, ref_arg, -1).astype(np.int32)
    for r in np.nonzero(has & (arg != ref_arg))[0]:
        c = arg[r]
        assert dense[r, c] > 0, (r, c)
        np.testing.assert_allclose(
            _cand64(dense[r, c], d[c], f[c], hopf_lax, recip), ref_min[r],
            rtol=rtol, err_msg=f"row {r}: column {c} against {ref_arg[r]}")


def _tiles_dense(band, tb, ts, n, R, WT):
    """The (n, n) matrix of a tiles band's values."""
    dense = np.zeros((n, n), np.float32)
    tiles = band.float().numpy().reshape(-1, R, WT)
    for g, (b, s) in enumerate(zip(tb, ts)):
        dense[b * R:(b + 1) * R, s:s + WT] = tiles[g]
    return dense


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hopf_lax,recip", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_k7_twin_matches_pallas(banded_ell, dtype, hopf_lax, recip):
    """Min within 1e-6 (relative), argmin tie-tolerant
    (:func:`_assert_minplus_matches_jax`) where a candidate exists; -1
    where none (JAX carries a float-coded sentinel there)."""
    band, plan, (tb, ts, bf), d, f = _minplus_inputs(banded_ell, dtype)
    jband = jnp.asarray(band.float().numpy()).astype(
        jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    ref = np.asarray(jps.band_tiles_minplus(
        jband, jnp.asarray(tb), jnp.asarray(ts), jnp.asarray(bf),
        jnp.asarray(d), jnp.asarray(f), 1024, R=128, WT=128,
        hopf_lax=hopf_lax, track_arg=True, recip=recip, interpret=True))
    m, arg = bs.band_tiles_minplus(band, plan, torch.as_tensor(d),
                                   torch.as_tensor(f), hopf_lax=hopf_lax,
                                   track_arg=True, recip=recip)
    assert m.dtype == torch.float32 and arg.dtype == torch.int32
    has = ref[:, 0] < 1e30
    _assert_minplus_matches_jax(
        m, arg, ref[:, 0], np.where(has, ref[:, 1], -1),
        _tiles_dense(band, tb, ts, 1024, 128, 128), d, f, hopf_lax, recip)
    m2, none = bs.band_tiles_minplus(band, plan, torch.as_tensor(d),
                                     torch.as_tensor(f), hopf_lax=hopf_lax,
                                     recip=recip)
    assert none is None
    np.testing.assert_array_equal(m2.numpy(), m.numpy())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 3])
def test_k9_twin_matches_pallas(banded_ell, dtype, C):
    """Sums within 1e-5 of max|ref| (f32 sums in other orders), min and
    max identical."""
    band, plan, (tb, ts, bf), _, _ = _minplus_inputs(banded_ell, dtype)
    U = np.random.RandomState(6).randn(1024, C).astype(np.float32)
    jband = jnp.asarray(band.float().numpy()).astype(
        jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    ref = np.asarray(jps.band_tiles_lip(
        jband, jnp.asarray(tb), jnp.asarray(ts), jnp.asarray(bf),
        jnp.asarray(np.pad(U, ((0, 0), (0, 128 - C)))), 1024, C=C, R=128,
        WT=128, interpret=True))
    sums, mins, maxs = bs.band_tiles_lip(band, plan, torch.as_tensor(U))
    np.testing.assert_allclose(sums.numpy(), ref[:, :C], rtol=0,
                               atol=1e-5 * np.abs(ref[:, :C]).max())
    np.testing.assert_array_equal(mins.numpy(), ref[:, 128:128 + C])
    np.testing.assert_array_equal(maxs.numpy(), ref[:, 256:256 + C])


@pytest.fixture(scope="module")
def residual(banded_ell):
    cols, vals, deg, _ = banded_ell
    _, _, _, rrows, rslots, _ = jps.plan_tiles(
        cols, R=128, WT=128, deg=deg, kcap_max=4, min_edges_per_tile=64)
    vals32 = vals.astype(np.float32)
    jres = jps.build_residual_ell(rrows, rslots, cols, vals32, 1024, rb=3)
    tres = bs.residual_to_device(
        bs.build_residual_ell(rrows, rslots, cols, vals32, 1024, rb=3),
        "cpu", torch.float32)
    return jres, tres


@pytest.mark.parametrize("hopf_lax,recip", [(False, False), (True, True)])
def test_residual_minplus_matches_jax(residual, hopf_lax, recip):
    """Min within 1e-6 (XLA may fuse the Hopf-Lax products into
    multiply-adds); the argmin equals JAX's on rows without spilled edges
    and is a column that attains the min everywhere (JAX keeps the last of
    several spilled edges, the port the smallest column)."""
    jres, tres = residual
    rs = np.random.RandomState(7)
    d = (rs.rand(1024) * 3).astype(np.float32)
    f = (rs.rand(1024) + 0.5).astype(np.float32)
    jm, ja = jps.residual_minplus(jnp.asarray(d), jnp.asarray(f), jres,
                                  hopf_lax=hopf_lax, track_arg=True,
                                  recip=recip)
    m, a = bs.residual_minplus(torch.as_tensor(d), torch.as_tensor(f), tres,
                               hopf_lax=hopf_lax, track_arg=True,
                               recip=recip)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-6)
    spilled = np.zeros(1024, bool)
    spilled[np.asarray(jres[4])] = True
    np.testing.assert_array_equal(a.numpy()[~spilled],
                                  np.asarray(ja)[~spilled])
    has = m.numpy() < 1e30
    assert (spilled & has).any()
    # the port's argmin attains the min on every row that has one
    urows, rcols, rvals, sp_r, sp_c, sp_v = (t.numpy() for t in tres)
    edges = {}
    for r, cs, vs in zip(urows, rcols, rvals):
        for c, v in zip(cs, vs):
            if v > 0:
                edges.setdefault(r, []).append((c, v))
    for r, c, v in zip(sp_r, sp_c, sp_v):
        edges.setdefault(r, []).append((c, v))
    for r in np.nonzero(has)[0]:
        ws = [v for c, v in edges[r] if c == a.numpy()[r]]
        assert ws
        w = np.float32(1.0) / ws[0] if recip else ws[0]
        fw = np.float32(w * f[a[r]])
        cand = (np.float32(0.5) * (fw + np.sqrt(fw * fw + np.float32(4.0)
                                                * d[a[r]] * d[a[r]]))
                if hopf_lax else d[a[r]] + w * f[a[r]])
        assert np.isclose(cand, m.numpy()[r], rtol=1e-6)


def test_residual_lip_matches_jax(residual):
    jres, tres = residual
    U = np.random.RandomState(8).randn(1024, 3).astype(np.float32)
    ref = jps.residual_lip(jnp.asarray(U), jres, 1024)
    out = bs.residual_lip(torch.as_tensor(U), tres, 1024)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-6, atol=1e-6)
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_rect_plan_matches_jax(monkeypatch):
    """The port's rectangular plan is JAX's on the same ordering and
    geometry (the cost constant that sets its window growth aligned)."""
    from graphlearning_tpu.ops import accel as jaccel
    from graphlearning_tpu_torch.ops import accel

    W, pts = _knn_csr(2000, 10, seed=9)
    monkeypatch.setattr(accel, "_TILES_R", 256)
    monkeypatch.setattr(accel, "_TILES_WT", 128)
    monkeypatch.setattr(jaccel, "_HBM_BPS", accel._HBM_BPS)
    acc = AccelSpMM(W, device="cpu")
    jacc = JAccelSpMM(W, R=256, WT=128, max_residual=accel._MAX_RESIDUAL,
                      interpret=True)
    np.testing.assert_array_equal(acc._perm_dev.numpy(), jacc.perm)
    for a, b in zip(acc._rect_plan, jacc._rect_plan):
        _assert_same(a, b)
    assert acc.rect_band_bytes() == acc.n_pad * jacc._rect_plan[3] * 8


def test_packed_plan_needs_a_padded_size_it_divides(monkeypatch):
    """With tiles smaller than the packed geometry, n_pad need not be a
    multiple of it: the accel warns and keeps the unpacked tiles (it
    raised from the planner before)."""
    from graphlearning_tpu_torch.ops import accel

    W, _ = _knn_csr(800, 10, seed=3)
    monkeypatch.setattr(accel, "_TILES_R", 128)
    monkeypatch.setattr(accel, "_TILES_WT", 128)
    with pytest.warns(RuntimeWarning, match="packed geometry"):
        acc = AccelSpMM(W, device="cpu")
    assert acc.n_pad == 896 and not acc.packed
    X = np.random.RandomState(5).randn(800, 2)
    out = acc.from_perm(acc.spmm(acc.to_perm(torch.as_tensor(X)))).numpy()
    np.testing.assert_allclose(out, W @ X, rtol=1e-10, atol=1e-10)


# -- K5, K6, K8: the rectangular route ----------------------------------------


@pytest.fixture(scope="module")
def rect_plan(banded_ell):
    """The rectangular plan of the banded ELL at R = WT = 128: its window
    leaves edges out (a residual), so the window masks matter."""
    cols, vals, deg, _ = banded_ell
    winstart, rrows, _, W, kcap = jps.plan_banded(
        cols, R=128, WT=128, deg=deg, kcap_max=32, max_residual=0.05)
    assert W < 1024 and len(rrows) > 0
    return winstart, W, kcap


def _rect_inputs(banded_ell, rect_plan, dtype):
    cols, vals, _, _ = banded_ell
    winstart, W, kcap = rect_plan
    c = torch.as_tensor(cols[:, :kcap].copy())
    v = torch.as_tensor(vals[:, :kcap].astype(np.float32))
    band = bs.materialize_band(c, v, torch.as_tensor(winstart), W, R=128,
                               WT=128, out_dtype=dtype)
    plan = bs.RectPlan.from_numpy(winstart, 1024, 128, 128, W, kcap, "cpu")
    return c, v, band, plan


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_twin_matches_pallas(banded_ell, rect_plan, dtype):
    """Within 1e-5 of max|ref| in f32 and in bf16: both packages multiply
    the same values exactly in f32 (a bf16 band times bf16 X) and sum in
    f32 in other orders."""
    _, _, band, plan = _rect_inputs(banded_ell, rect_plan, dtype)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    X = np.random.RandomState(11).randn(1024, 5).astype(np.float32)
    ref = np.asarray(jps.band_spmm(
        jnp.asarray(band.float().numpy()).astype(jdt),
        jnp.asarray(plan.winstart_host), jnp.asarray(np.pad(X, ((0, 0),
                                                                (0, 123)))),
        R=128, WT=128, interpret=True, mode="f32"))[:, :5]
    out = bs.band_spmm(band, plan, torch.as_tensor(X).to(dtype))
    assert out.dtype == torch.float32 and out.shape == (1024, 5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_k6_twin_matches_pallas(banded_ell, rect_plan, mode):
    """The unstored band: within 1e-5 of max|ref| (f32) and 1e-2 (bf16,
    where JAX rounds the built block and X to bf16 and the port each value
    and X)."""
    c, v, _, _ = _rect_inputs(banded_ell, rect_plan, torch.float32)
    winstart, W, kcap = rect_plan
    plan = bs.BandedPlan.from_numpy(winstart, 1024, 128, 128, W, kcap, "cpu")
    X = np.random.RandomState(12).randn(1024, 3).astype(np.float32)
    ref = np.asarray(jps.banded_spmm(
        jnp.asarray(c.numpy()), jnp.asarray(v.numpy()),
        jnp.asarray(winstart), jnp.asarray(np.pad(X, ((0, 0), (0, 125)))),
        W=W, R=128, WT=128, interpret=True, mode=mode))[:, :3]
    tdt = torch.float32 if mode == "f32" else torch.bfloat16
    out = bs.banded_spmm(c, v.to(tdt), plan, torch.as_tensor(X).to(tdt))
    assert out.dtype == torch.float32 and out.shape == (1024, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=(
        1e-5 if mode == "f32" else 1e-2) * np.abs(ref).max())
    # the window masks: the in-window part of W @ X, at f64
    out64 = bs.banded_spmm(c, v.double(), plan, torch.as_tensor(X).double())
    Wp = banded_ell[3]
    lo = np.repeat(winstart, 128)[:, None]
    cc = c.numpy()
    keep = (cc >= lo) & (cc < lo + W)
    Win = sp.csr_matrix((np.where(keep, v.numpy(), 0).ravel(),
                         (np.repeat(np.arange(1024), kcap), cc.ravel())),
                        shape=(1024, 1024))
    np.testing.assert_allclose(out64.numpy(), Win @ X.astype(np.float64),
                               rtol=1e-12, atol=1e-12)
    assert abs(Win).sum() < abs(Wp).sum()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hopf_lax,recip", [(False, False), (True, False),
                                            (False, True), (True, True)])
def test_k8_twin_matches_pallas(banded_ell, rect_plan, dtype, hopf_lax,
                                recip):
    """Min within 1e-6 (relative), argmin tie-tolerant, -1 where no
    candidate; without the argmin the same min."""
    _, _, band, plan = _rect_inputs(banded_ell, rect_plan, dtype)
    _, _, _, d, f = _minplus_inputs(banded_ell, torch.float32)
    jband = jnp.asarray(band.float().numpy()).astype(
        jnp.float32 if dtype == torch.float32 else jnp.bfloat16)
    ref = np.asarray(jps.band_minplus(
        jband, jnp.asarray(plan.winstart_host), jnp.asarray(d),
        jnp.asarray(f), R=128, WT=128, hopf_lax=hopf_lax, track_arg=True,
        recip=recip, interpret=True))
    m, arg = bs.band_minplus(band, plan, torch.as_tensor(d),
                             torch.as_tensor(f), hopf_lax=hopf_lax,
                             track_arg=True, recip=recip)
    assert m.dtype == torch.float32 and arg.dtype == torch.int32
    dense = np.zeros((1024, 1024), np.float32)
    for b, s in enumerate(plan.winstart_host):
        dense[b * 128:(b + 1) * 128, s:s + plan.W] = \
            band.float().numpy()[b * 128:(b + 1) * 128]
    has = ref[:, 0] < 1e30
    _assert_minplus_matches_jax(m, arg, ref[:, 0],
                                np.where(has, ref[:, 1], -1), dense, d, f,
                                hopf_lax, recip)
    m2, none = bs.band_minplus(band, plan, torch.as_tensor(d),
                               torch.as_tensor(f), hopf_lax=hopf_lax,
                               recip=recip)
    assert none is None
    np.testing.assert_array_equal(m2.numpy(), m.numpy())


def test_window_plans_refuse_what_they_do_not_describe():
    with pytest.raises(ValueError):              # W not a multiple of WT
        bs.RectPlan.from_numpy(np.zeros(8, np.int32), 1024, 128, 128, 200,
                               10, "cpu")
    with pytest.raises(ValueError):              # one start per row block
        bs.BandedPlan.from_numpy(np.zeros(4, np.int32), 1024, 128, 128, 256,
                                 10, "cpu")
    plan = bs.BandedPlan.from_numpy(np.zeros(8, np.int32), 1024, 128, 128,
                                    256, 10, "cpu")
    with pytest.raises(TypeError):               # K5 and K8 take a RectPlan
        bs.band_spmm(torch.zeros(1024, 256), plan, torch.zeros(1024, 2))
    with pytest.raises(TypeError):
        bs.band_minplus(torch.zeros(1024, 256), plan, torch.zeros(1024),
                        torch.ones(1024))


_CSRC = Path(bs.__file__).resolve().parents[1] / "csrc"


def _constexprs(source):
    """The namespace-level ``constexpr int`` constants of a kernel source."""
    text = (_CSRC / source).read_text()
    return {k: int(v) for k, v in
            re.findall(r"^constexpr int (\w+) = (\d+);", text, re.M)}


@pytest.mark.parametrize("source,names", [
    ("band_tiles_spmm.cu", {"ROWS": "_TILES_ROWS", "KC": "_TILES_KC",
                            "DMAX": "_TILES_DMAX"}),
    # K10/K11 on the same CTA: its wide rows, chunk and width
    ("band_tiles_spmm.cu", {"QROWS": "_TILES_QROWS", "KC": "_TILES_KC",
                            "DMAX": "_TILES_DMAX"}),
    # K9 and K7 walk the tiles band's live-chunk list: a warp a row group,
    # a chunk of KC columns
    ("band_tiles_lip.cu", {"ROWS": "_LIVE_ROWS", "KC": "_LIVE_KC"}),
    # K5 on the same CTA: the window starts' alignment its X chunks need
    ("band_tiles_spmm.cu", {"WIN_ALIGN": "_RECT_WIN_ALIGN"}),
    # the exact grade's FFMA consumer: the widest d it takes
    ("band_tiles_spmm.cu", {"FMA_DMAX": "_TILES_FMA_DMAX"}),
    ("band_tiles_minplus.cu", {"ROWS": "_LIVE_ROWS", "KC": "_LIVE_KC"}),
    # K8 walks the same list: a CTA a row group, a stage a chunk
    ("band_rect_minplus.cu", {"ROWS": "_TILES_ROWS", "KC": "_TILES_KC"}),
])
def test_kernel_geometry_matches_the_wrapper_checks(source, names):
    """Each CUDA source's CTA geometry is the one its wrapper checks."""
    consts = _constexprs(source)
    for cname, pyname in names.items():
        assert consts[cname] == getattr(bs, pyname), (source, cname)


@pytest.mark.parametrize("library", sorted(_build.SIGNATURES))
def test_ctypes_signatures_match_the_sources(library):
    """Each ``extern "C"`` entry of a CUDA source takes the arguments its
    ctypes signature passes: a pointer for each pointer, a 32-bit int for
    each int and a 64-bit int for each long long."""
    text = (_CSRC / f"{library}.cu").read_text()
    kinds = {"int": ctypes.c_int, "long long": ctypes.c_longlong}
    for fname, argtypes in _build.SIGNATURES[library].items():
        found = re.search(r'extern "C" int ' + fname + r"\(([^)]*)\)", text)
        assert found, fname
        params = [" ".join(p.split()) for p in found.group(1).split(",")]
        want = [ctypes.c_void_p if "*" in p else
                kinds[p.rsplit(" ", 1)[0].replace("const ", "")]
                for p in params]
        assert argtypes == want, (fname, params)


def test_tiles_spmm_geometry_admits_the_main_path_plans():
    """K2/K3's CTA divides the packed and the unpacked plans of the
    accel, and the X block of a ring stage is whole 16-byte pieces for
    any d in both modes (KC * d * 4 and KC * d * 2 bytes)."""
    from graphlearning_tpu_torch.ops import accel

    for R, WT in ((accel._PACKED_R, accel._PACKED_WT),
                  (accel._TILES_R, accel._TILES_WT)):
        assert R % bs._TILES_ROWS == 0 and WT % bs._TILES_KC == 0
    assert bs._TILES_KC * 2 % 16 == 0
    assert bs._TILES_ROWS % 16 == 0              # whole m16 MMA tiles


def test_slab_plan_refuses_tile_starts_off_the_tile_grid():
    with pytest.raises(ValueError):
        bs.TilesPlan.from_tiles([0], [32], 256, 128, 64, "cpu")
    bs.TilesPlan.from_tiles([0], [64], 256, 128, 64, "cpu")


def _uneven_slabs():
    """Tiles of R=128, WT=64 over 4 row blocks and 1536 X rows: block 0
    holds 9 tiles, block 1 one, block 2 none, block 3 five."""
    rs = np.random.RandomState(4)
    R, WT, x_rows = 128, 64, 1536
    tb, ts = [], []
    for b, c in ((0, 9), (1, 1), (3, 5)):
        tb += [b] * c
        ts += sorted(rs.choice(x_rows // WT, c, replace=False) * WT)
    band = rs.randn(len(tb) * R, WT)
    band[rs.rand(*band.shape) < 0.95] = 0
    return band, np.asarray(tb, np.int32), np.asarray(ts, np.int32), R, WT


@pytest.mark.parametrize("S", [1, 4])
def test_tiles_spmm_twin_uneven_blocks_matches_dense(S):
    """K2 (S=4: slabs of 4, 4 and 1 tiles, pad tiles) and K3 (S=1) twins
    on very uneven blocks, an empty block and a rectangular X, against
    the dense product in f64."""
    band, tb, ts, R, WT = _uneven_slabs()
    n, x_rows = 4 * R, 1536
    dense = np.zeros((n, x_rows))
    for i, (b, s) in enumerate(zip(tb, ts)):
        dense[b * R:(b + 1) * R, s:s + WT] += band[i * R:(i + 1) * R]
    X = np.random.RandomState(5).randn(x_rows, 3)
    band_t = torch.as_tensor(band)
    if S == 1:
        plan = bs.TilesPlan.from_tiles(tb, ts, n, R, WT, "cpu")
        out = bs.band_tiles_spmm(band_t, plan, torch.as_tensor(X))
    else:
        bf = np.zeros(len(tb), np.int32)
        bf[np.unique(tb, return_index=True)[1]] = 1
        sb, sts, _, src = bs.pack_tiles(tb, ts, bf, S)
        assert (src < 0).any() and (np.bincount(sb) == [3, 1, 0, 2]).all()
        plan = bs.PackedPlan.from_slabs(sb, sts, src, n, R, WT, "cpu")
        out = bs.band_tiles_spmm_packed(bs.pack_band(band_t, src, R, WT),
                                        plan, torch.as_tensor(X))
    np.testing.assert_allclose(out.numpy(), dense @ X, rtol=1e-12,
                               atol=1e-12)
    assert not out[2 * R:3 * R].any()
