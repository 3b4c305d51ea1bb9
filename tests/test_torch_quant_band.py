"""The quantized bands of graphlearning_tpu_torch (K10, K11) against
graphlearning_tpu.

The quantizers must give the JAX package's arrays bit for bit; the plain
torch twins of K10 and K11, fed JAX's quantized arrays, are held against
the Pallas kernels in interpret mode and against scipy in f64.  The CUDA
kernels are held against the twins in ``test_torch_cuda_kernels.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import random_knn_csr
from graphlearning_tpu.core.sparse import SparseGraph as JSparseGraph
from graphlearning_tpu.ops import pallas_spmm as jps
from graphlearning_tpu.parallel.shard import pad_graph_to
from graphlearning_tpu_torch.ops import band_spmm as bs

torch.set_num_threads(2)

R, WT, S = 64, 128, 4


@pytest.fixture(scope="module")
def packed_case():
    """JAX's packed f32 band of ``random_knn_csr(1024, 8)`` at R=64,
    WT=128, S=4 (every edge in a tile), its slabs, the port's plan of
    them, and X (1024, 128) from a seed."""
    W = random_knn_csr(1024, 8, seed=11)
    g = pad_graph_to(JSparseGraph.from_scipy(W, dtype=jnp.float32), 128)
    tb, ts, bf, rr, _, _ = jps.plan_tiles(
        np.asarray(g.cols), R=R, WT=WT, deg=np.asarray(g.deg), kcap=g.k,
        min_edges_per_tile=1, hbm_budget_bytes=float("inf"))
    assert len(rr) == 0
    band = jps.materialize_band_tiles(
        g.cols, g.vals, jnp.asarray(tb), jnp.asarray(ts), R=R, WT=WT,
        interpret=True, out_dtype=jnp.float32)
    sb, sts, sbf, src = jps.pack_tiles(tb, ts, bf, S)
    packed = jps.pack_band(band, src, R=R, WT=WT)
    plan = bs.PackedPlan.from_slabs(sb, sts, src, g.n, R, WT, "cpu")
    X = np.random.RandomState(12).randn(g.n, 128).astype(np.float32)
    return W, g.n, packed, (sb, sts, sbf), plan, X


def _row_of(sb, R):
    return jnp.asarray(np.repeat(np.asarray(sb, np.int64) * R, R)
                       + np.tile(np.arange(R), len(sb)))


def _jax_rowq(band, row_of, n, planes):
    return jax.jit(functools.partial(jps.quantize_band_rowq, n=n,
                                     planes=planes))(band, row_of)


def test_packed_row_of_matches_the_jax_bench(packed_case):
    _, _, _, (sb, _, _), plan, _ = packed_case
    np.testing.assert_array_equal(bs.packed_row_of(plan).numpy(),
                                  np.asarray(_row_of(sb, R)))


@pytest.mark.parametrize("planes", [1, 2])
def test_quantize_band_rowq_bit_identical(packed_case, planes):
    _, n, packed, (sb, _, _), plan, _ = packed_case
    q_j, s_j = _jax_rowq(packed, _row_of(sb, R), n, planes)
    q_t, s_t = bs.quantize_band_rowq(torch.as_tensor(np.array(packed)),
                                     plan, n, planes)
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))


def test_quantize_band_i8_bit_identical(packed_case):
    _, _, packed, _, _, _ = packed_case
    hi_j, q_j = jps.quantize_band_i8(packed)
    hi_t, q_t = bs.quantize_band_i8(torch.as_tensor(np.array(packed)))
    assert hi_t.dtype == torch.bfloat16 and q_t.dtype == torch.int8
    np.testing.assert_array_equal(hi_t.view(torch.int16).numpy(),
                                  np.asarray(hi_j).view(np.int16))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))


def _edge_band():
    """The edge-case band of ``tests/test_pallas_spmm.py``
    (``test_quantize_band_rowq_edge_cases``): mixed signs, an all-zero
    row, a 1e6 range inside one row; as one slab per 8-row block."""
    G, Rb, SW = 2, 8, 256
    rs = np.random.RandomState(0)
    band = rs.randn(G * Rb, SW).astype(np.float32)
    band[3, :] = 0.0
    band[5, 0] = 1e3
    band[5, 1] = 1e-3
    band[7, :8] = -7.25
    plan = bs.PackedPlan.from_numpy([0, 1], [[0, 128], [0, 128]], [2, 2],
                                    G * Rb, Rb, 128, "cpu")
    return band, plan, G * Rb


@pytest.mark.parametrize("planes", [1, 2])
def test_quantize_band_rowq_edge_cases_bit_identical(planes):
    band, plan, n = _edge_band()
    q_j, s_j = _jax_rowq(jnp.asarray(band), jnp.arange(n), n, planes)
    q_t, s_t = bs.quantize_band_rowq(torch.as_tensor(band), plan, n, planes)
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert (s_t.numpy()[3] == 1.0) and not q_t[3].any()    # the zero row


def _reconstruct(q, s, planes, SW):
    q = np.asarray(q, np.float64)
    s = np.asarray(s, np.float64)
    if planes == 2:
        return (q[:, :SW] + q[:, SW:] / 254.0) * s[:, None], s / 254.0
    return q * s[:, None], s


@pytest.mark.parametrize("planes", [1, 2])
def test_rowq_underflow_departure(planes):
    """A row whose largest weight is 1e-40 (subnormal in f32): the port's
    exponent is clamped at -126, so its scale is 2**-126; the other rows'
    scales are JAX's, and both packages reconstruct every row within its
    own quantum."""
    band, plan, n = _edge_band()
    band[6, :] = 0.0
    band[6, :4] = np.float32(1e-40)
    q_j, s_j = _jax_rowq(jnp.asarray(band), jnp.arange(n), n, planes)
    q_t, s_t = bs.quantize_band_rowq(torch.as_tensor(band), plan, n, planes)
    assert s_t[6].item() == 2.0 ** -126
    others = np.arange(n) != 6
    np.testing.assert_array_equal(s_t.numpy()[others],
                                  np.asarray(s_j)[others])
    for q, s in ((q_t.numpy(), s_t.numpy()), (q_j, s_j)):
        rec, quantum = _reconstruct(q, s, planes, band.shape[1])
        err = np.abs(rec - band.astype(np.float64))
        assert (err <= quantum[:, None] + 1e-45).all()


@pytest.fixture(scope="module")
def quantized(packed_case):
    """JAX's quantized arrays (numpy), and the Pallas kernels' outputs in
    interpret mode (X bf16 for planes 1)."""
    _, n, packed, (sb, sts, sbf), _, X = packed_case
    slabs = (jnp.asarray(sb), jnp.asarray(sts), jnp.asarray(sbf))
    out = {}
    for planes in (1, 2):
        q, s = _jax_rowq(packed, _row_of(sb, R), n, planes)
        Xk = jnp.asarray(X).astype(jnp.bfloat16 if planes == 1
                                   else jnp.float32)
        ref = jps.band_tiles_spmm_packed_rowq(
            q, s, *slabs, Xk, n=n, R=R, WT=WT, S=S, planes=planes,
            interpret=True)
        out[f"rowq{planes}"] = ((np.array(q), np.array(s)),
                                np.asarray(ref))
    hi, q = jps.quantize_band_i8(packed)
    ref = jps.band_tiles_spmm_packed_i8(hi, q, *slabs, jnp.asarray(X), n=n,
                                        R=R, WT=WT, S=S, interpret=True)
    out["i8"] = ((np.array(hi).view(np.int16), np.array(q)),
                 np.asarray(ref))
    return out


def _port_twin(kind, arrays, plan, X):
    if kind == "i8":
        hi, q = arrays
        return bs.band_tiles_spmm_packed_i8(
            torch.as_tensor(hi).view(torch.bfloat16), torch.as_tensor(q),
            plan, torch.as_tensor(X))
    planes = int(kind[-1])
    qband, srow = arrays
    Xk = torch.as_tensor(X)
    if planes == 1:
        Xk = Xk.to(torch.bfloat16)
    return bs.band_tiles_spmm_packed_rowq(torch.as_tensor(qband),
                                          torch.as_tensor(srow), plan, Xk,
                                          planes)


# Of max|ref|: planes=1 multiplies exactly in both packages (int8 times
# bf16) and sums in f32; planes=2 and i8 lose JAX's dropped q_lo * x_lo
# (resp. A_lo * x_lo) term, about 2**-16 of a product.
TWIN_TOL = {"rowq1": 1e-5, "rowq2": 1e-4, "i8": 1e-4}
# Against scipy f64, as tests/test_pallas_spmm.py grades the JAX kernels.
SCIPY_GRADE = {"rowq1": 2e-2, "rowq2": 1e-4, "i8": 1e-4}


@pytest.mark.parametrize("kind", ["rowq1", "rowq2", "i8"])
def test_quantized_twins_match_pallas_and_scipy(packed_case, quantized,
                                                kind):
    W, n, _, _, plan, X = packed_case
    arrays, ref = quantized[kind]
    out = _port_twin(kind, arrays, plan, X)
    assert out.shape == (n, 128) and out.dtype == torch.float32
    out = out.numpy().astype(np.float64)
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() <= TWIN_TOL[kind] * scale
    m = W.shape[0]
    ref64 = W @ X[:m].astype(np.float64)
    rel = np.abs(out[:m] - ref64).max() / np.abs(ref64).max()
    assert rel < SCIPY_GRADE[kind], rel


def test_quantized_twins_run_f64(packed_case, quantized):
    """f64 X runs the twins in f64: K10 planes=2 and K11 then reproduce
    their dequantized band exactly."""
    W, n, _, _, plan, X = packed_case
    X64 = torch.as_tensor(X, dtype=torch.float64)
    (qband, srow), _ = quantized["rowq2"]
    out = bs.band_tiles_spmm_packed_rowq(torch.as_tensor(qband),
                                         torch.as_tensor(srow), plan, X64, 2)
    assert out.dtype == torch.float64
    (hi, q), _ = quantized["i8"]
    hi_t = torch.as_tensor(hi).view(torch.bfloat16)
    out8 = bs.band_tiles_spmm_packed_i8(hi_t, torch.as_tensor(q), plan, X64)
    A = bs._dequantize_i8(hi_t, torch.as_tensor(q), torch.float64)
    ref = bs._tiles_spmm_plain(A, plan, X64)
    torch.testing.assert_close(out8, ref, rtol=1e-12, atol=1e-12)
    m = W.shape[0]
    ref64 = W @ X[:m].astype(np.float64)
    rel = np.abs(out.numpy()[:m] - ref64).max() / np.abs(ref64).max()
    assert rel < 1e-4, rel


def test_quantized_wrappers_refuse():
    band, plan, n = _edge_band()
    q, s = bs.quantize_band_rowq(torch.as_tensor(band), plan, n, 2)
    X = torch.zeros((n, 2))
    with pytest.raises(ValueError):
        bs.quantize_band_rowq(torch.as_tensor(band), plan, n, 3)
    with pytest.raises(ValueError):
        bs.quantize_band_rowq(torch.as_tensor(band).double(), plan, n, 2)
    with pytest.raises(ValueError):
        bs.band_tiles_spmm_packed_rowq(q, s, plan, X, 3)
    tiles = bs.TilesPlan.from_tiles([0], [0], n, 8, 128, "cpu")
    with pytest.raises(TypeError):
        bs.band_tiles_spmm_packed_rowq(q, s, tiles, X, 2)
    hi, q8 = bs.quantize_band_i8(torch.as_tensor(band))
    with pytest.raises(TypeError):
        bs.band_tiles_spmm_packed_i8(hi, q8, tiles, X)
    with pytest.raises(ValueError):
        bs.quantize_band_i8(torch.as_tensor(band).double())


@pytest.fixture(scope="module")
def uneven_packed():
    """Tiles of R=128, WT=64 over 4 row blocks and 1536 X rows (block 0
    holds 9 tiles, block 1 one, block 2 none, block 3 five; 95 % of the
    cells zero), packed by JAX at S=4: slabs of 4, 4 and 1 tiles (pad
    tiles), 1, then 4 and 1.  JAX's packed band, slabs and quantized
    arrays, the port's plan, and X (1536, 130) from a seed."""
    rs = np.random.RandomState(4)
    Ru, WTu, Su, x_rows = 128, 64, 4, 1536
    tb, ts = [], []
    for b, c in ((0, 9), (1, 1), (3, 5)):
        tb += [b] * c
        ts += sorted(rs.choice(x_rows // WTu, c, replace=False) * WTu)
    tb = np.asarray(tb, np.int32)
    ts = np.asarray(ts, np.int32)
    band = rs.randn(len(tb) * Ru, WTu).astype(np.float32)
    band[rs.rand(*band.shape) < 0.95] = 0
    bf = np.zeros(len(tb), np.int32)
    bf[np.unique(tb, return_index=True)[1]] = 1
    sb, sts, sbf, src = jps.pack_tiles(tb, ts, bf, Su)
    assert (np.asarray(src) < 0).any()
    packed = jps.pack_band(jnp.asarray(band), src, R=Ru, WT=WTu)
    n = 4 * Ru
    plan = bs.PackedPlan.from_slabs(sb, sts, src, n, Ru, WTu, "cpu")
    X = np.random.RandomState(6).randn(x_rows, 130).astype(np.float32)
    return packed, (sb, sts, sbf), plan, X, (n, Ru, WTu, Su)


@pytest.mark.parametrize("kind", ["rowq1", "rowq2", "i8"])
def test_quantized_twins_uneven_plan_match_pallas(uneven_packed, kind):
    """K10/K11's twins on an uneven packed plan with pad tiles, an empty
    row block and d=130, fed JAX's quantized arrays, against the Pallas
    kernels in interpret mode (X zero-padded to their 256 lanes); the
    empty block comes out 0 (the Pallas grid never visits it)."""
    packed, slabs, plan, X, (n, Ru, WTu, Su) = uneven_packed
    sb = slabs[0]
    slabs = tuple(jnp.asarray(a) for a in slabs)
    Xpad = np.zeros((X.shape[0], 256), np.float32)
    Xpad[:, :130] = X
    if kind == "i8":
        hi, q = jps.quantize_band_i8(packed)
        ref = jps.band_tiles_spmm_packed_i8(
            hi, q, *slabs, jnp.asarray(Xpad), n=n, R=Ru, WT=WTu, S=Su,
            interpret=True)
        arrays = (np.array(hi).view(np.int16), np.array(q))
    else:
        planes = int(kind[-1])
        q, s = _jax_rowq(packed, _row_of(sb, Ru), n, planes)
        Xk = jnp.asarray(Xpad).astype(jnp.bfloat16 if planes == 1
                                      else jnp.float32)
        ref = jps.band_tiles_spmm_packed_rowq(
            q, s, *slabs, Xk, n=n, R=Ru, WT=WTu, S=Su, planes=planes,
            interpret=True)
        arrays = (np.array(q), np.array(s))
    ref = np.asarray(ref, np.float64)[:, :130]
    out = _port_twin(kind, arrays, plan, X)
    assert out.shape == (n, 130) and out.dtype == torch.float32
    out = out.numpy().astype(np.float64)
    live = np.ones(n, bool)
    live[2 * Ru:3 * Ru] = False
    scale = np.abs(ref[live]).max()
    assert np.abs(out[live] - ref[live]).max() <= TWIN_TOL[kind] * scale
    assert not out[~live].any()


def test_quantized_geometry_admits_the_bench_plan():
    """The bench's packed (256, 128, 12) plan meets K10/K11's CTA (R a
    multiple of the 128-row CTA, WT of the 64-column chunk), and every
    staged plane row is whole 16-byte pieces: a chunk of 64 int8 or bf16
    cells, rows S*WT int8 or bf16 cells apart, plane lo S*WT bytes after
    plane hi."""
    from graphlearning_tpu_torch.ops import accel

    R_, WT_, S_ = accel._PACKED_R, accel._PACKED_WT, accel._PACKED_S
    assert R_ % bs._TILES_QROWS == 0 and bs._TILES_QROWS % bs._TILES_ROWS == 0
    assert WT_ % bs._TILES_KC == 0
    for cell in (1, 2):
        assert bs._TILES_KC * cell % 16 == 0
        assert S_ * WT_ * cell % 16 == 0
