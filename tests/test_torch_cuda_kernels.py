"""The CUDA kernels K1-K11 of graphlearning_tpu_torch against their plain
torch twins, on a GPU (K5 and K8 on the rectangular band's live chunks,
K7 and K9 on the tiles band's).

Every test here needs the card: it carries the ``cuda`` marker and skips
without one.  The file imports neither JAX nor the JAX package, so it runs
where only torch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

(``--noconftest``: the suite's conftest imports JAX.)  The twins are held
against the JAX package in ``test_torch_band_spmm.py``.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.csgraph import reverse_cuthill_mckee
from scipy.spatial import cKDTree

from graphlearning_tpu_torch.core.sparse import SparseGraph
from graphlearning_tpu_torch.ops import band_spmm as bs
from graphlearning_tpu_torch.ops.accel import AccelSpMM

torch.set_num_threads(2)

# Tolerance of a kernel against its twin, of max|ref|: both sum exact f32
# products (bf16 products are exact in f32) in other orders.
TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _knn_csr(n, k, seed):
    rs = np.random.RandomState(seed)
    pts = rs.rand(n, 2)
    dist, ind = cKDTree(pts).query(pts, k=k + 1)
    dist, ind = dist[:, 1:], ind[:, 1:]
    w = np.exp(-4 * dist ** 2 / np.maximum(dist[:, -1:] ** 2, 1e-12))
    W = sp.csr_matrix((w.ravel(), (np.repeat(np.arange(n), k), ind.ravel())),
                      shape=(n, n))
    W = ((W + W.T) / 2).tocsr()
    W._glt_points = pts
    return W


@pytest.fixture(scope="module")
def banded_tiles():
    """RCM-ordered kNN graph padded to 1024 rows, every edge in a tile."""
    W = _knn_csr(1000, 10, seed=0)
    perm = np.asarray(reverse_cuthill_mckee(W, symmetric_mode=True))
    Wp = W[perm][:, perm].tocsr()
    Wp.resize((1024, 1024))
    cols, vals, deg = SparseGraph.ell_from_scipy(Wp)
    R, WT = 128, 64
    tb, ts, bf, rr, _, _ = bs.plan_tiles(
        cols, R=R, WT=WT, deg=deg, kcap=cols.shape[1], min_edges_per_tile=1,
        hbm_budget_bytes=float("inf"))
    assert len(rr) == 0
    return cols, vals.astype(np.float32), tb, ts, bf, R, WT


def _close(out, ref, dtype):
    torch.testing.assert_close(out, ref, rtol=0,
                               atol=TOL[dtype] * float(ref.abs().max()))


# d of the K2/K3 cases: the MMA's n = 8 padding (1-16), one and several
# 32-column warp groups (40, 128), and the 128-column launches above 128
TILES_D = [1, 2, 3, 8, 10, 16, 40, 128, 130]


def _tiles_launches(d):
    return -(-d // bs._TILES_DMAX)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", TILES_D)
def test_cuda_kernels_match_twins(banded_tiles, cuda_device, dtype, d):
    cols, vals, tb, ts, bf, R, WT = banded_tiles
    dev = cuda_device
    args = tuple(torch.as_tensor(a, device=dev) for a in (cols, vals, tb, ts))
    n0 = bs.materialize_band_tiles.launches
    band = bs.materialize_band_tiles(*args, R=R, WT=WT, out_dtype=dtype)
    assert bs.materialize_band_tiles.launches == n0 + 1
    ref = bs._materialize_band_tiles_plain(*args, R, WT, dtype)
    torch.testing.assert_close(band, ref, rtol=0, atol=0)

    X = torch.randn((1024, d), device=dev).to(dtype)
    plan = bs.TilesPlan.from_tiles(tb, ts, 1024, R, WT, dev)
    n0 = bs.band_tiles_spmm.launches
    out = bs.band_tiles_spmm(band, plan, X)
    assert bs.band_tiles_spmm.launches == n0 + _tiles_launches(d)
    ref = bs._tiles_spmm_plain(band, plan, X)
    _close(out, ref, dtype)

    sb, sts, _, src = bs.pack_tiles(tb, ts, bf, 4)
    packed = bs.pack_band(band, src, R=R, WT=WT)
    pplan = bs.PackedPlan.from_slabs(sb, sts, src, 1024, R, WT, dev)
    n0 = bs.band_tiles_spmm_packed.launches
    out = bs.band_tiles_spmm_packed(packed, pplan, X)
    assert bs.band_tiles_spmm_packed.launches == n0 + _tiles_launches(d)
    _close(out, ref, dtype)


def _uneven_slabs(R):
    """Tiles of R rows and WT=64 over 4 row blocks and 1536 X rows: block
    0 holds 9 tiles (slabs of 4, 4 and 1 at S=4, so pad tiles), block 1 a
    single tile, block 2 none, block 3 five.  95 % of the cells are zero,
    and rows 16-47 of block 0's tiles are all zero (whole MMA fragments
    for the kernel to skip)."""
    rs = np.random.RandomState(4)
    WT, S, x_rows = 64, 4, 1536
    tb, ts = [], []
    for b, c in ((0, 9), (1, 1), (3, 5)):
        tb += [b] * c
        ts += sorted(rs.choice(x_rows // WT, c, replace=False) * WT)
    tb = np.asarray(tb, np.int32)
    band = rs.randn(len(tb) * R, WT).astype(np.float32)
    band[rs.rand(*band.shape) < 0.95] = 0
    band.reshape(len(tb), R, WT)[tb == 0, 16:48] = 0
    bf = np.zeros(len(tb), np.int32)
    bf[np.unique(tb, return_index=True)[1]] = 1
    return band, tb, np.asarray(ts, np.int32), bf, R, WT, S, x_rows


@pytest.fixture(scope="module")
def uneven_slabs():
    return _uneven_slabs(128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", TILES_D)
def test_cuda_tiles_spmm_uneven_blocks_rectangular_x(uneven_slabs,
                                                     cuda_device, dtype, d):
    """K3 and K2 on very uneven blocks (9, 1, 0 and 5 tiles), pad tiles
    and a rectangular X (1536 rows for 512 outputs) against their twins;
    the empty block comes out 0."""
    band_np, tb, ts, bf, R, WT, S, x_rows = uneven_slabs
    dev = cuda_device
    n = 4 * R
    band = torch.as_tensor(band_np, device=dev).to(dtype)
    X = torch.randn((x_rows, d), device=dev).to(dtype)
    plan = bs.TilesPlan.from_tiles(tb, ts, n, R, WT, dev)
    n0 = bs.band_tiles_spmm.launches
    out = bs.band_tiles_spmm(band, plan, X)
    assert bs.band_tiles_spmm.launches == n0 + _tiles_launches(d)
    ref = bs._tiles_spmm_plain(band, plan, X)
    _close(out, ref, dtype)
    assert not out[2 * R:3 * R].any()

    sb, sts, _, src = bs.pack_tiles(tb, ts, bf, S)
    assert (src < 0).any()
    packed = bs.pack_band(band, src, R=R, WT=WT)
    pplan = bs.PackedPlan.from_slabs(sb, sts, src, n, R, WT, dev)
    n0 = bs.band_tiles_spmm_packed.launches
    out = bs.band_tiles_spmm_packed(packed, pplan, X)
    assert bs.band_tiles_spmm_packed.launches == n0 + _tiles_launches(d)
    _close(out, ref, dtype)
    assert not out[2 * R:3 * R].any()


@pytest.mark.cuda
def test_cuda_tiles_spmm_refuses_misaligned_operands(banded_tiles,
                                                     cuda_device):
    """K2/K3's ring copies 16-byte pieces: a band or an X that does not
    start on a 16-byte boundary is refused, not copied."""
    cols, vals, tb, ts, bf, R, WT = banded_tiles
    dev = cuda_device
    args = [torch.as_tensor(a, device=dev) for a in (cols, vals, tb, ts)]
    band = bs.materialize_band_tiles(*args, R=R, WT=WT)
    plan = bs.TilesPlan.from_tiles(tb, ts, 1024, R, WT, dev)
    X = torch.randn((1024, 3), device=dev)
    X_off = torch.zeros(1024 * 3 + 1, device=dev)[1:].view(1024, 3)
    X_off.copy_(X)
    assert X_off.is_contiguous() and X_off.data_ptr() % 16
    with pytest.raises(ValueError):
        bs.band_tiles_spmm(band, plan, X_off)
    band_off = torch.zeros(band.numel() + 1, device=dev)[1:].view_as(band)
    band_off.copy_(band)
    with pytest.raises(ValueError):
        bs.band_tiles_spmm(band_off, plan, X)
    sb, sts, _, src = bs.pack_tiles(tb, ts, bf, 4)
    pplan = bs.PackedPlan.from_slabs(sb, sts, src, 1024, R, WT, dev)
    with pytest.raises(ValueError):
        bs.band_tiles_spmm_packed(bs.pack_band(band, src, R=R, WT=WT),
                                  pplan, X_off)
    _close(bs.band_tiles_spmm(band, plan, X),
           bs._tiles_spmm_plain(band, plan, X), torch.float32)


@pytest.mark.cuda
def test_cuda_wrappers_refuse_what_the_kernels_do_not_take(banded_tiles,
                                                           cuda_device):
    cols, vals, tb, ts, _, R, WT = banded_tiles
    dev = cuda_device
    args = [torch.as_tensor(a, device=dev) for a in (cols, vals, tb, ts)]
    with pytest.raises(ValueError):          # f64 has only the CPU twin
        bs.materialize_band_tiles(*args, R=R, WT=WT, out_dtype=torch.float64)
    band = bs.materialize_band_tiles(*args, R=R, WT=WT)
    plan = bs.TilesPlan.from_tiles(tb, ts, 1024, R, WT, dev)
    with pytest.raises(ValueError):          # X on another device
        bs.band_tiles_spmm(band, plan, torch.zeros(1024, 2))
    with pytest.raises(ValueError):          # too few X rows
        bs.band_tiles_spmm(band, plan, torch.zeros(512, 2, device=dev))
    with pytest.raises(TypeError):           # the unpacked plan is not K2's
        bs.band_tiles_spmm_packed(band, plan, torch.zeros(1024, 2,
                                                          device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
def test_cuda_accel_spmm_matches_scipy(cuda_device, packed):
    W = _knn_csr(9000, 10, seed=1)
    acc = AccelSpMM(W, device=cuda_device, packed=packed)
    assert acc.packed == packed
    X = np.random.RandomState(2).randn(9000, 4)
    launches = dict(bs.launches())
    out = acc.from_perm(acc.spmm(acc.to_perm(
        torch.as_tensor(X, dtype=torch.float32, device=cuda_device))))
    after = bs.launches()
    kernel = "band_tiles_spmm_packed" if packed else "band_tiles_spmm"
    assert after[kernel] == launches[kernel] + 1
    assert after["materialize_band_tiles"] == (
        launches["materialize_band_tiles"] + 1)
    ref = W @ X
    np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_rect_band_matches_twin(cuda_device, dtype):
    """K4: exact in f32; in bf16 within one rounding (4e-3 of max|ref|),
    as K1."""
    W = _knn_csr(1000, 10, seed=0)
    perm = np.asarray(reverse_cuthill_mckee(W, symmetric_mode=True))
    Wp = W[perm][:, perm].tocsr()
    Wp.resize((1024, 1024))
    cols, vals, deg = SparseGraph.ell_from_scipy(Wp)
    winstart, _, _, Wr, kcap = bs.plan_banded(cols, R=128, WT=128, deg=deg,
                                              kcap_max=32)
    dev = cuda_device
    c = torch.as_tensor(cols[:, :kcap], device=dev).contiguous()
    v = torch.as_tensor(vals[:, :kcap].astype(np.float32),
                        device=dev).contiguous()
    ws = torch.as_tensor(winstart, device=dev)
    n0 = bs.materialize_band.launches
    out = bs.materialize_band(c, v, ws, Wr, R=128, WT=128, out_dtype=dtype)
    assert bs.materialize_band.launches == n0 + 1
    ref = bs._materialize_band_plain(c, v, ws, Wr, 128, dtype)
    tol = 0 if dtype == torch.float32 else 4e-3 * float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=tol)


def _minplus_case(banded_tiles, dev, dtype):
    cols, vals, tb, ts, _, R, WT = banded_tiles
    args = tuple(torch.as_tensor(a, device=dev) for a in (cols, vals, tb, ts))
    band = bs.materialize_band_tiles(*args, R=R, WT=WT, out_dtype=dtype)
    plan = bs.TilesPlan.from_tiles(tb, ts, 1024, R, WT, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    d = torch.rand(1024, generator=gen, device=dev) * 3
    d[torch.rand(1024, generator=gen, device=dev) < 0.3] = bs.MINPLUS_BIG
    f = torch.rand(1024, generator=gen, device=dev) + 0.5
    return band, plan, d, f


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hopf_lax", [False, True])
@pytest.mark.parametrize("recip", [False, True])
@pytest.mark.parametrize("track_arg", [False, True])
def test_cuda_minplus_matches_twin(banded_tiles, cuda_device, dtype,
                                   hopf_lax, recip, track_arg):
    """K7: min and argmin identical to the twin (the same f32
    operations, no contraction)."""
    band, plan, d, f = _minplus_case(banded_tiles, cuda_device, dtype)
    n0 = bs.band_tiles_minplus.launches
    m, arg = bs.band_tiles_minplus(band, plan, d, f, hopf_lax=hopf_lax,
                                   track_arg=track_arg, recip=recip)
    assert bs.band_tiles_minplus.launches == n0 + 1
    rm, rarg = bs._tiles_minplus_plain(band, plan, d, f, hopf_lax,
                                       track_arg, recip)
    torch.testing.assert_close(m, rm, rtol=0, atol=0)
    assert bool((m < bs.MINPLUS_BIG).any()) and bool(
        (m == bs.MINPLUS_BIG).any())
    if track_arg:
        torch.testing.assert_close(arg, rarg, rtol=0, atol=0)
    else:
        assert arg is None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 2, 3, 10, 32])
def test_cuda_lip_matches_twin(banded_tiles, cuda_device, dtype, C):
    """K9: sums within the K2 tolerance of max|ref|, min and max
    identical."""
    band, plan, _, _ = _minplus_case(banded_tiles, cuda_device, dtype)
    U = torch.randn((1024, C), device=cuda_device)
    n0 = bs.band_tiles_lip.launches
    out = bs.band_tiles_lip(band, plan, U)
    assert bs.band_tiles_lip.launches == n0 + 1
    ref = bs._tiles_lip_plain(band, plan, U)
    _close(out[0], ref[0], dtype)
    torch.testing.assert_close(out[1], ref[1], rtol=0, atol=0)
    torch.testing.assert_close(out[2], ref[2], rtol=0, atol=0)


@pytest.mark.cuda
def test_cuda_distance_and_lip_wrappers_refuse(banded_tiles, cuda_device):
    band, plan, d, f = _minplus_case(banded_tiles, cuda_device,
                                     torch.float32)
    with pytest.raises(ValueError):          # f64 distances on CUDA
        bs.band_tiles_minplus(band, plan, d.double(), f.double())
    with pytest.raises(ValueError):          # too many classes
        bs.band_tiles_lip(band, plan, torch.zeros((1024, 33),
                                                  device=cuda_device))
    with pytest.raises(ValueError):          # U on another device
        bs.band_tiles_lip(band, plan, torch.zeros((1024, 2)))


@pytest.mark.cuda
def test_cuda_accel_distance_and_lip_take_the_kernels(cuda_device):
    """bellman_ford runs K1 + K7 and matches the plain Bellman-Ford;
    lip_gs_mc builds its band with K4; lip_iterate_mc runs K9."""
    from graphlearning_tpu_torch.solvers import eikonal, plaplace

    W = _knn_csr(9000, 10, seed=1)
    acc = AccelSpMM(W, device=cuda_device)
    g = SparseGraph.from_scipy(W, device=cuda_device)
    seeds = np.random.RandomState(0).choice(9000, 6, replace=False)
    before = dict(bs.launches())
    d_b, cp_b = eikonal.dijkstra(g, seeds, return_cp=True, accel=acc)
    d_p, cp_p = eikonal.dijkstra(g, seeds, return_cp=True)
    after = bs.launches()
    assert after["band_tiles_minplus"] > before["band_tiles_minplus"]
    np.testing.assert_allclose(d_b, d_p, rtol=1e-5, atol=1e-6)
    assert np.mean(cp_b == cp_p) > 0.999
    C = 2
    mask = np.zeros(9000, bool)
    mask[seeds] = True
    gv = np.zeros((9000, C))
    gv[seeds] = np.eye(C)[np.arange(6) % C]
    u_k9, _ = acc.lip_iterate_mc(np.zeros((9000, C)), mask, gv, 0.0, 1.0,
                                 0.0, 200)
    u_pl, _ = plaplace._lip_iterate_mc(
        g, torch.zeros((9000, C), device=cuda_device),
        torch.as_tensor(mask, device=cuda_device),
        torch.as_tensor(gv, dtype=torch.float32, device=cuda_device), 0.0,
        1.0, 0.0, 200)
    np.testing.assert_allclose(u_k9.cpu().numpy(), u_pl.cpu().numpy(),
                               rtol=2e-3, atol=2e-4)
    assert acc.rect_band_ok()
    acc.lip_gs_mc(u_pl, mask, gv, 0.0, 1.0, 1e-3, 30)
    assert bs.launches()["materialize_band"] == after["materialize_band"] + 1
    assert bs.launches()["band_tiles_lip"] >= after["band_tiles_lip"] + 200


def _tiles_chunk_band(banded_tiles, dev, kind, dtype):
    """K7's and K9's bands on the tiles plan: ``rcm``, K1's band;
    ``empty_group``, the same with output rows 16-31 (one warp's row
    group, in every tile of block 0) zeroed; ``all_live``, random positive
    cells, about 5 % nonzero, so every 16 x 32 chunk is live; ``ties``,
    every nonzero cell of K1's band 1.  Returns the band, the plan and its
    list."""
    band, plan, _, _ = _minplus_case(banded_tiles, dev, dtype)
    rows, kc = bs._LIVE_ROWS, bs._LIVE_KC
    if kind == "empty_group":
        band.view(-1, plan.R, plan.WT)[plan.slab_block == 0,
                                       rows:2 * rows] = 0
    elif kind == "all_live":
        rs = np.random.RandomState(7)
        shape = tuple(band.shape)
        cells = rs.rand(*shape) * (rs.rand(*shape) < 0.05)
        band = torch.as_tensor(cells, dtype=torch.float32,
                               device=dev).to(dtype)
    elif kind == "ties":
        band = (band != 0).to(dtype)
    chunks = bs.tiles_live_chunks(band, plan)
    n_live = chunks[1].numel()
    n_all = band.numel() // (rows * kc)
    assert n_live == n_all if kind == "all_live" else 0 < n_live < n_all
    if kind == "empty_group":
        assert int(chunks[0][2]) == int(chunks[0][1])
    return band, plan, chunks


TILES_CHUNK_KINDS = ["rcm", "empty_group", "all_live", "ties"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", TILES_CHUNK_KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hopf_lax", [False, True])
@pytest.mark.parametrize("recip", [False, True])
@pytest.mark.parametrize("track_arg", [False, True])
def test_cuda_tiles_minplus_on_the_live_chunks(banded_tiles, cuda_device,
                                               kind, dtype, hopf_lax, recip,
                                               track_arg):
    """K7 on the list: min and argmin identical to the dense twin, on the
    tie band (constant d and f: every candidate of a row ties, the first
    in tile, then column, order wins) too; the empty row group gets
    MINPLUS_BIG and -1."""
    dev = cuda_device
    band, plan, chunks = _tiles_chunk_band(banded_tiles, dev, kind, dtype)
    gen = torch.Generator(device=dev).manual_seed(1)
    if kind == "ties":
        d = torch.ones(1024, device=dev)
        f = torch.full((1024,), 0.75, device=dev)
    else:
        d = torch.rand(1024, generator=gen, device=dev) * 3
        d[torch.rand(1024, generator=gen, device=dev) < 0.3] = \
            bs.MINPLUS_BIG
        f = torch.rand(1024, generator=gen, device=dev) + 0.5
    n0 = bs.band_tiles_minplus.launches
    m, arg = bs.band_tiles_minplus(band, plan, d, f, hopf_lax=hopf_lax,
                                   track_arg=track_arg, recip=recip,
                                   chunks=chunks)
    assert bs.band_tiles_minplus.launches == n0 + 1
    rm, rarg = bs._tiles_minplus_plain(band, plan, d, f, hopf_lax, track_arg,
                                       recip)
    torch.testing.assert_close(m, rm, rtol=0, atol=0)
    assert bool((m < bs.MINPLUS_BIG).any())
    if track_arg:
        torch.testing.assert_close(arg, rarg, rtol=0, atol=0)
    if kind == "empty_group":
        rows = slice(bs._LIVE_ROWS, 2 * bs._LIVE_ROWS)
        assert bool((m[rows] == bs.MINPLUS_BIG).all())
        if track_arg:
            assert bool((arg[rows] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rcm", "empty_group", "all_live"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C", [1, 2, 3, 10, 32])
def test_cuda_tiles_lip_on_the_live_chunks(banded_tiles, cuda_device, kind,
                                           dtype, C):
    """K9 on the list: sums within the K2 tolerance of max|ref|, min and
    max identical to the dense twin; the empty row group gets 0 and the
    LIP_BIG identities."""
    dev = cuda_device
    band, plan, chunks = _tiles_chunk_band(banded_tiles, dev, kind, dtype)
    U = torch.randn((1024, C), device=dev)
    n0 = bs.band_tiles_lip.launches
    out = bs.band_tiles_lip(band, plan, U, chunks)
    assert bs.band_tiles_lip.launches == n0 + 1
    ref = bs._tiles_lip_plain(band, plan, U)
    _close(out[0], ref[0], dtype)
    torch.testing.assert_close(out[1], ref[1], rtol=0, atol=0)
    torch.testing.assert_close(out[2], ref[2], rtol=0, atol=0)
    if kind == "empty_group":
        rows = slice(bs._LIVE_ROWS, 2 * bs._LIVE_ROWS)
        assert not out[0][rows].any()
        assert bool((out[1][rows] == bs.LIP_BIG).all())
        assert bool((out[2][rows] == -bs.LIP_BIG).all())


@pytest.mark.cuda
def test_cuda_tiles_chunks_none_matches_the_cached_list(cuda_device):
    """K7 and K9 without a list build their own from the band: the same
    outputs, bit for bit, as with the list ``AccelSpMM`` caches beside its
    tiles band, which is the list the CPU builds from the same band."""
    W = _knn_csr(9000, 10, seed=1)
    acc = AccelSpMM(W, device=cuda_device)
    band, plan = acc.tiles_band(), acc.tiles_plan
    chunks = acc.live_chunks(band)
    assert acc.live_chunks(acc.tiles_band()) is chunks
    cpu_plan = bs.TilesPlan.from_tiles(
        plan.slab_block.cpu().numpy(), plan.slab_starts[:, 0].cpu().numpy(),
        plan.n, plan.R, plan.WT, "cpu")
    for a, b in zip(chunks, bs.tiles_live_chunks(band.cpu(), cpu_plan)):
        assert torch.equal(a.cpu(), b)
    d = torch.rand(acc.n_pad, device=cuda_device) * 3
    f = torch.rand(acc.n_pad, device=cuda_device) + 0.5
    for a, b in zip(bs.band_tiles_minplus(band, plan, d, f, track_arg=True),
                    bs.band_tiles_minplus(band, plan, d, f, track_arg=True,
                                          chunks=chunks)):
        assert torch.equal(a, b)
    U = torch.randn((acc.n_pad, 3), device=cuda_device)
    for a, b in zip(bs.band_tiles_lip(band, plan, U),
                    bs.band_tiles_lip(band, plan, U, chunks)):
        assert torch.equal(a, b)
    b16 = acc.build_band(torch.bfloat16, tiles=True)
    assert acc.live_chunks(b16) is not chunks


@pytest.mark.cuda
def test_cuda_tiles_chunk_wrappers_refuse(banded_tiles, cuda_device):
    """K7 and K9 refuse operands off a 16-byte boundary, a plan whose R or
    WT the warp's chunk does not divide, and a broken list."""
    dev = cuda_device
    band, plan, d, f = _minplus_case(banded_tiles, dev, torch.float32)
    U = torch.zeros((1024, 2), device=dev)
    bs.band_tiles_minplus(band, plan, d, f)          # what they take
    bs.band_tiles_lip(band, plan, U)
    shifted = torch.zeros(band.numel() + 1, device=dev)[1:].view(band.shape)
    shifted.copy_(band)
    with pytest.raises(ValueError):
        bs.band_tiles_minplus(shifted, plan, d, f)
    with pytest.raises(ValueError):
        bs.band_tiles_lip(shifted, plan, U)
    with pytest.raises(ValueError):
        bs.band_tiles_minplus(band, plan, torch.zeros(1025, device=dev)[1:],
                              f)
    with pytest.raises(ValueError):
        bs.band_tiles_lip(band, plan, torch.zeros(2049, device=dev)[1:]
                          .view(1024, 2))
    odd = bs.TilesPlan.from_tiles([0, 1], [0, 48], 96, 48, 48, dev)
    with pytest.raises(ValueError):                  # WT not a multiple of 32
        bs.band_tiles_minplus(torch.zeros((96, 48), device=dev), odd,
                              d[:96], f[:96])
    odd = bs.TilesPlan.from_tiles([0, 1], [0, 64], 48, 24, 64, dev)
    with pytest.raises(ValueError):                  # R not a multiple of 16
        bs.band_tiles_lip(torch.zeros((48, 64), device=dev), odd, U[:128])
    chunk_ptr, chunk_id = bs.tiles_live_chunks(band, plan)
    with pytest.raises(ValueError):                  # one group short
        bs.band_tiles_minplus(band, plan, d, f,
                              chunks=(chunk_ptr[:-1], chunk_id))
    with pytest.raises(ValueError):                  # int64
        bs.band_tiles_lip(band, plan, U, (chunk_ptr, chunk_id.long()))
    past = chunk_id.clone()
    past[-1] = plan.slab_block.numel() * (plan.WT // bs._LIVE_KC)
    with pytest.raises(ValueError):                  # past the last tile
        bs.band_tiles_minplus(band, plan, d, f, chunks=(chunk_ptr, past))
    flipped = chunk_id.clone()
    a = int(((chunk_ptr[1:] - chunk_ptr[:-1]) >= 2).nonzero()[0])
    a = int(chunk_ptr[a])
    flipped[a], flipped[a + 1] = chunk_id[a + 1], chunk_id[a]
    with pytest.raises(ValueError):                  # descending in a group
        bs.band_tiles_lip(band, plan, U, (chunk_ptr, flipped))


@pytest.fixture(scope="module")
def rect_case():
    """The RCM-ordered 1024-row kNN ELL and its rectangular plan at R = 128
    and WT = 64: the window leaves edges out, so its masks matter."""
    W = _knn_csr(1000, 10, seed=0)
    perm = np.asarray(reverse_cuthill_mckee(W, symmetric_mode=True))
    Wp = W[perm][:, perm].tocsr()
    Wp.resize((1024, 1024))
    cols, vals, deg = SparseGraph.ell_from_scipy(Wp)
    winstart, rrows, _, Wr, kcap = bs.plan_banded(
        cols, R=128, WT=64, deg=deg, kcap_max=32, max_residual=0.05)
    assert Wr < 1024 and len(rrows) > 0
    return (np.ascontiguousarray(cols[:, :kcap]),
            vals[:, :kcap].astype(np.float32), winstart, Wr, kcap)


def _rect(rect_case, dev, cls, dtype=torch.float32):
    cols, vals, winstart, Wr, kcap = rect_case
    c = torch.as_tensor(cols, device=dev)
    v = torch.as_tensor(vals, device=dev)
    plan = cls.from_numpy(winstart, 1024, 128, 64, Wr, kcap, dev)
    band = None
    if cls is bs.RectPlan:
        band = bs.materialize_band(c, v, plan.winstart, Wr, R=128, WT=64,
                                   out_dtype=dtype)
    return c, v, band, plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 2, 3, 10, 40])
def test_cuda_rect_spmm_kernels_match_twins(rect_case, cuda_device, dtype,
                                            d):
    """K5 (stored band) and K6 (ELL slots) against their twins, f32 and
    bf16, within the K2 tolerance of max|ref|."""
    dev = cuda_device
    _, _, band, plan = _rect(rect_case, dev, bs.RectPlan, dtype)
    X = torch.randn((1024, d), device=dev).to(dtype)
    n0 = bs.band_spmm.launches
    out = bs.band_spmm(band, plan, X)
    assert bs.band_spmm.launches == n0 + 1
    _close(out, bs._rect_spmm_plain(band, plan, X), dtype)

    c, v, _, bplan = _rect(rect_case, dev, bs.BandedPlan)
    v = v.to(dtype)
    n0 = bs.banded_spmm.launches
    out = bs.banded_spmm(c, v, bplan, X)
    assert bs.banded_spmm.launches == n0 + 1
    _close(out, bs._banded_spmm_plain(c, v, bplan, X), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hopf_lax", [False, True])
@pytest.mark.parametrize("recip", [False, True])
@pytest.mark.parametrize("track_arg", [False, True])
def test_cuda_rect_minplus_matches_twin(rect_case, cuda_device, dtype,
                                        hopf_lax, recip, track_arg):
    """K8: min and argmin identical to the twin (the same f32 operations,
    no contraction)."""
    dev = cuda_device
    _, _, band, plan = _rect(rect_case, dev, bs.RectPlan, dtype)
    gen = torch.Generator(device=dev).manual_seed(0)
    d = torch.rand(1024, generator=gen, device=dev) * 3
    d[torch.rand(1024, generator=gen, device=dev) < 0.3] = bs.MINPLUS_BIG
    f = torch.rand(1024, generator=gen, device=dev) + 0.5
    n0 = bs.band_minplus.launches
    m, arg = bs.band_minplus(band, plan, d, f, hopf_lax=hopf_lax,
                             track_arg=track_arg, recip=recip)
    assert bs.band_minplus.launches == n0 + 1
    rm, rarg = bs._rect_minplus_plain(band, plan, d, f, hopf_lax, track_arg,
                                      recip)
    torch.testing.assert_close(m, rm, rtol=0, atol=0)
    assert bool((m < bs.MINPLUS_BIG).any()) and bool(
        (m == bs.MINPLUS_BIG).any())
    if track_arg:
        torch.testing.assert_close(arg, rarg, rtol=0, atol=0)
    else:
        assert arg is None


def _chunk_band(rect_case, dev, kind, dtype):
    """K5's and K8's bands: ``rcm``, K4's band of the plan; ``empty_group``,
    the same with rows 64-127 (one CTA's row group) zeroed; ``all_live``,
    random positive cells, about 5 % nonzero, so every 64 x 64 chunk is
    live."""
    _, _, band, plan = _rect(rect_case, dev, bs.RectPlan, dtype)
    if kind == "empty_group":
        band[bs._TILES_ROWS:2 * bs._TILES_ROWS] = 0
    elif kind == "all_live":
        rs = np.random.RandomState(7)
        cells = rs.rand(plan.n, plan.W) * (rs.rand(plan.n, plan.W) < 0.05)
        band = torch.as_tensor(cells, dtype=torch.float32,
                               device=dev).to(dtype)
    chunks = bs.rect_live_chunks(band, plan)
    n_live = chunks[1].numel()
    n_all = (plan.n // bs._TILES_ROWS) * (plan.W // bs._TILES_KC)
    assert n_live == n_all if kind == "all_live" else 0 < n_live < n_all
    if kind == "empty_group":
        assert int(chunks[0][2]) == int(chunks[0][1])
    return band, plan, chunks


CHUNK_KINDS = ["rcm", "empty_group", "all_live"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", CHUNK_KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [1, 2, 3, 8, 10, 40, 128, 130])
def test_cuda_rect_spmm_on_the_live_chunks(rect_case, cuda_device, kind,
                                           dtype, d):
    """K5 on K2's CTA, driven by the live-chunk list, against its dense
    twin: the MMA's n = 8 padding, one and several 32-column warp groups,
    and two launches above 128 columns; an empty row group writes zeros."""
    dev = cuda_device
    band, plan, chunks = _chunk_band(rect_case, dev, kind, dtype)
    X = torch.randn((1024, d), device=dev).to(dtype)
    n0 = bs.band_spmm.launches
    out = bs.band_spmm(band, plan, X, chunks)
    assert bs.band_spmm.launches == n0 + _tiles_launches(d)
    ref = bs._rect_spmm_plain(band, plan, X)
    _close(out, ref, dtype)
    if kind == "empty_group":
        assert not out[bs._TILES_ROWS:2 * bs._TILES_ROWS].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["empty_group", "all_live"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hopf_lax", [False, True])
@pytest.mark.parametrize("recip", [False, True])
@pytest.mark.parametrize("track_arg", [False, True])
def test_cuda_rect_minplus_on_the_live_chunks(rect_case, cuda_device, kind,
                                              dtype, hopf_lax, recip,
                                              track_arg):
    """K8 on the list: min and argmin identical to the dense twin; the
    empty row group gets MINPLUS_BIG and -1."""
    dev = cuda_device
    band, plan, chunks = _chunk_band(rect_case, dev, kind, dtype)
    gen = torch.Generator(device=dev).manual_seed(1)
    d = torch.rand(1024, generator=gen, device=dev) * 3
    d[torch.rand(1024, generator=gen, device=dev) < 0.3] = bs.MINPLUS_BIG
    f = torch.rand(1024, generator=gen, device=dev) + 0.5
    n0 = bs.band_minplus.launches
    m, arg = bs.band_minplus(band, plan, d, f, hopf_lax=hopf_lax,
                             track_arg=track_arg, recip=recip, chunks=chunks)
    assert bs.band_minplus.launches == n0 + 1
    rm, rarg = bs._rect_minplus_plain(band, plan, d, f, hopf_lax, track_arg,
                                      recip)
    torch.testing.assert_close(m, rm, rtol=0, atol=0)
    if track_arg:
        torch.testing.assert_close(arg, rarg, rtol=0, atol=0)
    if kind == "empty_group":
        rows = slice(bs._TILES_ROWS, 2 * bs._TILES_ROWS)
        assert bool((m[rows] == bs.MINPLUS_BIG).all())
        if track_arg:
            assert bool((arg[rows] == -1).all())


@pytest.mark.cuda
def test_cuda_rect_chunks_none_matches_the_cached_list(cuda_device,
                                                       monkeypatch):
    """K5 and K8 without a list build their own from the band: the same
    outputs, bit for bit, as with the list ``AccelSpMM`` caches beside its
    band, which is the list the CPU builds from the same band."""
    monkeypatch.setenv("GLT_NO_BAND", "1")
    W = _knn_csr(9000, 10, seed=1)
    acc = AccelSpMM(W, device=cuda_device, materialize=True)
    band, plan = acc.band(), acc.plan
    chunks = acc.live_chunks(band)
    assert acc.live_chunks(acc.band()) is chunks
    for a, b in zip(chunks, bs.rect_live_chunks(band.cpu(), _cpu_plan(plan))):
        assert torch.equal(a.cpu(), b)
    X = torch.randn((acc.n_pad, 3), device=cuda_device)
    assert torch.equal(bs.band_spmm(band, plan, X),
                       bs.band_spmm(band, plan, X, chunks))
    d = torch.rand(acc.n_pad, device=cuda_device) * 3
    f = torch.rand(acc.n_pad, device=cuda_device) + 0.5
    for a, b in zip(bs.band_minplus(band, plan, d, f, track_arg=True),
                    bs.band_minplus(band, plan, d, f, track_arg=True,
                                    chunks=chunks)):
        assert torch.equal(a, b)
    b16 = acc.build_band(torch.bfloat16)
    assert acc.live_chunks(b16) is not chunks


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 40])
def test_cuda_exact_grade_sums_are_unbiased(banded_tiles, rect_case,
                                            cuda_device, d):
    """The exact grade's tensor-core sums round toward zero; added to the
    accumulators by FADD (rounded to nearest) the mean relative error of
    K5 and K3 on a positive X stays within 3e-8 of zero (about -6e-8
    accumulated in the MMA, -1.8e-8 measured with the FADD).  d=40 runs
    on the tensor cores, d=2 on the FFMA consumer (held tighter by
    ``test_cuda_exact_grade_ffma_at_narrow_d``)."""
    dev = cuda_device
    cols, vals, tb, ts, _, R, WT = banded_tiles
    args = tuple(torch.as_tensor(a, device=dev) for a in (cols, vals, tb, ts))
    tband = bs.materialize_band_tiles(*args, R=R, WT=WT,
                                      out_dtype=torch.float32)
    tplan = bs.TilesPlan.from_tiles(tb, ts, 1024, R, WT, dev)
    rband, rplan, chunks = _chunk_band(rect_case, dev, "rcm", torch.float32)
    gen = torch.Generator(device=dev).manual_seed(3)
    X = torch.rand((1024, d), generator=gen, device=dev)
    for out, ref in (
            (bs.band_tiles_spmm(tband, tplan, X),
             bs._tiles_spmm_plain(tband.double(), tplan, X.double())),
            (bs.band_spmm(rband, rplan, X, chunks),
             bs._rect_spmm_plain(rband.double(), rplan, X.double()))):
        live = ref.abs() > 1e-3
        rel = (out.double() - ref)[live] / ref[live]
        assert abs(float(rel.mean())) < 3e-8, float(rel.mean())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 10, 16])
def test_cuda_exact_grade_ffma_at_narrow_d(banded_tiles, rect_case,
                                           cuda_device, d):
    """K2, K3 and K5 in f32 at d <= FMA_DMAX sum by FFMA, rounded to
    nearest: within TOL of their twin on the packed and unpacked plans
    and on K5's live chunks, and on a positive X a mean relative error
    against the f64 product within 1e-8 of zero (about 2e-9 expected of
    unbiased roundings over these outputs; the tensor cores' sums are held
    to 3e-8 above)."""
    assert d <= bs._TILES_FMA_DMAX
    dev = cuda_device
    cols, vals, tb, ts, bf, R, WT = banded_tiles
    args = tuple(torch.as_tensor(a, device=dev) for a in (cols, vals, tb, ts))
    band = bs.materialize_band_tiles(*args, R=R, WT=WT,
                                     out_dtype=torch.float32)
    plan = bs.TilesPlan.from_tiles(tb, ts, 1024, R, WT, dev)
    sb, sts, _, src = bs.pack_tiles(tb, ts, bf, 4)
    packed = bs.pack_band(band, src, R=R, WT=WT)
    pplan = bs.PackedPlan.from_slabs(sb, sts, src, 1024, R, WT, dev)
    rband, rplan, chunks = _chunk_band(rect_case, dev, "rcm", torch.float32)
    gen = torch.Generator(device=dev).manual_seed(5)
    X = torch.rand((1024, d), generator=gen, device=dev)
    tref = bs._tiles_spmm_plain(band.double(), plan, X.double())
    n2, n3, n5 = (bs.band_tiles_spmm_packed.launches,
                  bs.band_tiles_spmm.launches, bs.band_spmm.launches)
    for out, ref in (
            (bs.band_tiles_spmm_packed(packed, pplan, X), tref),
            (bs.band_tiles_spmm(band, plan, X), tref),
            (bs.band_spmm(rband, rplan, X, chunks),
             bs._rect_spmm_plain(rband.double(), rplan, X.double()))):
        _close(out, ref.float(), torch.float32)
        live = ref.abs() > 1e-3
        rel = (out.double() - ref)[live] / ref[live]
        assert abs(float(rel.mean())) < 1e-8, float(rel.mean())
    assert (bs.band_tiles_spmm_packed.launches, bs.band_tiles_spmm.launches,
            bs.band_spmm.launches) == (n2 + 1, n3 + 1, n5 + 1)


def _cpu_plan(plan):
    return bs.RectPlan.from_numpy(plan.winstart_host, plan.n, plan.R,
                                  plan.WT, plan.W, plan.kcap, "cpu")


@pytest.mark.cuda
def test_cuda_rect_wrappers_refuse(rect_case, cuda_device):
    dev = cuda_device
    c, v, band, plan = _rect(rect_case, dev, bs.RectPlan)
    _, _, _, bplan = _rect(rect_case, dev, bs.BandedPlan)
    X = torch.zeros((1024, 2), device=dev)
    with pytest.raises(ValueError):          # f64 has only the CPU twin
        bs.band_spmm(band.double(), plan, X.double())
    with pytest.raises(ValueError):          # X on another device
        bs.band_spmm(band, plan, torch.zeros(1024, 2))
    with pytest.raises(ValueError):          # band and X types differ
        bs.band_spmm(band, plan, X.to(torch.bfloat16))
    with pytest.raises(ValueError):          # too few X rows
        bs.banded_spmm(c, v, bplan, torch.zeros((64, 2), device=dev))
    with pytest.raises(ValueError):          # int64 columns
        bs.banded_spmm(c.long(), v, bplan, X)
    with pytest.raises(TypeError):           # K6 takes a BandedPlan
        bs.banded_spmm(c, v, plan, X)
    d = torch.zeros(1024, device=dev)
    bs.band_minplus(band, plan, d, d + 1)    # what it takes
    with pytest.raises(ValueError):          # f64 distances on CUDA
        bs.band_minplus(band, plan, d.double(), d.double() + 1)
    with pytest.raises(ValueError):          # a band of another width
        bs.band_minplus(band[:, :64].contiguous(), plan, d, d + 1)
    # the cp.async ring's 16-byte pieces: a band, X or d off the boundary
    shifted = torch.zeros(band.numel() + 1, device=dev)[1:].view(band.shape)
    shifted.copy_(band)
    with pytest.raises(ValueError):
        bs.band_spmm(shifted, plan, X)
    with pytest.raises(ValueError):
        bs.band_minplus(shifted, plan, d, d + 1)
    with pytest.raises(ValueError):
        bs.band_spmm(band, plan, torch.zeros(2049, device=dev)[1:].view(
            1024, 2))
    with pytest.raises(ValueError):
        bs.band_minplus(band, plan, torch.zeros(1025, device=dev)[1:],
                        d + 1)
    # window starts off multiples of 8, and a list of another length
    odd = bs.RectPlan.from_numpy(np.full(8, 4, np.int32), 1024, 128, 64,
                                 plan.W, plan.kcap, dev)
    with pytest.raises(ValueError):
        bs.band_spmm(band, odd, torch.zeros((2048, 2), device=dev))
    chunk_ptr, chunk_col = bs.rect_live_chunks(band, plan)
    with pytest.raises(ValueError):
        bs.band_spmm(band, plan, X, (chunk_ptr[:-1], chunk_col))
    with pytest.raises(ValueError):
        bs.band_minplus(band, plan, d, d + 1,
                        chunks=(chunk_ptr.long(), chunk_col))
    # a list that ends short of chunk_col, or names a chunk past the window
    with pytest.raises(ValueError):
        bs.band_spmm(band, plan, X, (chunk_ptr - (chunk_ptr == chunk_ptr[
            -1]).int(), chunk_col))
    wide = chunk_col.clone()
    wide[-1] = plan.W // bs._TILES_KC
    with pytest.raises(ValueError):
        bs.band_minplus(band, plan, d, d + 1, chunks=(chunk_ptr, wide))


@pytest.mark.cuda
@pytest.mark.parametrize("materialize", [None, True])
def test_cuda_accel_rect_route_takes_the_kernels(cuda_device, monkeypatch,
                                                  materialize):
    """Under GLT_NO_BAND the matvec runs K6 (BandedPlan) or K4 + K5
    (RectPlan), and bellman_ford on a RectPlan runs K8."""
    from graphlearning_tpu_torch.solvers import eikonal

    monkeypatch.setenv("GLT_NO_BAND", "1")
    W = _knn_csr(9000, 10, seed=1)
    acc = AccelSpMM(W, device=cuda_device, materialize=materialize)
    assert isinstance(acc.plan, bs.RectPlan if materialize
                      else bs.BandedPlan)
    X = np.random.RandomState(2).randn(9000, 4)
    before = dict(bs.launches())
    out = acc.from_perm(acc.spmm(acc.to_perm(
        torch.as_tensor(X, dtype=torch.float32, device=cuda_device))))
    after = bs.launches()
    kernels = (("materialize_band", "band_spmm") if materialize
               else ("banded_spmm",))
    for name in kernels:
        assert after[name] == before[name] + 1, name
    ref = W @ X
    np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    if not materialize:
        return
    g = SparseGraph.from_scipy(W, device=cuda_device)
    seeds = np.random.RandomState(0).choice(9000, 6, replace=False)
    d_b, cp_b = eikonal.dijkstra(g, seeds, return_cp=True, accel=acc)
    d_p, cp_p = eikonal.dijkstra(g, seeds, return_cp=True)
    assert bs.launches()["band_minplus"] > after["band_minplus"]
    np.testing.assert_allclose(d_b, d_p, rtol=1e-5, atol=1e-6)
    assert np.mean(cp_b == cp_p) > 0.999


def _packed_q_case(R, n):
    """The packed (R, 128, 12) geometry on an RCM-ordered kNN graph of
    4000 rows padded to ``n``, every edge in a tile; row block 3 loses its
    slabs (an empty row block) and rows 10-19 of block 0 are zero in
    every slab."""
    W = _knn_csr(4000, 10, seed=3)
    perm = np.asarray(reverse_cuthill_mckee(W, symmetric_mode=True))
    Wp = W[perm][:, perm].tocsr()
    Wp.resize((n, n))
    cols, vals, deg = SparseGraph.ell_from_scipy(Wp)
    WT, S = 128, 12
    tb, ts, bf, rr, _, _ = bs.plan_tiles(
        cols, R=R, WT=WT, deg=deg, kcap=cols.shape[1], min_edges_per_tile=1,
        hbm_budget_bytes=float("inf"))
    assert len(rr) == 0
    sb, sts, _, src = bs.pack_tiles(tb, ts, bf, S)
    band = bs._materialize_band_tiles_plain(
        *(torch.as_tensor(a) for a in (cols, vals.astype(np.float32), tb,
                                       ts)), R, WT, torch.float32)
    packed = bs.pack_band(band, src, R=R, WT=WT).reshape(len(sb), R, -1)
    packed[sb == 0, 10:20] = 0.0
    keep = sb != 3
    assert (sb == 3).any() and keep.sum() > 8
    return (packed[torch.as_tensor(keep)].reshape(-1, S * WT), sb[keep],
            sts[keep], src[keep], R, WT, n)


@pytest.fixture(scope="module")
def packed_q_case():
    """The bench's packed geometry, R=256: 128-row CTAs."""
    return _packed_q_case(256, 4096)


def _packed_q(packed_q_case, dev):
    band, sb, sts, src, R, WT, n = packed_q_case
    plan = bs.PackedPlan.from_slabs(sb, sts, src, n, R, WT, dev)
    return band.to(dev), plan


def _run_quantized(kind, band, plan, X):
    """K10 (``kind`` rowq2 / rowq1) or K11 (i8) on ``band`` quantized, and
    its twin: ``(wrapper, out, ref)``."""
    if kind == "i8":
        hi, q = bs.quantize_band_i8(band)
        wrapper = bs.band_tiles_spmm_packed_i8
        n0 = wrapper.launches
        out = wrapper(hi, q, plan, X)
        ref = bs._tiles_spmm_i8_plain(hi, q, plan, X)
    else:
        planes = int(kind[-1])
        qband, srow = bs.quantize_band_rowq(band, plan, plan.n, planes)
        Xk = X if planes == 2 else X.to(torch.bfloat16)
        wrapper = bs.band_tiles_spmm_packed_rowq
        n0 = wrapper.launches
        out = wrapper(qband, srow, plan, Xk, planes)
        ref = bs._tiles_spmm_rowq_plain(qband, srow, plan, Xk, planes)
    torch.cuda.synchronize()
    assert wrapper.launches == n0 + _tiles_launches(X.shape[1])
    assert out.shape == (plan.n, X.shape[1]) and out.dtype == torch.float32
    return wrapper, out, ref


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rowq2", "rowq1", "i8"])
@pytest.mark.parametrize("d", TILES_D[:5] + [16, 33, 128, 130])
def test_cuda_quantized_kernels_match_twins(packed_q_case, cuda_device, kind,
                                            d):
    """K10 (planes 2 and 1) and K11 against their twins, within 1e-5 of
    max|ref| (exact cells, f32 sums in another order; 3xTF32 keeps about
    2^-21); the empty row block and the all-zero rows come out 0."""
    band, plan = _packed_q(packed_q_case, cuda_device)
    X = torch.randn((4096, d), device=cuda_device)
    _, out, ref = _run_quantized(kind, band, plan, X)
    _close(out, ref, torch.float32)
    assert not out[3 * 256:4 * 256].any()           # the empty row block
    assert not out[10:20].any()                     # the all-zero rows


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rowq2", "rowq1", "i8"])
@pytest.mark.parametrize("R, n", [(64, 4096), (192, 4224)])
@pytest.mark.parametrize("d", [3, 40, 128])
def test_cuda_quantized_kernels_64_row_ctas(cuda_device, kind, R, n, d):
    """K10/K11 on a plan whose R is a multiple of 64 but not of 128, so
    each row block takes R / 64 CTAs of 64 rows, against their twins."""
    band, plan = _packed_q(_packed_q_case(R, n), cuda_device)
    assert plan.R % bs._TILES_QROWS
    X = torch.randn((n, d), device=cuda_device)
    _, out, ref = _run_quantized(kind, band, plan, X)
    _close(out, ref, torch.float32)
    assert not out[3 * R:4 * R].any()               # the empty row block


def _uneven_packed_band(uneven_slabs, dev):
    """The uneven tiles packed at S=4 (slabs of 4, 4 and 1 tiles with pad
    tiles in block 0, one in block 1, none in block 2, 4 and 1 in block
    3): the f32 band on ``dev`` and its plan."""
    band_np, tb, ts, bf, R, WT, S, _ = uneven_slabs
    sb, sts, _, src = bs.pack_tiles(tb, ts, bf, S)
    assert (src < 0).any()
    band = bs.pack_band(torch.as_tensor(band_np), src, R=R, WT=WT)
    plan = bs.PackedPlan.from_slabs(sb, sts, src, 4 * R, R, WT, dev)
    return band.to(dev), plan


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rowq2", "rowq1", "i8"])
@pytest.mark.parametrize("R", [128, 192])
@pytest.mark.parametrize("d", TILES_D)
def test_cuda_quantized_uneven_blocks_rectangular_x(cuda_device, kind, R,
                                                    d):
    """K10 and K11 on very uneven blocks (9, 1, 0 and 5 tiles), pad tiles
    and a rectangular X (1536 rows for 4 R outputs), with R=128 (128-row
    CTAs) and R=192 (64-row CTAs), against their twins; the empty block
    comes out 0."""
    slabs = _uneven_slabs(R)
    band, plan = _uneven_packed_band(slabs, cuda_device)
    X = torch.randn((slabs[-1], d), device=cuda_device)
    _, out, ref = _run_quantized(kind, band, plan, X)
    _close(out, ref, torch.float32)
    assert not out[2 * R:3 * R].any()


@pytest.mark.cuda
def test_cuda_quantized_refuse_misaligned_planes_and_geometry(
        uneven_slabs, cuda_device):
    """K10/K11's ring copies 16-byte pieces: a plane, srow or X off a
    16-byte boundary is refused, and so are R or WT off 64."""
    dev = cuda_device
    band, plan = _uneven_packed_band(uneven_slabs, dev)
    qband, srow = bs.quantize_band_rowq(band, plan, plan.n, 2)
    hi, q = bs.quantize_band_i8(band)
    X = torch.randn((1536, 4), device=dev)

    def off(t):
        """``t``'s copy one element past a 16-byte boundary."""
        buf = torch.zeros(t.numel() + 1, dtype=t.dtype, device=dev)
        moved = buf[1:].view(t.shape)
        moved.copy_(t)
        assert moved.is_contiguous() and moved.data_ptr() % 16
        return moved

    with pytest.raises(ValueError):
        bs.band_tiles_spmm_packed_rowq(off(qband), srow, plan, X, 2)
    with pytest.raises(ValueError):
        bs.band_tiles_spmm_packed_rowq(qband, off(srow), plan, X, 2)
    with pytest.raises(ValueError):
        bs.band_tiles_spmm_packed_rowq(qband, srow, plan, off(X), 2)
    with pytest.raises(ValueError):
        bs.band_tiles_spmm_packed_i8(off(hi), q, plan, X)
    with pytest.raises(ValueError):
        bs.band_tiles_spmm_packed_i8(hi, off(q), plan, X)
    for R, WT in ((96, 64), (64, 32)):       # R or WT off 64
        odd = bs.PackedPlan.from_numpy([0], [[0]], [1], R, R, WT, dev)
        with pytest.raises(ValueError):
            bs.band_tiles_spmm_packed_rowq(
                torch.zeros((R, 2 * WT), dtype=torch.int8, device=dev),
                torch.ones(R, device=dev), odd, torch.zeros((R, 4),
                                                            device=dev), 2)
        with pytest.raises(ValueError):
            bs.band_tiles_spmm_packed_i8(
                torch.zeros((R, WT), dtype=torch.bfloat16, device=dev),
                torch.zeros((R, WT), dtype=torch.int8, device=dev), odd,
                torch.zeros((R, 4), device=dev))
    _, out, ref = _run_quantized("rowq2", band, plan, X)
    _close(out, ref, torch.float32)


@pytest.mark.cuda
def test_cuda_quantized_wrappers_refuse(packed_q_case, cuda_device):
    dev = cuda_device
    band, plan = _packed_q(packed_q_case, dev)
    qband, srow = bs.quantize_band_rowq(band, plan, plan.n, 2)
    hi, q = bs.quantize_band_i8(band)
    X = torch.zeros((4096, 4), device=dev)
    with pytest.raises(ValueError):          # X on the CPU, band on CUDA
        bs.band_tiles_spmm_packed_rowq(qband, srow, plan, X.cpu(), 2)
    with pytest.raises(ValueError):          # planes=1 takes bf16 X
        bs.band_tiles_spmm_packed_rowq(qband[:, :plan.S * plan.WT]
                                       .contiguous(), srow, plan, X, 1)
    with pytest.raises(ValueError):          # planes=2 takes an int8 band
        bs.band_tiles_spmm_packed_rowq(band.repeat(1, 2), srow, plan, X, 2)
    with pytest.raises(ValueError):          # too few X rows
        bs.band_tiles_spmm_packed_rowq(qband, srow, plan, X[:64], 2)
    with pytest.raises(ValueError):          # q on the CPU
        bs.band_tiles_spmm_packed_i8(hi, q.cpu(), plan, X)
    with pytest.raises(ValueError):          # K11 takes f32 X
        bs.band_tiles_spmm_packed_i8(hi, q, plan, X.double())
    with pytest.raises(TypeError):           # a TilesPlan is not K11's
        bs.band_tiles_spmm_packed_i8(hi, q, bs.TilesPlan.from_tiles(
            [0], [0], 4096, 256, 128, dev), X)


@pytest.mark.cuda
def test_cuda_bench_runs_every_mode(cuda_device):
    """The bench's 2-D spmm on the card runs the five modes, each within
    its grade of the scipy f64 chain, and launches K10 and K11."""
    from graphlearning_tpu_torch import bench

    bs.reset_launches()
    line = bench.main(device=cuda_device, mode="spmm", geom="2d", n=16384,
                      k=16, d=16, iters=5, prec=None, band_kernels=True,
                      stored_band=True)
    modes = line["config"]["modes"]
    assert set(modes) == set(bench.SPMM_MODES)
    assert modes["f32"]["rel_err_chain"] <= 1e-4
    for mode, grade in (("rowq2_int8", 1e-4), ("bf16i8", 1e-4),
                        ("rowq1_int8", 2e-2), ("bf16", 2e-2)):
        assert modes[mode]["rel_err_single"] <= grade, mode
    launches = bs.launches()
    assert launches["band_tiles_spmm_packed_rowq"] > 0
    assert launches["band_tiles_spmm_packed_i8"] > 0


def _eig_cases(acc, W, k, m, dev):
    """``acc.eig_normalized`` (``I + s Wp s`` in permuted space, LOBPCG on
    its 8th power, ``m`` steps) from the start ``X0`` of the plain path,
    and the same solve on the plain ELL path.  Returns ``(vals, U)`` of
    the band in original order, its K2 launches, and the plain path's
    ``(vals, U)``."""
    from graphlearning_tpu_torch import config
    from graphlearning_tpu_torch.ops import graphops
    from graphlearning_tpu_torch.solvers import eig

    deg = np.asarray(W.sum(axis=1)).ravel()
    s = torch.as_tensor(deg ** -0.5, dtype=torch.float32, device=dev)
    X0 = torch.randn((W.shape[0], k), generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    before = bs.launches()["band_tiles_spmm_packed"]
    info = {}
    vals, U = acc.eig_normalized(acc.to_perm(s), k, m=m, power=8,
                                 X0=acc.to_perm(X0), info=info)
    n_launch = bs.launches()["band_tiles_spmm_packed"] - before
    g = SparseGraph.from_scipy(W, dtype=torch.float32, device=dev)
    A = lambda X: X + s[:, None] * graphops.spmm(g, s[:, None] * X)
    with config.exact_matmul():
        _, Up = eig._lobpcg_topk(A, W.shape[0], k, 0, m=m, power=8, X0=X0)
        vals_p = 2.0 - eig._rayleigh(A, Up)
    return (vals, acc.from_perm(U)), n_launch, info["iters"], (vals_p, Up)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 13])
def test_cuda_eig_normalized_on_k2_matches_twin_and_plain(cuda_device,
                                                          monkeypatch, k):
    """LOBPCG's operator on K2 at its two widths, d = 3k (12: FFMA; 39:
    3xTF32 tensor cores) and d = k: one K2 launch an application of the
    operator (8 for the start check, 8 for the start, 16 a step, 1 for the
    Rayleigh quotients; ``launches_by_d`` splits them by width), and the
    first ``k - b`` eigenvalues (``b`` the
    graph's guard vectors; the last pairs converge worst) within 1e-5 of
    the twin's and of the plain path's (JAX's bound for its band,
    ``test_eigen_decomp_accel_matches_plain``)."""
    W = _knn_csr(9000, 10, seed=1)
    acc = AccelSpMM(W, device=cuda_device)
    assert acc.packed
    by_d = dict(bs.band_tiles_spmm_packed.launches_by_d)
    (vals, _), n_launch, iters, (vals_p, _) = _eig_cases(
        acc, W, k, 30, cuda_device)
    assert iters == 30 and n_launch == 8 + 8 + 16 * iters + 1
    grew = {d: c - by_d.get(d, 0)
            for d, c in bs.band_tiles_spmm_packed.launches_by_d.items()}
    assert {d: c for d, c in grew.items() if c} == {
        1: 8, k: 8 + 8 * iters + 1, 3 * k: 8 * iters}
    monkeypatch.setattr(bs, "band_tiles_spmm_packed",
                        lambda band, plan, X: bs._tiles_spmm_plain(
                            band, plan, X))
    (vals_t, _), _, _, _ = _eig_cases(acc, W, k, 30, cuda_device)
    kk = k - (2 + k // 10)
    first = lambda v: np.sort(v.cpu().numpy())[:kk]
    for ref in (vals_t, vals_p):
        np.testing.assert_allclose(first(vals), first(ref), rtol=0,
                                   atol=1e-5)
    assert np.all(np.isfinite(vals.cpu().numpy()))
    assert np.all(np.abs(first(vals)) < 0.01)


@pytest.mark.cuda
def test_cuda_lobpcg_products_exact_under_tf32(cuda_device):
    """LOBPCG's products run in full f32 whatever the caller's matmul
    precision: with TF32 allowed ("high") the solve gives the same bits as
    with "highest", and the caller's setting is restored."""
    from graphlearning_tpu_torch.solvers.lobpcg import lobpcg_standard

    rs = np.random.RandomState(0)
    Q, _ = np.linalg.qr(rs.randn(600, 600))
    ev = rs.rand(600)
    ev[:4] = [4.0, 3.0, 2.5, 2.2]
    A = torch.as_tensor((Q * ev) @ Q.T, dtype=torch.float32,
                        device=cuda_device)
    X0 = torch.as_tensor(rs.randn(600, 4), dtype=torch.float32,
                         device=cuda_device)
    old = torch.get_float32_matmul_precision()
    try:
        runs = []
        for precision in ("high", "highest"):
            torch.set_float32_matmul_precision(precision)
            runs.append(lobpcg_standard(lambda X: A @ X, X0, m=20))
            assert torch.get_float32_matmul_precision() == precision
    finally:
        torch.set_float32_matmul_precision(old)
    (t1, U1, i1), (t2, U2, i2) = runs
    assert i1 == i2 and torch.equal(t1, t2) and torch.equal(U1, U2)
    np.testing.assert_allclose(t1.cpu().numpy(), [4.0, 3.0, 2.5, 2.2],
                               rtol=1e-5)


@pytest.mark.cuda
def test_cuda_apply_residual_sums_the_same_in_every_run(cuda_device):
    """The residual edges' sum on the card: a spill of rows with many
    residual edges (one ELL slot a row) gives the same bits in every call,
    and the f64 sum on the CPU within TOL of max|ref|."""
    rs = np.random.RandomState(0)
    n, m = 4096, 20000
    rrows = np.sort(rs.randint(0, 64, size=m)).astype(np.int64)
    rslots = np.zeros(m, np.int64)
    for r in np.unique(rrows):
        rslots[rrows == r] = np.arange(np.sum(rrows == r))
    cols = rs.randint(0, n, size=(n, int(rslots.max()) + 1)).astype(np.int32)
    vals = rs.rand(n, cols.shape[1]).astype(np.float32)
    host = bs.build_residual_ell(rrows, rslots, cols, vals, n, rb=1)
    X = rs.randn(n, 12).astype(np.float32)
    Xd = torch.as_tensor(X, device=cuda_device)
    resid = bs.residual_to_device(host, cuda_device, torch.float32)
    runs = [bs.apply_residual(torch.zeros((n, 12), device=cuda_device), Xd,
                              resid) for _ in range(10)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    ref = bs.apply_residual(torch.zeros((n, 12), dtype=torch.float64),
                            torch.as_tensor(X, dtype=torch.float64),
                            bs.residual_to_device(host, "cpu", torch.float64))
    err = float((runs[0].cpu().double() - ref).abs().max())
    assert err <= TOL[torch.float32] * float(ref.abs().max())


@pytest.mark.cuda
def test_cuda_spmm_t_and_segment_sum_the_same_in_every_run(cuda_device):
    """``graphops.spmm_t`` (the transpose's ELL and its spill) on a directed
    kNN graph with hub columns, and ``segment_reduce(kind="sum")`` over
    repeated rows: 20 calls give the same bits, within TOL of the f64 sums
    on the CPU."""
    from graphlearning_tpu_torch.core.sparse import segment_reduce
    from graphlearning_tpu_torch.ops import graphops

    rs = np.random.RandomState(0)
    n, k = 8192, 10
    pts = rs.rand(n, 2)
    _, ind = cKDTree(pts).query(pts, k=k + 1)
    W = sp.csr_matrix((rs.rand(n * k).astype(np.float32) + 0.1, (
        np.repeat(np.arange(n), k), ind[:, 1:].ravel())), shape=(n, n))
    hubs = sp.csr_matrix((rs.rand(3000) + 0.1, (
        rs.choice(np.arange(8, n), 3000, replace=False),
        np.repeat(np.arange(6), 500))), shape=(n, n))
    W = (W + hubs).tocsr()
    g = SparseGraph.from_scipy(W, device=cuda_device)
    assert graphops.transpose(g).m > 0
    X = torch.as_tensor(rs.randn(n, 3).astype(np.float32), device=cuda_device)
    runs = [graphops.spmm_t(g, X) for _ in range(20)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    ref = W.T @ X.double().cpu().numpy()
    err = np.abs(runs[0].double().cpu().numpy() - ref).max()
    assert err <= TOL[torch.float32] * np.abs(ref).max()

    index = torch.as_tensor(rs.randint(0, 64, 200000), device=cuda_device)
    src = torch.as_tensor(rs.randn(200000, 4).astype(np.float32),
                          device=cuda_device)
    sums = [segment_reduce(torch.zeros((64, 4), device=cuda_device), index,
                           src, "sum") for _ in range(20)]
    assert all(torch.equal(sums[0], s) for s in sums[1:])
    ref = np.zeros((64, 4))
    np.add.at(ref, index.cpu().numpy(), src.double().cpu().numpy())
    assert np.abs(sums[0].double().cpu().numpy() - ref).max() \
        <= TOL[torch.float32] * np.abs(ref).max()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.float32, 57),
                                     (torch.float32, 171),
                                     (torch.bfloat16, 2),
                                     (torch.bfloat16, 10)])
def test_cuda_k2_at_the_eigenbasis_widths(banded_tiles, cuda_device, dtype,
                                          d):
    """K2 at the widths of phase 4d: Multiclass MBO's LOBPCG block (57
    vectors: d = 171 in two launches of 128 + 43 columns, and 57), and the
    bf16 band of INCRES and PoissonMBO's heat steps (d = k).
    ``launches_by_d`` counts each launch under X's full width."""
    cols, vals, tb, ts, bf, R, WT = banded_tiles
    dev = cuda_device
    args = tuple(torch.as_tensor(a, device=dev) for a in (cols, vals, tb, ts))
    band = bs.materialize_band_tiles(*args, R=R, WT=WT, out_dtype=dtype)
    sb, sts, _, src = bs.pack_tiles(tb, ts, bf, 4)
    packed = bs.pack_band(band, src, R=R, WT=WT)
    pplan = bs.PackedPlan.from_slabs(sb, sts, src, 1024, R, WT, dev)
    X = torch.randn((1024, d), device=dev).to(dtype)
    bs.reset_launches()
    out = bs.band_tiles_spmm_packed(packed, pplan, X)
    assert bs.band_tiles_spmm_packed.launches == _tiles_launches(d)
    assert bs.band_tiles_spmm_packed.launches_by_d == {d: _tiles_launches(d)}
    assert bs.band_tiles_spmm_packed.bf16_launches == (
        _tiles_launches(d) if dtype == torch.bfloat16 else 0)
    _close(out, bs._tiles_spmm_plain(packed, pplan, X), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["laplace", "poisson"])
def test_cuda_batched_fits_match_the_single_solves(cuda_device, model,
                                                   monkeypatch):
    """The batched Laplace and Poisson fits (the trials folded into the
    columns of one plain ELL product) on the card, at a tolerance of 1e-6:
    each trial stops within 1 % of its own solve's steps and ends within
    1e-4 of max|u| of its answer, with the same predictions on >= 0.999 of
    the nodes.  Not bit for bit: the sums over the folded columns may
    round otherwise than the single solve's, and CG carries that on (in
    float32 two Poisson solves at the default tolerance stopped 2 steps
    of 295 apart)."""
    import graphlearning_tpu_torch as gl

    monkeypatch.setenv("GLT_NO_ACCEL", "1")
    W = _knn_csr(8192, 10, seed=3)
    pts = W._glt_points
    y = (pts[:, 0] > 0.5).astype(int) + 2 * (pts[:, 1] > 0.5)
    trials = gl.trainsets.generate(y, rate=4, num_trials=5, seed=0)
    make = lambda: getattr(gl.ssl, model)(W, tol=1e-6, device=cuda_device)
    (idx, u, iters), = make()._solve_batched(np.stack(trials), y)
    assert u.device.type == "cuda" and u.shape == (5, 8192, 4)
    preds = make().fit_predict_batched(trials, y)
    for t in idx:
        single = make()
        us = single._fit(trials[t], y[trials[t]])
        assert abs(int(iters[t]) - single.iters) <= 0.01 * single.iters
        err = float((u[t] - us).abs().max() / us.abs().max())
        assert err <= 1e-4, (t, err)
        assert np.mean(preds[t] == single.fit_predict(
            trials[t], y[trials[t]])) >= 0.999


@pytest.mark.cuda
def test_cuda_batched_cg_freezes_each_trial(cuda_device):
    """``conjgrad_batched`` on the card: a trial whose right-hand side is an
    eigenvector stops after a step or two and stays there while the other
    runs on; each ends at its own solve's answer."""
    from graphlearning_tpu_torch import config
    from graphlearning_tpu_torch.solvers import cg

    rs = np.random.RandomState(4)
    n = 256
    Q, _ = np.linalg.qr(rs.randn(n, n))
    A = torch.as_tensor(Q @ np.diag(np.linspace(1.0, 50.0, n)) @ Q.T,
                        dtype=torch.float32, device=cuda_device)
    b = torch.as_tensor(np.stack([np.repeat(Q[:, [7]], 2, axis=1),
                                  rs.randn(n, 2)]), dtype=torch.float32,
                        device=cuda_device)
    with config.exact_matmul():
        x, iters, _ = cg.conjgrad_batched(lambda X: A @ X, b, tol=1e-6)
        single = [cg.conjgrad(lambda X: A @ X, b[t], tol=1e-6)
                  for t in range(2)]
    assert iters[0] <= 2 and iters[1] > 20
    for t, (xs, it, _) in enumerate(single):
        assert abs(it - int(iters[t])) <= 1
        torch.testing.assert_close(x[t], xs, rtol=0,
                                   atol=1e-4 * float(xs.abs().max()))


@pytest.mark.cuda
def test_cuda_sparse_label_propagation_the_same_in_every_run(cuda_device):
    """``ssl.sparse_label_propagation`` sums its divergence by sorted rows:
    two fits on the card give the same bits.  Against the float64 fit on
    the CPU, its accuracy within a point and its predictions on >= 0.95 of
    the nodes: the dual step's clip makes the rounds discontinuous, so
    float32 and float64 part (on the CPU, on this graph, they agree on
    0.987 of the nodes, 0.04 points of accuracy apart, the scores up to
    1.8 apart)."""
    import graphlearning_tpu_torch as gl

    W = _knn_csr(8192, 10, seed=5)
    pts = W._glt_points
    y = (pts[:, 0] > 0.5).astype(int) + 2 * (pts[:, 1] > 0.5)
    ti = gl.trainsets.generate(y, rate=5, seed=0)
    runs = [gl.ssl.sparse_label_propagation(W, device=cuda_device)
            for _ in range(2)]
    for m in runs:
        m.fit(ti, y[ti])
    np.testing.assert_array_equal(runs[0].prob, runs[1].prob)
    ref = gl.ssl.sparse_label_propagation(W, device="cpu")
    ref.fit(ti, y[ti])
    pred, pref = runs[0].predict(), ref.predict()
    assert np.isfinite(runs[0].prob).all()
    assert np.mean(pred == pref) >= 0.95
    assert abs(gl.ssl.ssl_accuracy(pred, y, ti)
               - gl.ssl.ssl_accuracy(pref, y, ti)) <= 1.0


# -- active learning, checkpoints and the IVF search ------------------------


@pytest.mark.cuda
def test_cuda_ivf_search_the_same_in_every_run(cuda_device):
    """``knnsearch(method="ivf")`` on the card, on the clustered input of
    the JAX package's recall test (n=4000, 30-d): the k-means sums by
    sorted rows, the member tables and the searches give the same bits in
    two runs, with recall against the brute search above 0.95 (the JAX
    test's bound; with 16 probes it holds where a point's neighbours
    share few cells)."""
    import graphlearning_tpu_torch as gl

    rs = np.random.RandomState(3)
    centers = rs.randn(10, 30) * 2.0
    X = centers[rs.randint(0, 10, 4000)] + rs.randn(4000, 30) * 0.5
    runs = [gl.weightmatrix.knnsearch(X, 10, method="ivf",
                                      device=cuda_device) for _ in range(2)]
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    Jb, _ = gl.weightmatrix.knnsearch(X, 10, method="brute",
                                      device=cuda_device)
    recall = np.mean([len(np.intersect1d(Jb[i], runs[0][0][i])) / 10
                      for i in range(len(X))])
    assert recall > 0.95, recall


@pytest.mark.cuda
def test_cuda_unc_sampling_matches_the_host_branch(cuda_device):
    """``unc_sampling`` of a CUDA tensor (every node on the card, the (n,)
    values copied back) against the host branch on its copy: within 1e-5
    for each method."""
    from graphlearning_tpu_torch import active_learning as al

    u = torch.rand((5000, 4), generator=torch.Generator().manual_seed(0))
    ud = u.to(cuda_device)
    cand = np.arange(0, 5000, 7)
    for method in ("norm", "entropy", "least_confidence", "smallest_margin",
                   "largest_margin", "unc_2norm"):
        acq = al.unc_sampling(method)
        np.testing.assert_allclose(acq.compute(ud, cand),
                                   acq.compute(u.numpy(), cand), rtol=0,
                                   atol=1e-5)


@pytest.mark.cuda
def test_cuda_poisson_mbo_killed_and_resumed_equals_fused(cuda_device,
                                                          tmp_path,
                                                          monkeypatch):
    """A checkpointed PoissonMBO on the card (the bf16 band where
    ``maybe_build`` takes it), killed after its second save and run again
    on the same path: the fused fit's prediction and scores, bit for
    bit."""
    import graphlearning_tpu_torch as gl
    from graphlearning_tpu_torch import checkpoint as ckpt

    W = _knn_csr(8192, 10, seed=6)
    pts = W._glt_points
    y = (pts[:, 0] > 0.5).astype(int) + 2 * (pts[:, 1] > 0.5)
    ti = gl.trainsets.generate(y, rate=3, seed=0)
    priors = gl.utils.class_priors(y)
    make = lambda: gl.ssl.poisson_mbo(W, class_priors=priors, T=8,
                                      device=cuda_device)
    m0 = make()
    pred0 = m0.fit_predict(ti, y[ti])
    real, left = ckpt.save, [2]

    def killing_save(path, state, step=0):
        real(path, state, step)
        left[0] -= 1
        if left[0] == 0:
            raise RuntimeError("simulated kill")

    path = str(tmp_path / "pmbo")
    monkeypatch.setattr(ckpt, "save", killing_save)
    with pytest.raises(RuntimeError, match="simulated kill"):
        make().fit(ti, y[ti], checkpoint_path=path, checkpoint_every=2)
    monkeypatch.setattr(ckpt, "save", real)
    m2 = make()
    pred2 = m2.fit_predict(ti, y[ti], checkpoint_path=path,
                           checkpoint_every=2)
    np.testing.assert_array_equal(pred2, pred0)
    np.testing.assert_array_equal(m2.prob, m0.prob)


@pytest.mark.cuda
def test_cuda_warm_laplace_refit_on_the_band(cuda_device, monkeypatch):
    """A Laplace refit on the band (its cost model set aside) started from
    the last scores, as ``active_learner(warm_start=True)`` refits: fewer
    CG steps than the cold refit, the same argmax."""
    import graphlearning_tpu_torch as gl
    from graphlearning_tpu_torch.ops import accel

    monkeypatch.setattr(accel, "_hybrid_estimate", lambda acc: 0.0)
    W = _knn_csr(16384, 10, seed=7)
    pts = W._glt_points
    y = (pts[:, 0] > 0.5).astype(int)
    ti = gl.trainsets.generate(y, rate=2, seed=0)
    m = gl.ssl.laplace(W, device=cuda_device)
    u = m.fit_device(ti, y[ti])
    assert isinstance(m._accel_cache, accel.AccelSpMM)
    more = np.append(ti, [5, 77])
    cold = gl.ssl.laplace(W, device=cuda_device)
    u_cold = cold.fit_device(more, y[more])
    m._warm_u = u
    try:
        u_warm = m.fit_device(more, y[more])
    finally:
        m._warm_u = None
    assert m.iters < cold.iters, (m.iters, cold.iters)
    assert torch.equal(torch.argmax(u_warm, 1), torch.argmax(u_cold, 1))


def _ars_case(n, dev):
    """P of n ten-cluster-like 20-d points built on ``dev`` and a start."""
    from graphlearning_tpu_torch import ars

    rs = np.random.RandomState(5)
    X = rs.randn(10, 20)[rs.randint(0, 10, n)] + rs.randn(n, 20)
    X, Y0 = ars._preprocess(X, 2, True, 200, "pca")
    return ars._build_P(X, 30, device=dev), Y0.astype(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1024, 700])
def test_cuda_ars_forces_and_iterations_match_the_cpu(cuda_device, chunk):
    """ARS's forces (float32, full-f32 products) within 1e-5 of the largest
    and 20 iterations within 1e-4 of max|Y| of the CPU's, from the same P
    and start; chunk 700 leaves a ragged last chunk."""
    from graphlearning_tpu_torch import ars

    P, Y0 = _ars_case(2048, cuda_device)
    cols, vals = P.cols.cpu(), P.vals.cpu()
    Y = np.random.RandomState(6).randn(2048, 2).astype(np.float32)
    got = ars._ars_forces(torch.as_tensor(Y, device=cuda_device), P.cols,
                          P.vals, 2.0, 3.0, chunk)
    want = ars._ars_forces(torch.as_tensor(Y), cols, vals, 2.0, 3.0, chunk)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0,
                                   atol=1e-5 * float(w.abs().max()))
    kw = dict(iters=20, num_early=10, time_step=1.0, theta1=2.0,
              theta2=3.0, alpha=10.0, chunk=chunk)
    Yg = ars._ars_iterate(torch.as_tensor(Y0, device=cuda_device), P.cols,
                          P.vals, **kw)
    Yc = ars._ars_iterate(torch.as_tensor(Y0), cols, vals, **kw)
    torch.testing.assert_close(Yg.cpu(), Yc, rtol=0,
                               atol=1e-4 * float(Yc.abs().max()))
    assert float(Yg.mean(0).abs().max()) < 1e-5 * float(Yg.abs().max())


@pytest.mark.cuda
def test_cuda_vae_replay_matches_the_cpu(cuda_device):
    """20 VAE steps from carried-across parameters (a flax-shaped tree) and
    noise drawn on a CPU generator: the card's latent means within 1e-4 of
    the largest of the CPU's."""
    from graphlearning_tpu_torch import weightmatrix as wm

    rs = np.random.RandomState(7)
    n, d, h, z, batch = 640, 50, 64, 8, 32
    X = wm._vae_data(rs.rand(n, d))
    params = {"params": {
        name: {"kernel": rs.randn(i, o) / np.sqrt(i),
               "bias": rs.randn(o) * 0.01}
        for name, (i, o) in zip(
            ("Dense_0", "Dense_1", "Dense_2", "Dense_3", "Dense_4"),
            ((d, h), (h, z), (h, z), (z, h), (h, d)))}}
    gen = torch.Generator().manual_seed(3)
    draws = [torch.randn((batch, z), generator=gen) for _ in range(20)]
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        it = iter(draws)
        model, hist = wm._vae_train(
            X, (h, z), wm.vae_params_from_flax(params),
            lambda shape: next(it).to(dev), batch, 1, 1e-3, 0, dev)
        out[dev.type] = (wm._vae_encode(model, X, dev), hist[0]["loss"])
    (Zg, lg), (Zc, lc) = out["cuda"], out["cpu"]
    np.testing.assert_allclose(Zg, Zc, rtol=0, atol=1e-4 * np.abs(Zc).max())
    np.testing.assert_allclose(lg, lc, rtol=1e-5)


# -- the distribution layer (P15a) ---------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 4])
def test_cuda_k3_on_halo_extended_partition_blocks(cuda_device, P):
    """K1 builds each block of the partitioned band (its twin's band to
    1e-6 of max|band|: one rounding of the same f32 sums), and K3 runs over
    the block's halo-extended X (its neighbours' boundary rows wrapped as
    the ring does), against its twin and, with the residual edges, the
    rows of the plain product (TOL: f32 sums in other orders)."""
    from graphlearning_tpu_torch.parallel.band_shard import (
        build_band_partition)

    W = _knn_csr(3000, 10, seed=5)
    perm = np.asarray(reverse_cuthill_mckee(W, symmetric_mode=True))
    Wp = W[perm][:, perm].tocsr().tolil()
    Wp[0, 2999] = Wp[2999, 0] = 0.5         # beyond a halo of B / 2
    Wp = Wp.tocsr()
    part = build_band_partition(Wp, P, R=128, WT=64, max_halo_frac=0.5,
                                device=cuda_device)
    twin = build_band_partition(Wp, P, R=128, WT=64, max_halo_frac=0.5,
                                device="cpu", band_dtype=torch.float32)
    assert len(part.res_rows) == 2
    gen = torch.Generator(device="cuda").manual_seed(P)
    X = torch.randn((part.n_pad, 2), generator=gen, device=cuda_device)
    X[3000:] = 0.0
    B, H = part.B, part.H
    out = torch.zeros_like(X)
    for p in range(P):
        _close(part.bands[p].cpu(), twin.bands[p], torch.float32)
        rows = (torch.arange(B + 2 * H, device=cuda_device) + p * B - H) \
            % part.n_pad
        plan = part.tiles_plan(p, cuda_device)
        before = bs.band_tiles_spmm.launches
        o = bs.band_tiles_spmm(part.bands[p], plan, X[rows])
        assert bs.band_tiles_spmm.launches == before + 1
        _close(o, bs._tiles_spmm_plain(part.bands[p], plan, X[rows]),
               torch.float32)
        out[p * B:(p + 1) * B] = o
    out = out.cpu().double().numpy()
    Xh = X.cpu().double().numpy()
    np.add.at(out, part.res_rows, part.res_vals[:, None] * Xh[part.res_cols])
    ref = Wp @ Xh[:3000]
    np.testing.assert_allclose(out[:3000], ref, rtol=0,
                               atol=TOL[torch.float32] * np.abs(ref).max())


@pytest.mark.cuda
def test_cuda_world_size_one_nccl_laplace_fit(cuda_device, tmp_path,
                                              monkeypatch):
    """A Laplace fit on the partitioned band (K1, then K3 over the halo
    that wraps to the rank itself) in a one-rank NCCL group: K3 once per
    product (the CG steps and 2), the plain single-device fit's
    predictions on >= 0.99 of the nodes, its iterations within 1 %."""
    import torch.distributed as dist

    import graphlearning_tpu_torch as gl

    W = _knn_csr(16384, 10, seed=7)
    y = (W._glt_points[:, 0] > 0.5).astype(int)
    ti = gl.trainsets.generate(y, rate=5, seed=0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        bs.reset_launches()
        m = gl.ssl.laplace(W, device=cuda_device).distribute(
            gl.GLTConfig(sharded_kernel="banded"))
        pred = m.fit_predict(ti, y[ti])
        torch.cuda.synchronize()
        assert m._dist.mesh.size == 1 and m._dist.route == "banded"
        assert bs.materialize_band_tiles.launches == 1
        assert bs.band_tiles_spmm.launches == m.iters + 2
    finally:
        dist.destroy_process_group()
    monkeypatch.setenv("GLT_NO_ACCEL", "1")
    ref = gl.ssl.laplace(W, device=cuda_device)
    ref_pred = ref.fit_predict(ti, y[ti])
    assert np.mean(pred == ref_pred) >= 0.99
    assert abs(m.iters - ref.iters) <= 0.01 * ref.iters


# -- the distribution layer (P15b) ---------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("P", [2, 4])
def test_cuda_k7_k9_on_halo_extended_partition_blocks(cuda_device, P):
    """K7 (argmin; plain, reciprocal and Hopf-Lax) and K9 (C = 2 and 40,
    the latter in two column blocks as ``ShardedOp.lip_reduce_`` launches
    it) on each block's halo-extended d, f and U (wrapped as the ring
    does), on the live-chunk list built once per block: K7's min and
    argmin equal to its twin's, K9's sums within TOL of max|ref| and its
    min and max equal."""
    from graphlearning_tpu_torch.parallel.band_shard import (
        build_band_partition)

    W = _knn_csr(3000, 10, seed=6)
    perm = np.asarray(reverse_cuthill_mckee(W, symmetric_mode=True))
    Wp = W[perm][:, perm].tocsr()
    part = build_band_partition(Wp, P, R=128, WT=64, max_halo_frac=0.5,
                                device=cuda_device)
    gen = torch.Generator(device="cuda").manual_seed(P)
    n_pad, B, H = part.n_pad, part.B, part.H
    d = torch.rand(n_pad, generator=gen, device=cuda_device) * 3.0
    f = torch.rand(n_pad, generator=gen, device=cuda_device) + 0.5
    U = torch.randn((n_pad, 40), generator=gen, device=cuda_device)
    for t in (d, f, U):
        t[3000:] = 0.0
    for p in range(P):
        band, plan = part.bands[p], part.tiles_plan(p, cuda_device)
        chunks = bs.tiles_live_chunks(band, plan)
        rows = (torch.arange(B + 2 * H, device=cuda_device) + p * B - H) \
            % n_pad
        for hopf, recip in ((False, False), (False, True), (True, False)):
            m, a = bs.band_tiles_minplus(band, plan, d[rows], f[rows],
                                         hopf_lax=hopf, track_arg=True,
                                         recip=recip, chunks=chunks)
            rm, ra = bs._tiles_minplus_plain(band, plan, d[rows], f[rows],
                                             hopf, True, recip)
            assert torch.equal(m, rm) and torch.equal(a, ra)
        for C in (2, 40):
            for c0 in range(0, C, 32):
                Uc = U[rows][:, c0:min(C, c0 + 32)].contiguous()
                out = bs.band_tiles_lip(band, plan, Uc, chunks)
                ref = bs._tiles_lip_plain(band, plan, Uc)
                _close(out[0], ref[0], torch.float32)
                assert torch.equal(out[1], ref[1])
                assert torch.equal(out[2], ref[2])


@pytest.mark.cuda
def test_cuda_world_size_one_nccl_distance_and_lipschitz_fits(
        cuda_device, tmp_path, monkeypatch):
    """Graph NN (K7 a Bellman-Ford round) and AMLE (K7 for the Voronoi
    start, then K9 a Jacobi round) on the partitioned band in a one-rank
    NCCL group, against the plain single-device fits: graph NN's
    predictions on >= 0.999 of the nodes, AMLE's on >= 0.99."""
    import torch.distributed as dist

    import graphlearning_tpu_torch as gl

    W = _knn_csr(16384, 10, seed=8)
    y = (W._glt_points[:, 0] > 0.5).astype(int)
    ti = gl.trainsets.generate(y, rate=5, seed=0)
    fits = {"graph_nn": lambda: gl.ssl.graph_nearest_neighbor(
                W, device=cuda_device),
            "amle": lambda: gl.ssl.amle(W, tol=1e-5, device=cuda_device)}
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    preds = {}
    try:
        for name, make in fits.items():
            bs.reset_launches()
            m = make().distribute(gl.GLTConfig(sharded_kernel="banded"))
            preds[name] = m.fit_predict(ti, y[ti])
            torch.cuda.synchronize()
            assert m._dist.route == "banded"
            if name == "graph_nn":
                assert bs.band_tiles_minplus.launches == m.iters
            else:
                assert bs.band_tiles_minplus.launches == \
                    m.info["voronoi_iters"]
                assert bs.band_tiles_lip.launches == m.iters
    finally:
        dist.destroy_process_group()
    monkeypatch.setenv("GLT_NO_ACCEL", "1")
    for name, make in fits.items():
        ref = make().fit_predict(ti, y[ti])
        limit = 0.999 if name == "graph_nn" else 0.99
        assert np.mean(preds[name] == ref) >= limit, name


# -- fit packs across devices ------------------------------------------------------


@pytest.mark.cuda
def test_cuda_packs_load_across_devices(cuda_device, tmp_path):
    """A pack saved on one device loads on the other: the Poisson and
    Laplace packs saved here (their segments alone) fit on the card as the
    CPU load of the same file does (agreement >= 0.99), and the spectral
    pack saved on the card (its LOBPCG start drawn there) loads on the CPU
    and the card, the two clusterings agreeing above 95 %."""
    import graphlearning_tpu_torch as gl

    W = _knn_csr(4000, 10, seed=3)
    y = (W._glt_points[:, 0] > 0.5).astype(int) + 2 * (
        W._glt_points[:, 1] > 0.5)
    ti = gl.trainsets.generate(y, rate=3, seed=0)
    for kind in ("poisson", "laplace"):
        path = str(tmp_path / f"{kind}.pack")
        getattr(gl.aot, f"save_{kind}_pack")(W, 4, path)
        load = getattr(gl.aot, f"load_{kind}_pack")
        on_card = load(W, path, device=cuda_device)(ti, y[ti])
        on_cpu = load(W, path, device="cpu")(ti, y[ti])
        assert np.mean(on_card == on_cpu) >= 0.99
    path = str(tmp_path / "spectral.pack")
    gl.aot.save_spectral_pack(W, 4, path, device=cuda_device)
    start = torch.load(path, weights_only=True)["start"]
    assert start.device.type == "cpu" and start.dtype == torch.float32
    on_card = gl.aot.load_spectral_pack(W, path, device=cuda_device)()
    on_cpu = gl.aot.load_spectral_pack(W, path, device="cpu")()
    assert gl.clustering.clustering_accuracy(on_card, on_cpu) > 95.0


# -- the plain ELL product (csrc/plain_ell_spmm.cu) --------------------------

# d of the plain ELL cases: each sub-group width (1-16), a warp a row at
# and below 32, and 2 to 4 columns a lane in one or more column blocks
PLAIN_ELL_D = [1, 2, 3, 10, 16, 17, 20, 30, 33, 57, 171]


def _skewed_ell(n=6000, k=125, seed=0):
    """ELL arrays of skewed degrees (mean about 16): rows of degree 0, rows
    at the full ``k``, padding slots whose column is the row itself."""
    rs = np.random.RandomState(seed)
    deg = np.minimum(rs.geometric(1 / 16, size=n), k)
    deg[rs.rand(n) < 0.02] = 0
    deg[[0, 7, n - 1]] = 0
    deg[[1, 8, n - 2]] = k
    real = np.arange(k)[None, :] < deg[:, None]
    cols = np.repeat(np.arange(n, dtype=np.int32)[:, None], k, axis=1)
    vals = np.zeros((n, k), np.float32)
    cols[real] = rs.randint(0, n, size=int(real.sum()))
    vals[real] = rs.rand(int(real.sum())) + 0.1
    return cols, vals, deg.astype(np.int32)


def _moons_ell(n=65536):
    """The ELL of a two-moons kNN graph (k=10, symmetrised), as the fits'
    plain route holds it."""
    rs = np.random.RandomState(0)
    t = np.linspace(0, np.pi, n // 2)
    pts = np.vstack([np.stack([np.cos(t), np.sin(t)], 1),
                     np.stack([1 - np.cos(t), 1 - np.sin(t) - 0.5], 1)])
    pts = pts[rs.permutation(n)] + rs.normal(scale=0.1, size=(n, 2))
    dist, ind = cKDTree(pts).query(pts, k=11)
    w = np.exp(-4 * dist[:, 1:] ** 2 / dist[:, -1:] ** 2)
    W = sp.csr_matrix((w.ravel(), (np.repeat(np.arange(n), 10),
                                   ind[:, 1:].ravel())), shape=(n, n))
    cols, vals, deg = SparseGraph.ell_from_scipy(((W + W.T) / 2).tocsr())
    return cols, vals.astype(np.float32), deg


@pytest.fixture(scope="module", params=["skewed", "moons"])
def plain_ell(request):
    return _skewed_ell() if request.param == "skewed" else _moons_ell()


def _real_slots_f64(cols, vals, deg, X):
    """The float64 gather-and-sum over each row's real slots, on the host."""
    real = np.arange(cols.shape[1])[None, :] < deg[:, None]
    rows = np.repeat(np.arange(cols.shape[0]), deg)
    W = sp.csr_matrix((vals[real].astype(np.float64), (rows, cols[real])),
                      shape=(cols.shape[0], X.shape[0]))
    return W @ X.astype(np.float64)


@pytest.mark.cuda
@pytest.mark.parametrize("d", PLAIN_ELL_D)
def test_cuda_plain_ell_spmm_matches_twin(plain_ell, cuda_device, d):
    """The kernel against the float64 sum over the real slots, within TOL
    of max|ref|; one launch a product; the same bits in a second call, with
    NaN in every padding value (the kernel reads the real slots alone), and
    from an X strided by rows or stored by columns."""
    from graphlearning_tpu_torch.ops import graphops

    cols, vals, deg = plain_ell
    dev = cuda_device
    X = np.random.RandomState(d).randn(cols.shape[0], d).astype(np.float32)
    c, v, dg = (torch.as_tensor(a, device=dev) for a in (cols, vals, deg))
    Xd = torch.as_tensor(X, device=dev)
    n0 = graphops.plain_ell_spmm.launches
    out = graphops.plain_ell_spmm(c, v, dg, Xd)
    assert graphops.plain_ell_spmm.launches == n0 + 1
    ref = torch.as_tensor(_real_slots_f64(cols, vals, deg, X))
    _close(out.cpu().double(), ref, torch.float32)
    assert torch.equal(graphops.plain_ell_spmm(c, v, dg, Xd), out)
    v_nan = v.clone()
    v_nan[torch.arange(v.shape[1], device=dev)[None, :] >= dg[:, None]] = \
        float("nan")
    assert torch.equal(graphops.plain_ell_spmm(c, v_nan, dg, Xd), out)
    wide = torch.zeros((Xd.shape[0], d + 3), device=dev)
    wide[:, 1:d + 1] = Xd
    by_cols = Xd.t().contiguous().t()
    for Xs in (wide[:, 1:d + 1], by_cols):
        assert not Xs.is_contiguous() or d == 1
        assert torch.equal(graphops.plain_ell_spmm(c, v, dg, Xs), out)


@pytest.mark.cuda
def test_cuda_spmm_takes_the_kernel_for_float32(cuda_device):
    """``graphops.spmm`` on the card: a float32 X (2-D, 1-D, and through
    ``laplacian_matvec``) goes to the kernel, one launch and one
    ``spmm.ell_kernel`` a product; a float64 X keeps the torch form
    (``spmm.ell_torch``).  Both within TOL of the float64 product."""
    from graphlearning_tpu_torch.observability import counters
    from graphlearning_tpu_torch.ops import graphops

    cols, vals, deg = _skewed_ell(n=3000, k=60, seed=1)
    dev = cuda_device
    g = SparseGraph.from_ell_np(cols, vals, deg, dtype=torch.float32,
                                device=dev)
    X = np.random.RandomState(0).randn(g.n, 30)
    ref = torch.as_tensor(_real_slots_f64(cols, vals, deg, X))

    def counts():
        return (counters.get("spmm.ell_kernel"),
                counters.get("spmm.ell_torch"),
                graphops.plain_ell_spmm.launches)

    for Xd, kernel in ((torch.as_tensor(X, dtype=torch.float32, device=dev),
                        True),
                       (torch.as_tensor(X, device=dev), False)):
        before = counts()
        out = graphops.spmm(g, Xd)
        out1 = graphops.spmm(g, Xd[:, 4])
        graphops.laplacian_matvec(g, Xd)
        delta = tuple(a - b for a, b in zip(counts(), before))
        assert delta == ((3.0, 0.0, 3) if kernel else (0.0, 3.0, 0))
        _close(out.cpu().double(), ref, torch.float32)
        _close(out1.cpu().double(), ref[:, 4], torch.float32)


@pytest.mark.cuda
@pytest.mark.parametrize("hub", [False, True])
def test_cuda_world_size_one_nccl_ell_route_takes_the_plain_ell_kernel(
        cuda_device, tmp_path, monkeypatch, hub):
    """A Laplace fit on the sharded ELL rows ("gspmd"; with a hub node,
    the capped ELL and its spill, "bucketed") in a one-rank NCCL group:
    the local rows' product is the plain ELL kernel, at least once a CG
    step, and the fit gives the plain single-device fit's predictions on
    >= 0.99 of the nodes."""
    import torch.distributed as dist

    import graphlearning_tpu_torch as gl
    from graphlearning_tpu_torch.ops import graphops

    W = _knn_csr(16384, 10, seed=9)
    if hub:
        pts, others = W._glt_points, np.arange(1, W.shape[0])
        nb = np.random.RandomState(1).choice(others, 600, replace=False)
        H = sp.csr_matrix((np.full(600, 0.05), (np.zeros(600, int), nb)),
                          shape=W.shape)
        W = (W + H + H.T).tocsr()
        W._glt_points = pts
    y = (W._glt_points[:, 0] > 0.5).astype(int)
    ti = gl.trainsets.generate(y, rate=5, seed=0)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        n0 = graphops.plain_ell_spmm.launches
        m = gl.ssl.laplace(W, device=cuda_device).distribute(
            gl.GLTConfig(sharded_kernel="gspmd"))
        pred = m.fit_predict(ti, y[ti])
        torch.cuda.synchronize()
        assert m._dist.route == ("bucketed" if hub else "gspmd")
        assert graphops.plain_ell_spmm.launches - n0 >= m.iters
    finally:
        dist.destroy_process_group()
    monkeypatch.setenv("GLT_NO_ACCEL", "1")
    ref_pred = gl.ssl.laplace(W, device=cuda_device).fit_predict(ti, y[ti])
    assert np.mean(pred == ref_pred) >= 0.99


@pytest.mark.cuda
def test_cuda_plain_ell_spmm_refuses_what_the_kernel_does_not_take(
        cuda_device):
    """int64 indices, a strided ELL, a wrong ``deg`` and tensors on two
    devices are refused before any launch; float64 values are cast for the
    kernel, and a float64 X takes the twin (``spmm.ell_torch``)."""
    from graphlearning_tpu_torch.observability import counters
    from graphlearning_tpu_torch.ops import graphops

    cols, vals, deg = (torch.as_tensor(a, device=cuda_device)
                       for a in _skewed_ell(n=256, k=40, seed=2))
    X = torch.randn((256, 5), device=cuda_device)
    n0 = graphops.plain_ell_spmm.launches
    bad = [(cols.long(), vals, deg, X), (cols, vals, deg.long(), X),
           (cols.t().contiguous().t(), vals, deg, X),
           (cols, vals, deg[:-1], X), (cols, vals, deg, X.cpu())]
    for args in bad:
        with pytest.raises(ValueError):
            graphops.plain_ell_spmm(*args)
    assert graphops.plain_ell_spmm.launches == n0
    out = graphops.plain_ell_spmm(cols, vals, deg, X)
    assert torch.equal(graphops.plain_ell_spmm(cols, vals.double(), deg, X),
                       out)
    assert graphops.plain_ell_spmm.launches == n0 + 2
    t0 = counters.get("spmm.ell_torch")
    out64 = graphops.plain_ell_spmm(cols, vals, deg, X.double())
    assert counters.get("spmm.ell_torch") == t0 + 1
    assert graphops.plain_ell_spmm.launches == n0 + 2
    _close(out64.cpu(), out.cpu().double(), torch.float32)
