"""The live-chunk list of the unpacked tiles band (``tiles_live_chunks``),
which drives K7 and K9 on the card, on the CPU.

The list names, for each 16-row group of the output, the 16 x 32 chunks
of its row block's tiles that hold a nonzero cell, by tile in plan order,
then by column.  The kernels read only those chunks, so the list must
cover every nonzero cell and name nothing else.  A min-plus round and the
Lipschitz reductions over the listed chunks alone are held to the Pallas
kernels (interpret mode) and to the dense twins.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch
import jax.numpy as jnp
from scipy.sparse.csgraph import reverse_cuthill_mckee
from scipy.spatial import cKDTree

from graphlearning_tpu.ops import pallas_spmm as jps
from graphlearning_tpu_torch.core.sparse import SparseGraph
from graphlearning_tpu_torch.ops import accel
from graphlearning_tpu_torch.ops import band_spmm as bs

torch.set_num_threads(2)

ROWS, KC = bs._LIVE_ROWS, bs._LIVE_KC
N, R, WT = 1024, 128, 128
CPT = WT // KC                  # chunks a tile row


def _knn_csr(n, k, seed):
    rs = np.random.RandomState(seed)
    pts = rs.rand(n, 2)
    dist, ind = cKDTree(pts).query(pts, k=k + 1)
    dist, ind = dist[:, 1:], ind[:, 1:]
    w = np.exp(-4 * dist ** 2 / np.maximum(dist[:, -1:] ** 2, 1e-12))
    W = sp.csr_matrix((w.ravel(), (np.repeat(np.arange(n), k), ind.ravel())),
                      shape=(n, n))
    return ((W + W.T) / 2).tocsr()


@pytest.fixture(scope="module")
def tiles_case():
    """The RCM-ordered kNN graph padded to 1024 rows, its tiles plan at
    R = WT = 128 (every edge in a tile, several tiles a block) and K1's
    bands in f32 and bf16."""
    W = _knn_csr(1000, 10, seed=0)
    perm = np.asarray(reverse_cuthill_mckee(W, symmetric_mode=True))
    Wp = W[perm][:, perm].tocsr()
    Wp.resize((N, N))
    cols, vals, deg = SparseGraph.ell_from_scipy(Wp)
    tb, ts, bf, rr, _, _ = bs.plan_tiles(
        cols, R=R, WT=WT, deg=deg, kcap=cols.shape[1], min_edges_per_tile=1,
        hbm_budget_bytes=float("inf"))
    assert len(rr) == 0 and np.bincount(tb).max() > 1
    plan = bs.TilesPlan.from_tiles(tb, ts, N, R, WT, "cpu")
    args = [torch.as_tensor(a) for a in (cols, vals.astype(np.float32), tb,
                                         ts)]
    bands = {dt: bs.materialize_band_tiles(*args, R=R, WT=WT, out_dtype=dt)
             for dt in (torch.float32, torch.bfloat16)}
    return plan, bands, (tb, ts, bf)


def _band(tiles_case, kind, dtype):
    """``rcm``: K1's band of the plan; ``empty_group``: the same with
    output rows 16-31 (row group 1, in every tile of block 0) zeroed;
    ``all_live``: random cells, about 5 % nonzero, so every chunk is live;
    ``ties``: the plan's band with every nonzero cell 1, so that with
    constant ``d`` and ``f`` every candidate of a row ties."""
    plan, bands, _ = tiles_case
    band = bands[dtype].clone()
    if kind == "empty_group":
        band.view(-1, R, WT)[plan.slab_block == 0, ROWS:2 * ROWS] = 0
    elif kind == "all_live":
        rs = np.random.RandomState(7)
        shape = tuple(band.shape)
        cells = rs.rand(*shape) * (rs.rand(*shape) < 0.05)
        band = torch.as_tensor(cells, dtype=torch.float32).to(dtype)
    elif kind == "ties":
        band = (band != 0).to(dtype)
    return plan, band


def _listed(chunk_ptr, chunk_id):
    """{(row group, chunk id)} of a list, and each group's entries."""
    ptr, ids = chunk_ptr.numpy(), chunk_id.numpy()
    groups = [ids[ptr[g]:ptr[g + 1]] for g in range(len(ptr) - 1)]
    return {(g, int(c)) for g, cs in enumerate(groups) for c in cs}, groups


KINDS = ["rcm", "empty_group", "all_live"]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_every_nonzero_cell_lies_in_a_listed_chunk(tiles_case, kind, dtype):
    plan, band = _band(tiles_case, kind, dtype)
    chunk_ptr, chunk_id = bs.tiles_live_chunks(band, plan)
    assert chunk_ptr.dtype == torch.int32 and chunk_id.dtype == torch.int32
    assert chunk_ptr.shape == (N // ROWS + 1,)
    assert int(chunk_ptr[0]) == 0 and int(chunk_ptr[-1]) == chunk_id.numel()
    listed, _ = _listed(chunk_ptr, chunk_id)
    rows, cols = np.nonzero(band.float().numpy())
    assert len(rows) > 0
    tile = rows // R
    group = plan.slab_block.numpy()[tile] * (R // ROWS) + rows % R // ROWS
    cells = set(zip(group.tolist(), (tile * CPT + cols // KC).tolist()))
    assert cells <= listed
    if kind == "all_live":
        assert len(listed) == plan.slab_block.numel() * (R // ROWS) * CPT


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_every_listed_chunk_holds_a_nonzero_cell(tiles_case, kind, dtype):
    plan, band = _band(tiles_case, kind, dtype)
    listed, _ = _listed(*bs.tiles_live_chunks(band, plan))
    for g, cid in listed:
        tile, c = divmod(cid, CPT)
        r0 = tile * R + g * ROWS % R
        assert int(plan.slab_block[tile]) == g * ROWS // R
        assert bool(band[r0:r0 + ROWS, c * KC:(c + 1) * KC].any())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_each_group_lists_its_chunks_by_tile_then_column(tiles_case, kind,
                                                         dtype):
    """Ascending ids: the tiles in plan order (their block's, within
    ``block_ptr``), then the columns."""
    plan, band = _band(tiles_case, kind, dtype)
    chunk_ptr, chunk_id = bs.tiles_live_chunks(band, plan)
    assert bool((chunk_ptr[1:] >= chunk_ptr[:-1]).all())
    block_ptr = plan.block_ptr.numpy()
    for g, ids in enumerate(_listed(chunk_ptr, chunk_id)[1]):
        assert (np.diff(ids) > 0).all()
        b = g * ROWS // R
        assert ((ids >= block_ptr[b] * CPT)
                & (ids < block_ptr[b + 1] * CPT)).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_an_empty_row_group_gets_an_empty_range(tiles_case, dtype):
    plan, band = _band(tiles_case, "empty_group", dtype)
    chunk_ptr, _ = bs.tiles_live_chunks(band, plan)
    assert int(chunk_ptr[2]) == int(chunk_ptr[1])
    full_ptr, _ = bs.tiles_live_chunks(tiles_case[1][dtype], plan)
    assert int(full_ptr[2]) > int(full_ptr[1])     # it held chunks before
    empty = bs.tiles_live_chunks(torch.zeros_like(band), plan)
    assert not empty[0].any() and empty[1].numel() == 0


@pytest.mark.parametrize("kind", KINDS)
def test_a_bf16_list_lies_within_its_f32_list(tiles_case, kind):
    """bf16 rounding keeps every zero and may flush a tiny cell to zero,
    never the other way."""
    plan, band = _band(tiles_case, kind, torch.float32)
    lf, _ = _listed(*bs.tiles_live_chunks(band, plan))
    lb, _ = _listed(*bs.tiles_live_chunks(band.to(torch.bfloat16), plan))
    assert lb <= lf
    tiny = band.clone()
    tiny[0, 0] = 1e-41      # f32 subnormal, rounds to 0 in bf16
    tiny[:ROWS, :KC][tiny[:ROWS, :KC] != tiny[0, 0]] = 0
    lt, _ = _listed(*bs.tiles_live_chunks(tiny, plan))
    lbt, _ = _listed(*bs.tiles_live_chunks(tiny.to(torch.bfloat16), plan))
    first = (int(plan.slab_block[0]) * (R // ROWS), 0)
    assert first in lt and first not in lbt and lbt <= lt


def _listed_cells(band, plan, g, ids):
    """Row group ``g``'s listed chunks side by side in list order: the
    (ROWS, len(ids) * KC) cells and their absolute columns."""
    rin = g * ROWS % R
    starts = plan.slab_starts[:, 0]
    A = torch.cat([band[t * R + rin:t * R + rin + ROWS, c * KC:(c + 1) * KC]
                   for t, c in (divmod(int(i), CPT) for i in ids)], dim=1)
    col = torch.cat([starts[int(i) // CPT] + int(i) % CPT * KC
                     + torch.arange(KC) for i in ids])
    return A, col


def _listed_minplus(band, plan, d, f, hopf_lax, recip, chunks):
    """The min-plus round over the listed chunks alone, with the twin's
    f32 candidates: per row the least candidate, and the column of the
    first least one in list order (-1 where none is below MINPLUS_BIG)."""
    m = torch.full((plan.n,), bs.MINPLUS_BIG, dtype=torch.float32)
    arg = torch.full((plan.n,), -1, dtype=torch.int32)
    for g, ids in enumerate(_listed(*chunks)[1]):
        if len(ids) == 0:
            continue
        A, col = _listed_cells(band, plan, g, ids)
        cand = bs._minplus_cand(A.float(), d[col][None, :], f[col][None, :],
                                hopf_lax, recip)
        mg = torch.amin(cand, dim=1)
        first = torch.argmax((cand == mg[:, None]).int(), dim=1)
        rows = slice(g * ROWS, (g + 1) * ROWS)
        m[rows] = mg
        arg[rows] = torch.where(mg < bs.MINPLUS_BIG,
                                col[first].to(torch.int32), -1)
    return m, arg


def _distances(kind):
    rs = np.random.RandomState(5)
    if kind == "ties":
        return np.ones(N, np.float32), np.full(N, 0.75, np.float32)
    d = (rs.rand(N) * 3).astype(np.float32)
    d[rs.rand(N) < 0.3] = 1e30                     # unreached nodes
    return d, (rs.rand(N) + 0.5).astype(np.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS + ["ties"])
@pytest.mark.parametrize("hopf_lax,recip", [(False, False), (True, True)])
def test_the_listed_chunks_minplus_equals_the_twin_and_pallas(
        tiles_case, kind, dtype, hopf_lax, recip):
    """Min and argmin over the listed chunks are the dense twin's exactly
    (a skipped chunk holds no candidate; on the tie band the first nonzero
    cell in tile, then column, order wins); against JAX's kernel the min
    within 1e-6 and the argmin a column that attains it (XLA may contract
    the candidates), the same column on the tie band."""
    plan, band = _band(tiles_case, kind, dtype)
    d, f = _distances(kind)
    dt, ft = torch.as_tensor(d), torch.as_tensor(f)
    m, arg = _listed_minplus(band, plan, dt, ft, hopf_lax, recip,
                             bs.tiles_live_chunks(band, plan))
    rm, rarg = bs._tiles_minplus_plain(band, plan, dt, ft, hopf_lax, True,
                                       recip)
    torch.testing.assert_close(m, rm, rtol=0, atol=0)
    torch.testing.assert_close(arg, rarg, rtol=0, atol=0)
    assert bool((m < bs.MINPLUS_BIG).any())
    tb, ts, bf = tiles_case[2]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jps.band_tiles_minplus(
        jnp.asarray(band.float().numpy()).astype(jdt), jnp.asarray(tb),
        jnp.asarray(ts), jnp.asarray(bf), jnp.asarray(d), jnp.asarray(f), N,
        R=R, WT=WT, hopf_lax=hopf_lax, track_arg=True, recip=recip,
        interpret=True))
    has = ref[:, 0] < 1e30
    np.testing.assert_allclose(m.numpy(), ref[:, 0], rtol=1e-6)
    assert np.all(arg.numpy()[~has] == -1)
    dense = np.zeros((N, N), np.float32)
    for g, (b, s) in enumerate(zip(tb, ts)):
        dense[b * R:(b + 1) * R, s:s + WT] = \
            band.float().numpy()[g * R:(g + 1) * R]
    rows = np.nonzero(has)[0]
    cols = arg.numpy()[rows]
    assert (dense[rows, cols] > 0).all()
    if kind == "ties":
        np.testing.assert_array_equal(cols, ref[rows, 1].astype(np.int64))


def _listed_lip(band, plan, U, chunks):
    """The Lipschitz reductions over the listed chunks alone: the sums in
    f64, the mins and maxes over the cells A > 0."""
    C = U.shape[1]
    sums = torch.zeros((plan.n, C), dtype=torch.float64)
    mins = torch.full((plan.n, C), bs.LIP_BIG, dtype=torch.float32)
    maxs = torch.full((plan.n, C), -bs.LIP_BIG, dtype=torch.float32)
    for g, ids in enumerate(_listed(*chunks)[1]):
        if len(ids) == 0:
            continue
        A, col = _listed_cells(band, plan, g, ids)
        rows = slice(g * ROWS, (g + 1) * ROWS)
        Uc = U[col]                                    # (L, C)
        sums[rows] = A.double() @ Uc.double()
        has = (A > 0)[:, :, None]
        mins[rows] = torch.amin(torch.where(has, Uc[None], bs.LIP_BIG), 1)
        maxs[rows] = torch.amax(torch.where(has, Uc[None], -bs.LIP_BIG), 1)
    return sums, mins, maxs


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("C", [1, 3])
def test_the_listed_chunks_lip_matches_the_twin_and_pallas(tiles_case, kind,
                                                           dtype, C):
    """Min and max over the listed chunks are the dense twin's and JAX's
    exactly; the sums within 1e-5 of max|ref| of JAX's (f32 sums in
    another order) and equal to the dense twin in f64 to rounding."""
    plan, band = _band(tiles_case, kind, dtype)
    U = np.random.RandomState(6).randn(N, C).astype(np.float32)
    Ut = torch.as_tensor(U)
    sums, mins, maxs = _listed_lip(band, plan, Ut,
                                   bs.tiles_live_chunks(band, plan))
    twin = bs._tiles_lip_plain(band, plan, Ut)
    torch.testing.assert_close(mins, twin[1], rtol=0, atol=0)
    torch.testing.assert_close(maxs, twin[2], rtol=0, atol=0)
    twin64 = bs._tiles_lip_plain(band.double(), plan, Ut.double())[0]
    np.testing.assert_allclose(sums.numpy(), twin64.numpy(), rtol=0,
                               atol=1e-12 * float(twin64.abs().max()))
    tb, ts, bf = tiles_case[2]
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jps.band_tiles_lip(
        jnp.asarray(band.float().numpy()).astype(jdt), jnp.asarray(tb),
        jnp.asarray(ts), jnp.asarray(bf),
        jnp.asarray(np.pad(U, ((0, 0), (0, 128 - C)))), N, C=C, R=R, WT=WT,
        interpret=True))
    np.testing.assert_allclose(sums.numpy(), ref[:, :C], rtol=0,
                               atol=1e-5 * np.abs(ref[:, :C]).max())
    np.testing.assert_array_equal(mins.numpy(), ref[:, 128:128 + C])
    np.testing.assert_array_equal(maxs.numpy(), ref[:, 256:256 + C])


def test_the_wrappers_take_a_list_and_the_cpu_twins_ignore_it(tiles_case):
    plan, band = _band(tiles_case, "rcm", torch.float32)
    chunks = bs.tiles_live_chunks(band, plan)
    d, f = torch.rand(N), torch.rand(N) + 0.5
    for a, b in zip(bs.band_tiles_minplus(band, plan, d, f, track_arg=True,
                                          chunks=chunks),
                    bs.band_tiles_minplus(band, plan, d, f, track_arg=True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    U = torch.randn(N, 2)
    for a, b in zip(bs.band_tiles_lip(band, plan, U, chunks),
                    bs.band_tiles_lip(band, plan, U)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_tiles_live_chunks_refuses_what_it_does_not_describe(tiles_case):
    plan, band = _band(tiles_case, "rcm", torch.float32)
    with pytest.raises(ValueError):              # a band of another width
        bs.tiles_live_chunks(band[:, :64].contiguous(), plan)
    with pytest.raises(ValueError):              # one tile short
        bs.tiles_live_chunks(band[:-R].contiguous(), plan)
    odd = bs.TilesPlan.from_tiles([0, 1], [0, 48], 96, 48, 48, "cpu")
    with pytest.raises(ValueError):              # WT not a multiple of 32
        bs.tiles_live_chunks(torch.zeros(96, 48), odd)
    odd = bs.TilesPlan.from_tiles([0, 1], [0, 64], 48, 24, 64, "cpu")
    with pytest.raises(ValueError):              # R not a multiple of 16
        bs.tiles_live_chunks(torch.zeros(48, 64), odd)


def _bad_lists(plan, chunk_ptr, chunk_id):
    """A list broken in each way the launch check refuses."""
    ptr, ids = chunk_ptr.clone(), chunk_id.clone()
    group = int((ptr[1:] - ptr[:-1] >= 2).nonzero()[0])
    flipped = ids.clone()
    a = int(ptr[group])
    flipped[a], flipped[a + 1] = ids[a + 1], ids[a]
    past = ids.clone()
    past[-1] = plan.slab_block.numel() * CPT
    # group 0's first entry names a tile of another row block
    other = ids.clone()
    block_ptr = plan.block_ptr
    other[0] = int(block_ptr[1]) * CPT
    return {"short_ptr_end": (torch.cat([ptr[:-1], ptr[-1:] - 1]), ids),
            "ptr_not_from_0": (ptr + 1, ids),
            "id_past_the_tiles": (ptr, past),
            "id_of_another_block": (ptr, other),
            "id_negative": (ptr, torch.where(ids == ids[0], -1, ids)),
            "descending_in_a_group": (ptr, flipped),
            "int64": (ptr.long(), ids.long()),
            "one_group_short": (ptr[:-1], ids)}


@pytest.mark.parametrize("how", ["short_ptr_end", "ptr_not_from_0",
                                 "id_past_the_tiles", "id_of_another_block",
                                 "id_negative", "descending_in_a_group",
                                 "int64", "one_group_short"])
def test_the_launch_check_refuses_a_broken_list(tiles_case, how):
    """K7's and K9's launch check refuses a list that would read out of
    the band, outside its group's row block, or out of order, and passes
    the built one."""
    plan, band = _band(tiles_case, "rcm", torch.float32)
    chunks = bs.tiles_live_chunks(band, plan)
    assert int(chunks[0][1]) > 0                 # group 0 lists a chunk
    bs._check_live_chunks("band_tiles_minplus", plan, *chunks)
    with pytest.raises(ValueError):
        bs._check_live_chunks("band_tiles_minplus", plan,
                              *_bad_lists(plan, *chunks)[how])


def test_accel_keeps_a_list_beside_the_tiles_band():
    """``AccelSpMM.live_chunks`` gives the tiles band its
    ``tiles_live_chunks`` list, built once and keyed by the band tensor:
    the distance rounds reuse it, a band built anew gets its own, and the
    packed matvec band, which no list describes, is refused."""
    W = _knn_csr(900, 10, seed=3)
    acc = accel.AccelSpMM(W, device="cpu")
    assert acc.packed and acc.tiles_plan is not None
    band = acc.tiles_band()
    chunks = acc.live_chunks(band)
    assert acc.live_chunks(acc.tiles_band()) is chunks
    for a, b in zip(chunks, bs.tiles_live_chunks(band, acc.tiles_plan)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    d0 = np.full(900, bs.MINPLUS_BIG)
    d0[:3] = 0.0
    acc.bellman_ford(d0, np.ones(900))
    assert acc.live_chunks(acc.tiles_band()) is chunks   # reused
    b16 = acc.build_band(torch.bfloat16, tiles=True)
    own = acc.live_chunks(b16)
    assert own is not chunks and acc.live_chunks(b16) is own
    assert _listed(*own)[0] <= _listed(*chunks)[0]
    with pytest.raises(ValueError):
        acc.live_chunks(acc.band())


def test_the_tiles_geometry_admits_the_chunk_kernels():
    """The accel's unpacked tiles geometry meets K7's and K9's launch
    checks: R a multiple of the warp's rows and WT of the chunk."""
    assert accel._TILES_R % ROWS == 0
    assert accel._TILES_WT % KC == 0
