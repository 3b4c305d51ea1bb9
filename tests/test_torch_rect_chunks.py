"""The live-chunk list of the rectangular band (``rect_live_chunks``),
which drives K5 and K8 on the card, on the CPU.

The list names, for each 64-row group of the (n, W) band, the 64-column
chunks of its window that hold a nonzero cell.  The kernels read only
those chunks, so the list must cover every nonzero cell and name nothing
else.  A product and a min-plus round over the listed chunks alone are
held to the Pallas kernels (interpret mode) and to the dense twins.
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

ROWS, KC = bs._TILES_ROWS, bs._TILES_KC


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
def rect_case():
    """The RCM-ordered kNN graph padded to 1024 rows and its rectangular
    plan at R = WT = 128, which leaves edges out of the window."""
    W = _knn_csr(1000, 10, seed=0)
    perm = np.asarray(reverse_cuthill_mckee(W, symmetric_mode=True))
    Wp = W[perm][:, perm].tocsr()
    Wp.resize((1024, 1024))
    cols, vals, deg = SparseGraph.ell_from_scipy(Wp)
    winstart, rrows, _, Wr, kcap = bs.plan_banded(
        cols, R=128, WT=128, deg=deg, kcap_max=32, max_residual=0.05)
    assert Wr < 1024 and len(rrows) > 0
    c = torch.as_tensor(np.ascontiguousarray(cols[:, :kcap]))
    v = torch.as_tensor(vals[:, :kcap].astype(np.float32))
    plan = bs.RectPlan.from_numpy(winstart, 1024, 128, 128, Wr, kcap, "cpu")
    bands = {dt: bs.materialize_band(c, v, plan.winstart, Wr, R=128,
                                     WT=128, out_dtype=dt)
             for dt in (torch.float32, torch.bfloat16)}
    return plan, bands


def _band(rect_case, kind, dtype):
    """``rcm``: K4's band of the plan; ``empty_group``: the same with rows
    64-127 (one whole row group) zeroed; ``all_live``: random cells, about
    5 % nonzero, so every chunk is live."""
    plan, bands = rect_case
    band = bands[dtype].clone()
    if kind == "empty_group":
        band[ROWS:2 * ROWS] = 0
    elif kind == "all_live":
        rs = np.random.RandomState(7)
        cells = rs.rand(plan.n, plan.W) * (rs.rand(plan.n, plan.W) < 0.05)
        band = torch.as_tensor(cells, dtype=torch.float32).to(dtype)
    return plan, band


def _listed(chunk_ptr, chunk_col):
    """{(row group, chunk)} of a list, and each group's chunks."""
    ptr, col = chunk_ptr.numpy(), chunk_col.numpy()
    groups = [col[ptr[g]:ptr[g + 1]] for g in range(len(ptr) - 1)]
    return {(g, int(c)) for g, cs in enumerate(groups) for c in cs}, groups


KINDS = ["rcm", "empty_group", "all_live"]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_every_nonzero_cell_lies_in_a_listed_chunk(rect_case, kind, dtype):
    plan, band = _band(rect_case, kind, dtype)
    chunk_ptr, chunk_col = bs.rect_live_chunks(band, plan)
    assert chunk_ptr.dtype == torch.int32 and chunk_col.dtype == torch.int32
    assert chunk_ptr.shape == (plan.n // ROWS + 1,)
    assert int(chunk_ptr[0]) == 0 and int(chunk_ptr[-1]) == chunk_col.numel()
    listed, _ = _listed(chunk_ptr, chunk_col)
    rows, cols = np.nonzero(band.float().numpy())
    assert len(rows) > 0
    cells = set(zip((rows // ROWS).tolist(), (cols // KC).tolist()))
    assert cells <= listed
    if kind == "all_live":
        assert len(listed) == (plan.n // ROWS) * (plan.W // KC)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_every_listed_chunk_holds_a_nonzero_cell(rect_case, kind, dtype):
    plan, band = _band(rect_case, kind, dtype)
    listed, _ = _listed(*bs.rect_live_chunks(band, plan))
    for g, c in listed:
        assert 0 <= c < plan.W // KC
        assert bool(band[g * ROWS:(g + 1) * ROWS, c * KC:(c + 1) * KC].any())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_each_group_lists_its_chunks_ascending(rect_case, kind, dtype):
    plan, band = _band(rect_case, kind, dtype)
    chunk_ptr, chunk_col = bs.rect_live_chunks(band, plan)
    assert bool((chunk_ptr[1:] >= chunk_ptr[:-1]).all())
    for cs in _listed(chunk_ptr, chunk_col)[1]:
        assert (np.diff(cs) > 0).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_an_empty_row_group_gets_an_empty_range(rect_case, dtype):
    plan, band = _band(rect_case, "empty_group", dtype)
    chunk_ptr, _ = bs.rect_live_chunks(band, plan)
    assert int(chunk_ptr[2]) == int(chunk_ptr[1])
    full_ptr, _ = bs.rect_live_chunks(rect_case[1][dtype], plan)
    assert int(full_ptr[2]) > int(full_ptr[1])     # it held chunks before
    empty = bs.rect_live_chunks(torch.zeros_like(band), plan)
    assert not empty[0].any() and empty[1].numel() == 0


@pytest.mark.parametrize("kind", KINDS)
def test_a_bf16_list_lies_within_its_f32_list(rect_case, kind):
    """bf16 rounding keeps every zero and may flush a tiny cell to zero,
    never the other way."""
    plan, band = _band(rect_case, kind, torch.float32)
    lf, _ = _listed(*bs.rect_live_chunks(band, plan))
    lb, _ = _listed(*bs.rect_live_chunks(band.to(torch.bfloat16), plan))
    assert lb <= lf
    tiny = band.clone()
    tiny[0, 0] = 1e-41      # f32 subnormal, rounds to 0 in bf16
    tiny[:ROWS, :KC][tiny[:ROWS, :KC] != tiny[0, 0]] = 0
    lt, _ = _listed(*bs.rect_live_chunks(tiny, plan))
    lbt, _ = _listed(*bs.rect_live_chunks(tiny.to(torch.bfloat16), plan))
    assert (0, 0) in lt and (0, 0) not in lbt and lbt <= lt


def _listed_spmm(band, plan, X, chunks):
    """The product over the listed chunks alone, in f64: what K5 adds."""
    out = torch.zeros((plan.n, X.shape[1]), dtype=torch.float64)
    _, groups = _listed(*chunks)
    for g, cs in enumerate(groups):
        r0 = g * ROWS
        ws = int(plan.winstart_host[r0 // plan.R])
        for c in cs:
            out[r0:r0 + ROWS] += (band[r0:r0 + ROWS, c * KC:(c + 1) * KC]
                                  .double()
                                  @ X[ws + c * KC:ws + (c + 1) * KC])
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
def test_the_listed_chunks_product_matches_pallas(rect_case, kind, dtype):
    """Within 1e-5 of max|ref| of JAX's dense band product (f32 sums in
    another order); equal to the dense twin in f64 to rounding."""
    plan, band = _band(rect_case, kind, dtype)
    X = np.random.RandomState(11).randn(1024, 3).astype(np.float32)
    Xt = torch.as_tensor(X).to(dtype)
    out = _listed_spmm(band, plan, Xt.double(),
                       bs.rect_live_chunks(band, plan))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = np.asarray(jps.band_spmm(
        jnp.asarray(band.float().numpy()).astype(jdt),
        jnp.asarray(plan.winstart_host),
        jnp.asarray(np.pad(Xt.float().numpy(), ((0, 0), (0, 125)))),
        R=128, WT=128, interpret=True, mode="f32"))[:, :3]
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    twin = bs._rect_spmm_plain(band.double(), plan, Xt.double())
    np.testing.assert_allclose(out.numpy(), twin.numpy(), rtol=0,
                               atol=1e-12 * float(twin.abs().max()))


def _listed_minplus(band, plan, d, f, hopf_lax, recip, chunks):
    """The min-plus round over the listed chunks alone, with the twin's
    f32 candidates: per row the least candidate, and the smallest column
    among the least (-1 where none is below MINPLUS_BIG)."""
    m = torch.full((plan.n,), bs.MINPLUS_BIG, dtype=torch.float32)
    arg = torch.full((plan.n,), -1, dtype=torch.int32)
    _, groups = _listed(*chunks)
    for g, cs in enumerate(groups):
        if len(cs) == 0:
            continue
        r0 = g * ROWS
        ws = int(plan.winstart_host[r0 // plan.R])
        local = torch.as_tensor(
            (np.asarray(cs)[:, None] * KC + np.arange(KC)).ravel())
        A = band[r0:r0 + ROWS, local].float()
        col = ws + local
        cand = bs._minplus_cand(A, d[col][None, :], f[col][None, :],
                                hopf_lax, recip)
        mg = torch.amin(cand, dim=1)
        hit = torch.where(cand == mg[:, None], col[None, :].to(torch.int32),
                          bs._NO_ARG)
        m[r0:r0 + ROWS] = mg
        arg[r0:r0 + ROWS] = torch.where(mg < bs.MINPLUS_BIG,
                                        torch.amin(hit, dim=1), -1)
    return m, arg


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("hopf_lax,recip", [(False, False), (True, True)])
def test_the_listed_chunks_minplus_equals_the_twin(rect_case, kind, dtype,
                                                   hopf_lax, recip):
    """Min and argmin over the listed chunks are the dense twin's exactly:
    a skipped chunk holds no candidate."""
    plan, band = _band(rect_case, kind, dtype)
    rs = np.random.RandomState(5)
    d = torch.as_tensor((rs.rand(1024) * 3).astype(np.float32))
    d[torch.as_tensor(rs.rand(1024) < 0.3)] = bs.MINPLUS_BIG
    f = torch.as_tensor((rs.rand(1024) + 0.5).astype(np.float32))
    m, arg = _listed_minplus(band, plan, d, f, hopf_lax, recip,
                             bs.rect_live_chunks(band, plan))
    rm, rarg = bs._rect_minplus_plain(band, plan, d, f, hopf_lax, True,
                                      recip)
    torch.testing.assert_close(m, rm, rtol=0, atol=0)
    torch.testing.assert_close(arg, rarg, rtol=0, atol=0)
    assert bool((m < bs.MINPLUS_BIG).any())


def test_the_wrappers_take_a_list_and_the_cpu_twins_ignore_it(rect_case):
    plan, band = _band(rect_case, "rcm", torch.float32)
    chunks = bs.rect_live_chunks(band, plan)
    X = torch.randn(1024, 2)
    torch.testing.assert_close(bs.band_spmm(band, plan, X, chunks),
                               bs.band_spmm(band, plan, X), rtol=0, atol=0)
    d, f = torch.rand(1024), torch.rand(1024) + 0.5
    for a, b in zip(bs.band_minplus(band, plan, d, f, track_arg=True,
                                    chunks=chunks),
                    bs.band_minplus(band, plan, d, f, track_arg=True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_rect_live_chunks_refuses_what_it_does_not_describe(rect_case):
    plan, band = _band(rect_case, "rcm", torch.float32)
    with pytest.raises(ValueError):              # a band of another width
        bs.rect_live_chunks(band[:, :128].contiguous(), plan)
    odd = bs.RectPlan.from_numpy(np.zeros(4, np.int32), 1024, 256, 32, 96,
                                 10, "cpu")     # W not a multiple of 64
    with pytest.raises(ValueError):
        bs.rect_live_chunks(torch.zeros(1024, 96), odd)


def _bad_lists(chunk_ptr, chunk_col, W):
    """A list broken in each way the launch check refuses."""
    ptr, col = chunk_ptr.clone(), chunk_col.clone()
    group = int((ptr[1:] - ptr[:-1] >= 2).nonzero()[0])
    flipped = col.clone()
    a = int(ptr[group])
    flipped[a], flipped[a + 1] = col[a + 1], col[a]
    wide = col.clone()
    wide[-1] = W // KC
    return {"short_ptr_end": (torch.cat([ptr[:-1], ptr[-1:] - 1]), col),
            "ptr_not_from_0": (ptr + 1, col),
            "col_past_the_window": (ptr, wide),
            "col_negative": (ptr, torch.where(col == col[0], -1, col)),
            "descending_in_a_group": (ptr, flipped),
            "int64": (ptr.long(), col.long()),
            "one_group_short": (ptr[:-1], col)}


@pytest.mark.parametrize("how", ["short_ptr_end", "ptr_not_from_0",
                                 "col_past_the_window", "col_negative",
                                 "descending_in_a_group", "int64",
                                 "one_group_short"])
def test_the_launch_check_refuses_a_broken_list(rect_case, how):
    """K5's and K8's launch check refuses a list that would read out of
    the band or its window, or out of order, and passes the built one."""
    plan, band = _band(rect_case, "rcm", torch.float32)
    chunks = bs.rect_live_chunks(band, plan)
    bs._check_live_chunks("band_spmm", plan, *chunks)
    with pytest.raises(ValueError):
        bs._check_live_chunks("band_spmm", plan,
                              *_bad_lists(*chunks, plan.W)[how])


def test_accel_keeps_a_list_beside_each_band(monkeypatch):
    """``AccelSpMM.live_chunks`` builds a band's list once and keys it by
    the band tensor: the matvec band's list is reused by ``spmm`` and the
    distance rounds, a band built anew gets its own, and the entry goes
    with its band."""
    monkeypatch.setenv("GLT_NO_BAND", "1")
    monkeypatch.setattr(accel, "_RECT_R", 128)
    monkeypatch.setattr(accel, "_RECT_WT", 128)
    W = _knn_csr(900, 10, seed=3)
    acc = accel.AccelSpMM(W, device="cpu", materialize=True)
    assert isinstance(acc.plan, bs.RectPlan)
    X = np.random.RandomState(4).randn(900, 3)
    out = acc.from_perm(acc.spmm(acc.to_perm(torch.as_tensor(X)))).numpy()
    np.testing.assert_allclose(out, W @ X, rtol=1e-10, atol=1e-10)
    band = acc.band()
    chunks = acc.live_chunks(band)
    assert acc.live_chunks(acc.band()) is chunks         # cached by spmm
    for a, b in zip(chunks, bs.rect_live_chunks(band, acc.plan)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    b16 = acc.build_band(torch.bfloat16)
    own = acc.live_chunks(b16)
    assert own is not chunks and acc.live_chunks(b16) is own
    assert _listed(*own)[0] <= _listed(*chunks)[0]
    assert len(acc._chunks) == 2
    del b16, own
    assert len(acc._chunks) == 1


def test_the_rect_route_geometry_admits_the_chunk_kernels():
    """The accel's rectangular geometry meets K5's and K8's launch checks:
    R a multiple of the CTA's rows, W (a multiple of WT) of the chunk, and
    window starts (multiples of WT) of 8."""
    assert accel._RECT_R % ROWS == 0
    assert accel._RECT_WT % KC == 0
    assert accel._RECT_WT % bs._RECT_WIN_ALIGN == 0
