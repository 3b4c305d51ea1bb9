#!/usr/bin/env python3
"""Which part of the band's eigensolve varies between runs of one tree, on
the card: the two-moons fit input of ``chip_smoke.py`` (n=65536, noise
0.1, k=10, seed 0), its packed f32 band.

    python3 tools/eig_determinism.py [--repeats N]

* the band built twice from two copies of W: the permutations and the
  bands, bit for bit;
* K2 (``band_tiles_spmm_packed``) called ``N`` times on one X at each
  width LOBPCG gives it (d = 1, 4, 12, 13, 39): the distinct results;
* the residual edges (``band_spmm.apply_residual``): their ELL bucket and
  the spill of rows with more residual edges than the bucket holds, and
  ``N`` sums of the spill by ``index_add_``, ``index_put_(...,
  accumulate=True)`` and ``segment_reduce``;
* the whole ``spmm`` ``N`` times;
* ``graph(W).eigen_decomp(normalization="normalized", k=2)`` on the band,
  three times on fresh graphs, and on the plain path twice.

Each count of distinct results is 1 where the step is deterministic.  The
last line is one JSON object with every count.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def distinct(tensors):
    """The number of bitwise-distinct tensors in ``tensors``."""
    seen = []
    for t in tensors:
        if not any(t.shape == s.shape and bool((t == s).all()) for s in seen):
            seen.append(t)
    return len(seen)


def main():
    import torch

    p = argparse.ArgumentParser()
    p.add_argument("--repeats", type=int, default=20)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("eig_determinism: no CUDA device", file=sys.stderr)
        return 1
    import graphlearning_tpu_torch as gl
    from chip_smoke import two_moons
    from graphlearning_tpu_torch.ops import accel
    from graphlearning_tpu_torch.ops import band_spmm as bs

    out = {}
    X, _ = two_moons(65536, 0.1, seed=0)
    W = gl.weightmatrix.knn(X, 10)

    def copy():
        Wc = W.copy()
        Wc._glt_points = W._glt_points
        return Wc

    accs = [accel.maybe_build(copy(), device="cuda") for _ in range(2)]
    acc = accs[0]
    if not isinstance(acc, accel.AccelSpMM):
        raise SystemExit(f"expected the band, got {type(acc).__name__}")
    out["perm_equal"] = bool((accs[0]._perm_dev == accs[1]._perm_dev).all())
    out["band_equal"] = bool((accs[0].band() == accs[1].band()).all())
    if acc._resid is None:
        raise SystemExit("the band has no residual edges")
    urows, rcols, _, sp_r, _, _ = acc._resid
    counts = torch.bincount(sp_r, minlength=acc.n_pad)
    out["residual"] = {"edges": int(acc.n_resid),
                       "ell_rows": int(urows.numel()),
                       "ell_slots": int(rcols.shape[1]),
                       "spill_edges": int(sp_r.numel()),
                       "spill_rows": int((counts > 0).sum()),
                       "spill_max_per_row": int(counts.max())}
    print(f"n_pad {acc.n_pad}, {type(acc.plan).__name__}: {out}", flush=True)

    gen = torch.Generator(device="cuda").manual_seed(0)
    band = acc.band()
    k2 = {}
    for d in (1, 4, 12, 13, 39):
        Xd = torch.randn((acc.n_pad, d), generator=gen, device="cuda")
        k2[d] = distinct([bs.band_tiles_spmm_packed(band, acc.plan, Xd)
                          for _ in range(a.repeats)])
    out["k2_distinct"] = k2

    Xd = torch.randn((acc.n_pad, 12), generator=gen, device="cuda")
    _, _, _, sp_r, sp_c, sp_v = acc._resid
    contrib = sp_v[:, None] * Xd[sp_c]
    zero = torch.zeros((acc.n_pad, 12), device="cuda")
    order_ok = bool((sp_r[1:] >= sp_r[:-1]).all()) if sp_r.numel() else True
    lengths = torch.bincount(sp_r, minlength=acc.n_pad)
    spill = {
        "index_add_": lambda: zero.clone().index_add_(0, sp_r, contrib),
        "index_put_": lambda: zero.clone().index_put_((sp_r,), contrib,
                                                      accumulate=True),
        "segment_reduce": lambda: torch.segment_reduce(
            contrib, "sum", lengths=lengths, axis=0),
    }
    out["spill_sorted_by_row"] = order_ok
    out["spill_distinct"] = {}
    for name, fn in spill.items():
        try:
            out["spill_distinct"][name] = distinct(
                [fn() for _ in range(a.repeats)])
        except Exception as e:                      # noqa: BLE001
            out["spill_distinct"][name] = f"{type(e).__name__}: {e}"
    out["spmm_distinct"] = distinct([acc.spmm(Xd)
                                     for _ in range(a.repeats)])

    def solve():
        G = gl.graph(copy())
        t = time.perf_counter()
        vals, vecs = G.eigen_decomp_device(normalization="normalized", k=2)
        torch.cuda.synchronize()
        path = next(iter(G.eigen_info.values()))["path"]
        print(f"  eigen_decomp(k=2) on {path}: {time.perf_counter() - t:.2f}"
              f" s, {vals.tolist()}", flush=True)
        return torch.cat([vals[None, :], vecs])

    out["band_solve_distinct"] = distinct([solve() for _ in range(3)])
    os.environ["GLT_NO_ACCEL"] = "1"
    out["plain_solve_distinct"] = distinct([solve() for _ in range(2)])
    del os.environ["GLT_NO_ACCEL"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
