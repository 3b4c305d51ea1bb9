#!/usr/bin/env python3
"""The signed error of the exact-grade band products on the GPU.

    python3 tools/exact_grade_bias.py

Builds the fit input of ``chip_smoke.py`` (two moons, n=65536, noise 0.1,
k=10, 5 labels per class, seed 0), its packed band (K2) and its
rectangular band (K5, ``GLT_NO_BAND=1``, ``materialize=True``), and
multiplies each f32 band by the harmonic solution (scipy's f64 masked
Laplace solve, smooth and positive) in float32.  For each kernel and its
f32 twin it prints the mean, the median and the largest relative error
against the f64 product, and the share of outputs below it: an unbiased
sum has a mean near 0 and a share near 0.5.  Needs a CUDA device.
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def signed(label, out, ref):
    live = ref.abs() > 1e-3
    rel = (out.double() - ref)[live] / ref[live]
    print(f"  {label:10s} mean {float(rel.mean()):+.3e}, median "
          f"{float(rel.median()):+.3e}, max|.| {float(rel.abs().max()):.3e},"
          f" below {float((rel < 0).double().mean()):.3f} of "
          f"{int(live.sum())}", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        print("exact_grade_bias: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    import graphlearning_tpu_torch as gl
    from chip_smoke import harmonic_reference, two_moons
    from graphlearning_tpu_torch.ops import accel
    from graphlearning_tpu_torch.ops import band_spmm as bs

    X, labels = two_moons(65536, 0.1, seed=0)
    W = gl.weightmatrix.knn(X, 10)
    ti = gl.trainsets.generate(labels, rate=5, seed=0)
    mask = np.zeros(W.shape[0], bool)
    mask[ti] = True
    bdy = np.zeros((W.shape[0], 2))
    bdy[ti] = np.eye(2)[labels[ti]]
    u = torch.as_tensor(harmonic_reference(W, mask, bdy),
                        dtype=torch.float32, device="cuda")
    packed = accel.AccelSpMM(W, device="cuda")
    os.environ["GLT_NO_BAND"] = "1"
    rect = accel.AccelSpMM(W, device="cuda", materialize=True)
    for acc, name in ((packed, "K2"), (rect, "K5")):
        band, plan = acc.band(), acc.plan
        Xp = acc.to_perm(u).contiguous()
        if name == "K5":
            out = bs.band_spmm(band, plan, Xp, acc.live_chunks(band))
            twin = bs._rect_spmm_plain(band, plan, Xp)
            ref = bs._rect_spmm_plain(band.double(), plan, Xp.double())
        else:
            out = bs.band_tiles_spmm_packed(band, plan, Xp)
            twin = bs._tiles_spmm_plain(band, plan, Xp)
            ref = bs._tiles_spmm_plain(band.double(), plan, Xp.double())
        print(f"== {name}, f32 band times the harmonic solution", flush=True)
        signed(name, out, ref)
        signed("f32 twin", twin, ref)
    return 0


if __name__ == "__main__":
    sys.exit(main())
