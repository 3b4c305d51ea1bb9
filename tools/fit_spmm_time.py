#!/usr/bin/env python3
"""The exact grade's matvec at the fits' shape on the GPU, for comparing
two trees of the port in one call.

    python3 tools/fit_spmm_time.py [--root TREE] [--label NAME]

Imports ``graphlearning_tpu_torch`` from ``TREE`` (default: this
checkout), builds the fit input of ``chip_smoke.py`` (two moons,
n=65536, k=10) and times, in float32, K2 on the packed band at d = 2, 3
and 10, K3 on the unpacked tiles and K5 on the rectangular band's live
chunks at d = 2, each as ``graph_ms`` (20 calls captured in one CUDA
graph, over 20; ``chip_smoke.graph_ms``), the median of five such
readings.  Prints one JSON line with the card's name and power limit.
Needs a CUDA device.
"""

import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("fit_spmm_time: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    sys.path.insert(0, os.path.abspath(args.root))
    import graphlearning_tpu_torch as gl
    from chip_smoke import card_line, graph_ms, two_moons
    from graphlearning_tpu_torch.ops import accel
    from graphlearning_tpu_torch.ops import band_spmm as bs

    assert gl.__file__.startswith(os.path.abspath(args.root)), gl.__file__
    X, _ = two_moons(65536, 0.1, seed=0)
    W = gl.weightmatrix.knn(X, 10)
    packed = accel.AccelSpMM(W, device="cuda")
    tiles = accel.AccelSpMM(W, device="cuda", packed=False)
    os.environ["GLT_NO_BAND"] = "1"
    rect = accel.AccelSpMM(W, device="cuda", materialize=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [("K2", packed, d) for d in (2, 3, 10)]
    cases += [("K3", tiles, 2), ("K5", rect, 2)]
    out = {"label": args.label, "card": card_line()}
    for name, acc, d in cases:
        band, plan = acc.band(), acc.plan
        Xd = torch.randn((acc.n_pad, d), generator=gen, device="cuda")
        if name == "K5":
            chunks = acc.live_chunks(band)
            run = lambda: bs.band_spmm(band, plan, Xd, chunks)
        elif name == "K2":
            run = lambda: bs.band_tiles_spmm_packed(band, plan, Xd)
        else:
            run = lambda: bs.band_tiles_spmm(band, plan, Xd)
        out[f"{name} d={d}"] = float(np.median(
            [graph_ms(torch, run) for _ in range(5)]))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
