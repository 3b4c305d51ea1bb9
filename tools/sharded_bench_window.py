#!/usr/bin/env python3
"""Where the sharded bench's time window goes, on one card.

    python3 tools/sharded_bench_window.py [--n 65536] [--device cuda]

Part 1, in this process: the ``gspmd`` route at P=1 (the bench's graph,
n=65536, k=10, d=64) timed product by product, with a device synchronize
after each, as the bench timed it before its window: one warm product,
then 20. It runs three times after 5 s of an idle card, then once with
no pause. Beside each run: the card's SM clock read by ``nvidia-smi``
just before its warm product and just after its last, and the segments
the caching allocator reserved during the 20 timed products.

Part 2: ``bench.sharded_bench`` on each route twice, at its defaults
(warm chain, then chains of 20 products until a second has passed):
each line's edges/s and its chains' ms, the warm one first.

Prints one line a run; ``--device cpu`` runs it on the CPU at a small
``--n`` to check the script.
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def sm_clock():
    """The card's SM clock, MHz, as ``nvidia-smi`` reads it (None on a
    machine without it)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
        return out.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return None


def segments(torch, dev):
    if dev.type != "cuda":
        return 0
    return torch.cuda.memory_stats(dev).get("segment.all.allocated", 0)


def products(torch, bench, fn, X, dev, iters, pause):
    """One run of part 1: ``pause`` seconds idle, one warm product, then
    ``iters`` products each closed by a synchronize."""
    time.sleep(pause)
    clock0 = sm_clock()
    fn(X)
    bench._sync(dev)
    seg0 = segments(torch, dev)
    ms = []
    Y = X
    for _ in range(iters):
        t0 = time.perf_counter()
        Y = fn(Y)
        bench._sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"pause_s": pause, "sm_clock_before": clock0,
            "sm_clock_after": sm_clock(), "ms": [round(t, 4) for t in ms],
            "total_ms": round(sum(ms), 4),
            "segments_added": segments(torch, dev) - seg0}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch

    from graphlearning_tpu_torch import bench, config
    from graphlearning_tpu_torch.parallel.mesh import Mesh

    dev = config.device(args.device)
    config.set_device(dev)
    cfg = bench.settings(mode="sharded", n=args.n)
    if dev.type == "cuda":
        from graphlearning_tpu_torch.ops import _build

        _build.build()
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    rs = np.random.RandomState(0)
    W = bench.bench_graph_2d(cfg["n"], cfg["k"], rs)
    X_np = rs.randn(cfg["n"], cfg["d"]).astype(np.float32)
    mesh = Mesh(None, 1, 0, dev, ("nodes", "batch"), sizes=(1, 1))
    fn, X, _ = bench._sharded_operator("gspmd", W, X_np, mesh, dev)
    for pause in (5.0, 5.0, 5.0, 0.0):
        run = products(torch, bench, fn, X, dev, cfg["iters"], pause)
        run["edges_per_sec"] = round(
            W.nnz * cfg["iters"] / (run["total_ms"] / 1e3), 1)
        print(json.dumps({"part": 1, **run}), flush=True)
    del fn, X
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for rep in range(2):
        for kernel in bench.SHARDED_KERNELS:
            line = bench.sharded_bench(
                dict(cfg, sharded_kernel=kernel, devices=1), dev)
            c = line["config"]
            print(json.dumps({"part": 2, "rep": rep, "kernel": kernel,
                              "edges_per_sec": c["edges_per_sec"]["1"],
                              "chains_timed": c["chains_timed"]["1"],
                              "chain_ms": c["chain_ms"]["1"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
