"""The control of a cell's check: the plain reference put in the program's
place, computed one precision step below what the configuration states
(its ``precision.control``: TF32 products for float32 with TF32 off), run
to its own stop, and judged by the float64 reference exactly as the
program's answers are.  A limit has to fail it.

    python3 benchmark/tools/control.py --workload <cell> --seeds 1 2 3

For each seed it draws the cell's inputs and the train sets of its first
calls, as a run does, and prints one JSON line: the largest reading of
each number over ``check.answers`` answers, beside the cell's limits,
and the CG steps the control took.
Runs on the card (``--device cpu`` for a small try)."""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def control_numbers(cell, cfg, traffic, seed, device):
    """The control's readings on ``seed``: ``({number: largest reading},
    [the control's CG steps of each answer])``."""
    import numpy as np

    from benchmark.lib.cell import Run, program_eps
    from benchmark.reference import graph as rgraph
    from benchmark.reference.models import load as load_model

    run = Run(cell, cfg, traffic, seed, 0, False, device)
    run.inputs()
    m = int(traffic["check"]["answers"])
    classes = np.unique(run.labels[run.labels >= 0])
    items = []
    c = 0
    while len(items) < m:
        for ti in run.shape.sets(run.draw(c))[:m - len(items)]:
            ti = np.asarray(ti)
            items.append({"train_ind": ti, "train_labels": run.labels[ti],
                          "classes": classes})
        c += 1
    W = rgraph.weight_matrix(*run.knn, run.k)
    mod = load_model(traffic["model"])
    settings = {**mod.DEFAULTS, "eps": program_eps(device)}
    low = rgraph.Arith(W, cfg["precision"]["control"], device)
    answers = mod.answers(low, items, settings)
    del low
    if not run.shape.SCORES:
        for a in answers:
            a.pop("scores", None)
    ref = rgraph.Arith(W, "float64", device)
    out = {}
    for r in mod.judge(ref, answers, settings):
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out, [int(a["iters"]) for a in answers]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    import torch

    from benchmark.lib import manifest as mf

    man = mf.manifest()
    cell = mf.cell(man, args.workload)
    cfg = mf.config(man, cell["config"])
    traffic = mf.traffic(cell["traffic"])
    limits = mf.limits(cell["name"])
    for seed in args.seeds:
        t = time.perf_counter()
        nums, iters = control_numbers(cell, cfg, traffic, seed,
                                      torch.device(args.device))
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control": cfg["precision"]["control"],
                          "numbers": nums, "limits": limits,
                          "control_iters": iters,
                          "seconds": time.perf_counter() - t}), flush=True)


if __name__ == "__main__":
    main()
