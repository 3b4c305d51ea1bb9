"""Run one cell several times, each run a fresh process of
``benchmark/run.py``, and report each run and the spread of each metric.

    python3 benchmark/tools/sets.py --workload <cell> --seconds 51 \\
        --seeds 11 12 13 14 15 16 --trace 0 [--out chiprun_out/name.jsonl]

Each run's result line (or its error's end) goes to ``--out`` as one JSON
line with its seed.  For each metric the summary gives the median and the
spread: the distance between the first and third quartiles, as
``statistics.quantiles(values, n=4)`` gives them, as a share of the
median."""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    rows = []
    out = open(args.out, "a") if args.out else None
    for seed in args.seeds:
        t = time.perf_counter()
        p = subprocess.run(
            [sys.executable, str(ROOT / "benchmark" / "run.py"),
             "--workload", args.workload, "--seed", str(seed),
             "--seconds", str(args.seconds), "--trace", str(args.trace)],
            capture_output=True, text=True, cwd=ROOT)
        row = {"workload": args.workload, "seed": seed, "trace": args.trace,
               "rc": p.returncode, "wall_s": time.perf_counter() - t}
        lines = p.stdout.strip().splitlines()
        try:
            row["result"] = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            row["stdout_tail"] = p.stdout[-2000:]
        row["stderr_tail"] = p.stderr[-3000:]
        rows.append(row)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()
        res = row.get("result", {})
        print(json.dumps({
            "seed": seed, "rc": p.returncode,
            "wall_s": round(row["wall_s"], 1),
            "correct": res.get("correct"),
            "metrics": {k: v["value"] for k, v in
                        res.get("metrics", {}).items()},
            "checks": {k: v["value"] for k, v in
                       res.get("checks", {}).items()}}), flush=True)
        if p.returncode != 0:
            print(p.stderr[-3000:], flush=True)
    names = sorted({k for r in rows for k in r.get("result", {})
                    .get("metrics", {})})
    for k in names:
        vals = [r["result"]["metrics"][k]["value"] for r in rows
                if k in r.get("result", {}).get("metrics", {})]
        print(json.dumps({"metric": k, "n": len(vals),
                          "median": statistics.median(vals),
                          "spread": spread(vals)}), flush=True)
    if out:
        out.close()


if __name__ == "__main__":
    main()
