"""Run one cell of the benchmark once, in this process, on this machine's
cards:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration, traffic mix, limits and metric readers are
found by name (:mod:`benchmark.lib.manifest`).  The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number compared beside its limit.  The same numbers are
the last lines of standard error.  Without a CUDA card, or with fewer
than the cell asks for, it prints no result and exits with 2; if JAX or
the JAX package is loaded once the window has closed, with 3.

The program's build and kernel caches go to fixed directories under
``.benchmark_cache/`` at the root of the checkout, so that only a cell's
first run in a checkout builds."""

import argparse
import json
import os
import sys
import time
from pathlib import Path

_T_IMPORT = time.perf_counter()
ROOT = Path(__file__).resolve().parents[1]
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton"),
                   ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
    os.environ[_var] = str(ROOT / ".benchmark_cache" / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "graphlearning_tpu")


def process_age():
    """Seconds since this process started (Linux), else since this module
    was imported."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return time.perf_counter() - _T_IMPORT


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def measure(cell, cfg, traffic, limits, entries, seed, seconds, trace,
            device, chips=1, say=None):
    """One run of ``cell`` (a ``workloads`` entry) with its configuration,
    traffic and limits given as dicts and ``entries`` the metrics to
    report.  Returns the result object."""
    import torch

    from benchmark.lib import manifest as mf
    from benchmark.lib.cell import Run

    say = say or (lambda msg: print(msg, file=sys.stderr, flush=True))
    run = Run(cell, cfg, traffic, seed, seconds, trace, device)
    run.setup()
    say(f"set-up done: n={run.n} nnz={run.nnz} route={run.route} "
        f"first_fit_s={run.first_fit_s}")
    run.window(process_age)
    say(f"window: {len(run.calls)} calls, "
        f"{sum(c['answers'] for c in run.calls)} answers in "
        f"{run.window_s} s after {run.setup_s} s of set-up")
    say("calls (end s, mean CG steps): " + ", ".join(
        f"{c['t_end']:.3f} {sum(c['iters']) / len(c['iters']):.1f}"
        for c in run.calls))
    if trace:
        run.reduce_trace()
    metrics = {}
    for m in entries:
        v = mf.reader(m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    run.free_program()
    t = time.perf_counter()
    numbers, failed = run.check(limits)
    say(f"check: {min(len(run.kept), int(traffic['check']['answers']))} "
        f"answers against the reference in {time.perf_counter() - t} s")
    checks = {k: {"value": v, "limit": limits.get(k)}
              for k, v in sorted(numbers.items())}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": chips, "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": bool(numbers) and failed == 0,
              "attempted": sum(c["answers"] for c in run.calls),
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and run.trace_summary is not None:
        dev["busy_s"] = run.trace_summary["busy_s"]
        dev["window_s"] = run.trace_summary["window_s"]
        result["breakdown"] = {
            "device_ops": run.trace_summary["device_ops"],
            "idle_gaps": run.trace_summary["idle_gaps"]}
    result["checks"] = checks
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.lib import manifest as mf

    man = mf.manifest()
    cell = mf.cell(man, args.workload)
    chips = int(cell["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    print(f"card: {power_limit()}", file=sys.stderr, flush=True)
    result = measure(cell, mf.config(man, cell["config"]),
                     mf.traffic(cell["traffic"]), mf.limits(cell["name"]),
                     mf.metrics(man, cell["name"], bool(args.trace)),
                     args.seed, args.seconds, bool(args.trace), device,
                     chips)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded after the window: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
