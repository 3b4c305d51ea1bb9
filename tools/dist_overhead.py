#!/usr/bin/env python3
"""Where a sharded fit's time goes at world size 1, on the card.

    python3 tools/dist_overhead.py

On the smoke's fit input (two moons, n=65536, k=10, 5 labels a class) it
times a Laplace fit on the plain path (``GLT_NO_ACCEL=1``), then through
``distribute`` on the banded route (K3 over the halo) and on the ELL route,
each without a process group (the mesh's collectives are the identity)
and in a one-rank NCCL group; one sharded product (``ShardedOp.spmm_``)
and one NCCL all-reduce of a CG scalar with its ``float()``, by CUDA
events; and the busiest kernels of one banded fit in the group under
``torch.profiler``.  Prints seconds, ms an iteration and the profile.
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def _device_us(evt):
    """Self GPU time of a profiler event, in microseconds."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, name, None)
        if value is not None:
            return value
    return 0.0


def main():
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    import graphlearning_tpu_torch as gl
    from graphlearning_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("dist_overhead: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    _build.build()
    X, labels = cs.two_moons(65536, 0.1, seed=0)
    W = gl.weightmatrix.knn(X, 10)
    ti = gl.trainsets.generate(labels, rate=5, seed=0)

    def fit(label, make):
        m = make()
        m.fit_predict(ti, labels[ti])          # the operator's build
        torch.cuda.synchronize()
        t = time.perf_counter()
        m.fit_predict(ti, labels[ti])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t
        print(f"{label}: {secs:.3f} s, {m.iters} iterations, "
              f"{secs / m.iters * 1e3:.4f} ms an iteration", flush=True)
        return m

    with cs.env("GLT_NO_ACCEL", "1"):
        fit("plain", lambda: gl.ssl.laplace(W))
    routes = ("banded", "gspmd")
    for route in routes:
        fit(f"{route}, no group", lambda: gl.ssl.laplace(W).distribute(
            gl.GLTConfig(sharded_kernel=route)))
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                rank=0, world_size=1)
        try:
            for route in routes:
                m = fit(f"{route}, NCCL group", lambda: gl.ssl.laplace(
                    W).distribute(gl.GLTConfig(sharded_kernel=route)))
                op = m._dist.last_op
                Xd = torch.randn((op.n, 2), device="cuda")
                ms = cs.time_ms(torch, lambda: op.spmm_(Xd))
                print(f"  {route} product, d=2: {ms:.4f} ms (chain "
                      f"{cs.chain_ms(torch, lambda: op.spmm_(Xd)):.4f})",
                      flush=True)
            mesh = m._dist.mesh
            s = torch.ones(2, device="cuda")
            ms = cs.time_ms(torch, lambda: float(mesh.all_reduce(s).sum()))
            print(f"  all_reduce of 2 values + float(): {ms:.4f} ms",
                  flush=True)
            m = gl.ssl.laplace(W).distribute(
                gl.GLTConfig(sharded_kernel="banded"))
            m.fit_predict(ti, labels[ti])
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                t = time.perf_counter()
                m.fit_predict(ti, labels[ti])
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            events = prof.key_averages()
            kernels = [e for e in events
                       if str(e.device_type).endswith("CUDA")]
            busy = sum(_device_us(e) for e in kernels) * 1e-6
            print(f"  profiled banded fit: {wall:.3f} s, GPU kernel time "
                  f"{busy:.3f} s", flush=True)
            for e in sorted(kernels, key=_device_us, reverse=True)[:10]:
                print(f"  {_device_us(e) * 1e-3:9.2f} ms GPU  {e.count:6d} x "
                      f" {e.key[:80]}", flush=True)
            print(events.table(sort_by="self_cpu_time_total", row_limit=15),
                  flush=True)
        finally:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
