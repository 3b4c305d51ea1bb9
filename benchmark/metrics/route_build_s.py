"""route_build_s: the seconds of set-up in ``ops.accel.maybe_build``'s
choice and build of the route (the band-hostility test, the band's plan
and device build, or the gather; span ``accel.build``), from the
program's counters (lib.spans.counted_s).  None where no route was built
(off CUDA)."""

from benchmark.lib.spans import counted_s


def read(run):
    return counted_s("accel.build")
