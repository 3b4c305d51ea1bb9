"""graph_build_s: the seconds of set-up in the program's graph builds:
``weightmatrix.knn`` (the weights and the host symmetrisation, span
``knn.build``) and the device ELL from scipy (span ``graph.ell``), from
the program's counters (lib.spans.counted_s)."""

from benchmark.lib.spans import counted_s


def read(run):
    return counted_s("knn.build", "graph.ell")
