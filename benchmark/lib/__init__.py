"""The harness: finds a cell's configuration, traffic mix, limits and metric
readers by name, sets the cell up, runs its window, reduces the trace and
judges the answers against :mod:`benchmark.reference`."""
