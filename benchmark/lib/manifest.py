"""Everything a cell is made of, found by name:

* ``BENCHMARK.json`` at the root: the cells, configurations and metrics;
* ``benchmark/configs/<config>.json`` (the path the manifest gives);
* ``benchmark/traffic/<traffic>.json``: the mix, data read by
  :mod:`lib.cell`, whose ``call`` names its shape,
  ``benchmark/calls/<call>.py`` (:mod:`benchmark.calls`);
* ``benchmark/limits/<cell>.json``: the limit of each number compared;
* ``benchmark/metrics/<metric>.py``: each metric's reader, ``read(run)``.

Adding any of them is adding a file; none of these is edited to do so."""

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"


def _json(path):
    with open(path) as f:
        return json.load(f)


def manifest(root=ROOT):
    return _json(Path(root) / "BENCHMARK.json")


def cell(man, name):
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man, name, root=ROOT):
    for c in man["configs"]:
        if c["name"] == name:
            return _json(Path(root) / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name):
    return _json(HERE / "traffic" / f"{name}.json")


def limits(cell_name):
    path = HERE / "limits" / f"{cell_name}.json"
    return _json(path) if path.is_file() else {}


def metrics(man, cell_name, trace):
    """The cell's metric entries: its end-to-end metrics untraced, its
    per-layer metrics traced (an entry without ``workloads`` is every
    cell's)."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in man[key]
            if cell_name in m.get("workloads", [cell_name])]


def reader(name):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
