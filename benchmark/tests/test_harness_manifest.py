"""BENCHMARK.json holds to the benchmark's contract, and each of its names
finds its file."""

import json
import re

import pytest

from benchmark import calls
from benchmark.lib import manifest as mf

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def man():
    return mf.manifest()


def test_manifest_keys_and_limits(man):
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"]
    assert man["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= man["run_seconds"] <= 51
    assert (mf.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    for m in man["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in man["end_to_end"])


def test_names_units_and_unique(man):
    groups = [man["configs"], man["workloads"],
              man["end_to_end"] + man["per_layer"]]
    for g in groups:
        names = [x["name"] for x in g]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  mf.manifest()["workloads"]])
def test_cell_files_found_by_name(man, cell):
    w = mf.cell(man, cell)
    assert w["chips"] == 1 and len(w["why"]) <= 200
    cfg = mf.config(man, w["config"])
    assert cfg["name"] == w["config"]
    tf = mf.traffic(w["traffic"])
    shape = calls.load(tf["call"])
    for fn in ("draw", "sets", "call", "route", "operator", "least_bytes"):
        assert callable(getattr(shape, fn))
    assert mf.limits(cell), "every cell has its limits file"
    e2e = {m["name"] for m in mf.metrics(man, cell, False)}
    layer = mf.metrics(man, cell, True)
    assert "setup_s" in e2e and len(e2e) >= 2 and layer
    for m in layer:
        assert m["moves"] in e2e
        assert callable(mf.reader(m["name"]).read)
    for name in e2e:
        assert callable(mf.reader(name).read)


def test_configs_state_their_cut(man):
    for c in man["configs"]:
        cfg = json.loads((mf.ROOT / c["file"]).read_text())
        assert c["file"].startswith("benchmark/")
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["assumed"] and isinstance(cfg["points"]["seed"], int)
        # float32 with TF32 off: the step below is TF32
        assert cfg["precision"]["control"] == "tf32"
