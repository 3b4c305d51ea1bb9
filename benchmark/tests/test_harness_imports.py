"""What the harness and the reference load, and the harness's refusal
without a card."""

import json
import subprocess
import sys

import pytest

from benchmark.lib import manifest as mf

FORBIDDEN = {"jax", "jaxlib", "flax", "graphlearning_tpu"}


def _modules(code):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, cwd=mf.ROOT, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    tops = _modules(
        "import sys; sys.path.insert(0, '.'); sys.argv = ['run.py']\n"
        "import benchmark.run, benchmark.lib.cell, benchmark.lib.program\n"
        "import benchmark.calls.fit, benchmark.calls.trials\n"
        "import benchmark.tools.control, benchmark.tools.sets\n"
        "from benchmark.reference.models import laplace, poisson\n"
        "from benchmark.lib import manifest as mf\n"
        "man = mf.manifest()\n"
        "[mf.reader(m['name']) for m in man['end_to_end'] + "
        "man['per_layer']]")
    assert "graphlearning_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_reference_loads_nothing_of_the_program():
    tops = _modules(
        "import sys; sys.path.insert(0, '.')\n"
        "import benchmark.reference.models.laplace, "
        "benchmark.reference.models.poisson, "
        "benchmark.reference.knn, benchmark.reference.trainsets, "
        "benchmark.reference.generators.ten_clusters, "
        "benchmark.reference.generators.two_moons")
    assert not tops & (FORBIDDEN | {"graphlearning_tpu_torch"})


def test_run_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         mf.manifest()["workloads"][0]["name"], "--seed", "1",
         "--seconds", "1"], capture_output=True, text=True, cwd=mf.ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
