"""The frozen copies match what they were copied from, and each mix's call
on the program agrees with the plain reference at a tiny size on the CPU
(the program called directly, not through the measurement path)."""

import numpy as np
import pytest
import torch
from conftest import CELLS, tiny

from benchmark.lib import program
from benchmark.lib.cell import Run, program_eps
from benchmark.reference import compare, graph, knn, trainsets
from benchmark.reference.generators import ten_clusters, two_moons
from benchmark.reference.models import load as load_model

CPU = torch.device("cpu")


def test_ten_clusters_is_the_bench_generator():
    from graphlearning_tpu_torch import bench

    a, la = ten_clusters.points(500, 0)
    b, lb = bench.ten_cluster_points(500)
    assert np.array_equal(a, b) and np.array_equal(la, lb)


def test_two_moons_is_the_smoke_generator():
    import chip_smoke

    a, la = two_moons.points(501, 3, noise=0.1)
    b, lb = chip_smoke.two_moons(501, 0.1, 3)
    assert np.array_equal(a, b) and np.array_equal(la, lb)


def test_draw_is_trainsets_generate():
    from graphlearning_tpu_torch import trainsets as gl_trainsets

    labels = np.random.RandomState(1).randint(0, 4, 300)
    for rate in (1, 3):
        ours = trainsets.Drawer(labels).draw(np.random.RandomState(9), rate)
        theirs = gl_trainsets.generate(labels, rate=rate, seed=9)
        assert np.array_equal(ours, theirs)


@pytest.mark.parametrize("gen", ["brute", "kdtree"])
def test_weight_matrix_is_the_programs(gen):
    pts = (ten_clusters.points(400, 2)[0] if gen == "brute"
           else two_moons.points(400, 2)[0])
    ind, dist = (knn.brute(pts, 10, CPU) if gen == "brute"
                 else knn.kdtree(pts, 10))
    assert np.array_equal(ind[:, 0], np.arange(400))
    assert np.all(dist[:, 0] == 0) and np.all(np.diff(dist, axis=1) >= 0)
    ours = graph.weight_matrix(ind, dist, 10)
    theirs = program.weight_matrix(pts, 10, (ind, dist), CPU)
    assert ours.nnz == theirs.nnz
    assert abs(ours - theirs).max() < 1e-12


def test_brute_and_kdtree_find_the_same_neighbours():
    pts = ten_clusters.points(300, 4, dim=3)[0]
    a, da = knn.brute(pts, 10, CPU)
    b, db = knn.kdtree(pts, 10)
    assert np.allclose(da, db, atol=1e-10)
    assert np.mean(a == b) > 0.99


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.0],
                     dtype=torch.float32)
    y = graph.round_tf32(x)
    assert y.tolist() == [1.0, 1.0 + 2**-10, 1.0 + 2**-10, -3.0]


@pytest.mark.parametrize("name", CELLS)
def test_mix_agrees_with_reference(name):
    cell, cfg, tf = tiny(name)
    run = Run(cell, cfg, tf, 20201, 0, False, CPU)
    run.inputs()
    W = program.weight_matrix(run.points, run.k, run.knn, CPU)
    draw = run.draw(0)
    preds, iters, scores = run.shape.call(tf, W, run.labels, draw, CPU)
    sets = run.shape.sets(draw)
    assert len(preds) == len(iters) == len(sets)
    assert all(i > 0 for i in iters)
    answers = [{"train_ind": np.asarray(t), "train_labels": run.labels[t],
                "labels": p, "scores": s}
               for t, p, s in zip(sets, preds, scores)]
    mod = load_model(tf["model"])
    ar = graph.Arith(graph.weight_matrix(*run.knn, run.k), "float64", CPU)
    settings = {**mod.DEFAULTS, "eps": program_eps(CPU)}
    for nums in mod.judge(ar, answers, settings):
        for k, v in nums.items():
            assert v <= (1e-5 if k == "score_err" else 0.0), (k, v)


def test_label_gap_reads_a_wrong_label_by_its_margin():
    u = torch.tensor([[1.0, 0.0], [0.4, 0.6], [0.5, 0.5]],
                     dtype=torch.float64)
    assert compare.label_gap([u], [0, 1, 1]) == 0.0
    assert compare.label_gap([u], [0, 0, 1]) == pytest.approx(0.2)
    assert compare.label_gap([u, u * 0 + 1], [1, 0, 0]) == 0.0
