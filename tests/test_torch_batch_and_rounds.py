"""The mesh's batch axis and the verbose MBO and INCRES fits on spawned gloo
ranks:

* a world of 4 ranks as ``GLTConfig(mesh_shape=(2, 2), mesh_axes=("nodes",
  "batch"))``: its shape is JAX's ``make_mesh(2, 2).shape`` over four CPU
  devices, and each rank's Laplace and Poisson CG fits (tol 1e-10) on both
  routes equal, within 1e-12 of max|u|, the (2,)-mesh fit of a world of 2
  (each batch replica runs that fit on its own node group), and within
  1e-7 of max|u| the one-device fit of the port and the JAX package's
  (two CG solves stopped at their tolerance), the predictions equal;
* ``all_labels`` on a two-rank mesh, both routes: PoissonMBO (T = 5),
  VolumeMBO (temperature 0.1, seed 0) and INCRES (T = 6, seed 0) print
  the rounds and predict what their one-device fits with ``all_labels``
  print and predict.

One spawn: the world of 4 and the world of 2 start at once.  The n = 603
three-cluster graph is ``test_torch_sharded_models``'s (n not a multiple
of 2).
"""

import jax
import numpy as np
import pytest

import graphlearning_tpu as jgl
from graphlearning_tpu import parallel as jpar

import graphlearning_tpu_torch as tgl
from tests import test_torch_ranks as ranks
from tests.test_torch_sharded_models import _clusters

ROUTES = ("gspmd", "banded")
BATCH = ((2, 2), ("nodes", "batch"))
TOL_MESH = 1e-12          # the same fit on a node group of the same size
TOL_ONE = 1e-7            # against one device: CG stopped at 1e-10


@pytest.fixture(scope="module")
def clusters():
    W, labels, ti = _clusters(603, 3, 5, 10, seed=0)
    return W, labels, ti, np.bincount(labels) / len(labels)


@pytest.fixture(scope="module")
def ranked(clusters, tmp_path_factory):
    W, labels, ti, priors = clusters
    fits = {"W": W, "ti": ti, "labels": labels}
    rounds = [(("all_labels", route), ranks.case_all_labels,
               dict(fits, priors=priors, kernel=route)) for route in ROUTES]
    return ranks.run_ranks(
        {4: [("batch", ranks.case_batch_fits, dict(fits, shape=BATCH[0],
                                                    axes=BATCH[1]))],
         2: [("nodes", ranks.case_batch_fits, dict(fits, shape=(2,),
                                                    axes=("nodes",)))]
            + rounds},
        tmp_path_factory.mktemp("p15c"))


def _close(out, ref, tol):
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=tol * np.abs(ref).max())


def test_batch_mesh_shape_is_jax(ranked):
    jshape = dict(jpar.make_mesh(2, 2, devices=jax.devices()[:4]).shape)
    for r, res in enumerate(ranked[4]):
        shape, size, rank = res["batch"]["mesh"]
        assert shape == jshape == {"nodes": 2, "batch": 2}
        # rank r at (r // 2, r % 2): its node index is r // 2
        assert (size, rank) == (2, r // 2)
        assert res["batch"]["make_mesh"] == (jshape, 2, r // 2)
    for r, res in enumerate(ranked[2]):
        assert res["nodes"]["mesh"] == ({"nodes": 2}, 2, r)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", ["laplace", "poisson"])
def test_batch_mesh_fits_equal_node_mesh_and_one_device(ranked, clusters,
                                                        route, name):
    W, labels, ti, _ = clusters
    one = ranks.FITS[name](tgl, W, None)
    u_one = np.asarray(one.fit(ti, labels[ti]))
    jm = (jgl.ssl.laplace(W, tol=1e-10) if name == "laplace"
          else jgl.ssl.poisson(W, tol=1e-10))
    u_jax = np.asarray(jm.fit(ti, labels[ti]))
    u_mesh, pred_mesh, _ = ranked[2][0]["nodes"][route, name]
    for res in ranked[4]:
        u, pred, got_route = res["batch"][route, name]
        assert got_route == route
        _close(u, u_mesh, TOL_MESH)
        _close(u, u_one, TOL_ONE)
        _close(u, u_jax, TOL_ONE)
        np.testing.assert_array_equal(pred, pred_mesh)
        np.testing.assert_array_equal(pred, one.predict())
        np.testing.assert_array_equal(pred, jm.predict())


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", list(ranks.ALL_LABELS_FITS))
def test_all_labels_rounds_on_a_mesh(ranked, clusters, route, name):
    W, labels, ti, priors = clusters
    pred_one, printed_one = ranks.fit_all_labels(tgl, name, W, ti, labels,
                                                 priors)
    assert printed_one.count("\n") >= 5
    for res in ranked[2]:
        pred, printed = res["all_labels", route][name]
        assert printed == printed_one
        np.testing.assert_array_equal(pred, pred_one)
