"""One fit a call: ``fit_predict`` of the mix's model on one train set.
Its products go through the operator that ``ops.accel.maybe_build``
returns for the graph (the band or the gather), or the plain ELL where it
returns none."""

import torch

from benchmark.lib import roofline
from benchmark.lib.program import gl, gl_accel, gl_config, plain_product

SCORES = True    # a fit leaves its scores (``prob``) to be judged


def draw(drawer, rs, rate, traffic):
    return drawer.draw(rs, rate)


def sets(draw):
    return [draw]


def call(traffic, W, labels, draw, device):
    m = getattr(gl.ssl, traffic["model"])(W, device=device)
    pred = m.fit_predict(draw, labels[draw])
    return [pred], [int(m.iters)], [m.prob]


def route(W, device):
    return gl_accel.path_name(gl_accel.maybe_build(W, device=device))


def operator(traffic, W, classes, device, gen):
    """The fit's own operator: ``maybe_build``'s cache returns it."""
    dtype = gl_config.float_dtype(device)
    X = torch.randn(W.shape[0], classes, generator=gen, device=device,
                    dtype=dtype)
    acc = gl_accel.maybe_build(W, device=device)
    if acc is None:
        return plain_product(W, device), X, classes
    return acc.spmm, acc.to_perm(X), classes


def least_bytes(n, nnz, classes, iters):
    """Each CG step a product at the classes' width."""
    return sum(iters) * (roofline.w_bytes(n, nnz)
                         + roofline.xy_bytes(n, classes))
