"""A sweep of trials a call, as ``ssl_trials`` makes one: the mix's
``trials`` train sets of one label rate, solved together by
``fit_predict_batched``, which groups them by ``ssl._batch_groups`` and
runs each group's products on the plain ELL at the group's width."""

import numpy as np
import torch

from benchmark.lib import roofline
from benchmark.lib.program import gl, gl_config, gl_ssl, plain_product

SCORES = False   # the batched fit returns labels alone


def draw(drawer, rs, rate, traffic):
    return [drawer.draw(rs, rate) for _ in range(traffic["trials"])]


def sets(draw):
    return draw


def call(traffic, W, labels, draw, device):
    m = getattr(gl.ssl, traffic["model"])(W, device=device)
    preds = m.fit_predict_batched(draw, labels)
    return preds, list(np.asarray(m.iters)), [None] * len(preds)


def route(W, device):
    return "plain ELL"


def operator(traffic, W, classes, device, gen):
    """The plain ELL product at one trial group's width."""
    dtype = gl_config.float_dtype(device)
    g = gl.graph(W, device=device).sparse
    d = classes * len(gl_ssl._batch_groups(int(traffic["trials"]), g,
                                           classes, dtype)[0])
    X = torch.randn(W.shape[0], d, generator=gen, device=device, dtype=dtype)
    return plain_product(W, device), X, d


def least_bytes(n, nnz, classes, iters):
    """The call's trials reading ``W`` once a step between them, as one
    product over all their columns would, and each trial's columns once a
    step of its own."""
    steps = [int(i) for i in iters]
    return (max(steps) * roofline.w_bytes(n, nnz)
            + sum(steps) * roofline.xy_bytes(n, classes))
