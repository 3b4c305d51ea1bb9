"""Call shapes, one module each, found by the name a traffic mix's
``call`` gives.  A shape says what one call of the window is and what its
products cost; a mix of an existing shape is a data file alone.  Each
module has:

* ``SCORES``: whether a call returns each answer's scores;
* ``draw(drawer, rs, rate, traffic)``: a call's input, drawn from ``rs``;
* ``sets(draw)``: the train sets of that input, one an answer;
* ``call(traffic, W, labels, draw, device)``: one call of the program,
  ``(labels, iters, scores)``, each a list with one entry an answer;
* ``route(W, device)``: the name of the path its products go through;
* ``operator(traffic, W, classes, device, gen)``: ``(product, X, d)``,
  the product the calls ran, at their width ``d``, and an input for it;
* ``least_bytes(n, nnz, classes, iters)``: the least bytes that one
  call's products move, given each answer's CG steps."""

import importlib


def load(name):
    return importlib.import_module(f"benchmark.calls.{name}")
