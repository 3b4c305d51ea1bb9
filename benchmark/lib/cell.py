"""One run of one cell: set-up, the measured window, the per-layer
readings and the check of the answers.

Set-up makes the points and labels (the configuration's generator, from
its own ``points.seed``: a fixed data set), their exact kNN data, the
weight matrix the program builds from it, and one throwaway call of the
mix's own shape.  The window runs whole calls, closed loop, one caller,
until ``seconds`` have passed; the last call ends after that.  Call ``c``
draws its train sets from its own stream of the seed as it starts, at the
mix's ``c``-th rate after the first, which is drawn from the seed.  What
a call is, and what its products cost, is its shape's
(:mod:`benchmark.calls`, by the mix's ``call``).  A traced run profiles
the window's first whole calls until ``TRACE_S`` have passed.  After the
window the program is freed and a sample of the answers, drawn from the
seed, is solved again by the plain reference."""

import gc
import time

import numpy as np
import torch

from benchmark import calls
from benchmark.lib import program
from benchmark.lib import trace as tr
from benchmark.reference import graph as rgraph
from benchmark.reference import knn as rknn
from benchmark.reference.generators import load as load_generator
from benchmark.reference.models import load as load_model
from benchmark.reference.trainsets import Drawer


def stream(seed, *path):
    """A 32-bit seed of the sub-stream ``path`` of ``seed`` (any integer)."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), *path])
    return int(ss.generate_state(1)[0])


def rng(seed, *path):
    return np.random.RandomState(stream(seed, *path))


def program_eps(device):
    """The machine epsilon of the program's working precision on
    ``device``: float32 on the card, float64 on the CPU."""
    return float(np.finfo(np.float32 if device.type == "cuda"
                          else np.float64).eps)


_POINTS, _CALLS, _WARM, _KEEP, _CHECK, _OPERATOR = range(6)

TRACE_S = 1.0    # the least seconds of whole calls a traced run profiles


class Run:
    """What one run measured, for the metric readers."""

    def __init__(self, cell, cfg, traffic, seed, seconds, trace, device):
        self.cell, self.config, self.traffic = cell, cfg, traffic
        self.shape = calls.load(traffic["call"])
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = device
        self.calls = []          # per call: t_end, answers, CG steps
        self.trace_summary = None
        self.setup_s = self.first_fit_s = self.window_s = None
        self.route = None
        self.nnz = self.n = None

    # -- set-up ------------------------------------------------------------

    def inputs(self):
        """The points, labels and kNN data of the seed, and ``self.draw(c)``,
        call ``c``'s train sets."""
        cfg, tf = self.config, self.traffic
        pts_cfg = dict(cfg["points"])
        gen = load_generator(pts_cfg.pop("generator"))
        n, seed = pts_cfg.pop("n"), pts_cfg.pop("seed")
        self.points, labels = gen.points(n, seed, **pts_cfg)
        self.k = int(cfg["k"])
        if cfg["knn"] == "kdtree":
            self.knn = rknn.kdtree(self.points, self.k)
        else:
            self.knn = rknn.brute(self.points, self.k, self.device)
        self.labels = np.asarray(labels)
        drawer = Drawer(self.labels)
        rates = tf["rates"]
        start = rng(self.seed, _CALLS).randint(len(rates))

        def draw(rs, c):
            return self.shape.draw(drawer, rs,
                                   rates[(start + c) % len(rates)], tf)

        self.draw = lambda c: draw(rng(self.seed, _CALLS, c), c)
        self.draw_warm = lambda: draw(rng(self.seed, _WARM), 0)

    def setup(self):
        """:meth:`inputs`, the program's weight matrix, and the throwaway
        call (``first_fit_s``)."""
        dev = self.device
        self.inputs()
        self.W = program.weight_matrix(self.points, self.k, self.knn, dev)
        self.n, self.nnz = self.W.shape[0], int(self.W.nnz)
        t = time.perf_counter()
        self._call(self.draw_warm())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.first_fit_s = time.perf_counter() - t
        self.route = self.shape.route(self.W, dev)

    def _call(self, draw):
        return self.shape.call(self.traffic, self.W, self.labels, draw,
                               self.device)

    # -- the window --------------------------------------------------------

    def window(self, clock):
        """``clock()``: seconds since the process started, read as the
        window opens (``setup_s``)."""
        tf, dev = self.traffic, self.device
        keep = tf["check"]["keep_per_call"]
        pick = rng(self.seed, _KEEP)
        self.kept = []
        prof = span = None
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            span = torch.profiler.record_function(tr.WINDOW)
            span.__enter__()
        self.setup_s = clock()
        t0 = time.perf_counter()
        c = 0
        while True:
            draw = self.draw(c)
            preds, iters, scores = self._call(draw)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t = time.perf_counter()
            sets = self.shape.sets(draw)
            self.calls.append({"t_end": t - t0, "answers": len(preds),
                               "iters": iters})
            chosen = pick.choice(len(preds), min(keep, len(preds)),
                                 replace=False)
            for j in sorted(chosen):
                ti = np.asarray(sets[j])
                self.kept.append({
                    "train_ind": ti, "train_labels": self.labels[ti],
                    "labels": np.asarray(preds[j]),
                    "scores": scores[j],
                    "classes": np.unique(self.labels[self.labels >= 0])})
            del preds, scores
            c += 1
            if prof is not None and (t - t0 >= TRACE_S
                                     or t - t0 >= self.seconds):
                span.__exit__(None, None, None)
                prof.stop()
                self._prof, prof = prof, None
            if t - t0 >= self.seconds:
                break
        self.window_s = self.calls[-1]["t_end"]
        self.memory_peak_bytes = (torch.cuda.max_memory_allocated(dev)
                                  if dev.type == "cuda" else 0)

    def reduce_trace(self):
        prof = getattr(self, "_prof", None)
        if prof is not None:
            self.trace_summary = tr.summarize(tr.events(prof))
            self._prof = None

    def operator(self):
        """The product the calls ran, at their width, and an input for it
        drawn from the seed (the shape's ``operator``)."""
        classes = len(np.unique(self.labels[self.labels >= 0]))
        gen = torch.Generator(device=self.device).manual_seed(
            stream(self.seed, _OPERATOR))
        return self.shape.operator(self.traffic, self.W, classes,
                                   self.device, gen)

    # -- the check ---------------------------------------------------------

    def free_program(self):
        """Drop the program's graph, operators and models (their caches
        ride on ``W``) before the reference runs."""
        self.W = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, limits):
        """``(numbers, failed)``: each number's largest reading over the
        sampled answers, and how many answers read over a limit."""
        tf = self.traffic
        m = min(int(tf["check"]["answers"]), len(self.kept))
        idx = sorted(rng(self.seed, _CHECK).choice(len(self.kept), m,
                                                   replace=False))
        sample = [self.kept[i] for i in idx]
        ar = rgraph.Arith(rgraph.weight_matrix(*self.knn, self.k), "float64",
                          self.device)
        mod = load_model(tf["model"])
        settings = {**mod.DEFAULTS, "eps": program_eps(self.device)}
        readings = mod.judge(ar, sample, settings)
        numbers = {}
        failed = 0
        for r in readings:
            bad = False
            for name, v in r.items():
                numbers[name] = max(numbers.get(name, v), v)
                bad |= not (name in limits and v <= limits[name])
            failed += bad
        return numbers, failed
