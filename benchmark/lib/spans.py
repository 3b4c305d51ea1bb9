"""Readings of the program's own spans and counters
(``graphlearning_tpu_torch.observability``), for the metric readers.

A span is kept only while a profiler records, so the spans a run holds
are its traced window's: the run is one process (``benchmark/run.py``),
and set-up runs untraced.  Only the trees rooted in the fit API's spans
(``ssl.*``) are read, one a call; the chains of products that other
readers profile after the window open none.  The counters are the
process's since it started.  Each reading is None where the program
kept nothing to read (a program without these spans and counters)."""

from benchmark.lib.program import gl

API = "ssl."
BELOW = ("cg.", "accel.", "graph.", "knn.")   # the layers under the fit API


def calls():
    """``[(root, members)]``: each call's root span and every span of its
    tree (the root included), oldest call first."""
    read = getattr(gl.observability, "spans", None)
    recs = read() if read is not None else []
    roots = [r for r in recs
             if r["parent"] is None and r["name"].startswith(API)]
    members = {r["id"]: [] for r in roots}
    for r in recs:
        if r["root"] in members:
            members[r["root"]].append(r)
    return [(r, members[r["id"]]) for r in roots]


def seconds(rec):
    return (rec["end_ns"] - rec["start_ns"]) * 1e-9


def _outermost_below(root, tree):
    """The spans of ``tree`` in the layers below the fit API that no other
    such span of the tree encloses."""
    by_id = {r["id"]: r for r in tree}
    below = [r for r in tree if r["name"].startswith(BELOW)]
    out = []
    for r in below:
        p = by_id.get(r["parent"])
        while p is not None and p is not root \
                and not p["name"].startswith(BELOW):
            p = by_id.get(p["parent"])
        if p is None or p is root:
            out.append(r)
    return out


def api_self_ms(run):
    """The fit API's own time a call: each root's duration less that of
    its outermost descendants in the layers below, mean over the calls,
    in ms."""
    own = [seconds(root) - sum(seconds(r) for r in
                               _outermost_below(root, tree))
           for root, tree in calls()]
    return 1e3 * sum(own) / len(own) if own else None


def cg_host_ms(run):
    """The host's time issuing a CG step: the solves' time less their
    waits on the card, over their steps, in ms."""
    solve = wait = steps = 0
    for _, tree in calls():
        ids = {r["id"] for r in tree if r["name"] == "cg.solve"}
        for r in tree:
            if r["id"] in ids:
                solve += seconds(r)
                steps += r["attrs"]["steps"]
            elif r["name"] == "cg.wait" and r["parent"] in ids:
                wait += seconds(r)
    return 1e3 * (solve - wait) / steps if steps else None


def host_reads_per_step(run):
    """The calls' device-to-host reads over their CG steps, each counted
    over the root span's life."""
    reads = steps = 0
    for root, _ in calls():
        counts = root.get("counts", {})
        reads += counts.get("host_reads", 0)
        steps += counts.get("cg.steps", 0)
    return reads / steps if steps else None


def counted_s(*names):
    """The seconds the process spent in the spans ``names``, or None where
    none of them ran."""
    c = gl.observability.counters
    if not any(c.get(n) for n in names):
        return None
    return sum(c.get(n + ".s") for n in names)
