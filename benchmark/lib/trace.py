"""Reduction of a ``torch.profiler`` trace to the device's busy time, its
idle gaps and its busiest operations.

The busy time is the union of the intervals in which a kernel, copy or
set runs on the card (not a sum of kernel times, which counts overlapping
streams twice; not the host spans that the profiler mirrors on the
device's timeline), clipped to the traced window: the span that the harness
opens around the traced calls (``WINDOW``).  Each idle gap is labelled by
the innermost host operation running at its middle, or as the host
between operations (in Python) where none runs."""

import heapq
from collections import defaultdict

WINDOW = "benchmark.traced_window"


def _t(ev, what):
    """Seconds of a kineto event's start or duration, in whichever unit
    this torch offers."""
    for unit, scale in (("ns", 1e-9), ("us", 1e-6)):
        fn = getattr(ev, f"{what}_{unit}", None)
        if fn is not None:
            return fn() * scale
    raise AttributeError(f"kineto event has no {what}")


def events(prof):
    """``[(name, on_device, start_s, end_s)]`` of a finished profiler."""
    from torch.autograd import DeviceType

    out = []
    for ev in prof.profiler.kineto_results.events():
        s = _t(ev, "start")
        out.append((ev.name(), ev.device_type() == DeviceType.CUDA, s,
                    s + _t(ev, "duration")))
    return out


def summarize(evs, top=10):
    """``{"busy_s", "window_s", "device_ops", "idle_gaps"}`` of the events
    inside the ``WINDOW`` span, or None when the trace holds no such span
    or no device event."""
    win = [(s, e) for name, dev, s, e in evs if not dev and name == WINDOW]
    if not win:
        return None
    t0, t1 = win[0]
    # a host span (record_function) is mirrored on the device's timeline
    # as an annotation under its own name; it is no device work
    spans = {name for name, d, s, e in evs if not d}
    dev = sorted((max(s, t0), min(e, t1), name)
                 for name, d, s, e in evs
                 if d and name not in spans and e > t0 and s < t1)
    if not dev:
        return None
    busy, gaps, by_op = 0.0, [], defaultdict(float)
    cur_s, cur_e = t0, t0
    for s, e, name in dev:
        by_op[name] += e - s
        if s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s = s
        cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    if t1 > cur_e:
        gaps.append((cur_e, t1))
    host = sorted((s, e, name) for name, d, s, e in evs
                  if not d and name != WINDOW and e > t0 and s < t1)
    idle = defaultdict(float)
    heap, j = [], 0
    for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(heap, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while heap and heap[0][1] < mid:
            heapq.heappop(heap)
        idle[heap[0][2] if heap else "(host between operations)"] += b - a
    order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": busy, "window_s": t1 - t0,
            "device_ops": [[k, v] for k, v in order(by_op)],
            "idle_gaps": [[k, v] for k, v in order(idle)]}
