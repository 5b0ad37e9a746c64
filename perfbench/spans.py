"""Device time by the program's spans in a traced training window, read
from the marker kernels the program launches at each span's open and
close (``nvsf_span_open_<span>`` / ``nvsf_span_close_<span>``, a dot of the
span's name spelt ``_``). Written apart from the program's own reduction,
so that no change to the program moves what these readers count."""

from __future__ import annotations

import bisect
import re

from perfbench.trace import union

MARK = re.compile(r"nvsf_span_(open|close)_([a-z_]+)")


def walk(ops):
    """(spans open, us) of each device op, in start order; a marker is
    charged inside its own span."""
    stack = []
    for name, _, dur in sorted(ops, key=lambda o: o[1]):
        m = MARK.search(name)
        span = m.group(2).replace("_", ".") if m else None
        if m and m.group(1) == "open":
            stack.append(span)
        yield tuple(stack), dur
        if m and m.group(1) == "close" and span in stack:
            del stack[len(stack) - 1 - stack[::-1].index(span):]


def _window(run):
    w = run.trace_data
    # the LiDAR frame render's graphs replay the field's markers; no metric
    # of that entry reads spans, so its window stays unread
    if run.mix["entry"] == "render_lidar" or w is None \
            or not run.work["count"] \
            or not any(MARK.search(n) for n, _, _ in w.device_ops):
        return None
    return w


def _under(span, names):
    return any(span == n or span.startswith(n + ".") for n in names)


def self_ms(run, names, outside="refresh"):
    """Device ms a step while the innermost open span is one of ``names``
    or their dot-children, outside every ``outside`` span; None where the
    window ran no marker."""
    w = _window(run)
    if w is None:
        return None
    us = sum(d for st, d in walk(w.device_ops)
             if st and outside not in st and _under(st[-1], names))
    return us / 1e3 / run.work["count"]


def inclusive_ms(run, span):
    """Device ms a step inside ``span``, nested spans included."""
    w = _window(run)
    if w is None:
        return None
    us = sum(d for st, d in walk(w.device_ops) if span in st)
    return us / 1e3 / run.work["count"]


# the CUDA runtime's and driver's calls, and the profiler's record of a
# launch that blocks on a full queue: where the host waits for the device
RUNTIME = re.compile(r"(cuda|cu[A-Z])\w*|Command Buffer Full")


def host_us(run, names):
    """Host us a step in the program's ranges ``names``, less the CUDA
    runtime calls inside them (a launch that blocks while the device's
    queue is full, a synchronisation: the device's time, not the host's);
    None where the window ran no marker or holds no such range."""
    w = _window(run)
    ranges = [(s, s + d) for n, s, d in w.host_ops if n in names] if w else []
    if not ranges:
        return None
    calls = union([(s, s + d) for n, s, d in w.host_ops
                   if RUNTIME.fullmatch(n)])
    starts = [s for s, _ in calls]
    us = 0.0
    for a, b in ranges:
        us += b - a
        for s, e in calls[max(bisect.bisect_right(starts, a) - 1, 0):
                          bisect.bisect_left(starts, b)]:
            us -= max(0.0, min(e, b) - max(s, a))
    return us / run.work["count"]
