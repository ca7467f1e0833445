"""Spans around the program's layers and the reading of a profiler trace.

The spans are host intervals that the harness records around calls into
the program's layers, by wrapping bound methods of the instances it built
(no program file changes), on the clock of the profiler's timestamps
(``time.time_ns``). The program launches its work from the thread that
calls it, and the loops call it from one thread, so the spans do not
overlap. A span's device time is the time of the device operations
launched inside it: a kernel's launch (the CUDA runtime call with its
correlation id) falls in the span that holds the call's start.
``summarize`` reduces a trace to the numbers the per-layer readers take.
"""

import bisect
import time
from collections import defaultdict

import torch

WINDOW = "pb.window"


class Spans:
    """Host seconds and calls per span name; with ``record`` on, also each
    call's (start ns, end ns, name)."""

    def __init__(self, record: bool):
        self.record = record
        self.host_s = defaultdict(float)
        self.calls = defaultdict(int)
        self.intervals = []

    def wrap(self, obj, method: str, name: str, capture=None):
        """obj.method, in a span ``name``; ``capture(args, kw, result)``
        sees every call."""
        fn = getattr(obj, method)

        def wrapped(*args, **kw):
            t, t_ns = time.perf_counter(), time.time_ns()
            out = fn(*args, **kw)
            end_ns, dt = time.time_ns(), time.perf_counter() - t
            self.host_s[name] += dt
            self.calls[name] += 1
            if self.record:
                self.intervals.append((t_ns, end_ns, name))
            if capture is not None:
                capture(args, kw, out)
            return out

        setattr(obj, method, wrapped)

    def reset(self):
        self.host_s.clear()
        self.calls.clear()
        self.intervals.clear()


def _is_device(ev):
    return ev.device_type() == torch.autograd.DeviceType.CUDA


def _is_device_op(ev):
    """A device operation: a kernel, copy or set, not the device-side
    mirror of a host range."""
    return (_is_device(ev) and ev.duration_ns() > 0
            and not ev.is_user_annotation() and not ev.name().startswith("pb."))


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _span_at(spans, t):
    """The name of the span that holds time t, or None; ``spans`` is
    (starts, [(start, end, name)]) sorted."""
    starts, rows = spans
    i = bisect.bisect_right(starts, t) - 1
    if i >= 0 and t <= rows[i][1]:
        return rows[i][2]
    return None


def summarize(prof, intervals, top: int = 10):
    """From a finished profiler and the spans' intervals: the window (the
    ``pb.window`` range), the device's busy seconds in it, the device
    seconds of the operations launched inside each span name, the device
    operations that took most time, and the idle gaps by the span the host
    was in at their middle."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW and not _is_device(e)]
    if not win:
        return None
    w0 = win[0].start_ns()
    w1 = w0 + win[0].duration_ns()
    rows = sorted(intervals)
    spans = ([r[0] for r in rows], rows)
    launch = {}
    for e in events:
        if not _is_device(e) and e.correlation_id() > 0 and \
                e.name().startswith(("cuda", "cu")):
            launch[e.correlation_id()] = e.start_ns()
    dev = [e for e in events if _is_device_op(e)]
    by_op = defaultdict(float)
    by_span = defaultdict(float)
    ops = []
    for e in dev:
        s, d = e.start_ns(), e.duration_ns()
        if s + d < w0 or s > w1:
            continue
        ops.append((max(s, w0), min(s + d, w1)))
        by_op[e.name()[:120]] += d / 1e9
        at = launch.get(e.correlation_id())
        name = None if at is None else _span_at(spans, at)
        if name is not None:
            by_span[name] += d / 1e9
    busy = _union(ops)
    busy_s = sum(e - s for s, e in busy) / 1e9
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        name = _span_at(spans, (s + e) / 2)
        gaps["host: " + (name or "outside the program's spans")] += \
            (e - s) / 1e9
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": busy_s,
        "span_device_s": dict(by_span),
        "device_ops": sorted(by_op.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:top],
        "n_device_ops": len(dev),
    }
