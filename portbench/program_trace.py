"""The program's own spans laid over a profiler trace.

The port records spans and counters inside itself
(``spatiotemporalentropymodel_tpu_torch/utils/trace.py``): named host
intervals on ``time.time_ns()``, the profiler's clock, each with its parent
on its thread. ``summarize_program`` takes a finished profiler whose trace
holds the ``pb.window`` range and that recording, and splits the window's
device-idle time by the innermost program span the host was in, by exact
overlap: each idle interval is cut at every span boundary, and each piece
goes to the deepest span open over it (the latest started among equals,
where threads overlap), or to no span. The pieces add up to the window
less the device's busy time.

It reads the recording by duck typing (``spans`` with ``name``,
``start_ns``, ``end_ns``, ``parent``; ``counters``) and imports nothing of
the program.
"""

from collections import defaultdict

from . import tracing

# the host coder: rANS of each stream and the sparse transport's host halves
HOST_CODER = ("rans.", "transport.")


def _window(events):
    win = [e for e in events
           if e.name() == tracing.WINDOW and not tracing._is_device(e)]
    if not win:
        return None
    w0 = win[0].start_ns()
    return w0, w0 + win[0].duration_ns()


def _idle(events, w0, w1):
    """The window's intervals with no device operation, sorted."""
    ops = []
    for e in events:
        if tracing._is_device_op(e):
            s, t = e.start_ns(), e.start_ns() + e.duration_ns()
            if t >= w0 and s <= w1:
                ops.append((max(s, w0), min(t, w1)))
    edges = [w0] + [x for iv in tracing._union(ops) for x in iv] + [w1]
    return [(s, t) for s, t in zip(edges[0::2], edges[1::2]) if t > s]


def _depth(span, memo):
    key = id(span)
    if key not in memo:
        memo[key] = 0 if span.parent is None else _depth(span.parent,
                                                         memo) + 1
    return memo[key]


def _innermost_segments(spans):
    """[(start, end, span or None)], sorted and disjoint: between two span
    boundaries, the deepest span open there."""
    memo = {}
    points = sorted({p for s in spans for p in (s.start_ns, s.end_ns)})
    opens = sorted(spans, key=lambda s: s.start_ns)
    out, live, i = [], [], 0
    for a, b in zip(points, points[1:]):
        while i < len(opens) and opens[i].start_ns <= a:
            live.append(opens[i])
            i += 1
        live = [s for s in live if s.end_ns > a]
        top = max(live, key=lambda s: (_depth(s, memo), s.start_ns),
                  default=None)
        out.append((a, b, top))
    return out


def _overlap(intervals, others):
    """Total overlap, in ns, of two sorted lists of disjoint intervals."""
    total, j = 0, 0
    for s, t in intervals:
        while j < len(others) and others[j][1] <= s:
            j += 1
        k = j
        while k < len(others) and others[k][0] < t:
            total += min(t, others[k][1]) - max(s, others[k][0])
            k += 1
    return total


def summarize_program(prof, recording):
    """From a finished profiler and the program's recording: the window and
    the device's busy seconds in it (as ``tracing.summarize`` reads them),
    the idle seconds by innermost program span and outside every span, the
    idle seconds inside the host coder's spans (``HOST_CODER``), the host
    seconds of each span name within the window, and the counters."""
    events = prof.profiler.kineto_results.events()
    w = _window(events)
    if w is None:
        return None
    w0, w1 = w
    idle = _idle(events, w0, w1)
    spans = [s for s in recording.spans
             if s.end_ns is not None and s.end_ns > w0 and s.start_ns < w1]
    by_span = defaultdict(int)
    inside, j = 0, 0
    for a, b, top in _innermost_segments(spans):
        a, b = max(a, w0), min(b, w1)
        if b <= a or top is None:
            continue
        while j < len(idle) and idle[j][1] <= a:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < b:
            n = min(b, idle[k][1]) - max(a, idle[k][0])
            by_span[top.name] += n
            inside += n
            k += 1
    idle_ns = sum(t - s for s, t in idle)
    coder = tracing._union([(max(s.start_ns, w0), min(s.end_ns, w1))
                            for s in spans if s.name.startswith(HOST_CODER)])
    host = defaultdict(int)
    for s in spans:
        host[s.name] += min(s.end_ns, w1) - max(s.start_ns, w0)
    return {
        "window_s": (w1 - w0) / 1e9,
        "busy_s": (w1 - w0 - idle_ns) / 1e9,
        "idle_by_span": {k: v / 1e9 for k, v in sorted(
            by_span.items(), key=lambda kv: -kv[1])},
        "idle_outside_s": (idle_ns - inside) / 1e9,
        "idle_in_host_coder_s": _overlap(idle, [tuple(c) for c in coder])
        / 1e9,
        "host_s": {k: v / 1e9 for k, v in sorted(host.items(),
                                                 key=lambda kv: -kv[1])},
        "counters": dict(recording.counters),
    }
