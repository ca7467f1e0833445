"""Spans and counters recorded inside the port.

A span is a named host interval: its start and end on ``time.time_ns()``
(the clock of ``torch.profiler``'s timestamps, so spans lie over a
profiler trace as they are), the span that was open on its thread when it
began (its parent), its thread and its attributes. A counter is a named
sum. Both are kept in memory, in the ``Recording`` that ``record()``
returns, until it is stopped:

    from spatiotemporalentropymodel_tpu_torch.utils import trace

    with trace.record() as rec:
        pipe.serve_gop(frames, y0)
    rec.host_s()["rans.y.decode"], rec.counters["d2h_bytes"]

With no recording on, ``span`` returns one shared no-op object after a
single check of a module global and ``count`` returns at once: no object,
no clock read, no profiler call. No profiler range is emitted at all, so
nothing of this enters a trace's device time.

The names the codec paths use (``PERF.md`` lists them with the metric
that reads each): ``serve.*`` the serving pipelines' frames, ``stem.*``,
``ar.*``, ``charm.*`` and ``image.*`` the codec stages, ``rans.{y,z}.
{encode,decode}`` one per coded stream, ``transport.*`` the sparse
transport's host halves, ``xfer.d2h``/``xfer.h2d`` the blocking copies
(counters ``d2h_bytes``, ``h2d_bytes``), and the counters
``transport.sparse``/``transport.dense``, frames by transport taken.
"""

import threading
import time
from collections import defaultdict

_REC = None  # the Recording being filled, or None
_LOCAL = threading.local()


class _Noop:
    """The span handed out while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _Noop()


def _stack():
    """The spans open on this thread, innermost last."""
    try:
        return _LOCAL.stack
    except AttributeError:
        _LOCAL.stack = []
        return _LOCAL.stack


class Span:
    """One recorded interval; ``parent`` is the span that was open on the
    same thread when it began (None at the top)."""

    __slots__ = ("name", "attrs", "start_ns", "end_ns", "parent", "thread",
                 "_rec")

    def __init__(self, rec, name, attrs):
        self._rec, self.name, self.attrs = rec, name, attrs
        self.start_ns = self.end_ns = None
        self.parent = None
        self.thread = threading.get_ident()

    def __enter__(self):
        stack = _stack()
        if stack and stack[-1]._rec is self._rec:
            self.parent = stack[-1]
        stack.append(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.end_ns = time.time_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self._rec.end_ns is None:  # one that outlived it is dropped
            self._rec.spans.append(self)
        return False


class Recording:
    """The spans (in the order they ended) and counters recorded from
    ``record()`` until ``stop()``; ``start_ns``/``end_ns`` bound it."""

    def __init__(self):
        self.spans = []
        self.counters = defaultdict(int)
        self._lock = threading.Lock()
        self.start_ns, self.end_ns = time.time_ns(), None

    def stop(self):
        global _REC
        if _REC is self:
            _REC = None
        if self.end_ns is None:
            self.end_ns = time.time_ns()
        return self

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def host_s(self):
        """Host seconds by span name, summed over the spans."""
        out = defaultdict(float)
        for s in self.spans:
            out[s.name] += (s.end_ns - s.start_ns) / 1e9
        return dict(out)


def record() -> Recording:
    """Turns recording on; returns the Recording it fills until stopped."""
    global _REC
    if _REC is not None:
        raise RuntimeError("a recording is on already")
    _REC = Recording()
    return _REC


def span(name: str, **attrs):
    """A context manager over the block: a ``Span`` while recording, else
    the shared no-op."""
    rec = _REC
    if rec is None:
        return NOOP
    return Span(rec, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Adds n to the counter ``name`` while recording."""
    rec = _REC
    if rec is None:
        return
    with rec._lock:
        rec.counters[name] += n


def d2h(nbytes: int):
    """The span of a blocking device→host copy of ``nbytes`` (``xfer.d2h``;
    counted under ``d2h_bytes``): the block holds the wait for the copy."""
    rec = _REC
    if rec is None:
        return NOOP
    count("d2h_bytes", nbytes)
    return Span(rec, "xfer.d2h", {"bytes": nbytes})


def fetch(t):
    """``t.cpu().numpy()`` in a ``d2h`` span: the helper every blocking
    fetch of the codec and serving paths goes through."""
    if _REC is None:
        return t.cpu().numpy()
    with d2h(t.nbytes):
        return t.cpu().numpy()


def upload(t, device, non_blocking: bool = False):
    """``t.to(device)`` (host → device) in an ``xfer.h2d`` span, counted
    under ``h2d_bytes``. Without ``non_blocking`` the copy waits for the
    work queued before it on the stream, so the span can hold a wait for
    the device too."""
    rec = _REC
    if rec is None:
        return t.to(device, non_blocking=non_blocking)
    count("h2d_bytes", t.nbytes)
    with Span(rec, "xfer.h2d", {"bytes": t.nbytes}):
        return t.to(device, non_blocking=non_blocking)


def upload_into(dst, t):
    """``dst.copy_(t)`` (host → an existing device buffer) in an
    ``xfer.h2d`` span, counted under ``h2d_bytes``, as ``upload``."""
    rec = _REC
    if rec is None:
        return dst.copy_(t)
    count("h2d_bytes", t.nbytes)
    with Span(rec, "xfer.h2d", {"bytes": t.nbytes}):
        return dst.copy_(t)
