"""The program's spans over a trace (``program_trace.summarize_program``),
on synthetic events and on a CPU profiler run."""

import time
from types import SimpleNamespace

import pytest
import torch

from portbench import program_trace, tracing
from portbench.tests.test_portbench_tracing import CUDA, _Ev, _prof


def _span(name, start, end, parent=None):
    return SimpleNamespace(name=name, start_ns=start, end_ns=end,
                           parent=parent)


def _events():
    return [
        _Ev(tracing.WINDOW, 0, 1000),
        _Ev("cudaLaunchKernel", 60, 1, corr=1),
        _Ev("cudaLaunchKernel", 520, 1, corr=2),
        _Ev("k1", 100, 100, CUDA, corr=1),
        _Ev("k2", 600, 100, CUDA, corr=2),
    ]


def _recording():
    decode = _span("serve.decode", 50, 650)
    fetch = _span("ar.decode.fetch", 150, 300, decode)
    spans = [_span("xfer.d2h", 250, 300, fetch), fetch,
             _span("rans.y.decode", 300, 500, decode), decode,
             _span("serve.encode", 800, 900), _span("serve.gop", -50, 20)]
    return SimpleNamespace(spans=spans, counters={"d2h_bytes": 64})


def test_idle_goes_to_the_innermost_span_by_exact_overlap():
    """Idle [0, 100), [200, 600), [700, 1000]: each piece to the deepest
    span open over it, by overlap (a midpoint would give the whole of
    [200, 600) to rans), the rest outside; together the window less the
    busy time."""
    out = program_trace.summarize_program(_prof(_events()), _recording())
    assert out["window_s"] == pytest.approx(1000e-9)
    assert out["busy_s"] == pytest.approx(200e-9)
    assert out["idle_by_span"] == pytest.approx({
        "serve.decode": 150e-9, "ar.decode.fetch": 50e-9,
        "xfer.d2h": 50e-9, "rans.y.decode": 200e-9,
        "serve.encode": 100e-9, "serve.gop": 20e-9})
    assert out["idle_outside_s"] == pytest.approx(230e-9)
    assert sum(out["idle_by_span"].values()) + out["idle_outside_s"] == \
        pytest.approx(out["window_s"] - out["busy_s"], abs=1e-15)
    assert out["idle_in_host_coder_s"] == pytest.approx(200e-9)
    assert out["host_s"]["serve.decode"] == pytest.approx(600e-9)
    assert out["host_s"]["serve.gop"] == pytest.approx(20e-9)
    assert out["counters"] == {"d2h_bytes": 64}


def test_the_benchmarks_summary_is_unchanged_by_program_spans():
    """``tracing.summarize`` reads the same numbers with the program's
    spans summarised beside it."""
    intervals = [(40, 660, "pb.stem"), (780, 920, "pb.g_s")]
    before = tracing.summarize(_prof(_events()), intervals)
    program_trace.summarize_program(_prof(_events()), _recording())
    after = tracing.summarize(_prof(_events()), intervals)
    assert before == after
    assert dict(after["idle_gaps"]) == pytest.approx({
        "host: pb.stem": 500e-9, "host: pb.g_s": 300e-9})


def test_spans_overlapping_on_two_threads_go_to_the_deeper():
    spans = [_span("a", 0, 1000), _span("b", 100, 400)]
    spans.append(_span("c", 300, 600, spans[1]))
    segs = program_trace._innermost_segments(spans)
    assert [(a, b, s.name) for a, b, s in segs] == [
        (0, 100, "a"), (100, 300, "b"), (300, 400, "c"), (400, 600, "c"),
        (600, 1000, "a")]


def test_a_cpu_profile_splits_its_whole_window():
    """On the CPU no device operation runs: the window is idle, and the
    program's spans, recorded on the profiler's clock, split it."""
    from spatiotemporalentropymodel_tpu_torch.utils import trace

    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(tracing.WINDOW), \
                trace.record() as rec:
            for _ in range(3):
                with trace.span("serve.encode"):
                    with trace.span("rans.y.encode"):
                        time.sleep(0.002)
                time.sleep(0.001)
    out = program_trace.summarize_program(prof, rec)
    assert out["busy_s"] == 0
    total = sum(out["idle_by_span"].values()) + out["idle_outside_s"]
    assert total == pytest.approx(out["window_s"], abs=1e-6)
    assert out["idle_by_span"]["rans.y.encode"] >= 0.006
    assert out["idle_in_host_coder_s"] == pytest.approx(
        out["idle_by_span"]["rans.y.encode"])
