"""The spans and the reading of a trace, on synthetic events."""

from types import SimpleNamespace

import pytest
import torch

from portbench import tracing

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class _Ev:
    def __init__(self, name, start, dur, device=CPU, corr=0, resource=0):
        self._v = (name, start, dur, device, corr, resource)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def device_resource_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return False


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


def test_spans_record_calls():
    spans = tracing.Spans(record=True)
    obj = SimpleNamespace(f=lambda v: v + 1)
    seen = []
    spans.wrap(obj, "f", "pb.x", lambda a, k, o: seen.append(o))
    assert obj.f(1) == 2 and obj.f(2) == 3
    assert spans.calls["pb.x"] == 2 and seen == [2, 3]
    assert [n for *_, n in spans.intervals] == ["pb.x", "pb.x"]
    assert all(t0 <= t1 for t0, t1, _ in spans.intervals)
    spans.reset()
    assert not spans.intervals and not spans.calls


def test_launches_go_to_the_span_they_were_made_in():
    """Each kernel goes to the span that holds its launch (a launch outside
    every span goes to none), and each idle gap to the span the host was
    in at its middle."""
    intervals = [(100, 200, "pb.g_a"), (250, 300, "pb.host_coder"),
                 (300, 400, "pb.g_s")]
    events = [
        _Ev(tracing.WINDOW, 0, 1000),
        _Ev("cudaLaunchKernel", 160, 1, corr=1),
        _Ev("cudaLaunchKernel", 270, 1, corr=2),
        _Ev("cudaLaunchKernel", 350, 1, corr=3),
        _Ev("cudaLaunchKernel", 500, 1, corr=4),
        _Ev("k1", 180, 100, CUDA, corr=1),
        _Ev("k2", 280, 50, CUDA, corr=2),
        _Ev("k3", 360, 150, CUDA, corr=3),
        _Ev("k4", 700, 100, CUDA, corr=4),
    ]
    out = tracing.summarize(_prof(events), intervals)
    assert out["span_device_s"] == pytest.approx(
        {"pb.g_a": 100e-9, "pb.host_coder": 50e-9, "pb.g_s": 150e-9})
    assert out["busy_s"] == pytest.approx(400e-9)
    assert out["window_s"] == pytest.approx(1000e-9)
    assert dict(out["idle_gaps"]) == pytest.approx(
        {"host: pb.g_s": 30e-9,
         "host: outside the program's spans": 570e-9})
