"""The port's span and counter recorder (utils/trace.py) and the spans of
its codec paths, on the CPU."""

import os
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu_torch.models import (
    SpatioTemporalPriorModel,
)
from spatiotemporalentropymodel_tpu_torch.models import ar_wavefront as wf
from spatiotemporalentropymodel_tpu_torch.utils import trace

PORT = Path(__file__).resolve().parents[1] / \
    "spatiotemporalentropymodel_tpu_torch"
M, EBC, B, LAT = 16, 16, 2, 8  # an 8×8 latent, two streams


@pytest.fixture(scope="module")
def res():
    """A seeded res STEM with the benchmark's wavefront tile (1, 4), and two
    frames' (y_cur, y_cond) of two streams."""
    stem = SpatioTemporalPriorModel(variant="res",
                                    entropy_bottleneck_channels=EBC,
                                    in_channels=M, wavefront_tile=(1, 4),
                                    device="cpu", seed=3)
    stem.update()
    g = torch.Generator().manual_seed(4)
    frames = []
    for _ in range(2):
        y_cond = torch.randn((B, M, LAT, LAT), generator=g)
        frames.append((y_cond + 0.3 * torch.randn(y_cond.shape, generator=g),
                       y_cond))
    return stem, frames


def _round_trip(stem, frames):
    for y_cur, y_cond in frames:
        enc = stem.compress(y_cur, y_cond)
        stem.decompress(enc["strings"], enc["shape"], y_cond)


def test_recording_off_records_nothing(res, monkeypatch):
    """Off: ``span`` hands out the one shared no-op, makes no Span and
    reads no clock; ``count`` adds nothing; the codec still runs."""
    stem, frames = res
    assert trace._REC is None
    assert trace.span("x") is trace.span("y", frame=1) is trace.NOOP
    assert trace.d2h(8) is trace.NOOP

    def refuse(*a, **k):
        raise AssertionError("the off path made a span or read the clock")

    monkeypatch.setattr(trace.Span, "__init__", refuse)
    monkeypatch.setattr(trace.time, "time_ns", refuse)
    with trace.span("x", frame=0):
        trace.count("c", 3)
    _round_trip(stem, frames[:1])
    monkeypatch.undo()
    with trace.record() as rec:
        pass
    assert rec.spans == [] and dict(rec.counters) == {}
    assert trace._REC is None


def test_nesting_and_parents_on_two_threads():
    """Each thread's spans nest on its own stack: a span's parent is the
    one open on its thread, never another thread's."""
    both_open = threading.Barrier(2)

    def work(tag):
        with trace.span("outer", tag=tag):
            with trace.span("inner", tag=tag):
                both_open.wait()
            trace.count("n", 2)

    with trace.record() as rec:
        threads = [threading.Thread(target=work, args=(t,)) for t in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        with pytest.raises(RuntimeError):
            trace.record()
    assert rec.counters["n"] == 4
    by = {(s.name, s.attrs["tag"]): s for s in rec.spans}
    assert len(by) == 4
    for tag in "ab":
        outer, inner = by[("outer", tag)], by[("inner", tag)]
        assert outer.parent is None and inner.parent is outer
        assert inner.thread == outer.thread
        assert outer.start_ns <= inner.start_ns <= inner.end_ns <= \
            outer.end_ns
    assert by[("outer", "a")].thread != by[("outer", "b")].thread
    # the two inner spans were open at once
    a, b = by[("inner", "a")], by[("inner", "b")]
    assert a.start_ns < b.end_ns and b.start_ns < a.end_ns
    assert rec.host_s()["outer"] >= rec.host_s()["inner"]


def test_counts_and_spans_from_many_threads_are_all_kept():
    """More threads than cores, switching often: no count or span lost."""
    n_threads, n = (os.cpu_count() or 1) + 4, 500

    def work():
        for _ in range(n):
            trace.count("n")
            with trace.span("s"):
                pass

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with trace.record() as rec:
            threads = [threading.Thread(target=work)
                       for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert rec.counters["n"] == n_threads * n
    assert len(rec.spans) == n_threads * n
    assert all(s.parent is None for s in rec.spans)


def test_spans_share_the_profilers_clock():
    """A span around a ``record_function`` range lies on the profiler's
    clock: it holds the range's kineto event, within 50 µs at both ends."""
    from torch.profiler import ProfilerActivity, profile, record_function

    probes = []
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            trace.record() as rec:
        with record_function("warm-up"):
            pass
        for i in range(5):
            with trace.span("probe", i=i) as sp:
                with record_function(f"probe{i}"):
                    time.sleep(0.002)
            probes.append(sp)
    assert len(rec.spans) == 5
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    gaps = []
    for i, sp in enumerate(probes):
        ev = events[f"probe{i}"]
        d0 = ev.start_ns() - sp.start_ns
        d1 = sp.end_ns - (ev.start_ns() + ev.duration_ns())
        assert d0 > -5_000 and d1 > -5_000, (d0, d1)
        gaps.append(max(d0, d1))
    assert min(gaps) < 50_000, gaps


def test_stage_clock_adds_host_seconds_without_synchronising(res,
                                                             monkeypatch):
    """With ``_codec_stats`` set the stages fill the old keys with the host
    seconds of the spans that replaced them, and nothing synchronises; no
    model file calls ``torch.cuda.synchronize``."""
    stem, frames = res

    def refuse(*a, **k):
        raise AssertionError("the stage clock synchronised")

    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    stem._codec_stats = {}
    try:
        with trace.record() as rec:
            _round_trip(stem, frames[:1])
        st = stem._codec_stats
    finally:
        stem._codec_stats = None
    assert {"hyper_s", "priors_s", "enc_device_s", "enc_host_s", "device_s",
            "host_rans_s"} <= set(st)
    host = rec.host_s()
    for key, names in (("host_rans_s", ["ar.decode.rans"]),
                       ("enc_host_s", ["ar.encode.host"]),
                       ("priors_s", ["stem.priors"]),
                       ("device_s", ["ar.decode.params", "ar.decode.fetch",
                                     "ar.decode.write"])):
        assert st[key] == pytest.approx(sum(host[n] for n in names),
                                        abs=1e-3), key
    assert st["enc_fetch_bytes"] == B * LAT * LAT * M * 3
    for path in (PORT / "models").glob("*.py"):
        assert "synchronize" not in path.read_text(), path.name


def test_wavefront_rounds_and_fetched_bytes(res):
    """One ``ar.decode.round`` a round a frame, in order, each holding its
    fetch, rANS and write; one rANS span a stream; ``d2h_bytes`` the bytes
    the fetches return: ẑ in f32, the encoder's int16 symbols and u8
    indexes, and each round's u8 indexes."""
    stem, frames = res
    coords, valid = wf.wavefront_tables(1, 4)
    n_rounds = int(valid.any(axis=1).sum())
    with trace.record() as rec:
        _round_trip(stem, frames)
    rounds = [s for s in rec.spans if s.name == "ar.decode.round"]
    assert [s.attrs["round"] for s in rounds] == \
        list(range(n_rounds)) * len(frames)
    for r in rounds:
        kids = [s.name for s in rec.spans if s.parent is r]
        assert kids == ["ar.decode.fetch", "ar.decode.rans",
                        "ar.decode.write"]
    names = [s.name for s in rec.spans]
    for name, per_frame in (("rans.y.encode", B), ("rans.z.encode", B),
                            ("rans.z.decode", B),
                            ("rans.y.decode", B * n_rounds),
                            ("stem.hyper", 2), ("stem.priors", 2)):
        assert names.count(name) == per_frame * len(frames), name
    fetches = [s for s in rec.spans if s.name == "xfer.d2h"]
    zh = -(-LAT // 4)
    z_f32 = B * zh * zh * EBC * np.dtype(np.float32).itemsize
    enc = B * LAT * LAT * M * (np.dtype(np.int16).itemsize
                               + np.dtype(np.uint8).itemsize)
    idx = B * LAT * LAT * M * np.dtype(np.uint8).itemsize
    want = len(frames) * (z_f32 + enc + idx)
    assert rec.counters["d2h_bytes"] == want
    assert sum(s.attrs["bytes"] for s in fetches) == want
    assert len(fetches) == len(frames) * (1 + 2 + n_rounds)
    for stage in (s for s in rec.spans if s.name == "ar.decode.fetch"):
        assert [s.name for s in rec.spans if s.parent is stage] == \
            ["xfer.d2h"]


def test_image_codec_spans_and_attention_counter():
    """A recorded compress and decompress of two pictures through a small
    Cheng2020Attention: ``image.g_a`` (g_a and h_a), ``image.z`` (ẑ's
    fetch, rANS and upload) and ``image.priors`` (h_s) once a compress,
    ``image.z``, ``image.priors`` and ``image.g_s`` once a decompress, each
    a top-level span; ``attention.calls`` 2 for each picture's g_a (g_a
    runs once per picture) and 2 for g_s (once on the batch); the stage
    clock keeps its ``hyper_s`` key."""
    from spatiotemporalentropymodel_tpu_torch.models import Cheng2020Attention

    model = Cheng2020Attention(8, device="cpu", seed=5)
    model.update()
    x = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(6))
    model._codec_stats = {}
    try:
        with trace.record() as enc_rec:
            enc = model.compress(x)
        with trace.record() as dec_rec:
            model.decompress(enc["strings"], enc["shape"])
        st = model._codec_stats
    finally:
        model._codec_stats = None

    def top(rec):
        return [s.name for s in sorted(rec.spans, key=lambda s: s.start_ns)
                if s.parent is None and s.name.startswith("image.")]

    assert top(enc_rec) == ["image.g_a", "image.z", "image.priors"]
    assert top(dec_rec) == ["image.z", "image.priors", "image.g_s"]
    assert enc_rec.counters["attention.calls"] == 2 * 2
    assert dec_rec.counters["attention.calls"] == 2
    assert "hyper_s" in st and "image.hyper" not in {
        s.name for s in enc_rec.spans + dec_rec.spans}
