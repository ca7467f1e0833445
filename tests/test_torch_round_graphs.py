"""The wavefront rounds as CUDA graphs (models/ar_wavefront.py::EncodeGraph,
DecodeGraphs), their bookkeeping on the CPU: each capture is stood in for
by a function that re-runs the captured steps on replay and writes their
outputs into the tensors the capture returned, as a graph's replay writes
its outputs' memory. The streams and ŷ then equal the eager rounds'
exactly, batched or alone, and the graphs are kept per shape until the
parameters move. The card runs the graphs themselves
(tests/test_torch_cuda.py::test_cuda_image_ar_round_graphs_match_eager)."""

import contextlib

import pytest
import torch

from spatiotemporalentropymodel_tpu_torch.models import ar_wavefront as wf
from spatiotemporalentropymodel_tpu_torch.models.priors import (
    JointAutoregressiveHierarchicalPriors,
)


def _flat(out):
    if out is None:
        return []
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in _flat(o)]


class _Replay:
    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        for mine, new in zip(_flat(self.out), _flat(self.fn())):
            mine.copy_(new)


class _Stream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def fake_graphs(monkeypatch):
    """Captures on the CPU; returns the list of captured functions."""
    captured = []

    def capture(fn, stream, pool):
        captured.append(fn)
        out = fn()
        return _Replay(fn, out), out

    monkeypatch.setattr(wf, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "Stream", _Stream)
    monkeypatch.setattr(torch.cuda, "current_stream", _Stream)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    return captured


def _model(graphs: bool):
    model = JointAutoregressiveHierarchicalPriors(8, 8, device="cpu",
                                                  seed=3)
    with torch.no_grad():
        for p in model.module.parameters():
            p.mul_(0.7)
    model.update()
    if graphs:
        model._graphed = lambda serial: not serial
    return model


def _pictures(n=2):
    return torch.rand((n, 3, 64, 128), generator=torch.Generator()
                      .manual_seed(5))


def _round_trip(model, x):
    enc, y_enc = model.encode_with_y_hat(x)
    dec = model.decompress(enc["strings"], enc["shape"])
    return enc["strings"], y_enc, dec["y_hat"]


def test_graphed_rounds_equal_the_eager_rounds(fake_graphs):
    x = _pictures()
    strings, y_enc, y_dec = _round_trip(_model(False), x)
    assert not fake_graphs
    model = _model(True)
    g_strings, g_enc, g_dec = _round_trip(model, x)
    h, w = g_enc.shape[2:]
    rounds = model._rounds_cache[(h, w, False)][2]
    # 1 encoder graph, then the decoder's first step and one a round
    assert len(fake_graphs) == 1 + 1 + len(rounds)
    assert g_strings == strings
    assert torch.equal(g_enc, y_enc) and torch.equal(g_dec, y_dec)
    assert torch.equal(y_dec, y_enc)


def test_graphs_are_kept_per_shape_until_the_parameters_move(fake_graphs):
    model, x = _model(True), _pictures()
    first = _round_trip(model, x)
    n = len(fake_graphs)
    again = _round_trip(model, x)
    assert len(fake_graphs) == n
    assert again[0] == first[0] and torch.equal(again[2], first[2])
    # a replayed decode does not leave its result in the graph's plane
    assert again[2].data_ptr() != first[2].data_ptr()
    _round_trip(model, x[:1])  # another batch: its own graphs
    assert len(fake_graphs) == 2 * n
    with torch.no_grad():
        p = next(model.module.entropy_parameters.parameters())
        p.data = p.data.clone()
    again = _round_trip(model, x)
    assert len(fake_graphs) == 3 * n
    assert again[0] == first[0] and torch.equal(again[2], first[2])


def test_graphed_streams_equal_each_stream_alone(fake_graphs):
    model, x = _model(True), _pictures()
    strings, _, y_dec = _round_trip(model, x)
    for i in range(x.shape[0]):
        s_i, _, y_i = _round_trip(model, x[i:i + 1])
        assert s_i[0] == [strings[0][i]]
        assert torch.equal(y_i[0], y_dec[i])


def test_serial_mode_and_the_cpu_run_eagerly(fake_graphs):
    graphed = _model(True)
    graphed.ar_mode = "serial"
    x = _pictures(1)[:, :, :32, :32]
    eager = _model(False)
    eager.ar_mode = "serial"
    assert _round_trip(graphed, x)[0] == _round_trip(eager, x)[0]
    assert not fake_graphs
    model = _model(False)
    assert model.round_graphs and not model._graphed(False)
