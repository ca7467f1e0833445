"""A program other than the STEM through the harness as it is: the port's
MeanScaleHyperprior(8, 8) as a plain image codec at 64², with a weights
module, a loop, a plain reference and a judge of its own, registered under
the harness's name lookup for these tests alone."""

import functools
import time
from types import SimpleNamespace

import pytest
import torch
import torch.nn.functional as F

from portbench import harness, peaks
from portbench import judge as J
from portbench import workload as WL

PEDESTAL = (2.0 ** -18) ** 2


# ---- the plain reference: g_a and g_s of Ballé et al. (CompressAI's layers)


def _nonneg(v, minimum):
    return torch.clamp_min(v, (minimum + PEDESTAL) ** 0.5) ** 2 - PEDESTAL


def _gdn(x, beta, gamma, inverse):
    c = gamma.shape[0]
    norm = F.conv2d(x * x, _nonneg(gamma, 0.0).view(c, c, 1, 1),
                    _nonneg(beta, 1e-6))
    return x * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))


def ref_g_a(I, x):
    for i in range(4):
        x = F.conv2d(x, I[f"g_a.layers.{2 * i}.weight"],
                     I[f"g_a.layers.{2 * i}.bias"], 2, 2)
        if i < 3:
            x = _gdn(x, I[f"g_a.layers.{2 * i + 1}.beta"],
                     I[f"g_a.layers.{2 * i + 1}.gamma"], False)
    return x


def ref_g_s(I, y):
    for i in range(4):
        y = F.conv_transpose2d(y, I[f"g_s.layers.{2 * i}.weight"],
                               I[f"g_s.layers.{2 * i}.bias"], 2, 2, 1)
        if i < 3:
            y = _gdn(y, I[f"g_s.layers.{2 * i + 1}.beta"],
                     I[f"g_s.layers.{2 * i + 1}.gamma"], True)
    return torch.clamp(y, 0.0, 1.0)


# ---- the program, its weights, loop and judge --------------------------


def _make_weights(cfg, frames, seed, gen, device):
    return SimpleNamespace(I=WL.draw(WL.i_model_specs(cfg["N"], cfg["M"]),
                                     gen, device))


def _make_program(cfg, traffic, W, frames, device):
    from spatiotemporalentropymodel_tpu_torch.models import (
        MeanScaleHyperprior,
    )

    codec = MeanScaleHyperprior(cfg["N"], cfg["M"], device=device)
    codec.module.load_state_dict(W.I, strict=True)
    codec.update(force=True)
    return {"codec": codec}, {}


def _transforms(cfg, hw):
    n, m = cfg["N"], cfg["M"]
    h, w = hw
    chans = [3, n, n, n, m]
    ops = sum(peaks.conv(chans[j], chans[j + 1], 5, h >> j + 1, w >> j + 1)
              for j in range(4))  # the k5 s2 convs, from h/2 to h/16
    layers = (ops, [((h >> j) * (w >> j), n) for j in (1, 2, 3)], 0)
    io = 3 * h * w + m * (h // 16) * (w // 16)
    return {"g_a": (layers, io), "g_s": (layers, io)}


def _picture_ops(cfg, hw, served):
    return sum(peaks.transform_ops(layers)
               for layers, _ in _transforms(cfg, hw).values())


class ImageServe(harness.Loop):
    """Each step compresses one frame of every stream, then decompresses
    it."""

    def __init__(self, st, spans, clock):
        self.st, self.clock, self.k = st, clock, 0
        self.enc_y_hat = []
        spans.wrap(st.codec, "fused_encode_expr", "pb.g_a",
                   lambda a, k, o: self.enc_y_hat.append(o[1]))

    def step(self):
        x = self.st.frames[self.k % self.st.gop]
        self.k += 1
        self.enc_y_hat.clear()
        t = time.perf_counter()
        enc = self.st.codec.compress(x)
        dec = self.st.codec.decompress(enc["strings"], enc["shape"])
        end = self.clock.mark()
        return [(t, end, x.shape[0])], [{
            "x": x, "strings": enc["strings"], "y_hat_enc": self.enc_y_hat[0],
            "y_hat": dec["y_hat"], "x_hat": dec["x_hat"]}]


@torch.no_grad()
def _judge(I, rec):
    """``y_hat``: how far the decoded ŷ is from a rounding of the
    reference's y (and from the encoder's ŷ), over max |y|; ``x_hat``:
    max |x̂ − g_s_ref(ŷ)|."""
    y = ref_g_a(I, rec["x"])
    gap = max(J.rounding_gap(y, rec["y_hat"]),
              float((rec["y_hat"] - rec["y_hat_enc"]).abs().max()))
    return {"y_hat": gap / float(y.abs().max()),
            "x_hat": float((rec["x_hat"] - ref_g_s(I, rec["y_hat"]))
                           .abs().max())}


PROGRAM = SimpleNamespace(
    make=_make_program, reference=lambda W, cfg, net_dtype: W.I,
    transforms=_transforms, picture_ops=_picture_ops,
    check=lambda cfg, loop: None)
MODULES = {
    ("programs", "msh_image"): PROGRAM,
    ("weights", "msh_image"): SimpleNamespace(make=_make_weights),
    ("loops", "image_serve"): SimpleNamespace(
        KEYS=(), PROGRAMS=("msh_image",), make=ImageServe),
    ("judges", "image_serve"): SimpleNamespace(
        NAMES=("y_hat", "x_hat"), judge=_judge),
}


@pytest.fixture(autouse=True)
def _registered(monkeypatch):
    """The modules above, found by name as files under portbench/ are."""
    find = harness.find
    monkeypatch.setattr(harness, "find", lambda kind, name: MODULES.get(
        (kind, name)) or find(kind, name))
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cell():
    return SimpleNamespace(
        name="msh_image_8.serve_f32", chips=1,
        cfg={"name": "msh_image_8", "program": "msh_image",
             "weights": "msh_image", "N": 8, "M": 8},
        traffic={"loop": "image_serve", "judge": "image_serve",
                 "dtype": "float32", "streams": 2, "height": 64,
                 "width": 64, "gop": 2, "sample": 2,
                 "why": "2 streams of 64x64 pictures, each coded and decoded"},
        limits={"y_hat": 1e-4, "x_hat": 1e-4},
        end_to_end=[{"name": "frames_per_s", "unit": "frames/s"},
                    {"name": "setup_s", "unit": "s"}],
        per_layer=[{"name": "step_mfu", "unit": "%"}])


def _run(cell, trace=False, fault=None):
    lines = []
    out = harness.run(cell, 2147483901, 0.3, trace, device="cpu",
                      log=lambda *a: lines.append(" ".join(map(str, a))),
                      fault=fault)
    return out, lines


def test_a_second_program_runs_and_is_judged():
    cell = _cell()
    harness.check_cell(cell)
    out, lines = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0
    assert set(out["metrics"]) == {"frames_per_s", "setup_s"}
    assert any(ln.startswith("coded bits per picture") for ln in lines)
    for name, c in out["checks"].items():
        assert c["value"] <= 1e-5, (name, c)


def test_its_readers_ask_the_program(monkeypatch):
    asked = []
    monkeypatch.setattr(PROGRAM, "picture_ops", lambda cfg, hw, served: (
        asked.append((hw, served)) or _picture_ops(cfg, hw, served)))
    out, _ = _run(_cell(), trace=True)
    assert out["correct"], out["checks"]
    assert asked == [((64, 64), True)]
    assert out["metrics"]["step_mfu"]["value"] > 0


def _x_hat_altered(st):
    """One element of every decoded picture off by one."""
    decompress = st.codec.decompress

    @functools.wraps(decompress)
    def altered(*a, **kw):
        out = decompress(*a, **kw)
        x_hat = out["x_hat"].clone()
        x_hat[:, 0, 3, 5] += 1.0
        return {**out, "x_hat": x_hat}

    st.codec.decompress = altered


def test_an_altered_picture_is_not_correct():
    out, _ = _run(_cell(), fault=_x_hat_altered)
    assert not out["correct"]
    assert out["checks"]["x_hat"]["value"] >= 0.5


@pytest.mark.parametrize("change, word", [
    (lambda c: c.cfg.update(program="cheng2020_attn"), "no programs module"),
    (lambda c: c.cfg.pop("program"), "names no program"),
    (lambda c: c.cfg.update(program="stem"), "does not drive program"),
], ids=["unknown", "unnamed", "not_driven"])
def test_a_program_the_loop_does_not_drive_is_refused(change, word):
    cell = _cell()
    change(cell)
    with pytest.raises(SystemExit, match=word):
        harness.check_cell(cell)
