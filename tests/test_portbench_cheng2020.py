"""The benchmark's Cheng2020-attn cell on the CPU at N = M = 16 on 64²
pictures, seeded: its plain reference against the port's modules, the
port's streams decoded by the reference, the judge on a sound and on a
faulted program, the counts against ``torch.utils.flop_counter``, the
cell's metrics, and a reference that imports nothing of the port."""

import copy
import functools
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, peaks
from portbench import judge as J
from portbench import reference_cheng2020 as RC
from portbench import workload as WL

ROOT = Path(__file__).resolve().parents[1]
CELL = "cheng2020_attn_q6.image_f32"
N, HW, SEED = 16, (64, 64), 2147484301
# f32 on the CPU on both sides; they differ in the order of some sums (the
# port's plain GDN sums γ·x² by einsum where the reference convolves, its
# sigmoid is 1/(1 + e^-x) where the reference calls torch.sigmoid): a few
# f32 ulps through about 40 layers, far under 1e-5 of the largest output
RTOL_OF_MAX = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfg():
    cfg = dict(harness.load_cell(CELL).cfg)
    cfg.update(N=N, M=N, active_channels=5)
    return cfg


def _small_cell(streams=2, hw=HW[0]):
    cell = harness.load_cell(CELL)
    cell.cfg.update(N=N, M=N, active_channels=5)
    cell.traffic.update(height=hw, width=hw, streams=streams, gop=3)
    return cell


@functools.lru_cache(maxsize=None)
def _weights():
    """(weights, frames (gop, 2, 3, 64, 64)) from the seed, surgery and
    all."""
    cfg = _cfg()
    frames = WL.gop_frames(SEED, 2, 2, HW, "cpu")
    gen = torch.Generator().manual_seed(SEED)
    W = harness.find("weights", cfg["weights"]).make(cfg, frames, SEED, gen,
                                                     "cpu").W
    return W, frames


def _codec():
    cfg = _cfg()
    W, _ = _weights()
    return harness.find("programs", cfg["program"]).make(
        cfg, {"dtype": "float32"}, type("W", (), {"W": W}), None,
        "cpu")[0]["codec"]


@torch.no_grad()
@pytest.mark.parametrize("net", ["g_a", "g_s", "h_a", "h_s"])
def test_reference_nets_are_the_ports(net):
    W, frames = _weights()
    module = _codec().module
    ref = RC.Ref(W, _cfg())
    y = RC.g_a(W, frames[0])
    _, z_hat = RC.z_symbols(ref, RC.h_a(W, y[:1]))
    inputs = {"g_a": frames[0], "g_s": torch.round(y), "h_a": y,
              "h_s": z_hat}
    x = inputs[net]
    want = getattr(RC, net)(W, x, clamp=False) if net == "g_s" else \
        getattr(RC, net)(W, x)
    got = getattr(module, net)(x)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= RTOL_OF_MAX * float(
        want.abs().max())


@torch.no_grad()
def test_the_ports_streams_decode_in_the_reference():
    """The port's z and y streams of two pictures, decoded by the
    reference round by round with its own tables and (σ, μ), give the
    port's ŷ exactly, on the encoder's side and the decoder's."""
    W, frames = _weights()
    codec = _codec()
    ref = RC.Ref(W, _cfg())
    x = frames[1]
    enc, y_enc = codec.encode_with_y_hat(x)
    y_dec = codec.decompress(enc["strings"], enc["shape"])["y_hat"]
    assert torch.equal(y_enc, y_dec)
    y_strings, z_strings = enc["strings"]
    for i in range(x.shape[0]):
        y = RC.g_a(W, x[i:i + 1])
        z = RC.h_a(W, y)[0].double().numpy() - ref.zt.medians[:, None, None]
        zs = J.decode_z(ref, z_strings[i:i + 1], (1, *z.shape))[0]
        assert abs(z - zs).max() <= 0.5
        y_hat, _ = RC.ar_decode(ref, y_strings[i], zs, "cpu")
        assert torch.equal(y_hat, y_dec[i:i + 1])
        assert J.rounding_gap(y, y_hat) <= 1e-5


def _symbol_moved(st):
    decompress = st.codec.decompress

    @functools.wraps(decompress)
    def moved(*a, **kw):
        out = decompress(*a, **kw)
        y_hat = out["y_hat"].clone()
        y_hat[0, 1, 2, 3] += 1.0
        return {**out, "y_hat": y_hat}

    st.codec.decompress = moved


def _g_s_bf16(st):
    """g_s run in bf16: a bf16 copy of the codec's g_s in its place."""
    half = copy.deepcopy(st.codec.module.g_s).to(torch.bfloat16)
    st.codec.module.g_s.forward = lambda y: half(y.to(torch.bfloat16)).float()


@pytest.mark.parametrize("fault, number", [
    (None, None), (_symbol_moved, "y_hat"), (_g_s_bf16, "g_s")],
    ids=["sound", "symbol_moved", "g_s_bf16"])
def test_the_judge_passes_the_sound_program_and_fails_faults(fault, number):
    out = harness.run(_small_cell(), SEED, 0.3, False, device="cpu",
                      log=lambda *a: None, fault=fault)
    if fault is None:
        assert out["correct"], out["checks"]
        for name, c in out["checks"].items():
            assert c["value"] <= c["limit"] / 10, (name, c)
    else:
        assert not out["correct"]
        c = out["checks"][number]
        assert c["value"] > 10 * c["limit"], c


@torch.no_grad()
def test_counts_are_the_flop_counters():
    """``transforms`` and ``picture_ops`` count what the reference's
    picture computes, as ``torch.utils.flop_counter`` counts it, on a
    64 × 128 picture (a 4 × 8 latent), served and not."""
    W, _ = _weights()
    cfg = _cfg()
    prog = harness.find("programs", cfg["program"])
    ref = RC.Ref(W, cfg)
    hw = (64, 128)
    x = WL.gop_frames(SEED, 1, 1, hw, "cpu")[0]

    def flops(fn):
        with FlopCounterMode(display=False) as fc:
            out = fn()
        return fc.get_total_flops(), out

    t = prog.transforms(cfg, hw)
    f_ga, _ = flops(lambda: RC.g_a(W, x))
    f_enc, (y, zs, y_string, _, y_hat) = flops(lambda: RC.encode(ref, x))
    f_dec, _ = flops(lambda: RC.ar_decode(ref, y_string, zs, "cpu"))
    f_gs, _ = flops(lambda: RC.g_s(W, y_hat))
    assert peaks.transform_ops(t["g_a"][0]) == f_ga
    assert peaks.transform_ops(t["g_s"][0]) == f_gs
    assert prog.picture_ops(cfg, hw, True) == f_enc + f_dec + f_gs
    assert prog.picture_ops(cfg, hw, False) == f_enc + f_gs
    assert t["g_a"][1] == 3 * 64 * 128 + N * 4 * 8
    ga_weights = sum(v.numel() for k, v in W.items()
                     if k.startswith("g_a.") and not k.endswith(".beta"))
    assert t["g_a"][0][2] == ga_weights + 3 * N  # each GDN's β once


def test_the_cell_loads_and_reports_its_metrics():
    """The cell's entries, and one CPU run at 64² untraced and traced:
    every end-to-end metric, and the per-layer metrics that need no device
    (the roofline shares and the rounds' device time read nothing where no
    operation ran on a device)."""
    cell = harness.load_cell(CELL)
    assert {m["name"] for m in cell.end_to_end} == {
        "frames_per_s.host_paced", "setup_s"}
    per_layer = {m["name"] for m in cell.per_layer}
    assert per_layer == {
        "g_a_roofline.host_paced", "g_s_roofline.host_paced",
        "step_mfu.host_paced", "device_idle_pct.host_paced",
        "host_coder_ms_per_step.host_paced",
        "ar_device_ms_per_step.host_paced"}
    assert cell.chips == 1 and cell.traffic["streams"] == 4
    small = _small_cell()
    out = harness.run(small, SEED, 0.3, False, device="cpu",
                      log=lambda *a: None)
    assert out["correct"] and set(out["metrics"]) == {
        "frames_per_s.host_paced", "setup_s"}
    out = harness.run(small, SEED, 0.3, True, device="cpu",
                      log=lambda *a: None)
    assert out["correct"] and set(out["metrics"]) == {
        "step_mfu.host_paced", "device_idle_pct.host_paced",
        "host_coder_ms_per_step.host_paced"}
    assert out["metrics"]["host_coder_ms_per_step.host_paced"]["value"] > 0


def test_a_port_without_the_timed_g_a_is_refused(monkeypatch):
    """The parent port lacks ``_analysis_streams``: the cell is refused as
    it loads, before any work."""
    from spatiotemporalentropymodel_tpu_torch.models import priors

    monkeypatch.delattr(priors.JointAutoregressiveHierarchicalPriors,
                        "_analysis_streams")
    with pytest.raises(SystemExit, match="_analysis_streams"):
        harness.load_cell(CELL)


def test_the_reference_imports_nothing_of_the_port():
    code = (
        "import sys\n"
        "from portbench import harness, reference_cheng2020\n"
        "for kind, name in (('weights', 'cheng2020_seeded'),\n"
        "                   ('judges', 'image_serve'),\n"
        "                   ('metrics', 'ar_device_ms_per_step')):\n"
        "    harness.find(kind, name)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}\n"
        "             & {'spatiotemporalentropymodel_tpu_torch',\n"
        "                *harness.FORBIDDEN}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
