"""The operation counts behind step_mfu and the rooflines against
torch.utils.flop_counter on the reference's served step."""

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import harness, peaks
from portbench import judge as J
from portbench import reference as R
from portbench import workload as WL

HW = (64, 128)
PJ = harness.find("judges", "parallel_serve")
WJ = harness.find("judges", "wavefront_serve")


def _models(cfg, seed=4):
    gen = torch.Generator().manual_seed(seed)
    I = WL.draw(WL.i_model_specs(cfg["N"], cfg["M"]), gen, "cpu")
    S = WL.draw(WL.stem_specs(cfg["variant"],
                              cfg["entropy_bottleneck_channels"], cfg["M"]),
                gen, "cpu")
    WL.realistic_stem(S, np.random.default_rng(seed))
    return J.Ref(I, S, cfg)


def _served_parallel(ref, x, y_cond):
    """Encoder (g_a, HE, priors, EPM) and decoder (priors, EPM, g_s)."""
    y = R.g_a(ref.I, x)
    z_sym, mu, sym, idx, y_hat = PJ.parallel_encode(ref, y, y_cond)
    R.epm(ref.S, R.priors(ref.S, z_sym + ref.med32, y_cond))
    R.g_s(ref.I, y_hat)


def _served_wavefront(ref, x, y_cond):
    """Encoder (g_a, then HE, priors and the rounds per picture) and
    decoder (priors and the rounds per picture, g_s)."""
    y = R.g_a(ref.I, x)
    _, _, y_hat, _ = WJ.wavefront_encode(ref, y, y_cond)
    th, tw = ref.cfg["wavefront_tile"]
    b, _, h, w = y.shape
    z_hat = torch.zeros((1, ref.cfg["entropy_bottleneck_channels"],
                         (h + 3) // 4, (w + 3) // 4))
    for i in range(b):
        pri = WJ._tile(R.priors(ref.S, z_hat, y_cond[i:i + 1]), th, tw)
        ar = WJ._AR(ref, pri, R.F32)
        for pixels in WJ._rounds(th, tw):
            ar.params(pixels)
    R.g_s(ref.I, y_hat)


@pytest.mark.parametrize("config", ["stem_without_spm_192", "stem_res_192"])
def test_served_picture_operations(config):
    cell = harness.load_cell({"stem_without_spm_192":
                              "without_spm_192.serve_f32",
                              "stem_res_192": "res_192.serve_f32"}[config])
    cfg = cell.cfg
    ref = _models(cfg)
    b = 2
    x = torch.rand((b, 3, *HW))
    y_cond = torch.round(torch.randn((b, cfg["M"], HW[0] // 16, HW[1] // 16)))
    served = _served_wavefront if cfg["variant"] == "res" else \
        _served_parallel
    with torch.no_grad(), FlopCounterMode(display=False) as fc:
        served(ref, x, y_cond)
    assert fc.get_total_flops() == peaks.picture_ops(cfg, HW, True) * b


def test_transform_bounds():
    for dtype in ("float32", "bfloat16"):
        for layers in (peaks.g_a_layers(192, 192, 1088, 1920),
                       peaks.g_s_layers(192, 192, 68, 120)):
            t = peaks.transform_bound_s(layers, 4, 3 * 1088 * 1920 + 192 * 68
                                        * 120, dtype)
            assert 0 < t < 0.1
    # the f32 convs alone on the CUDA cores bound the f32 transform
    ops = peaks.g_a_layers(192, 192, 1088, 1920)[0]
    assert peaks.transform_bound_s(peaks.g_a_layers(192, 192, 1088, 1920), 1,
                                   0, "float32") >= ops / peaks.F32_FLOPS_PER_S
