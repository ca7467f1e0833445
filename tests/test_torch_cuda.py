"""The port's CUDA kernels against their plain PyTorch versions, on the card:
forward, gradients, and the bf16 slice with the kernels against the same
slice with every wrapper replaced by its plain version.

Marked ``cuda``: they skip without one. This file imports neither jax nor
the JAX package, so it also runs on a machine that has only PyTorch:
``python -m pytest -m cuda tests/test_torch_cuda.py``.

The fused bf16 kernels round the (I)GDN'd window to bf16 for the tensor
cores, as the TPU kernels do, while the plain versions of the g_s pair keep
it in f32 (pallas_kernels.py::_igdn_deconv_ref), and all sum in f32 in
another order. That error grows with the output's magnitude, so each fused
kernel is held to its plain version at max|out − plain| ≤ 2⁻⁶·max|plain|,
and to the same arithmetic with the window rounded to bf16 (what the kernel
computes) at ≤ 2⁻⁸·max|plain|: one bf16 step of the largest output. The
bf16 ``gdn_fused`` differs from its plain version only in the f32 summation
order and in γ, kept to 2⁻¹⁶ in two bf16 pieces, so by at most one bf16
step: rtol 2⁻⁷.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spatiotemporalentropymodel_tpu_torch.entropy import get_scale_table
from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
    StemVideoPipeline,
    WavefrontVideoPipeline,
)
from spatiotemporalentropymodel_tpu_torch.eval.workload import (
    match_latent_to_prior,
    realistic_stem,
    wavefront_y_cur,
)
from spatiotemporalentropymodel_tpu_torch.models import (
    MeanScaleHyperprior,
    SpatioTemporalPriorModel,
)
from spatiotemporalentropymodel_tpu_torch.models import ar_wavefront as wf
from spatiotemporalentropymodel_tpu_torch.models.base import _nchw
from spatiotemporalentropymodel_tpu_torch.ops import kernels


@pytest.fixture
def cuda(monkeypatch):
    """The card, with the plain versions' f32 convs and products in full
    f32 (no TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs the same "
                    "checks at the serving shapes)")
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _edge_inputs(device, shape=(2, 64, 8, 8), seed=4):
    """(y, μ, σ) with y−μ on ±k.5 ties and beyond ±2³⁰, and σ on, just below
    and just above every f32 table entry and 0.11."""
    rng = np.random.default_rng(seed)
    t32 = get_scale_table().astype(np.float32)
    means = (2 * rng.standard_normal(shape)).astype(np.float32)
    y = (means + 3 * rng.standard_normal(shape)).astype(np.float32)
    scales = np.exp(4 * rng.random(shape) - 3).astype(np.float32)
    yf, mf, sf = y.reshape(-1), means.reshape(-1), scales.reshape(-1)
    ties = np.arange(-20, 21, dtype=np.float32) + 0.5
    mf[:ties.size], yf[:ties.size] = 0.0, ties
    big = np.array([3e9, -3e9, 2.0**30 + 128, -(2.0**30) - 128], np.float32)
    o = ties.size
    mf[o:o + big.size], yf[o:o + big.size] = 0.0, big
    edges = np.concatenate([
        t32, np.nextafter(t32, np.float32(-1)),
        np.nextafter(t32, np.float32(1e9)),
        np.array([0.11, 0.0, -1.0, 0.05], np.float32),
        np.nextafter(np.float32(0.11), np.float32(1))[None],
    ]).astype(np.float32)
    sf[:edges.size] = edges
    return [torch.from_numpy(a).to(device) for a in (y, means, scales)]


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(cuda):
    """Both kernels against their plain versions (gdn rtol 1e-5,
    quantize_and_index exact), and each launch counted."""
    y, means, scales = _edge_inputs(cuda)
    t = kernels.scale_table_tensor(get_scale_table(), cuda)
    n0 = dict(kernels.LAUNCHES)
    sym, idx = kernels.quantize_and_index(y, means, scales, t)
    rs, ri = kernels._qidx_ref(y, means, scales, t, 0.11)
    assert torch.equal(sym, rs) and torch.equal(idx, ri)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 192, 24, 40)).astype(
        np.float32)).to(cuda)
    gt = torch.from_numpy((0.02 * rng.random((192, 192))
                           + 0.1 * np.eye(192)).astype(np.float32)).to(cuda)
    beta = torch.ones(192, device=cuda)
    for inverse in (False, True):
        out = kernels.gdn_fused(x, gt, beta, inverse)
        ref = kernels._gdn_ref(x, gt, beta, inverse)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
    assert kernels.LAUNCHES["gdn_fused"] == n0["gdn_fused"] + 2
    assert (kernels.LAUNCHES["quantize_and_index"]
            == n0["quantize_and_index"] + 1)


@pytest.mark.cuda
def test_cuda_wrappers_reject_bad_inputs(cuda):
    """On a CUDA tensor a wrapper launches or raises, never runs the plain
    version: wrong dtype, non-contiguous input and a wrong γ shape raise."""
    x = torch.randn((1, 8, 4, 4), device=cuda)
    g = torch.eye(8, device=cuda)
    b = torch.ones(8, device=cuda)
    n0 = dict(kernels.LAUNCHES)
    with pytest.raises(TypeError):
        kernels.gdn_fused(x.double(), g.double(), b.double())
    with pytest.raises(ValueError):
        kernels.gdn_fused(x.transpose(2, 3), g, b)
    with pytest.raises(ValueError):
        kernels.gdn_fused(x, torch.eye(4, device=cuda), b)
    assert kernels.LAUNCHES == n0


QIDX_ENTRY = {torch.float32: "quantize_and_index",
              torch.bfloat16: "quantize_and_index_bf16"}


def _qidx_table(size):
    """A non-decreasing table of ``size`` entries: the scale table at 64,
    else log-spaced random entries with one repeated."""
    if size == 64:
        return get_scale_table().astype(np.float32)
    rng = np.random.default_rng(size)
    t = np.sort(np.exp(rng.uniform(np.log(0.05), np.log(300.0), size)))
    t = t.astype(np.float32)
    if size > 4:
        t[size // 2] = t[size // 2 - 1]
    return t


def _qidx_crafted(table, shape, dtype, seed=7):
    """(y, μ, σ) NCHW on the CPU in ``dtype``: y − μ on ±k.5 ties and beyond
    ±2³⁰, σ on every table entry (rounded to dtype), one step of dtype
    either side of it, the bound, 0 and −1; then shuffled, so the crafted
    values land in every row, head, vector and tail."""
    rng = np.random.default_rng(seed)
    means = (2 * rng.standard_normal(shape)).astype(np.float32)
    y = (means + 3 * rng.standard_normal(shape)).astype(np.float32)
    scales = np.exp(rng.uniform(np.log(0.05), np.log(2 * table.max()),
                                shape)).astype(np.float32)
    yt, mt, st = (torch.from_numpy(a).to(dtype) for a in (y, means, scales))
    yf, mf, sf = (t.view(-1) for t in (yt, mt, st))
    special = torch.cat([torch.arange(-20, 21) + 0.5, torch.tensor(
        [3e9, -3e9, 2.0**30 + 128, -(2.0**30) - 128, 1e38])]).to(dtype)
    mf[:special.numel()], yf[:special.numel()] = 0, special
    t = torch.from_numpy(table).to(dtype)
    if dtype == torch.bfloat16:  # positive: ±1 in the bits is ±1 step
        lo = (t.view(torch.int16) - 1).view(dtype)
        hi = (t.view(torch.int16) + 1).view(dtype)
    else:
        lo = torch.nextafter(t, torch.full_like(t, -np.inf))
        hi = torch.nextafter(t, torch.full_like(t, np.inf))
    edges = torch.cat([t, lo, hi, torch.tensor([0.11, 0.0, -1.0]).to(dtype)])
    assert edges.numel() <= sf.numel()
    sf[:edges.numel()] = edges
    perm = torch.from_numpy(rng.permutation(yf.numel()))
    return [v[perm].view(shape) for v in (yf, mf, sf)]


def _qidx_layout(case, y, means, scales, device):
    """The three inputs on the card in the case's layout."""
    if case == "halves":  # chunk's halves of one (B, 2C, H, W) tensor
        both = torch.cat([scales, means], dim=1).to(device)
        s_half, m_half = both.chunk(2, dim=1)
        return y.to(device), m_half, s_half
    if case == "row_heads":  # [:, :C] of (B, C + 8, H, W): rows off phase
        out = []
        for t in (y, means, scales):
            big = torch.full((t.shape[0], t.shape[1] + 8, *t.shape[2:]),
                             float("nan"), dtype=t.dtype)
            big[:, :t.shape[1]] = t
            out.append(big.to(device)[:, :t.shape[1]])
        return out
    if case == "misaligned":  # 1, 2, 3 elements past a 16-byte boundary
        out = []
        for k, t in zip((1, 2, 3), (y, means, scales)):
            flat = torch.empty(t.numel() + k, dtype=t.dtype, device=device)
            flat[k:] = t.reshape(-1).to(device)
            out.append(flat[k:].view(t.shape))
        return out
    return [t.to(device) for t in (y, means, scales)]


QIDX_CASES = {
    "contiguous": (2, 64, 8, 8),
    "odd": (3, 5, 7, 9),  # 945 elements: vectors and a tail
    "halves": (4, 16, 8, 12),
    "odd_halves": (2, 13, 7, 9),  # rows whose inputs' phases differ
    "row_heads": (3, 5, 7, 9),  # rows 1, 2 start mid-vector: scalar heads
    "misaligned": (2, 8, 9, 7),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(QIDX_CASES))
@pytest.mark.parametrize("table_size", [2, 64, 256])
def test_cuda_quantize_and_index_exact(cuda, dtype, case, table_size):
    """Each entry of quantize_and_index equals ``_qidx_ref`` bit for bit on
    crafted inputs, in every layout the wrapper reads without a copy and
    off 16-byte alignment, and launches once, under its own name."""
    table = _qidx_table(table_size)
    layout = "halves" if case == "odd_halves" else case
    y, means, scales = _qidx_layout(
        layout, *_qidx_crafted(table, QIDX_CASES[case], dtype), cuda)
    t = kernels.scale_table_tensor(table, cuda)
    n0 = dict(kernels.LAUNCHES)
    sym, idx = kernels.quantize_and_index(y, means, scales, t)
    rs, ri = kernels._qidx_plain(y, means, scales, t, 0.11)
    assert torch.equal(sym, rs) and torch.equal(idx, ri)
    want = dict(n0)
    want[QIDX_ENTRY[dtype]] += 1
    assert kernels.LAUNCHES == want


@pytest.mark.cuda
def test_cuda_quantize_and_index_rejects_bad_inputs(cuda):
    """Mixed or other dtypes, mismatched shapes, a table off the card or of
    more than 256 entries: each raises, and nothing launches."""
    x = torch.randn((2, 8, 4, 4), device=cuda)
    t = kernels.scale_table_tensor(get_scale_table(), cuda)
    n0 = dict(kernels.LAUNCHES)
    with pytest.raises(TypeError):
        kernels.quantize_and_index(x, x.to(torch.bfloat16), x, t)
    with pytest.raises(TypeError):
        kernels.quantize_and_index(x.half(), x.half(), x.half(), t)
    with pytest.raises(ValueError):
        kernels.quantize_and_index(x, x[:1], x, t)
    with pytest.raises(ValueError):
        kernels.quantize_and_index(x, x, x, t.cpu())
    with pytest.raises(ValueError):
        kernels.quantize_and_index(x, x, x, torch.arange(
            257, dtype=torch.float32, device=cuda))
    assert kernels.LAUNCHES == n0


PLAIN_TOL, WINDOW_TOL = 2**-6, 2**-8


def _assert_scaled_close(out, ref, tol):
    err = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    assert err <= tol * scale, f"max err {err} > {tol} × max|ref| {scale}"


def _assert_within_top_step(out, ref):
    """max|out − ref| within one bf16 step of ref's largest magnitude,
    2^(⌊log2 max|ref|⌋ − 7): what WINDOW_TOL's 2⁻⁸·max|ref| stands for,
    which it equals only for a maximum at the top of its binade (half
    the step at the bottom)."""
    err = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    step = 2.0 ** (np.floor(np.log2(scale)) - 7)
    assert err <= step, f"max err {err} > one bf16 step {step} at {scale}"


def _window_bf16_conv(x, gt, beta, inverse, conv):
    """The kernels' rounding points: (I)GDN in f32 rounded to bf16, then the
    conv in f32 (``conv`` on the f32 window), then bf16."""
    g = kernels._gdn_ref(x.float(), gt, beta, inverse).to(torch.bfloat16)
    return conv(g.float()).to(torch.bfloat16)


def _gdn_params(rng, c, device):
    gt = (0.02 * rng.random((c, c)) + 0.1 * np.eye(c)).astype(np.float32)
    beta = (1.0 + rng.random(c)).astype(np.float32)
    return (torch.from_numpy(gt).to(device), torch.from_numpy(beta).to(device))


def _bf16(rng, shape, device, scale=1.0):
    a = (scale * rng.standard_normal(shape)).astype(np.float32)
    return torch.from_numpy(a).to(device).to(torch.bfloat16)


@pytest.mark.cuda
def test_cuda_gdn_fused_bf16_matches_plain(cuda):
    rng = np.random.default_rng(6)
    x = _bf16(rng, (2, 192, 24, 40), cuda)
    gt, beta = _gdn_params(rng, 192, cuda)
    n0 = dict(kernels.LAUNCHES)
    for inverse in (False, True):
        out = kernels.gdn_fused(x, gt, beta, inverse)
        ref = kernels._gdn_ref(x.float(), gt, beta, inverse).to(x.dtype)
        assert out.dtype == torch.bfloat16
        torch.testing.assert_close(out.float(), ref.float(), rtol=2**-7,
                                   atol=1e-6)
    assert kernels.LAUNCHES["gdn_fused_bf16"] == n0["gdn_fused_bf16"] + 2
    assert kernels.LAUNCHES["gdn_fused"] == n0["gdn_fused"]


def _wide_range_f32(rng, shape, device):
    """f32 x whose pixels span 10⁻¹..10^1.5 in magnitude (see
    _wide_range)."""
    scale = 10.0 ** rng.uniform(-1.0, 1.5, (shape[0], 1) + tuple(shape[2:]))
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 96, 128, 192])
@pytest.mark.parametrize("hw", [(24, 40), (5, 12), (9, 13)])
def test_cuda_gdn_fused_widths_and_dynamic_range(cuda, c, hw):
    """Both entries, forward and inverse, at C = 64, 128 and 192 (96 runs
    zero-padded to 128), on x over two and a half decades (x²·γ dominates
    β, so the tensor-core norm must keep f32 accuracy), with P a multiple
    of 8 (the 16-byte loads and stores), of 4 but not 8, and odd (partial
    tiles and the 2- or 4-byte paths): f32 at rtol 1e-5, atol 1e-6, bf16
    at rtol 2⁻⁷."""
    rng = np.random.default_rng(c + hw[1])
    x = _wide_range_f32(rng, (2, c) + hw, cuda)
    gt, beta = _gdn_params(rng, c, cuda)
    n0 = dict(kernels.LAUNCHES)
    for inverse in (False, True):
        out = kernels.gdn_fused(x, gt, beta, inverse)
        ref = kernels._gdn_ref(x, gt, beta, inverse)
        assert out.shape == x.shape and out.dtype == torch.float32
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
        xb = x.to(torch.bfloat16)
        out = kernels.gdn_fused(xb, gt, beta, inverse)
        ref = kernels._gdn_ref(xb.float(), gt, beta, inverse).to(xb.dtype)
        assert out.shape == x.shape and out.dtype == torch.bfloat16
        torch.testing.assert_close(out.float(), ref.float(), rtol=2**-7,
                                   atol=1e-6)
    assert kernels.LAUNCHES["gdn_fused"] == n0["gdn_fused"] + 2
    assert kernels.LAUNCHES["gdn_fused_bf16"] == n0["gdn_fused_bf16"] + 2


def _wide_range(rng, shape, device):
    """bf16 x whose pixels span 10⁻¹..10^1.5 in magnitude, so x²·γ dominates
    β at most pixels: the norm's dynamic range is what the kernels' split
    bf16 products must keep at f32 accuracy."""
    scale = 10.0 ** rng.uniform(-1.0, 1.5, (shape[0], 1) + tuple(shape[2:]))
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return torch.from_numpy(a).to(device).to(torch.bfloat16)


def _check_gdn_conv(cuda, c, h, w, wide_range=False, o=None,
                    window_step=False):
    o = c if o is None else o
    rng = np.random.default_rng(c + h)
    x = (_wide_range(rng, (2, c, h, w), cuda) if wide_range
         else _bf16(rng, (2, c, h, w), cuda))
    gt, beta = _gdn_params(rng, c, cuda)
    weight = _bf16(rng, (o, c, 5, 5), cuda, 0.05)
    bias = torch.from_numpy(rng.standard_normal(o).astype(np.float32)).to(
        cuda)
    n0 = kernels.LAUNCHES["gdn_conv_fused"]
    out = kernels.gdn_conv_fused(x, gt, beta, weight, bias)
    ref = kernels._gdn_conv_ref(x, gt, beta, weight, bias)
    win = _window_bf16_conv(x, gt, beta, False, lambda g: F.conv2d(
        g, weight.float(), bias, 2, 2))
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (2, o, (h + 1) // 2, (w + 1) // 2)
    _assert_scaled_close(out, ref, PLAIN_TOL)
    if window_step:
        _assert_within_top_step(out, win)
    else:
        _assert_scaled_close(out, win, WINDOW_TOL)
    assert kernels.LAUNCHES["gdn_conv_fused"] == n0 + 1


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,w", [(64, 26, 38), (192, 17, 35),
                                   (128, 21, 48), (128, 9, 35),
                                   (192, 20, 72), (64, 8, 32)])
def test_cuda_gdn_conv_fused_matches_plain(cuda, c, h, w):
    """C = 64, 128 and 192; partial 4 × 16 output tiles on the bottom and
    right edges with W a multiple of 8 (the 16-byte window load) and not
    (the 2-byte gather), and whole tiles only (8 × 32 → 4 × 16)."""
    _check_gdn_conv(cuda, c, h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,wide_range", [(17, 35, False),
                                            (20, 72, False),
                                            (20, 72, True)])
def test_cuda_gdn_conv_fused_128_to_192(cuda, h, w, wide_range):
    """C = 128 → O = 192, g_a's last stage of the hero I-model (N = 128,
    M = 192): a ring slot of O rows for the weights and C for γ."""
    assert kernels.gdn_conv_supported(128, 192)
    _check_gdn_conv(cuda, 128, h, w, wide_range, o=192)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,wide_range", [(17, 35, False),
                                            (20, 72, False),
                                            (20, 72, True),
                                            (136, 240, False)])
def test_cuda_gdn_conv_fused_192_to_320(cuda, h, w, wide_range):
    """C = 192 → O = 320, g_a's last stage of the zoo's N = 192, M = 320
    models (mbt2018 at quality 5-8): O split across two blocks of 160
    channels, each normalising the window itself; partial edge tiles, whole
    tiles, and the mbt2018 1080p stage's 136 × 240. Against the window's
    arithmetic the outputs are held to one bf16 step of the largest: at
    17 × 35 an output near 8.8 rounds the other way (0.0625 apart, one
    step there), more than 2⁻⁸·max|plain| = 0.034, which is one step only
    for a maximum at the top of its binade."""
    assert kernels.gdn_conv_supported(192, 320)
    _check_gdn_conv(cuda, 192, h, w, wide_range, o=320, window_step=True)


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,w", [(192, 20, 72), (128, 17, 35)])
def test_cuda_gdn_conv_fused_wide_dynamic_range(cuda, c, h, w):
    """x over two and a half decades, so x²·γ dominates β: the tensor-core
    norm keeps the plain version's f32 accuracy."""
    _check_gdn_conv(cuda, c, h, w, wide_range=True)


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,w", [(64, 12, 40), (192, 9, 33)])
def test_cuda_igdn_deconv_pair_matches_plain(cuda, c, h, w):
    """The wide N→N kernel, then the tail N→3 kernel on its output, each
    against the plain version on the same input."""
    rng = np.random.default_rng(c + w)
    x = _bf16(rng, (2, c, h, w), cuda)
    g1, b1 = _gdn_params(rng, c, cuda)
    g2, b2 = _gdn_params(rng, c, cuda)
    w1 = _bf16(rng, (c, c, 5, 5), cuda, 0.05)
    w2 = _bf16(rng, (c, 3, 5, 5), cuda, 0.05)
    s1 = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(cuda)
    s2 = torch.from_numpy(rng.standard_normal(3).astype(np.float32)).to(cuda)
    n0 = dict(kernels.LAUNCHES)
    mid = kernels.igdn_deconv_wide_packed(x, g1, b1, w1, s1)
    mid_ref = kernels._igdn_deconv_ref(x, g1, b1, w1, s1)
    out = kernels.igdn_deconv_tail_packed(mid, g2, b2, w2, s2)
    ref = kernels._igdn_deconv_ref(mid, g2, b2, w2, s2)
    mid_win = _window_bf16_conv(x, g1, b1, True, lambda g: F.conv_transpose2d(
        g, w1.float(), s1, 2, 2, 1))
    win = _window_bf16_conv(mid, g2, b2, True, lambda g: F.conv_transpose2d(
        g, w2.float(), s2, 2, 2, 1))
    torch.cuda.synchronize()
    assert mid.shape == (2, c, 2 * h, 2 * w)
    assert out.shape == (2, 3, 4 * h, 4 * w)
    _assert_scaled_close(mid, mid_ref, PLAIN_TOL)
    _assert_scaled_close(mid, mid_win, WINDOW_TOL)
    _assert_scaled_close(out, ref, PLAIN_TOL)
    _assert_scaled_close(out, win, WINDOW_TOL)
    assert (kernels.LAUNCHES["igdn_deconv_wide_packed"]
            == n0["igdn_deconv_wide_packed"] + 1)
    assert (kernels.LAUNCHES["igdn_deconv_tail_packed"]
            == n0["igdn_deconv_tail_packed"] + 1)


@pytest.mark.cuda
def test_cuda_fused_wrappers_reject_bad_inputs(cuda):
    """Wrong dtype, shape, width or device raises; nothing launches and
    nothing runs the plain version instead."""
    rng = np.random.default_rng(8)
    x = _bf16(rng, (1, 64, 8, 8), cuda)
    gt, beta = _gdn_params(rng, 64, cuda)
    wc = _bf16(rng, (64, 64, 5, 5), cuda)
    bias = torch.zeros(64, device=cuda)
    tail_w = _bf16(rng, (64, 3, 5, 5), cuda)
    n0 = dict(kernels.LAUNCHES)
    for fn, w_ok, b_ok in ((kernels.gdn_conv_fused, wc, bias),
                           (kernels.igdn_deconv_wide_packed, wc, bias),
                           (kernels.igdn_deconv_wide, wc, bias),
                           (kernels.igdn_deconv_tail_packed, tail_w,
                            bias[:3]),
                           (kernels.igdn_deconv_fused, tail_w, bias[:3])):
        with pytest.raises(TypeError):
            fn(x.float(), gt, beta, w_ok, b_ok)
        with pytest.raises(TypeError):
            fn(x, gt, beta, w_ok.float(), b_ok)
        with pytest.raises(ValueError):
            fn(x.transpose(2, 3), gt, beta, w_ok, b_ok)
        with pytest.raises(ValueError):
            fn(x, gt[:32, :32].contiguous(), beta, w_ok, b_ok)
        with pytest.raises(ValueError):
            fn(x, gt, beta, w_ok.cpu(), b_ok)
    with pytest.raises(ValueError):  # no kernel for 48 channels
        x48 = _bf16(rng, (1, 48, 8, 8), cuda)
        g48, b48 = _gdn_params(rng, 48, cuda)
        kernels.gdn_conv_fused(x48, g48, b48, _bf16(rng, (48, 48, 5, 5), cuda),
                               torch.zeros(48, device=cuda))
    with pytest.raises(ValueError):  # the tail takes at most 4 outputs
        kernels.igdn_deconv_tail_packed(x, gt, beta,
                                        _bf16(rng, (64, 8, 5, 5), cuda),
                                        torch.zeros(8, device=cuda))
    with pytest.raises(ValueError):  # the narrow kernel takes at most 32
        kernels.igdn_deconv_fused(x, gt, beta,
                                  _bf16(rng, (64, 33, 5, 5), cuda),
                                  torch.zeros(33, device=cuda))
    with pytest.raises(TypeError):  # bf16 gdn_fused needs f32 γᵀ and β
        kernels.gdn_fused(x, gt.to(torch.bfloat16), beta)
    assert kernels.LAUNCHES == n0


def _check_narrow(cuda, c, f, h, w, wide_range=False, window_step=False):
    rng = np.random.default_rng(10 * c + f)
    x = (_wide_range(rng, (2, c, h, w), cuda) if wide_range
         else _bf16(rng, (2, c, h, w), cuda))
    gt, beta = _gdn_params(rng, c, cuda)
    weight = _bf16(rng, (c, f, 5, 5), cuda, 0.05)
    bias = torch.from_numpy(rng.standard_normal(f).astype(np.float32)).to(
        cuda)
    n0 = dict(kernels.LAUNCHES)
    out = kernels.igdn_deconv_fused(x, gt, beta, weight, bias)
    ref = kernels._igdn_deconv_ref(x, gt, beta, weight, bias)
    win = _window_bf16_conv(x, gt, beta, True, lambda g: F.conv_transpose2d(
        g, weight.float(), bias, 2, 2, 1))
    torch.cuda.synchronize()
    assert out.shape == (2, f, 2 * h, 2 * w)
    _assert_scaled_close(out, ref, PLAIN_TOL)
    if window_step:
        _assert_within_top_step(out, win)
    else:
        _assert_scaled_close(out, win, WINDOW_TOL)
    assert (kernels.LAUNCHES["igdn_deconv_fused"]
            == n0["igdn_deconv_fused"] + 1)
    assert (kernels.LAUNCHES["igdn_deconv_tail_packed"]
            == n0["igdn_deconv_tail_packed"])


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 128, 192])
@pytest.mark.parametrize("f", [3, 8, 32])
def test_cuda_igdn_deconv_fused_matches_plain(cuda, c, f):
    """The narrow kernel at 16, 32 and 128 GEMM rows (F = 3, 8, 32), at
    17 × 30: partial tiles on the bottom and right edges, W not a multiple
    of 8 (the 2-byte window gather)."""
    _check_narrow(cuda, c, f, 17, 30)


@pytest.mark.cuda
@pytest.mark.parametrize("c,f,h,w", [(192, 3, 16, 64), (128, 20, 9, 40),
                                     (64, 12, 13, 33)])
def test_cuda_igdn_deconv_fused_dynamic_range(cuda, c, f, h, w):
    """x over two and a half decades, so x²·γ dominates β in the IGDN, at
    16, 96 and 64 GEMM rows, with whole tiles and W a multiple of 8 (the
    16-byte window load) and partial ones."""
    _check_narrow(cuda, c, f, h, w, wide_range=True)


def _check_wide(cuda, c, b, h, w, wide_range=False, window_step=False):
    rng = np.random.default_rng(h + w)
    x = (_wide_range(rng, (b, c, h, w), cuda) if wide_range
         else _bf16(rng, (b, c, h, w), cuda))
    gt, beta = _gdn_params(rng, c, cuda)
    weight = _bf16(rng, (c, c, 5, 5), cuda, 0.05)
    bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(
        cuda)
    n0 = dict(kernels.LAUNCHES)
    out = kernels.igdn_deconv_wide(x, gt, beta, weight, bias)
    ref = kernels._igdn_deconv_ref(x, gt, beta, weight, bias)
    win = _window_bf16_conv(x, gt, beta, True, lambda g: F.conv_transpose2d(
        g, weight.float(), bias, 2, 2, 1))
    torch.cuda.synchronize()
    assert out.shape == (b, c, 2 * h, 2 * w)
    _assert_scaled_close(out, ref, PLAIN_TOL)
    if window_step:
        _assert_within_top_step(out, win)
    else:
        _assert_scaled_close(out, win, WINDOW_TOL)
    assert kernels.LAUNCHES["igdn_deconv_wide"] == n0["igdn_deconv_wide"] + 1
    assert (kernels.LAUNCHES["igdn_deconv_wide_packed"]
            == n0["igdn_deconv_wide_packed"])


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(2, 17, 30), (1, 136, 240)])
def test_cuda_igdn_deconv_wide_matches_plain(cuda, b, h, w):
    """The lone wide kernel at C = O = 192: a ragged 17 × 30 input, and the
    wide chain's first stage, 136 × 240 (240 columns = 7.5 tiles)."""
    _check_wide(cuda, 192, b, h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,w", [(128, 13, 40), (64, 6, 24),
                                   (192, 16, 64)])
def test_cuda_igdn_deconv_wide_widths_and_edge_tiles(cuda, c, h, w):
    """C = 64 and 128; partial 8 × 32 input tiles on both edges with W a
    multiple of 8 (13 rows: the second pass of 4 rows runs past the
    image), a tile taller than the image, and whole tiles only."""
    _check_wide(cuda, c, 2, h, w)


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,w", [(192, 13, 40), (128, 9, 33)])
def test_cuda_igdn_deconv_wide_dynamic_range(cuda, c, h, w):
    """x over two and a half decades, so x²·γ dominates β in the IGDN."""
    _check_wide(cuda, c, 2, h, w, wide_range=True)



@pytest.mark.cuda
@pytest.mark.parametrize("c", [200, 256, 320, 384, 512])
@pytest.mark.parametrize("hw", [(24, 40), (9, 13)])
def test_cuda_gdn_fused_past_192_channels(cuda, c, hw):
    """gdn_fused past 192 channels: the norm in chunks of output channels
    (two of 128 at 256; 128 + 128 + 64 at 320 in f32; 6 × 64 at 384 in
    f32; 512 f32 without a window, x read from device memory; 200 runs
    zero-padded to 256), both entries, forward and inverse, on x over two
    and a half decades, with P a multiple of 8 and odd (partial tiles):
    f32 at rtol 1e-5, atol 1e-6, bf16 at rtol 2⁻⁷. Each launch counted at
    its width."""
    rng = np.random.default_rng(c + hw[1])
    x = _wide_range_f32(rng, (2, c) + hw, cuda)
    gt, beta = _gdn_params(rng, c, cuda)
    kernels.reset_launch_counts()
    for inverse in (False, True):
        out = kernels.gdn_fused(x, gt, beta, inverse)
        ref = kernels._gdn_ref(x, gt, beta, inverse)
        assert out.shape == x.shape and out.dtype == torch.float32
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-6)
        xb = x.to(torch.bfloat16)
        out = kernels.gdn_fused(xb, gt, beta, inverse)
        ref = kernels._gdn_ref(xb.float(), gt, beta, inverse).to(xb.dtype)
        assert out.shape == x.shape and out.dtype == torch.bfloat16
        torch.testing.assert_close(out.float(), ref.float(), rtol=2**-7,
                                   atol=1e-6)
    assert kernels.LAUNCHES_BY_WIDTH == {("gdn_fused", c): 2,
                                         ("gdn_fused_bf16", c): 2}


@pytest.mark.cuda
@pytest.mark.parametrize("c,p", [(64, 3), (192, 8)])
def test_cuda_gdn_fused_batch_past_65535(cuda, c, p):
    """A batch of 65,600 items (past the 65,535 a grid's y dimension
    takes): the batch is folded into the grid's x dimension, both
    entries, against the plain version."""
    rng = np.random.default_rng(c)
    x = torch.from_numpy((rng.standard_normal((65600, c, 1, p))).astype(
        np.float32)).to(cuda)
    gt, beta = _gdn_params(rng, c, cuda)
    for inverse in (False, True):
        out = kernels.gdn_fused(x, gt, beta, inverse)
        torch.testing.assert_close(out, kernels._gdn_ref(x, gt, beta,
                                                         inverse),
                                   rtol=1e-5, atol=1e-6)
        xb = x.to(torch.bfloat16)
        out = kernels.gdn_fused(xb, gt, beta, inverse)
        ref = kernels._gdn_ref(xb.float(), gt, beta, inverse).to(xb.dtype)
        torch.testing.assert_close(out.float(), ref.float(), rtol=2**-7,
                                   atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("o,h,w,wide_range", [
    (256, 17, 35, False), (256, 20, 72, True), (256, 68, 120, False),
    (320, 17, 35, False), (320, 20, 72, True), (320, 34, 60, False)])
def test_cuda_gdn_conv_fused_256(cuda, o, h, w, wide_range):
    """C = 256 → O = 256 and 320 (g_a of MeanScaleHyperprior(256, 320)):
    tiles of 4 × 14 and 4 × 13 output pixels, O in two groups of 128 and
    160 over one window, the norm in two chunks of 128; partial edge
    tiles, W a multiple of 8 and not, and x over two and a half decades.
    Against the window's arithmetic within one bf16 step of the largest
    output, as at 192 → 320."""
    assert kernels.gdn_conv_supported(256, o)
    _check_gdn_conv(cuda, 256, h, w, wide_range, o=o, window_step=True)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(9, 33), (17, 64)])
def test_cuda_igdn_deconv_pair_256(cuda, h, w):
    """The packed g_s pair at C = 256: the wide kernel (O in two groups of
    128) then the tail (N → 3) on its output, each against its plain
    version, with partial and whole 8 × 32 input tiles; against the
    window's arithmetic within one bf16 step of the largest output, as at
    192 → 320 (at 17 × 64 an output of 25.125 lies 0.125 off, one step
    there, above 2⁻⁸·max|ref| = 0.098)."""
    rng = np.random.default_rng(256 + w)
    c = 256
    x = _bf16(rng, (2, c, h, w), cuda)
    g1, b1 = _gdn_params(rng, c, cuda)
    g2, b2 = _gdn_params(rng, c, cuda)
    w1 = _bf16(rng, (c, c, 5, 5), cuda, 0.05)
    w2 = _bf16(rng, (c, 3, 5, 5), cuda, 0.05)
    s1 = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(cuda)
    s2 = torch.from_numpy(rng.standard_normal(3).astype(np.float32)).to(cuda)
    kernels.reset_launch_counts()
    mid = kernels.igdn_deconv_wide_packed(x, g1, b1, w1, s1)
    out = kernels.igdn_deconv_tail_packed(mid, g2, b2, w2, s2)
    mid_ref = kernels._igdn_deconv_ref(x, g1, b1, w1, s1)
    ref = kernels._igdn_deconv_ref(mid, g2, b2, w2, s2)
    mid_win = _window_bf16_conv(x, g1, b1, True, lambda g: F.conv_transpose2d(
        g, w1.float(), s1, 2, 2, 1))
    win = _window_bf16_conv(mid, g2, b2, True, lambda g: F.conv_transpose2d(
        g, w2.float(), s2, 2, 2, 1))
    torch.cuda.synchronize()
    assert mid.shape == (2, c, 2 * h, 2 * w)
    assert out.shape == (2, 3, 4 * h, 4 * w)
    _assert_scaled_close(mid, mid_ref, PLAIN_TOL)
    _assert_within_top_step(mid, mid_win)
    _assert_scaled_close(out, ref, PLAIN_TOL)
    _assert_within_top_step(out, win)
    assert kernels.LAUNCHES_BY_WIDTH == {
        ("igdn_deconv_wide_packed", c, c): 1,
        ("igdn_deconv_tail_packed", c, 3): 1}


@pytest.mark.cuda
@pytest.mark.parametrize("f", [3, 8, 20, 32])
def test_cuda_igdn_deconv_fused_256(cuda, f):
    """The lone narrow kernel at C = 256, 16, 32, 96 and 128 GEMM rows, at
    17 × 30 (partial tiles, the 2-byte window gather); against the
    window's arithmetic within one bf16 step of the largest output."""
    _check_narrow(cuda, 256, f, 17, 30, window_step=True)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,wide_range", [(2, 17, 30, False),
                                              (2, 13, 40, True),
                                              (1, 68, 120, False)])
def test_cuda_igdn_deconv_wide_256(cuda, b, h, w, wide_range):
    """The lone wide kernel at C = O = 256: ragged and whole tiles, and x
    over two and a half decades; against the window's arithmetic within
    one bf16 step of the largest output."""
    _check_wide(cuda, 256, b, h, w, wide_range, window_step=True)

def _grad_case(name, rng, device):
    """(wrapper, plain version, inputs) of one differentiable kernel at a
    small shape; the dtypes are those the kernel takes on the card."""
    c = 64
    x32 = torch.from_numpy(rng.standard_normal((2, c, 9, 12)).astype(
        np.float32)).to(device)
    gt, beta = _gdn_params(rng, c, device)
    if name in ("gdn_fused", "gdn_fused_bf16"):
        x = x32 if name == "gdn_fused" else x32.to(torch.bfloat16)
        return (lambda *a: kernels.gdn_fused(*a, True),
                lambda *a: kernels._gdn_plain(*a, True), (x, gt, beta))
    o = {"gdn_conv_fused": c, "igdn_deconv_wide_packed": c,
         "igdn_deconv_wide": c, "igdn_deconv_tail_packed": 3,
         "igdn_deconv_fused": 8}[name]
    shape = (o, c, 5, 5) if name == "gdn_conv_fused" else (c, o, 5, 5)
    weight = _bf16(rng, shape, device, 0.05)
    bias = torch.from_numpy(rng.standard_normal(o).astype(np.float32)).to(
        device)
    plain = (kernels._gdn_conv_ref if name == "gdn_conv_fused"
             else kernels._igdn_deconv_ref)
    return (getattr(kernels, name), plain,
            (x32.to(torch.bfloat16), gt, beta, weight, bias))


# g_s's four f32 deconvs of 4 streams of 1088 × 1920 pictures: (B, C, O,
# H, W) of each input
DECONV_F32_SHAPES = [(4, 192, 192, 68, 120), (4, 192, 192, 136, 240),
                     (4, 192, 192, 272, 480), (4, 192, 3, 544, 960)]


def _deconv_f32_inputs(device, b, c, o, h, w, seed):
    """x ~ N(0, 1), the Deconv's Kaiming weights (fan-in 25·C) and a
    bias."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, c, h, w), generator=gen, device=device)
    weight = (torch.randn((c, o, 5, 5), generator=gen, device=device)
              * (2.0 / (25 * c)) ** 0.5)
    bias = 0.1 * torch.randn((o,), generator=gen, device=device)
    return x, weight, bias


def _deconv_f32_errors(x, weight, bias, out):
    """(max|out − ref|, max|cuDNN f32 − ref|, max|ref|) of the k5 s2
    transposed conv + bias, ref in float64 (TF32 off for the f32 call)."""
    ref = F.conv_transpose2d(x.double(), weight.double(), bias.double(), 2,
                             2, 1)
    lib = F.conv_transpose2d(x, weight, None, 2, 2, 1) + bias.view(1, -1, 1,
                                                                   1)
    return (float((out.double() - ref).abs().max()),
            float((lib.double() - ref).abs().max()),
            float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,o,h,w", DECONV_F32_SHAPES)
def test_cuda_deconv_k5s2_f32_at_g_s_shapes(cuda, b, c, o, h, w):
    """deconv_k5s2_f32 at g_s's shapes: its max error against float64 at
    most twice cuDNN f32's against the same float64, two launches
    bit-identical, each counted under its widths."""
    x, weight, bias = _deconv_f32_inputs(cuda, b, c, o, h, w, seed=h)
    n0 = kernels.LAUNCHES["deconv_k5s2_f32"]
    w0 = kernels.LAUNCHES_BY_WIDTH.get(("deconv_k5s2_f32", c, o), 0)
    out = kernels.deconv_k5s2_f32(x, weight, bias)
    again = kernels.deconv_k5s2_f32(x, weight, bias)
    assert kernels.LAUNCHES["deconv_k5s2_f32"] == n0 + 2
    assert kernels.LAUNCHES_BY_WIDTH[("deconv_k5s2_f32", c, o)] == w0 + 2
    assert out.shape == (b, o, 2 * h, 2 * w) and out.dtype == torch.float32
    assert torch.equal(out, again)
    del again
    err, lib_err, _ = _deconv_f32_errors(x, weight, bias, out)
    assert err <= 2 * lib_err, (err, lib_err)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,o,h,w", [
    (2, 192, 192, 17, 35), (1, 16, 32, 5, 6), (3, 64, 64, 9, 33),
    (1, 256, 256, 4, 4), (2, 128, 3, 13, 70), (1, 16, 1, 7, 9),
    (2, 8, 2, 33, 65), (1, 192, 3, 40, 130)])
def test_cuda_deconv_k5s2_f32_edge_tiles(cuda, b, c, o, h, w):
    """Partial tiles on both edges, tiles larger than the image, W not a
    multiple of 4 (x staged element by element) and odd (outputs stored
    pixel by pixel), one stage (C = 16 wide, 8 narrow) and O = 1, 2: the
    error against float64 within twice cuDNN f32's (or 2⁻²⁰ of the
    output's range, where cuDNN's is smaller), and bit-identical
    launches."""
    x, weight, bias = _deconv_f32_inputs(cuda, b, c, o, h, w, seed=w)
    out = kernels.deconv_k5s2_f32(x, weight, bias)
    assert torch.equal(out, kernels.deconv_k5s2_f32(x, weight, bias))
    err, lib_err, top = _deconv_f32_errors(x, weight, bias, out)
    assert err <= 2 * max(lib_err, 2.0**-20 * top), (err, lib_err, top)


@pytest.mark.cuda
def test_cuda_deconv_k5s2_f32_rejects_bad_inputs(cuda):
    """On a CUDA tensor the wrapper launches or raises: bf16, a
    non-contiguous x, widths the kernel does not take (O = 4, C = 12) and
    a mismatched bias raise, and nothing is counted."""
    x, weight, bias = _deconv_f32_inputs(cuda, 1, 16, 32, 4, 4, seed=1)
    n0 = dict(kernels.LAUNCHES)
    bad = [(x.to(torch.bfloat16), weight, bias),
           (x.transpose(2, 3), weight, bias),
           (x, weight[:, :4], bias[:4]),
           (x[:, :12].contiguous(), weight[:12], bias),
           (x, weight, bias[:8])]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            kernels.deconv_k5s2_f32(*args)
    assert kernels.LAUNCHES == n0


def _g_s_float64(g_s, y):
    """g_s's layers in float64: the transposed convs with their biases, the
    IGDNs on the f32 (γᵀ, β) the kernels take."""
    from spatiotemporalentropymodel_tpu_torch.layers import GDN

    x = y.double()
    for layer in g_s.layers:
        if isinstance(layer, GDN):
            gamma_t, beta = layer.kernel_weights()
            x = kernels._gdn_ref(x, gamma_t.double(), beta.double(),
                                 layer.inverse)
        else:
            x = F.conv_transpose2d(x, layer.weight.double(),
                                   layer.bias.double(), 2, 2, 1)
    return x


@pytest.mark.cuda
def test_cuda_g_s_f32_runs_the_deconv_kernel(cuda):
    """MeanScaleHyperprior(192, 192).g_s on an f32 latent with no graph to
    record: its four Deconvs launch deconv_k5s2_f32 (4 a call) and x̂ lies
    within twice the cuDNN chain's error of float64 layers (TF32 off); with
    gradients the chain runs cuDNN, and h_s never launches the kernel."""
    from spatiotemporalentropymodel_tpu_torch.layers import Sequential

    model = MeanScaleHyperprior(192, 192, device=cuda, seed=3)
    g_s, h_s = model.module.g_s, model.module.h_s
    gen = torch.Generator(device=cuda).manual_seed(3)
    y = torch.round(4.0 * torch.randn((2, 192, 12, 20), generator=gen,
                                      device=cuda))
    n0 = kernels.LAUNCHES["deconv_k5s2_f32"]
    with torch.no_grad():
        got = g_s(y)
        lib = Sequential.forward(g_s, y)
        h_s(y[:, :, :3, :5].contiguous())
        ref = _g_s_float64(g_s, y)
    assert kernels.LAUNCHES["deconv_k5s2_f32"] == n0 + 4
    err = float((got.double() - ref).abs().max())
    lib_err = float((lib.double() - ref).abs().max())
    assert err <= 2 * lib_err + 1e-7, (err, lib_err)
    x = g_s(y)  # grad mode on and the parameters require grad: cuDNN
    assert x.grad_fn is not None
    assert kernels.LAUNCHES["deconv_k5s2_f32"] == n0 + 4


# g_a's four f32 convs of 4 streams of 1088 × 1920 pictures: (B, C, O, H,
# W) of each input
CONV_F32_SHAPES = [(4, 3, 192, 1088, 1920), (4, 192, 192, 544, 960),
                   (4, 192, 192, 272, 480), (4, 192, 192, 136, 240)]


def _conv_f32_inputs(device, b, c, o, h, w, seed):
    """x ~ N(0, 1), the Conv's Kaiming weights (fan-in 25·C) and a bias."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((b, c, h, w), generator=gen, device=device)
    weight = (torch.randn((o, c, 5, 5), generator=gen, device=device)
              * (2.0 / (25 * c)) ** 0.5)
    bias = 0.1 * torch.randn((o,), generator=gen, device=device)
    return x, weight, bias


def _conv_f32_errors(x, weight, bias, out):
    """(max|out − ref|, max|cuDNN f32 − ref|, max|ref|) of the k5 s2 conv +
    bias, ref in float64 (TF32 off for the f32 call, its bias added after
    as the port's Conv adds it)."""
    ref = F.conv2d(x.double(), weight.double(), bias.double(), 2, 2)
    lib = F.conv2d(x, weight, None, 2, 2) + bias.view(1, -1, 1, 1)
    return (float((out.double() - ref).abs().max()),
            float((lib.double() - ref).abs().max()),
            float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,o,h,w", CONV_F32_SHAPES)
def test_cuda_conv_k5s2_f32_at_g_a_shapes(cuda, b, c, o, h, w):
    """conv_k5s2_f32 at g_a's shapes: its max error against float64 at most
    1.25 times cuDNN f32's against the same float64, two launches
    bit-identical, each counted under its widths."""
    x, weight, bias = _conv_f32_inputs(cuda, b, c, o, h, w, seed=h)
    n0 = kernels.LAUNCHES["conv_k5s2_f32"]
    w0 = kernels.LAUNCHES_BY_WIDTH.get(("conv_k5s2_f32", c, o), 0)
    out = kernels.conv_k5s2_f32(x, weight, bias)
    again = kernels.conv_k5s2_f32(x, weight, bias)
    assert kernels.LAUNCHES["conv_k5s2_f32"] == n0 + 2
    assert kernels.LAUNCHES_BY_WIDTH[("conv_k5s2_f32", c, o)] == w0 + 2
    assert out.shape == (b, o, h // 2, w // 2) and out.dtype == torch.float32
    assert torch.equal(out, again)
    del again
    err, lib_err, _ = _conv_f32_errors(x, weight, bias, out)
    assert err <= 1.25 * lib_err, (err, lib_err)


@pytest.mark.cuda
@pytest.mark.parametrize("b,c,o,h,w", [
    (2, 192, 192, 35, 69), (1, 16, 32, 9, 11), (3, 64, 64, 18, 68),
    (1, 256, 320, 8, 8), (2, 3, 128, 27, 130), (1, 3, 32, 1, 1),
    (2, 128, 192, 66, 130), (1, 3, 192, 80, 262), (2, 192, 192, 40, 136)])
def test_cuda_conv_k5s2_f32_edge_tiles(cuda, b, c, o, h, w):
    """Partial tiles on both edges, tiles larger than the image, odd sides,
    W not a multiple of 4 (x staged element by element) and an output
    width not a multiple of 4 (stored pixel by pixel), one stage (C = 16)
    and the narrow C = 3: the error against float64 within 1.25 times
    cuDNN f32's (or 2⁻²⁰ of the output's range, where cuDNN's is smaller),
    and bit-identical launches."""
    x, weight, bias = _conv_f32_inputs(cuda, b, c, o, h, w, seed=w)
    out = kernels.conv_k5s2_f32(x, weight, bias)
    assert out.shape == (b, o, (h + 1) // 2, (w + 1) // 2)
    assert torch.equal(out, kernels.conv_k5s2_f32(x, weight, bias))
    err, lib_err, top = _conv_f32_errors(x, weight, bias, out)
    assert err <= 1.25 * max(lib_err, 2.0**-20 * top), (err, lib_err, top)


@pytest.mark.cuda
def test_cuda_conv_k5s2_f32_rejects_bad_inputs(cuda):
    """On a CUDA tensor the wrapper launches or raises: bf16, a
    non-contiguous x, widths the kernel does not take (O = 48, C = 8) and
    a mismatched bias raise, and nothing is counted."""
    x, weight, bias = _conv_f32_inputs(cuda, 1, 16, 64, 8, 8, seed=1)
    n0 = dict(kernels.LAUNCHES)
    bad = [(x.to(torch.bfloat16), weight, bias),
           (x.transpose(2, 3), weight, bias),
           (x, weight[:48], bias[:48]),
           (x[:, :8].contiguous(), weight[:, :8].contiguous(), bias),
           (x, weight, bias[:32])]
    for args in bad:
        with pytest.raises((TypeError, ValueError)):
            kernels.conv_k5s2_f32(*args)
    assert kernels.LAUNCHES == n0


def _g_a_float64(g_a, x):
    """g_a's layers in float64: the convs with their biases, the GDNs on
    the f32 (γᵀ, β) the kernels take."""
    from spatiotemporalentropymodel_tpu_torch.layers import GDN

    x = x.double()
    for layer in g_a.layers:
        if isinstance(layer, GDN):
            gamma_t, beta = layer.kernel_weights()
            x = kernels._gdn_ref(x, gamma_t.double(), beta.double(),
                                 layer.inverse)
        else:
            x = F.conv2d(x, layer.weight.double(), layer.bias.double(), 2, 2)
    return x


@pytest.mark.cuda
def test_cuda_g_a_f32_runs_the_conv_kernel(cuda):
    """MeanScaleHyperprior(192, 192).g_a on an f32 picture with no graph to
    record: its four Convs launch conv_k5s2_f32 (4 a call) and y lies
    within 1.25 times the cuDNN chain's error of float64 layers (TF32 off);
    with gradients the chain runs cuDNN, and h_a never launches the
    kernel."""
    from spatiotemporalentropymodel_tpu_torch.layers import Sequential

    model = MeanScaleHyperprior(192, 192, device=cuda, seed=3)
    g_a, h_a = model.module.g_a, model.module.h_a
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.rand((2, 3, 192, 320), generator=gen, device=cuda)
    n0 = kernels.LAUNCHES["conv_k5s2_f32"]
    with torch.no_grad():
        got = g_a(x)
        lib = Sequential.forward(g_a, x)
        h_a(got)
        ref = _g_a_float64(g_a, x)
    assert kernels.LAUNCHES["conv_k5s2_f32"] == n0 + 4
    err = float((got.double() - ref).abs().max())
    lib_err = float((lib.double() - ref).abs().max())
    assert err <= 1.25 * lib_err + 1e-7, (err, lib_err)
    y = g_a(x)  # grad mode on and the parameters require grad: cuDNN
    assert y.grad_fn is not None
    assert kernels.LAUNCHES["conv_k5s2_f32"] == n0 + 4


GRAD_CASES = ["gdn_fused", "gdn_fused_bf16", "gdn_conv_fused",
              "igdn_deconv_wide_packed", "igdn_deconv_tail_packed",
              "igdn_deconv_fused", "igdn_deconv_wide"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", GRAD_CASES)
def test_cuda_kernel_gradients_match_plain(cuda, name, monkeypatch):
    """Each wrapper's output on the card has a grad_fn, the forward launched
    the kernel, and the gradients reaching x, γᵀ, β, the weight and the bias
    are the plain version's, in each input's dtype (deterministic cuDNN; f32
    rtol 1e-5, bf16 one step of the largest gradient)."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    rng = np.random.default_rng(len(name))
    fn, plain, inputs = _grad_case(name, rng, cuda)
    leaves = [t.clone().requires_grad_() for t in inputs]
    refs = [t.clone().requires_grad_() for t in inputs]
    n0 = sum(kernels.LAUNCHES.values())
    out = fn(*leaves)
    assert out.grad_fn is not None
    assert sum(kernels.LAUNCHES.values()) == n0 + 1
    cot = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32)).to(cuda).to(out.dtype)
    got = torch.autograd.grad(out, leaves, cot)
    want = torch.autograd.grad(plain(*refs), refs, cot)
    for t, g, r in zip(inputs, got, want):
        assert g.dtype == t.dtype and g.shape == t.shape
        if t.dtype == torch.float32:
            torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-6)
        else:
            _assert_scaled_close(g, r, 2**-8)


def _cuda_slice(device, seed=0):
    """The small bf16 slice (N = M = 64, EB 32, 2 × 64 × 64 frames) on the
    card: the workload surgery at f32, update(), then bf16."""
    rng = np.random.default_rng(seed)
    frames = [torch.from_numpy(rng.random((2, 3, 64, 64), dtype=np.float32))
              .to(device) for _ in range(3)]
    y_cond = torch.from_numpy((0.5 * rng.standard_normal((2, 64, 4, 4)))
                              .astype(np.float32)).to(device)
    imodel = MeanScaleHyperprior(64, 64, device=device, seed=0)
    stem = SpatioTemporalPriorModel(variant="without_spm",
                                    entropy_bottleneck_channels=32,
                                    in_channels=64, device=device, seed=1)
    realistic_stem(stem)
    match_latent_to_prior(imodel, stem, frames[0], y_cond)
    imodel.update()
    imodel.set_compute_dtype(torch.bfloat16)
    stem.set_compute_dtype(torch.bfloat16)
    return StemVideoPipeline(imodel, stem, transport_mode="sparse"), frames, \
        y_cond


def _run_slice(pipe, frames, y_cond):
    encs = list(pipe.encode_frames(frames, y_cond))
    dec = list(pipe.decode_frames(encs, y_cond))
    bpp = [sum(len(s) for g in e["strings"] for s in g) + e["counts"].nbytes
           for e in encs]
    return dec, bpp


def _plain_wrappers(monkeypatch):
    """Every kernel wrapper replaced by its plain version."""
    for name in ("igdn_deconv_wide_packed", "igdn_deconv_tail_packed",
                 "igdn_deconv_fused", "igdn_deconv_wide"):
        monkeypatch.setattr(kernels, name, kernels._igdn_deconv_ref)
    monkeypatch.setattr(kernels, "gdn_conv_fused", kernels._gdn_conv_ref)
    monkeypatch.setattr(kernels, "deconv_k5s2_f32",
                        kernels._deconv_k5s2_plain)
    monkeypatch.setattr(kernels, "conv_k5s2_f32", kernels._conv_k5s2_plain)
    monkeypatch.setattr(kernels, "gdn_fused",
                        lambda x, g, b, inverse=False:
                        kernels._gdn_plain(x, g, b, inverse))
    monkeypatch.setattr(kernels, "quantize_and_index",
                        lambda y, m, s, t, scale_bound=0.11:
                        kernels._qidx_plain(y, m, s, t, scale_bound))


@pytest.mark.cuda
@pytest.mark.parametrize("knob_set", ["default", "wide"])
def test_cuda_bf16_slice_matches_plain_versions(cuda, knob_set, monkeypatch):
    """The bf16 slice through the kernels against the same slice through
    their plain versions, held to tests/test_torch_bf16_pipeline.py's
    criteria: ŷ flips at ≤ 0.1 % of the elements (|Δ| ≤ 1e-4 elsewhere,
    ≤ one step there), x̂ max |Δ| ≤ 6e-2 and mean |Δ| ≤ 2e-3, bpp rtol 2e-2.
    The kernels must have launched."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    values = kernels.WIDE_KNOBS if knob_set == "wide" else {}
    with kernels.knobs(**values):
        pipe, frames, y_cond = _cuda_slice(cuda)
        n0 = sum(kernels.LAUNCHES.values())
        dec, bpp = _run_slice(pipe, frames, y_cond)
        assert sum(kernels.LAUNCHES.values()) > n0
        _plain_wrappers(monkeypatch)
        n1 = sum(kernels.LAUNCHES.values())
        ref, ref_bpp = _run_slice(pipe, frames, y_cond)
        assert sum(kernels.LAUNCHES.values()) == n1
    for (x_hat, y_hat), (x_ref, y_ref) in zip(dec, ref):
        dx = (x_hat.float() - x_ref.float()).abs()
        assert float(dx.max()) <= 6e-2 and float(dx.mean()) <= 2e-3
        dy = (y_hat - y_ref).abs()
        assert float((dy > 1e-4).float().mean()) <= 1e-3
        assert float(dy.max()) <= 1 + 1e-4
    np.testing.assert_allclose(bpp, ref_bpp, rtol=2e-2)


def _res_slice(device, seed=0):
    """The small bf16 flagship: STEM res (EB 32, M = 64) with wavefront tile
    (1, 4) and MeanScaleHyperprior(64, 64), 2 × 64 × 64 frames."""
    rng = np.random.default_rng(seed)
    frames = [torch.from_numpy(rng.random((2, 3, 64, 64), dtype=np.float32))
              .to(device) for _ in range(3)]
    y_cond = torch.from_numpy((0.5 * rng.standard_normal((2, 64, 4, 4)))
                              .astype(np.float32)).to(device)
    imodel = MeanScaleHyperprior(64, 64, device=device, seed=0)
    stem = SpatioTemporalPriorModel(variant="res",
                                    entropy_bottleneck_channels=32,
                                    in_channels=64, wavefront_tile=(1, 4),
                                    device=device, seed=1)
    realistic_stem(stem)
    imodel.set_compute_dtype(torch.bfloat16)
    stem.set_compute_dtype(torch.bfloat16)
    return WavefrontVideoPipeline(imodel, stem), frames, y_cond


@torch.no_grad()
def _encoder_recon(stem, enc, y_cur, y_cond):
    """The wavefront encoder's reconstruction + y_cond over the priors of
    the decoder's ẑ (JAX tests/test_stem.py:141-166)."""
    b, _, h, w = y_cur.shape
    th, tw, nt = stem._tile_dims(h, w)
    z_hat = stem._upload(stem._eb_decompress(enc["strings"][1],
                                             enc["shape"]))
    priors = stem._tiled_priors(z_hat, y_cond, th, tw, nt)
    target = wf.tile_plane((y_cur - y_cond).permute(0, 2, 3, 1), th, tw)
    _, _, rounds, encoder, *_ = stem._wavefront_setup(th, tw)
    recon = wf.untile_plane(encoder(target, priors, rounds, b)[2], b, h, w)
    return _nchw(recon.permute(0, 3, 1, 2)) + y_cond


def _run_res(pipe, frames, y_cond):
    """serve_latent over the frames (y_cur from each frame's g_a, as the
    bench draws it); the encoder's reconstruction must be the decoder's ŷ
    bit for bit on every frame. Returns [(x̂, ŷ)], bytes per frame."""
    gen = torch.Generator(device=y_cond.device).manual_seed(13)
    dec, nbytes = [], []
    for k, x in enumerate(frames):
        y_cur = wavefront_y_cur(pipe.i_model, x, y_cond, gen)
        enc, y_hat, x_hat = pipe.serve_latent(y_cur, y_cond, frame=k)
        assert torch.equal(_encoder_recon(pipe.stem, enc, y_cur, y_cond),
                           y_hat)
        dec.append((x_hat, y_hat))
        nbytes.append(sum(len(s) for g in enc["strings"] for s in g))
        y_cond = y_hat
    return dec, nbytes


@pytest.mark.cuda
def test_cuda_res_wavefront_matches_plain_versions(cuda, monkeypatch):
    """The small bf16 res wavefront pipeline through the kernels (g_a's
    gdn_conv_fused, g_s's gdn_fused and packed pair)
    against the same pipeline through their plain versions, to
    test_cuda_bf16_slice_matches_plain_versions's criteria, with encoder ŷ
    == decoder ŷ exactly in both."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    pipe, frames, y_cond = _res_slice(cuda)
    n0 = sum(kernels.LAUNCHES.values())
    dec, nbytes = _run_res(pipe, frames, y_cond)
    assert sum(kernels.LAUNCHES.values()) > n0
    _plain_wrappers(monkeypatch)
    n1 = sum(kernels.LAUNCHES.values())
    ref, ref_bytes = _run_res(pipe, frames, y_cond)
    assert sum(kernels.LAUNCHES.values()) == n1
    for (x_hat, y_hat), (x_ref, y_ref) in zip(dec, ref):
        assert x_hat.dtype == torch.bfloat16
        dx = (x_hat.float() - x_ref.float()).abs()
        assert float(dx.max()) <= 6e-2 and float(dx.mean()) <= 2e-3
        dy = (y_hat - y_ref).abs()
        assert float((dy > 1e-4).float().mean()) <= 1e-3
        assert float(dy.max()) <= 1 + 1e-4
    np.testing.assert_allclose(nbytes, ref_bytes, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("variant,tile", [("without_spm", None),
                                          ("res", (2, 4))])
def test_cuda_stemv_round_trip_and_png(cuda, monkeypatch, tmp_path, variant,
                                       tile):
    """encode_video/decode_video of 250×256 frames (padded to 256²) on the
    card, f32 then bf16, in both families, with kernel launches on each:
    finite frames that a second decode repeats exactly and that read back
    from their PNGs; then data/png.py round-trips a 1080p frame."""
    from spatiotemporalentropymodel_tpu_torch.data.png import (
        read_png, write_png,
    )
    from spatiotemporalentropymodel_tpu_torch.eval import video_codec as vc
    from spatiotemporalentropymodel_tpu_torch.eval.codec import to_png_array
    from spatiotemporalentropymodel_tpu_torch.eval.workload import (
        hero_1080p_frames,
        structured_frames,
    )

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    i_model = MeanScaleHyperprior(128, 192, device="cuda")
    stem = SpatioTemporalPriorModel(variant=variant,
                                    entropy_bottleneck_channels=128,
                                    in_channels=192, wavefront_tile=tile,
                                    device="cuda", seed=1)
    with torch.no_grad():
        for p in i_model.module.parameters():
            p.mul_(0.05)
        for p in stem.module.parameters():
            p.mul_(0.01)
    i_model.update()
    stem.update()
    frames = [f.astype(np.float32) / 255.0 for f in structured_frames(
        np.random.default_rng(0), 3, (250, 256))]
    for dtype in (None, torch.bfloat16):
        if dtype is not None:
            i_model.set_compute_dtype(dtype)
            stem.set_compute_dtype(dtype)
        out = tmp_path / f"{dtype}.stemv"
        kernels.reset_launch_counts()
        vc.encode_video(frames, i_model, stem, out, gop=3)
        assert sum(kernels.LAUNCHES.values()) > 0
        kernels.reset_launch_counts()
        got = vc.decode_video(out, i_model, stem, output_dir=tmp_path / "png")
        assert sum(kernels.LAUNCHES.values()) > 0
        again = vc.decode_video(out, i_model, stem)
        for t, (a, b) in enumerate(zip(got, again)):
            assert a.shape == (250, 256, 3) and np.isfinite(a).all()
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(
                read_png(tmp_path / "png" / f"frame_{t:04d}.png"),
                to_png_array(a))
    frame = hero_1080p_frames()[0]
    write_png(tmp_path / "hd.png", frame)
    np.testing.assert_array_equal(read_png(tmp_path / "hd.png"), frame)


def _train_grads(module, x, mode, monkeypatch):
    """Gradients of the RD loss of one train forward of ``module`` (noise
    fed as x + 0.45·sin(7·x + k), the same on every run), with gdn_fused's
    kernel ("kernel"), its plain version ("plain"), or its plain version
    with each output moved by 1e-5 relative, with random signs ("random")
    or all up ("scaled")."""
    from spatiotemporalentropymodel_tpu_torch.entropy import (
        bottleneck, gaussian,
    )
    from spatiotemporalentropymodel_tpu_torch.training import (
        rate_distortion_loss,
    )

    gen = torch.Generator(device=x.device).manual_seed(21)

    def plain(v, g, b, inverse=False):
        out = kernels._gdn_plain(v, g, b, bool(inverse))
        if mode == "random":
            sign = torch.empty(out.shape, device=out.device).bernoulli_(
                0.5, generator=gen) * 2 - 1
            out = out * (1 + 1e-5 * sign)
        elif mode == "scaled":
            out = out * (1 + 1e-5)
        return out

    with monkeypatch.context() as m:
        for mod, k in ((bottleneck, 0.1), (gaussian, 0.7)):
            m.setattr(mod, "quantize_noise", lambda v, generator, k=k: v + (
                0.45 * torch.sin(7.0 * v + k)).detach())
        if mode != "kernel":
            m.setattr(kernels, "gdn_fused", plain)
        kernels.reset_launch_counts()
        loss = rate_distortion_loss(module(x, train=True), x)["loss"]
        grads = torch.autograd.grad(loss, list(module.parameters()),
                                    allow_unused=True)
        launched = kernels.LAUNCHES["gdn_fused"]
    return {n: g for (n, _), g in zip(module.named_parameters(), grads)
            if g is not None}, launched


@pytest.mark.cuda
def test_cuda_train_step_kernel_matches_plain(cuda, monkeypatch):
    """One train_image step of MSH(128, 192) at 2×128×128 with gdn_fused's
    kernel and with its plain version: the forward launches the kernel in
    each of the 6 (I)GDNs, and each gradient leaf moves no more than twice
    as far from the plain one as the plain runs with every (I)GDN output
    moved by 1e-5 relative (the f32 kernel's rtol), with random signs or
    all up, do."""
    model = MeanScaleHyperprior(128, 192, device=cuda, seed=2)
    x = torch.rand((2, 3, 128, 128), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(2))
    got, n_kernel = _train_grads(model.module, x, "kernel", monkeypatch)
    ref, n_plain = _train_grads(model.module, x, "plain", monkeypatch)
    moved = [_train_grads(model.module, x, m, monkeypatch)[0]
             for m in ("random", "scaled")]
    assert (n_kernel, n_plain) == (6, 0)
    assert got.keys() == ref.keys()
    for name, r in ref.items():
        err = float((got[name] - r).abs().max())
        yard = max(float((m[name] - r).abs().max()) for m in moved)
        assert err <= 2 * yard, (name, err, yard)


@pytest.mark.cuda
@pytest.mark.parametrize("name,quality", [("mbt2018", 5),
                                          ("cheng2020-attn", 6)])
def test_cuda_image_ar_round_trip(cuda, name, quality):
    """The zoo's mbt2018 at quality 5 (N 192, M 320) and Cheng2020-attn at
    quality 6 on the card, bf16, a 256 × 384 picture: encoder ŷ == decoder
    ŷ bit for bit, a second compress repeats the strings, x̂ finite; mbt2018
    runs g_a's last stage through gdn_conv_fused at 192 → 320 (one launch
    per compress), Cheng2020's six (I)GDNs through gdn_fused."""
    from spatiotemporalentropymodel_tpu_torch import zoo

    model = zoo.create_model(name, quality, device=cuda, seed=1)
    model.update()
    model.set_compute_dtype(torch.bfloat16)
    x = torch.rand((1, 3, 256, 384), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(3))
    kernels.reset_launch_counts()
    enc, y_enc = model.encode_with_y_hat(x)
    dec = model.decompress(enc["strings"], enc["shape"])
    torch.cuda.synchronize()
    by_width = dict(kernels.LAUNCHES_BY_WIDTH)
    assert torch.equal(dec["y_hat"], y_enc)
    assert model.compress(x)["strings"] == enc["strings"]
    assert dec["x_hat"].shape == x.shape
    assert bool(torch.isfinite(dec["x_hat"]).all())
    if name == "mbt2018":
        assert by_width[("gdn_conv_fused", 192, 320)] == 1
        assert by_width[("gdn_conv_fused", 192, 192)] == 2
        assert by_width[("igdn_deconv_tail_packed", 192, 3)] == 1
    else:
        assert by_width == {("gdn_fused_bf16", 192): 6}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_cuda_image_ar_round_graphs_match_eager(cuda, dtype):
    """Cheng2020-attn at quality 6 on the card, f32 and bf16, two 256 × 384
    pictures: the wavefront rounds as CUDA graphs give the eager rounds'
    strings and ŷ bit for bit (the same kernels on the same inputs), again
    on a replay, and each picture alone gives its batched stream."""
    from spatiotemporalentropymodel_tpu_torch import zoo

    x = torch.rand((2, 3, 256, 384), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(3))
    runs = {}
    for graphs in (False, True):
        model = zoo.create_model("cheng2020-attn", 6, device=cuda, seed=1)
        model.update()
        model.set_compute_dtype(dtype)
        model.round_graphs = graphs
        got = []
        for xs in (x, x, x[:1], x[1:]):
            enc, y_enc = model.encode_with_y_hat(xs)
            dec = model.decompress(enc["strings"], enc["shape"])
            got.append((enc["strings"], y_enc, dec["y_hat"]))
        runs[graphs] = got
        assert bool(model._graphs) == graphs
    for (s, y_enc, y_dec), (gs, g_enc, g_dec) in zip(runs[False],
                                                      runs[True]):
        assert gs == s
        assert torch.equal(g_enc, y_enc) and torch.equal(g_dec, y_dec)
        assert torch.equal(g_dec, g_enc)
    both, alone = runs[True][0], runs[True][2:]
    for i, (s, _, y_dec) in enumerate(alone):
        assert s[0] == [both[0][0][i]]
        assert torch.equal(y_dec[0], both[2][i])


@pytest.mark.cuda
def test_cuda_cheng2020_f32_transforms_take_no_fft(cuda):
    """Cheng2020-attn(192)'s f32 g_a on one 1088 × 1920 picture and g_s on
    four 68 × 120 latents, as the benchmark's image cell runs them: their
    3×3 stride-1 convs go through im2col and cuBLAS (``Conv.im2col``), so
    no FFT, GEMV or complex-GEMM kernel runs, and the outputs are cuDNN's
    chain's within 1e-5 of their largest value (both f32 with TF32 off,
    summed in other orders: a few ulps over about 40 layers)."""
    from spatiotemporalentropymodel_tpu_torch.layers import Conv
    from spatiotemporalentropymodel_tpu_torch.models.waseda import (
        Cheng2020AttentionModule,
    )

    m = Cheng2020AttentionModule(192, 192, torch.Generator().manual_seed(2))
    m = m.to(cuda).eval()
    for p in m.parameters():
        p.data.mul_(0.5)
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.rand((1, 3, 1088, 1920), device=cuda, generator=g)
    y = torch.randn((4, 192, 68, 120), device=cuda, generator=g)
    marked = [c for c in m.modules() if isinstance(c, Conv) and c.im2col]
    assert len(marked) == 51
    with torch.no_grad():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            got = m.g_a(x), m.g_s(y)
            torch.cuda.synchronize()
        for c in marked:
            c.im2col = False
        want = m.g_a(x), m.g_s(y)
    names = [e.name.lower() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert not [n for n in names if "fft" in n or "gemv" in n or "cf32" in n]
    for a, b in zip(got, want):
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["analysis", "get_x"])
def test_cuda_spatial_apply_bf16_matches_unsplit(cuda, monkeypatch, method):
    """bf16 g_a (gdn_conv_fused) and g_s (gdn_fused_bf16, then the packed
    pair) of MeanScaleHyperprior(192, 192), W-split over a mesh naming the
    card twice, against the unsplit call: within 2⁻⁶·max|unsplit| (the
    fused kernels' tolerance against their plain versions), each kernel
    launched twice as often."""
    from spatiotemporalentropymodel_tpu_torch.parallel import (
        SP_AXIS, Mesh, spatial_apply,
    )

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    model = MeanScaleHyperprior(192, 192, device=cuda, seed=0)
    model.set_compute_dtype(torch.bfloat16)
    gen = torch.Generator(device=cuda).manual_seed(3)
    x = torch.rand((1, 3, 128, 512), generator=gen, device=cuda)
    inp = x if method == "analysis" else model.analysis(x)
    kernels.reset_launch_counts()
    ref = getattr(model, method)(inp)
    once = dict(kernels.LAUNCHES)
    kernels.reset_launch_counts()
    got = spatial_apply(model, method, inp, Mesh((cuda, cuda), SP_AXIS),
                        gather=True)
    assert sum(once.values()) > 0
    assert dict(kernels.LAUNCHES) == {k: 2 * v for k, v in once.items()}
    assert got.dtype == ref.dtype == torch.bfloat16
    err = float((got.float() - ref.float()).abs().max())
    assert err <= 2**-6 * float(ref.float().abs().max())


@pytest.mark.cuda
def test_cuda_data_parallel_one_entry_is_the_step(cuda, monkeypatch):
    """data_parallel_step on a mesh of the card alone is the plain image
    step exactly (the shard draws from the caller's generator), with
    cuDNN deterministic as the pipelines run it."""
    import copy

    from spatiotemporalentropymodel_tpu_torch.parallel import (
        Mesh, data_parallel_step, init_train_state, make_image_train_step,
    )
    from spatiotemporalentropymodel_tpu_torch.training import (
        configure_optimizers,
    )

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    base = MeanScaleHyperprior(64, 64, device=cuda, seed=5).module
    x = torch.rand((2, 3, 64, 64), device=cuda,
                   generator=torch.Generator(device=cuda).manual_seed(5))
    runs = []
    for dp in (False, True):
        module = copy.deepcopy(base)
        opt = configure_optimizers(module, 1e-4)
        step = make_image_train_step(module, opt)
        if dp:
            step = data_parallel_step(step, Mesh((cuda,)))
        state = init_train_state(module, opt)
        gen = torch.Generator(device=cuda).manual_seed(9)
        metrics = [step(state, x, gen)[1] for _ in range(2)]
        runs.append((metrics, [p.detach().clone()
                               for p in module.parameters()]))
    (m0, p0), (m1, p1) = runs
    assert all(torch.equal(a[k], b[k]) for a, b in zip(m0, m1) for k in a)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))


def _port_fed_noise(monkeypatch):
    """The training tests' fed noise, the port's side
    (tests/torch_port_util.py::fed_noise): quantize_noise replaced by
    x + 0.45·sin(7·x + k), the identity's gradient, so every shard's noise
    is a function of its input, whichever device draws it."""
    from spatiotemporalentropymodel_tpu_torch.entropy import (
        bottleneck, gaussian,
    )
    from spatiotemporalentropymodel_tpu_torch.models import priors, stem

    for mod, k in ((bottleneck, 0.1), (gaussian, 0.7), (priors, 1.3),
                   (stem, 2.9)):
        monkeypatch.setattr(mod, "quantize_noise",
                            lambda x, generator, k=k: x + (
                                0.45 * torch.sin(7.0 * x + k)).detach())


def _cards(n=2):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} or more cards")
    return torch.cuda.device_count()


def _meshes(cuda, kind):
    from spatiotemporalentropymodel_tpu_torch.parallel import Mesh, make_mesh

    if kind == "card_and_cpu":
        return Mesh((cuda, "cpu"))
    _cards()
    return make_mesh()


def check_replicas(monkeypatch, mesh):
    """Two image steps of MSH(64, 64) through data_parallel_step over
    ``mesh``, with fed noise: the gradient each step applies must be, bit
    for bit, the mean of each shard's gradient computed by hand on its
    device from a fresh copy of the module's current parameters, so every
    replica took the new parameters before the second step. Returns (the
    first step's applied gradient, the plain step's on the first device)."""
    import copy

    from spatiotemporalentropymodel_tpu_torch.parallel import (
        data_parallel_step, init_train_state, make_image_train_step,
        shard_batch,
    )
    from spatiotemporalentropymodel_tpu_torch.parallel.mesh import on_device
    from spatiotemporalentropymodel_tpu_torch.training import (
        configure_optimizers,
    )
    from spatiotemporalentropymodel_tpu_torch.training.optimizers import (
        main_parameters,
    )

    _port_fed_noise(monkeypatch)
    first = mesh.devices[0]
    x = torch.rand((2 * mesh.size, 3, 64, 64), device=first,
                   generator=torch.Generator(device=first).manual_seed(5))
    module = MeanScaleHyperprior(64, 64, device=first, seed=5).module
    opt = configure_optimizers(module, 1e-2)
    base = make_image_train_step(module, opt)
    applied, apply_both = [], base.stepper.apply_both

    def record(state, g_main, g_aux):
        applied.append([g.clone() for g in g_main])
        return apply_both(state, g_main, g_aux)

    monkeypatch.setattr(base.stepper, "apply_both", record)
    step = data_parallel_step(base, mesh)
    state = init_train_state(module, opt)

    def by_hand(batch, devices):
        total = None
        for device, shard in zip(devices, batch):
            net = copy.deepcopy(module).to(device)
            params = main_parameters(net)
            with on_device(device):
                loss = base.losses(net, shard,
                                   torch.Generator(device=device))["loss"]
                got = torch.autograd.grad(loss, params, allow_unused=True)
            g = [(torch.zeros_like(p) if v is None else v).to(first)
                 for p, v in zip(params, got)]
            total = g if total is None else [a + b for a, b in zip(total, g)]
        return [v / len(devices) for v in total]

    plain = by_hand([x], [first])
    for t in range(2):
        want = by_hand(shard_batch(x, mesh), mesh.devices)
        step(state, x, torch.Generator(device=first))
        assert all(torch.equal(a, b) for a, b in zip(applied[t], want)), t
    return applied[0], plain


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["card_and_cpu", "every_card"])
def test_cuda_data_parallel_replicas(cuda, monkeypatch, kind):
    """data_parallel_step with shards on other devices than the module's:
    the card and the CPU (the CPU shard through a replica and the plain
    versions), or every card (each shard through a replica with its card
    current), held by ``check_replicas``. On every card the first step's
    gradient is also the plain step's on the first card, within
    1e-4·max|g| of each leaf."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    applied, plain = check_replicas(monkeypatch, _meshes(cuda, kind))
    if kind == "every_card":
        for a, b in zip(applied, plain):
            assert float((a - b).abs().max()) <= \
                1e-4 * (float(b.abs().max()) or 1e-30)


def _split_slice(device, width=512):
    """The bf16 slice (N = M = 64, EB 32) at 1 × 3 × 64 × ``width``."""
    rng = np.random.default_rng(3)
    frames = [torch.from_numpy(rng.random((1, 3, 64, width),
                                          dtype=np.float32)).to(device)
              for _ in range(2)]
    y_cond = torch.from_numpy((0.5 * rng.standard_normal(
        (1, 64, 4, width // 16))).astype(np.float32)).to(device)
    imodel = MeanScaleHyperprior(64, 64, device=device, seed=0)
    stem = SpatioTemporalPriorModel(variant="without_spm",
                                    entropy_bottleneck_channels=32,
                                    in_channels=64, device=device, seed=1)
    realistic_stem(stem)
    match_latent_to_prior(imodel, stem, frames[0], y_cond)
    imodel.update()
    return imodel, stem, frames, y_cond


@pytest.mark.cuda
def test_cuda_every_card_serving(cuda, monkeypatch):
    """The split paths over every card, each shard on its own card:
    gop_forward_sharded (f32, B one per card) against gop_forward, x̂ atol
    1e-5 and bpp rtol 1e-5; spatial_apply of the bf16 g_a and g_s against
    the unsplit calls within 2⁻⁶·max|unsplit|, each kernel launched once
    per card; the W-split StemVideoPipeline's streams decoded by the
    unsplit pipeline to the split decoder's ŷ exactly, and x̂ by the bf16
    slice's criteria."""
    from spatiotemporalentropymodel_tpu_torch.parallel import (
        Sharded, make_mesh, make_spatial_mesh, spatial_apply,
    )
    from spatiotemporalentropymodel_tpu_torch.parallel.spatial import whole

    n = _cards()
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    first = torch.device("cuda", 0)
    imodel, stem, frames, y_cond = _split_slice(first)
    pipe = StemVideoPipeline(imodel, stem)
    gop = torch.stack([f.expand(n, -1, -1, -1) * (1 - 0.1 * i)
                       for i, f in enumerate(frames)])
    y0 = y_cond.expand(n, -1, -1, -1).contiguous()
    x_ref, bpp_ref = pipe.gop_forward(gop, y0)
    x_sh, bpp_sh = pipe.gop_forward_sharded(gop, y0, make_mesh())
    assert float((x_sh - x_ref).abs().max()) <= 1e-5
    torch.testing.assert_close(bpp_sh, bpp_ref, rtol=1e-5, atol=0)

    imodel.set_compute_dtype(torch.bfloat16)
    stem.set_compute_dtype(torch.bfloat16)
    mesh = make_spatial_mesh()
    y = imodel.analysis(frames[0])
    for method, inp in (("analysis", frames[0]), ("get_x", y)):
        kernels.reset_launch_counts()
        ref = getattr(imodel, method)(inp)
        once = dict(kernels.LAUNCHES)
        kernels.reset_launch_counts()
        got = spatial_apply(imodel, method, inp, mesh)
        assert [s.device for s in got.shards] == list(mesh.devices)
        assert sum(once.values()) > 0
        assert dict(kernels.LAUNCHES) == {k: n * v for k, v in once.items()}
        err = float((got.gather().float() - ref.float()).abs().max())
        assert err <= 2**-6 * float(ref.float().abs().max())

    split = StemVideoPipeline(imodel, stem, spatial_mesh=mesh)
    encs = list(split.encode_frames(frames, y_cond))
    dec = list(split.decode_frames(encs, y_cond))
    cross = list(pipe.decode_frames(encs, y_cond))
    unsplit = list(pipe.decode_frames(list(pipe.encode_frames(frames,
                                                              y_cond)),
                                      y_cond))
    for (x_s, y_s), (_, y_c), (x_u, _) in zip(dec, cross, unsplit):
        assert isinstance(y_s, Sharded)
        assert [s.device for s in y_s.shards] == list(mesh.devices)
        assert torch.equal(whole(y_s), y_c)
        dx = (whole(x_s).float() - x_u.float()).abs()
        assert float(dx.max()) <= 6e-2 and float(dx.mean()) <= 2e-3
