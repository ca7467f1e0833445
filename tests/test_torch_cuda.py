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


def _check_narrow(cuda, c, f, h, w, wide_range=False):
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


def _check_wide(cuda, c, b, h, w, wide_range=False):
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
