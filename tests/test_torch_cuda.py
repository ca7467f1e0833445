"""The port's on-card check: its CUDA kernels against their plain PyTorch
versions (forward and gradients, at edge shapes and at the serving paths'
shapes), the small bf16 slices with the kernels against the same slices
with every wrapper replaced by its plain version, and the paths at their
serving shapes: the sparse and wavefront serving slices, the trained hero
models, the file codecs and their CLIs, training, the autoregressive image
models, the ROI family, charm and the parallel slice, each with its
launches held exact by kernel and width.

Marked ``cuda``: they skip without one. A path test with a "cpu" case runs
there too, at a small size. This file imports neither jax nor the JAX
package, so it also runs on a machine that has only PyTorch:
``python3 -m pytest -q -m cuda tests/test_torch_cuda.py``.

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
        pytest.skip("needs an NVIDIA card")
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
    special = torch.cat([torch.arange(-40, 41) + 0.5, torch.tensor(
        [3e9, -3e9, 2.0**30 + 128, -(2.0**30) - 128, 1e38])]).to(dtype)
    mf[:special.numel()], yf[:special.numel()] = 0, special
    t = torch.from_numpy(table).to(dtype)
    if dtype == torch.bfloat16:  # positive: ±1 in the bits is ±1 step
        lo = (t.view(torch.int16) - 1).view(dtype)
        hi = (t.view(torch.int16) + 1).view(dtype)
    else:
        lo = torch.nextafter(t, torch.full_like(t, -np.inf))
        hi = torch.nextafter(t, torch.full_like(t, np.inf))
    edges = torch.cat([t, lo, hi,
                       torch.tensor([0.11, 0.0, -1.0, 0.05]).to(dtype)])
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
    # the y plane of 4 × 1088 × 1920 frames, (σ, μ) as EPM and h_s hand
    # them over; and an odd shape off 16-byte alignment
    "path_halves": (4, 192, 68, 120),
    "path_misaligned": (3, 37, 17, 29),
}
QIDX_LAYOUT = {"odd_halves": "halves", "path_halves": "halves",
               "path_misaligned": "misaligned"}


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
    layout = QIDX_LAYOUT.get(case, case)
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


# the f32 k5 s2 kernels against their plain versions, both f32:
# max|kernel − plain| ≤ K5S2_F32_TOL·max|plain|
K5S2_F32_TOL = 1e-5

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
    most twice cuDNN f32's against the same float64, and against its plain
    version within 1e-5·max|plain| (both f32, summed in other orders), two
    launches bit-identical, each counted under its widths."""
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
    _assert_scaled_close(out, kernels._deconv_k5s2_plain(x, weight, bias),
                         K5S2_F32_TOL)


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
    1.25 times cuDNN f32's against the same float64, and against its plain
    version within 1e-5·max|plain|, two launches bit-identical, each
    counted under its widths."""
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
    _assert_scaled_close(out, kernels._conv_k5s2_plain(x, weight, bias),
                         K5S2_F32_TOL)


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
def _encoder_pass(stem, enc, y_cur, y_cond):
    """The model's wavefront encoder over the priors of the decoder's ẑ, as
    JAX tests/test_stem.py:141-166 runs it: (its reconstruction + y_cond
    NCHW, its symbols and CDF-row indexes per stream in wire order)."""
    b, _, h, w = y_cur.shape
    th, tw, nt, serial = stem._ar_dims(h, w)
    z_hat = stem._upload(stem._eb_decompress(enc["strings"][1],
                                             enc["shape"]))
    priors = stem._tiled_priors(z_hat, y_cond, th, tw, nt)
    target = (y_cur - y_cond).permute(0, 2, 3, 1)
    if nt > 1:
        target = wf.tile_plane(target, th, tw)
    coords, valid, rounds, encoder, *_ = stem._wavefront_setup(th, tw, serial)
    syms, idxs, recon = encoder(target, priors, rounds, b)
    flat = [wf.flatten_wavefront_grouped(p, coords, valid, b).cpu().numpy()
            for p in (syms, idxs)]
    if nt > 1:
        recon = wf.untile_plane(recon, b, h, w)
    return _nchw(recon.permute(0, 3, 1, 2)) + y_cond, flat[0], flat[1]


def _check_ar_frame(stem, enc, y_cur, y_cond, y_dec):
    """The encoder's reconstruction is the decoder's ŷ bit for bit, and
    every stream decodes, with the encoder's indexes, to the encoder's
    symbols."""
    y_enc, sym, idx = _encoder_pass(stem, enc, y_cur, y_cond)
    assert torch.equal(y_enc, y_dec)
    t = stem.tables["gaussian_conditional"]
    for i, s in enumerate(enc["strings"][0]):
        got = stem.coder.make_stream_decoder(s).decode(
            idx[i], t.cdf, t.cdf_length, t.offset)
        assert (got == sym[i]).all(), i


def _run_res(pipe, frames, y_cond):
    """serve_latent over the frames (y_cur from each frame's g_a, as the
    bench draws it); the encoder's reconstruction must be the decoder's ŷ
    bit for bit on every frame. Returns [(x̂, ŷ)], bytes per frame."""
    gen = torch.Generator(device=y_cond.device).manual_seed(13)
    dec, nbytes = [], []
    for k, x in enumerate(frames):
        y_cur = wavefront_y_cur(pipe.i_model, x, y_cond, gen)
        enc, y_hat, x_hat = pipe.serve_latent(y_cur, y_cond, frame=k)
        assert torch.equal(_encoder_pass(pipe.stem, enc, y_cur, y_cond)[0],
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


def _feed_noise(m, models=False):
    """The training tests' fed noise (tests/torch_port_util.py::fed_noise),
    set on the monkeypatch (context) ``m``: quantize_noise replaced by
    x + 0.45·sin(7·x + k), the identity's gradient, so every device and
    every run sees the same noise; with ``models`` also getY's
    (models/priors.py) and the STEM context's (models/stem.py)."""
    from spatiotemporalentropymodel_tpu_torch.entropy import (
        bottleneck, gaussian,
    )
    from spatiotemporalentropymodel_tpu_torch.models import priors, stem

    sites = [(bottleneck, 0.1), (gaussian, 0.7)]
    if models:
        sites += [(priors, 1.3), (stem, 2.9)]
    for mod, k in sites:
        m.setattr(mod, "quantize_noise", lambda x, generator, k=k: x + (
            0.45 * torch.sin(7.0 * x + k)).detach())


def _moved_gdn(mode, device):
    """A stand-in for gdn_fused: its plain version ("plain"), with each
    output scaled by 1 ± 1e-5, the signs drawn from a fixed seed
    ("random"), or by 1 + 1e-5 ("scaled")."""
    gen = torch.Generator(device=device).manual_seed(21)

    def plain(v, g, b, inverse=False):
        out = kernels._gdn_plain(v, g, b, bool(inverse))
        if mode == "random":
            sign = torch.empty(out.shape, device=out.device).bernoulli_(
                0.5, generator=gen) * 2 - 1
            out = out * (1 + 1e-5 * sign)
        elif mode == "scaled":
            out = out * (1 + 1e-5)
        return out

    return plain


def _train_grads(module, x, mode, monkeypatch):
    """Gradients of the RD loss of one train forward of ``module`` (fed
    noise), with gdn_fused's kernel ("kernel") or ``_moved_gdn``'s stand-in
    of the mode, and gdn_fused's launches."""
    from spatiotemporalentropymodel_tpu_torch.training import (
        rate_distortion_loss,
    )

    with monkeypatch.context() as m:
        _feed_noise(m)
        if mode != "kernel":
            m.setattr(kernels, "gdn_fused", _moved_gdn(mode, x.device))
        kernels.reset_launch_counts()
        loss = rate_distortion_loss(module(x, train=True), x)["loss"]
        grads = torch.autograd.grad(loss, list(module.parameters()),
                                    allow_unused=True)
        launched = kernels.LAUNCHES["gdn_fused"]
    return {n: g for (n, _), g in zip(module.named_parameters(), grads)
            if g is not None}, launched


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw", [(2, 128), (16, 256)])
def test_cuda_train_step_kernel_matches_plain(cuda, monkeypatch, b, hw):
    """One train_image step of MSH(128, 192) at 2×128×128 and at
    train_image's 16×256² with gdn_fused's kernel and with its plain
    version: the forward launches the kernel in each of the 6 (I)GDNs, and
    each gradient leaf moves no more than twice as far from the plain one
    as the plain runs with every (I)GDN output moved by 1e-5 relative (the
    f32 kernel's rtol), with random signs or all up, do."""
    model = MeanScaleHyperprior(128, 192, device=cuda, seed=2)
    x = torch.rand((b, 3, hw, hw), device=cuda,
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

    _feed_noise(monkeypatch, models=True)
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


# ---------------------------------------------------------------------------
# The kernels at the serving paths' shapes, then the paths themselves: the
# serving slices, the hero models, the file codecs and their CLIs, training,
# the autoregressive image models, the ROI family, charm and the parallel
# slice. Each path's launches are held exact by kernel, and by width where
# its model's widths are known. A test with a "cpu" case runs there at a
# small size with every wrapper call counted as its launch on the card would
# count it (``_count_on_cpu``).
# ---------------------------------------------------------------------------

B, H, W = 4, 1088, 1920  # 4 streams of 1080p frames (1080 rows padded)
N = M = 192
EBC = 256
P_FRAMES = 3
HERO_N = 128  # the hero I-model's N (artifacts/trained/hero/hero.json)
# the wide knobs' decode against the default one: mean|x̂_wide − x̂_default|
# (tests/test_torch_bf16_pipeline.py's mean criterion), and max|Δ| of the
# unclamped g_s outputs over max|default| (PLAIN_TOL's scale, doubled for
# one differing stage carried through two more)
WIDE_X_MEAN = 2e-3
WIDE_GS_TOL = 2**-5
RES_TILE = (1, 4)  # the JAX bench's wavefront tile (bench.py:692)
RES_BPP = (0.15, 0.30)  # the JAX package codes this workload at ≈ 0.223
SERIAL_ATOL = 1e-4  # serial vs wavefront ŷ (JAX tests/test_stem.py:123-125)
# the hero models against hero.json: bpp within 5 %, PSNR within 0.3 dB (the
# JAX figures came from another device's arithmetic; the CPU tests hold the
# port to the JAX package tightly)
HERO_BPP_REL, HERO_PSNR_DB = 0.05, 0.3
GOP_RTOL = 1e-5  # gop_forward's bpp_est vs estimate_bpp of stem.forward


@pytest.fixture
def card(cuda, monkeypatch):
    """The card as the serving pipelines run it: cuDNN deterministic (the
    encoder and the decoder compute bit-identical (σ, μ) from ẑ) and not
    autotuning; the launch counts from 0."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    kernels.reset_launch_counts()
    yield cuda
    torch.cuda.empty_cache()


def _count_on_cpu(monkeypatch):
    """On the CPU each wrapper runs its plain version and counts nothing:
    count each call there under the name and widths its launch on the card
    counts, so that a path's launches are held on the CPU too."""
    bf16 = torch.bfloat16

    def count(name, key):
        fn = getattr(kernels, name)

        def counted(*args, **kwargs):
            kernels._count(*key(*args))
            return fn(*args, **kwargs)

        monkeypatch.setattr(kernels, name, counted)

    count("gdn_fused", lambda x, *_: (
        "gdn_fused_bf16" if x.dtype == bf16 else "gdn_fused", x.shape[1]))
    count("quantize_and_index",
          lambda y, *_: (kernels._QIDX_ENTRIES[y.dtype][0],))
    for name in ("gdn_conv_fused", "conv_k5s2_f32"):
        count(name, lambda x, *a, name=name: (
            name, x.shape[1], a[-2].shape[0]))
    for name in ("igdn_deconv_wide_packed", "igdn_deconv_wide",
                 "igdn_deconv_tail_packed", "igdn_deconv_fused",
                 "deconv_k5s2_f32"):
        count(name, lambda x, *a, name=name: (
            name, x.shape[1], a[-2].shape[1]))


def _on(request, monkeypatch, where):
    """The device of a path's case: the CPU, with every wrapper call
    counted, for "cpu"; else the card (``card``)."""
    if where != "cpu":
        return request.getfixturevalue("card")
    _count_on_cpu(monkeypatch)
    kernels.reset_launch_counts()
    return torch.device("cpu")


def _want(**counts):
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want.update(counts)
    return want


def _launches(widths):
    """(LAUNCHES, LAUNCHES_BY_WIDTH) of launches by (kernel, *widths), the
    same key summed, zeros dropped."""
    by_width = {}
    for key, n in widths:
        by_width[key] = by_width.get(key, 0) + n
    by_width = {k: v for k, v in by_width.items() if v}
    counts = _want()
    for (name, *_), n in by_width.items():
        counts[name] += n
    return counts, by_width


def _msh_launches(n, m, bf16, n_ga, n_gs, n_q=0, wide=False, graph=False):
    """The launches of n_ga g_a and n_gs g_s passes of a MeanScaleHyperprior
    (N, M) (mbt2018's transforms are the same) and n_q quantizer calls. In
    bf16 g_a fuses its three GDN stages into gdn_conv_fused, N → N twice
    and N → M once, and g_s runs its first IGDN alone through gdn_fused's
    bf16 entry and its last two stages as the packed pair (under the wide
    knobs the lone wide kernel twice and the narrow one). In f32 every
    (I)GDN is a gdn_fused at N, g_a's four convs run as conv_k5s2_f32 and
    g_s's four transposed convs as deconv_k5s2_f32, unless autograd
    records them (``graph``: training)."""
    q = "quantize_and_index_bf16" if bf16 else "quantize_and_index"
    widths = [((q,), n_q)]
    if bf16:
        widths += [(("gdn_conv_fused", n, n), 2 * n_ga),
                   (("gdn_conv_fused", n, m), n_ga)]
        widths += ([(("igdn_deconv_wide", n, n), 2 * n_gs),
                    (("igdn_deconv_fused", n, 3), n_gs)] if wide else
                   [(("gdn_fused_bf16", n), n_gs),
                    (("igdn_deconv_wide_packed", n, n), n_gs),
                    (("igdn_deconv_tail_packed", n, 3), n_gs)])
    else:
        widths.append((("gdn_fused", n), 3 * (n_ga + n_gs)))
        if not graph:
            widths += [(("conv_k5s2_f32", c, o), n_ga)
                       for c, o in ((3, n), (n, n), (n, n), (n, m))]
            widths += [(("deconv_k5s2_f32", c, o), n_gs)
                       for c, o in ((m, n), (n, n), (n, n), (n, 3))]
    return _launches(widths)


def _launched(want):
    """The launches since the last reset are ``want``'s, by kernel and by
    width."""
    counts, by_width = want
    assert dict(kernels.LAUNCHES) == counts
    assert dict(kernels.LAUNCHES_BY_WIDTH) == by_width


def _stream_bytes(enc):
    return sum(len(s) for group in enc["strings"] for s in group)


# gdn_fused at the paths' shapes, (dtype, B, C, H, W): g_a's GDNs and g_s's
# IGDNs of the f32 path; g_s's first IGDN of the bf16 path, the hero's too;
# the ROI trunk's first GDN; the N = 256 path's; and C = 200, 320, 384 and
# 512, on no path, at 1080p shapes
GDN_PATH_SHAPES = [
    ("f32", B, N, H // 2, W // 2), ("f32", B, N, H // 4, W // 4),
    ("f32", B, N, H // 8, W // 8), ("bf16", B, N, H // 8, W // 8),
    ("bf16", 1, HERO_N, H // 8, W // 8),
    ("f32", 1, HERO_N, H // 2, W // 2), ("bf16", 1, HERO_N, H // 2, W // 2),
    ("f32", B, 256, H // 2, W // 2), ("bf16", B, 256, H // 8, W // 8),
    ("f32", 1, 320, H // 2, W // 2), ("bf16", 1, 320, H // 2, W // 2),
    ("f32", 1, 512, H // 2, W // 2), ("bf16", 1, 512, H // 2, W // 2),
    ("f32", 1, 200, H // 8, W // 8), ("bf16", 1, 200, H // 8, W // 8),
    ("f32", 1, 384, H // 8, W // 8), ("bf16", 1, 384, H // 8, W // 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,b,c,h,w", GDN_PATH_SHAPES,
                         ids=lambda v: str(v))
def test_cuda_gdn_fused_at_path_shapes(cuda, dtype, b, c, h, w):
    """gdn_fused, forward and inverse, at the serving paths' shapes against
    its plain version: f32 at rtol 1e-5, atol 1e-6; bf16 at rtol 2⁻⁷ (one
    bf16 step: only the f32 summation order differs). Each launch counted
    at its width."""
    gen = torch.Generator(device=cuda).manual_seed(c + h)
    gamma_t, beta = _gdn_params(np.random.default_rng(c + h), c, cuda)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    x = torch.randn((b, c, h, w), generator=gen, device=cuda).to(dt)
    rtol = 2**-7 if dtype == "bf16" else 1e-5
    kernels.reset_launch_counts()
    for inverse in (False, True):
        out = kernels.gdn_fused(x, gamma_t, beta, inverse)
        ref = kernels._gdn_ref(x.float(), gamma_t, beta, inverse).to(dt)
        assert out.dtype == dt and out.shape == x.shape
        torch.testing.assert_close(out.float(), ref.float(), rtol=rtol,
                                   atol=1e-6)
        del out, ref
    name = "gdn_fused_bf16" if dtype == "bf16" else "gdn_fused"
    assert kernels.LAUNCHES_BY_WIDTH == {(name, c): 2}


# the fused bf16 kernels at the paths' shapes, (kernel, B, C, O, H, W) of
# the input: g_a's three GDN → conv stages of the 192-wide models, of the
# hero I-model (N 128, M 192, one picture) and of N = 256, M = 320; g_s's
# packed pair from 272 × 480 ("pair": the wide kernel C → C, then the tail
# C → 3 on its output, as on the path); and the wide knobs' lone kernels at
# the chain's first and last stages (240 columns leave a partial tile)
FUSED_PATH_SHAPES = [
    ("gdn_conv_fused", B, N, N, H // 2, W // 2),
    ("gdn_conv_fused", B, N, N, H // 4, W // 4),
    ("gdn_conv_fused", B, N, N, H // 8, W // 8),
    ("gdn_conv_fused", 1, HERO_N, HERO_N, H // 2, W // 2),
    ("gdn_conv_fused", 1, HERO_N, HERO_N, H // 4, W // 4),
    ("gdn_conv_fused", 1, HERO_N, M, H // 8, W // 8),
    ("gdn_conv_fused", B, 256, 256, H // 2, W // 2),
    ("gdn_conv_fused", B, 256, 256, H // 4, W // 4),
    ("gdn_conv_fused", B, 256, 320, H // 8, W // 8),
    ("pair", B, N, N, H // 4, W // 4),
    ("pair", 1, HERO_N, HERO_N, H // 4, W // 4),
    ("pair", B, 256, 256, H // 4, W // 4),
    ("igdn_deconv_wide", B, N, N, H // 8, W // 8),
    ("igdn_deconv_fused", B, N, 3, H // 2, W // 2),
    ("igdn_deconv_wide", B, 256, 256, H // 8, W // 8),
    ("igdn_deconv_fused", B, 256, 3, H // 2, W // 2),
]


def _fused_at_path(fn, plain, x, o, gen, deconv):
    """fn (a fused kernel C → O) on x with the models' init-scale bf16
    weights, against its plain version at max|out − plain| ≤
    2⁻⁶·max|plain|; returns the output."""
    c = x.shape[1]
    gamma_t, beta = _gdn_params(np.random.default_rng(c + o), c, x.device)
    weight = (torch.randn((c, o, 5, 5) if deconv else (o, c, 5, 5),
                          generator=gen, device=x.device)
              * (2.0 / (25 * c)) ** 0.5).to(torch.bfloat16)
    bias = 0.1 * torch.randn((o,), generator=gen, device=x.device)
    out = fn(x, gamma_t, beta, weight, bias)
    ref = plain(x, gamma_t, beta, weight, bias)
    assert bool(torch.isfinite(out).all())
    _assert_scaled_close(out, ref, PLAIN_TOL)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,b,c,o,h,w", FUSED_PATH_SHAPES,
                         ids=lambda v: str(v))
def test_cuda_fused_kernels_at_path_shapes(cuda, kernel, b, c, o, h, w):
    """The fused bf16 kernels at the serving paths' shapes against their
    plain versions (which keep the (I)GDN'd window in f32) at max|kernel −
    plain| ≤ 2⁻⁶·max|plain|, each launch counted at its widths."""
    gen = torch.Generator(device=cuda).manual_seed(c + o + h)
    x = torch.randn((b, c, h, w), generator=gen,
                    device=cuda).to(torch.bfloat16)
    kernels.reset_launch_counts()
    if kernel == "pair":
        mid = _fused_at_path(kernels.igdn_deconv_wide_packed,
                             kernels._igdn_deconv_ref, x, o, gen, True)
        del x
        _fused_at_path(kernels.igdn_deconv_tail_packed,
                       kernels._igdn_deconv_ref, mid, 3, gen, True)
        want = {("igdn_deconv_wide_packed", c, o): 1,
                ("igdn_deconv_tail_packed", o, 3): 1}
    else:
        plain = (kernels._gdn_conv_ref if kernel == "gdn_conv_fused"
                 else kernels._igdn_deconv_ref)
        _fused_at_path(getattr(kernels, kernel), plain, x, o, gen,
                       kernel != "gdn_conv_fused")
        want = {(kernel, c, o): 1}
    assert kernels.LAUNCHES_BY_WIDTH == want


def _headline_slice(device, b, h, w, n, m, ebc):
    """MeanScaleHyperprior(n, m) and a without_spm STEM (EB ebc, in_channels
    m) from seeds with the benchmark workload's surgery (at f32), P_FRAMES
    frames of b × 3 × h × w and a y_cond of their latent's shape, drawn on
    ``device``."""
    imodel = MeanScaleHyperprior(n, m, device=device, seed=0)
    stem = SpatioTemporalPriorModel(variant="without_spm",
                                    entropy_bottleneck_channels=ebc,
                                    in_channels=m, device=device, seed=1)
    realistic_stem(stem)
    gen = torch.Generator(device=device).manual_seed(0)
    frames = [torch.rand((b, 3, h, w), generator=gen, device=device)
              for _ in range(P_FRAMES)]
    y_cond = 0.5 * torch.randn((b, m, h // 16, w // 16), generator=gen,
                               device=device)
    match_latent_to_prior(imodel, stem, frames[0], y_cond)
    return imodel, stem, frames, y_cond


SLICES = {  # (B, H, W, N, M, EB)
    "cpu": (2, 64, 64, 64, 64, 32),
    "n192": (B, H, W, N, M, EBC),
    "n256": (B, H, W, 256, 320, EBC),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("where", [
    "cpu", pytest.param("n192", marks=pytest.mark.cuda),
    pytest.param("n256", marks=pytest.mark.cuda)])
def test_sparse_slice_exact(request, monkeypatch, where, dtype):
    """MeanScaleHyperprior(N, M) and a without_spm STEM (EB 256, in_channels
    M) from seeds with the benchmark workload's surgery (at f32) through
    StemVideoPipeline(sparse): 3 P-frames of 4 × 3 × 1088 × 1920 encoded
    with encode_frames and decoded with decode_frames, at N = M = 192 and
    at N = 256, M = 320. Every frame sparse, the launches exact by kernel
    and width, encode_frame's streams encode_frames', encoder ŷ == decoder
    ŷ bit for bit, x̂ finite of the frames' shape and dtype, bpp finite
    (below 1 at N = M = 192). In bf16 the same streams then decode under
    the wide knobs (ŷ the default decode's, mean|Δx̂| ≤ 2e-3, g_s's
    unclamped outputs within 2⁻⁵·max|default|), and the I-frame codec
    round-trips frame 0 under both knob sets (launches exact, encoder ŷ ==
    decoder ŷ, streams that repeat). On the CPU at N = M = 64, EB 32, 2 ×
    64 × 64."""
    device = _on(request, monkeypatch, where)
    b, h, w, n, m, ebc = SLICES[where]
    bf16 = dtype == torch.bfloat16
    imodel, stem, frames, y_cond = _headline_slice(device, *SLICES[where])
    imodel.update()
    if bf16:  # after the surgery and update(), as set_compute_dtype needs
        imodel.set_compute_dtype(dtype)
        stem.set_compute_dtype(dtype)
    pipe = StemVideoPipeline(imodel, stem, transport_mode="sparse")
    enc, _ = pipe.encode_frame(frames[0], y_cond)  # warm-up, not counted
    pipe.decode_frame(enc, y_cond=y_cond)
    kernels.reset_launch_counts()
    encs = list(pipe.encode_frames(frames, y_cond))
    decoded = list(pipe.decode_frames(encs, y_cond))
    assert [e["transport"] for e in encs] == ["sparse"] * P_FRAMES
    _launched(_msh_launches(n, m, bf16, P_FRAMES, P_FRAMES, P_FRAMES))
    # the encoder's carry, frame by frame through encode_frame (the same
    # device expressions as encode_frames), against the decoder's ŷ
    y_enc = y_cond
    for i, (enc, (x_hat, y_dec)) in enumerate(zip(encs, decoded)):
        again, y_enc = pipe.encode_frame(frames[i], y_enc)
        assert again["strings"] == enc["strings"], i
        assert torch.equal(y_enc, y_dec), i
        assert x_hat.shape == (b, 3, h, w) and x_hat.dtype == dtype
        assert bool(torch.isfinite(x_hat).all())
        bpp = (_stream_bytes(enc) + enc["counts"].nbytes) * 8 / (b * h * w)
        assert np.isfinite(bpp) and (where != "n192" or bpp < 1.0), bpp
    if not bf16:
        return

    kernels.reset_launch_counts()
    with kernels.knobs(**kernels.WIDE_KNOBS):
        wide = list(pipe.decode_frames(encs, y_cond))
    _launched(_msh_launches(n, m, True, 0, P_FRAMES, wide=True))
    for (x_w, y_w), (x_d, y_d) in zip(wide, decoded):
        assert torch.equal(y_w, y_d)
        assert x_w.shape == (b, 3, h, w) and bool(torch.isfinite(x_w).all())
        assert float((x_w.float() - x_d.float()).abs().mean()) <= WIDE_X_MEAN
    y0 = imodel._cast_in(decoded[0][1])
    with torch.no_grad():
        ref = imodel.module.g_s(y0).float()
        with kernels.knobs(**kernels.WIDE_KNOBS):
            out = imodel.module.g_s(y0).float()
    assert float((out - ref).abs().max()) <= \
        WIDE_GS_TOL * float(ref.abs().max())

    x = frames[0]
    for wide_knobs in (False, True):
        with kernels.knobs(**(kernels.WIDE_KNOBS if wide_knobs else {})):
            imodel.decompress(**imodel.compress(x))  # warm-up
            kernels.reset_launch_counts()
            enc = imodel.compress(x)
            dec = imodel.decompress(**enc)
            _launched(_msh_launches(n, m, True, 1, 1, 1, wide=wide_knobs))
            _, y_enc = imodel.fused_encode_expr(x)
            assert imodel.compress(x)["strings"] == enc["strings"]
        assert torch.equal(y_enc, dec["y_hat"])
        x_hat = dec["x_hat"]
        assert x_hat.shape == (b, 3, h, w) and x_hat.dtype == torch.bfloat16
        assert bool(torch.isfinite(x_hat).all())
        assert _stream_bytes(enc) > 0
    assert (kernels.FUSE_GS_PACKED, kernels.FUSE_IGDN_DECONV_WIDE) == (
        True, False)


@pytest.mark.parametrize("where", [
    "cpu", pytest.param("n192", marks=pytest.mark.cuda)])
def test_res_wavefront_exact(request, monkeypatch, where):
    """The flagship, the JAX bench's wavefront server (bench.py:648-689) at
    S = 4 streams: STEM res (EB 256, bf16) with wavefront tile (1, 4) and
    MeanScaleHyperprior(192, 192) in bf16 serve 3 P-frames of 4 × 3 × 1088
    × 1920 through WavefrontVideoPipeline.serve_latent, y_cur = y_cond +
    0.2·ε with g_a run on the pixel frame. The launches exact by width; per
    frame the encoder's reconstruction + y_cond is the decoder's ŷ bit for
    bit, every stream decodes with the encoder's indexes to its symbols, a
    second encode repeats the streams, x̂ is finite bf16 of the frames'
    shape and bpp within (0.15, 0.30); a frame decodes in 4 rounds; and
    each stream of frame 1, coded alone, gives the batched streams byte for
    byte and the batched ŷ bit for bit. On the CPU at N = M = 64, EB 32, 2
    × 64 × 64, where the bpp band does not apply."""
    device = _on(request, monkeypatch, where)
    b, h, w, n, m, ebc = SLICES[where]
    imodel = MeanScaleHyperprior(n, m, device=device, seed=0)
    stem = SpatioTemporalPriorModel(variant="res",
                                    entropy_bottleneck_channels=ebc,
                                    in_channels=m, wavefront_tile=RES_TILE,
                                    device=device, seed=1)
    realistic_stem(stem)
    imodel.set_compute_dtype(torch.bfloat16)
    stem.set_compute_dtype(torch.bfloat16)
    pipe = WavefrontVideoPipeline(imodel, stem)
    gen = torch.Generator(device=device).manual_seed(5)
    y_cond = 0.5 * torch.randn((b, m, h // 16, w // 16), generator=gen,
                               device=device)
    x_pix = torch.rand((b, 3, h, w), generator=gen, device=device)
    pipe.serve_latent(wavefront_y_cur(imodel, x_pix, y_cond, gen),
                      y_cond)  # warm-up
    kernels.reset_launch_counts()
    gen = torch.Generator(device=device).manual_seed(13)
    frames = []
    for k in range(P_FRAMES):
        y_cur = wavefront_y_cur(imodel, x_pix, y_cond, gen)
        enc, y_hat, x_hat = pipe.serve_latent(y_cur, y_cond, frame=k)
        frames.append((y_cur, y_cond, enc, y_hat, x_hat))
        y_cond = y_hat
    _launched(_msh_launches(n, m, True, P_FRAMES, P_FRAMES))
    for y_cur, y_cond, enc, y_hat, x_hat in frames:
        _check_ar_frame(stem, enc, y_cur, y_cond, y_hat)
        assert pipe.encode_frame(y_cur, y_cond)["strings"] == enc["strings"]
        assert x_hat.shape == (b, 3, h, w) and x_hat.dtype == torch.bfloat16
        assert bool(torch.isfinite(x_hat).all())
        bpp = _stream_bytes(enc) * 8 / (b * h * w)
        assert where == "cpu" or RES_BPP[0] < bpp < RES_BPP[1], bpp
    y_cur, y_cond = frames[0][:2]
    stem._codec_stats = {}
    try:
        pipe.serve_latent(y_cur, y_cond)
        rounds = stem._codec_stats["rounds"]
    finally:
        stem._codec_stats = None
    assert rounds == 3 * (RES_TILE[0] - 1) + RES_TILE[1]
    y_cur, y_cond, enc, y_hat = frames[1][:4]
    for i in range(b):
        solo = pipe.encode_frame(y_cur[i:i + 1], y_cond[i:i + 1])
        assert solo["strings"][0][0] == enc["strings"][0][i], i
        assert solo["strings"][1][0] == enc["strings"][1][i], i
        assert torch.equal(pipe.decode_frame(solo, y_cond[i:i + 1]),
                           y_hat[i:i + 1]), i


@pytest.mark.cuda
def test_cuda_serial_ar_codec_matches_wavefront(card):
    """The serial AR codec on a small f32 res model (M = 32), one stream at
    a 4 × 8 latent: in both modes the encoder's reconstruction is the
    decoder's ŷ and the symbols decode; the serial ŷ is the untiled
    wavefront's within 1e-4 (the two batch different numbers of crops, so
    their bits may differ)."""
    stem = SpatioTemporalPriorModel(variant="res",
                                    entropy_bottleneck_channels=32,
                                    in_channels=32, ar_mode="serial",
                                    device=card, seed=3)
    stem.update()
    gen = torch.Generator(device=card).manual_seed(21)
    y_cur = torch.randn((1, 32, 4, 8), generator=gen, device=card)
    y_cond = y_cur + 0.3 * torch.randn(y_cur.shape, generator=gen,
                                       device=card)
    y_hat = {}
    for mode in ("serial", "wavefront"):
        stem.ar_mode = mode
        enc = stem.compress(y_cur, y_cond)
        dec = stem.decompress(enc["strings"], enc["shape"], y_cond)
        _check_ar_frame(stem, enc, y_cur, y_cond, dec["y_hat"])
        y_hat[mode] = dec["y_hat"]
    err = float((y_hat["serial"] - y_hat["wavefront"]).abs().max())
    assert err <= SERIAL_ATOL


def _within_band(got, ref):
    """bpp within 5 % of ref's, PSNR within 0.3 dB."""
    assert abs(got["bpp"] - ref["bpp"]) <= HERO_BPP_REL * ref["bpp"], (
        got, ref)
    assert abs(got["psnr"] - ref["psnr"]) <= HERO_PSNR_DB, (got, ref)


def _hero_frames(device):
    """The hero serving probe's 4 frames of 1088 × 1920 as (1, 3, H, W) f32
    in [0, 1] on ``device``."""
    from spatiotemporalentropymodel_tpu_torch.eval import workload

    return [torch.from_numpy(f).permute(2, 0, 1)[None].contiguous()
            .to(device).float() / 255.0 for f in workload.hero_1080p_frames()]


def _iframe_y_hat(i_model, x):
    """The I-frame codec on x: the decoder's ŷ, which must be the
    encoder's."""
    enc = i_model.compress(x)
    dec = i_model.decompress(enc["strings"], enc["shape"])
    _, y_enc = i_model.fused_encode_expr(x)
    assert torch.equal(y_enc, dec["y_hat"])
    return dec["y_hat"]


@pytest.mark.cuda
def test_cuda_hero_gop_eval(card):
    """The trained hero models (eval/workload.py::load_hero, read with no
    jax) through eval_dataset on the hero GOP eval set (2 × 24 frames of
    256², GOP 12) in f32 with the model API, as tools/bakeoff.py::_eval_cfg
    ran it: each variant's launches exact by width, bpp within 5 % and PSNR
    within 0.3 dB of hero.json; then MS-SSIM of one decoded I-frame in
    (0, 1]."""
    from spatiotemporalentropymodel_tpu_torch.eval.eval_stem import (
        eval_dataset,
    )
    from spatiotemporalentropymodel_tpu_torch.eval.metrics import ms_ssim
    from spatiotemporalentropymodel_tpu_torch.eval.workload import (
        hero_config, hero_gop_set, load_hero,
    )

    models = load_hero(device=card)
    ref = hero_config()["eval"]
    seqs = hero_gop_set()
    n_i = sum(1 for q in seqs for f in q if f.is_intra)
    n_p = sum(len(q) for q in seqs) - n_i
    for variant in ("res", "without_spm"):
        kernels.reset_launch_counts()
        res = eval_dataset(models["i"], models[variant], seqs,
                           compute_msssim=False, report_estimated_bpp=True)
        # I-frame: forward (g_a, g_s), compress (g_a), decompress (g_s);
        # P-frame: get_y (g_a), get_x (g_s)
        passes = 2 * n_i + n_p
        q = n_i + (n_p if variant == "without_spm" else 0)
        _launched(_msh_launches(HERO_N, M, False, passes, passes, q))
        _within_band(res["average"], ref[variant])
    frame = next(iter(seqs[0]))
    x = torch.from_numpy(frame.image).permute(2, 0, 1)[None].contiguous()
    x = x.to(card)
    enc = models["i"].compress(x)
    x_hat = models["i"].decompress(enc["strings"], enc["shape"])["x_hat"]
    assert 0.0 < float(ms_ssim(x, x_hat)) <= 1.0


@pytest.mark.cuda
def test_cuda_hero_serving_1080p_and_gop_forward(card):
    """The hero without_spm pair on the serving probe's 4 frames of 1088 ×
    1920, in f32 then bf16: frame 0 through the I-frame codec, then 3
    P-frames through StemVideoPipeline(sparse) at B = 1, every frame
    sparse, encoder ŷ == decoder ŷ, the launches exact by width, bpp (the
    streams and the row counts' raw bytes, as tools/bakeoff.py::
    _serving_1080p charges it) and PSNR held to hero.json's serving_1080p
    in f32 and to the port's f32 in bf16 (5 %, 0.3 dB); then the same
    P-frames through gop_forward: launches exact, x̂ finite, and each
    frame's bpp_est equal to estimate_bpp of stem.forward on the same
    latents (rtol 1e-5)."""
    from spatiotemporalentropymodel_tpu_torch.eval.metrics import (
        estimate_bpp, psnr,
    )
    from spatiotemporalentropymodel_tpu_torch.eval.workload import (
        hero_config, load_hero,
    )

    models = load_hero(device=card)
    i_model, stem = models["i"], models["without_spm"]
    frames = _hero_frames(card)
    h, w = frames[0].shape[2:]
    p = len(frames) - 1
    served = {}
    for bf16 in (False, True):
        if bf16:
            i_model.set_compute_dtype(torch.bfloat16)
            stem.set_compute_dtype(torch.bfloat16)
        pipe = StemVideoPipeline(i_model, stem, transport_mode="sparse")
        yc = _iframe_y_hat(i_model, frames[0])
        enc, _ = pipe.encode_frame(frames[1], yc)  # warm-up
        pipe.decode_frame(enc, y_cond=yc)
        kernels.reset_launch_counts()
        total, psnrs = 0, []
        for t in range(1, len(frames)):
            enc, y_carry = pipe.encode_frame(frames[t], yc)
            x_hat, y_next = pipe.decode_frame(enc, y_cond=yc)
            assert enc["transport"] == "sparse", t
            assert torch.equal(y_carry, y_next), t
            total += _stream_bytes(enc) + enc["counts"].nbytes
            psnrs.append(float(psnr(frames[t], x_hat)))
            yc = y_next
        _launched(_msh_launches(HERO_N, M, bf16, p, p, p))
        served[bf16] = dict(bpp=total * 8.0 / (p * h * w),
                            psnr=sum(psnrs) / p)

        pipe = StemVideoPipeline(i_model, stem)
        y0 = _iframe_y_hat(i_model, frames[0])
        gop = torch.stack(frames[1:])  # (T, 1, 3, H, W)
        pipe.gop_forward(gop[:1], y0)  # warm-up
        kernels.reset_launch_counts()
        x_hats, bpps = pipe.gop_forward(gop, y0)
        _launched(_msh_launches(HERO_N, M, bf16, p, p))
        assert x_hats.shape == (p, 1, 3, h, w)
        assert bool(torch.isfinite(x_hats).all())
        y_cond = y0
        with torch.no_grad():
            for t in range(p):
                out = stem.forward(i_model.analysis(gop[t]), y_cond)
                want = estimate_bpp(out["likelihoods"], h * w)
                assert abs(float(bpps[t, 0]) - want) <= GOP_RTOL * want, t
                y_cond = out["y_hat"]
    _within_band(served[False], hero_config()["serving_1080p"])
    _within_band(served[True], served[False])


@pytest.mark.cuda
def test_cuda_hero_res_wavefront_bf16(card):
    """The hero res through WavefrontVideoPipeline, tile (1, 4), bf16, B = 1,
    on the serving probe's P-frames: the launches exact by width, and on
    every frame the encoder's reconstruction is the decoder's ŷ and the
    streams decode to the encoder's symbols (hero.json has no such
    figure)."""
    from spatiotemporalentropymodel_tpu_torch.eval.workload import load_hero

    models = load_hero(device=card, variants=("res",),
                       wavefront_tile=RES_TILE)
    i_model, stem = models["i"], models["res"]
    i_model.set_compute_dtype(torch.bfloat16)
    stem.set_compute_dtype(torch.bfloat16)
    pipe = WavefrontVideoPipeline(i_model, stem)
    frames = _hero_frames(card)
    yc = _iframe_y_hat(i_model, frames[0])
    pipe.serve_latent(pipe.analysis(frames[1]), yc)  # warm-up
    kernels.reset_launch_counts()
    served = []
    for t in range(1, len(frames)):
        y_cur = pipe.analysis(frames[t])
        enc, y_hat, _ = pipe.serve_latent(y_cur, yc, frame=t)
        served.append((y_cur, yc, enc, y_hat))
        yc = y_hat
    p = len(served)
    _launched(_msh_launches(HERO_N, M, True, p, p))
    for y_cur, y_cond, enc, y_hat in served:
        _check_ar_frame(stem, enc, y_cur, y_cond, y_hat)


def _file_records(vc, path, n):
    with open(path, "rb") as f:
        hdr = vc.read_header(f)
        return hdr, [vc._read_frame(f) for _ in range(n)]


def _record_bytes(strings, counts):
    """A record's size on the wire: 5 bytes of type and ẑ shape, the
    packed row counts of a sparse record, 4 bytes and the payload per
    string."""
    from spatiotemporalentropymodel_tpu_torch.entropy.transport import (
        pack_counts,
    )

    size = 5 + sum(4 + len(g[0]) for g in strings)
    if counts is not None:
        size += len(pack_counts(np.asarray(counts).reshape(1, -1)))
    return size


def _counted(want, fn):
    """fn() with the launch counts from 0, held to ``want`` after it;
    returns fn()'s result."""
    kernels.reset_launch_counts()
    out = fn()
    _launched(want)
    return out


def _file_leg(i_model, stem, frames, tmp, tag, bf16):
    """One .stemv of the hero without_spm pair (family 0): encode_video and
    decode_video of the frames (H × W × 3 f32), GOP = their count, the
    launches exact, then decode_video(output_dir) again. Every P record
    sparse, the header's hashes the models', the PNGs the decoded frames as
    decode_video converts them, the streams and frames the in-memory
    chain's (I compress and decompress, the pipeline's encode_frame and
    decode_frame) and the file's size its records' to the byte. Returns
    the P-frames' {bpp, psnr} over the picture's rows."""
    from spatiotemporalentropymodel_tpu_torch.data.png import read_png
    from spatiotemporalentropymodel_tpu_torch.eval import video_codec as vc
    from spatiotemporalentropymodel_tpu_torch.eval.codec import to_png_array
    from spatiotemporalentropymodel_tpu_torch.eval.metrics import psnr
    from spatiotemporalentropymodel_tpu_torch.ops.padding import pad_centered

    n = len(frames)
    path, pngs = tmp / f"{tag}.stemv", tmp / f"{tag}_png"
    meta = {"i_model": "mbt2018-mean", "i_quality": 3}
    _counted(_msh_launches(HERO_N, M, bf16, n, 1, n),
             lambda: vc.encode_video(frames, i_model, stem, path, gop=n,
                                     meta=meta))
    decoded = _counted(_msh_launches(HERO_N, M, bf16, 0, n),
                       lambda: vc.decode_video(path, i_model, stem))
    again = vc.decode_video(path, i_model, stem, output_dir=pngs)
    assert all(np.array_equal(a, b) for a, b in zip(again, decoded))
    hdr, records = _file_records(vc, path, n)
    assert [r[0] for r in records] == (
        [vc.FTYPE_I] + [vc.FTYPE_P_SPARSE] * (n - 1))
    assert (hdr["stem_params_hash"], hdr["i_params_hash"]) == (
        vc.params_hash(stem), vc.params_hash(i_model))
    for t, fr in enumerate(decoded):
        assert np.array_equal(read_png(pngs / f"frame_{t:04d}.png"),
                              to_png_array(fr)), t
    pipe = StemVideoPipeline(i_model, stem, transport_mode="sparse")
    h, w = frames[0].shape[:2]
    top = (-(-h // 64) * 64 - h) // 2
    size, yc = 45, None  # the header's 45 bytes
    for t, fr in enumerate(frames):
        x, _ = pad_centered(
            torch.from_numpy(fr).permute(2, 0, 1)[None].to(
                i_model.device), 64)
        if t == 0:
            enc = i_model.compress(x)
            dec = i_model.decompress(enc["strings"], enc["shape"])
            x_hat, yc, counts = dec["x_hat"], dec["y_hat"], None
        else:
            enc, _ = pipe.encode_frame(x, yc)
            x_hat, yc = pipe.decode_frame(enc, y_cond=yc)
            counts = enc["counts"]
        assert enc["strings"] == records[t][3], t
        want = x_hat[0].float().permute(1, 2, 0).cpu().numpy()[top:top + h]
        assert np.array_equal(decoded[t], want), t
        size += _record_bytes(enc["strings"], counts)
    assert path.stat().st_size == size
    p_bytes = sum(_record_bytes(r[3], r[2]) for r in records[1:])
    psnrs = [float(psnr(torch.from_numpy(frames[t]),
                        torch.from_numpy(decoded[t]))) for t in range(1, n)]
    return dict(bpp=p_bytes * 8.0 / ((n - 1) * h * w),
                psnr=sum(psnrs) / len(psnrs))


@pytest.mark.cuda
def test_cuda_stemv_files_of_the_hero_models(card, tmp_path):
    """The .stemv files of the hero without_spm pair (family 0), GOP 4, on
    the serving probe's frames: in f32 on its own 1088-row frames, whose
    P-frames' bpp and PSNR fall in the band of hero.json's 1080p serving
    figures; then, in f32 and bf16, on the frames cut to 1080 × 1920 (rows
    4-1083, which the codec pads to 1088), held by exactness only (the
    centred padding's black rows cost bits that hero.json's frames never
    paid). Each leg as ``_file_leg`` holds it."""
    from spatiotemporalentropymodel_tpu_torch.eval import workload

    full_u8 = workload.hero_1080p_frames()
    models = workload.load_hero(device=card, variants=("without_spm",))
    i_model, stem = models["i"], models["without_spm"]
    got = _file_leg(i_model, stem,
                    [f.astype(np.float32) / 255.0 for f in full_u8],
                    tmp_path, "f32_1088", False)
    _within_band(got, workload.hero_config()["serving_1080p"])
    cut = [f[4:-4].astype(np.float32) / 255.0 for f in full_u8]
    for bf16 in (False, True):
        if bf16:
            i_model.set_compute_dtype(torch.bfloat16)
            stem.set_compute_dtype(torch.bfloat16)
        _file_leg(i_model, stem, cut, tmp_path, f"cut_{bf16}", bf16)


@pytest.mark.cuda
def test_cuda_stemv_wavefront_file_of_the_hero_res(card, tmp_path):
    """The hero res at tile (1, 4), bf16, through encode_video and
    decode_video (family 1) on the probe's frames cut to 1080 rows: the
    tile in the header, I then wavefront P records, the launches exact,
    and the decoded frames the model-API chain's exactly
    (tests/test_video_codec.py:146-195)."""
    from spatiotemporalentropymodel_tpu_torch.eval import video_codec as vc
    from spatiotemporalentropymodel_tpu_torch.eval import workload
    from spatiotemporalentropymodel_tpu_torch.ops.padding import pad_centered

    frames = [f[4:-4].astype(np.float32) / 255.0
              for f in workload.hero_1080p_frames()]
    n, h = len(frames), frames[0].shape[0]
    models = workload.load_hero(device=card, variants=("res",),
                                wavefront_tile=RES_TILE)
    i_model, stem = models["i"], models["res"]
    i_model.set_compute_dtype(torch.bfloat16)
    stem.set_compute_dtype(torch.bfloat16)
    path = tmp_path / "res.stemv"
    _counted(_msh_launches(HERO_N, M, True, n, 1, 1),
             lambda: vc.encode_video(frames, i_model, stem, path, gop=n))
    decoded = _counted(_msh_launches(HERO_N, M, True, 0, n),
                       lambda: vc.decode_video(path, i_model, stem))
    hdr, records = _file_records(vc, path, n)
    assert (hdr["stem_family"], hdr["cfg0"], hdr["cfg1"]) == (1, *RES_TILE)
    assert [r[0] for r in records] == (
        [vc.FTYPE_I] + [vc.FTYPE_P_WAVEFRONT] * (n - 1))
    top = (-(-h // 64) * 64 - h) // 2
    yc = None
    for t, fr in enumerate(frames):
        x, _ = pad_centered(torch.from_numpy(fr).permute(2, 0, 1)[None]
                            .to(card), 64)
        if t == 0:
            enc = i_model.compress(x)
            dec = i_model.decompress(enc["strings"], enc["shape"])
            x_hat, yc = dec["x_hat"], dec["y_hat"]
        else:
            enc = stem.compress(i_model.analysis(x), yc)
            yc = stem.decompress(enc["strings"], enc["shape"], yc)["y_hat"]
            x_hat = i_model.get_x(yc)
        want = x_hat[0].float().permute(1, 2, 0).cpu().numpy()[top:top + h]
        assert np.array_equal(decoded[t], want), t


def _paeth_png(path, rgb):
    """rgb as an 8-bit RGB PNG whose rows all use the Paeth filter. The
    encoder's predictors read the original pixels, so it vectorises; the
    reader's depend on the pixels it rebuilds (data/png.py's diagonals)."""
    import struct
    import zlib

    from spatiotemporalentropymodel_tpu_torch.data import png

    h, w, _ = rgb.shape
    x = rgb.astype(np.int16)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    raw = np.empty((h, 3 * w + 1), np.uint8)
    raw[:, 0] = 4
    raw[:, 1:] = ((x - pred) & 0xFF).reshape(h, 3 * w)
    with open(path, "wb") as f:
        f.write(png.SIGNATURE
                + png._chunk(b"IHDR", struct.pack(">2I5B", w, h, 8, 2, 0, 0,
                                                  0))
                + png._chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + png._chunk(b"IEND", b""))


def test_png_of_a_1080p_frame_reads_back(tmp_path):
    """data/png.py on the serving probe's first 1080p frame (host code, the
    same on every machine): its writer's file (Up rows) and one whose rows
    all use the Paeth filter each read back to the frame exactly."""
    from spatiotemporalentropymodel_tpu_torch.data.png import (
        read_png, write_png,
    )
    from spatiotemporalentropymodel_tpu_torch.eval.workload import (
        hero_1080p_frames,
    )

    frame = hero_1080p_frames()[0][4:-4]
    for name, write in (("up", write_png), ("paeth", _paeth_png)):
        write(tmp_path / f"{name}.png", frame)
        assert np.array_equal(read_png(tmp_path / f"{name}.png"), frame)


def _bin_strings(codec, path, n):
    """The strings of a .bin file: past its 2 + 8 + 12 bytes of header,
    ``n`` length-prefixed strings."""
    with open(path, "rb") as f:
        f.read(2 + 8 + 12)
        return [[f.read(codec._read_uints(f, 1)[0])] for _ in range(n)]


@pytest.mark.cuda
def test_cuda_codec_clis_on_png_files(card, tmp_path):
    """Both CLIs through main(argv), f32, on PNG files that data/png.py
    wrote from the probe's frames cut to 1080 rows: video_codec with the
    hero I checkpoint (mbt2018-mean, quality 3) and a seeded STEM (EB 128),
    its records I then sparse or dense P, its decode decode_video's of the
    same file; codec with the hero I checkpoint, then bmshj2018-factorized
    and bmshj2018-hyperprior at quality 1 from their seeds, the strings
    compress's and the decoded PNG decompress's. Launches exact."""
    from types import SimpleNamespace

    from spatiotemporalentropymodel_tpu_torch.data.png import (
        read_png, write_png,
    )
    from spatiotemporalentropymodel_tpu_torch.eval import codec
    from spatiotemporalentropymodel_tpu_torch.eval import video_codec as vc
    from spatiotemporalentropymodel_tpu_torch.eval import workload
    from spatiotemporalentropymodel_tpu_torch.ops.padding import pad_centered

    dev = ["--device", card.type]
    ckpt = str(workload.HERO_DIR / "ckpt_i_0.012.pkl.gz")
    frames_u8 = [f[4:-4] for f in workload.hero_1080p_frames()]
    src = tmp_path / "frames"
    src.mkdir()
    for t, f in enumerate(frames_u8):
        write_png(src / f"frame_{t:04d}.png", f)
    n, h, w = len(frames_u8), *frames_u8[0].shape[:2]
    out = tmp_path / "cli.stemv"
    kernels.reset_launch_counts()
    vc.main(["encode", str(src), "-o", str(out), "--gop", str(n),
             "--i-model", "mbt2018-mean", "--i-quality", "3",
             "--i-checkpoint", ckpt, "--stem-channels", "128", *dev])
    kinds = [r[0] for r in _file_records(vc, out, n)[1]]
    sparse, dense = (kinds.count(vc.FTYPE_P_SPARSE),
                     kinds.count(vc.FTYPE_P_DENSE))
    assert kinds[0] == vc.FTYPE_I and sparse + dense == n - 1, kinds
    # a dense P-frame encodes twice (the sparse try, then dense) and
    # decodes once for its carry; the I-frame compresses and decompresses
    _launched(_msh_launches(HERO_N, M, False, 1 + sparse + 2 * dense,
                            1 + dense, 1 + sparse + 2 * dense))
    rec = tmp_path / "rec"
    _counted(_msh_launches(HERO_N, M, False, 0, n),
             lambda: vc.main(["decode", str(out), "-o", str(rec),
                              "--i-checkpoint", ckpt, *dev]))
    i_model, stem = vc._build_models(SimpleNamespace(
        i_model="mbt2018-mean", i_quality=3, i_checkpoint=ckpt,
        stem_family="parallel", stem_variant="without_spm",
        stem_channels=128, stem_checkpoint=None, wavefront_tile=None,
        device=card.type))
    for t, fr in enumerate(vc.decode_video(out, i_model, stem)):
        assert np.array_equal(read_png(rec / f"frame_{t:04d}.png"),
                              codec.to_png_array(fr)), t

    png = src / "frame_0000.png"
    x = codec.to_device(codec._load_image(png), card)
    x_padded, _ = pad_centered(x, 64)
    top, left = (x_padded.shape[2] - h) // 2, (x_padded.shape[3] - w) // 2
    for name, q, ck in (("mbt2018-mean", 3, ckpt),
                        ("bmshj2018-factorized", 1, None),
                        ("bmshj2018-hyperprior", 1, None)):
        binf, recf = tmp_path / f"{name}.bin", tmp_path / f"{name}.png"
        cli = ["--model", name, "--quality", str(q), *dev] + (
            ["--checkpoint", ck] if ck else [])
        n_q = int(name != "bmshj2018-factorized")
        _counted(_msh_launches(HERO_N, M, False, 1, 0, n_q),
                 lambda: codec.main(["encode", str(png), "-o", str(binf),
                                     *cli]))
        _counted(_msh_launches(HERO_N, M, False, 0, 1),
                 lambda: codec.main(["decode", str(binf), "-o", str(recf),
                                     *dev] + (["--checkpoint", ck] if ck
                                              else [])))
        model = codec._build_model(name, q, ck, card.type)
        enc = model.compress(x_padded)
        assert _bin_strings(codec, binf, len(enc["strings"])) == \
            enc["strings"]
        x_hat = model.decompress(enc["strings"], enc["shape"])["x_hat"]
        x_hat = x_hat[0, :, top:top + h, left:left + w]
        want = x_hat.float().permute(1, 2, 0).cpu().numpy()
        assert np.array_equal(read_png(recf), codec.to_png_array(want))


TRAIN_LR = 1e-4  # the trainers' default main learning rate
TRAIN_LOSS_RTOL = 1e-4  # card vs CPU, as the CPU tests hold the port to JAX
TRAIN_GRAD_TOL = 1e-4  # × max|g| of each leaf
TRAIN_PARAM_ATOL = 1e-6  # after one update, where the gradients pin Adam
# the kernel's gradients against the plain version's: each leaf's max|Δg|
# within this many times that of the plain runs with every (I)GDN output
# moved by 1e-5 relative (the f32 gdn_fused's rtol), with random signs or
# all up
TRAIN_KERNEL_SCALE = 2.0


def _hero_i_checkpoint():
    from spatiotemporalentropymodel_tpu_torch.eval.workload import HERO_DIR

    return str(HERO_DIR / "ckpt_i_0.012.pkl.gz")


def _adam_first(g):
    """Adam's first update over lr: g/(|g| + ε)."""
    return g / (np.abs(g) + 1e-8)


def _first_moments(state):
    """{name: g} of a first step's clipped gradients, from the Adams'
    exp_avg = (1 − β₁)·g, as host arrays."""
    out = {}
    for name, p in state.module.named_parameters():
        opt = next(o for o in state.optimizers[:2] if p in o.state)
        out[name] = (opt.state[p]["exp_avg"] / 0.1).double().cpu().numpy()
    return out


def _params_of(module):
    return {k: v.detach().double().cpu().numpy()
            for k, v in module.named_parameters()}


def _assert_grads_close(got, ref, tol):
    """Each leaf of ``got`` within tol·max|g| of ``ref``'s; returns the
    worst ratio."""
    worst = 0.0
    for name, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(got[name] - r).max()) / scale
        assert err <= tol, (name, err)
        worst = max(worst, err)
    return worst


def _assert_first_step_params(got, ref, g_got, g_ref):
    """Parameters after one update from equal states: within 1e-6 where the
    two gradients give Adam steps under half of it apart, else within
    2·lr."""
    for k, r in ref.items():
        err = np.abs(got[k] - r)
        loose = TRAIN_LR * np.abs(_adam_first(g_got[k])
                                  - _adam_first(g_ref[k])) > (
            TRAIN_PARAM_ATOL / 2)
        assert float(np.where(loose, 0, err).max()) <= TRAIN_PARAM_ATOL, k
        assert float(np.where(loose, err, 0).max()) <= 2 * TRAIN_LR, k


@pytest.mark.cuda
def test_cuda_image_train_step_matches_the_cpu(card, monkeypatch):
    """One make_image_train_step of MeanScaleHyperprior(64, 64) at 2 × 64 ×
    64 on the card and on the CPU from the same weights with the same fed
    noise, TF32 off: loss within 1e-4 relative, each gradient leaf (from
    the Adams' first moments) within 1e-4 of its max|g|, each parameter
    within 1e-6 where the two gradients pin Adam's first step, else within
    2·lr."""
    import copy

    from spatiotemporalentropymodel_tpu_torch.parallel import (
        init_train_state, make_image_train_step,
    )
    from spatiotemporalentropymodel_tpu_torch.training import (
        configure_optimizers,
    )

    _feed_noise(monkeypatch)
    cpu = MeanScaleHyperprior(64, 64, device="cpu", seed=5).module
    x = torch.from_numpy(np.random.default_rng(5).random(
        (2, 3, 64, 64), dtype=np.float32))
    out = {}
    for name, dev, module in (("cpu", torch.device("cpu"), cpu),
                              ("card", card, copy.deepcopy(cpu).to(card))):
        opt = configure_optimizers(module, TRAIN_LR)
        state = init_train_state(module, opt)
        state, metrics = make_image_train_step(module, opt)(
            state, x.to(dev), torch.Generator(device=dev))
        out[name] = ({k: float(v) for k, v in metrics.items()},
                     _first_moments(state), _params_of(module))
    (m_cpu, g_cpu, p_cpu), (m_card, g_card, p_card) = out["cpu"], out["card"]
    for k, v in m_cpu.items():
        assert np.isfinite(m_card[k])
        assert abs(m_card[k] - v) <= TRAIN_LOSS_RTOL * abs(v), k
    _assert_grads_close(g_card, g_cpu, TRAIN_GRAD_TOL)
    _assert_first_step_params(p_card, p_cpu, g_card, g_cpu)


def _watch_steps(monkeypatch, ns, maker, check):
    """Wrap ns.<maker> (a make_*_step) so that check(out) sees what each
    step it makes returns."""
    make = getattr(ns, maker)

    def make_watched(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(*a):
            out = step(*a)
            check(out)
            return out

        return run

    monkeypatch.setattr(ns, maker, make_watched)


def _finite(metrics):
    vals = {k: float(v) for k, v in metrics.items()}
    assert all(np.isfinite(v) for v in vals.values()), vals
    return vals


@pytest.mark.cuda
def test_cuda_train_image_at_its_defaults(card, monkeypatch, tmp_path):
    """train_image with TrainImageConfig's defaults (mbt2018-mean quality 4
    = MeanScaleHyperprior(128, 192), 16 × 256² synthetic batches) for 3
    steps: finite metrics, every main parameter moved, the aux optimizer
    moving the quantiles only, 6 gdn_fused launches (C = 128) per forward,
    and the checkpoint read back through load_checkpoint + load_jax_leaves
    to the trained parameters."""
    from spatiotemporalentropymodel_tpu_torch.convert import load_jax_leaves
    from spatiotemporalentropymodel_tpu_torch.training import (
        load_checkpoint,
    )
    from spatiotemporalentropymodel_tpu_torch.training import (
        train_image as ti,
    )
    from spatiotemporalentropymodel_tpu_torch.utils.config import (
        TrainImageConfig,
    )
    from spatiotemporalentropymodel_tpu_torch.zoo import create_model

    cfg = TrainImageConfig(workdir=str(tmp_path), device=card.type)
    model = create_model(cfg.model, cfg.quality, device=card)
    before = {k: v.detach().clone() for k, v in
              model.module.named_parameters()}
    aux_moved = []
    configure = ti.configure_optimizers

    def configure_watched(module, *args):
        pair = configure(module, *args)
        step = pair.aux.step

        def aux_step(*a, **kw):
            snap = {k: v.detach().clone()
                    for k, v in module.named_parameters()}
            out = step(*a, **kw)
            aux_moved.append(sorted(k for k, v in module.named_parameters()
                                    if not torch.equal(v, snap[k])))
            return out

        pair.aux.step = aux_step
        return pair

    monkeypatch.setattr(ti, "configure_optimizers", configure_watched)
    state, metrics = _counted(
        _msh_launches(HERO_N, M, False, 3, 3, graph=True),
        lambda: ti.train_image(cfg, max_steps=3, model=model))
    _finite(metrics)
    assert state.step == 3
    assert not [k for k, v in model.module.named_parameters()
                if "quantiles" not in k and torch.equal(v, before[k])]
    assert aux_moved == [["entropy_bottleneck.quantiles"]] * 3
    leaves = load_checkpoint(tmp_path / "ckpt" /
                             "image_latest.pkl")["train_state"]
    fresh = create_model(cfg.model, cfg.quality, device=card, seed=9)
    load_jax_leaves(fresh.module, leaves)
    for (k, v), w in zip(model.module.named_parameters(),
                         fresh.module.parameters()):
        assert torch.equal(v, w), k


@pytest.mark.cuda
def test_cuda_train_stem_in_both_step_modes(card, monkeypatch, tmp_path):
    """train_stem with TrainStemConfig's defaults (res, M 192, EB 256, 4 ×
    7 × 256²) behind the hero I checkpoint: one batch per_frame (a step per
    P-frame), two per_sequence, each with its validation and checkpoint,
    then a resumed third per_sequence step: finite metrics, the carry
    handed back detached, 3 gdn_fused launches (C = 128) per get_y call,
    the checkpoint at its step."""
    from spatiotemporalentropymodel_tpu_torch.training import load_trees
    from spatiotemporalentropymodel_tpu_torch.training import (
        train_stem as ts,
    )
    from spatiotemporalentropymodel_tpu_torch.utils.config import (
        TrainStemConfig,
    )

    def carry_detached(out):
        assert not (len(out) == 3 and out[2].requires_grad)

    ckpt = _hero_i_checkpoint()
    i_model = ts.build_i_model(
        TrainStemConfig(i_checkpoint=ckpt, device=card.type), card)
    for mode, steps, resume, n_get_y in (("per_frame", 1, False, 2),
                                         ("per_sequence", 2, False, 3),
                                         ("per_sequence", 3, True, 2)):
        cfg = TrainStemConfig(i_checkpoint=ckpt, step_mode=mode,
                              resume=resume, device=card.type,
                              workdir=str(tmp_path / mode))
        with monkeypatch.context() as m:
            _watch_steps(m, ts, "make_stem_frame_step" if mode == "per_frame"
                         else "make_stem_train_step", carry_detached)
            _, metrics = _counted(
                _msh_launches(HERO_N, M, False, n_get_y, 0),
                lambda: ts.train_stem(cfg, max_steps=steps,
                                      i_model=i_model))
        _finite(metrics)
        saved = load_trees(tmp_path / mode / "ckpt" / "stem_latest.pkl")
        assert int(saved["counters"]["iteration"]) == steps


AR_M = 320  # mbt2018 at quality 5-8: N 192, M 320 (zoo cfgs)


def _cheng_launches(n, bf16, n_ga, n_gs):
    """Cheng2020's launches: its six (I)GDNs feed residual sums, so each
    runs gdn_fused alone (its convs are its own)."""
    name = "gdn_fused_bf16" if bf16 else "gdn_fused"
    return _launches([((name, n), 3 * (n_ga + n_gs))])


def _probe_picture(device, frames=1, hw=None):
    """The serving probe's first ``frames`` frames as (frames, 3, H, W) f32
    on ``device``, cut to ``hw`` where given."""
    from spatiotemporalentropymodel_tpu_torch.eval import workload

    x = np.stack(workload.hero_1080p_frames()[:frames])
    if hw is not None:
        x = x[:, :hw[0], :hw[1]]
    x = torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)
    return x.contiguous().to(device).float() / 255.0


def _ar_round_trip(model, x, want):
    """compress, then decompress, of x through the model API with the
    launches held to ``want``: encoder ŷ == decoder ŷ bit for bit, a second
    compress repeats the strings, x̂ finite of x's shape, bpp finite."""
    kernels.reset_launch_counts()
    enc, y_enc = model.encode_with_y_hat(x)
    dec = model.decompress(enc["strings"], enc["shape"])
    _launched(want)
    assert torch.equal(dec["y_hat"], y_enc)
    assert model.compress(x)["strings"] == enc["strings"]
    assert dec["x_hat"].shape == x.shape
    assert bool(torch.isfinite(dec["x_hat"]).all())
    bpp = _stream_bytes(enc) * 8.0 / (x.shape[0] * x.shape[2] * x.shape[3])
    assert np.isfinite(bpp)
    return enc, y_enc


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("where,name,quality", [
    ("cpu", "mbt2018", 5),
    pytest.param("1080p", "mbt2018", 5, marks=pytest.mark.cuda),
    pytest.param("1080p", "cheng2020-attn", 6, marks=pytest.mark.cuda)])
def test_image_ar_round_trip_exact(request, monkeypatch, where, name,
                                   quality, dtype):
    """The autoregressive image models from seeds on the serving probe's
    first 1088 × 1920 frame: mbt2018 at quality 5 (N 192, M 320) and
    Cheng2020-attn at quality 6 (N 192), through the wavefront codec's
    compress and decompress (321 rounds), held as ``_ar_round_trip`` holds
    them, with the launches exact by width: in bf16 mbt2018's g_a runs
    gdn_conv_fused twice at 192 → 192 and once at 192 → 320 and its g_s
    gdn_fused_bf16 then the packed pair; in f32 its (I)GDNs run gdn_fused
    and its convs the f32 k5 s2 kernels; Cheng2020 runs gdn_fused 3 + 3
    times. On the CPU mbt2018 at 64 × 64."""
    from spatiotemporalentropymodel_tpu_torch import zoo

    device = _on(request, monkeypatch, where)
    bf16 = dtype == torch.bfloat16
    x = _probe_picture(device, hw=(64, 64) if where == "cpu" else None)
    model = zoo.create_model(name, quality, device=device, seed=1)
    model.update()
    if bf16:
        model.set_compute_dtype(dtype)
    want = (_cheng_launches(N, bf16, 1, 1) if name.startswith("cheng")
            else _msh_launches(N, AR_M, bf16, 1, 1))
    _ar_round_trip(model, x, want)


@pytest.mark.cuda
def test_cuda_image_ar_batch_invariance_at_1080p(card):
    """mbt2018 at quality 4 (N = M = 192) in bf16 on the probe's first two
    1088 × 1920 frames batched, held as ``_ar_round_trip`` holds it (g_a
    once per picture, g_s once on the batch); each frame coded alone gives
    the batched strings byte for byte and the batched ŷ bit for bit."""
    from spatiotemporalentropymodel_tpu_torch import zoo

    x2 = _probe_picture(card, frames=2)
    model = zoo.create_model("mbt2018", 4, device=card, seed=2)
    model.update()
    model.set_compute_dtype(torch.bfloat16)
    enc, y_hat = _ar_round_trip(model, x2, _msh_launches(N, M, True, 2, 1))
    for i in range(2):
        solo, y_solo = model.encode_with_y_hat(x2[i:i + 1])
        assert solo["strings"][0][0] == enc["strings"][0][i], i
        assert solo["strings"][1][0] == enc["strings"][1][i], i
        assert torch.equal(y_solo[0], y_hat[i]), i


@pytest.mark.cuda
def test_cuda_serial_image_ar_matches_wavefront(card):
    """The serial mbt2018 codec (N 8, M 12) on a 4 × 8 latent: in both modes
    the encoder's ŷ is the decoder's, and the serial ŷ is the wavefront's
    within 1e-4."""
    from spatiotemporalentropymodel_tpu_torch.models import (
        JointAutoregressiveHierarchicalPriors,
    )

    gen = torch.Generator(device=card).manual_seed(22)
    x = torch.rand((1, 3, 64, 128), generator=gen, device=card)
    y_hat = {}
    for mode in ("serial", "wavefront"):
        model = JointAutoregressiveHierarchicalPriors(8, 12, ar_mode=mode,
                                                      device=card, seed=4)
        model.update()
        enc, y_enc = model.encode_with_y_hat(x)
        y_hat[mode] = model.decompress(enc["strings"], enc["shape"])["y_hat"]
        assert torch.equal(y_hat[mode], y_enc), mode
    err = float((y_hat["serial"] - y_hat["wavefront"]).abs().max())
    assert err <= SERIAL_ATOL


@pytest.mark.cuda
def test_cuda_image_ar_files_and_checkpoint(card, tmp_path):
    """f32, from seeds: the .bin CLI through main(argv) with
    cheng2020-anchor at quality 3 (N 128) on a 256² PNG (strings
    compress's, the PNG decompress's); a .stemv of the probe's frames with
    mbt2018 at quality 4 as the I-model and the hero without_spm STEM
    (family 0, GOP 4: I then sparse or dense P records, no flags, the
    streams and decoded frames the in-memory chain's); and
    load_torch_checkpoint of a CompressAI-keyed file written from mbt2018
    at quality 5 (the same parameters and strings). Launches exact."""
    from spatiotemporalentropymodel_tpu_torch import zoo
    from spatiotemporalentropymodel_tpu_torch.data.png import (
        read_png, write_png,
    )
    from spatiotemporalentropymodel_tpu_torch.eval import codec
    from spatiotemporalentropymodel_tpu_torch.eval import video_codec as vc
    from spatiotemporalentropymodel_tpu_torch.eval import workload
    from spatiotemporalentropymodel_tpu_torch.zoo.convert import KEY_MAPS

    frames_u8 = workload.hero_1080p_frames()
    dev = ["--device", card.type]
    name, q = "cheng2020-anchor", 3
    png, binf, recf = (tmp_path / "ar.png", tmp_path / "ar.bin",
                       tmp_path / "ar_rec.png")
    write_png(png, frames_u8[0][:256, :256])
    n_cli = zoo.cfgs[name][q][0]
    _counted(_cheng_launches(n_cli, False, 1, 0),
             lambda: codec.main(["encode", str(png), "-o", str(binf),
                                 "--model", name, "--quality", str(q),
                                 *dev]))
    _counted(_cheng_launches(n_cli, False, 0, 1),
             lambda: codec.main(["decode", str(binf), "-o", str(recf),
                                 *dev]))
    model = codec._build_model(name, q, None, card.type)
    x = codec.to_device(codec._load_image(png), card)
    enc = model.compress(x)
    assert _bin_strings(codec, binf, len(enc["strings"])) == enc["strings"]
    x_hat = model.decompress(enc["strings"], enc["shape"])["x_hat"]
    want = x_hat[0].float().permute(1, 2, 0).cpu().numpy()
    assert np.array_equal(read_png(recf), codec.to_png_array(want))

    i_model = zoo.create_model("mbt2018", 4, device=card, seed=5)
    i_model.update()
    stem = workload.load_hero(device=card,
                              variants=("without_spm",))["without_spm"]
    frames = [f.astype(np.float32) / 255.0 for f in frames_u8]
    n, path = len(frames), tmp_path / "ar.stemv"
    kernels.reset_launch_counts()
    vc.encode_video(frames, i_model, stem, path, gop=n,
                    meta={"i_model": "mbt2018", "i_quality": 4})
    hdr, records = _file_records(vc, path, n)
    kinds = [r[0] for r in records]
    sparse, dense = (kinds.count(vc.FTYPE_P_SPARSE),
                     kinds.count(vc.FTYPE_P_DENSE))
    assert kinds[0] == vc.FTYPE_I and sparse + dense == n - 1, kinds
    assert not hdr["flags"]
    # I: compress (g_a) and decompress (g_s); a sparse P-frame g_a and one
    # quantizer call, a dense one the sparse try and the dense encode (g_a
    # and the quantizer twice) and a decode for its carry (g_s)
    _launched(_msh_launches(N, M, False, 1 + sparse + 2 * dense, 1 + dense,
                            sparse + 2 * dense))
    decoded = _counted(_msh_launches(N, M, False, 0, n),
                       lambda: vc.decode_video(path, i_model, stem))
    pipe = StemVideoPipeline(i_model, stem, transport_mode="sparse")
    yc = None
    for t, fr in enumerate(frames):
        xt = torch.from_numpy(fr).permute(2, 0, 1)[None].to(card)
        if t == 0:
            enc = i_model.compress(xt)
            dec = i_model.decompress(enc["strings"], enc["shape"])
            x_hat, yc = dec["x_hat"], dec["y_hat"]
        else:
            enc, _ = pipe.encode_frame(xt, yc)
            x_hat, yc = pipe.decode_frame(enc, y_cond=yc)
        assert enc["strings"] == records[t][3], t
        assert np.array_equal(decoded[t], x_hat[0].float().permute(
            1, 2, 0).cpu().numpy()), t

    src = zoo.create_model("mbt2018", 5, device=card, seed=6)
    src.update()
    key_map = KEY_MAPS["mbt2018"]
    ckpt = tmp_path / "mbt2018.pth.tar"
    torch.save({"state_dict": {key_map(k): v.detach().cpu()
                               for k, v in src.module.named_parameters()}},
               ckpt)
    got = zoo.load_torch_checkpoint("mbt2018", str(ckpt), 5, device=card)
    for (k, a), b in zip(src.module.named_parameters(),
                         got.module.parameters()):
        assert torch.equal(a, b), k
    x = torch.from_numpy(frames[0]).permute(2, 0, 1)[None].to(card)
    assert got.compress(x)["strings"] == src.compress(x)["strings"]


ROI_EBC, ROI_M, ROI_N = 256, 192, 128  # TrainStemRoiConfig; the fixed trunk
ROI_NAMES = ("stem_baseline", "stem_baselinev2", "stem_roi",
             "stem_roi_wo_gsc", "stem_roi_i")
ROI_LEVELS = (0, 50, 100, -1)
ROI_RC = (0.45,)
ROI_TRAIN_GRAD_TOL = 2e-3  # × max|g|, f32 against f64, plain GDN


def _roi_model(name, bf16, device, seed=1):
    """A seeded model of the family, tamed (eval/workload.py::tame_roi: at
    their initialisation the quality-map transforms blow x̂ past f32)."""
    from spatiotemporalentropymodel_tpu_torch import zoo
    from spatiotemporalentropymodel_tpu_torch.eval.workload import tame_roi

    model = zoo.roi_models[name](entropy_bottleneck_channels=ROI_EBC,
                                 in_channels=ROI_M, device=device, seed=seed)
    tame_roi(model.module)
    model.update()
    if bf16:
        model.set_compute_dtype(torch.bfloat16)
    return model


def _roi_launches(name, bf16, frames=1):
    """The launches of ``frames`` compress + decompress round trips, B = 1.
    The pixel encoders (the baselines' PEncoder and ConditionEncoder, the
    ROI P-models' ConditionEncoder) run 3 GDNs each (bf16: 3
    gdn_conv_fused, 128 → 128 twice and 128 → M): a baseline runs 3 (x_cur
    and x_cond, then x_cond to decode), a ROI P-model 2; the ROI g_a and
    g_s run 3 GDNs each, alone; the baselines' PDecoder 3 IGDNs (bf16: its
    first alone, then the packed pair); quantize_and_index once per
    compress."""
    n = ROI_N
    baseline = name.startswith("stem_baseline")
    n_enc = 3 if baseline else (0 if name == "stem_roi_i" else 2)
    n_alone = 0 if baseline else 6
    q = "quantize_and_index_bf16" if bf16 else "quantize_and_index"
    widths = [((q,), 1)]
    if bf16:
        widths += [(("gdn_conv_fused", n, n), 2 * n_enc),
                   (("gdn_conv_fused", n, ROI_M), n_enc),
                   (("gdn_fused_bf16", n), n_alone + int(baseline))]
        if baseline:
            widths += [(("igdn_deconv_wide_packed", n, n), 1),
                       (("igdn_deconv_tail_packed", n, 3), 1)]
    else:
        widths.append((("gdn_fused", n), 3 * n_enc + n_alone
                       + 3 * int(baseline)))
    return _launches([(k, v * frames) for k, v in widths])


def _roi_inputs(device, rows=None, hw=None):
    """(x_cur, x_cond, qmap) on ``device``: the probe's frames 1 and 0 and a
    synthesize_qmap map (random.Random(3)) cut to the frame, (1, 1, H, W);
    ``rows`` cuts the frames' rows, ``hw`` the top-left corner."""
    import random

    from spatiotemporalentropymodel_tpu_torch.data import synthesize_qmap
    from spatiotemporalentropymodel_tpu_torch.eval import workload

    frames = workload.hero_1080p_frames()[:2]
    if rows is not None:
        frames = [f[rows] for f in frames]
    if hw is not None:
        frames = [f[:hw[0], :hw[1]] for f in frames]
    xs = [torch.from_numpy(np.ascontiguousarray(f)).permute(2, 0, 1)[None]
          .contiguous().to(device).float() / 255.0 for f in frames]
    h, w = xs[0].shape[2:]
    q = synthesize_qmap(max(h, w), rng=random.Random(3))[:h, :w]
    return xs[1], xs[0], torch.from_numpy(
        np.ascontiguousarray(q[None, :, :, 0]))[None].to(device)


def _roi_args(name, x, xc, q):
    """(compress's arguments, decompress's conditioning) of a model."""
    if name == "stem_roi_i":
        return (x, q), ()
    return ((x, xc, q) if name.startswith("stem_roi") else (x, xc)), (xc,)


def _roi_round_trip(model, args, cond, want):
    """compress, then decompress with no quality map, with the launches held
    to ``want``: encoder ŷ == decoder ŷ bit for bit, x̂ finite in [0, 1], a
    second compress repeats the strings. Returns x̂."""
    kernels.reset_launch_counts()
    enc, y_enc = model.encode_with_y_hat(*args)
    dec = model.decompress(enc["strings"], enc["shape"], *cond)
    _launched(want)
    assert torch.equal(dec["y_hat"], y_enc)
    x_hat = dec["x_hat"]
    assert bool(torch.isfinite(x_hat).all())
    assert float(x_hat.min()) >= 0 and float(x_hat.max()) <= 1
    assert model.compress(*args)["strings"] == enc["strings"]
    return x_hat


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("where", [
    "cpu", pytest.param("1080p", marks=pytest.mark.cuda)])
def test_roi_family_round_trips_exact(request, monkeypatch, where, dtype):
    """The five ROI-family models (EB 256, M 192) from seeds, tamed, on the
    probe's 1088 × 1920 pair, each held as ``_roi_round_trip`` holds it
    with its launches exact by width; in f32 on the card also stem_roi on
    the pair cut to rows 4-1083, unpadded (its hyper-encoder's map is the
    1080 → 68 resize), x̂ of the full 1088 rows. On the CPU at 64 × 64."""
    device = _on(request, monkeypatch, where)
    bf16 = dtype == torch.bfloat16
    x, xc, q = _roi_inputs(device, hw=(64, 64) if where == "cpu" else None)
    for name in ROI_NAMES:
        model = _roi_model(name, bf16, device)
        _roi_round_trip(model, *_roi_args(name, x, xc, q),
                        _roi_launches(name, bf16))
        del model
    if where == "cpu" or bf16:
        return
    x, xc, q = _roi_inputs(device, rows=slice(4, 1084))
    model = _roi_model("stem_roi", False, device)
    x_hat = _roi_round_trip(model, *_roi_args("stem_roi", x, xc, q),
                            _roi_launches("stem_roi", False))
    assert x_hat.shape == (1, 3, H, W)


@pytest.mark.cuda
def test_cuda_roi_eval_levels_and_rc(card):
    """eval_levels on a 3-frame GOP of 1088 × 1920 (stem_roi_i, then
    stem_roi conditioned on the padded reconstruction) at levels 0, 50,
    100 and −1, then eval_rc at 0.45, in f32: every compress's streams
    decode to its encoder's ŷ exactly, bpp and PSNR finite, the launches
    exact."""
    from spatiotemporalentropymodel_tpu_torch.data import ArraySequence
    from spatiotemporalentropymodel_tpu_torch.eval import eval_stem_roi
    from spatiotemporalentropymodel_tpu_torch.eval import workload

    model_i = _roi_model("stem_roi_i", False, card, seed=2)
    model_p = _roi_model("stem_roi", False, card, seed=3)
    checked = []
    for model in (model_i, model_p):
        def compress(*a, _m=model):
            enc, _m._y_enc = type(_m).encode_with_y_hat(_m, *a)
            return enc

        def decompress(*a, _m=model):
            dec = type(_m).decompress(_m, *a)
            assert torch.equal(dec["y_hat"], _m._y_enc)
            checked.append(1)
            return dec

        model.compress, model.decompress = compress, decompress
    seq = ArraySequence(workload.hero_1080p_frames()[:3], gop_size=3)
    # per level an I-frame (stem_roi_i: a forward, 6 GDNs, and a round
    # trip, 6) and two P-frames (stem_roi: a forward, 9, and a round trip,
    # 12), each compress one quantize_and_index
    n_lv = len(ROI_LEVELS) + len(ROI_RC)
    g, n_q = n_lv * (12 + 2 * 21), 3 * n_lv
    levels, rc = _counted(
        _launches([(("gdn_fused", ROI_N), g), (("quantize_and_index",), n_q)]),
        lambda: (eval_stem_roi.eval_levels(model_i, model_p, [seq],
                                           list(ROI_LEVELS)),
                 eval_stem_roi.eval_rc(model_i, model_p, [seq],
                                       list(ROI_RC))))
    assert len(checked) == n_q
    for level, r in {**levels, **rc}.items():
        assert np.isfinite(r["psnr"]) and np.isfinite(r["bpp"]), level
        assert r["bpp"] > 0, level


@pytest.mark.cuda
def test_cuda_roi_joint_step_matches_the_cpu(card):
    """One joint step of each recipe (roi: stem_roi_i + stem_roi at EB 16,
    M 12, tamed; baseline: MeanScaleHyperprior(16, 16) + stem_baselinev2)
    on a 2-frame 2 × 64² sequence, from the same weights with the same fed
    noise: on the CPU in f64 and f32, and on the card with the gdn_fused
    kernel, with its plain version, and with the plain version's outputs
    moved by 1e-5 relative (random signs; all up). The card's loss within
    1e-4 relative of the CPU's; the CPU's and the card's plain f32
    gradients within 2e-3 of each leaf's max|g| of the f64 run's; the
    kernel's gradients off the card's plain ones by at most twice the
    moved runs' largest deviation, leaf by leaf: the SFT and quality-map
    gradients are sums that cancel to a small part of their terms, so a
    GDN output moved by its f32 tolerance moves them by up to a tenth of
    max|g|."""
    import copy
    import random

    from spatiotemporalentropymodel_tpu_torch.data import synthesize_qmap
    from spatiotemporalentropymodel_tpu_torch.eval.workload import tame_roi
    from spatiotemporalentropymodel_tpu_torch.models import (
        StemBaselineModule, StemROIModule,
    )
    from spatiotemporalentropymodel_tpu_torch.parallel import (
        init_train_state,
    )
    from spatiotemporalentropymodel_tpu_torch.training import (
        configure_optimizers,
    )
    from spatiotemporalentropymodel_tpu_torch.training import (
        train_stem_roi as tr,
    )

    rng = np.random.default_rng(7)
    frames = torch.from_numpy(rng.random((2, 2, 3, 64, 64),
                                         dtype=np.float32))
    q = torch.from_numpy(np.stack([synthesize_qmap(
        64, rng=random.Random(i))[None, :, :, 0] for i in range(2)]))
    cpu = torch.device("cpu")
    # (tag, device, dtype, the gdn_fused stand-in's mode or None)
    runs = (("cpu64", cpu, torch.float64, None),
            ("cpu", cpu, torch.float32, None),
            ("kernel", card, torch.float32, None),
            ("plain", card, torch.float32, "plain"),
            ("random", card, torch.float32, "random"),
            ("scaled", card, torch.float32, "scaled"))
    for mode in ("roi", "baseline"):
        g = torch.Generator().manual_seed(5)
        if mode == "roi":
            base = (StemROIModule(16, 12, conditional=False, generator=g),
                    StemROIModule(16, 12, generator=g))
        else:
            base = (MeanScaleHyperprior(16, 16, device="cpu", seed=5).module,
                    StemBaselineModule(16, 12, True, generator=g))
        for module in base:
            tame_roi(module)
        out = {}
        for tag, dev, dtype, gdn in runs:
            with pytest.MonkeyPatch.context() as m:
                _feed_noise(m)
                if gdn is not None:
                    m.setattr(kernels, "gdn_fused", _moved_gdn(gdn, dev))
                mods = [copy.deepcopy(b).to(dev, dtype) for b in base]
                opts = [configure_optimizers(b, TRAIN_LR) for b in mods]
                states = [init_train_state(b, o) for b, o in zip(mods, opts)]
                step = tr.make_joint_sequence_step(*mods, *opts, mode=mode,
                                                   loss_threshold=1e9)
                *states, metrics = step(*states, frames.to(dev, dtype),
                                        q.to(dev, dtype),
                                        torch.Generator(device=dev))
            out[tag] = (float(metrics["loss"]),
                        {f"{i}.{n}": v for i, s in enumerate(states)
                         for n, v in _first_moments(s).items()})
        loss = {k: v[0] for k, v in out.items()}
        assert abs(loss["kernel"] - loss["cpu"]) <= \
            TRAIN_LOSS_RTOL * abs(loss["cpu"]), mode
        grads = {k: v[1] for k, v in out.items()}
        for k in ("cpu", "plain"):
            _assert_grads_close(grads[k], grads["cpu64"], ROI_TRAIN_GRAD_TOL)
        _assert_kernel_within_moved(grads["kernel"], grads["plain"],
                                    [grads["random"], grads["scaled"]])


def _assert_kernel_within_moved(got, ref, moved):
    """Each leaf's max|kernel − plain| within twice the largest max|moved −
    plain| of the ``moved`` runs."""
    for name, r in ref.items():
        d_kernel = float(np.abs(got[name] - r).max())
        d_moved = max(float(np.abs(m[name] - r).max()) for m in moved)
        assert d_kernel <= TRAIN_KERNEL_SCALE * d_moved, (name, d_kernel,
                                                           d_moved)


def _unmoved(modules, before):
    """The parameters of ``modules`` equal to their ``before`` copies."""
    return [f"{i}.{k}" for i, m in enumerate(modules)
            for k, v in m.named_parameters() if torch.equal(v, before[i][k])]


def _params(modules):
    return [{k: v.detach().clone() for k, v in m.named_parameters()}
            for m in modules]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["roi", "baseline"])
def test_cuda_train_stem_roi(card, tmp_path, mode):
    """train_stem_roi at TrainStemRoiConfig's defaults (EB 256, M 192, 4 ×
    256², the JAX package's synthetic 3-frame batches) but for the loss
    threshold, 3 steps, the weights tamed: finite metrics, every frame
    valid, every parameter of both modules moved, the checkpoint at step
    3, the gdn_fused launches of the forwards (6 for the I-frame, 9 per
    P-frame); then one step of each on a 7-frame batch (a Vimeo
    septuplet's length), every frame valid, every parameter moved again
    and the launches exact. The seeded weights' losses (400-470 on the
    card) are far past the default threshold 3.0, which would mask every
    frame's gradient: the threshold is 1e9."""
    from spatiotemporalentropymodel_tpu_torch.eval.workload import tame_roi
    from spatiotemporalentropymodel_tpu_torch.parallel import (
        init_train_state,
    )
    from spatiotemporalentropymodel_tpu_torch.training import (
        configure_optimizers, load_trees,
    )
    from spatiotemporalentropymodel_tpu_torch.training import (
        train_stem_roi as tr,
    )
    from spatiotemporalentropymodel_tpu_torch.utils.config import (
        TrainStemRoiConfig,
    )

    steps, frames = 3, 3
    cfg = TrainStemRoiConfig(mode=mode, workdir=str(tmp_path),
                             loss_skip_threshold=1e9, device=card.type)
    modules = tr.build_modules(cfg, card)
    for module in modules:
        tame_roi(module)
    before = _params(modules)
    n = steps * (6 + 9 * (frames - 1))
    (st_i, st_p), metrics = _counted(
        _launches([(("gdn_fused", ROI_N), n)]),
        lambda: tr.train_stem_roi(cfg, steps, modules))
    vals = _finite(metrics)
    assert vals["valid_frames"] == frames
    assert not _unmoved(modules, before)
    saved = load_trees(tmp_path / "ckpt" / "stem_roi_latest.pkl")
    assert int(saved["counters"]["iteration"]) == steps
    assert st_i.step == st_p.step == steps

    x7 = torch.rand((cfg.batch_size, 7, 3, cfg.cropsize, cfg.cropsize),
                    device=card)
    q7 = torch.rand((cfg.batch_size, 1, cfg.cropsize, cfg.cropsize),
                    device=card)
    opts = [configure_optimizers(m, cfg.learning_rate) for m in modules]
    states = [init_train_state(m, o) for m, o in zip(modules, opts)]
    step7 = tr.make_joint_sequence_step(
        *modules, *opts, mode=mode, loss_threshold=cfg.loss_skip_threshold,
        lmbda=cfg.lmbda)
    before = _params(modules)
    out7 = _counted(_launches([(("gdn_fused", ROI_N), 6 + 9 * 6)]),
                    lambda: step7(*states, x7, q7,
                                  torch.Generator(device=card)))
    assert _finite(out7[2])["valid_frames"] == 7
    assert not _unmoved(modules, before)


@pytest.mark.cuda
def test_cuda_roi_video_checkpoints(card):
    """load_video_torch_checkpoint on CompressAI-keyed state dicts written
    from a seeded stem_roi (EB 256, M 192, tamed) and a seeded STEM res:
    the same parameters, and compress gives the source model's strings
    (stem_roi on the 1088 × 1920 pair, res on latents of its size)."""
    from spatiotemporalentropymodel_tpu_torch import zoo
    from spatiotemporalentropymodel_tpu_torch.zoo.convert import KEY_MAPS

    x, xc, q = _roi_inputs(card)
    gen = torch.Generator(device=card).manual_seed(4)
    lat = [torch.randn((1, ROI_M, H // 16, W // 16), generator=gen,
                       device=card) for _ in range(2)]
    for name, key_map, args in (("stem_roi", "stem-roi", (x, xc, q)),
                                ("stpm_res", "stem", lat)):
        if name == "stem_roi":
            src = _roi_model(name, False, card, seed=6)
        else:
            src = zoo.stem_models[name](entropy_bottleneck_channels=ROI_EBC,
                                        in_channels=ROI_M, device=card,
                                        seed=6)
            src.update()
        km = KEY_MAPS[key_map]
        state = {"state_dict": {km(k): v.detach().cpu()
                                for k, v in src.module.named_parameters()}}
        got = zoo.load_video_torch_checkpoint(
            name, state, device=card, entropy_bottleneck_channels=ROI_EBC,
            in_channels=ROI_M)
        for (k, a), b in zip(src.module.named_parameters(),
                             got.module.parameters()):
            assert torch.equal(a, b), (name, k)
        assert got.compress(*args)["strings"] == \
            src.compress(*args)["strings"], name


CHARM_GROUPS = 4
CHARM_MEAN_ERR = 1.0  # mean|ŷ − y_cur|, the tripwire of bench.py:1058-1060
CHARM_EVAL_HW = 256  # the GOP eval's and the trainer's frames


def _charm_decodes(model, y_cur, y_cond):
    """The three decodes of charm's model API on one latent pair, the
    fetch-free one (with the counts), the per-group sparse one (counts
    None) and the dense one (of a dense compress): each ŷ bit for bit the
    others' and the encoder's own recursion's (the carry of its encode
    expressions), and mean|ŷ − y_cur| ≤ 1.0. Returns ŷ."""
    enc = model.compress(y_cur, y_cond)
    assert enc["transport"] == "sparse"
    dense = model.compress(y_cur, y_cond, transport_mode="dense")
    outs = [
        model.decompress(enc["strings"], enc["shape"], y_cond,
                         counts=enc["counts"])["y_hat"],
        model.decompress(enc["strings"], enc["shape"], y_cond)["y_hat"],
        model.decompress(dense["strings"], dense["shape"], y_cond,
                         transport_mode="dense")["y_hat"],
        model.fused_encode_sparse_carry_expr(y_cur, y_cond)[1],
        model.fused_encode_carry_expr(y_cur, y_cond)[1],
    ]
    for i, out in enumerate(outs[1:]):
        assert torch.equal(out, outs[0]), i
    assert float((outs[0] - y_cur).abs().mean()) <= CHARM_MEAN_ERR
    return outs[0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("where", [
    "cpu", pytest.param("1080p", marks=pytest.mark.cuda)])
def test_charm_model_api_decodes_agree(request, monkeypatch, where, dtype):
    """bench.py's run_charm workload (eval/workload.py::charm_workload: G 4,
    EB 256, M 192, seeded weights × 0.02, y_cond = 0.3·ε, y_cur = y_cond +
    0.2·ε at 1 × 192 × 68 × 120) through the model API: the decodes agree
    as ``_charm_decodes`` holds them, and no kernel launches (charm has
    none). On the CPU at a 1 × 192 × 8 × 16 latent."""
    from spatiotemporalentropymodel_tpu_torch.eval.workload import (
        CHARM_LATENT, charm_workload,
    )

    device = _on(request, monkeypatch, where)
    shape = (1, 192, 8, 16) if where == "cpu" else CHARM_LATENT
    model, y_cur, y_cond = charm_workload(device, groups=CHARM_GROUPS,
                                          shape=shape)
    if dtype == torch.bfloat16:
        model.set_compute_dtype(dtype)
    _charm_decodes(model, y_cur, y_cond)
    _launched(_launches([]))


@pytest.mark.cuda
def test_cuda_charm_other_coders(card):
    """The other two coders on the f32 workload: a dense round trip with
    rans_interleaved (8 lanes, from the repo's rans.cpp as "rans" is) at
    the full latent, its ŷ the "rans" dense decode's; then the sparse round
    trip with the NumPy coder, the fetch-free decode through its fallback,
    on a 16 × 16 crop (a 256² frame), its ŷ the "rans" model's on the same
    crop."""
    from spatiotemporalentropymodel_tpu_torch.eval.workload import (
        charm_workload,
    )

    native, y_cur, y_cond = charm_workload(card, groups=CHARM_GROUPS)
    ref = native.compress(y_cur, y_cond, transport_mode="dense")
    ref = native.decompress(ref["strings"], ref["shape"], y_cond,
                            transport_mode="dense")["y_hat"]
    inter, _, _ = charm_workload(card, groups=CHARM_GROUPS,
                                 entropy_coder="rans_interleaved")
    enc = inter.compress(y_cur, y_cond, transport_mode="dense")
    dec = inter.decompress(enc["strings"], enc["shape"], y_cond,
                           transport_mode="dense")
    assert torch.equal(dec["y_hat"], ref)

    side = CHARM_EVAL_HW // 16
    crop = [t[:, :, :side, :side].contiguous() for t in (y_cur, y_cond)]
    spec, _, _ = charm_workload(card, groups=CHARM_GROUPS,
                                entropy_coder="numpy")
    want = native.compress(*crop)
    want = native.decompress(want["strings"], want["shape"], crop[1],
                             counts=want.get("counts"))["y_hat"]
    enc = spec.compress(*crop)
    dec = spec.decompress(enc["strings"], enc["shape"], crop[1],
                          transport_mode=enc["transport"],
                          counts=enc.get("counts"))
    assert enc["transport"] == "sparse"
    assert torch.equal(dec["y_hat"], want)


def _record(monkeypatch, obj, name, store, pick=lambda out: out):
    """Wrap the method obj.<name> so that pick(its result) is appended to
    ``store`` at each call."""
    fn = getattr(obj, name)

    def rec(*a, **kw):
        out = fn(*a, **kw)
        store.append(pick(out))
        return out

    monkeypatch.setattr(obj, name, rec)


def _charm_i_model(device):
    """MeanScaleHyperprior(192, 192) from a seed, f32, its g_a's last conv
    × 0.05 so that its latent sits in the charm workload's sparse regime
    (seeded g_a weights give a spread of a few units)."""
    i_model = MeanScaleHyperprior(N, M, device=device, seed=9)
    with torch.no_grad():
        last = i_model.module.g_a.layers[-1]
        last.weight.mul_(0.05)
        last.bias.mul_(0.05)
    i_model.update()
    return i_model


@pytest.mark.cuda
def test_cuda_charm_stemv_file(card, monkeypatch, tmp_path):
    """A .stemv family-2 file of 3 probe frames (1088 × 1920, GOP 3) with
    ``_charm_i_model`` in bf16 and the bf16 charm workload's model: the
    header (family 2, cfg0 4, cfg1 3), every P record sparse (type 4), each
    P-frame's ŷ the same in the encoder's recursion, its carry and the
    file's decode, x̂ finite, and exact launches by width: g_a 3 times and
    g_s once to encode (the I-frame's compress and decompress, the
    P-frames' analysis), one quantize_and_index_bf16, g_s 3 times to
    decode."""
    from spatiotemporalentropymodel_tpu_torch.eval import video_codec as vc
    from spatiotemporalentropymodel_tpu_torch.eval import workload

    model, _, _ = workload.charm_workload(card, groups=CHARM_GROUPS)
    model.set_compute_dtype(torch.bfloat16)
    i_model = _charm_i_model(card)
    i_model.set_compute_dtype(torch.bfloat16)
    frames = [f.astype(np.float32) / 255.0
              for f in workload.hero_1080p_frames()[:3]]
    n = len(frames)
    out = tmp_path / "charm.stemv"
    encoder, carried, decoded_y = [], [], []
    with monkeypatch.context() as m:
        for name in ("fused_encode_sparse_carry_expr",
                     "fused_encode_carry_expr"):
            _record(m, model, name, encoder, lambda o: o[1])
        _record(m, model, "decompress", carried, lambda o: o["y_hat"])
        _counted(_msh_launches(N, M, True, n, 1, 1),
                 lambda: vc.encode_video(frames, i_model, model, out, gop=n))
    with monkeypatch.context() as m:
        _record(m, model, "decompress", decoded_y, lambda o: o["y_hat"])
        decoded = _counted(_msh_launches(N, M, True, 0, n),
                           lambda: vc.decode_video(out, i_model, model))
    with open(out, "rb") as f:
        hdr = vc.read_header(f)
        records = [vc._read_frame(f, hdr["cfg0"]) for _ in range(n)]
    assert (hdr["stem_family"], hdr["cfg0"], hdr["cfg1"]) == (
        vc.FAMILY_CHARM, CHARM_GROUPS, 3)
    assert [r[0] for r in records] == (
        [vc.FTYPE_I] + [vc.FTYPE_P_CHARM] * (n - 1))
    assert len(encoder) == len(carried) == len(decoded_y) == n - 1
    for e, c, d in zip(encoder, carried, decoded_y):
        assert torch.equal(e, c) and torch.equal(c, d)
    assert all(np.isfinite(fr).all() for fr in decoded)


@pytest.mark.cuda
def test_cuda_charm_eval_sequence(card, monkeypatch):
    """charm through eval_stem.eval_sequence (the model API, f32) behind
    ``_charm_i_model`` on the hero eval set's first 3 frames (256², GOP 3):
    every value finite, the bpp the mean of the frames' actual bpp with
    the P-frames' counts, and exact launches (3 gdn_fused per g_a and g_s
    pass: g_a and g_s in the I-frame's forward, g_a in its compress and
    g_s in its decompress, g_a (get_y) and g_s (get_x) per P-frame; one
    quantize_and_index)."""
    from spatiotemporalentropymodel_tpu_torch.data import ArraySequence
    from spatiotemporalentropymodel_tpu_torch.eval import eval_stem
    from spatiotemporalentropymodel_tpu_torch.eval.metrics import actual_bpp
    from spatiotemporalentropymodel_tpu_torch.eval.workload import (
        charm_workload, hero_gop_set,
    )

    seq = ArraySequence(hero_gop_set(1, 3)[0].frames, 3, "seq0")
    i_model = _charm_i_model(card)
    stem, _, _ = charm_workload(card, groups=CHARM_GROUPS)
    encs, i_encs = [], []
    _record(monkeypatch, stem, "compress", encs)
    _record(monkeypatch, i_model, "compress", i_encs)
    res = _counted(_msh_launches(N, M, False, 4, 4, 1),
                   lambda: eval_stem.eval_sequence(i_model, stem, seq,
                                                   compute_msssim=False))
    pixels = CHARM_EVAL_HW * CHARM_EVAL_HW
    want = np.mean([actual_bpp(i_encs[0]["strings"], pixels)] + [
        actual_bpp(e["strings"], pixels, counts=e.get("counts"))
        for e in encs])
    assert all(np.isfinite(v) for k, v in res.items() if k != "ms_ssim")
    assert res["frames"] == 3 and len(encs) == 2
    assert abs(res["bpp"] - want) <= 1e-12


@pytest.mark.cuda
def test_cuda_train_stem_with_a_charm_module(card, tmp_path):
    """Two train_stem steps (per_sequence) with ``module=`` a charm module
    (G 4, EB 256, M 192) at 4 × 3 × 256² behind the hero I checkpoint:
    finite losses, and every parameter moved but the last group's LRP,
    which the rate loss does not reach (its refinement feeds only the ŷ
    carry, which the next frame takes detached; the same in the JAX
    trainer); 3 gdn_fused launches (C = 128) per get_y call, two steps
    and a validation."""
    from spatiotemporalentropymodel_tpu_torch.models import (
        ChannelARSTEMModule,
    )
    from spatiotemporalentropymodel_tpu_torch.training import (
        train_stem as ts,
    )
    from spatiotemporalentropymodel_tpu_torch.utils.config import (
        TrainStemConfig,
    )

    cfg = TrainStemConfig(i_checkpoint=_hero_i_checkpoint(),
                          step_mode="per_sequence", cropsize=CHARM_EVAL_HW,
                          batch_size=4, device=card.type,
                          workdir=str(tmp_path))
    i_model = ts.build_i_model(cfg, card)
    module = ChannelARSTEMModule(
        CHARM_GROUPS, cfg.entropy_bottleneck_channels, cfg.in_channels,
        generator=torch.Generator().manual_seed(3)).to(card)
    before = {k: p.detach().clone() for k, p in module.named_parameters()}
    _, metrics = _counted(
        _msh_launches(HERO_N, M, False, 3, 0),
        lambda: ts.train_stem(cfg, max_steps=2, i_model=i_model,
                              module=module))
    _finite(metrics)
    last = f"LRP_{CHARM_GROUPS - 1}."
    for k, p in module.named_parameters():
        assert torch.equal(p, before[k]) == k.startswith(last), k


# W-split serving against the unsplit pipeline (bf16): symbols that flip
# (|Δŷ| ≥ 0.5) at most this share, else |Δŷ| ≤ 1e-4 (μ's bits); x̂ by the
# bf16 slice's criteria (max 6e-2, mean 2e-3)
SPLIT_FLIP_SHARE = 1e-4
SPLIT_Y_ATOL = 1e-4
SPLIT_X_MAX, SPLIT_X_MEAN = 6e-2, 2e-3
# gop_forward_sharded against gop_forward (f32): every element of x̂ within
# the f32 test tolerance (tests/test_torch_parallel.py)
GOP_X_ATOL = 1e-5


@pytest.mark.cuda
def test_cuda_data_parallel_training_and_export(card, monkeypatch, tmp_path):
    """Data-parallel training at the trainers' configurations: train_image
    (MeanScaleHyperprior(128, 192), 16 × 256²) and train_stem res
    per_sequence (4 × 7 × 256², the hero I checkpoint) with
    data_parallel=True. On make_mesh() (the card alone) the run equals the
    data_parallel=False run of the same seed exactly; on a mesh naming the
    card twice, one step with fed noise equals the one-device step within
    the training tolerances (loss 1e-4 relative, gradients 1e-4·max|g|,
    parameters 1e-6 where pinned), and three steps run with finite
    metrics; launches exact in every run. Then update_model exports the
    one-entry run's checkpoint, which loads back to the trained
    parameters and round-trips the probe's first 1088 × 1920 frame in bf16
    with encoder ŷ == decoder ŷ and exact launches."""
    from spatiotemporalentropymodel_tpu_torch.eval.update_model import (
        update_checkpoint,
    )
    from spatiotemporalentropymodel_tpu_torch.parallel import Mesh
    from spatiotemporalentropymodel_tpu_torch.training import (
        load_checkpoint,
    )
    from spatiotemporalentropymodel_tpu_torch.training import (
        train_image as ti,
    )
    from spatiotemporalentropymodel_tpu_torch.training import (
        train_stem as ts,
    )
    from spatiotemporalentropymodel_tpu_torch.utils.config import (
        TrainImageConfig, TrainStemConfig,
    )
    from spatiotemporalentropymodel_tpu_torch.zoo import create_model

    ckpt = _hero_i_checkpoint()
    i_model = ts.build_i_model(
        TrainStemConfig(i_checkpoint=ckpt, device=card.type), card)

    def image(tag, dp, steps, n):
        cfg = TrainImageConfig(workdir=str(tmp_path / tag), data_parallel=dp,
                               device=card.type)
        model = create_model(cfg.model, cfg.quality, device=card)
        state, metrics = _counted(
            _msh_launches(HERO_N, M, False, steps * n, steps * n,
                          graph=True),
            lambda: ti.train_image(cfg, max_steps=steps, model=model))
        return state, _finite(metrics)

    def stem(tag, dp, steps=1):
        cfg = TrainStemConfig(i_checkpoint=ckpt, data_parallel=dp,
                              step_mode="per_sequence", device=card.type,
                              workdir=str(tmp_path / tag))
        # get_y of each step's batch and of the validation batch
        state, metrics = _counted(
            _msh_launches(HERO_N, M, False, steps + 1, 0),
            lambda: ts.train_stem(cfg, max_steps=steps, i_model=i_model))
        return state, _finite(metrics)

    runs = {"image": [image("image_plain", False, 2, 1),
                      image("image_card", True, 2, 1)],
            "stem": [stem("stem_plain", False), stem("stem_card", True)]}
    for name, ((s0, m0), (s1, m1)) in runs.items():
        assert m0 == m1, name
        assert all(torch.equal(a, b) for a, b in zip(
            s0.module.parameters(), s1.module.parameters())), name
    trained = runs["image"][1][0].module

    mesh2 = Mesh((card, card))
    for ns in (ti, ts):
        monkeypatch.setattr(ns, "training_mesh", lambda device: mesh2)
    with monkeypatch.context() as m:
        _feed_noise(m, models=True)
        pairs = {"image": [image("image_fed", False, 1, 1),
                           image("image_dp2", True, 1, 2)],
                 "stem": [stem("stem_fed", False), stem("stem_dp2", True)]}
    image("image_dp2_steps", True, 3, 2)
    stem("stem_dp2_steps", True, 3)
    for name, ((s0, m0), (s1, m1)) in pairs.items():
        for k, v in m0.items():
            assert abs(m1[k] - v) <= TRAIN_LOSS_RTOL * abs(v), (name, k)
        g0, g1 = _first_moments(s0), _first_moments(s1)
        _assert_grads_close(g1, g0, TRAIN_GRAD_TOL)
        _assert_first_step_params(_params_of(s1.module),
                                  _params_of(s0.module), g1, g0)

    out = update_checkpoint(
        create_model("mbt2018-mean", 4, device=card, seed=5),
        str(tmp_path / "image_card" / "ckpt" / "image_latest.pkl"),
        str(tmp_path / "export"), "mbt2018-mean")
    model = create_model("mbt2018-mean", 4, device=card, seed=6)
    model.load_state_leaves(load_checkpoint(out)["model"])
    for (k, a), b in zip(model.module.named_parameters(),
                         trained.parameters()):
        assert "quantiles" in k or torch.equal(a, b), k
    model.set_compute_dtype(torch.bfloat16)
    x = _hero_frames(card)[0]
    enc = model.compress(x)
    model.decompress(enc["strings"], enc["shape"])  # warm-up
    kernels.reset_launch_counts()
    enc = model.compress(x)
    dec = model.decompress(enc["strings"], enc["shape"])
    _launched(_msh_launches(HERO_N, M, True, 1, 1, 1))
    _, y_enc = model.fused_encode_expr(x)
    assert torch.equal(y_enc, dec["y_hat"])
    assert bool(torch.isfinite(dec["x_hat"]).all())


@pytest.mark.cuda
def test_cuda_gop_forward_sharded_hero(card):
    """gop_forward_sharded of the hero I-model and without_spm (f32) on the
    probe's 4 frames of 1088 × 1920 at B = 2 (each frame and its mirror
    image): the I-frame's ŷ, then the 3 P-frames through gop_forward and
    through gop_forward_sharded on a mesh naming the card twice, each with
    its launches exact by width; x̂ within 1e-5, bpp rtol 1e-5."""
    from spatiotemporalentropymodel_tpu_torch.eval.workload import load_hero
    from spatiotemporalentropymodel_tpu_torch.parallel import Mesh

    models = load_hero(device=card, variants=("without_spm",))
    i_model, stem = models["i"], models["without_spm"]
    frames = [torch.cat([f, f.flip(-1)]) for f in _hero_frames(card)]
    y0 = _iframe_y_hat(i_model, frames[0])
    gop = torch.stack(frames[1:])  # (3, 2, 3, H, W)
    pipe = StemVideoPipeline(i_model, stem)
    mesh = Mesh((card, card))
    pipe.gop_forward_sharded(gop[:1], y0, mesh)  # warm-up, both shapes
    pipe.gop_forward(gop[:1], y0)
    t = gop.shape[0]
    x_ref, bpp_ref = _counted(_msh_launches(HERO_N, M, False, t, t),
                              lambda: pipe.gop_forward(gop, y0))
    x_sh, bpp_sh = _counted(
        _msh_launches(HERO_N, M, False, 2 * t, 2 * t),
        lambda: pipe.gop_forward_sharded(gop, y0, mesh))
    assert float((x_sh - x_ref).abs().max()) <= GOP_X_ATOL
    assert float(((bpp_sh - bpp_ref).abs() / bpp_ref).max()) <= GOP_RTOL


def _flipped(got, ref):
    """Elements of got off ref by ≥ 0.5 (flipped roundings), and the
    largest |Δ| elsewhere."""
    diff = (got - ref).abs()
    off = diff >= 0.5
    return int(off.sum()), float(diff[~off].max())


@pytest.mark.cuda
def test_cuda_w_split_serving(card):
    """W-split serving: the 192-wide headline models (MeanScaleHyperprior
    (192, 192), STEM without_spm, EB 256, the benchmark workload's surgery)
    at 4 × 3 × 1088 × 1920 in bf16, 3 P-frames through StemVideoPipeline
    unsplit and with spatial meshes of 2 and 4 entries of the card: every
    frame sparse, the carry and x̂ Sharded, encoder ŷ == decoder ŷ, the
    split streams decoded by the unsplit pipeline and the unsplit ones by
    the split pipeline to the encoder's ŷ exactly, the streams the unsplit
    pipeline's or their flipped symbols counted (at most 1e-4 of them,
    |Δŷ| ≤ 1e-4 elsewhere), x̂ within the bf16 slice's criteria, and the
    launches exact by width (the nets once per shard, the quantizer once
    on the whole latent)."""
    from spatiotemporalentropymodel_tpu_torch.parallel import (
        SP_AXIS, Mesh, Sharded,
    )
    from spatiotemporalentropymodel_tpu_torch.parallel.spatial import whole

    imodel, stem, frames, y_cond = _headline_slice(card, *SLICES["n192"])
    imodel.set_compute_dtype(torch.bfloat16)
    stem.set_compute_dtype(torch.bfloat16)

    def serve(pipe, n):
        enc, _ = pipe.encode_frame(frames[0], y_cond)  # warm-up
        pipe.decode_frame(enc, y_cond=y_cond)
        kernels.reset_launch_counts()
        encs = list(pipe.encode_frames(frames, y_cond))
        dec = list(pipe.decode_frames(encs, y_cond))
        _launched(_msh_launches(N, M, True, P_FRAMES * n, P_FRAMES * n,
                                P_FRAMES))
        return encs, dec

    ref_pipe = StemVideoPipeline(imodel, stem)
    ref_encs, ref_dec = serve(ref_pipe, 1)
    for n in (2, 4):
        pipe = StemVideoPipeline(imodel, stem,
                                 spatial_mesh=Mesh((card,) * n, SP_AXIS))
        encs, dec = serve(pipe, n)
        # each pipeline decodes the other's streams to the encoder's ŷ
        for other, mine in ((ref_pipe.decode_frames(encs, y_cond), dec),
                            (pipe.decode_frames(ref_encs, y_cond), ref_dec)):
            for (_, y_o), (_, y_m) in zip(other, mine):
                assert torch.equal(whole(y_o), whole(y_m)), n
        same, flips, y_enc = 0, 0, y_cond
        for i, (enc, ref, (x_hat, y_hat), (x_ref, y_ref)) in enumerate(
                zip(encs, ref_encs, dec, ref_dec)):
            assert enc["transport"] == "sparse", (n, i)
            assert isinstance(y_hat, Sharded) and isinstance(x_hat, Sharded)
            assert len(y_hat.shards) == n
            _, y_enc = pipe.encode_frame(frames[i], y_enc)
            yd = y_hat.gather()
            assert torch.equal(y_enc.gather(), yd), (n, i)
            same += enc["strings"] == ref["strings"]
            count, y_err = _flipped(yd, y_ref)
            assert count <= SPLIT_FLIP_SHARE * yd.numel(), (n, i, count)
            assert y_err <= SPLIT_Y_ATOL, (n, i, y_err)
            flips += count
            dx = (x_hat.gather().float() - x_ref.float()).abs()
            assert float(dx.max()) <= SPLIT_X_MAX, (n, i)
            assert float(dx.mean()) <= SPLIT_X_MEAN, (n, i)
        assert same == P_FRAMES or flips, n
