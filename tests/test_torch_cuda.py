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
order, so by at most one bf16 step: rtol 2⁻⁷.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spatiotemporalentropymodel_tpu_torch.entropy import get_scale_table
from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
    StemVideoPipeline,
)
from spatiotemporalentropymodel_tpu_torch.eval.workload import (
    match_latent_to_prior,
    realistic_stem,
)
from spatiotemporalentropymodel_tpu_torch.models import (
    MeanScaleHyperprior,
    SpatioTemporalPriorModel,
)
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


PLAIN_TOL, WINDOW_TOL = 2**-6, 2**-8


def _assert_scaled_close(out, ref, tol):
    err = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    assert err <= tol * scale, f"max err {err} > {tol} × max|ref| {scale}"


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


@pytest.mark.cuda
@pytest.mark.parametrize("c,h,w", [(64, 26, 38), (192, 17, 35)])
def test_cuda_gdn_conv_fused_matches_plain(cuda, c, h, w):
    """Odd and ragged sizes: partial output tiles on both edges."""
    rng = np.random.default_rng(c + h)
    x = _bf16(rng, (2, c, h, w), cuda)
    gt, beta = _gdn_params(rng, c, cuda)
    weight = _bf16(rng, (c, c, 5, 5), cuda, 0.05)
    bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32)).to(
        cuda)
    n0 = kernels.LAUNCHES["gdn_conv_fused"]
    out = kernels.gdn_conv_fused(x, gt, beta, weight, bias)
    ref = kernels._gdn_conv_ref(x, gt, beta, weight, bias)
    win = _window_bf16_conv(x, gt, beta, False, lambda g: F.conv2d(
        g, weight.float(), bias, 2, 2))
    torch.cuda.synchronize()
    assert out.shape == ref.shape == (2, c, (h + 1) // 2, (w + 1) // 2)
    _assert_scaled_close(out, ref, PLAIN_TOL)
    _assert_scaled_close(out, win, WINDOW_TOL)
    assert kernels.LAUNCHES["gdn_conv_fused"] == n0 + 1


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


@pytest.mark.cuda
@pytest.mark.parametrize("c", [64, 128, 192])
@pytest.mark.parametrize("f", [3, 8, 32])
def test_cuda_igdn_deconv_fused_matches_plain(cuda, c, f):
    """The narrow kernel at 1, 2 and 4 passes of 32 GEMM rows (F = 3, 8,
    32), at 17 × 30: partial tiles on the bottom and right edges."""
    rng = np.random.default_rng(10 * c + f)
    x = _bf16(rng, (2, c, 17, 30), cuda)
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
    assert out.shape == (2, f, 34, 60)
    _assert_scaled_close(out, ref, PLAIN_TOL)
    _assert_scaled_close(out, win, WINDOW_TOL)
    assert (kernels.LAUNCHES["igdn_deconv_fused"]
            == n0["igdn_deconv_fused"] + 1)
    assert (kernels.LAUNCHES["igdn_deconv_tail_packed"]
            == n0["igdn_deconv_tail_packed"])


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(2, 17, 30), (1, 136, 240)])
def test_cuda_igdn_deconv_wide_matches_plain(cuda, b, h, w):
    """The lone wide kernel at C = O = 192: a ragged 17 × 30 input, and the
    wide chain's first stage, 136 × 240 (240 columns = 7.5 tiles)."""
    c = 192
    rng = np.random.default_rng(h + w)
    x = _bf16(rng, (b, c, h, w), cuda)
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
    stem = SpatioTemporalPriorModel(32, 64, device=device, seed=1)
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
                        kernels._qidx_ref(y, m, s, t, scale_bound))


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
