"""The operands that the wrappers hand to the tensor-core kernels
(ops/csrc/gdn_window_tc.cuh, kernels.cu): γ split into bf16 hi + lo or
into three bf16 pieces, and the conv and deconv weights packed one ring
stage after another. Each is checked by a plain emulation of the kernel's
arithmetic over that layout, on the CPU, against the JAX package.

- hi + lo is γ to 2⁻¹⁶ relative (bf16 keeps 8 significant bits, so two
  terms keep 16).
- The split-bf16 norm, s_hi·g_hi + s_hi·g_lo + s_lo·g_hi summed in f32 with
  x² = s_hi + s_lo exact for bf16 x, drops terms below 2⁻¹⁶ of the norm: its
  GDN is held to the JAX ``_gdn_ref`` (an f32 product) at 2⁻¹⁴ relative, on
  inputs spanning five decades so that x²·γ dominates β.
- The three-piece split of an f32 (x² or γ, 24 significant bits) is exact,
  and the six-product norm of the f32 ``gdn_fused``, Σ s_i·g_j over
  i + j ≤ 2 summed in f32, drops terms below 3·2⁻²⁴ of the norm: its GDN is
  held to the JAX ``_gdn_ref`` at 2⁻²⁰ relative over five decades, the
  rounding of two f32 sums in different orders.
- The implicit GEMMs over the packed weights, in f32, equal the JAX
  ``_gdn_conv_ref``, the interpret-mode ``igdn_deconv_wide`` and
  ``igdn_deconv_fused`` and the tail's ``_igdn_deconv_tail_packed_ref`` at
  f32 atol 1e-4 (tests/test_torch_fused.py's tolerance for the plain
  versions).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.ops import pallas_kernels as pk
from spatiotemporalentropymodel_tpu_torch.convert import (
    invert_conv_weight,
    invert_deconv_weight,
)
from spatiotemporalentropymodel_tpu_torch.ops import kernels

from torch_port_util import pack_phase_major, to_nchw, to_nhwc

F32_ATOL = 1e-4


def _gdn_params(rng, c):
    gt = (0.01 * np.abs(rng.standard_normal((c, c)))
          + 0.1 * np.eye(c)).astype(np.float32)
    return gt, (1.0 + rng.random(c)).astype(np.float32)


def _unsplit(gs):
    """(C/32, C, 64) split → (hi, lo), each (C, C) f32 as γ[o][i]."""
    k, c, _ = gs.shape
    hi = gs[:, :, :32].permute(1, 0, 2).reshape(c, c).float()
    lo = gs[:, :, 32:].permute(1, 0, 2).reshape(c, c).float()
    return hi, lo


def _split_norm_gdn(x_rows, gs, beta, inverse):
    """The kernels' (I)GDN of bf16 rows (R, C): x² split exactly into bf16
    hi + lo, the three bf16 products summed in f32, then x·rsqrt(β + norm)
    (IGDN: x·sqrt) in f32."""
    x = x_rows.float()
    s = x * x
    s_hi = s.to(torch.bfloat16).float()
    s_lo = (s - s_hi).to(torch.bfloat16).float()
    assert torch.equal(s_hi + s_lo, s)  # a bf16 square has 16 bits
    g_hi, g_lo = _unsplit(gs)
    norm = s_hi @ g_hi.t() + s_hi @ g_lo.t() + s_lo @ g_hi.t() + beta
    return x * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))


@pytest.mark.parametrize("c", [64, 128, 192])
def test_split_gamma_sums_to_gamma(c):
    rng = np.random.default_rng(c)
    gt = (rng.random((c, c)) * 10.0 ** rng.uniform(-4, 2, (c, c))).astype(
        np.float32)
    gs = kernels.split_gamma(torch.from_numpy(gt))
    assert gs.shape == (c // 32, c, 64) and gs.dtype == torch.bfloat16
    hi, lo = _unsplit(gs)
    g = torch.from_numpy(gt).t()
    assert torch.equal(hi, g.to(torch.bfloat16).float())
    rel = ((hi + lo - g).abs() / g.abs()).max()
    assert float(rel) <= 2**-16


@pytest.mark.parametrize("inverse", [False, True])
def test_split_bf16_norm_matches_jax_gdn_ref(inverse):
    rng = np.random.default_rng(7 + inverse)
    c, rows = 192, 512
    # magnitudes over five decades: x²·γ from far below to far above β
    x = (rng.standard_normal((rows, c))
         * 10.0 ** rng.uniform(-3, 2, (rows, 1))).astype(np.float32)
    x = torch.from_numpy(x).to(torch.bfloat16)
    gt, beta = _gdn_params(rng, c)
    got = _split_norm_gdn(x, kernels.split_gamma(torch.from_numpy(gt)),
                          torch.from_numpy(beta), inverse)
    ref = np.asarray(pk._gdn_ref(jnp.asarray(x.float().numpy()),
                                 jnp.asarray(gt), jnp.asarray(beta), inverse))
    rel = np.abs(got.numpy() - ref) / np.maximum(np.abs(ref), 1e-30)
    assert float(rel.max()) <= 2**-14


def _three_pieces(v):
    """An f32 tensor as the three bf16 pieces of kernels.cu::split_squares,
    each the bf16 rounding of what the earlier ones leave, as f32."""
    pieces = []
    for _ in range(3):
        p = v.to(torch.bfloat16).float()
        pieces.append(p)
        v = v - p
    return pieces


def _unsplit_pieces(gp, k):
    """(C/64 · k, C, 64) pieces → (k, C, C) f32 as γ_j[o][i]."""
    c = gp.shape[1]
    return gp.reshape(c // 64, k, c, 64).permute(1, 2, 0, 3).reshape(
        k, c, c).float()


@pytest.mark.parametrize("c", [64, 128, 192])
def test_split_gamma_pieces_sum_to_gamma(c):
    """Three pieces sum to γ exactly; two are the hi and lo of
    split_gamma, γ to 2⁻¹⁶."""
    rng = np.random.default_rng(c + 1)
    gt = (rng.random((c, c)) * 10.0 ** rng.uniform(-6, 3, (c, c))).astype(
        np.float32)
    gp = kernels.split_gamma_pieces(torch.from_numpy(gt), 3)
    assert gp.shape == (3 * c // 64, c, 64) and gp.dtype == torch.bfloat16
    g = _unsplit_pieces(gp, 3)
    want = torch.from_numpy(gt).t()
    assert torch.equal(g[0], want.to(torch.bfloat16).float())
    assert torch.equal(g.double().sum(0), want.double())
    for j, p in enumerate(_three_pieces(want)):
        assert torch.equal(g[j], p)
    g2 = _unsplit_pieces(kernels.split_gamma_pieces(torch.from_numpy(gt), 2),
                         2)
    hi, lo = _unsplit(kernels.split_gamma(torch.from_numpy(gt)))
    assert torch.equal(g2[0], hi) and torch.equal(g2[1], lo)


def test_three_piece_squares_are_exact():
    """s₀ + s₁ + s₂ = x² exactly (the f32 square, as the kernel forms it),
    for f32 x over twelve decades, each piece exact in bf16."""
    rng = np.random.default_rng(17)
    x = (rng.standard_normal(1 << 16)
         * 10.0 ** rng.uniform(-6, 6, 1 << 16)).astype(np.float32)
    s = torch.from_numpy(x) ** 2
    pieces = _three_pieces(s)
    for p in pieces:
        assert torch.equal(p.to(torch.bfloat16).float(), p)
    assert torch.equal(sum(p.double() for p in pieces), s.double())


@pytest.mark.parametrize("c", [64, 192])
@pytest.mark.parametrize("inverse", [False, True])
def test_six_product_norm_matches_jax_gdn_ref(c, inverse):
    """The f32 gdn_fused kernel's arithmetic: x² and γ in three bf16 pieces
    each, the six products with i + j ≤ 2 summed in f32, then
    x·rsqrt(β + norm) (IGDN: x·sqrt) in f32."""
    rng = np.random.default_rng(c + inverse)
    rows = 512
    x = (rng.standard_normal((rows, c))
         * 10.0 ** rng.uniform(-3, 2, (rows, 1))).astype(np.float32)
    gt, beta = _gdn_params(rng, c)
    xt = torch.from_numpy(x)
    s = _three_pieces(xt * xt)
    g = _unsplit_pieces(kernels.split_gamma_pieces(
        torch.from_numpy(gt), 3), 3)
    norm = torch.zeros((rows, c))
    for i in range(3):
        for j in range(3 - i):
            norm = norm + s[i] @ g[j].t()
    norm = norm + torch.from_numpy(beta)
    got = xt * (torch.sqrt(norm) if inverse else torch.rsqrt(norm))
    ref = np.asarray(pk._gdn_ref(jnp.asarray(x), jnp.asarray(gt),
                                 jnp.asarray(beta), inverse))
    rel = np.abs(got.numpy() - ref) / np.maximum(np.abs(ref), 1e-30)
    assert float(rel.max()) <= 2**-20


def _packed_conv(g, wp, bias):
    """gdn_conv_fused's implicit GEMM over pack_conv_weight's layout, f32:
    out[o, y, x] = b[o] + Σ_{tap, c} wp[tap][c / 64][o][c % 64]
    · g[c, 2y + ky − 2, 2x + kx − 2]."""
    b, c, h, w = g.shape
    o = wp.shape[2]
    ho, wo = (h + 1) // 2, (w + 1) // 2
    gp = torch.nn.functional.pad(g, (2, 2, 2, 2))
    out = bias.view(1, o, 1, 1).expand(b, o, ho, wo).clone()
    for tap in range(25):
        ky, kx = divmod(tap, 5)
        wt = wp[tap].permute(1, 0, 2).reshape(o, c).float()
        patch = gp[:, :, ky:ky + 2 * ho - 1:2, kx:kx + 2 * wo - 1:2]
        out += torch.einsum("oc,bchw->bohw", wt, patch)
    return out


@pytest.mark.parametrize("c,shape", [(64, (2, 9, 14)), (128, (1, 12, 7))])
def test_packed_conv_weight_matches_jax_gdn_conv_ref(c, shape):
    rng = np.random.default_rng(c)
    b, h, w = shape
    x = (0.5 * rng.standard_normal((b, h, w, c))).astype(np.float32)
    gt, beta = _gdn_params(rng, c)
    kernel = (0.05 * rng.standard_normal((5, 5, c, c))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ref = pk._gdn_conv_ref(jnp.asarray(x), jnp.asarray(gt), jnp.asarray(beta),
                           jnp.asarray(kernel), jnp.asarray(bias))
    weight = torch.from_numpy(invert_conv_weight(kernel))
    wp = kernels.pack_conv_weight(weight)
    assert wp.shape == (25, c // 64, c, 64)
    g = kernels._gdn_ref(to_nchw(x), torch.from_numpy(gt),
                         torch.from_numpy(beta), False)
    got = _packed_conv(g, wp, torch.from_numpy(bias))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), atol=F32_ATOL)


def _packed_wide(g, wp, bias):
    """The wide kernel's 4 phase GEMMs over pack_wide_weight's layout, f32:
    out[o, 2m + a, 2n + b] = b[o] + Σ over the taps t of phase a·2 + b
    and c of wp[t][c / 64][o][c % 64] · g[c, m + dy, n + dx]."""
    b, c, h, w = g.shape
    o = wp.shape[2]
    gp = torch.nn.functional.pad(g, (1, 1, 1, 1))
    out = bias.view(1, o, 1, 1).expand(b, o, 2 * h, 2 * w).clone()
    for t, (ph, dy, dx, _, _) in enumerate(kernels.wide_taps()):
        wt = wp[t].permute(1, 0, 2).reshape(o, c).float()
        patch = gp[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        out[:, :, ph >> 1::2, ph & 1::2] += torch.einsum("oc,bchw->bohw", wt,
                                                         patch)
    return out


@pytest.mark.parametrize("c", [64, 128])
def test_packed_wide_weight_matches_jax_interpret(c):
    rng = np.random.default_rng(3 * c)
    x = (0.5 * rng.standard_normal((2, 4, 6, c))).astype(np.float32)
    gt, beta = _gdn_params(rng, c)
    kernel = (0.05 * rng.standard_normal((5, 5, c, c))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32)
    ref = pk.igdn_deconv_wide(jnp.asarray(x), jnp.asarray(gt),
                              jnp.asarray(beta), jnp.asarray(kernel),
                              jnp.asarray(bias), interpret=True)
    taps = kernels.wide_taps()
    assert len(taps) == 25 and [t[0] for t in taps].count(0) == 9
    wp = kernels.pack_wide_weight(torch.from_numpy(invert_deconv_weight(
        kernel)))
    assert wp.shape == (25, c // 64, c, 64)
    g = kernels._gdn_ref(to_nchw(x), torch.from_numpy(gt),
                         torch.from_numpy(beta), True)
    got = _packed_wide(g, wp, torch.from_numpy(bias))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), atol=F32_ATOL)


def _packed_narrow(g, wp, bias_m, f):
    """The narrow kernel's GEMM over pack_narrow_weight's layout, f32:
    row r = o·4 + a·2 + b of out[o, 2m + a, 2n + b] = bias_m[r] + Σ over
    the 9 taps (dy + 1)·3 + (dx + 1) and c of wp[tap][c / 64][r][c % 64] ·
    g[c, m + dy, n + dx]."""
    b, c, h, w = g.shape
    rows = wp.shape[2]
    gp = torch.nn.functional.pad(g, (1, 1, 1, 1))
    acc = bias_m.view(1, rows, 1, 1).expand(b, rows, h, w).clone()
    for tap in range(9):
        dy, dx = tap // 3 - 1, tap % 3 - 1
        wt = wp[tap].permute(1, 0, 2).reshape(rows, c).float()
        patch = gp[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
        acc += torch.einsum("rc,bchw->brhw", wt, patch)
    v = acc[:, :4 * f].reshape(b, f, 2, 2, h, w)  # o, a, b, m, n
    return v.permute(0, 1, 4, 2, 5, 3).reshape(b, f, 2 * h, 2 * w)


def _narrow_case(seed, shape, f):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    gt, beta = _gdn_params(rng, c)
    kernel = (0.05 * rng.standard_normal((5, 5, c, f))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(f)).astype(np.float32)
    weight = torch.from_numpy(invert_deconv_weight(kernel))
    wp = kernels.pack_narrow_weight(weight)
    assert wp.shape == (9, c // 64, kernels.narrow_rows(f), 64)
    _, _, rows_o, live = kernels._narrow_index(torch.device("cpu"), f)
    bias_m = torch.where(live, torch.from_numpy(bias)[rows_o], 0.0)
    g = kernels._gdn_ref(to_nchw(x), torch.from_numpy(gt),
                         torch.from_numpy(beta), True)
    return (x, gt, beta, kernel, bias), _packed_narrow(g, wp, bias_m, f)


@pytest.mark.parametrize("f", [3, 8, 32])
def test_packed_narrow_weight_matches_jax_interpret(f):
    """At 16, 32 and 128 GEMM rows, against the interpret-mode
    igdn_deconv_fused."""
    (x, gt, beta, kernel, bias), got = _narrow_case(5 * f, (2, 4, 6, 64), f)
    ref = pk.igdn_deconv_fused(jnp.asarray(x), jnp.asarray(gt),
                               jnp.asarray(beta), jnp.asarray(kernel),
                               jnp.asarray(bias), 2, interpret=True)
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), atol=F32_ATOL)


def test_packed_narrow_weight_matches_jax_tail_packed_ref():
    """The tail's layout: the logical input packed phase-major for the JAX
    _igdn_deconv_tail_packed_ref, F = 3, C = 128."""
    (x, gt, beta, kernel, bias), got = _narrow_case(23, (1, 6, 8, 128), 3)
    ref = pk._igdn_deconv_tail_packed_ref(
        jnp.asarray(pack_phase_major(x)), jnp.asarray(gt), jnp.asarray(beta),
        jnp.asarray(kernel), jnp.asarray(bias))
    np.testing.assert_allclose(to_nhwc(got), np.asarray(ref), atol=F32_ATOL)
