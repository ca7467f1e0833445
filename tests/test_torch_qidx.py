"""``quantize_and_index`` on its new inputs, on the CPU: bf16 (y, μ, σ), and
(σ, μ) as the two channel-halves of one (B, 2M, H, W) tensor, against the
JAX package's Pallas kernel in interpret mode on the same values cast to
f32 (exact: bf16 → f32 loses nothing); a NumPy mirror of the card kernel's
padded lower-bound search against ``np.searchsorted``; the table check; the
kernel's rows and batch strides; and the encoder callers handing the net
outputs to the quantizer without a cast or a copy. Every comparison is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spatiotemporalentropymodel_tpu.entropy import get_scale_table
from spatiotemporalentropymodel_tpu.ops import pallas_kernels as pk
from spatiotemporalentropymodel_tpu_torch.models import (
    MeanScaleHyperprior,
    SpatioTemporalPriorModel,
)
from spatiotemporalentropymodel_tpu_torch.ops import kernels

from test_torch_ops import _qidx_inputs
from torch_port_util import to_nchw, to_nhwc

BOUND = 0.11


def _pallas(y, means, scales, table):
    """The JAX package's kernel in interpret mode on NHWC f32 arrays."""
    sym, idx = pk.quantize_and_index(jnp.asarray(y), jnp.asarray(means),
                                     jnp.asarray(scales), table,
                                     interpret=True)
    return np.asarray(sym), np.asarray(idx)


def _bf16_inputs(seed=4, shape=(2, 8, 8, 64)):
    """``_qidx_inputs`` rounded to bf16, NHWC, with σ's edges moved to bf16:
    every table entry rounded to bf16 and its two bf16 neighbours, the
    bound, 0 and −1. The ties (±k.5) and the values beyond ±2³⁰ stay."""
    y, means, scales, table = _qidx_inputs(seed, shape)
    yb, mb, sb = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in (y, means, scales))
    t = torch.from_numpy(table.astype(np.float32)).to(torch.bfloat16)
    bits = t.view(torch.int16)  # positive: ±1 in the bits is ±1 bf16 step
    edges = torch.cat([
        t, (bits - 1).view(torch.bfloat16), (bits + 1).view(torch.bfloat16),
        torch.tensor([BOUND, 0.0, -1.0], dtype=torch.bfloat16),
    ])
    sb.view(-1)[:edges.numel()] = edges
    return yb, mb, sb, table


def _f32(t):
    return t.float().numpy()


def test_quantize_and_index_bf16_matches_pallas_exactly():
    yb, mb, sb, table = _bf16_inputs()
    ref_sym, ref_idx = _pallas(_f32(yb), _f32(mb), _f32(sb), table)
    sym, idx = kernels.quantize_and_index(
        *(to_nchw(_f32(t)).to(torch.bfloat16) for t in (yb, mb, sb)), table)
    assert sym.dtype == torch.int32 and idx.dtype == torch.uint8
    np.testing.assert_array_equal(to_nhwc(sym), ref_sym)
    np.testing.assert_array_equal(to_nhwc(idx), ref_idx)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_and_index_takes_channel_halves(dtype):
    """(σ, μ) as ``chunk``'s halves of one (B, 2M, H, W) tensor, the way
    EPM and h_s hand them over."""
    if dtype == torch.bfloat16:
        yb, mb, sb, table = _bf16_inputs(seed=6)
        y, means, scales = (_f32(t) for t in (yb, mb, sb))
    else:
        y, means, scales, table = _qidx_inputs(seed=6)
    ref_sym, ref_idx = _pallas(y, means, scales, table)
    both = torch.cat([to_nchw(scales), to_nchw(means)], dim=1).to(dtype)
    s_half, m_half = both.chunk(2, dim=1)
    assert not m_half.is_contiguous()
    sym, idx = kernels.quantize_and_index(to_nchw(y).to(dtype), m_half,
                                          s_half, table)
    np.testing.assert_array_equal(to_nhwc(sym), ref_sym)
    np.testing.assert_array_equal(to_nhwc(idx), ref_idx)


def _padded_search(table, sigma, bound=BOUND):
    """The card kernel's index (kernels.cu::qidx_kernel) step by step: the
    table but its last entry, padded with +inf to 2^k − 1 entries, 2^k >
    n_table, in shared-memory slots t + t/32; then i += (t[i + h − 1] < s)
    ? h : 0 for h = 2^(k−1) .. 1, with s = fmax(σ, bound)."""
    n_table = table.size - 1
    steps = 0
    while (1 << steps) <= n_table:
        steps += 1
    t = np.arange((1 << steps) - 1)
    slots = np.full(256 + 256 // 32, np.nan, np.float32)  # NaN: never read
    slots[t + (t >> 5)] = np.concatenate(
        [table[:-1], np.full(t.size - n_table, np.inf, np.float32)])
    s = np.fmax(sigma, np.float32(bound))
    i = np.zeros(s.shape, np.int64)
    h = (1 << steps) >> 1
    while h:
        j = i + h - 1
        i += np.where(slots[j + (j >> 5)] < s, h, 0)
        h >>= 1
    return i, steps


def _sorted_table(size, rng):
    if size == 64:
        return get_scale_table().astype(np.float32)
    t = np.sort(np.exp(rng.uniform(np.log(0.05), np.log(300.0), size)))
    t = t.astype(np.float32)
    if size > 4:  # a repeated entry: non-decreasing, not increasing
        t[size // 2] = t[size // 2 - 1]
    return t


@pytest.mark.parametrize("size,steps", [(1, 0), (2, 1), (63, 6), (64, 6),
                                        (255, 8), (256, 8)])
def test_padded_search_equals_searchsorted(size, steps):
    table = _sorted_table(size, np.random.default_rng(size))
    sigma = np.concatenate([
        table, np.nextafter(table, np.float32(-np.inf)),
        np.nextafter(table, np.float32(np.inf)),
        np.array([BOUND, 0.0, -1.0, np.inf], np.float32),
    ]).astype(np.float32)
    got, took = _padded_search(table, sigma)
    want = np.searchsorted(table[:-1], np.maximum(sigma, np.float32(BOUND)),
                           side="left")
    assert took == steps
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("table", [[0.2, 0.1], [0.11, np.nan, 0.3],
                                   [[0.1, 0.2]]])
def test_scale_table_tensor_rejects_other_tables(table):
    """Not a non-decreasing vector: decreasing, a NaN, two dimensions."""
    with pytest.raises(ValueError):
        kernels.scale_table_tensor(table, "cpu")


def test_quantize_and_index_rejects_mixed_dtypes():
    x = torch.zeros((1, 4, 2, 2))
    t = kernels.scale_table_tensor(get_scale_table(), "cpu")
    with pytest.raises(TypeError):
        kernels.quantize_and_index(x, x.to(torch.bfloat16), x, t)
    with pytest.raises(TypeError):
        kernels.quantize_and_index(x.double(), x.double(), x.double(), t)


def _rows(*tensors):
    strides = kernels._contiguous_strides(tensors[0].shape)
    return kernels._qidx_rows(tensors, tensors[0].numel(), strides)


def test_qidx_rows_reads_views_and_copies_the_rest():
    """The kernel's rows: contiguous tensors as one row; channel-halves as
    batch rows at their own strides, with no copy; a permuted tensor
    copied; a batch beyond the grid's rows as one row of copies; size-1
    dimensions at any stride as contiguous."""
    y = torch.zeros((2, 3, 4, 5))
    n = y.numel()
    assert kernels._contiguous_strides(y.shape) == y.stride()
    rows, per, ins = _rows(y, y, y)
    assert (rows, per) == (1, n) and all(t is y for t, _ in ins)

    s_half, m_half = torch.zeros((2, 6, 4, 5)).chunk(2, dim=1)
    rows, per, ins = _rows(y, m_half, s_half)
    assert (rows, per) == (2, 60)
    assert [s for _, s in ins] == [60, 120, 120]
    assert ins[1][0] is m_half and ins[2][0] is s_half

    perm = torch.zeros((2, 4, 5, 3)).permute(0, 3, 1, 2)
    rows, per, ins = _rows(y, perm, y)
    assert (rows, per) == (1, n) and ins[1][0].is_contiguous()
    assert ins[1][0] is not perm

    one = torch.zeros((1, 6, 4, 5))[:, :3]
    odd = torch.zeros((1, 3, 1, 5)).as_strided((1, 3, 1, 5), (99, 5, 77, 1))
    for t in (one, odd):
        rows, per, ins = _rows(t, t, t)
        assert (rows, per) == (1, t.numel()) and ins[0][0] is t

    wide = torch.zeros((kernels._QIDX_MAX_ROWS + 1, 2, 1))
    w_half, _ = torch.zeros((kernels._QIDX_MAX_ROWS + 1, 4, 1)).chunk(2, 1)
    rows, per, ins = _rows(wide, w_half, wide)
    assert (rows, per) == (1, wide.numel()) and ins[1][0].is_contiguous()


def _spy_quantizer(monkeypatch):
    """Record what the encoder hands ``quantize_and_index``."""
    seen = []
    real = kernels.quantize_and_index

    def spy(y, means, scales, table, scale_bound=0.11):
        seen.append((y, means, scales))
        return real(y, means, scales, table, scale_bound)

    monkeypatch.setattr(kernels, "quantize_and_index", spy)
    return seen


def _halves_of_one_tensor(means, scales):
    return (means.untyped_storage().data_ptr()
            == scales.untyped_storage().data_ptr()
            and means.data_ptr() != scales.data_ptr())


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_encoders_hand_net_outputs_to_the_quantizer(dtype, monkeypatch):
    """The STEM encoder (sparse and dense) and the I-frame encoder give the
    quantizer y, σ and μ in the compute dtype, σ and μ as the halves of the
    net's output (no cast, no copy), and the sparse carry still equals the
    dense decoder's ŷ exactly."""
    torch.manual_seed(0)
    want = dtype or torch.float32
    imodel = MeanScaleHyperprior(32, 32, device="cpu", seed=0)
    stem = SpatioTemporalPriorModel(variant="without_spm",
                                    entropy_bottleneck_channels=32,
                                    in_channels=32, device="cpu", seed=1)
    imodel.update()
    stem.update()
    imodel.set_compute_dtype(dtype)
    stem.set_compute_dtype(dtype)
    x = torch.rand((2, 3, 64, 64))
    y_cond = 0.5 * torch.randn((2, 32, 4, 4))
    seen = _spy_quantizer(monkeypatch)
    y_cur = imodel.analysis(x)
    assert y_cur.dtype == want
    _, y_hat = stem.fused_encode_sparse_carry_expr(y_cur, y_cond)
    packed = stem.fused_encode_expr(y_cur, y_cond)
    imodel.fused_encode_expr(x)
    assert len(seen) == 3
    for y, means, scales in seen:
        assert y.dtype == means.dtype == scales.dtype == want
        assert _halves_of_one_tensor(means, scales)
    assert seen[0][0] is y_cur and seen[1][0] is y_cur
    if dtype is not None:  # a caller's f32 y_cur: all three go in f32
        stem.fused_encode_sparse_carry_expr(y_cur.float(), y_cond)
        assert all(t.dtype == torch.float32 for t in seen[-1])
    # the dense decoder's ŷ from the dense buffer equals the sparse carry
    b, m, h, w = y_cur.shape
    zn = 2 * 1 * 1 * 32
    z_sym = packed[b * h * w * m * 2:][:zn * 2].view(torch.int16).view(
        b, 1, 1, 32).permute(0, 3, 1, 2).to(torch.int32)
    means, idx = stem.fused_params_expr(z_sym, y_cond)
    y_sym = packed[:b * h * w * m * 2].view(torch.int16).view(
        b, h, w, m).permute(0, 3, 1, 2)
    assert torch.equal(stem.fused_reconstruct_expr(y_sym, means, y_cond),
                       y_hat)
    idx_sent = packed[-b * h * w * m:].view(b, h, w, m).permute(0, 3, 1, 2)
    assert torch.equal(idx_sent, idx)
