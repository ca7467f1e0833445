"""Cheng2020's residual and attention blocks and the ROI family's SFT
layers, NCHW.

Counterpart of spatiotemporalentropymodel_tpu/layers/blocks.py
(compressai/layers/layers.py:67-213, compressai/models/stem_utils.py:
24-63). The submodules carry the JAX package's names (``conv1``, ``gdn``,
``skip``, ``subpel_conv``, ``a_0`` …), so the parameter trees map one to
one (convert.py). Each GDN and IGDN is the
port's ``GDN`` layer, so it runs the ``gdn_fused`` kernel in f32 and bf16.
In bf16 every step rounds where the JAX package's does: each conv's bias
goes on after its rounded sum (``Conv``), the LeakyReLU slope is bf16, the
sigmoid rounds after each of its three operations (``_sigmoid``), and the
gate's product and the residual sums round to bf16 each.

The quality-map layers (``adaptive_avg_pool``, ``SFT``, ``SFTResblk``)
carry the JAX package's names too (``mlp_shared``, ``mlp_gamma``,
``mlp_beta``; ``norm_0``, ``conv_0``, ``norm_1``, ``conv_1``). At bf16 the
pool's mean runs in f32 and rounds once, as ``jnp.mean`` does, and SFT's
``x·(1 + γ) + β`` rounds after each operation.
"""

import numpy as np
import torch
from torch import nn

from .conv import Conv, LeakyReLU, SubpelConv3x3
from .gdn import GDN

_LEAKY_RELU = LeakyReLU(0.01)  # torch's default slope, as the reference


def leaky_relu(x):
    """leaky_relu(x, 0.01) with the slope rounded to x's dtype."""
    return _LEAKY_RELU(x)


def _sigmoid(x):
    """1 / (1 + exp(−x)) in x's dtype, each step rounded to it: at bf16 the
    JAX package's jax.nn.sigmoid, which lowers to those three operations,
    each rounded to bf16; torch.sigmoid rounds once and gives other bits
    for about a third of bf16 inputs."""
    return 1 / (1 + torch.exp(-x))


class ResidualBlockWithStride(nn.Module):
    """conv3x3(s) → lrelu → conv3x3 → GDN, + 1×1 strided skip
    (layers.py:67-98)."""

    def __init__(self, in_ch: int, out_ch: int, stride: int = 2,
                 generator=None):
        super().__init__()
        g = generator
        self.conv1 = Conv(in_ch, out_ch, 3, stride, g)
        self.conv2 = Conv(out_ch, out_ch, 3, 1, g)
        self.gdn = GDN(out_ch)
        self.skip = (Conv(in_ch, out_ch, 1, stride, g)
                     if stride != 1 or in_ch != out_ch else None)

    def forward(self, x):
        out = self.gdn(self.conv2(leaky_relu(self.conv1(x))))
        return out + (x if self.skip is None else self.skip(x))


class ResidualBlockUpsample(nn.Module):
    """subpel → lrelu → conv3x3 → IGDN, + sub-pixel skip
    (layers.py:101-126)."""

    def __init__(self, in_ch: int, out_ch: int, upsample: int = 2,
                 generator=None):
        super().__init__()
        g = generator
        self.subpel_conv = SubpelConv3x3(in_ch, out_ch, upsample, g)
        self.conv = Conv(out_ch, out_ch, 3, 1, g)
        self.igdn = GDN(out_ch, inverse=True)
        self.upsample = SubpelConv3x3(in_ch, out_ch, upsample, g)

    def forward(self, x):
        out = self.igdn(self.conv(leaky_relu(self.subpel_conv(x))))
        return out + self.upsample(x)


class ResidualBlock(nn.Module):
    """conv3x3 → lrelu → conv3x3 → lrelu, + skip (layers.py:129-159)."""

    def __init__(self, in_ch: int, out_ch: int, generator=None):
        super().__init__()
        g = generator
        self.conv1 = Conv(in_ch, out_ch, 3, 1, g)
        self.conv2 = Conv(out_ch, out_ch, 3, 1, g)
        self.skip = Conv(in_ch, out_ch, 1, 1, g) if in_ch != out_ch else None

    def forward(self, x):
        out = leaky_relu(self.conv2(leaky_relu(self.conv1(x))))
        return out + (x if self.skip is None else self.skip(x))


class _ResidualUnit(nn.Module):
    """1×1 (N/2) → relu → 3×3 (N/2) → relu → 1×1 (N), + x, relu
    (layers.py:177-196)."""

    def __init__(self, n: int, generator=None):
        super().__init__()
        g = generator
        self.conv_0 = Conv(n, n // 2, 1, 1, g)
        self.conv_1 = Conv(n // 2, n // 2, 3, 1, g)
        self.conv_2 = Conv(n // 2, n, 1, 1, g)

    def forward(self, x):
        out = torch.relu(self.conv_1(torch.relu(self.conv_0(x))))
        return torch.relu(self.conv_2(out) + x)


class AttentionBlock(nn.Module):
    """Sigmoid-gated dual-branch attention (layers.py:162-213): x + a ·
    sigmoid(b), a and b three residual units each (``a_0`` … ``b_2``), b
    through a last 1×1 conv (``b_out``)."""

    def __init__(self, n: int, generator=None):
        super().__init__()
        for branch in "ab":
            for i in range(3):
                self.add_module(f"{branch}_{i}", _ResidualUnit(n, generator))
        self.b_out = Conv(n, n, 1, 1, generator)

    def forward(self, x):
        a = b = x
        for i in range(3):
            a = getattr(self, f"a_{i}")(a)
            b = getattr(self, f"b_{i}")(b)
        return x + a * _sigmoid(self.b_out(b))


# ---- the quality-map layers of the ROI family ------------------------------

_LEAKY_RELU_02 = LeakyReLU(0.2)  # SFTResblk's slope (stem_utils.py:59-62)


def _resize_weights(n_in: int, n_out: int):
    """(n_in, n_out) f32 weights of ``jax.image.resize(..., "linear")``
    along one axis: ``scale_and_translate``'s ``compute_weight_mat`` with
    the triangle kernel and ``antialias=True``, whose kernel widens by the
    downscale factor (a scaled triangle, not the box of an average pool or
    the two taps of ``F.interpolate``), each step in f32 as JAX takes it."""
    f32 = torch.float32
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=f32)
    kernel_scale = torch.maximum(inv_scale, torch.tensor(1.0, dtype=f32))
    sample = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs()
    weights = torch.clamp_min(1 - (x / kernel_scale).abs(), 0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], weights, 0)


def adaptive_avg_pool(x, out_hw):
    """NCHW adaptive average pool (layers/blocks.py:106-116 of the JAX
    package): the mean over each block where both sizes divide (torch's
    ``F.adaptive_avg_pool2d``), else JAX's antialiased linear resize
    (``_resize_weights``) along each axis whose size changes. The mean runs
    in f32 and rounds once to x's dtype. The resize contracts the axes in
    the order of JAX's einsum path, the fewer products first and rows first
    on a tie, so at bf16 its intermediate rounds where JAX's does."""
    b, c, h, w = x.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    if h % oh == 0 and w % ow == 0:
        blocks = x.float().reshape(b, c, oh, h // oh, ow, w // ow)
        return blocks.mean(dim=(3, 5)).to(x.dtype)
    steps = []
    if h != oh:
        steps.append(("bchw,hH->bcHw", _resize_weights(h, oh)))
    if w != ow:
        steps.append(("bchw,wW->bchW", _resize_weights(w, ow)))
    if len(steps) == 2 and h * ow * (w + oh) < oh * w * (h + ow):
        steps.reverse()
    for spec, weights in steps:
        x = torch.einsum(spec, x, weights.to(x.device, x.dtype))
    return x


class SFT(nn.Module):
    """Spatial feature transform conditioned on a quality map
    (stem_utils.py:24-43): the map pooled to x's size, a shared conv and
    ReLU, then per-pixel (γ, β) convs; out = x·(1 + γ) + β. ``prior_nc``
    is the map's channel count, which the JAX package infers."""

    def __init__(self, x_nc: int, prior_nc: int = 1, ks: int = 3,
                 nhidden: int = 128, generator=None):
        super().__init__()
        g = generator
        self.mlp_shared = Conv(prior_nc, nhidden, ks, 1, g)
        self.mlp_gamma = Conv(nhidden, x_nc, ks, 1, g)
        self.mlp_beta = Conv(nhidden, x_nc, ks, 1, g)

    def forward(self, x, qmap):
        actv = torch.relu(self.mlp_shared(
            adaptive_avg_pool(qmap, x.shape[2:])))
        return x * (1 + self.mlp_gamma(actv)) + self.mlp_beta(actv)


class SFTResblk(nn.Module):
    """x + conv(lrelu₀.₂(SFT(conv(lrelu₀.₂(SFT(x)))))), each SFT on the
    same map (stem_utils.py:46-63)."""

    def __init__(self, x_nc: int, prior_nc: int = 1, ks: int = 3,
                 generator=None):
        super().__init__()
        g = generator
        self.norm_0 = SFT(x_nc, prior_nc, ks, generator=g)
        self.conv_0 = Conv(x_nc, x_nc, 3, 1, g)
        self.norm_1 = SFT(x_nc, prior_nc, ks, generator=g)
        self.conv_1 = Conv(x_nc, x_nc, 3, 1, g)

    def forward(self, x, qmap):
        dx = self.conv_0(_LEAKY_RELU_02(self.norm_0(x, qmap)))
        dx = self.conv_1(_LEAKY_RELU_02(self.norm_1(dx, qmap)))
        return x + dx
