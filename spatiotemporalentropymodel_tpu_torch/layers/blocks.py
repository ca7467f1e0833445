"""Cheng2020's residual and attention blocks, NCHW.

Counterpart of spatiotemporalentropymodel_tpu/layers/blocks.py
(compressai/layers/layers.py:67-213). The submodules carry the JAX
package's names (``conv1``, ``gdn``, ``skip``, ``subpel_conv``, ``a_0`` …),
so the parameter trees map one to one (convert.py). Each GDN and IGDN is the
port's ``GDN`` layer, so it runs the ``gdn_fused`` kernel in f32 and bf16.
In bf16 every step rounds where the JAX package's does: each conv's bias
goes on after its rounded sum (``Conv``), the LeakyReLU slope is bf16, the
sigmoid rounds after each of its three operations (``_sigmoid``), and the
gate's product and the residual sums round to bf16 each.
The quality-map SFT layers wait for the ROI family (models/stem_roi.py).
"""

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
