"""Convolutions with the reference's exact geometry, NCHW (cuDNN's layout).

Counterpart of spatiotemporalentropymodel_tpu/layers/conv.py:
- ``Conv``   == compressai/models/utils.py:112-121 (padding = k//2)
- ``Deconv`` == compressai/models/utils.py:124-130 (ConvTranspose2d with
  padding = k//2, output_padding = stride-1 → output exactly stride·H)

Weights use torch's own layouts: Conv (out, in, k, k), Deconv
(in, out, k, k). The JAX package stores HWIO and, for Deconv, the spatially
flipped transposed-conv weight; ``convert.py`` maps between the two.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn


def _kaiming_normal(shape, fan_in: int, generator=None):
    """torch's kaiming_normal_ default (fan_in, gain √2), which the
    reference applies to every conv (compressai/models/priors.py:67-72)."""
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in)


class Conv(nn.Module):
    """2-D convolution with symmetric torch-style padding (padding=k//2)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 5,
                 stride: int = 2, generator=None):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.padding = k // 2
        self.weight = nn.Parameter(
            _kaiming_normal((features, in_ch, k, k), k * k * in_ch, generator)
        )
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class Deconv(nn.Module):
    """Transposed conv matching ConvTranspose2d(k, s, padding=k//2,
    output_padding=s-1): output spatial size is exactly ``s * H``."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 5,
                 stride: int = 2, generator=None):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.padding = k // 2
        self.output_padding = stride - 1
        # fan_in over (k, k, in) as the JAX package's HWIO initializer counts it
        self.weight = nn.Parameter(
            _kaiming_normal((in_ch, features, k, k), k * k * in_ch, generator)
        )
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding)


class Sequential(nn.Module):
    """Plain chain of layers (parameter names ``layers.<i>.*``).

    The JAX package's Sequential fuses GDN→conv and IGDN→deconv pairs into
    Pallas kernels, but only for bf16 inputs; in f32 none of its peepholes
    fires, so the f32 port is a plain chain. The bf16 serving slice adds the
    fused kernels here: GDN→Conv(k5s2) as ``gdn_conv_fused`` and the last
    two IGDN→Deconv pairs of g_s as ``igdn_deconv_wide_packed`` +
    ``igdn_deconv_tail_packed``.
    """

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x
