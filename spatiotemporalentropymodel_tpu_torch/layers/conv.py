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

from ..ops import kernels


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


def _k5s2(layer, cls) -> bool:
    return (isinstance(layer, cls) and layer.stride == 2
            and layer.weight.shape[-1] == 5)


class Sequential(nn.Module):
    """Chain of layers (parameter names ``layers.<i>.*``) with the JAX
    package's peepholes (layers/conv.py::Sequential there), which fire on
    bf16 inputs only, so an f32 chain runs layer by layer. In the JAX
    package's order, each under its knob (``ops/kernels.py::FUSE_*``, read
    at every call):

      1. IGDN → Deconv(k5s2) → IGDN → Deconv(k5s2, ≤ 4 outputs), g_s's last
         two stages (``FUSE_GS_PACKED``): ``igdn_deconv_wide_packed`` then
         ``igdn_deconv_tail_packed``;
      2. GDN → Conv(k5s2), g_a's stages (``FUSE_GDN_CONV``):
         ``gdn_conv_fused``;
      3. a lone IGDN → Deconv(k5s2, ≤ 32 outputs) (``FUSE_IGDN_DECONV``):
         ``igdn_deconv_fused``;
      4. a lone IGDN → Deconv(k5s2, N→N) (``FUSE_IGDN_DECONV_WIDE``, off by
         default): ``igdn_deconv_wide``.

    The gates are the widths the port's kernels take
    (``ops/kernels.py::*_supported``), not the TPU's lane and VMEM rules; on
    the CPU the wrappers run their plain versions behind the same gates. The
    fused paths read the layers' own parameters, so the parameters and
    state-dict keys are those of the plain chain.
    """

    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)

    def _pair_at(self, i, inverse: bool, cls) -> bool:
        """layers[i], layers[i + 1] are a (I)GDN and a k5 s2 ``cls``."""
        from .gdn import GDN

        if i + 1 >= len(self.layers):
            return False
        gdn, conv = self.layers[i], self.layers[i + 1]
        return (isinstance(gdn, GDN) and gdn.inverse == inverse
                and _k5s2(conv, cls))

    def _packed_pair_at(self, i, x) -> bool:
        if not (kernels.FUSE_GS_PACKED and self._pair_at(i, True, Deconv)
                and self._pair_at(i + 2, True, Deconv)):
            return False
        mid = self.layers[i + 1].weight.shape[1]
        return (kernels.igdn_deconv_wide_supported(x.shape[1], mid)
                and kernels.igdn_deconv_tail_supported(
                    mid, self.layers[i + 3].weight.shape[1]))

    def _gdn_conv_at(self, i, x) -> bool:
        return (kernels.FUSE_GDN_CONV and self._pair_at(i, False, Conv)
                and kernels.gdn_conv_supported(
                    x.shape[1], self.layers[i + 1].weight.shape[0]))

    def _igdn_deconv_at(self, i, x, knob, supported) -> bool:
        return (knob and self._pair_at(i, True, Deconv)
                and supported(x.shape[1], self.layers[i + 1].weight.shape[1]))

    def forward(self, x):
        layers, i = self.layers, 0
        fusable = x.dtype == torch.bfloat16 and x.dim() == 4
        while i < len(layers):
            if fusable and self._packed_pair_at(i, x):
                g2, d2, g3, d3 = layers[i:i + 4]
                x = kernels.igdn_deconv_wide_packed(
                    x, *g2.kernel_weights(), d2.weight, d2.bias.float())
                x = kernels.igdn_deconv_tail_packed(
                    x, *g3.kernel_weights(), d3.weight, d3.bias.float())
                i += 4
                continue
            if fusable and self._gdn_conv_at(i, x):
                fused = kernels.gdn_conv_fused
            elif fusable and self._igdn_deconv_at(
                    i, x, kernels.FUSE_IGDN_DECONV,
                    kernels.igdn_deconv_fused_supported):
                fused = kernels.igdn_deconv_fused
            elif fusable and self._igdn_deconv_at(
                    i, x, kernels.FUSE_IGDN_DECONV_WIDE,
                    kernels.igdn_deconv_wide_supported):
                fused = kernels.igdn_deconv_wide
            else:
                x = layers[i](x)
                i += 1
                continue
            gdn, conv = layers[i], layers[i + 1]
            x = fused(x, *gdn.kernel_weights(), conv.weight, conv.bias.float())
            i += 2
        return x
