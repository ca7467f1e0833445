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
from ..utils import trace


def _kaiming_normal(shape, fan_in: int, generator=None):
    """torch's kaiming_normal_ default (fan_in, gain √2), which the
    reference applies to every conv (compressai/models/priors.py:67-72)."""
    return torch.randn(shape, generator=generator) * math.sqrt(2.0 / fan_in)


def _add_bias(out, bias):
    """The bias added to the rounded conv output, in its dtype, as the JAX
    package's Conv and Deconv add it (layers/conv.py there). At bf16 a bias
    folded into the convolution's f32 sum (torch's CPU convs, cuBLAS's
    epilogue) rounds once instead of twice, and gives other bits."""
    return out + bias.to(out.dtype).view(-1, *(1,) * (out.dim() - 2))


class Conv(nn.Module):
    """2-D convolution with symmetric torch-style padding (padding=k//2).

    ``im2col`` (off by default; ``models/waseda.py`` sets it on the
    Cheng2020 transforms' 3×3 stride-1 convs) runs the conv, on f32 input
    on the card, through PyTorch's own CUDA convolution (im2col and a cuBLAS
    GEMM) in place of cuDNN's."""

    im2col = False

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
        if self.im2col and x.is_cuda and x.dtype == torch.float32:
            out = torch.ops.aten._slow_conv2d_forward(
                x, self.weight, self.weight.shape[2:], None,
                (self.stride,) * 2, (self.padding,) * 2)
        else:
            out = F.conv2d(x, self.weight, None, self.stride, self.padding)
        return _add_bias(out, self.bias)


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
        out = F.conv_transpose2d(x, self.weight, None, self.stride,
                                 self.padding, self.output_padding)
        return _add_bias(out, self.bias)


def conv(in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 2,
         generator=None) -> Conv:
    """The reference's ``conv`` (compressai/models/utils.py:112-121). The
    JAX package's factories infer ``in_ch``; torch's layers need it."""
    return Conv(in_ch, out_ch, kernel_size, stride, generator)


def deconv(in_ch: int, out_ch: int, kernel_size: int = 5, stride: int = 2,
           generator=None) -> Deconv:
    return Deconv(in_ch, out_ch, kernel_size, stride, generator)


def conv3x3(in_ch: int, out_ch: int, stride: int = 1,
            generator=None) -> Conv:
    return Conv(in_ch, out_ch, 3, stride, generator)


def conv1x1(in_ch: int, out_ch: int, stride: int = 1,
            generator=None) -> Conv:
    return Conv(in_ch, out_ch, 1, stride, generator)


class LeakyReLU(nn.Module):
    """leaky_relu with the slope rounded to the input's dtype: at bf16 the
    JAX package multiplies by bf16(0.01), the weakly typed constant of
    ``jax.nn.leaky_relu`` (layers/blocks.py there), where torch's own
    LeakyReLU multiplies by the f32 slope. The product of two bf16 values
    is exact in f32, so both round once, to the same bf16."""

    def __init__(self, negative_slope: float = 0.01):
        super().__init__()
        self.negative_slope = negative_slope
        self._slopes = {}

    def forward(self, x):
        slope = self._slopes.get(x.dtype)
        if slope is None:
            slope = float(torch.tensor(self.negative_slope, dtype=x.dtype))
            self._slopes[x.dtype] = slope
        return F.leaky_relu(x, slope)


class ReLU(nn.Module):
    """max(x, 0), a ``Sequential`` entry of its own as the JAX package's
    ``_ReLU`` is (models/priors.py there), so the layer indices of the
    parameter tree line up."""

    def forward(self, x):
        return torch.relu(x)


def pixel_shuffle(x, r: int):
    """NCHW pixel shuffle (B, C·r², H, W) → (B, C, H·r, W·r) with torch's
    channel order c·r² + dy·r + dx, the order the JAX package keeps in NHWC
    (layers/conv.py::pixel_shuffle there)."""
    return F.pixel_shuffle(x, r)


class SubpelConv3x3(nn.Module):
    """3×3 conv to features·r² channels, then pixel shuffle by r
    (compressai/layers/layers.py:55-59); its conv is the child ``conv``, as
    in the JAX package's parameter tree."""

    def __init__(self, in_ch: int, features: int, r: int = 1,
                 generator=None):
        super().__init__()
        self.r = r
        self.conv = Conv(in_ch, features * r * r, 3, 1, generator)

    def forward(self, x):
        return pixel_shuffle(self.conv(x), self.r)


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


class _F32Chain(Sequential):
    """A ``Sequential`` (the same layers and parameter names) whose f32
    chain runs each k5 s2 ``_layer`` through the hand-written kernel
    ``kernels.<_kernel>``, f32 FMA on the CUDA cores, in place of cuDNN and
    the bias add. It does so on 4-D f32 input when autograd records nothing
    (grad mode off, or neither the input nor a parameter requires grad) and
    the kernel takes the widths (``kernels.<_kernel>_supported``); bf16
    input takes the ``Sequential``'s peepholes, and anything else runs layer
    by layer as there. On the CPU the wrapper runs its plain version. Each
    such call counts ``_counter`` in a ``trace`` recording."""

    _layer = None  # Conv or Deconv
    _kernel = ""
    _counter = ""

    def _f32_route(self, x) -> bool:
        if x.dtype != torch.float32 or x.dim() != 4:
            return False
        return not torch.is_grad_enabled() or not (
            x.requires_grad or any(p.requires_grad for p in self.parameters()))

    def forward(self, x):
        if not self._f32_route(x):
            return super().forward(x)
        kernel = getattr(kernels, self._kernel)
        supported = getattr(kernels, self._kernel + "_supported")
        for layer in self.layers:
            if (_k5s2(layer, self._layer) and x.is_contiguous()
                    and layer.weight.dtype == torch.float32
                    and supported(x.shape[1], layer.bias.shape[0])):
                x = kernel(x, layer.weight, layer.bias)
                trace.count(self._counter)
            else:
                x = layer(x)
        return x


class Synthesis(_F32Chain):
    """The synthesis transform g_s: its f32 k5 s2 ``Deconv``s run through
    ``kernels.deconv_k5s2_f32`` (``_F32Chain``), counted as
    ``gs.deconv_f32``.

    Only g_s routes here: x̂ feeds nothing that is entropy-coded, so a new
    summation order is safe in g_s, and h_s and the STEM's HD, which set the
    coder's (σ, μ), keep their bits."""

    _layer, _kernel, _counter = Deconv, "deconv_k5s2_f32", "gs.deconv_f32"


class Analysis(_F32Chain):
    """The analysis transform g_a: its f32 k5 s2 ``Conv``s run through
    ``kernels.conv_k5s2_f32`` (``_F32Chain``), counted as ``ga.conv_f32``.

    Only g_a routes here: h_a and the STEM's HE, which set ẑ and the
    coder's (σ, μ), keep cuDNN's bits. A new summation order in g_a moves y
    by f32 rounding, which the coder then takes as its input."""

    _layer, _kernel, _counter = Conv, "conv_k5s2_f32", "ga.conv_f32"
