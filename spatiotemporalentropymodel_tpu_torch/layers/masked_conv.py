"""PixelCNN-style masked convolution, NCHW.

Counterpart of spatiotemporalentropymodel_tpu/layers/masked_conv.py
(compressai/layers/layers.py:21-47). As in the JAX package the raw kernel is
the parameter and the mask multiplies it inside the forward (here a
non-persistent buffer, so the state dict holds the parameters only). Mask
type "A" zeroes the centre pixel and everything after it in raster order;
"B" keeps the centre.

Besides the full-plane ``forward`` there is the autoregressive codecs' entry:
the output at the centre of a causal crop, as one product of the unmasked
taps (``causal_taps``) with the kernel's rows for them (``center``). It reads
nothing the mask zeroes, so it gives the same value whatever a plane holds
at pixels not yet coded, on any device and with any matmul algorithm; a
convolution that transforms its input (Winograd, FFT) would mix those
pixels into the last bits.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def per_stream(fn, streams: int, *batches):
    """fn of the batches, applied to each of ``streams`` equal parts of
    them (dimension 0) and concatenated: each stream's result then has the
    bits it has when the stream is alone, whatever else is batched with it
    (a conv or a GEMM may choose another algorithm or sum order for another
    batch or row count)."""
    if streams == 1:
        return fn(*batches)
    return torch.cat([fn(*parts) for parts in
                      zip(*(t.chunk(streams) for t in batches))])


def make_causal_mask(kh: int, kw: int, mask_type: str = "A") -> np.ndarray:
    """(kh, kw) raster-order causal mask."""
    if mask_type not in ("A", "B"):
        raise ValueError(f'Invalid "mask_type" value "{mask_type}"')
    mask = np.ones((kh, kw), dtype=np.float32)
    mask[kh // 2, kw // 2 + (mask_type == "B"):] = 0
    mask[kh // 2 + 1:] = 0
    return mask


class MaskedConv2d(nn.Module):
    """Conv(in_ch → features, k, stride 1, padding k//2) with a causal mask."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 5,
                 mask_type: str = "A", generator=None):
        super().__init__()
        k = kernel_size
        self.padding = k // 2
        fan_in = k * k * in_ch
        self.weight = nn.Parameter(
            torch.randn((features, in_ch, k, k), generator=generator)
            * math.sqrt(2.0 / fan_in))
        self.bias = nn.Parameter(torch.zeros(features))
        mask = make_causal_mask(k, k, mask_type)
        self.register_buffer("mask", torch.from_numpy(mask), persistent=False)
        # (dh, dw) of the unmasked taps in raster order
        hh, ww = np.nonzero(mask)
        self.taps = tuple(zip(hh.tolist(), ww.tolist()))
        self.register_buffer("tap_h", torch.from_numpy(hh), persistent=False)
        self.register_buffer("tap_w", torch.from_numpy(ww), persistent=False)

    def forward(self, x):
        """The masked conv over a whole plane; the conv in x's dtype, its
        output rounded to it before the bias is added in it (masked_conv.py:
        45-51 of the JAX package)."""
        w = (self.weight * self.mask).to(x.dtype)
        out = F.conv2d(x, w, None, 1, self.padding)
        return out + self.bias.to(out.dtype)[None, :, None, None]

    def causal_taps(self, crop):
        """(N, C, k, k) crops → (N, taps·C), tap-major: the inputs the
        masked conv reads at the crop's centre."""
        taps = crop[:, :, self.tap_h, self.tap_w]  # (N, C, taps)
        return taps.transpose(1, 2).reshape(crop.shape[0], -1)

    def tap_weight(self):
        """The kernel's rows for the taps: (features, taps·C), tap-major."""
        w = self.weight[:, :, self.tap_h, self.tap_w]  # (O, C, taps)
        return w.transpose(1, 2).reshape(w.shape[0], -1)

    def center(self, taps, streams: int = 1):
        """The masked conv's output at the centre of each crop, from its
        ``causal_taps`` (N, taps·C) → (N, features), in the taps' dtype:
        the product rounded to it, then the bias added in it, as ``forward``
        does. The product runs once for each of ``streams`` equal parts of
        the rows (``per_stream``)."""
        w_t = self.tap_weight().to(taps.dtype).t()
        out = per_stream(lambda x: torch.matmul(x, w_t), streams, taps)
        return out + self.bias.to(out.dtype)
