"""MeanScaleHyperprior (mbt2018-mean), the I-frame model of the video codec.

Counterpart of spatiotemporalentropymodel_tpu/models/priors.py::
MeanScaleHyperprior (compressai/models/priors.py:316-402), NCHW. Every layer
is here so the whole parameter tree carries across from the JAX package
(convert.py). The P-frame pipeline calls ``analysis`` (g_a) and ``get_x``
(g_s + clamp), which cast their input to the compute dtype as the JAX
package's ``_apply`` does. ``compress``/``decompress`` are the I-frame codec
of the JAX package's ``_HyperpriorCodecBase`` (priors.py:354-487 there), with
its stream format and its dispatches: one device expression per compress
(``fused_encode_expr``), two per decompress (``fused_params_expr``,
``fused_finish_expr``), host rANS between them. At a bf16 compute dtype the
nets run in bf16 and the codec math in f32, as in the P-frame path.
"""

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..entropy import EntropyBottleneck, GaussianConditional, build_indexes
from ..entropy import base as entropy_base
from ..layers import GDN, Conv, Deconv, Sequential
from ..ops import kernels
from .base import CompressionModel, _as_bytes, _nchw, _nhwc_flat, _to_nchw


class MeanScaleHyperpriorModule(nn.Module):
    """priors.py:316-402 — h_s outputs (σ, μ); getY/getX STEM hooks."""

    def __init__(self, N: int, M: int, generator=None):
        super().__init__()
        n, m, g = N, M, generator
        self.g_a = Sequential([
            Conv(3, n, 5, 2, g), GDN(n), Conv(n, n, 5, 2, g), GDN(n),
            Conv(n, n, 5, 2, g), GDN(n), Conv(n, m, 5, 2, g),
        ])
        self.g_s = Sequential([
            Deconv(m, n, 5, 2, g), GDN(n, inverse=True),
            Deconv(n, n, 5, 2, g), GDN(n, inverse=True),
            Deconv(n, n, 5, 2, g), GDN(n, inverse=True),
            Deconv(n, 3, 5, 2, g),
        ])
        self.h_a = Sequential([
            Conv(m, n, 3, 1, g), nn.LeakyReLU(0.01), Conv(n, n, 5, 2, g),
            nn.LeakyReLU(0.01), Conv(n, n, 5, 2, g),
        ])
        self.h_s = Sequential([
            Deconv(n, m, 5, 2, g), nn.LeakyReLU(0.01),
            Deconv(m, m * 3 // 2, 5, 2, g), nn.LeakyReLU(0.01),
            Conv(m * 3 // 2, m * 2, 3, 1, g),
        ])
        self.entropy_bottleneck = EntropyBottleneck(n, generator=g)
        self.gaussian_conditional = GaussianConditional()

    def get_x(self, y_hat):
        """getX hook (priors.py:397-402): synthesize and clamp to [0, 1]."""
        return torch.clamp(self.g_s(y_hat), 0.0, 1.0)


class MeanScaleHyperprior(CompressionModel):
    """priors.py:316-402. Weights are drawn from ``seed`` with an explicit
    CPU generator, then moved to ``device``."""

    has_gaussian = True
    _I16_LIM = 32767.0

    def __init__(self, N: int, M: int, device="cuda", seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        super().__init__(MeanScaleHyperpriorModule(N, M, gen), device)
        self.N, self.M = N, M

    @torch.no_grad()
    def analysis(self, x):
        """g_a only. The JAX package's ``analysis`` also runs h_a, which its
        pipeline drops unused; eager PyTorch would run it."""
        return self.module.g_a(self._cast_in(x))

    @torch.no_grad()
    def get_x(self, y_hat):
        return self.module.get_x(self._cast_in(y_hat))

    # ---- the I-frame codec (priors.py:354-487 of the JAX package) ---------

    def _params_f32(self, z_sym):
        """(σ, μ) in f32 from the f32 symbols of ẑ. ẑ = z_sym + medians goes
        to h_s in the compute dtype with the canonical NCHW strides, on
        encoder and decoder alike, so both get the same (σ, μ) bit for bit
        (see ``models/base.py::_nchw``)."""
        z_hat = _nchw(z_sym + self._medians,
                      self.compute_dtype or torch.float32)
        scales, means = self.module.h_s(z_hat).chunk(2, dim=1)
        return scales.float().contiguous(), means.float().contiguous()

    @torch.no_grad()
    def fused_encode_expr(self, x):
        """x (B, 3, H, W) → (packed u8 buffer [y int16][z int16][idx u8] in
        NHWC order, the ŷ the decoder rebuilds, f32 NCHW), one device
        dispatch (priors.py:372-403): g_a and h_a, ẑ's symbols, h_s on ẑ,
        then the f32 island ``quantize_and_index`` on (y, μ, σ)."""
        lim = self._I16_LIM
        y = self.module.g_a(self._cast_in(x))
        z = self.module.h_a(y)
        z_sym = torch.clamp(torch.round(z.float() - self._medians), -lim, lim)
        scales, means = self._params_f32(z_sym)
        y_sym, idx = kernels.quantize_and_index(
            y.float().contiguous(), means, scales, self._scale_table)
        y_sym = torch.clamp(y_sym, -int(lim), int(lim))
        b = x.shape[0]
        packed = torch.cat([
            _as_bytes(_nhwc_flat(y_sym.to(torch.int16), b)),
            _as_bytes(_nhwc_flat(z_sym.to(torch.int16), b)),
            _nhwc_flat(idx, b).reshape(-1),
        ])
        return packed, y_sym.float() + means

    @torch.no_grad()
    def fused_params_expr(self, z_sym):
        """Decoder side (priors.py:405-422): int ẑ symbols NCHW → (μ f32,
        CDF-row indexes u8), both NCHW."""
        scales, means = self._params_f32(z_sym.float())
        return means, build_indexes(scales, self._scale_table).to(torch.uint8)

    @torch.no_grad()
    def fused_finish_expr(self, y_sym, means):
        """(int ŷ symbols, μ) → (ŷ f32, x̂ = clamp(g_s(ŷ), 0, 1)) in the
        compute dtype (priors.py:424-430)."""
        y_hat = y_sym.float() + means
        return y_hat, self.get_x(y_hat)

    def compress(self, x) -> Dict[str, Any]:
        """x (B, 3, H, W) in [0, 1] → {"strings": [y_strings, z_strings],
        "shape": (z_h, z_w)}, the JAX package's stream format. The latent
        sizes are ceil-divided, as the k5 s2 convs make them."""
        self._require_tables()
        b, _, h, w = x.shape
        zt = self.tables["entropy_bottleneck"]
        y_shape = (b, -(-h // 16), -(-w // 16), self.M)
        z_shape = (b, -(-h // 64), -(-w // 64), zt.rows)
        packed, _ = self.fused_encode_expr(x)
        y_sym, z_sym, idx = entropy_base.unpack_symbol_buffer(
            packed.cpu().numpy(), y_shape, z_shape)
        z_strings = entropy_base.compress(
            z_sym.astype(np.int32),
            entropy_base.bottleneck_indexes(z_shape, zt.rows), zt, self.coder)
        y_strings = entropy_base.compress(
            y_sym.astype(np.int32), idx, self.tables["gaussian_conditional"],
            self.coder)
        return {"strings": [y_strings, z_strings], "shape": tuple(z_shape[1:3])}

    def decompress(self, strings, shape) -> Dict[str, Any]:
        """{"x_hat": clamp(g_s(ŷ), 0, 1), "y_hat": ŷ f32}, both NCHW on the
        model's device."""
        if not (isinstance(strings, list) and len(strings) == 2):
            raise ValueError("strings must be [y_strings, z_strings]")
        self._require_tables()
        zt = self.tables["entropy_bottleneck"]
        z_idx = entropy_base.bottleneck_indexes(
            (len(strings[1]), *shape, zt.rows), zt.rows)
        z_sym = entropy_base.decompress(strings[1], z_idx, zt, self.coder)
        means, idx = self.fused_params_expr(_to_nchw(z_sym, self.device))
        y_sym = entropy_base.decompress(
            strings[0], idx.permute(0, 2, 3, 1).cpu().numpy().astype(np.int32),
            self.tables["gaussian_conditional"], self.coder)
        y_hat, x_hat = self.fused_finish_expr(_to_nchw(y_sym, self.device),
                                              means)
        return {"x_hat": x_hat, "y_hat": y_hat}
