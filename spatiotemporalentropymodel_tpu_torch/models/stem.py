"""STEM P-frame entropy model, ``without_spm`` variant, and its codec
expressions.

Counterpart of spatiotemporalentropymodel_tpu/models/stem.py
(compressai/models/spatiotemporalpriors.py) for the serving path's variant:
no spatial prior, so every symbol is coded in parallel, and the EPM fuses the
temporal and hyper priors (4M input channels).

  HE : k3s1(→256) + 2 × k5s2(→256/EB-ch) hyper-encoder over cat(y_cur, y_cond)
  HD : mirror transposed stack → 2M channels
  TPM: 3 × k5s1 (256→320→2M) temporal prior on y_cond
  EPM: 1×1 stack (in→768→576→2M) fusing the priors → (σ, μ)

Tensors are NCHW on the device. Wherever symbols leave the device they are
in the JAX package's NHWC order, so the packed buffers and the bitstreams
are the JAX package's byte for byte. At a bf16 compute dtype the nets run in
bf16 and the codec math in f32, with the JAX package's casts
(models/stem.py:254-258, 291-539 there): z goes to f32 before quantizing,
the encoder's quantizer upcasts bf16 y, σ and μ in registers (exact, as
the JAX package's casts to f32), the target and the ŷ carry are f32, and ẑ
and y_cond are cast for HE, HD, TPM and EPM. The SPM variants (wavefront AR
codec) and ``without_spm_tpm`` wait for later slices.
"""

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..entropy import EntropyBottleneck, build_indexes
from ..entropy import base as entropy_base
from ..entropy.transport import sparse_capacity
from ..layers import Conv, Deconv, Sequential
from ..ops import kernels
from .base import (
    CompressionModel, _as_bytes, _common_dtype, _nchw, _nhwc_flat, _to_nchw,
)


class STEMModule(nn.Module):
    """The without_spm variant's layers (spatiotemporalpriors.py:43-65)."""

    def __init__(self, entropy_bottleneck_channels: int = 256,
                 in_channels: int = 192, generator=None):
        super().__init__()
        m, ebc, g = in_channels, entropy_bottleneck_channels, generator
        lrelu = nn.LeakyReLU(0.01)  # torch default slope, as the reference
        self.HE = Sequential([
            Conv(2 * m, 256, 3, 1, g), lrelu, Conv(256, 256, 5, 2, g), lrelu,
            Conv(256, ebc, 5, 2, g),
        ])
        self.HD = Sequential([
            Deconv(ebc, 256, 5, 2, g), lrelu, Deconv(256, 256, 5, 2, g),
            lrelu, Conv(256, 2 * m, 3, 1, g),
        ])
        self.TPM = Sequential([
            Conv(m, 256, 5, 1, g), lrelu, Conv(256, 320, 5, 1, g), lrelu,
            Conv(320, 2 * m, 5, 1, g),
        ])
        self.EPM = Sequential([
            Conv(4 * m, 768, 1, 1, g), lrelu,
            Conv(768, 576, 1, 1, g), lrelu, Conv(576, 2 * m, 1, 1, g),
        ])
        self.entropy_bottleneck = EntropyBottleneck(ebc, generator=g)

    def hyper_encode(self, y_cur, y_conditioned):
        return self.HE(torch.cat([y_cur, y_conditioned], dim=1))

    def entropy_params(self, z_hat, y_conditioned):
        """(σ, μ) from the temporal and hyper priors."""
        feats = torch.cat([self.TPM(y_conditioned), self.HD(z_hat)], dim=1)
        scales, means = self.EPM(feats).chunk(2, dim=1)
        return scales, means


class SpatioTemporalPriorModel(CompressionModel):
    """Host wrapper with the reference's compress/decompress API plus the
    fused codec expressions the serving pipeline composes:

      compress(y_cur, y_conditioned) -> {"strings": [y, z], "shape"}
      decompress(strings, shape, y_conditioned) -> {"y_hat": ...}
    """

    has_gaussian = True
    _I16_LIM = 32767.0
    _I8_LIM = 127

    def __init__(self, entropy_bottleneck_channels: int = 256,
                 in_channels: int = 192, device="cuda", seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        super().__init__(
            STEMModule(entropy_bottleneck_channels, in_channels, gen), device
        )
        self.in_channels = in_channels

    @property
    def levels(self) -> int:
        return int(self._scale_table.numel())

    def _entropy_params(self, z_sym, y_cond_c):
        """(σ, μ) in the compute dtype from the f32 symbols of ẑ and the
        cast y_cond: the two channel-halves of EPM's output, as they are."""
        return self.module.entropy_params(self._cast(z_sym + self._medians),
                                          y_cond_c)

    def _entropy_params_f32(self, z_sym, y_cond_c):
        """(σ, μ) in f32, μ contiguous: the decoder's."""
        scales, means = self._entropy_params(z_sym, y_cond_c)
        return scales.float(), means.float().contiguous()

    def _quantize(self, y_cur, z_sym, y_cond_c):
        """(y symbols, CDF-row indexes, μ) of the encoder: y_cur, σ and μ
        straight into the quantizer, in their own dtype (all in f32 where a
        caller's y_cur is not in the compute dtype)."""
        scales, means = self._entropy_params(z_sym, y_cond_c)
        y_sym, idx = kernels.quantize_and_index(
            *_common_dtype(y_cur, means, scales), self._scale_table)
        return y_sym, idx, means

    # ---- dense transport ---------------------------------------------------

    @torch.no_grad()
    def fused_encode_expr(self, y_cur, y_cond):
        """(y_cur, y_cond) → packed u8 buffer [y int16][z int16][idx u8],
        NHWC order (stem.py:291)."""
        lim = self._I16_LIM
        y_cond_c = self._cast(y_cond)
        z = self.module.hyper_encode(self._cast(y_cur), y_cond_c)
        z_sym = torch.clamp(torch.round(z.float() - self._medians), -lim, lim)
        y_sym, idx, _ = self._quantize(y_cur, z_sym, y_cond_c)
        b = y_cur.shape[0]
        y_sym = torch.clamp(y_sym, -int(lim), int(lim)).to(torch.int16)
        return torch.cat([
            _as_bytes(_nhwc_flat(y_sym, b)),
            _as_bytes(_nhwc_flat(z_sym.to(torch.int16), b)),
            _nhwc_flat(idx, b).reshape(-1),
        ])

    @torch.no_grad()
    def fused_params_expr(self, z_sym, y_cond):
        """Decoder side: (z_sym, y_cond) → (means f32, idx u8), NCHW. ẑ gets
        the encoder's canonical layout, so the convs run the same algorithms
        and (σ, μ) match the encoder's bit for bit."""
        scales, means = self._entropy_params_f32(_nchw(z_sym),
                                                 self._cast(y_cond))
        idx = build_indexes(scales, self._scale_table)
        return means, idx.to(torch.uint8)

    @staticmethod
    def fused_reconstruct_expr(y_sym, means, y_cond):
        del y_cond  # the residual variant (flagship slice) adds it back
        return y_sym.float() + means

    # ---- sparse-grouped transport ------------------------------------------
    #
    # Symbols sorted by CDF row on device; (bitmask + compacted nonzero int8
    # values + per-row counts) cross to the host instead of dense planes.
    # Wire order: grouped-by-row over the NHWC-flattened plane.

    @torch.no_grad()
    def fused_encode_sparse_carry_expr(self, y_cur, y_cond):
        """(y_cur, y_cond) → (packed u8 transport buffer, decoder-consistent ŷ).

        Buffer layout per batch (b elements, n = h·w·M symbols and
        zn = zh·zw·zc each, L scale levels, C = sparse_capacity(n)):
          [y bitmask b·n/8 u8][y values b·C i8][counts b·L i32]
          [z_sym b·zn i8][meta b·2 i32: (nonzero count, overflow flag)]

        This covers stem.py:361 (the buffer) and :441 (the carry). One
        entropy-parameter pass serves both outputs. It runs on ẑ clipped
        at the dense int16 band, as the JAX package's carry does
        (stem.py:441); the buffer's ẑ is clipped at int8, which differs only
        when z overflows int8, and then the overflow flag sends the frame to
        the dense transport, whose decoder sees the int16-band ẑ. So the
        carry equals the decoder's ŷ on either transport.
        """
        lim16, lim8 = self._I16_LIM, self._I8_LIM
        b = y_cur.shape[0]
        y_cond_c = self._cast(y_cond)
        z = self.module.hyper_encode(self._cast(y_cur), y_cond_c)
        z_sym = torch.clamp(torch.round(z.float() - self._medians), -lim16,
                            lim16)
        z_over = (z_sym.abs() > lim8).any()
        y_sym, idx, means = self._quantize(y_cur, z_sym, y_cond_c)
        # f32 + μ in the compute dtype adds in f32: the decoder's ŷ exactly
        y_hat = torch.clamp(y_sym, -int(lim16), int(lim16)).float() + means

        y_flat = _nhwc_flat(y_sym, b)
        idx_flat = _nhwc_flat(idx, b).long()
        n = y_flat.shape[1]
        cap = sparse_capacity(n)
        levels = self.levels
        y_over = (y_flat.abs() > lim8).any(dim=1)

        order = torch.argsort(idx_flat, dim=1, stable=True)
        y_sorted = torch.gather(y_flat, 1, order)
        y_sorted = torch.clamp(y_sorted, -lim8, lim8).to(torch.int8)
        mask = y_sorted != 0
        nz = mask.sum(dim=1, dtype=torch.int32)
        pos = torch.cumsum(mask, dim=1, dtype=torch.int32) - 1
        pos = torch.where(mask & (pos < cap), pos, cap).long()  # → dump slot
        values = torch.zeros((b, cap + 1), dtype=torch.int8,
                             device=y_cur.device)
        values = values.scatter_(1, pos, y_sorted)[:, :cap]
        counts = torch.zeros((b, levels), dtype=torch.int32,
                             device=y_cur.device)
        counts.scatter_add_(1, idx_flat, torch.ones_like(idx_flat,
                                                         dtype=torch.int32))
        weights = (1 << torch.arange(8, device=y_cur.device)).to(torch.int32)
        maskbits = (mask.view(b, n // 8, 8).to(torch.int32) * weights).sum(
            dim=-1).to(torch.uint8)
        overflow = (y_over | (nz > cap) | z_over).to(torch.int32)
        meta = torch.stack([nz, overflow], dim=-1)
        z8 = _nhwc_flat(torch.clamp(z_sym, -lim8, lim8).to(torch.int8), b)
        packed = torch.cat([
            maskbits.reshape(-1), _as_bytes(values), _as_bytes(counts),
            _as_bytes(z8), _as_bytes(meta),
        ])
        return packed, y_hat

    @torch.no_grad()
    def fused_params_sparse_expr(self, z_sym, y_cond):
        """Decoder side: (z_sym, y_cond) → (order, means), both staying on
        the device. The JAX package also returns the row counts for
        containers without them; the port's containers always carry them."""
        means, idx = self.fused_params_expr(z_sym, y_cond)
        idx_flat = _nhwc_flat(idx, idx.shape[0]).long()
        return torch.argsort(idx_flat, dim=1, stable=True), means

    @staticmethod
    @torch.no_grad()
    def fused_reconstruct_sparse_expr(maskbits, values, order, means,
                                      y_cond):
        """(bitmask u8, compacted values i8, order, means NCHW) → ŷ NCHW.

        Unpack bits → gather the compacted values through the mask's prefix
        sum → scatter back to spatial (NHWC-flat) order through ``order``."""
        del y_cond  # the residual variant (flagship slice) adds it back
        b, m, h, w = means.shape
        n = m * h * w
        cap = values.shape[1]
        shifts = torch.arange(8, device=maskbits.device, dtype=torch.uint8)
        mask = ((maskbits.view(b, n // 8, 1) >> shifts) & 1).view(b, n) != 0
        cums = torch.cumsum(mask, dim=1)
        gathered = torch.gather(values, 1, torch.clamp(cums - 1, 0, cap - 1))
        y_sorted = torch.where(mask, gathered, torch.zeros_like(gathered))
        y_flat = torch.zeros((b, n), dtype=torch.int32, device=means.device)
        y_flat.scatter_(1, order, y_sorted.to(torch.int32))
        # canonical NCHW, like the encoder's ŷ, which is the next frame's TPM
        # input and g_s's (see _nchw)
        return _nchw(y_flat.view(b, h, w, m).permute(0, 3, 1, 2)) + means

    # ---- model API (dense order, the reference's CHW streams) --------------

    def _zshape(self, hgt, wid):
        return -(-hgt // 4), -(-wid // 4)  # k5s2 convs ceil-divide

    def compress(self, y_cur, y_conditioned) -> Dict[str, Any]:
        self._require_tables()
        b, m, hgt, wid = y_cur.shape
        zh, zw = self._zshape(hgt, wid)
        zt = self.tables["entropy_bottleneck"]
        zc = zt.rows
        packed = self.fused_encode_expr(y_cur, y_conditioned).cpu().numpy()
        y_sym, z_sym, idx = entropy_base.unpack_symbol_buffer(
            packed, (b, hgt, wid, m), (b, zh, zw, zc))
        z_idx = entropy_base.bottleneck_indexes(z_sym.shape, zc)
        z_strings = entropy_base.compress(z_sym.astype(np.int32), z_idx, zt,
                                          self.coder)
        y_strings = entropy_base.compress(
            y_sym.astype(np.int32), idx, self.tables["gaussian_conditional"],
            self.coder,
        )
        return {"strings": [y_strings, z_strings], "shape": (zh, zw)}

    @torch.no_grad()
    def decompress(self, strings, shape, y_conditioned) -> Dict[str, Any]:
        if not (isinstance(strings, list) and len(strings) == 2):
            raise ValueError("strings must be [y_strings, z_strings]")
        self._require_tables()
        zt = self.tables["entropy_bottleneck"]
        z_idx = entropy_base.bottleneck_indexes(
            (len(strings[1]), *shape, zt.rows), zt.rows)
        z_sym = entropy_base.decompress(strings[1], z_idx, zt, self.coder)
        means, idx = self.fused_params_expr(
            _to_nchw(z_sym, self.device), y_conditioned)
        idx_np = idx.permute(0, 2, 3, 1).cpu().numpy().astype(np.int32)
        y_sym = entropy_base.decompress(
            strings[0], idx_np, self.tables["gaussian_conditional"],
            self.coder,
        )
        y_hat = self.fused_reconstruct_expr(
            _to_nchw(y_sym, self.device), means, y_conditioned)
        return {"y_hat": y_hat}
