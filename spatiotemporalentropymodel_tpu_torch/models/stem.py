"""STEM — the Spatio-Temporal Entropy Model P-frame family, all five
variants, and their codecs.

Counterpart of spatiotemporalentropymodel_tpu/models/stem.py
(compressai/models/spatiotemporalpriors.py): one parameterized module for

  variant                    priors fused in EPM        EPM input  codec path
  ---------------------------------------------------------------------------
  without_spm_tpm            hyper                      2M         parallel
  without_spm                TPM + hyper                4M         parallel
  without_tpm                SPM + hyper                4M         AR
  full                       TPM + hyper + SPM          6M         AR
  res (flagship)             TPM + hyper + SPM on the   6M         AR
                             residual y_cur − y_cond

  HE : k3s1(→256) + 2 × k5s2(→256/EB-ch) hyper-encoder over cat(y_cur, y_cond)
  HD : mirror transposed stack → 2M channels
  TPM: 3 × k5s1 (256→320→2M) temporal prior on y_cond
  SPM: MaskedConv2d(M→2M, k5) spatial context
  EPM: 1×1 stack (in→768→576→2M) fusing [TPM, HD, ctx] → (σ, μ)

Tensors are NCHW on the device. Wherever symbols leave the device they are
in the JAX package's order, so the bitstreams are the JAX package's byte for
byte. The parallel variants code every symbol at once (the fused codec
expressions below); the SPM variants code autoregressively, by wavefront
rounds (``ar_mode="wavefront"``, optionally tiled) or pixel by pixel in
raster order (``"serial"``, the reference's order), with ẑ coded on the host
and host rANS per round (models/ar_wavefront.py).

At a bf16 compute dtype the nets run in bf16 and the codec math in f32, with
the JAX package's casts (models/stem.py:254-258, 291-778 there): the
parallel encoder quantizes bf16 (y, σ, μ) upcast exactly; on the AR path the
priors, the context taps and EPM are bf16, the masked conv's centre is
rounded to bf16 before its bias is added, σ meets the scale table cast to
bf16, and the symbols, the context plane and the ŷ carry are f32.
"""

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..entropy import EntropyBottleneck, GaussianConditional, build_indexes
from ..entropy import base as entropy_base
from ..entropy.transport import sparse_capacity
from ..layers import Conv, Deconv, LeakyReLU, MaskedConv2d, Sequential
from ..layers.masked_conv import per_stream
from ..ops import kernels
from ..ops.quantize import quantize_dequantize, quantize_noise
from ..utils import trace
from . import ar_wavefront as wf
from .base import (
    CompressionModel, _as_bytes, _common_dtype, _nchw, _nhwc_flat,
    _pack_sparse, _to_nchw, _unpack_sparse,
)

STEM_VARIANTS = ("without_spm_tpm", "without_spm", "without_tpm", "full",
                 "res")


class STEMModule(nn.Module):
    """One parameterized module covering the five reference variants
    (spatiotemporalpriors.py:43-65, 142-171, 523-556)."""

    def __init__(self, variant: str = "res",
                 entropy_bottleneck_channels: int = 256,
                 in_channels: int = 192, generator=None):
        super().__init__()
        if variant not in STEM_VARIANTS:
            raise ValueError(f"unknown STEM variant: {variant!r}")
        self.variant = variant
        self.entropy_bottleneck_channels = entropy_bottleneck_channels
        m, ebc, g = in_channels, entropy_bottleneck_channels, generator
        lrelu = LeakyReLU(0.01)  # torch default slope, as the reference
        self.HE = Sequential([
            Conv(2 * m, 256, 3, 1, g), lrelu, Conv(256, 256, 5, 2, g), lrelu,
            Conv(256, ebc, 5, 2, g),
        ])
        self.HD = Sequential([
            Deconv(ebc, 256, 5, 2, g), lrelu, Deconv(256, 256, 5, 2, g),
            lrelu, Conv(256, 2 * m, 3, 1, g),
        ])
        if self.use_tpm:
            self.TPM = Sequential([
                Conv(m, 256, 5, 1, g), lrelu, Conv(256, 320, 5, 1, g), lrelu,
                Conv(320, 2 * m, 5, 1, g),
            ])
        if self.use_spm:
            self.context_prediction = MaskedConv2d(m, 2 * m, 5, "A", g)
        n_priors = 1 + int(self.use_tpm) + int(self.use_spm)
        self.EPM = Sequential([
            Conv(2 * m * n_priors, 768, 1, 1, g), lrelu,
            Conv(768, 576, 1, 1, g), lrelu, Conv(576, 2 * m, 1, 1, g),
        ])
        self.entropy_bottleneck = EntropyBottleneck(ebc, generator=g)
        self.gaussian_conditional = GaussianConditional()

    @property
    def use_tpm(self) -> bool:
        return self.variant in ("without_spm", "full", "res")

    @property
    def use_spm(self) -> bool:
        return self.variant in ("without_tpm", "full", "res")

    @property
    def residual(self) -> bool:
        return self.variant == "res"

    def forward(self, y_cur, y_conditioned, train: bool = False,
                generator=None):
        """Forward with rate estimation (stem.py:122-156 of the JAX
        package): {"y_hat", "likelihoods": {"y", "z"}}. The SPM variants'
        context sees the quantized target and the Gaussian conditional
        quantizes the target again (the reference's double quantization,
        spatiotemporalpriors.py:570-579): in eval mode both round, in train
        mode they are two separate noise draws from ``generator``."""
        z = self.hyper_encode(y_cur, y_conditioned)
        z_hat, z_likelihoods = self.entropy_bottleneck(z, train, generator)
        feats = self.prior_feats(z_hat, y_conditioned)
        target = y_cur - y_conditioned if self.residual else y_cur
        if self.use_spm:
            target_hat = (quantize_noise(target, generator) if train
                          else quantize_dequantize(target))
            feats = torch.cat([feats, self.context_prediction(target_hat)],
                              dim=1)
            scales_hat, means_hat = self.EPM(feats).chunk(2, dim=1)
            _, y_likelihoods = self.gaussian_conditional(
                target, scales_hat, means_hat, train=train,
                generator=generator)
        else:
            scales_hat, means_hat = self.EPM(feats).chunk(2, dim=1)
            target_hat, y_likelihoods = self.gaussian_conditional(
                target, scales_hat, means_hat, train=train,
                generator=generator)
        y_hat = target_hat + y_conditioned if self.residual else target_hat
        return {"y_hat": y_hat,
                "likelihoods": {"y": y_likelihoods, "z": z_likelihoods}}

    def hyper_encode(self, y_cur, y_conditioned):
        return self.HE(torch.cat([y_cur, y_conditioned], dim=1))

    def prior_feats(self, z_hat, y_conditioned):
        """The hyper (+ temporal) priors, cat([TPM(y_cond), HD(ẑ)]):
        (B, 2M·k, H, W)."""
        feats = [self.HD(z_hat)]
        if self.use_tpm:
            feats.insert(0, self.TPM(y_conditioned))
        return torch.cat(feats, dim=1)

    def entropy_params(self, z_hat, y_conditioned):
        """Parallel-variant (σ, μ) from the priors."""
        scales, means = self.EPM(self.prior_feats(z_hat, y_conditioned)).chunk(
            2, dim=1)
        return scales, means

    def ar_step(self, taps, prior_vec, streams: int = 1):
        """One AR pixel per row: the masked 5×5 context at the crop centre
        from its causal taps (N, 12·M) (``MaskedConv2d.causal_taps``), then
        the 1×1 EPM on cat([prior row (N, P), ctx]) → (σ, μ), each (N, M).
        The same function as the JAX package's ar_step on the whole crop.
        The rows are ``streams`` equal parts, one per stream, and each
        product runs once per part (``per_stream``)."""
        ctx = self.context_prediction.center(taps, streams)
        gp = wf.conv1x1_rows(self.EPM, torch.cat([prior_vec, ctx], dim=1),
                             streams)
        scales, means = gp.chunk(2, dim=1)
        return scales, means


class HyperAnalysis:
    """The encoder's hyper-analysis (HE) on whole tensors of ``model``'s
    device: ``hyper_encode`` on inputs already in the compute dtype
    (``cast``), and ``whole``, the identity here. eval/pipeline.py's W-split
    HE has the same methods, on tensors split over a mesh. Only the encoder
    runs HE (the decoder reads ẑ from the stream), so how it is computed
    moves no decoder's (σ, μ)."""

    def __init__(self, model):
        self.model = model

    def cast(self, t):
        return self.model._cast(t)

    def hyper_encode(self, y_cur_c, y_cond_c):
        return self.model.module.hyper_encode(y_cur_c, y_cond_c)

    def whole(self, t):
        return t


class SpatioTemporalPriorModel(wf.ARCodec, CompressionModel):
    """Host wrapper with the reference's compress/decompress API:

      compress(y_cur, y_conditioned) -> {"strings": [y, z], "shape"}
      decompress(strings, shape, y_conditioned) -> {"y_hat": ...}

    plus, for the parallel variants, the fused codec expressions the serving
    pipeline composes.

    ar_mode (SPM variants only): "wavefront" — anti-diagonal rounds, one
    host rANS call per round and stream (the fast format); "serial" — the
    reference's raster order, one pixel per round.

    wavefront_tile: optional (th, tw). Tiles the latent into th×tw blocks
    whose SPM context resets at tile borders; every tile advances in the
    same round, so decode needs 3(th−1)+tw rounds instead of 3(H−1)+W.
    Hyper/temporal priors stay global. Latent dims must be divisible by the
    tile.
    """

    has_gaussian = True
    _I16_LIM = 32767.0
    _I8_LIM = 127

    def __init__(self, variant: str = "res",
                 entropy_bottleneck_channels: int = 256,
                 in_channels: int = 192, ar_mode: str = "wavefront",
                 wavefront_tile=None, device="cuda", seed: int = 0):
        if ar_mode not in ("wavefront", "serial"):
            raise ValueError(f"unknown ar_mode {ar_mode!r}")
        gen = torch.Generator().manual_seed(seed)
        super().__init__(
            STEMModule(variant, entropy_bottleneck_channels, in_channels,
                       gen), device
        )
        self.variant = variant
        self.in_channels = in_channels
        self.ar_mode = ar_mode
        self.wavefront_tile = (
            tuple(int(v) for v in wavefront_tile) if wavefront_tile else None
        )
        # the AR legs' rounds, wire order and stage clock: wf.ARCodec
        self._rounds_cache = {}

    @property
    def use_spm(self) -> bool:
        return self.module.use_spm

    @property
    def residual(self) -> bool:
        return self.module.residual

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

    @property
    def hyper_analysis(self):
        """The encoder's HE on whole tensors (``HyperAnalysis``); the encode
        expressions take another with the same methods as ``he=``
        (eval/pipeline.py's W-split one)."""
        return HyperAnalysis(self)

    # ---- dense transport ---------------------------------------------------

    @torch.no_grad()
    def fused_encode_expr(self, y_cur, y_cond, he=None):
        """(y_cur, y_cond) → packed u8 buffer [y int16][z int16][idx u8],
        NHWC order (stem.py:291)."""
        lim = self._I16_LIM
        he = he or self.hyper_analysis
        y_cond_c = he.cast(y_cond)
        z = he.hyper_encode(he.cast(y_cur), y_cond_c)
        z_sym = torch.clamp(torch.round(z.float() - self._medians), -lim, lim)
        y_sym, idx, _ = self._quantize(he.whole(y_cur), z_sym,
                                       he.whole(y_cond_c))
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

    def fused_reconstruct_expr(self, y_sym, means, y_cond):
        target_hat = y_sym.float() + means
        return target_hat + y_cond if self.residual else target_hat

    # ---- sparse-grouped transport ------------------------------------------
    #
    # Symbols sorted by CDF row on device; (bitmask + compacted nonzero int8
    # values + per-row counts) cross to the host instead of dense planes.
    # Wire order: grouped-by-row over the NHWC-flattened plane.

    @torch.no_grad()
    def fused_encode_sparse_carry_expr(self, y_cur, y_cond, he=None):
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
        he = he or self.hyper_analysis
        y_cond_c = he.cast(y_cond)
        z = he.hyper_encode(he.cast(y_cur), y_cond_c)
        z_sym = torch.clamp(torch.round(z.float() - self._medians), -lim16,
                            lim16)
        z_over = (z_sym.abs() > lim8).any()
        y_sym, idx, means = self._quantize(he.whole(y_cur), z_sym,
                                           he.whole(y_cond_c))
        # f32 + μ in the compute dtype adds in f32: the decoder's ŷ exactly
        y_hat = torch.clamp(y_sym, -int(lim16), int(lim16)).float() + means
        y_flat = _nhwc_flat(y_sym, b)
        z8 = _nhwc_flat(torch.clamp(z_sym, -lim8, lim8).to(torch.int8), b)
        packed = _pack_sparse(y_flat, _nhwc_flat(idx, b).long(), self.levels,
                              sparse_capacity(y_flat.shape[1]), z8, z_over)
        return packed, y_hat

    @torch.no_grad()
    def fused_params_sparse_expr(self, z_sym, y_cond):
        """Decoder side: (z_sym, y_cond) → (order, means), both staying on
        the device. The JAX package also returns the row counts for
        containers without them; the port's containers always carry them."""
        means, idx = self.fused_params_expr(z_sym, y_cond)
        idx_flat = _nhwc_flat(idx, idx.shape[0]).long()
        return torch.argsort(idx_flat, dim=1, stable=True), means

    @torch.no_grad()
    def fused_reconstruct_sparse_expr(self, maskbits, values, order, means,
                                      y_cond):
        """(bitmask u8, compacted values i8, order, means NCHW) → ŷ NCHW.

        Unpack bits → gather the compacted values through the mask's prefix
        sum → scatter back to spatial (NHWC-flat) order through ``order``."""
        b, m, h, w = means.shape
        y_flat = _unpack_sparse(maskbits, values, order, b, m * h * w)
        # canonical NCHW, like the encoder's ŷ, which is the next frame's TPM
        # input and g_s's (see _nchw)
        target_hat = _nchw(y_flat.view(b, h, w, m).permute(0, 3, 1, 2)) + means
        return target_hat + y_cond if self.residual else target_hat

    # ---- model API (dense order, the reference's CHW streams) --------------

    def _zshape(self, hgt, wid):
        return -(-hgt // 4), -(-wid // 4)  # k5s2 convs ceil-divide

    def compress(self, y_cur, y_conditioned) -> Dict[str, Any]:
        self._require_tables()
        if self.use_spm:
            z_strings, z_hat = self._code_z(y_cur, y_conditioned)
            return self._compress_wavefront(y_cur, y_conditioned, z_hat,
                                            z_strings)
        b, m, hgt, wid = y_cur.shape
        zh, zw = self._zshape(hgt, wid)
        zt = self.tables["entropy_bottleneck"]
        zc = zt.rows
        packed = trace.fetch(self.fused_encode_expr(y_cur, y_conditioned))
        y_sym, z_sym, idx = entropy_base.unpack_symbol_buffer(
            packed, (b, hgt, wid, m), (b, zh, zw, zc))
        z_idx = entropy_base.bottleneck_indexes(z_sym.shape, zc)
        z_strings = entropy_base.compress(z_sym.astype(np.int32), z_idx, zt,
                                          self.coder, stream="z")
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
        if self.use_spm:
            with self._lap("stem.hyper", "hyper_s"):
                z_hat = self._upload(self._eb_decompress(strings[1], shape))
            return self._decompress_wavefront(strings, z_hat, y_conditioned)
        zt = self.tables["entropy_bottleneck"]
        z_idx = entropy_base.bottleneck_indexes(
            (len(strings[1]), *shape, zt.rows), zt.rows)
        z_sym = entropy_base.decompress(strings[1], z_idx, zt, self.coder,
                                        stream="z")
        means, idx = self.fused_params_expr(
            _to_nchw(z_sym, self.device), y_conditioned)
        idx_np = trace.fetch(idx.permute(0, 2, 3, 1)).astype(np.int32)
        y_sym = entropy_base.decompress(
            strings[0], idx_np, self.tables["gaussian_conditional"],
            self.coder,
        )
        y_hat = self.fused_reconstruct_expr(
            _to_nchw(y_sym, self.device), means, y_conditioned)
        return {"y_hat": y_hat}

    # ---- AR codec paths (SPM variants) -------------------------------------
    #
    # ẑ is coded on the host (entropy-bottleneck NumPy helpers) and uploaded
    # with the canonical NCHW strides on both sides, so TPM and HD run the
    # same cuDNN algorithms and the priors agree bit for bit. HE, TPM, HD
    # and each round's products run once per stream, so a stream batched
    # with others gets the (σ, μ), streams and ŷ it gets alone. The AR
    # planes are NHWC tile batches (models/ar_wavefront.py). The serial mode
    # (the reference's raster order, spatiotemporalpriors.py:633-768) runs the
    # same round steps on a schedule of one pixel per round, untiled and in
    # the lane format; the JAX package's serial path differs only in not
    # saturating symbols at int16.

    @torch.no_grad()
    def _code_z(self, y_cur, y_conditioned):
        """HE, then ẑ's strings and the encoder's ẑ (the decoder's, by
        construction) on the device."""
        with self._lap("stem.hyper", "hyper_s"):
            z = per_stream(self.module.hyper_encode, y_cur.shape[0],
                           self._cast(y_cur), self._cast(y_conditioned))
            z_np = trace.fetch(z.float().permute(0, 2, 3, 1))
            z_strings = self._eb_compress(z_np)
            z_hat = self._upload(self._eb_quantize(z_np))
        return z_strings, z_hat

    def _tile_dims(self, hgt: int, wid: int):
        """(th, tw, nt) for the configured wavefront tiling (nt=1 untiled)."""
        if not self.wavefront_tile:
            return hgt, wid, 1
        th, tw = self.wavefront_tile
        # every round must be non-empty: round t covers coords with
        # 3r + c == t, c < tw. For th > 1 that needs tw >= 3 (else e.g.
        # (2, 2) leaves t = 2 empty); single-row tiles have t = c, so every
        # tw >= 1 works
        if th < 1 or tw < 1 or (th > 1 and tw < 3):
            raise ValueError(
                f"wavefront_tile needs th >= 1 and (tw >= 3 or th == 1), "
                f"got ({th}, {tw})"
            )
        if hgt % th or wid % tw:
            raise ValueError(
                f"latent {hgt}x{wid} not divisible by wavefront_tile "
                f"({th}, {tw})"
            )
        return th, tw, (hgt // th) * (wid // tw)

    def _ar_dims(self, hgt: int, wid: int):
        """(th, tw, nt, serial) of the configured AR mode."""
        if self.ar_mode == "serial":
            return hgt, wid, 1, True
        return (*self._tile_dims(hgt, wid), False)

    def _tiled_priors(self, z_hat, y_conditioned, th, tw, nt):
        """prior_feats as the NHWC tile batch (B·nt, th, tw, P), the nets
        run once per stream."""
        with self._lap("stem.priors", "priors_s"):
            priors = per_stream(self.module.prior_feats, z_hat.shape[0],
                                self._cast(z_hat),
                                self._cast(y_conditioned)).permute(0, 2, 3, 1)
            if nt > 1:
                priors = wf.tile_plane(priors, th, tw)
        return priors

    @torch.no_grad()
    def _compress_wavefront(self, y_cur, y_conditioned, z_hat, z_strings):
        b, m, hgt, wid = y_cur.shape
        th, tw, nt, serial = self._ar_dims(hgt, wid)
        priors = self._tiled_priors(z_hat, y_conditioned, th, tw, nt)
        # the residual target by type promotion: f32 against an f32 carry
        target = y_cur - y_conditioned if self.residual else y_cur
        target = target.permute(0, 2, 3, 1)
        if nt > 1:
            target = wf.tile_plane(target, th, tw)
        y_strings, _ = self._ar_encode(target, priors, b, nt, serial)
        return {"strings": [y_strings, z_strings],
                "shape": tuple(z_hat.shape[2:4])}

    @torch.no_grad()
    def _decompress_wavefront(self, strings, z_hat, y_conditioned):
        b = z_hat.shape[0]
        hgt, wid = z_hat.shape[2] * 4, z_hat.shape[3] * 4
        m = self.in_channels
        th, tw, nt, serial = self._ar_dims(hgt, wid)
        priors = self._tiled_priors(z_hat, y_conditioned, th, tw, nt)
        target_hat = self._ar_decode(strings[0], priors, m, nt, serial)
        if nt > 1:
            target_hat = wf.untile_plane(target_hat, b, hgt, wid)
        y_hat = _nchw(target_hat.permute(0, 3, 1, 2))
        if self.residual:
            y_hat = _nchw(y_hat + y_conditioned)
        return {"y_hat": y_hat}


# ---- reference-named constructors (README/zoo parity) ----------------------


def SpatioTemporalPriorModelWithoutSPMTPM(**kw):
    return SpatioTemporalPriorModel(variant="without_spm_tpm", **kw)


def SpatioTemporalPriorModelWithoutSPM(**kw):
    return SpatioTemporalPriorModel(variant="without_spm", **kw)


def SpatioTemporalPriorModelWithoutTPM(**kw):
    return SpatioTemporalPriorModel(variant="without_tpm", **kw)


def SpatioTemporalPriorModelFull(**kw):
    return SpatioTemporalPriorModel(variant="full", **kw)


def SpatioTemporalPriorModel_Res(**kw):
    return SpatioTemporalPriorModel(variant="res", **kw)
