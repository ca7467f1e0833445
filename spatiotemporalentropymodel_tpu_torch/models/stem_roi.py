"""The ROI / variable-rate STEM family: pixel-domain video codecs.

Counterpart of spatiotemporalentropymodel_tpu/models/stem_roi.py
(compressai/models/stem_roi.py, five classes), NCHW:

  stem_baseline    single-rate pixel-domain P-codec: its own 128-channel
                   PEncoder/PDecoder, TPM + hyper EPM, no SPM
  stem_baselinev2  + a separate ConditionEncoder for the conditioning frame
  stem_roi         variable-rate P-codec: the encoder and hyper-encoder
                   interleaved with SFT layers conditioned on a quality map
                   through the qmap_feature_* pyramids; the decoder
                   conditioned on a map generated from ẑ (wmap_generator),
                   so decoding needs no quality map
  stem_roi_wo_gsc  the ablation without the decoder-side SFT
  stem_roi_i       the matching I-frame model (no TPM, no condition)

Two parameterized modules (``StemBaselineModule``, ``StemROIModule``)
cover the five; every codec path is parallel. Their submodules carry the
JAX package's names, so the parameter trees map one to one (convert.py).
Images are (B, 3, H, W) in [0, 1] and the quality map is (B, 1, H, W) in
[0, 1], both on the model's device.

The codec (``_PixelCodecBase``) is the JAX package's: one device expression
per compress packs [y int16][z int16][idx u8] in NHWC order, the symbols
and ẑ saturated at ±32767 and ẑ around the bottleneck's medians, with
``quantize_and_index`` on (y, μ, σ) in the compute dtype; decompress runs
two (μ and the CDF rows from ẑ, then ŷ and the synthesis), host rANS
between them. ẑ and ŷ reach the nets with the canonical NCHW strides on
encoder and decoder alike (``models/base.py::_nchw``), so the decoder's ŷ
is the encoder's bit for bit. The latent sizes are those the k5 s2 convs
give (ceil-divided), so a frame of any size codes; the JAX package's
compress floors them and raises for a frame whose sides are not multiples
of 16.

In bf16 (``set_compute_dtype``) the g_a chains of ``_pixel_encoder`` run
their GDN → conv stages as ``gdn_conv_fused`` and ``_pixel_decoder`` its
last two stages as the packed g_s pair (``layers/conv.py::Sequential``);
the ROI family's GDN and IGDN end their ``Sequential``s and run
``gdn_fused``, as in the JAX package.
"""

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..entropy import EntropyBottleneck, GaussianConditional, build_indexes
from ..entropy import base as entropy_base
from ..layers import (
    GDN, SFT, Conv, Deconv, LeakyReLU, SFTResblk, Sequential,
    adaptive_avg_pool, leaky_relu,
)
from ..ops import kernels
from ..ops.padding import pad_centered
from .base import (
    CompressionModel, _as_bytes, _common_dtype, _nchw, _nhwc_flat, _to_nchw,
)

_LRELU = LeakyReLU(0.01)  # the JAX package's _LeakyReLU (torch's default)
_LRELU01 = LeakyReLU(0.1)  # _LeakyReLU01 of the quality-map pyramids
TRUNK = 128  # the reference's fixed pixel-trunk width


def _pixel_encoder(out_ch: int, g) -> Sequential:
    """4 × k5 s2 conv with GDN, 128 trunk (stem_roi.py:28-36)."""
    n = TRUNK
    return Sequential([
        Conv(3, n, 5, 2, g), GDN(n), Conv(n, n, 5, 2, g), GDN(n),
        Conv(n, n, 5, 2, g), GDN(n), Conv(n, out_ch, 5, 2, g),
    ])


def _pixel_decoder(in_ch: int, g) -> Sequential:
    """The mirror decoder (stem_roi.py:37-45)."""
    n = TRUNK
    return Sequential([
        Deconv(in_ch, n, 5, 2, g), GDN(n, inverse=True),
        Deconv(n, n, 5, 2, g), GDN(n, inverse=True),
        Deconv(n, n, 5, 2, g), GDN(n, inverse=True), Deconv(n, 3, 5, 2, g),
    ])


def _tpm(m: int, g) -> Sequential:
    return Sequential([Conv(m, 256, 5, 1, g), _LRELU, Conv(256, 320, 5, 1, g),
                       _LRELU, Conv(320, 2 * m, 5, 1, g)])


def _he(in_ch: int, ebc: int, g) -> Sequential:
    return Sequential([Conv(in_ch, 256, 3, 1, g), _LRELU,
                       Conv(256, 256, 5, 2, g), _LRELU,
                       Conv(256, ebc, 5, 2, g)])


def _hd(ebc: int, m: int, g) -> Sequential:
    return Sequential([Deconv(ebc, 256, 5, 2, g), _LRELU,
                       Deconv(256, 256, 5, 2, g), _LRELU,
                       Conv(256, 2 * m, 3, 1, g)])


def _epm(in_ch: int, m: int, g) -> Sequential:
    return Sequential([Conv(in_ch, 768, 1, 1, g), _LRELU,
                       Conv(768, 576, 1, 1, g), _LRELU,
                       Conv(576, 2 * m, 1, 1, g)])


def _qmap_head(in_ch: int, widths, g) -> Sequential:
    """Three k3 s1 convs with LeakyReLU(0.1) between them."""
    a, b, c = widths
    return Sequential([Conv(in_ch, a, 3, 1, g), _LRELU01, Conv(a, b, 3, 1, g),
                       _LRELU01, Conv(b, c, 3, 1, g)])


def _qmap_stage(in_ch: int, mid: int, out_ch: int, g,
                up: bool = False) -> Sequential:
    """A k3 s2 conv (a k3 s2 transposed conv where ``up``) to ``mid``,
    LeakyReLU(0.1), then a 1×1 conv to ``out_ch``."""
    return Sequential([(Deconv if up else Conv)(in_ch, mid, 3, 2, g),
                       _LRELU01, Conv(mid, out_ch, 1, 1, g)])


class StemBaselineModule(nn.Module):
    """Pixel-domain single-rate P-codec (stem_roi.py:21-348); v2 with a
    separate ConditionEncoder."""

    def __init__(self, entropy_bottleneck_channels: int = 256,
                 in_channels: int = 192,
                 separate_condition_encoder: bool = False, generator=None):
        super().__init__()
        m, ebc, g = in_channels, entropy_bottleneck_channels, generator
        self.separate_condition_encoder = separate_condition_encoder
        self.PEncoder = _pixel_encoder(m, g)
        self.PDecoder = _pixel_decoder(m, g)
        if separate_condition_encoder:
            self.ConditionEncoder = _pixel_encoder(m, g)
        self.TPM = _tpm(m, g)
        self.HE = _he(2 * m, ebc, g)
        self.HD = _hd(ebc, m, g)
        self.EPM = _epm(4 * m, m, g)
        self.entropy_bottleneck = EntropyBottleneck(ebc, generator=g)
        self.gaussian_conditional = GaussianConditional()

    def cond_latent(self, x_conditioned):
        if self.separate_condition_encoder:
            return self.ConditionEncoder(x_conditioned)
        return self.PEncoder(x_conditioned)

    def forward(self, x_cur, x_conditioned, train: bool = False,
                generator=None):
        """{"x_hat", "y_hat", "likelihoods": {"y", "z"}}; train mode adds
        noise from ``generator`` where eval mode rounds."""
        y_cur, y_cond, z = self.encode_latents(x_cur, x_conditioned)
        z_hat, z_lik = self.entropy_bottleneck(z, train, generator)
        scales, means = self.entropy_params(z_hat, y_cond)
        y_hat, y_lik = self.gaussian_conditional(
            y_cur, scales, means, train=train, generator=generator)
        return {"x_hat": self.PDecoder(y_hat), "y_hat": y_hat,
                "likelihoods": {"y": y_lik, "z": z_lik}}

    def encode_latents(self, x_cur, x_conditioned):
        y_cur = self.PEncoder(x_cur)
        y_cond = self.cond_latent(x_conditioned)
        return y_cur, y_cond, self.HE(torch.cat([y_cur, y_cond], dim=1))

    def entropy_params(self, z_hat, y_cond):
        gp = self.EPM(torch.cat([self.TPM(y_cond), self.HD(z_hat)], dim=1))
        scales, means = gp.chunk(2, dim=1)
        return scales, means

    def synthesis(self, y_hat):
        return torch.clamp(self.PDecoder(y_hat), 0.0, 1.0)

    def get_y(self, x):
        return self.PEncoder(x)


class StemROIModule(nn.Module):
    """The quality-map-conditioned variable-rate codec
    (stem_roi.py:353-1325). ``conditional=False`` is stem_roi_i (no TPM, no
    ConditionEncoder), ``decoder_sft=False`` stem_roi_wo_gsc."""

    def __init__(self, entropy_bottleneck_channels: int = 256,
                 in_channels: int = 192, conditional: bool = True,
                 decoder_sft: bool = True, generator=None):
        super().__init__()
        m, ebc, g = in_channels, entropy_bottleneck_channels, generator
        n = TRUNK
        self.conditional = conditional
        self.decoder_sft = decoder_sft

        # g_a pyramid with SFT conditioning (stem_roi.py:359-400)
        self.ga1 = Sequential([Conv(3, n, 5, 2, g), GDN(n)])
        self.ga1_SFT = SFT(n, n, generator=g)
        self.ga2 = Sequential([Conv(n, n, 5, 2, g), GDN(n)])
        self.ga2_SFT = SFT(n, n, generator=g)
        self.ga3 = Sequential([Conv(n, n, 5, 2, g), GDN(n)])
        self.ga3_SFT = SFT(n, n, generator=g)
        self.ga4 = Conv(n, m, 5, 2, g)
        self.ga4_SFTResB1 = SFTResblk(m, m, generator=g)
        self.ga4_SFTResB2 = SFTResblk(m, m, generator=g)
        self.qmap_feature_ga1 = _qmap_head(4, (192, 160, n), g)
        self.qmap_feature_ga2 = _qmap_stage(n, n, n, g)
        self.qmap_feature_ga3 = _qmap_stage(n, n, n, g)
        self.qmap_feature_ga4 = _qmap_stage(n, n, m, g)

        # the hyper-encoder with SFT conditioning (stem_roi.py:403-429); the
        # reference hard-codes 256 for ha3, parameterized on ebc here as in
        # the JAX package (the same at the default ebc = 256)
        he_in = 2 * m if conditional else m
        self.ha1 = Conv(he_in, 256, 3, 1, g)
        self.ha1_SFT = SFT(256, 256, generator=g)
        self.ha2 = Conv(256, 256, 5, 2, g)
        self.ha2_SFT = SFT(256, 256, generator=g)
        self.ha3 = Conv(256, ebc, 5, 2, g)
        self.ha3_ResB1 = SFTResblk(ebc, 256, generator=g)
        self.ha3_ResB2 = SFTResblk(ebc, 256, generator=g)
        self.qmap_feature_ha1 = _qmap_head(1 + he_in, (n, 192, 256), g)
        self.qmap_feature_ha2 = _qmap_stage(256, 256, 256, g)
        self.qmap_feature_ha3 = _qmap_stage(256, 256, 256, g)

        self.hs = _hd(ebc, m, g)

        # the decoder (stem_roi.py:442-491); its map comes from ẑ
        if decoder_sft:
            self.wmap_generator = Sequential([
                Deconv(ebc, 192, 5, 2, g), _LRELU, Deconv(192, n, 5, 2, g),
                _LRELU, Conv(n, 64, 3, 1, g),
            ])
            self.gs0_SFTResB1 = SFTResblk(m, 192, generator=g)
            self.gs0_SFTResB2 = SFTResblk(m, 192, generator=g)
            self.qmap_feature_gs0 = _qmap_head(64 + m, (192, 192, 192), g)
            self.qmap_feature_gs1 = _qmap_stage(192, n, n, g, up=True)
            self.qmap_feature_gs2 = _qmap_stage(n, n, n, g, up=True)
            self.qmap_feature_gs3 = _qmap_stage(n, n, n, g, up=True)
            self.gs1_SFT = SFT(n, n, generator=g)
            self.gs2_SFT = SFT(n, n, generator=g)
            self.gs3_SFT = SFT(n, n, generator=g)
        self.gs1 = Sequential([Deconv(m, n, 5, 2, g), GDN(n, inverse=True)])
        self.gs2 = Sequential([Deconv(n, n, 5, 2, g), GDN(n, inverse=True)])
        self.gs3 = Sequential([Deconv(n, n, 5, 2, g), GDN(n, inverse=True)])
        self.gs4 = Deconv(n, 3, 5, 2, g)

        if conditional:
            self.ConditionEncoder = _pixel_encoder(m, g)
            self.TPM = _tpm(m, g)
        self.EPM = _epm(4 * m if conditional else 2 * m, m, g)
        self.entropy_bottleneck = EntropyBottleneck(ebc, generator=g)
        self.gaussian_conditional = GaussianConditional()

    def p_encoder(self, x, qmap):
        q = self.qmap_feature_ga1(torch.cat([x, qmap], dim=1))
        x = self.ga1_SFT(self.ga1(x), q)
        q = self.qmap_feature_ga2(q)
        x = self.ga2_SFT(self.ga2(x), q)
        q = self.qmap_feature_ga3(q)
        x = self.ga3_SFT(self.ga3(x), q)
        q = self.qmap_feature_ga4(q)
        x = self.ga4_SFTResB1(self.ga4(x), q)
        return self.ga4_SFTResB2(x, q)

    def hyper_encoder(self, y, qmap):
        q = adaptive_avg_pool(qmap, y.shape[2:])
        q = self.qmap_feature_ha1(torch.cat([q, y], dim=1))
        x = leaky_relu(self.ha1_SFT(self.ha1(y), q))
        q = self.qmap_feature_ha2(q)
        x = leaky_relu(self.ha2_SFT(self.ha2(x), q))
        q = self.qmap_feature_ha3(q)
        x = self.ha3_ResB1(self.ha3(x), q)
        return self.ha3_ResB2(x, q)

    def p_decoder(self, y_hat, z_hat):
        x = y_hat
        if self.decoder_sft:
            w = self.qmap_feature_gs0(torch.cat([self.wmap_generator(z_hat),
                                                 x], dim=1))
            x = self.gs0_SFTResB2(self.gs0_SFTResB1(x, w), w)
            for i in (1, 2, 3):
                w = getattr(self, f"qmap_feature_gs{i}")(w)
                x = getattr(self, f"gs{i}_SFT")(getattr(self, f"gs{i}")(x), w)
        else:
            x = self.gs3(self.gs2(self.gs1(x)))
        return self.gs4(x)

    def _split(self, args):
        """(x_conditioned or None, qmap) of the call's extra arguments:
        (x_conditioned, qmap) for the P-models, (qmap,) for stem_roi_i."""
        if self.conditional:
            x_conditioned, qmap = args
            return x_conditioned, qmap
        (qmap,) = args
        return None, qmap

    def forward(self, x_cur, *args, train: bool = False, generator=None):
        """stem_roi / wo_gsc: (x_cur, x_conditioned, qmap); stem_roi_i:
        (x_cur, qmap). {"x_hat" (unclipped), "y_hat", "likelihoods"}."""
        y_cur, y_cond, z = self.encode_latents(x_cur, *args)
        z_hat, z_lik = self.entropy_bottleneck(z, train, generator)
        scales, means = self.entropy_params(z_hat, y_cond)
        y_hat, y_lik = self.gaussian_conditional(
            y_cur, scales, means, train=train, generator=generator)
        return {"x_hat": self.p_decoder(y_hat, z_hat), "y_hat": y_hat,
                "likelihoods": {"y": y_lik, "z": z_lik}}

    def encode_latents(self, x_cur, *args):
        """(y_cur, y_cond, z); y_cond is zeros for stem_roi_i."""
        x_conditioned, qmap = self._split(args)
        y_cur = self.p_encoder(x_cur, qmap)
        if not self.conditional:
            return y_cur, torch.zeros_like(y_cur), self.hyper_encoder(
                y_cur, qmap)
        y_cond = self.ConditionEncoder(x_conditioned)
        return y_cur, y_cond, self.hyper_encoder(
            torch.cat([y_cur, y_cond], dim=1), qmap)

    def cond_latent(self, x_conditioned):
        return self.ConditionEncoder(x_conditioned)

    def entropy_params(self, z_hat, y_cond):
        hyper = self.hs(z_hat)
        if self.conditional:
            hyper = torch.cat([self.TPM(y_cond), hyper], dim=1)
        scales, means = self.EPM(hyper).chunk(2, dim=1)
        return scales, means

    def synthesis(self, y_hat, z_hat):
        return torch.clamp(self.p_decoder(y_hat, z_hat), 0.0, 1.0)


class _PixelCodecBase(CompressionModel):
    """The parallel codec over (y_cur, y_cond, z) encoders
    (stem_roi.py:423-554 of the JAX package)."""

    has_gaussian = True
    _I16_LIM = 32767.0
    _synthesis_needs_z = False

    def __init__(self, module, in_channels: int, device):
        super().__init__(module, device)
        self.in_channels = in_channels

    def _z_hat(self, z_sym):
        """ẑ = symbols + medians in the compute dtype, canonical strides."""
        return _nchw(z_sym + self._medians,
                     self.compute_dtype or torch.float32)

    @torch.no_grad()
    def fused_encode_expr(self, *model_args):
        """The model's inputs → (packed u8 buffer [y int16][z int16][idx u8]
        in NHWC order, the ŷ the decoder rebuilds, f32 NCHW), one device
        dispatch (stem_roi.py:445-475): the encoders, ẑ's symbols, the
        entropy parameters on ẑ, then ``quantize_and_index`` on (y, μ, σ)
        in the compute dtype, its math in f32."""
        lim = self._I16_LIM
        y_cur, y_cond, z = self.module.encode_latents(
            *(self._cast(a) for a in model_args))
        z_sym = torch.clamp(torch.round(z.float() - self._medians), -lim, lim)
        scales, means = self.module.entropy_params(self._z_hat(z_sym), y_cond)
        y_sym, idx = kernels.quantize_and_index(
            *_common_dtype(y_cur, means, scales), self._scale_table)
        y_sym = torch.clamp(y_sym, -int(lim), int(lim))
        b = y_cur.shape[0]
        packed = torch.cat([
            _as_bytes(_nhwc_flat(y_sym.to(torch.int16), b)),
            _as_bytes(_nhwc_flat(z_sym.to(torch.int16), b)),
            _nhwc_flat(idx, b).reshape(-1),
        ])
        # f32 + μ in the compute dtype adds in f32: the decoder's ŷ exactly
        return packed, y_sym.float() + means

    @torch.no_grad()
    def fused_params_expr(self, z_sym, y_cond):
        """Decoder side (stem_roi.py:477-492): int ẑ symbols NCHW and the
        conditioning latent → (μ f32, CDF-row indexes u8), both NCHW."""
        scales, means = self.module.entropy_params(
            self._z_hat(z_sym.float()), y_cond)
        idx = build_indexes(scales.float(), self._scale_table)
        return means.float().contiguous(), idx.to(torch.uint8)

    @torch.no_grad()
    def fused_finish_expr(self, y_sym, means, z_sym):
        """(ŷ symbols, μ, ẑ symbols) → (ŷ f32, x̂ = the synthesis clipped to
        [0, 1]) (stem_roi.py:494-508)."""
        y_hat = y_sym.float() + means
        args = [self._cast(y_hat)]
        if self._synthesis_needs_z:
            args.append(self._z_hat(z_sym.float()))
        return y_hat, self.module.synthesis(*args)

    def _latent_shapes(self, x_shape):
        b, _, h, w = x_shape
        yh, yw = -(-h // 16), -(-w // 16)
        return ((b, yh, yw, self.in_channels),
                (b, -(-yh // 4), -(-yw // 4),
                 self.tables["entropy_bottleneck"].rows))

    def encode_with_y_hat(self, x_cur, *rest):
        """(``compress``'s dict, the ŷ the decoder rebuilds, f32 NCHW)."""
        self._require_tables()
        y_shape, z_shape = self._latent_shapes(x_cur.shape)
        packed, y_hat = self.fused_encode_expr(x_cur, *rest)
        y_sym, z_sym, idx = entropy_base.unpack_symbol_buffer(
            packed.cpu().numpy(), y_shape, z_shape)
        zt = self.tables["entropy_bottleneck"]
        z_strings = entropy_base.compress(
            z_sym.astype(np.int32),
            entropy_base.bottleneck_indexes(z_shape, zt.rows), zt, self.coder)
        y_strings = entropy_base.compress(
            y_sym.astype(np.int32), idx, self.tables["gaussian_conditional"],
            self.coder)
        return ({"strings": [y_strings, z_strings],
                 "shape": tuple(z_shape[1:3])}, y_hat)

    def _codec_decode(self, strings, shape, y_cond):
        if not (isinstance(strings, list) and len(strings) == 2):
            raise ValueError("strings must be [y_strings, z_strings]")
        zt = self.tables["entropy_bottleneck"]
        z_idx = entropy_base.bottleneck_indexes(
            (len(strings[1]), *shape, zt.rows), zt.rows)
        z_sym = _to_nchw(entropy_base.decompress(strings[1], z_idx, zt,
                                                 self.coder), self.device)
        means, idx = self.fused_params_expr(z_sym, y_cond)
        y_sym = entropy_base.decompress(
            strings[0], idx.permute(0, 2, 3, 1).cpu().numpy().astype(np.int32),
            self.tables["gaussian_conditional"], self.coder)
        y_hat, x_hat = self.fused_finish_expr(_to_nchw(y_sym, self.device),
                                              means, z_sym)
        return {"x_hat": x_hat, "y_hat": y_hat,
                "entropy_params": {"means_hat": means}}

    @torch.no_grad()
    def cond_latent(self, x_conditioned):
        """The conditioning frame's latent in the compute dtype."""
        return self.module.cond_latent(self._cast(x_conditioned))


class StemBaseline(_PixelCodecBase):
    """stem_baseline (stem_roi.py:556-594); v2 with ``v2=True``. Weights
    are drawn from ``seed`` with an explicit CPU generator, then moved to
    ``device``.

      compress(x_cur, x_conditioned) -> {"strings": [y, z], "shape"}
      decompress(strings, shape, x_conditioned) -> {"x_hat", "y_hat",
                                                    "entropy_params"}
    """

    def __init__(self, entropy_bottleneck_channels: int = 256,
                 in_channels: int = 192, v2: bool = False, device="cuda",
                 seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        super().__init__(
            StemBaselineModule(entropy_bottleneck_channels, in_channels,
                               separate_condition_encoder=v2, generator=gen),
            in_channels, device)

    def compress(self, x_cur, x_conditioned) -> Dict[str, Any]:
        return self.encode_with_y_hat(x_cur, x_conditioned)[0]

    def decompress(self, strings, shape, x_conditioned) -> Dict[str, Any]:
        self._require_tables()
        return self._codec_decode(strings, shape,
                                  self.cond_latent(x_conditioned))

    @torch.no_grad()
    def get_y(self, x, is_eval: bool = False):
        """getY with the eval-time centred padding to a multiple of 64
        (stem_roi.py:144-160)."""
        if is_eval:
            x, _ = pad_centered(x, 64)
        return self.module.get_y(self._cast_in(x))

    getY = get_y


def StemBaselineV2(**kw):
    return StemBaseline(v2=True, **kw)


class StemROI(_PixelCodecBase):
    """stem_roi (stem_roi.py:601-638); the ablations through its flags.
    Weights are drawn from ``seed`` with an explicit CPU generator, then
    moved to ``device``.

      compress(x_cur, x_conditioned, qmap) -> {"strings": [y, z], "shape"}
        (stem_roi_i: compress(x_cur, qmap))
      decompress(strings, shape, x_conditioned=None) -> {"x_hat", "y_hat",
                                                         "entropy_params"}
    """

    _synthesis_needs_z = True  # the decoder's map comes from ẑ

    def __init__(self, entropy_bottleneck_channels: int = 256,
                 in_channels: int = 192, conditional: bool = True,
                 decoder_sft: bool = True, device="cuda", seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        super().__init__(
            StemROIModule(entropy_bottleneck_channels, in_channels,
                          conditional=conditional, decoder_sft=decoder_sft,
                          generator=gen),
            in_channels, device)
        self.conditional = conditional

    def compress(self, x_cur, *args) -> Dict[str, Any]:
        return self.encode_with_y_hat(x_cur, *args)[0]

    def decompress(self, strings, shape,
                   x_conditioned=None) -> Dict[str, Any]:
        """No quality map: the decoder's comes from ẑ. stem_roi_i takes no
        conditioning frame and conditions on zeros (stem_roi.py:630-632)."""
        self._require_tables()
        if self.conditional:
            y_cond = self.cond_latent(x_conditioned)
        else:
            y_cond = torch.zeros(
                (len(strings[1]), self.in_channels, shape[0] * 4,
                 shape[1] * 4), device=self.device)
        return self._codec_decode(strings, shape, y_cond)


def StemROIWoGsc(**kw):
    return StemROI(decoder_sft=False, **kw)


def StemROI_I(**kw):
    return StemROI(conditional=False, **kw)
