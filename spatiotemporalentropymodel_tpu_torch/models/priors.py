"""Image codecs: FactorizedPrior (bmshj2018-factorized), ScaleHyperprior
(bmshj2018-hyperprior), MeanScaleHyperprior (mbt2018-mean), the I-frame
model of the video codec, and JointAutoregressiveHierarchicalPriors
(mbt2018), whose context model codes y autoregressively.

Counterparts of spatiotemporalentropymodel_tpu/models/priors.py
(compressai/models/priors.py:109-402), NCHW. Every layer is here so the whole
parameter tree carries across from the JAX package (convert.py).

FactorizedPrior codes y with its EntropyBottleneck: one string group, and
``shape`` is y's spatial shape. The two hyperprior models share the I-frame
codec of the JAX package's ``_HyperpriorCodecBase`` (priors.py:354-479
there), with its stream format and its dispatches: one device expression
per compress (``fused_encode_expr``), two per decompress
(``fused_params_expr``, ``fused_finish_expr``), host rANS between them.
ScaleHyperprior's h_a reads |y| and its h_s gives σ alone, so its μ is 0
and its ``decompress`` returns no ŷ. MeanScaleHyperprior's h_s gives (σ, μ);
the P-frame pipeline calls its ``analysis`` (g_a) and ``get_x`` (g_s +
clamp), which cast their input to the compute dtype as the JAX package's
``_apply`` does. At a bf16 compute dtype the nets run in bf16 and the codec
math in f32, as in the P-frame path.

JointAutoregressiveHierarchicalPriors codes ẑ on the host and y by the
rounds of models/ar_wavefront.py (``ar_mode="wavefront"``, the default) or
pixel by pixel in raster order (``"serial"``), with the JAX package's
streams: each (σ, μ) from the 12 causal taps of the pixel through the masked
conv's centre and the entropy-parameters stack on rows. g_a, h_a, h_s and
each round's products run once per picture of the batch, so a picture's
strings and ŷ do not depend on what it is batched with.
"""

import time
from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..entropy import EntropyBottleneck, GaussianConditional, build_indexes
from ..entropy import base as entropy_base
from ..layers import (
    GDN, Conv, Deconv, LeakyReLU, MaskedConv2d, ReLU, Sequential,
)
from ..layers.masked_conv import per_stream
from ..ops import kernels
from ..ops.quantize import quantize_dequantize, quantize_noise
from . import ar_wavefront as wf
from .base import CompressionModel, _as_bytes, _nchw, _nhwc_flat, _to_nchw


def _g_a(n, m, g):
    return Sequential([
        Conv(3, n, 5, 2, g), GDN(n), Conv(n, n, 5, 2, g), GDN(n),
        Conv(n, n, 5, 2, g), GDN(n), Conv(n, m, 5, 2, g),
    ])


def _g_s(n, m, g):
    return Sequential([
        Deconv(m, n, 5, 2, g), GDN(n, inverse=True),
        Deconv(n, n, 5, 2, g), GDN(n, inverse=True),
        Deconv(n, n, 5, 2, g), GDN(n, inverse=True),
        Deconv(n, 3, 5, 2, g),
    ])


class FactorizedPriorModule(nn.Module):
    """priors.py:109-181 — g_a/g_s only; y coded by the EntropyBottleneck."""

    def __init__(self, N: int, M: int, generator=None):
        super().__init__()
        self.g_a = _g_a(N, M, generator)
        self.g_s = _g_s(N, M, generator)
        self.entropy_bottleneck = EntropyBottleneck(M, generator=generator)

    def forward(self, x, train: bool = False, generator=None):
        """Forward with rate estimation (priors.py:62-66 of the JAX
        package): {"x_hat", "likelihoods": {"y"}}. Train mode adds noise
        from ``generator`` where eval mode rounds."""
        y_hat, y_likelihoods = self.entropy_bottleneck(
            self.g_a(x), train, generator)
        return {"x_hat": self.g_s(y_hat), "likelihoods": {"y": y_likelihoods}}


class ScaleHyperpriorModule(nn.Module):
    """priors.py:196-313 — the hyper pair on |y| → σ only."""

    def __init__(self, N: int, M: int, generator=None):
        super().__init__()
        n, m, g = N, M, generator
        self.g_a = _g_a(n, m, g)
        self.g_s = _g_s(n, m, g)
        self.h_a = Sequential([
            Conv(m, n, 3, 1, g), ReLU(), Conv(n, n, 5, 2, g), ReLU(),
            Conv(n, n, 5, 2, g),
        ])
        self.h_s = Sequential([
            Deconv(n, n, 5, 2, g), ReLU(), Deconv(n, n, 5, 2, g), ReLU(),
            Conv(n, m, 3, 1, g), ReLU(),
        ])
        self.entropy_bottleneck = EntropyBottleneck(n, generator=g)
        self.gaussian_conditional = GaussianConditional()

    def hyper_analysis(self, y):
        return self.h_a(torch.abs(y))

    def forward(self, x, train: bool = False, generator=None):
        """Forward with rate estimation (priors.py:117-127 of the JAX
        package): {"x_hat", "likelihoods": {"y", "z"}}. Train mode adds
        noise from ``generator`` where eval mode rounds."""
        y = self.g_a(x)
        z_hat, z_likelihoods = self.entropy_bottleneck(
            self.hyper_analysis(y), train, generator)
        y_hat, y_likelihoods = self.gaussian_conditional(
            y, self.h_s(z_hat), train=train, generator=generator)
        return {
            "x_hat": self.g_s(y_hat),
            "likelihoods": {"y": y_likelihoods, "z": z_likelihoods},
        }


def _h_a(n, m, g):
    return Sequential([
        Conv(m, n, 3, 1, g), LeakyReLU(0.01), Conv(n, n, 5, 2, g),
        LeakyReLU(0.01), Conv(n, n, 5, 2, g),
    ])


def _h_s(n, m, g):
    return Sequential([
        Deconv(n, m, 5, 2, g), LeakyReLU(0.01),
        Deconv(m, m * 3 // 2, 5, 2, g), LeakyReLU(0.01),
        Conv(m * 3 // 2, m * 2, 3, 1, g),
    ])


class MeanScaleHyperpriorModule(nn.Module):
    """priors.py:316-402 — h_s outputs (σ, μ); getY/getX STEM hooks."""

    def __init__(self, N: int, M: int, generator=None):
        super().__init__()
        n, m, g = N, M, generator
        self.g_a = _g_a(n, m, g)
        self.g_s = _g_s(n, m, g)
        self.h_a = _h_a(n, m, g)
        self.h_s = _h_s(n, m, g)
        self.entropy_bottleneck = EntropyBottleneck(n, generator=g)
        self.gaussian_conditional = GaussianConditional()

    def hyper_analysis(self, y):
        return self.h_a(y)

    def forward(self, x, train: bool = False, generator=None):
        """Forward with rate estimation (priors.py:175-191 of the JAX
        package): {"y", "y_hat", "x_hat", "likelihoods": {"y", "z"}}. Train
        mode adds noise from ``generator`` where eval mode rounds."""
        y = self.g_a(x)
        z_hat, z_likelihoods = self.entropy_bottleneck(self.h_a(y), train,
                                                       generator)
        scales_hat, means_hat = self.h_s(z_hat).chunk(2, dim=1)
        y_hat, y_likelihoods = self.gaussian_conditional(
            y, scales_hat, means_hat, train=train, generator=generator)
        return {
            "y": y,
            "y_hat": y_hat,
            "x_hat": self.g_s(y_hat),
            "likelihoods": {"y": y_likelihoods, "z": z_likelihoods},
        }

    def get_y(self, x, train: bool = False, generator=None):
        """getY hook (priors.py:390-395): the latent and its rounding, or
        in train mode the latent plus noise from ``generator``."""
        y = self.g_a(x)
        if train:
            return y, quantize_noise(y, generator)
        return y, quantize_dequantize(y)

    def get_x(self, y_hat):
        """getX hook (priors.py:397-402): synthesize and clamp to [0, 1]."""
        return torch.clamp(self.g_s(y_hat), 0.0, 1.0)


class JointAutoregressiveModule(nn.Module):
    """priors.py:406-694 (mbt2018) — the mean-scale hyperprior's nets plus a
    mask-A 5×5 context model on ŷ and a 1×1 entropy-parameters stack on
    cat([h_s(ẑ), context]) → (σ, μ). The Cheng2020 modules
    (models/waseda.py) override the ``_build_*`` factories."""

    def __init__(self, N: int, M: int, generator=None):
        super().__init__()
        n, m, g = N, M, generator
        self.N, self.M = N, M
        self.g_a = self._build_g_a(g)
        self.g_s = self._build_g_s(g)
        self.h_a = self._build_h_a(g)
        self.h_s = self._build_h_s(g)
        self.entropy_parameters = Sequential([
            Conv(m * 4, m * 10 // 3, 1, 1, g), LeakyReLU(0.01),
            Conv(m * 10 // 3, m * 8 // 3, 1, 1, g), LeakyReLU(0.01),
            Conv(m * 8 // 3, m * 6 // 3, 1, 1, g),
        ])
        self.context_prediction = MaskedConv2d(m, 2 * m, 5, "A", g)
        self.entropy_bottleneck = EntropyBottleneck(n, generator=g)
        self.gaussian_conditional = GaussianConditional()

    def _build_g_a(self, g):
        return _g_a(self.N, self.M, g)

    def _build_g_s(self, g):
        return _g_s(self.N, self.M, g)

    def _build_h_a(self, g):
        return _h_a(self.N, self.M, g)

    def _build_h_s(self, g):
        return _h_s(self.N, self.M, g)

    def forward(self, x, train: bool = False, generator=None):
        """Forward with rate estimation (priors.py:264-304 of the JAX
        package): {"y", "y_hat", "x_hat", "likelihoods": {"y", "z"},
        "entropy_params": {"scales_hat", "means_hat"}}. The context model
        sees the quantized latent and the Gaussian conditional quantizes y
        again (the reference's double quantization, priors.py:483-495): in
        eval mode both round, in train mode they are two separate noise
        draws from ``generator``."""
        y = self.g_a(x)
        z_hat, z_likelihoods = self.entropy_bottleneck(self.h_a(y), train,
                                                       generator)
        params = self.h_s(z_hat)
        y_hat = (quantize_noise(y, generator) if train
                 else quantize_dequantize(y))
        ctx = self.context_prediction(y_hat)
        scales_hat, means_hat = self.entropy_parameters(
            torch.cat([params, ctx], dim=1)).chunk(2, dim=1)
        _, y_likelihoods = self.gaussian_conditional(
            y, scales_hat, means_hat, train=train, generator=generator)
        return {
            "y": y,
            "y_hat": y_hat,
            "x_hat": self.g_s(y_hat),
            "likelihoods": {"y": y_likelihoods, "z": z_likelihoods},
            "entropy_params": {"scales_hat": scales_hat,
                               "means_hat": means_hat},
        }

    def ar_step(self, taps, prior_vec, streams: int = 1):
        """One AR pixel per row: the masked 5×5 context at the crop centre
        from its causal taps (N, 12·M) (``MaskedConv2d.causal_taps``), then
        the 1×1 entropy-parameters stack on cat([h_s row (N, 2M), ctx]) →
        (σ, μ), each (N, M): the JAX package's ar_step on the whole crop
        (priors.py:306-316). Each product runs once for each of ``streams``
        equal parts of the rows (``per_stream``)."""
        ctx = self.context_prediction.center(taps, streams)
        gp = wf.conv1x1_rows(self.entropy_parameters,
                             torch.cat([prior_vec, ctx], dim=1), streams)
        scales, means = gp.chunk(2, dim=1)
        return scales, means

    def get_y(self, x, train: bool = False, generator=None):
        """getY (priors.py:686-694): the latent and the latent plus noise
        from ``generator``; noise in either mode, as in the reference, so
        ``train`` (the mean-scale model's signature) changes nothing."""
        del train
        y = self.g_a(x)
        return y, quantize_noise(y, generator)

    def get_x(self, y_hat):
        """getX: synthesize and clamp to [0, 1]."""
        return torch.clamp(self.g_s(y_hat), 0.0, 1.0)


class FactorizedPrior(CompressionModel):
    """priors.py:330-352. Weights are drawn from ``seed`` with an explicit
    CPU generator, then moved to ``device``."""

    def __init__(self, N: int, M: int, device="cuda", seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        super().__init__(FactorizedPriorModule(N, M, gen), device)
        self.N, self.M = N, M

    @torch.no_grad()
    def compress(self, x) -> Dict[str, Any]:
        """x (B, 3, H, W) in [0, 1] → {"strings": [y_strings], "shape":
        y's (h, w)}."""
        self._require_tables()
        y = self.module.g_a(self._cast_in(x))
        strings = self._eb_compress(y.float().permute(0, 2, 3, 1).cpu()
                                    .numpy())
        return {"strings": [strings], "shape": tuple(y.shape[2:])}

    @torch.no_grad()
    def decompress(self, strings, shape) -> Dict[str, Any]:
        """{"x_hat": clamp(g_s(ŷ), 0, 1)}, NCHW on the model's device."""
        if not (isinstance(strings, list) and len(strings) == 1):
            raise ValueError("strings must be [y_strings]")
        self._require_tables()
        y_hat = torch.from_numpy(self._eb_decompress(strings[0], shape))
        y_hat = _nchw(y_hat.to(self.device).permute(0, 3, 1, 2))
        x_hat = self.module.g_s(self._cast_in(y_hat))
        return {"x_hat": torch.clamp(x_hat, 0.0, 1.0)}


class _HyperpriorCodecBase(CompressionModel):
    """The I-frame codec shared by the hyperprior image models
    (priors.py:354-479 of the JAX package). ``_with_means`` tells the
    σ-only ScaleHyperprior from the (σ, μ) MeanScaleHyperprior."""

    has_gaussian = True
    _with_means = False
    _I16_LIM = 32767.0

    def __init__(self, module, N: int, M: int, device):
        super().__init__(module, device)
        self.N, self.M = N, M

    def _params(self, z_sym):
        """(σ, μ) in the compute dtype from the f32 symbols of ẑ: the two
        channel-halves of h_s's output as they are, or h_s's output and
        zeros where h_s gives σ alone. ẑ = z_sym + medians goes to h_s in
        the compute dtype with the canonical NCHW strides, on encoder and
        decoder alike, so both get the same (σ, μ) bit for bit (see
        ``models/base.py::_nchw``)."""
        z_hat = _nchw(z_sym + self._medians,
                      self.compute_dtype or torch.float32)
        out = self.module.h_s(z_hat)
        if self._with_means:
            return out.chunk(2, dim=1)
        return out, torch.zeros_like(out)

    def _params_f32(self, z_sym):
        """(σ, μ) in f32, μ contiguous: the decoder's."""
        scales, means = self._params(z_sym)
        return scales.float(), means.float().contiguous()

    @torch.no_grad()
    def fused_encode_expr(self, x):
        """x (B, 3, H, W) → (packed u8 buffer [y int16][z int16][idx u8] in
        NHWC order, the ŷ the decoder rebuilds, f32 NCHW), one device
        dispatch (priors.py:372-403): g_a and h_a, ẑ's symbols, h_s on ẑ,
        then ``quantize_and_index`` on (y, μ, σ) as they are, in the compute
        dtype, its math in f32."""
        lim = self._I16_LIM
        y = self.module.g_a(self._cast_in(x))
        z = self.module.hyper_analysis(y)
        z_sym = torch.clamp(torch.round(z.float() - self._medians), -lim, lim)
        scales, means = self._params(z_sym)
        y_sym, idx = kernels.quantize_and_index(y, means, scales,
                                                self._scale_table)
        y_sym = torch.clamp(y_sym, -int(lim), int(lim))
        b = x.shape[0]
        packed = torch.cat([
            _as_bytes(_nhwc_flat(y_sym.to(torch.int16), b)),
            _as_bytes(_nhwc_flat(z_sym.to(torch.int16), b)),
            _nhwc_flat(idx, b).reshape(-1),
        ])
        # f32 + μ in the compute dtype adds in f32: the decoder's ŷ exactly
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
        x_hat = torch.clamp(self.module.g_s(self._cast_in(y_hat)), 0.0, 1.0)
        return y_hat, x_hat

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
        """{"x_hat": clamp(g_s(ŷ), 0, 1)}, and with the means "y_hat": ŷ
        f32, both NCHW on the model's device."""
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
        if self._with_means:
            return {"x_hat": x_hat, "y_hat": y_hat}
        return {"x_hat": x_hat}


class ScaleHyperprior(_HyperpriorCodecBase):
    """priors.py:481-486. Weights are drawn from ``seed`` with an explicit
    CPU generator, then moved to ``device``."""

    _with_means = False

    def __init__(self, N: int, M: int, device="cuda", seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        super().__init__(ScaleHyperpriorModule(N, M, gen), N, M, device)


class MeanScaleHyperprior(_HyperpriorCodecBase):
    """priors.py:316-402. Weights are drawn from ``seed`` with an explicit
    CPU generator, then moved to ``device``."""

    _with_means = True

    def __init__(self, N: int, M: int, device="cuda", seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        super().__init__(MeanScaleHyperpriorModule(N, M, gen), N, M, device)

    @torch.no_grad()
    def analysis(self, x):
        """g_a only. The JAX package's ``analysis`` also runs h_a, which its
        pipeline drops unused; eager PyTorch would run it."""
        return self.module.g_a(self._cast_in(x))

    @torch.no_grad()
    def get_x(self, y_hat):
        return self.module.get_x(self._cast_in(y_hat))

    def get_y(self, x):
        """(y, round(y)) of g_a, in the compute dtype (priors.py:498)."""
        return self.module.get_y(self._cast_in(x))


class JointAutoregressiveHierarchicalPriors(wf.ARCodec, CompressionModel):
    """mbt2018 (priors.py:511-734 of the JAX package). ``ar_mode=
    "wavefront"`` (the default) codes anti-diagonal rounds, one host rANS
    call per round and picture on decode; ``"serial"`` is the reference's
    per-pixel raster order (8160 rounds for a 1080p latent: small latents
    only). ``wavefront_format`` ("auto" = "lane", or "grouped") is the
    stream order of the wavefront mode (models/ar_wavefront.py::ARCodec).
    Each picture of a batch is a stream of its own. Weights are drawn from
    ``seed`` with an explicit CPU generator, then moved to ``device``."""

    has_gaussian = True
    _module_cls = JointAutoregressiveModule

    def __init__(self, N: int = 192, M: int = 192, ar_mode: str = "wavefront",
                 device="cuda", seed: int = 0):
        if ar_mode not in ("wavefront", "serial"):
            raise ValueError(f"unknown ar_mode {ar_mode!r}")
        gen = torch.Generator().manual_seed(seed)
        super().__init__(self._module_cls(N, M, gen), device)
        self.N, self.M = N, M
        self.ar_mode = ar_mode
        self._rounds_cache = {}

    @torch.no_grad()
    def analysis(self, x):
        """g_a only, in the compute dtype (the video codec's P-frame leg)."""
        return self.module.g_a(self._cast_in(x))

    @torch.no_grad()
    def get_x(self, y_hat):
        return self.module.get_x(self._cast_in(y_hat))

    def get_y(self, x, generator=None):
        """(y, y + noise) of g_a, in the compute dtype (priors.py:686)."""
        return self.module.get_y(self._cast_in(x), generator=generator)

    def _priors(self, z_hat, streams: int):
        """h_s(ẑ) (B, 2M, h, w), run once per stream, as NHWC rows of the
        rounds."""
        return per_stream(self.module.h_s, streams,
                          self._cast(z_hat)).permute(0, 2, 3, 1)

    def compress(self, x) -> Dict[str, Any]:
        """x (B, 3, H, W) in [0, 1] → {"strings": [y_strings, z_strings],
        "shape": (z_h, z_w)}: ẑ through the host bottleneck coder, y by the
        AR rounds against h_s(ẑ) (priors.py:650-700)."""
        return self.encode_with_y_hat(x)[0]

    @torch.no_grad()
    def encode_with_y_hat(self, x):
        """(``compress(x)``, the ŷ the decoder rebuilds, f32 NCHW)."""
        self._require_tables()
        b = x.shape[0]
        t0 = time.perf_counter()
        y = per_stream(self.module.g_a, b, self._cast_in(x))
        z = per_stream(self.module.h_a, b, y)
        z_np = z.float().permute(0, 2, 3, 1).cpu().numpy()
        z_strings = self._eb_compress(z_np)
        z_hat = self._upload(self._eb_quantize(z_np))
        self._lap("hyper_s", t0)
        priors = self._priors(z_hat, b)
        y_strings, y_hat = self._ar_encode(y.permute(0, 2, 3, 1), priors, b,
                                           serial=self.ar_mode == "serial")
        return ({"strings": [y_strings, z_strings],
                 "shape": tuple(z_hat.shape[2:4])},
                _nchw(y_hat.permute(0, 3, 1, 2)))

    @torch.no_grad()
    def decompress(self, strings, shape) -> Dict[str, Any]:
        """{"x_hat": clamp(g_s(ŷ), 0, 1), "y_hat": ŷ f32}, both NCHW on the
        model's device."""
        if not (isinstance(strings, list) and len(strings) == 2):
            raise ValueError("strings must be [y_strings, z_strings]")
        self._require_tables()
        t0 = time.perf_counter()
        z_hat = self._upload(self._eb_decompress(strings[1], shape))
        self._lap("hyper_s", t0)
        priors = self._priors(z_hat, z_hat.shape[0])
        y_hat = self._ar_decode(strings[0], priors, self.M,
                                serial=self.ar_mode == "serial")
        y_hat = _nchw(y_hat.permute(0, 3, 1, 2))
        x_hat = self.module.g_s(self._cast_in(y_hat))
        return {"x_hat": torch.clamp(x_hat, 0.0, 1.0), "y_hat": y_hat}
