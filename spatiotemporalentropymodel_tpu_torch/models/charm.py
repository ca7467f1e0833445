"""Channel-autoregressive STEM (charm) and its codec.

Counterpart of spatiotemporalentropymodel_tpu/models/charm.py: the masked
spatial context of the SPM variants gives way to channel-group conditioning
(Minnen & Singh 2020, "Channel-wise Autoregressive Entropy Models",
arXiv:2007.08739). The latent splits into G channel groups; group g's (σ, μ)
condition on the temporal and hyper priors and on the decoded groups < g.
Decode is parallel over space: G rounds of (device parameters, host rANS)
per frame instead of pixel steps or wavefronts.

  HE   : k3s1(→256) + 2 × k5s2(→256/EB-ch) over cat(y_cur, y_cond)
  HD   : the mirror transposed stack → 2M
  TPM  : 3 × k5s1 (256 → 320 → 2M) on y_cond
  EPM_g: 1×1 stack (4M + g·M/G → 512 → 384 → 2·M/G) → (σ_g, μ_g)
  LRP_g: 1×1 stack (4M + (g+1)·M/G → 224 → 128 → M/G), latent residual
         prediction: ŷ_g += 0.5·tanh(LRP_g(priors, groups < g, ŷ_g))

The sub-nets are attributes named ``EPM_<g>`` and ``LRP_<g>``, flax's names,
so ``convert.py`` maps the JAX tree as it is. Charm has no GDN and calls the
plain ``build_indexes``: it reaches no kernel of its own.

Tensors are NCHW on the device; wherever symbols leave it they are in the
JAX package's NHWC order, so streams, counts and files are the JAX
package's byte for byte. Two transports:

  sparse  one dispatch → [bitmask][values i8, n // 4][counts G·levels i32]
          [z i8][meta]: the symbols sorted (stably) by the composite key
          group·levels + CDF row, so each group's wire segment is contiguous;
          ẑ and y clamp to int8, and any overflow falls back to
  dense   one dispatch → [y int16][z int16][idx u8], one stream per group.

and three decodes: fetch-free (the container's counts; all groups' host
rANS first, one payload upload, one device pass), per group sparse (each
group's counts computed on the device and fetched) and dense (each group's
index plane fetched). Each rebuilds the encoder's ŷ bit for bit: the
encoder's recursion runs on the ŷ the decoder will have, and ẑ and the
symbols reach the convs with canonical NCHW strides on both sides
(``models/base.py::_nchw``).

Under a bf16 compute dtype (``set_compute_dtype``) the nets run in bf16 and
the codec math in f32, with the JAX package's casts (charm.py:218-222
there): σ, μ and the target in f32 before rounding and ``build_indexes``;
each group's ŷ enters LRP (and, with LRP off, the context) rounded to bf16.

The latent sides must be multiples of 4, as in the JAX package: the dense
path floors the ẑ shape (h // 4) where the sparse path ceil-divides, and
``decompress`` rebuilds the sides as 4 × ẑ's. ``encode_video`` and
``eval_stem`` pad frames to 64, which gives such latents; other sizes raise
a ValueError here.
"""

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from ..entropy import EntropyBottleneck, GaussianConditional, build_indexes
from ..entropy import base as entropy_base
from ..entropy import transport
from ..layers import Conv, Deconv, LeakyReLU, Sequential
from ..ops.quantize import ste_round
from ..utils import trace
from .base import (
    CompressionModel, _as_bytes, _nchw, _nhwc_flat, _pack_sparse, _to_nchw,
    _unpack_sparse,
)


class ChannelARSTEMModule(nn.Module):
    """STEM with TPM + hyper priors and G-group channel autoregression
    (charm.py:39-170 of the JAX package). ``lrp=True`` adds latent residual
    prediction (Minnen & Singh 2020 §III-B): after group g decodes, a 1×1
    stack predicts its quantization residual from the priors, the decoded
    earlier groups and the group's own quantized values; the refinement is
    bounded (0.5·tanh, at most half a bin) and reads only decoded values."""

    def __init__(self, groups: int = 4, entropy_bottleneck_channels: int = 256,
                 in_channels: int = 192, residual: bool = True,
                 lrp: bool = True, generator=None):
        super().__init__()
        m, ebc, gen = in_channels, entropy_bottleneck_channels, generator
        if m % groups:
            raise ValueError(f"in_channels {m} not divisible by {groups}")
        self.groups = groups
        self.entropy_bottleneck_channels = ebc
        self.in_channels = m
        self.residual = residual
        self.lrp = lrp
        lrelu = LeakyReLU(0.01)  # torch default slope, as the reference
        self.HE = Sequential([
            Conv(2 * m, 256, 3, 1, gen), lrelu, Conv(256, 256, 5, 2, gen),
            lrelu, Conv(256, ebc, 5, 2, gen),
        ])
        self.HD = Sequential([
            Deconv(ebc, 256, 5, 2, gen), lrelu, Deconv(256, 256, 5, 2, gen),
            lrelu, Conv(256, 2 * m, 3, 1, gen),
        ])
        self.TPM = Sequential([
            Conv(m, 256, 5, 1, gen), lrelu, Conv(256, 320, 5, 1, gen), lrelu,
            Conv(320, 2 * m, 5, 1, gen),
        ])
        gs = m // groups
        for g in range(groups):
            setattr(self, f"EPM_{g}", Sequential([
                Conv(4 * m + g * gs, 512, 1, 1, gen), lrelu,
                Conv(512, 384, 1, 1, gen), lrelu,
                Conv(384, 2 * gs, 1, 1, gen),
            ]))
        if lrp:
            for g in range(groups):
                setattr(self, f"LRP_{g}", Sequential([
                    Conv(4 * m + (g + 1) * gs, 224, 1, 1, gen), lrelu,
                    Conv(224, 128, 1, 1, gen), lrelu,
                    Conv(128, gs, 1, 1, gen),
                ]))
        self.entropy_bottleneck = EntropyBottleneck(ebc, generator=gen)
        self.gaussian_conditional = GaussianConditional()

    @property
    def group_size(self) -> int:
        return self.in_channels // self.groups

    def priors(self, z_hat, y_cond):
        """cat([TPM(y_cond), HD(ẑ)]): (B, 4M, H, W)."""
        return torch.cat([self.TPM(y_cond), self.HD(z_hat)], dim=1)

    def hyper_encode(self, y_cur, y_cond):
        return self.HE(torch.cat([y_cur, y_cond], dim=1))

    def group_params(self, priors, ctx, g: int):
        """(σ_g, μ_g) from the priors and ``ctx``, the decoded groups < g
        (None for group 0): EPM_g's two channel halves, as they are."""
        feats = priors if ctx is None else torch.cat([priors, ctx], dim=1)
        return getattr(self, f"EPM_{g}")(feats).chunk(2, dim=1)

    def lrp_refine(self, priors, ctx, y_hat_g, g: int):
        """The bounded residual refinement of decoded group g (y_hat_g as
        it is when the module has no LRP)."""
        if not self.lrp:
            return y_hat_g
        parts = [priors, y_hat_g] if ctx is None else [priors, ctx, y_hat_g]
        feats = torch.cat(parts, dim=1)
        return y_hat_g + 0.5 * torch.tanh(getattr(self, f"LRP_{g}")(feats))

    def forward(self, y_cur, y_conditioned, train: bool = False,
                generator=None):
        """Forward with rate estimation (charm.py:130-166 there): {"y_hat",
        "likelihoods": {"y", "z"}}. Each group's context and reconstruction
        round exactly as the coder does, round(t − μ) + μ, straight through
        in training (Minnen & Singh 2020 §III-A); the likelihoods take
        noise from ``generator`` in train mode."""
        z = self.hyper_encode(y_cur, y_conditioned)
        z_hat, z_likelihoods = self.entropy_bottleneck(z, train, generator)
        priors = self.priors(z_hat, y_conditioned)
        target = y_cur - y_conditioned if self.residual else y_cur
        gs = self.group_size
        liks, decoded = [], []
        for g in range(self.groups):
            ctx = torch.cat(decoded, dim=1) if decoded else None
            scales, means = self.group_params(priors, ctx, g)
            t_g = target[:, g * gs:(g + 1) * gs]
            _, lik_g = self.gaussian_conditional(
                t_g, scales, means, train=train, generator=generator)
            liks.append(lik_g)
            t_hat_g = ste_round(t_g - means) + means
            decoded.append(self.lrp_refine(priors, ctx, t_hat_g, g))
        target_out = torch.cat(decoded, dim=1)
        y_hat = target_out + y_conditioned if self.residual else target_out
        return {"y_hat": y_hat,
                "likelihoods": {"y": torch.cat(liks, dim=1),
                                "z": z_likelihoods}}


class SpatioTemporalPriorModelChannelAR(CompressionModel):
    """Host wrapper (charm.py:173-732 there): encode is one device pass
    (the G-group recursion runs on the device; quantization is
    decoder-replicable, so there is no host round trip); decode is G
    (parameters → host rANS) rounds, each over the whole plane, or one
    device pass after the host rANS where the container carries the
    counts.

      compress(y_cur, y_cond, transport_mode="sparse")
          -> {"strings": [y per element per group, z], "shape", "transport",
              "counts" (sparse: (b, G, levels) int32)}
      decompress(strings, shape, y_cond, transport_mode, counts=None)
          -> {"y_hat"}
    """

    has_gaussian = True
    bottleneck_names = ("entropy_bottleneck",)
    _I16_LIM = 32767.0
    _I8_LIM = 127

    def __init__(self, groups: int = 4, entropy_bottleneck_channels: int = 256,
                 in_channels: int = 192, residual: bool = True,
                 lrp: bool = True, device="cuda", seed: int = 0,
                 entropy_coder=None):
        gen = torch.Generator().manual_seed(seed)
        super().__init__(
            ChannelARSTEMModule(groups, entropy_bottleneck_channels,
                                in_channels, residual, lrp, gen),
            device, entropy_coder)
        self.groups = groups
        self.in_channels = in_channels
        self.residual = residual

    @property
    def levels(self) -> int:
        return int(self._scale_table.numel())

    def _check_latent(self, hgt: int, wid: int):
        if hgt % 4 or wid % 4:
            raise ValueError(
                f"charm codes latents whose sides are multiples of 4 (its ẑ "
                f"is rebuilt as 4× smaller), got {hgt}×{wid}: pad the "
                f"frames to 64")

    # ---- the device expressions --------------------------------------------

    def _priors(self, z_sym, y_cond):
        """The priors in the compute dtype from ẑ's f32 symbols (NCHW)."""
        return self.module.priors(self._cast(z_sym + self._medians),
                                  self._cast(y_cond))

    def _params_f32(self, priors, ctx, g: int):
        """(σ_g, μ_g) cast to f32: the f32 island of the codec math."""
        scales, means = self.module.group_params(priors, ctx, g)
        return scales.float(), means.float()

    def _refine(self, priors, ctx, y_hat_g, g: int):
        """Group g's decoded values (f32) through LRP, in the compute dtype
        (with LRP off: the values cast to it)."""
        return self.module.lrp_refine(priors, ctx, self._cast(y_hat_g), g)

    def _encode_groups(self, y_cur, y_cond, z_sym):
        """The encoder's group recursion on ẑ's symbols: (y symbols f32
        unclamped, CDF-row indexes int32, the decoder's target ŷ), NCHW."""
        priors = self._priors(z_sym, y_cond)
        target = y_cur - y_cond if self.residual else y_cur
        gs, lim = self.module.group_size, self._I16_LIM
        syms, idxs, decoded = [], [], []
        for g in range(self.groups):
            ctx = torch.cat(decoded, dim=1) if decoded else None
            scales, means = self._params_f32(priors, ctx, g)
            t_g = target[:, g * gs:(g + 1) * gs].float()
            sym = torch.round(t_g - means)
            decoded.append(self._refine(
                priors, ctx, torch.clamp(sym, -lim, lim) + means, g))
            syms.append(sym)
            idxs.append(build_indexes(scales, self._scale_table))
        return (torch.cat(syms, dim=1), torch.cat(idxs, dim=1),
                torch.cat(decoded, dim=1))

    def _carry(self, target_hat, y_cond):
        return target_hat + y_cond if self.residual else target_hat

    @torch.no_grad()
    def fused_encode_carry_expr(self, y_cur, y_cond):
        """Dense encode (charm.py:196-240 there): (y_cur, y_cond) → (packed
        u8 [y int16][z int16][idx u8] in NHWC order, the encoder's ŷ)."""
        lim = self._I16_LIM
        b = y_cur.shape[0]
        z = self.module.hyper_encode(self._cast(y_cur), self._cast(y_cond))
        z_sym = torch.clamp(torch.round(z.float() - self._medians), -lim, lim)
        y_sym, idx, target_hat = self._encode_groups(y_cur, y_cond, z_sym)
        y16 = torch.clamp(y_sym, -lim, lim).to(torch.int16)
        packed = torch.cat([
            _as_bytes(_nhwc_flat(y16, b)),
            _as_bytes(_nhwc_flat(z_sym.to(torch.int16), b)),
            _nhwc_flat(idx.to(torch.uint8), b).reshape(-1),
        ])
        return packed, self._carry(target_hat, y_cond)

    @torch.no_grad()
    def fused_encode_sparse_carry_expr(self, y_cur, y_cond):
        """Sparse encode (charm.py:242-332 there): (y_cur, y_cond) → (packed
        transport buffer, the encoder's ŷ). Per batch element (n = h·w·M,
        cap = n // 4, L = G·levels):

          [bitmask b·n/8][values b·cap i8][counts b·L i32][z b·zn i8]
          [meta b·2 i32: (nonzero count, overflow flag)]

        The symbols sort stably by group·levels + CDF row over the NHWC
        flat order. ẑ clamps to int8; the priors, and so the ŷ, come from
        that ẑ, which is the decoder's whenever the frame ships sparse (an
        overflow sends it dense)."""
        lim8 = self._I8_LIM
        b = y_cur.shape[0]
        z = self.module.hyper_encode(self._cast(y_cur), self._cast(y_cond))
        z_raw = torch.round(z.float() - self._medians)
        z_sym = torch.clamp(z_raw, -lim8, lim8)
        y_sym, idx, target_hat = self._encode_groups(y_cur, y_cond, z_sym)
        levels, gs = self.levels, self.module.group_size
        group = torch.arange(self.groups, dtype=torch.int32,
                             device=y_cur.device).repeat_interleave(gs)
        key = idx + levels * group.view(1, -1, 1, 1)
        y_flat = _nhwc_flat(y_sym, b)
        packed = _pack_sparse(
            y_flat, _nhwc_flat(key, b).long(), self.groups * levels,
            y_flat.shape[1] // 4, _nhwc_flat(z_sym.to(torch.int8), b),
            (z_raw.abs() > lim8).any())
        return packed, self._carry(target_hat, y_cond)

    @torch.no_grad()
    def fused_decode_expr(self, z_sym, payload, y_cond):
        """The fetch-free decoder (charm.py:571-634 there): (ẑ symbols NCHW,
        payload u8 = per group [bitmask b·n_g/8][values i8 b·(n_g // 4)],
        y_cond) → the target ŷ, in one device pass. Group g's stable sort
        of its CDF rows reproduces the encoder's composite-key order
        restricted to the group (both order by (h, w, c))."""
        b, _, zh, zw = z_sym.shape
        hgt, wid = 4 * zh, 4 * zw
        gs = self.module.group_size
        n_g = hgt * wid * gs
        cap = n_g // 4
        seg_mask, seg_val = b * n_g // 8, b * cap
        priors = self._priors(_nchw(z_sym), y_cond)
        decoded, off = [], 0
        for g in range(self.groups):
            maskbits = payload[off:off + seg_mask].view(b, n_g // 8)
            values = payload[off + seg_mask:off + seg_mask + seg_val].view(
                torch.int8).view(b, cap)
            off += seg_mask + seg_val
            ctx = torch.cat(decoded, dim=1) if decoded else None
            scales, means = self.module.group_params(priors, ctx, g)
            idx = build_indexes(scales.float(), self._scale_table)
            order = torch.argsort(_nhwc_flat(idx, b).long(), dim=1,
                                  stable=True)
            flat = _unpack_sparse(maskbits, values, order, b, n_g)
            y_hat_g = _nchw(flat.view(b, hgt, wid, gs).permute(0, 3, 1, 2))
            decoded.append(self._refine(priors, ctx, y_hat_g + means, g))
        return torch.cat(decoded, dim=1)

    # ---- compress ----------------------------------------------------------

    def _compress_sparse(self, y_cur, y_conditioned):
        """The sparse transport's strings and counts, or None when the frame
        overflows it (charm.py:334-379 there)."""
        b, m, hgt, wid = y_cur.shape
        zt = self.tables["entropy_bottleneck"]
        gt = self.tables["gaussian_conditional"]
        levels = self.levels
        z_shape = (b, -(-hgt // 4), -(-wid // 4), zt.rows)
        layout = transport.SparseLayout(
            b=b, n=hgt * wid * m, zn=int(np.prod(z_shape[1:])),
            levels=self.groups * levels, cap_value=(hgt * wid * m) // 4)
        with self._lap("charm.encode.device", "enc_device_s"):
            packed = trace.fetch(self.fused_encode_sparse_carry_expr(
                y_cur, y_conditioned)[0])
        with self._lap("charm.encode.host", "enc_host_s"):
            planes = transport.unpack_encode(packed, layout)
            if planes.overflow:
                return None
            z_idx = entropy_base.bottleneck_indexes(z_shape, zt.rows)
            z_strings = entropy_base.compress(planes.z_sym.reshape(z_shape),
                                              z_idx, zt, self.coder,
                                              stream="z")
            counts = planes.counts.reshape(b, self.groups, levels)
            y_strings = []
            for i in range(b):
                offs = np.concatenate([[0],
                                       np.cumsum(counts[i].sum(axis=-1))])
                y_strings.append([
                    transport.encode_grouped(
                        planes.y_sorted[i, offs[g]:offs[g + 1]][None],
                        counts[i, g][None], gt, self.coder)[0]
                    for g in range(self.groups)
                ])
        trace.count("transport.sparse")
        return {
            "strings": [y_strings, z_strings],
            "shape": tuple(z_shape[1:3]),
            "transport": "sparse",
            # the per-group CDF-row counts ride the container, so decode is
            # one device pass with no fetch
            "counts": counts,
        }

    @torch.no_grad()
    def compress(self, y_cur, y_conditioned,
                 transport_mode: str = "sparse") -> Dict[str, Any]:
        self._require_tables()
        b, m, hgt, wid = y_cur.shape
        self._check_latent(hgt, wid)
        if transport_mode == "sparse":
            enc = self._compress_sparse(y_cur, y_conditioned)
            if enc is not None:
                return enc
        zt = self.tables["entropy_bottleneck"]
        gt = self.tables["gaussian_conditional"]
        y_shape, z_shape = (b, hgt, wid, m), (b, hgt // 4, wid // 4, zt.rows)
        with self._lap("charm.encode.device", "enc_device_s"):
            packed = trace.fetch(self.fused_encode_carry_expr(
                y_cur, y_conditioned)[0])
        with self._lap("charm.encode.host", "enc_host_s"):
            y_sym, z_sym, idx = entropy_base.unpack_symbol_buffer(
                packed, y_shape, z_shape)
            z_idx = entropy_base.bottleneck_indexes(z_shape, zt.rows)
            z_strings = entropy_base.compress(z_sym.astype(np.int32), z_idx,
                                              zt, self.coder, stream="z")
            # one stream per group per element: the groups decode in
            # sequence, each plane in one host call
            gs = m // self.groups
            y_strings = []
            for i in range(b):
                y_strings.append([])
                for g in range(self.groups):
                    with trace.span("rans.y.encode"):
                        y_strings[i].append(self.coder.encode_with_indexes(
                            y_sym[i, ..., g * gs:(g + 1) * gs].astype(
                                np.int32).reshape(-1),
                            idx[i, ..., g * gs:(g + 1) * gs].reshape(-1),
                            gt.cdf, gt.cdf_length, gt.offset))
        trace.count("transport.dense")
        return {"strings": [y_strings, z_strings],
                "shape": tuple(z_shape[1:3]), "transport": "dense"}

    # ---- decompress --------------------------------------------------------

    @torch.no_grad()
    def decompress(self, strings, shape, y_conditioned,
                   transport_mode: str = "sparse",
                   counts=None) -> Dict[str, Any]:
        """``counts``: the container's (b, G, levels) per-group CDF-row
        counts, which enable the fetch-free decode."""
        if not (isinstance(strings, list) and len(strings) == 2):
            raise ValueError("strings must be [y_strings, z_strings]")
        self._require_tables()
        hgt, wid = 4 * shape[0], 4 * shape[1]
        if tuple(y_conditioned.shape[2:]) != (hgt, wid):
            raise ValueError(
                f"ẑ of {shape[0]}×{shape[1]} decodes a {hgt}×{wid} latent, "
                f"but y_conditioned is {tuple(y_conditioned.shape[2:])}")
        zt = self.tables["entropy_bottleneck"]
        b = len(strings[1])
        with self._lap("charm.decode.host", "dec_host_s"):
            z_idx = entropy_base.bottleneck_indexes((b, *shape, zt.rows),
                                                    zt.rows)
            z_sym = entropy_base.decompress(strings[1], z_idx, zt,
                                            self.coder, stream="z")
            z_dev = _to_nchw(z_sym, self.device)
            payload = None
            if transport_mode == "sparse" and counts is not None:
                payload = self._host_fetchfree(
                    strings[0], np.asarray(counts, np.int32), b, hgt, wid)
        if payload is not None:
            with self._lap("charm.decode.device", "dec_device_s"):
                target_hat = self.fused_decode_expr(
                    z_dev, trace.upload(torch.from_numpy(payload),
                                        self.device), y_conditioned)
            return {"y_hat": self._carry(target_hat, y_conditioned)}
        with self._lap("charm.priors", "dec_device_s"):
            priors = self._priors(z_dev, y_conditioned)
        if transport_mode == "sparse":
            decoded = self._decode_groups_sparse(strings[0], priors, b)
        else:
            decoded = self._decode_groups_dense(strings[0], priors, b)
        return {"y_hat": self._carry(torch.cat(decoded, dim=1),
                                     y_conditioned)}

    def _host_fetchfree(self, y_strings, counts, b, hgt, wid):
        """Host rANS of every group up front (the rows from the container's
        counts) into the fused decode's payload; None when a group's
        nonzeros exceed its values capacity n_g // 4 (the caller falls
        back to the per-group decode)."""
        gt = self.tables["gaussian_conditional"]
        cap = hgt * wid * self.module.group_size // 4
        segments = []
        for g in range(self.groups):
            group_strings = [y_strings[i][g] for i in range(b)]
            packed = transport.decode_grouped_packed(
                group_strings, counts[:, g], cap, gt, self.coder)
            if packed is not None:
                maskbits, values = packed
            else:  # a coder without the run path, or nonzeros over cap
                y_sorted = transport.decode_grouped(
                    group_strings, counts[:, g], gt, self.coder)
                if int((y_sorted != 0).sum(axis=-1).max()) > cap:
                    return None
                maskbits, values = transport.pack_decode_payload(y_sorted,
                                                                 cap)
            segments.append(maskbits.reshape(-1))
            segments.append(values.view(np.uint8).reshape(-1))
        return np.concatenate(segments)

    def _decode_groups_dense(self, y_strings, priors, b):
        """Per group: (σ, μ) on the device, its index plane fetched, host
        rANS, ŷ_g (charm.py:672-695 there)."""
        gt = self.tables["gaussian_conditional"]
        decoded = []
        for g in range(self.groups):
            with self._lap("charm.decode.params", "dec_device_s"):
                ctx = torch.cat(decoded, dim=1) if decoded else None
                scales, means = self._params_f32(priors, ctx, g)
                idx = build_indexes(scales, self._scale_table).to(
                    torch.uint8)
                idx_np = trace.fetch(idx.permute(0, 2, 3, 1)).astype(
                    np.int32)
            with self._lap("charm.decode.rans", "dec_host_s"):
                sym = np.empty(idx_np.shape, np.int32)
                for i in range(b):
                    with trace.span("rans.y.decode"):
                        sym[i] = self.coder.decode_with_indexes(
                            y_strings[i][g], idx_np[i].reshape(-1), gt.cdf,
                            gt.cdf_length, gt.offset,
                        ).reshape(idx_np.shape[1:])
            with self._lap("charm.decode.write", "dec_device_s"):
                y_hat_g = _to_nchw(sym, self.device).float() + means
                decoded.append(self._refine(priors, ctx, y_hat_g, g))
        return decoded

    def _decode_groups_sparse(self, y_strings, priors, b):
        """Per group: its G·levels counts computed on the device and
        fetched (the order and μ stay there), grouped host rANS, the
        bitmask and values uploaded (charm.py:697-732 there). The payload's
        capacity is the group's need rounded up to 4096 symbols, at least
        n_g // 4."""
        gt = self.tables["gaussian_conditional"]
        levels = self.levels
        decoded = []
        for g in range(self.groups):
            with self._lap("charm.decode.params", "dec_device_s"):
                ctx = torch.cat(decoded, dim=1) if decoded else None
                scales, means = self.module.group_params(priors, ctx, g)
                idx = build_indexes(scales.float(), self._scale_table)
                idx_flat = _nhwc_flat(idx, b).long()
                counts = torch.zeros((b, levels), dtype=torch.int32,
                                     device=self.device).scatter_add_(
                    1, idx_flat, torch.ones_like(idx_flat, dtype=torch.int32))
                counts = trace.fetch(counts)
                order = torch.argsort(idx_flat, dim=1, stable=True)
            with self._lap("charm.decode.rans", "dec_host_s"):
                y_sorted = transport.decode_grouped(
                    [y_strings[i][g] for i in range(b)], counts, gt,
                    self.coder)
                n_g = y_sorted.shape[1]
                nz_max = int((y_sorted != 0).sum(axis=-1).max())
                cap = min(max(n_g // 4, -(-max(nz_max, 1) // 4096) * 4096),
                          n_g)
                maskbits, values = transport.pack_decode_payload(y_sorted,
                                                                 cap)
            with self._lap("charm.decode.write", "dec_device_s"):
                flat = _unpack_sparse(
                    trace.upload(torch.from_numpy(maskbits), self.device),
                    trace.upload(torch.from_numpy(values), self.device),
                    order, b, n_g)
                _, gs, hgt, wid = means.shape
                y_hat_g = _nchw(flat.view(b, hgt, wid, gs).permute(
                    0, 3, 1, 2))
                decoded.append(self._refine(priors, ctx, y_hat_g + means, g))
        return decoded
