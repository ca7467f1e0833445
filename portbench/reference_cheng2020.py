"""The plain reference of Cheng2020-attn: the codec's mathematics in plain
PyTorch and NumPy.

Cheng, Sun, Takeuchi and Katto, "Learned Image Compression with Discretized
Gaussian Mixture Likelihoods and Attention Modules", CVPR 2020
(arXiv:2001.01568), as CompressAI defines it: ``Cheng2020Attention``
(compressai/models/waseda.py:29-138) over the blocks of
compressai/layers/layers.py:67-213, with mbt2018's context model and
entropy-parameters stack (compressai/models/priors.py:415-512).

Imports nothing of the program and nothing of JAX. It reuses
``reference.py``'s convolution, GDN, LeakyReLU, precision, coding tables and
masked context on the 12 causal taps, and ``rans.py``'s coder.

Departures from the published description, each noted where it lies:

- The paper codes y with a mixture of three discretised Gaussians;
  CompressAI's cheng2020 models, which this follows, code it with one
  mean-scale Gaussian, (σ, μ) from the entropy-parameters stack.
- y is coded in wavefront rounds (round 3·row + column, the rows of a
  round top first), not in raster order. The 12 taps of a 5×5 mask-A
  context lie on earlier rounds, so every pixel sees the context it sees in
  raster order and codes at the same rate; only the order of the symbols in
  the stream differs.
- Each convolution adds its bias after its sum (``reference.conv``), where
  ``nn.Conv2d`` folds it into cuDNN's sum: the last bit only.
- z's symbols round z − median in float64 on the host, as the codec's host
  coder does; CompressAI rounds in the model's dtype.
- Parameter names follow the program's modules: ``g_a.layers.<i>.conv1``
  for CompressAI's ``g_a.<i>.conv1``, and an attention block's residual
  units ``a_0`` … ``a_2``, ``b_0`` … ``b_2`` and last 1×1 conv ``b_out``
  for its ``conv_a.<i>.conv.<j>``, ``conv_b.<i>.conv.<j>`` and
  ``conv_b.3``.
"""

import numpy as np
import torch
import torch.nn.functional as F

from . import rans
from . import reference as R

F32 = R.F32

# the transforms' blocks in order (compressai/models/waseda.py:104-129)
G_A = ("rbws", "rb", "rbws", "attn", "rb", "rbws", "rb", "conv_s2", "attn")
G_S = ("attn", "rb", "rbu", "rb", "rbu", "attn", "rb", "rbu", "rb",
       "subpel_out")
# h_a (waseda.py:44-54): 3×3 convs at layers 0, 2, 4, 6, 8, strides below,
# LeakyReLU between; h_s (waseda.py:56-66): conv, sub-pixel, conv,
# sub-pixel, conv, LeakyReLU between
H_A_STRIDES = (1, 1, 2, 1, 2)
H_S = ("conv", "subpel", "conv", "subpel", "conv")


# ---- blocks (compressai/layers/layers.py) ------------------------------------


def _conv(x, W, name, stride=1, p=F32):
    """conv3x3 or conv1x1 (padding k//2), then its bias."""
    return R.conv(x, W[f"{name}.weight"], W[f"{name}.bias"], stride, p)


def _subpel(x, W, name, p=F32):
    """subpel_conv3x3 with r = 2 (layers.py:55-59): a 3×3 conv to 4× the
    channels, then PixelShuffle(2)."""
    return F.pixel_shuffle(_conv(x, W, f"{name}.conv", 1, p), 2)


def _gdn(x, W, name, inverse, p=F32):
    return R.gdn(x, W[f"{name}.beta"], W[f"{name}.gamma"], inverse, p)


def residual_block_with_stride(x, W, pre, p=F32):
    """conv3x3(s 2) → LeakyReLU → conv3x3 → GDN, plus the 1×1 stride-2
    skip (layers.py:67-98)."""
    out = _conv(R.leaky(_conv(x, W, f"{pre}.conv1", 2, p)), W,
                f"{pre}.conv2", 1, p)
    return _gdn(out, W, f"{pre}.gdn", False, p) + _conv(x, W, f"{pre}.skip",
                                                        2, p)


def residual_block(x, W, pre, p=F32):
    """conv3x3 → LeakyReLU → conv3x3 → LeakyReLU, plus x (layers.py:
    129-159; no skip conv where the widths agree, as they do here)."""
    out = R.leaky(_conv(x, W, f"{pre}.conv1", 1, p))
    return R.leaky(_conv(out, W, f"{pre}.conv2", 1, p)) + x


def residual_block_upsample(x, W, pre, p=F32):
    """subpel_conv3x3 → LeakyReLU → conv3x3 → IGDN, plus the sub-pixel
    ``upsample`` (layers.py:101-126)."""
    out = _conv(R.leaky(_subpel(x, W, f"{pre}.subpel_conv", p)), W,
                f"{pre}.conv", 1, p)
    return _gdn(out, W, f"{pre}.igdn", True, p) + _subpel(
        x, W, f"{pre}.upsample", p)


def _unit(x, W, pre, p=F32):
    """The attention block's ResidualUnit: conv1x1 (N/2) → ReLU → conv3x3
    (N/2) → ReLU → conv1x1 (N), plus x, ReLU (layers.py:177-196)."""
    out = torch.relu(_conv(x, W, f"{pre}.conv_0", 1, p))
    out = torch.relu(_conv(out, W, f"{pre}.conv_1", 1, p))
    return torch.relu(_conv(out, W, f"{pre}.conv_2", 1, p) + x)


def attention_block(x, W, pre, p=F32):
    """x + a · sigmoid(b): a three residual units, b three more and a
    conv1x1 (layers.py:162-213)."""
    a = b = x
    for i in range(3):
        a = _unit(a, W, f"{pre}.a_{i}", p)
        b = _unit(b, W, f"{pre}.b_{i}", p)
    return x + a * torch.sigmoid(_conv(b, W, f"{pre}.b_out", 1, p))


BLOCKS = {
    "rbws": residual_block_with_stride,
    "rb": residual_block,
    "rbu": residual_block_upsample,
    "attn": attention_block,
    "conv_s2": lambda x, W, pre, p: _conv(x, W, pre, 2, p),
    "subpel_out": _subpel,
}


# ---- the transforms ----------------------------------------------------------


def g_a(W, x, p=F32):
    """The analysis transform, x (B, 3, H, W) → y (B, N, H/16, W/16)."""
    for i, kind in enumerate(G_A):
        x = BLOCKS[kind](x, W, f"g_a.layers.{i}", p)
    return x


def g_s(W, y, p=F32, clamp=True):
    """The synthesis transform, clamped to [0, 1] as ``decompress`` clamps
    it (waseda.py's decompress: ``g_s(y_hat).clamp_(0, 1)``)."""
    for i, kind in enumerate(G_S):
        y = BLOCKS[kind](y, W, f"g_s.layers.{i}", p)
    return torch.clamp(y, 0.0, 1.0) if clamp else y


def h_a(W, y, p=F32):
    x = y
    for j, stride in enumerate(H_A_STRIDES):
        x = _conv(x, W, f"h_a.layers.{2 * j}", stride, p)
        if j < len(H_A_STRIDES) - 1:
            x = R.leaky(x)
    return x


def h_s(W, z_hat, p=F32):
    """(B, 2N, 4h, 4w): the hyper-synthesis, its output the rows the
    entropy parameters read beside the context."""
    x = z_hat
    for j, kind in enumerate(H_S):
        name = f"h_s.layers.{2 * j}"
        x = _subpel(x, W, name, p) if kind == "subpel" else _conv(
            x, W, name, 1, p)
        if j < len(H_S) - 1:
            x = R.leaky(x)
    return x


def ep_rows(W, rows, p=F32):
    """The 1×1 entropy-parameters stack (768 → 640 → 512 → 384 at M = 192)
    on (N, 4M) rows, cat(h_s row, context): each 1×1 conv a product with
    its (out, in) matrix, then its bias. Returns (σ, μ), σ first."""
    x = rows
    for i in (0, 2, 4):
        w = W[f"entropy_parameters.layers.{i}.weight"].flatten(1)
        x = p.q(F.linear(p.q(x), p.q(w))
                + W[f"entropy_parameters.layers.{i}.bias"])
        if i < 4:
            x = R.leaky(x)
    return x.chunk(2, dim=1)


# ---- tables ------------------------------------------------------------------


class Ref:
    """The weights (f32 on the run's device) and the coding tables the
    reference derives from them: the bottleneck's (``zt``, with its float64
    medians) and the Gaussian conditional's (``gt``)."""

    def __init__(self, W, cfg):
        self.W, self.cfg = W, cfg
        pre = "entropy_bottleneck."
        self.zt = R.eb_tables({k[len(pre):]: v.float().cpu().numpy()
                               for k, v in W.items() if k.startswith(pre)})
        self.gt = R.gaussian_tables()
        self.table = torch.as_tensor(self.gt.scales, dtype=torch.float32,
                                     device=W["entropy_parameters.layers.0."
                                              "weight"].device)


# ---- the autoregressive rounds -----------------------------------------------


def wavefront_rounds(h, w):
    """The pixels of an h×w latent by round 3·row + column, each round's
    rows top first: the order of the symbols in a y stream."""
    rounds = {}
    for i in range(h):
        for j in range(w):
            rounds.setdefault(3 * i + j, []).append((i, j))
    return [rounds[t] for t in sorted(rounds)]


class Plane:
    """One picture's ŷ as coded so far, NHWC, padded by 2 with zeros (the
    masked convolution's padding), and its h_s rows; ``params`` gives the
    (σ, μ) of a round's pixels from their 12 causal taps."""

    def __init__(self, ref, params_nchw, p=F32):
        self.ref, self.p = ref, p
        _, _, h, w = params_nchw.shape
        self.m = ref.W["context_prediction.weight"].shape[1]
        self.priors = params_nchw.permute(0, 2, 3, 1)[0]
        self.plane = torch.zeros((h + 4, w + 4, self.m),
                                 device=params_nchw.device)
        dev = self.plane.device
        self.dh = torch.tensor([t[0] for t in R.TAPS], device=dev)
        self.dw = torch.tensor([t[1] for t in R.TAPS], device=dev)

    def params(self, pixels):
        """(rows, columns, σ, μ, CDF rows) of ``pixels``, each (L, M)."""
        dev = self.plane.device
        hh = torch.tensor([q[0] for q in pixels], device=dev)
        ww = torch.tensor([q[1] for q in pixels], device=dev)
        taps = self.plane[hh[:, None] + self.dh, ww[:, None] + self.dw, :]
        ctx = R.context(self.ref.W, taps.reshape(len(pixels), -1), self.p)
        sigma, mu = ep_rows(self.ref.W, torch.cat([self.priors[hh, ww], ctx],
                                                  1), self.p)
        sigma, mu = sigma.float(), mu.float()
        return hh, ww, sigma, mu, R.cdf_index(sigma, self.ref.table)

    def write(self, hh, ww, values):
        self.plane[hh + 2, ww + 2, :] = values

    def y_hat(self):
        """ŷ (1, M, h, w)."""
        return self.plane[2:-2, 2:-2, :].permute(2, 0, 1)[None].contiguous()


def z_symbols(ref, z):
    """round(z − median) in float64 on the host, (C, h, w) int64, and ẑ
    (1, C, h, w) f32 on z's device. z (1, C, h, w)."""
    med = ref.zt.medians[:, None, None]
    zs = np.clip(np.round(z[0].double().cpu().numpy() - med), -(1 << 30),
                 1 << 30).astype(np.int64)
    return zs, z_hat_of(ref, zs, z.device)


def z_hat_of(ref, zs, device):
    return torch.from_numpy((zs + ref.zt.medians[:, None, None])
                            .astype(np.float32))[None].to(device)


@torch.no_grad()
def ar_encode(ref, y, params, p=F32):
    """One picture's y (1, M, h, w) against its h_s rows (1, 2M, h, w):
    the symbols round(y − μ) and their CDF rows in stream order, ŷ, and
    max |μ|."""
    _, m, h, w = y.shape
    pl = Plane(ref, params, p)
    target = y[0].permute(1, 2, 0)
    syms, rows, mu_max = [], [], 1e-30
    for pixels in wavefront_rounds(h, w):
        hh, ww, _, mu, idx = pl.params(pixels)
        sym = torch.round(target[hh, ww, :] - mu)
        pl.write(hh, ww, sym + mu)
        mu_max = max(mu_max, float(mu.abs().max()))
        syms.append(sym.reshape(-1))
        rows.append(idx.reshape(-1))
    return (torch.cat(syms).to(torch.int64).cpu().numpy(),
            torch.cat(rows).cpu().numpy(), pl.y_hat(), mu_max)


@torch.no_grad()
def ar_decode(ref, y_string, zs, device, p=F32):
    """One picture's y stream decoded against h_s of ẑ = ``zs`` + medians,
    round by round, each round's CDF rows from the reference's own (σ, μ)
    on what it decoded before: (ŷ (1, M, h, w), max |μ|)."""
    params = h_s(ref.W, z_hat_of(ref, zs, device), p)
    _, _, h, w = params.shape
    pl = Plane(ref, params, p)
    dec = rans.Decoder(y_string, ref.gt)
    mu_max = 1e-30
    for pixels in wavefront_rounds(h, w):
        hh, ww, _, mu, idx = pl.params(pixels)
        mu_max = max(mu_max, float(mu.abs().max()))
        sym = dec.decode(idx.reshape(-1).cpu().numpy())
        pl.write(hh, ww, torch.from_numpy(sym).to(device).float()
                 .view(mu.shape) + mu)
    return pl.y_hat(), mu_max


@torch.no_grad()
def encode(ref, x, p=F32):
    """One picture x (1, 3, H, W) coded by the reference: (y, its z
    symbols, the y stream, the z stream, ŷ)."""
    y = g_a(ref.W, x, p)
    zs, z_hat = z_symbols(ref, h_a(ref.W, y, p))
    syms, rows, y_hat, _ = ar_encode(ref, y, h_s(ref.W, z_hat, p), p)
    z_rows = np.repeat(np.arange(zs.shape[0]), zs[0].size)
    return (y, zs, rans.encode(syms, rows, ref.gt),
            rans.encode(zs.reshape(-1), z_rows, ref.zt), y_hat)
