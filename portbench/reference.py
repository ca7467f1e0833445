"""The plain reference: the codec's mathematics in plain PyTorch and NumPy.

Imports nothing of the program and nothing of JAX. It follows the
published description (CompressAI's MeanScaleHyperprior transforms and
EntropyBottleneck, the STEM of SpatioTemporalPriorModel, its Gaussian
conditional and rANS coding) and recomputes from the weights alone every
table the codec derives. Each function names the rule it implements.

Precision: ``Precision`` runs every convolution and product in f32 with
TF32 off, the configurations' arithmetic, or in the control's lower
precision: TF32 (for the f32 cells) or fp8 e4m3 with a per-tensor scale on
both operands (for the bf16 cells).

The nets here issue the same PyTorch calls as the published layers (a
convolution, then its bias), so at f32 on one device they give the bits a
faithful implementation gives; where the codec's symbols depend on a
rounding, a faithful implementation therefore codes the same symbols.
"""

import contextlib
import math

import numpy as np
import scipy.special
import scipy.stats
import torch
import torch.nn.functional as F

SCALES_MIN, SCALES_MAX, SCALES_LEVELS = 0.11, 256.0, 64
LIKELIHOOD_BOUND = 1e-9
TAIL_MASS = 1e-9
EB_FILTERS = (3, 3, 3, 3)
EB_INIT_SCALE = 10.0
PEDESTAL = (2.0 ** -18) ** 2  # GDN's non-negative reparametrisation
BETA_MIN = 1e-6
LEAKY_SLOPE = 0.01
I16 = 32767.0
FP8_MAX = 448.0  # float8 e4m3's largest finite value


# ---- precision ---------------------------------------------------------------


class Precision:
    """How the reference's products run: "f32" (TF32 off), "tf32", or
    "fp8": operands and each layer's output held in e4m3 with a per-tensor
    scale (as a bf16 program holds them in bf16), products summed in f32."""

    def __init__(self, mode: str = "f32"):
        if mode not in ("f32", "tf32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    @contextlib.contextmanager
    def active(self):
        cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
        saved = cuda.allow_tf32, cudnn.allow_tf32
        cuda.allow_tf32 = cudnn.allow_tf32 = self.mode == "tf32"
        try:
            yield
        finally:
            cuda.allow_tf32, cudnn.allow_tf32 = saved

    def q(self, t):
        """An operand as this precision holds it."""
        if self.mode != "fp8":
            return t
        t = t.float()
        scale = FP8_MAX / t.abs().amax().clamp_min(1e-30)
        return (t * scale).to(torch.float8_e4m3fn).float() / scale


F32 = Precision("f32")


# ---- layers ------------------------------------------------------------------


def conv(x, w, b, stride, p: Precision = F32):
    """Conv2d with padding k//2 (CompressAI's ``conv``), then its bias."""
    out = F.conv2d(p.q(x), p.q(w), None, stride, w.shape[-1] // 2)
    return p.q(out + b.view(1, -1, 1, 1))


def deconv(x, w, b, stride, p: Precision = F32):
    """ConvTranspose2d(k, s, padding k//2, output_padding s−1): the output
    is exactly s times the input (CompressAI's ``deconv``), then its bias."""
    k = w.shape[-1]
    out = F.conv_transpose2d(p.q(x), p.q(w), None, stride, k // 2, stride - 1)
    return p.q(out + b.view(1, -1, 1, 1))


def leaky(x):
    """LeakyReLU with its slope rounded to x's dtype (the weakly typed
    constant of the JAX layers the program follows: bf16(0.01) in bf16)."""
    return F.leaky_relu(x, float(torch.tensor(LEAKY_SLOPE, dtype=x.dtype)))


def nonneg(v, minimum: float):
    """GDN's reparametrisation: max(v, √(min + pedestal))² − pedestal."""
    bound = (minimum + PEDESTAL) ** 0.5
    return torch.clamp_min(v, bound) ** 2 - PEDESTAL


def gdn(x, beta, gamma, inverse: bool, p: Precision = F32):
    """y = x / √(β + γ·x²) (inverse: x·√(…)), γ (out, in) (Ballé 2016;
    compressai/layers/gdn.py)."""
    beta_v = nonneg(beta, BETA_MIN)
    gamma_v = nonneg(gamma, 0.0)
    c = gamma_v.shape[0]
    norm = F.conv2d(p.q(x * x), p.q(gamma_v.view(c, c, 1, 1)))
    norm = norm + beta_v.view(1, -1, 1, 1)
    return p.q(x * (torch.sqrt(norm) if inverse else torch.rsqrt(norm)))


def g_a(W, x, p: Precision = F32, pre="g_a.layers"):
    """MeanScaleHyperprior's analysis: 4 × k5s2 conv with GDN between."""
    for i in (0, 2, 4):
        x = conv(x, W[f"{pre}.{i}.weight"], W[f"{pre}.{i}.bias"], 2, p)
        x = gdn(x, W[f"{pre}.{i + 1}.beta"], W[f"{pre}.{i + 1}.gamma"],
                False, p)
    return conv(x, W[f"{pre}.6.weight"], W[f"{pre}.6.bias"], 2, p)


def g_s(W, y, p: Precision = F32, pre="g_s.layers"):
    """The synthesis: 4 × k5s2 transposed conv with IGDN between, clamped
    to [0, 1] (the getX hook of STEM's trainer)."""
    for i in (0, 2, 4):
        y = deconv(y, W[f"{pre}.{i}.weight"], W[f"{pre}.{i}.bias"], 2, p)
        y = gdn(y, W[f"{pre}.{i + 1}.beta"], W[f"{pre}.{i + 1}.gamma"],
                True, p)
    x = deconv(y, W[f"{pre}.6.weight"], W[f"{pre}.6.bias"], 2, p)
    return torch.clamp(x, 0.0, 1.0)


# ---- STEM nets ---------------------------------------------------------------


def he(W, y_cur, y_cond, p: Precision = F32):
    """Hyper-encoder over cat(y_cur, y_cond): k3s1, k5s2, k5s2."""
    x = torch.cat([y_cur, y_cond], dim=1)
    x = leaky(conv(x, W["HE.layers.0.weight"], W["HE.layers.0.bias"], 1, p))
    x = leaky(conv(x, W["HE.layers.2.weight"], W["HE.layers.2.bias"], 2, p))
    return conv(x, W["HE.layers.4.weight"], W["HE.layers.4.bias"], 2, p)


def hd(W, z_hat, p: Precision = F32):
    x = leaky(deconv(z_hat, W["HD.layers.0.weight"], W["HD.layers.0.bias"],
                     2, p))
    x = leaky(deconv(x, W["HD.layers.2.weight"], W["HD.layers.2.bias"], 2,
                     p))
    return conv(x, W["HD.layers.4.weight"], W["HD.layers.4.bias"], 1, p)


def tpm(W, y_cond, p: Precision = F32):
    x = leaky(conv(y_cond, W["TPM.layers.0.weight"], W["TPM.layers.0.bias"],
                   1, p))
    x = leaky(conv(x, W["TPM.layers.2.weight"], W["TPM.layers.2.bias"], 1,
                   p))
    return conv(x, W["TPM.layers.4.weight"], W["TPM.layers.4.bias"], 1, p)


def priors(W, z_hat, y_cond, p: Precision = F32):
    """cat(TPM(y_cond), HD(ẑ)): the temporal and hyper priors."""
    return torch.cat([tpm(W, y_cond, p), hd(W, z_hat, p)], dim=1)


def epm(W, feats, p: Precision = F32):
    """The 1×1 entropy-parameters stack → (σ, μ), σ first."""
    x = leaky(conv(feats, W["EPM.layers.0.weight"], W["EPM.layers.0.bias"],
                   1, p))
    x = leaky(conv(x, W["EPM.layers.2.weight"], W["EPM.layers.2.bias"], 1,
                   p))
    out = conv(x, W["EPM.layers.4.weight"], W["EPM.layers.4.bias"], 1, p)
    return out.chunk(2, dim=1)


def epm_rows(W, rows, p: Precision = F32):
    """The same stack on (N, C) rows of one picture: a 1×1 conv is a
    product of the rows with the kernel's (out, in) matrix."""
    x = rows
    for i in (0, 2, 4):
        w = W[f"EPM.layers.{i}.weight"].flatten(1)
        x = p.q(F.linear(p.q(x), p.q(w)) + W[f"EPM.layers.{i}.bias"])
        if i < 4:
            x = leaky(x)
    return x.chunk(2, dim=1)


# the 12 causal taps of a 5×5 type-A mask: rows 0-1, then row 2 left of
# the centre (PixelCNN's raster-causal mask)
TAPS = tuple((h, w) for h in range(5) for w in range(5)
             if h < 2 or (h == 2 and w < 2))


def context(W, taps, p: Precision = F32):
    """The masked conv's output at a pixel from its causal taps (N, 12·M),
    tap-major: the product with the kernel's rows for those taps."""
    w = W["context_prediction.weight"]
    th = torch.tensor([t[0] for t in TAPS], device=w.device)
    tw = torch.tensor([t[1] for t in TAPS], device=w.device)
    wt = w[:, :, th, tw].transpose(1, 2).reshape(w.shape[0], -1)
    return p.q(torch.matmul(p.q(taps), p.q(wt).t())
               + W["context_prediction.bias"])


# ---- entropy bottleneck (Ballé 2018 factorized prior) ------------------------


def eb_logits_np(P, x):
    """The monotone CDF chain in float64 NumPy (softplus matrices, biases,
    tanh gates), x (C, 1, N)."""
    logits = x
    for i in range(len(EB_FILTERS) + 1):
        m = np.asarray(P[f"matrix{i}"], np.float64)
        b = np.asarray(P[f"bias{i}"], np.float64)
        logits = np.einsum("cof,cfn->con", np.logaddexp(0.0, m), logits) + b
        if i < len(EB_FILTERS):
            fac = np.asarray(P[f"factor{i}"], np.float64)
            logits = logits + np.tanh(fac) * np.tanh(logits)
    return logits


def eb_logits(P, x, p: Precision = F32):
    """The same chain in torch, x (C, 1, N)."""
    logits = x
    for i in range(len(EB_FILTERS) + 1):
        logits = p.q(torch.einsum("cof,cfn->con",
                                  p.q(F.softplus(P[f"matrix{i}"])),
                                  logits) + P[f"bias{i}"])
        if i < len(EB_FILTERS):
            logits = p.q(logits + torch.tanh(P[f"factor{i}"])
                         * torch.tanh(logits))
    return logits


def eb_likelihood(P, values, p: Precision = F32):
    """P(bin of each value) of the factorized prior, values (C, 1, N), with
    the sign trick and the likelihood bound."""
    lower = eb_logits(P, values - 0.5, p)
    upper = eb_logits(P, values + 0.5, p)
    sign = -torch.sign(lower + upper)
    lk = torch.abs(torch.sigmoid(sign * upper) - torch.sigmoid(sign * lower))
    return torch.clamp_min(lk, LIKELIHOOD_BOUND)


def solve_quantiles(P):
    """The quantiles where the chain's logits are (−t, 0, t), t = ln(2/tail
    − 1), by bisection in float64: the converged aux objective."""
    t = np.log(2.0 / TAIL_MASS - 1.0)
    targets = np.array([-t, 0.0, t])
    c = np.asarray(P["bias0"]).shape[0]
    lo = np.full((c, 1, 3), -1e4)
    hi = np.full((c, 1, 3), 1e4)
    for _ in range(90):
        mid = 0.5 * (lo + hi)
        low = eb_logits_np(P, mid) < targets[None, None, :]
        lo = np.where(low, mid, lo)
        hi = np.where(low, hi, mid)
    return 0.5 * (lo + hi)


# ---- coding tables -----------------------------------------------------------


def quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    """pmf (with its tail bucket) → integer CDF summing to 2^precision:
    rounded frequencies, renormalised by floor division, then each
    zero-width symbol steals one count from the smallest frequency above 1
    (compressai/cpp_exts/ops/ops.cpp:24-81)."""
    pmf = np.asarray(pmf, np.float64)
    n = pmf.shape[0]
    scale = 1 << precision
    cdf = np.zeros(n + 1, np.int64)
    cdf[1:] = np.floor(pmf * scale + 0.5).astype(np.int64)
    total = int(cdf.sum())
    cdf = np.cumsum((scale * cdf) // total)
    cdf[-1] = scale
    for i in np.nonzero(cdf[:-1] == cdf[1:])[0]:
        if cdf[i] != cdf[i + 1]:  # an earlier repair filled it
            continue
        freqs = cdf[1:] - cdf[:-1]
        cand = np.nonzero(freqs > 1)[0]
        best = cand[np.argmin(freqs[cand])]
        if best < i:
            cdf[best + 1:i + 1] -= 1
        else:
            cdf[i + 1:best + 1] += 1
    return cdf.astype(np.int32)


def _table_rows(pmfs, tails, lengths):
    out = np.zeros((len(lengths), int(lengths.max()) + 2), np.int32)
    for i, n in enumerate(lengths):
        row = quantized_cdf(np.concatenate([pmfs[i, :n], tails[i:i + 1]]))
        out[i, :row.shape[0]] = row
    return out


class Tables:
    """One entropy model's coding tables: cdf rows, their lengths, symbol
    offsets, and the medians (bottleneck) or the scale table (Gaussian)."""

    def __init__(self, cdf, length, offset, medians=None, scales=None):
        self.cdf, self.length, self.offset = cdf, length, offset
        self.medians, self.scales = medians, scales


def eb_tables(P) -> Tables:
    """EntropyBottleneck.update: integer support from the quantiles, pmf at
    ±½ around each integer, both tails as the escape bucket (float64)."""
    q = np.asarray(P["quantiles"], np.float64)
    med = q[:, 0, 1]
    lo = np.clip(np.ceil(med - q[:, 0, 0]).astype(np.int64), 0, None)
    hi = np.clip(np.ceil(q[:, 0, 2] - med).astype(np.int64), 0, None)
    length = lo + hi + 1
    samples = np.arange(int(length.max()))[None, None, :] + (med - lo)[:, None,
                                                                     None]
    lower = eb_logits_np(P, samples - 0.5)
    upper = eb_logits_np(P, samples + 0.5)
    sign = -np.sign(lower + upper)

    def sig(v):
        return 0.5 * (1.0 + np.tanh(0.5 * v))

    pmf = np.abs(sig(sign * upper) - sig(sign * lower))[:, 0, :]
    tail = sig(lower[:, 0, :1]) + sig(-upper[:, 0, -1:])
    return Tables(_table_rows(pmf, tail[:, 0], length),
                  (length + 2).astype(np.int32), (-lo).astype(np.int32),
                  medians=med)


def scale_table() -> np.ndarray:
    """64 log-spaced σ from 0.11 to 256 (CompressAI's mbt2018 scale table)."""
    return np.exp(np.linspace(math.log(SCALES_MIN), math.log(SCALES_MAX),
                              SCALES_LEVELS))


def gaussian_tables() -> Tables:
    """GaussianConditional.update: per σ a support of ±⌈σ·Φ⁻¹(1 − tail/2)⌉,
    pmf from Φ at the half-integers, the two tails as the escape bucket."""
    s = scale_table()
    center = np.ceil(s * -scipy.stats.norm.ppf(TAIL_MASS / 2)).astype(np.int64)
    length = 2 * center + 1
    samples = np.abs(np.arange(int(length.max()))[None, :]
                     - center[:, None]).astype(np.float64)

    def phi(v):
        return 0.5 * scipy.special.erfc(-(2 ** -0.5) * v)

    upper = phi((0.5 - samples) / s[:, None])
    lower = phi((-0.5 - samples) / s[:, None])
    return Tables(_table_rows(upper - lower, 2 * lower[:, 0], length),
                  (length + 2).astype(np.int32), (-center).astype(np.int32),
                  scales=s)


def cdf_index(sigma, table):
    """A σ's CDF row: #{entries of the table but its last below
    max(σ, 0.11)}, the table in σ's dtype."""
    t = torch.as_tensor(table, dtype=sigma.dtype, device=sigma.device)
    return torch.searchsorted(t[:-1].contiguous(),
                              torch.clamp_min(sigma, SCALES_MIN).contiguous())


def gaussian_likelihood(values, sigma):
    """P(round(v) | N(0, σ)) of mean-removed values, σ ≥ 0.11, bounded
    below by 1e-9."""
    s = torch.clamp_min(sigma, SCALES_MIN)
    v = torch.abs(values)
    c = -(2 ** -0.5)
    up = 0.5 * torch.special.erfc(c * (0.5 - v) / s)
    lo = 0.5 * torch.special.erfc(c * (-0.5 - v) / s)
    return torch.clamp_min(up - lo, LIKELIHOOD_BOUND)


def nhwc_flat(t):
    """NCHW (b, c, h, w) → (b, h·w·c): the wire's symbol order."""
    return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1)
