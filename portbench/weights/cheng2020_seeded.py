"""Seeded weights of Cheng2020-attn, then the benchmark's own surgery, so
that a picture codes like a trained quality-6 model.

Every parameter of the program's ``Cheng2020AttentionModule`` is drawn on
the device with the run's generator, in the module's parameter order, one
call per distribution (``workload.draw``): He-normal kernels as the
published layers start them, GDN and the bottleneck's matrices at their
published initial values, the bottleneck's biases and tanh factors uniform
in [-0.5, 0.5), and every other bias uniform in [-0.1, 0.1) (zeros, the
published start, would hide where a bias is added).

The surgery, each step with its reason:

1. Taming (``tests/torch_port_util.py::tame``'s rule): every kernel × 0.7,
   g_s's × 0.49. Seeded, the model grows without bound (x̂ reaches
   1e9-1e19, where no f32 tolerance means anything).
2. z: h_a's last kernel × 1e-3 and its bias at the bottleneck's medians,
   the bottleneck's chain at softplus 0.56 and its quantiles solved: z
   lies at the medians, where a converged bottleneck puts its mass, and
   each z symbol costs about 0.35 bits (``workload.realistic_stem``'s z).
3. y: the configuration's ``active_channels`` channels (drawn from the
   seed) get scales log-spaced over ``active_scales``, each moved to the
   geometric middle between two entries of the scale table (so that no
   last bit moves a CDF row); the others are dead, at scale 0.05 (under
   the table's 0.11 floor), as most of a trained model's channels are.
   g_a's latent is then rescaled per channel, on the first picture of
   every stream through the plain reference, so that an active channel's
   standard deviation is its scale and a dead channel's root mean square
   is 0.03 (its symbols all 0). The rescale is exact: g_a ends in a 3×3
   conv and an attention block, and scaling that conv's output channel c by
   f_c > 0, each residual unit's last conv's output c by f_c and every 1×1
   conv that reads those channels (the units' first convs, ``b_out``) by
   1/f_c scales the block's output channel c by f_c (ReLU commutes with a
   positive scale). The entropy-parameters stack's last kernel × 1e-3 and
   its bias (σ, μ) = (the scale, f_c times the channel's mean): the
   context and hyperprior compute in full but move (σ, μ) by about 1e-3,
   as the STEM's surgery does.
4. x̂: g_s's last sub-pixel conv is rescaled per colour so that x̂ before
   its clamp has mean 0.5 and standard deviation 0.2 over those pictures:
   x̂ stays finite and of order 1, and few pixels reach the clamp, so the
   judge's ``g_s`` compares numbers the clamp has not flattened.
"""

import math
from types import SimpleNamespace

import numpy as np
import torch

from portbench import reference as R
from portbench import reference_cheng2020 as RC
from portbench import workload as WL

TAME, TAME_G_S = 0.7, 0.49
BIAS_SCALE = 0.2  # uniform [-0.5, 0.5) → [-0.1, 0.1)
EP_SCALE = 1e-3
H_A_SCALE = 1e-3
CHAIN_SOFTPLUS = 0.56
DEAD_SCALE, DEAD_RMS = 0.05, 0.03
X_MEAN, X_STD = 0.5, 0.2


# ---- the parameters ------------------------------------------------------------


def _conv(name, o, i, k):
    return [(f"{name}.weight", (o, i, k, k), "he", k * k * i),
            (f"{name}.bias", (o,), "uniform", 0)]


def _block(kind, pre, n, cin):
    if kind == "rbws":
        return (_conv(f"{pre}.conv1", n, cin, 3) + _conv(f"{pre}.conv2", n, n, 3)
                + WL._gdn(f"{pre}.gdn", n) + _conv(f"{pre}.skip", n, cin, 1))
    if kind == "rb":
        return _conv(f"{pre}.conv1", n, n, 3) + _conv(f"{pre}.conv2", n, n, 3)
    if kind == "rbu":
        return (_conv(f"{pre}.subpel_conv.conv", 4 * n, n, 3)
                + _conv(f"{pre}.conv", n, n, 3) + WL._gdn(f"{pre}.igdn", n)
                + _conv(f"{pre}.upsample.conv", 4 * n, n, 3))
    if kind == "attn":
        s = []
        for unit in ("a_0", "a_1", "a_2", "b_0", "b_1", "b_2"):
            s += (_conv(f"{pre}.{unit}.conv_0", n // 2, n, 1)
                  + _conv(f"{pre}.{unit}.conv_1", n // 2, n // 2, 3)
                  + _conv(f"{pre}.{unit}.conv_2", n, n // 2, 1))
        return s + _conv(f"{pre}.b_out", n, n, 1)
    if kind == "conv_s2":
        return _conv(pre, n, n, 3)
    if kind == "subpel_out":
        return _conv(f"{pre}.conv", 12, n, 3)
    raise ValueError(kind)


def specs(n):
    """Cheng2020-attn at N = M = n: g_a, g_s, h_a, h_s, the entropy
    parameters, the context model and the bottleneck, in the program's
    parameter order."""
    s = []
    for i, kind in enumerate(RC.G_A):
        s += _block(kind, f"g_a.layers.{i}", n, 3 if i == 0 else n)
    for i, kind in enumerate(RC.G_S):
        s += _block(kind, f"g_s.layers.{i}", n, n)
    for j in range(len(RC.H_A_STRIDES)):
        s += _conv(f"h_a.layers.{2 * j}", n, n, 3)
    n3 = n * 3 // 2
    for j, (kind, o, i) in enumerate(zip(RC.H_S, (n, n, n3, n3, 2 * n),
                                         (n, n, n, n3, n3))):
        name = f"h_s.layers.{2 * j}"
        s += (_conv(f"{name}.conv", 4 * o, i, 3) if kind == "subpel"
              else _conv(name, o, i, 3))
    widths = (4 * n, n * 10 // 3, n * 8 // 3, n * 6 // 3)
    for j in range(3):
        s += _conv(f"entropy_parameters.layers.{2 * j}", widths[j + 1],
                   widths[j], 1)
    s += _conv("context_prediction", 2 * n, n, 5)
    return s + WL._eb("entropy_bottleneck", n)


# ---- the surgery ---------------------------------------------------------------


def tame(W):
    for k, v in W.items():
        if k.startswith("entropy_bottleneck."):
            continue
        if k.endswith(".weight"):
            v.mul_(TAME_G_S if k.startswith("g_s.") else TAME)
        elif k.endswith(".bias"):
            v.mul_(BIAS_SCALE)


def hyper(W):
    """z at the bottleneck's medians, its chain narrowed, its quantiles
    solved (step 2)."""
    last = f"h_a.layers.{2 * (len(RC.H_A_STRIDES) - 1)}"
    W[f"{last}.weight"].mul_(H_A_SCALE)
    sp_inv = math.log(math.expm1(CHAIN_SOFTPLUS))
    for k in W:
        if k.startswith("entropy_bottleneck.matrix"):
            W[k].fill_(sp_inv)
    P = {k: v.cpu().numpy() for k, v in WL.eb_params(W).items()}
    q = torch.from_numpy(R.solve_quantiles(P).astype(np.float32))
    W["entropy_bottleneck.quantiles"].copy_(q)
    W[f"{last}.bias"].copy_(q[:, 0, 1])


def channel_scales(n, k, lo, hi, rng):
    """(σ per channel, active mask): k channels drawn from rng with scales
    log-spaced over [lo, hi] in a drawn order, each moved to the nearest
    geometric middle of two scale-table entries; the rest at DEAD_SCALE."""
    table = R.scale_table()
    mids = np.sqrt(table[:-1] * table[1:])
    want = rng.permutation(np.exp(np.linspace(np.log(lo), np.log(hi), k)))
    near = np.abs(np.log(mids)[None, :] - np.log(want)[:, None]).argmin(1)
    sigma = np.full(n, DEAD_SCALE)
    active = np.zeros(n, bool)
    idx = rng.choice(n, k, replace=False)
    sigma[idx], active[idx] = mids[near], True
    return sigma, active


def scale_latent(W, f):
    """g_a's output channel c × f_c, exactly (step 3)."""
    i_conv, i_attn = len(RC.G_A) - 2, len(RC.G_A) - 1
    assert RC.G_A[i_conv:] == ("conv_s2", "attn")
    col, row = f.view(1, -1, 1, 1), f.view(-1, 1, 1, 1)
    conv, attn = f"g_a.layers.{i_conv}", f"g_a.layers.{i_attn}"
    W[f"{conv}.weight"].mul_(row)
    W[f"{conv}.bias"].mul_(f)
    for unit in ("a_0", "a_1", "a_2", "b_0", "b_1", "b_2"):
        W[f"{attn}.{unit}.conv_0.weight"].div_(col)
        W[f"{attn}.{unit}.conv_2.weight"].mul_(row)
        W[f"{attn}.{unit}.conv_2.bias"].mul_(f)
    W[f"{attn}.b_out.weight"].div_(col)


def _moments(ts, dims):
    """Mean and standard deviation over ``dims`` of every tensor in ts, in
    float64."""
    s1 = sum(t.double().sum(dims) for t in ts)
    s2 = sum((t.double() ** 2).sum(dims) for t in ts)
    count = sum(t.numel() // s1.numel() for t in ts)
    mean = s1 / count
    return mean, (s2 / count - mean ** 2).clamp_min(0).sqrt()


def latent(W, x, cfg, rng):
    """Scales, dead channels and the latent's rescale (step 3); returns
    the rescaled latents of the pictures x and μ."""
    n = cfg["N"]
    ys = [RC.g_a(W, x[i:i + 1]) for i in range(x.shape[0])]
    mean, std = _moments(ys, (0, 2, 3))
    sigma, active = channel_scales(n, cfg["active_channels"],
                                   *cfg["active_scales"], rng)
    sigma = torch.from_numpy(sigma).to(mean)
    active = torch.from_numpy(active).to(mean.device)
    rms = (std ** 2 + mean ** 2).sqrt()
    f = torch.where(active, sigma / std.clamp_min(1e-30),
                    DEAD_RMS / rms.clamp_min(1e-30))
    scale_latent(W, f.float())
    mu = (f * mean).float()
    ep = "entropy_parameters.layers.4"
    W[f"{ep}.weight"].mul_(EP_SCALE)
    W[f"{ep}.bias"].copy_(torch.cat([sigma.float(), mu]))
    return [y * f.float().view(1, -1, 1, 1) for y in ys], mu


def synthesis(W, ys, mu):
    """x̂ before its clamp at mean X_MEAN, deviation X_STD per colour
    (step 4), measured on ŷ = round(y − μ) + μ."""
    last = f"g_s.layers.{len(RC.G_S) - 1}.conv"
    m = mu.view(1, -1, 1, 1)
    xs = [RC.g_s(W, torch.round(y - m) + m, clamp=False) for y in ys]
    mean, std = _moments(xs, (0, 2, 3))
    a = (X_STD / std.clamp_min(1e-30)).repeat_interleave(4).float()
    b = (X_MEAN - X_STD * mean / std.clamp_min(1e-30)).repeat_interleave(4)
    W[f"{last}.weight"].mul_(a.view(-1, 1, 1, 1))
    W[f"{last}.bias"].mul_(a).add_(b.float())


@torch.no_grad()
def make(cfg, frames, seed, gen, device):
    W = WL.draw(specs(cfg["N"]), gen, device)
    tame(W)
    hyper(W)
    ys, mu = latent(W, frames[0], cfg, np.random.default_rng([seed, 24]))
    synthesis(W, ys, mu)
    return SimpleNamespace(W=W)
