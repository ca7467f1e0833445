"""Inputs and weights, made from the seed on the run's device.

Weights: every parameter of the configuration's two models, drawn on the
device with one ``torch.Generator`` in one call per distribution (He
normal for the convolutions, uniform in [-0.5, 0.5) for the bottleneck's
biases and tanh factors; GDN and the bottleneck's matrices start where the
published layers start them), then the weight surgery that makes seeded
weights code like a converged model. Without it an untrained prior runs
near 9 bpp and every frame overflows the sparse transport.

The factors are drawn, not zero as the published layer starts them: with
zero factors the chain is linear, its logits at ±½ around the median sum
to 0, and the likelihood's sign trick (sign(0) = 0) reads 0 there, 30 bits
at the bound, on about a quarter of the channels. A trained bottleneck has
nonzero factors.

``realistic_stem`` and ``match_latent_to_prior`` are copies of the
program's ``eval/workload.py`` functions (themselves the JAX bench's
``realistic_stem`` and the latent matching of its serving probe), reworked
to act on a dict of tensors through the plain reference. ``structured_frames``
is a copy of that file's frame generator (tools/bakeoff.py's moving blocks
over a gradient), drawn the same way and drawn on the device.
"""

import math

import numpy as np
import torch

from . import reference as R

EB_CHAIN = (1,) + R.EB_FILTERS + (1,)


def _conv(name, o, i, k):
    return [(f"{name}.weight", (o, i, k, k), "he", k * k * i),
            (f"{name}.bias", (o,), "zero", 0)]


def _deconv(name, i, o, k):
    return [(f"{name}.weight", (i, o, k, k), "he", k * k * i),
            (f"{name}.bias", (o,), "zero", 0)]


def _gdn(name, c):
    return [(f"{name}.beta", (c,), "gdn_beta", 0),
            (f"{name}.gamma", (c, c), "gdn_gamma", 0)]


def _eb(name, c):
    out = []
    for i in range(len(EB_CHAIN) - 1):
        out.append((f"{name}.matrix{i}", (c, EB_CHAIN[i + 1], EB_CHAIN[i]),
                    "eb_matrix", EB_CHAIN[i + 1]))
        out.append((f"{name}.bias{i}", (c, EB_CHAIN[i + 1], 1), "uniform", 0))
        if i < len(EB_CHAIN) - 2:
            out.append((f"{name}.factor{i}", (c, EB_CHAIN[i + 1], 1),
                        "uniform", 0))
    out.append((f"{name}.quantiles", (c, 1, 3), "eb_quantiles", 0))
    return out


def i_model_specs(n, m):
    """MeanScaleHyperprior(N, M): g_a, g_s, h_a, h_s and its bottleneck, in
    the published layer order."""
    s = []
    chans = [3, n, n, n, m]
    for j in range(4):
        s += _conv(f"g_a.layers.{2 * j}", chans[j + 1], chans[j], 5)
        if j < 3:
            s += _gdn(f"g_a.layers.{2 * j + 1}", n)
    outs = [n, n, n, 3]
    ins = [m, n, n, n]
    for j in range(4):
        s += _deconv(f"g_s.layers.{2 * j}", ins[j], outs[j], 5)
        if j < 3:
            s += _gdn(f"g_s.layers.{2 * j + 1}", n)
    s += _conv("h_a.layers.0", n, m, 3) + _conv("h_a.layers.2", n, n, 5)
    s += _conv("h_a.layers.4", n, n, 5)
    s += _deconv("h_s.layers.0", n, m, 5)
    s += _deconv("h_s.layers.2", m, m * 3 // 2, 5)
    s += _conv("h_s.layers.4", m * 2, m * 3 // 2, 3)
    return s + _eb("entropy_bottleneck", n)


def stem_specs(variant, ebc, m):
    """SpatioTemporalPriorModel(variant, EB ebc, M m): HE, HD, TPM, the
    masked context conv where the variant has the spatial prior, EPM and the
    bottleneck."""
    s = _conv("HE.layers.0", 256, 2 * m, 3) + _conv("HE.layers.2", 256, 256, 5)
    s += _conv("HE.layers.4", ebc, 256, 5)
    s += _deconv("HD.layers.0", ebc, 256, 5) + _deconv("HD.layers.2", 256,
                                                       256, 5)
    s += _conv("HD.layers.4", 2 * m, 256, 3)
    s += _conv("TPM.layers.0", 256, m, 5) + _conv("TPM.layers.2", 320, 256, 5)
    s += _conv("TPM.layers.4", 2 * m, 320, 5)
    n_priors = 2
    if variant == "res":
        s += _conv("context_prediction", 2 * m, m, 5)
        n_priors = 3
    s += _conv("EPM.layers.0", 768, 2 * m * n_priors, 1)
    s += _conv("EPM.layers.2", 576, 768, 1) + _conv("EPM.layers.4", 2 * m, 576,
                                                    1)
    return s + _eb("entropy_bottleneck", ebc)


@torch.no_grad()
def draw(specs, gen, device):
    """The parameters of ``specs`` from ``gen``: one normal draw for every
    He-initialised tensor, one uniform draw for the bottleneck's biases and
    factors."""
    sizes = {k: sum(math.prod(sh) for _, sh, kind, _ in specs if kind == k)
             for k in ("he", "uniform")}
    normal = torch.randn(sizes["he"], generator=gen, device=device)
    uniform = torch.rand(sizes["uniform"], generator=gen, device=device) - 0.5
    pos = {"he": 0, "uniform": 0}
    chain_scale = R.EB_INIT_SCALE ** (1 / (len(R.EB_FILTERS) + 1))
    out = {}
    for name, shape, kind, arg in specs:
        if kind in pos:
            n = math.prod(shape)
            t = (normal if kind == "he" else uniform)[pos[kind]:pos[kind] + n]
            pos[kind] += n
            t = t.view(shape)
            out[name] = t * math.sqrt(2.0 / arg) if kind == "he" else t
        elif kind == "zero":
            out[name] = torch.zeros(shape, device=device)
        elif kind == "gdn_beta":
            out[name] = torch.full(shape, math.sqrt(1.0 + R.PEDESTAL),
                                   device=device)
        elif kind == "gdn_gamma":
            out[name] = torch.sqrt(0.1 * torch.eye(shape[0], device=device)
                                   + R.PEDESTAL)
        elif kind == "eb_matrix":
            out[name] = torch.full(shape, math.log(math.expm1(
                1 / chain_scale / arg)), device=device)
        elif kind == "eb_quantiles":
            q = torch.tensor([-R.EB_INIT_SCALE, 0.0, R.EB_INIT_SCALE],
                             device=device)
            out[name] = q.repeat(shape[0], 1, 1)
    return out


def eb_params(W, prefix="entropy_bottleneck"):
    """The bottleneck's parameters of W by their short names."""
    return {k[len(prefix) + 1:]: v for k, v in W.items()
            if k.startswith(prefix + ".")}


@torch.no_grad()
def realistic_stem(S, rng):
    """The surgery of the program's ``eval/workload.py::realistic_stem``:
    EPM's last layer emits 93 % of the scale channels at 0.05 (below the
    0.11 floor) and 7 % in [0.2, 1.8], means 0, its weights × 1e-3; HE's
    last layer × 1e-3; the bottleneck's chain narrowed and its quantiles
    solved. Three changes from the program's copy. Its HE bias is the
    bottleneck's medians, not 0: z then lies where the bottleneck's mass
    is, as a converged model's does (at 0 it sat in the far tail of every
    channel whose median is past ±½). The softplus of every chain matrix is
    0.56, not 0.8: z's median bin then costs about 0.35 bits, as the
    trained hero bottleneck's does (0.34 in f32), where at 0.8 z cost
    nothing and a lost z likelihood would not show. And where the copy
    draws each channel active with probability 0.07 and its scale
    log-uniform, here exactly round(0.07·M) channels are active and their
    scales are one log-spaced set, placed in a seeded order: every seed
    then codes at the same rate, so the seed moves no work."""
    bias = S["EPM.layers.4.bias"]
    m = bias.shape[0] // 2
    scales = np.full(m, 0.05, np.float32)
    k = round(0.07 * m)
    active = rng.choice(m, k, replace=False)
    scales[active] = rng.permutation(np.exp(np.linspace(np.log(0.2),
                                                        np.log(1.8), k)))
    bias.copy_(torch.from_numpy(np.concatenate(
        [scales, np.zeros(m, np.float32)])))
    S["EPM.layers.4.weight"].mul_(1e-3)
    S["HE.layers.4.weight"].mul_(1e-3)
    sp_inv = float(np.log(np.expm1(0.56)))
    for k in S:
        if k.startswith("entropy_bottleneck.matrix"):
            S[k].fill_(sp_inv)
    P = {k: v.cpu().numpy() for k, v in eb_params(S).items()}
    q = torch.from_numpy(R.solve_quantiles(P).astype(np.float32))
    S["entropy_bottleneck.quantiles"].copy_(q)
    S["HE.layers.4.bias"].copy_(q[:, 0, 1])


def medians(S):
    """The bottleneck's medians as f32, (1, C, 1, 1)."""
    return S["entropy_bottleneck.quantiles"][:, 0, 1].float().view(1, -1, 1,
                                                                    1)


@torch.no_grad()
def match_latent_to_prior(I, S, x, y_cond):
    """The program's ``eval/workload.py::match_latent_to_prior`` on the
    plain reference: rescale g_a's last conv per channel so that g_a(x) has
    the mean and standard deviation of y = μ + σ·ε under this STEM's own
    (σ, μ) from ẑ = round(HE(y_cond, y_cond)) (σ clipped to [0.11, 256]),
    over the batch and positions."""
    med = medians(S)
    z = R.he(S, y_cond, y_cond)
    z_hat = torch.round(z - med) + med
    scales, means = R.epm(S, R.priors(S, z_hat, y_cond))
    sigma = scales.double().abs().clamp(R.SCALES_MIN, R.SCALES_MAX)
    dims = (0, 2, 3)
    target_mean = means.double().mean(dims)
    target_std = ((sigma * sigma).mean(dims)
                  + means.double().var(dims, unbiased=False)).sqrt()
    y = R.g_a(I, x).double()
    factor = target_std / y.std(dims, unbiased=False)
    w, b = I["g_a.layers.6.weight"], I["g_a.layers.6.bias"]
    b.copy_(((b.double() - y.mean(dims)) * factor + target_mean).float())
    w.mul_(factor.view(-1, 1, 1, 1).float())


# ---- frames ------------------------------------------------------------------


def block_tracks(rng, h, w):
    """2-4 moving blocks (position, velocity, size, colour), drawn in the
    order of ``structured_frames``."""
    objs = []
    for _ in range(int(rng.integers(2, 5))):
        objs.append((rng.uniform(8, min(h, w) - 24, 2), rng.uniform(-3, 3, 2),
                     rng.integers(10, 36, 2), rng.uniform(0, 1, 3)))
    return objs


@torch.no_grad()
def structured_frames(rng, n_frames, hw, device):
    """n_frames (3, H, W) frames in [0, 1] of one sequence: a gradient
    background and moving blocks (a copy of the program's
    ``eval/workload.py::structured_frames``, drawn on the device and
    quantised to 8 bits as the copy's uint8 frames are)."""
    h, w = hw
    yy = torch.arange(h, device=device, dtype=torch.float32).view(h, 1)
    xx = torch.arange(w, device=device, dtype=torch.float32).view(1, w)
    base = torch.stack([(yy / h).expand(h, w), (xx / w).expand(h, w),
                        (xx + yy) / (h + w)], 0)
    base = 0.3 + 0.4 * base
    objs = block_tracks(rng, h, w)
    out = []
    for t in range(n_frames):
        img = base.clone()
        for pos, vel, size, color in objs:
            y0 = int(np.clip(pos[0] + t * vel[0], 0, h - 1))
            x0 = int(np.clip(pos[1] + t * vel[1], 0, w - 1))
            img[:, y0:y0 + int(size[0]), x0:x0 + int(size[1])] = torch.tensor(
                color, dtype=torch.float32, device=device).view(3, 1, 1)
        out.append(torch.floor(torch.clamp(img, 0, 1) * 255) / 255)
    return torch.stack(out)


def gop_frames(seed, streams, gop, hw, device):
    """(gop, streams, 3, H, W): one independent sequence per stream."""
    seqs = [structured_frames(np.random.default_rng([seed, s]), gop, hw,
                              device) for s in range(streams)]
    return torch.stack(seqs, 1)
