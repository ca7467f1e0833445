"""The serving benchmark's workload, rebuilt on the port's parameters.

``realistic_stem`` is the port's copy of the weight surgery in the JAX
package's bench.py::realistic_stem: a STEM whose entropy head emits the scale
statistics of a converged model (~93% of the scale channels below the 0.11 σ
floor, 7% log-uniform in [0.2, 1.8], means 0), a hyper-encoder whose output
is nearly constant, and a sharpened factorized prior with its quantiles
solved in closed form. Without it an untrained prior runs near 9 bpp and
every frame overflows the sparse transport.

``match_latent_to_prior`` does the same for the I-model's analysis
transform. bench.py (make_bench_encode) codes y = μ + σ·ε, ε ~ N(0, 1), with
(σ, μ) from this STEM's own entropy head, in place of g_a's output; random
g_a weights would instead give a latent spread of a few units, where a
converged model codes mostly zeros. The port's pipeline codes the real g_a,
so its last conv is rescaled channel by channel until the latent on the
given frame has the per-channel mean and standard deviation of that sampler.

``wavefront_y_cur`` is the wavefront bench's latent (bench.py:669-672): the
conditioning latent plus 0.2·ε, with g_a run on the pixel frame for its cost
and kept live, so the rate point is controlled.
"""

import numpy as np
import torch

from ..entropy.bottleneck import solve_quantiles
from ..entropy.gaussian import SCALES_MAX, SCALES_MIN


@torch.no_grad()
def realistic_stem(stem, rng_seed: int = 7):
    """Apply bench.py::realistic_stem's surgery to ``stem`` (a
    SpatioTemporalPriorModel of any variant: every one has EPM.layers[4] and
    HE.layers[4]), then rebuild its tables. Draws come from a NumPy
    generator seeded like bench.py's, so both packages get the same
    weights."""
    rng = np.random.default_rng(rng_seed)
    epm_last = stem.module.EPM.layers[4]
    m = epm_last.bias.shape[0] // 2  # 2M outputs: scales || means
    scales_bias = np.full(m, 0.05, np.float32)
    active = rng.random(m) < 0.07
    scales_bias[active] = np.exp(
        rng.uniform(np.log(0.2), np.log(1.8), active.sum())
    )
    means_bias = np.zeros(m, np.float32)
    epm_last.bias.copy_(torch.from_numpy(
        np.concatenate([scales_bias, means_bias])))
    epm_last.weight.mul_(1e-3)
    he_last = stem.module.HE.layers[4]
    he_last.weight.mul_(1e-3)
    he_last.bias.zero_()
    eb = stem.module.entropy_bottleneck
    sp_inv = np.log(np.expm1(0.8))  # softplus⁻¹(0.8): chain slope ≈ 26
    for name, p in eb.named_parameters():
        if name.startswith("matrix"):
            p.fill_(sp_inv)
    eb.quantiles.copy_(torch.from_numpy(
        solve_quantiles(eb.numpy_params()).astype(np.float32)))
    stem.update(force=True)
    return stem


@torch.no_grad()
def match_latent_to_prior(i_model, stem, x, y_cond) -> torch.Tensor:
    """Rescale g_a's last conv so that, per channel c, g_a(x) has the mean
    and standard deviation of bench.py's sampled latent μ + σ·ε: mean
    E[μ_c] and std sqrt(E[σ_c²] + Var[μ_c]), over the batch and positions,
    with σ = clip(|scales|, SCALES_MIN, SCALES_MAX) and (scales, μ) taken
    from ẑ = round(h_e(y_cond, y_cond)) as bench.py takes them. Returns the
    per-channel factor applied to the weights."""
    module = stem.module
    z = module.hyper_encode(y_cond, y_cond)
    z_hat = torch.round(z - stem._medians) + stem._medians
    scales, means = module.entropy_params(z_hat, y_cond)
    sigma = scales.double().abs().clamp(SCALES_MIN, SCALES_MAX)
    dims = (0, 2, 3)
    target_mean = means.double().mean(dims)
    target_std = ((sigma * sigma).mean(dims)
                  + means.double().var(dims, unbiased=False)).sqrt()
    y = i_model.module.g_a(x).double()
    factor = target_std / y.std(dims, unbiased=False)
    last = i_model.module.g_a.layers[-1]
    # y' = (y − E[y])·f + target_mean, folded into the conv
    new_bias = (last.bias.double() - y.mean(dims)) * factor + target_mean
    last.weight.mul_(factor.view(-1, 1, 1, 1).to(last.weight.dtype))
    last.bias.copy_(new_bias.to(last.bias.dtype))
    return factor


@torch.no_grad()
def wavefront_y_cur(i_model, x, y_cond, generator):
    """bench.py::_build_wavefront_server's y_cur: y_cond + 0.2·ε, ε ~ N(0, 1)
    drawn from ``generator`` on y_cond's device, plus 1e-30·mean(g_a(x)),
    which keeps the analysis transform on the encode path at its real cost
    without moving the latent."""
    y_ga = i_model.analysis(x)
    noise = torch.randn(y_cond.shape, generator=generator,
                        device=y_cond.device, dtype=y_cond.dtype)
    return y_cond + 0.2 * noise + 1e-30 * y_ga.float().mean()
