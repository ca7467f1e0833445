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

``tame_roi`` scales the ROI family's quality-map transforms down: at their
initialisation (the JAX package's, which the port draws) x̂ overflows f32.

``wavefront_y_cur`` is the wavefront bench's latent (bench.py:669-672): the
conditioning latent plus 0.2·ε, with g_a run on the pixel frame for its cost
and kept live, so the rate point is controlled.

The trained hero models (``load_hero``): the checkpoints the JAX package
trained and evaluated (tools/bakeoff.py::cmd_hero), read with no jax, and
the frames of their recorded evaluation (``hero_gop_set``,
``hero_1080p_frames``), made again with NumPy alone from the seeds of
tools/bakeoff.py; its frames went through PNG, which is lossless, so these
are the frames the JAX evaluation read.
"""

import json
from pathlib import Path

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
def tame_roi(module, scale: float = 0.1):
    """``module`` (an ROI-family module) with each SFT's γ and β convs and
    each SFTResblk's two convs scaled by ``scale``. At their initialisation
    the quality-map transforms multiply the latent by 1 + γ at every stage:
    y reaches about 200 at 64², and the decoder's IGDNs (x·sqrt(β + γ·x²))
    take x̂ past f32 (NaN), where no tolerance means anything. Tamed, y
    stays within about 6 and x̂ within about 4."""
    from ..layers import SFT, SFTResblk

    for m in module.modules():
        if isinstance(m, SFT):
            m.mlp_gamma.weight.mul_(scale)
            m.mlp_beta.weight.mul_(scale)
        elif isinstance(m, SFTResblk):
            m.conv_0.weight.mul_(scale)
            m.conv_1.weight.mul_(scale)
    return module


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


# ---- the trained hero models ------------------------------------------------

HERO_DIR = Path(__file__).resolve().parents[2] / "artifacts" / "trained" / \
    "hero"
HERO_EVAL_HW = 256  # tools/bakeoff.py:37, EVAL_HW
HERO_GOP = 12  # tools/bakeoff.py::_eval_cfg
HERO_1080P = (1088, 1920)  # tools/bakeoff.py::_serving_1080p


def structured_frames(rng, n_frames: int, hw):
    """Compressible moving content: a gradient background and 2-4 moving
    blocks, as (H, W, 3) uint8 frames; the port's copy of
    tools/bakeoff.py::_structured_frames (:46-74), draw for draw, without
    its sensor noise (off in every call there)."""
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([yy / h, xx / w, (xx + yy) / (h + w)], -1)
    base = 0.3 + 0.4 * base
    n_obj = rng.integers(2, 5)
    objs = []
    for _ in range(n_obj):
        objs.append({
            "pos": rng.uniform(8, min(h, w) - 24, 2),
            "vel": rng.uniform(-3, 3, 2),
            "size": rng.integers(10, 36, 2),
            "color": rng.uniform(0, 1, 3),
        })
    frames = []
    for t in range(n_frames):
        img = base.copy()
        for o in objs:
            y0 = int(np.clip(o["pos"][0] + t * o["vel"][0], 0, h - 1))
            x0 = int(np.clip(o["pos"][1] + t * o["vel"][1], 0, w - 1))
            img[y0:y0 + o["size"][0], x0:x0 + o["size"][1]] = o["color"]
        frames.append((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return frames


def hero_gop_set(n_seqs: int = 2, n_frames: int = 24):
    """The hero models' GOP eval set (tools/bakeoff.py::make_data,
    :109-116): ``n_seqs`` sequences of ``n_frames`` 256² frames from
    default_rng(99), as ``data.ArraySequence``s named seq0, seq1, … with
    GOP 12."""
    from ..data import ArraySequence

    rng = np.random.default_rng(99)
    return [ArraySequence(structured_frames(
        rng, n_frames, (HERO_EVAL_HW, HERO_EVAL_HW)), HERO_GOP, f"seq{i}")
        for i in range(n_seqs)]


def hero_1080p_frames():
    """The hero serving probe's frames (tools/bakeoff.py::_serving_1080p,
    :459-489): 4 frames of 1088×1920, uint8, from default_rng(1)."""
    return structured_frames(np.random.default_rng(1), 4, HERO_1080P)


def hero_config(hero_dir=HERO_DIR) -> dict:
    """hero.json: the configuration and the JAX package's figures."""
    with open(Path(hero_dir) / "hero.json") as f:
        return json.load(f)


def load_hero(hero_dir=HERO_DIR, device="cuda",
              variants=("res", "without_spm"), wavefront_tile=None):
    """The trained hero models, with no jax: {"i": MeanScaleHyperprior(N,
    M), variant: SpatioTemporalPriorModel(variant, EBC, M), …} from
    hero.json's config (N 128, M 192, EBC 128) and the checkpoints
    ckpt_{i,p_<variant>}_<λ>.pkl.gz beside it, each with its tables
    rebuilt by ``update(force=True)``, as tools/bakeoff.py::_load_i and
    _load_p do. The I checkpoint's leaves hold the params, then the codec
    tables: exactly as many leaves as the model has parameters are read as
    parameters, and the rest must be the tables' (eight, integer or f64)."""
    from ..convert import load_jax_leaves
    from ..models import MeanScaleHyperprior, SpatioTemporalPriorModel
    from ..training.checkpoints import load_checkpoint

    hero_dir = Path(hero_dir)
    cfg = hero_config(hero_dir)["config"]
    n, m, ebc, lmbda = cfg["N"], cfg["M"], cfg["EBC"], cfg["lmbda"]
    i_model = MeanScaleHyperprior(n, m, device=device)
    rest = load_jax_leaves(
        i_model.module,
        load_checkpoint(hero_dir / f"ckpt_i_{lmbda}.pkl.gz")["model"])
    kinds = [r.dtype.kind for r in rest]
    if len(rest) != 8 or any(k not in "if" for k in kinds) or \
            sum(r.dtype == np.float32 for r in rest):
        raise ValueError(f"the I checkpoint's leaves after the params are "
                         f"not its codec tables: {len(rest)} of dtypes "
                         f"{[str(r.dtype) for r in rest]}")
    models = {"i": i_model}
    for variant in variants:
        stem = SpatioTemporalPriorModel(
            variant=variant, entropy_bottleneck_channels=ebc, in_channels=m,
            wavefront_tile=wavefront_tile, device=device)
        rest = load_jax_leaves(stem.module, load_checkpoint(
            hero_dir / f"ckpt_p_{variant}_{lmbda}.pkl.gz")["params"])
        if rest:
            raise ValueError(f"{len(rest)} leaves left over in the "
                             f"{variant} checkpoint")
        models[variant] = stem
    for model in models.values():
        model.update(force=True)
    return models
