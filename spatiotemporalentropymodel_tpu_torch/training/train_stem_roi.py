"""Joint I+P training: the single-rate baseline and the variable-rate ROI
recipes (stem_roi/train_stem_roi.py parity).

Counterpart of spatiotemporalentropymodel_tpu/training/train_stem_roi.py:

  * mode="baseline" (:109-391): the mbt2018-mean I-codec
    (MeanScaleHyperpriorModule(128, 192)) and the stem_baselinev2 P-codec,
    the rate-distortion loss at one λ;
  * mode="roi" (:394-716): stem_roi_i and stem_roi with a synthesized
    quality map (data/qmap.py) and the pixelwise rate-distortion loss
    (λ-map = quality2lambda(qmap)).

Both condition each P-frame on the previous *reconstruction*, not
detached (:548-550), and take one optimizer step per sequence (:628-631).
``guard="per_frame"`` takes each frame's gradient on its own (the
reference's backward per frame with ``retain_graph``; the JAX package
recomputes the history with the same noise, which gives the same values),
masked by a running validity flag: a frame whose loss is NaN, Inf or above
``loss_threshold`` breaks the GOP, and it and every later frame add
nothing (:526-529, 554-557); the gradients are summed with NaN and Inf
zeroed. ``guard="none"`` takes one gradient of the whole sequence's summed
loss. The gradients, clip and updates are the port's train-step machinery
(parallel/train_step.py).

Runs on ``config.device`` (``cuda`` unless ``device="cpu"``); with no card
and no ``device="cpu"`` it raises. Synthetic batches of 3 frames from a
NumPy seed when ``data_root`` is None (the JAX package's for the same
seed), Vimeo-90k septuplets otherwise. As in the JAX package, ``resume``
and ``data_parallel`` are not read, and a checkpoint is written at the
end.

    python -m spatiotemporalentropymodel_tpu_torch.training.train_stem_roi \\
        --device cuda --mode roi --workdir runs/train_stem_roi
"""

import os
import random
from typing import Optional

import numpy as np
import torch

from ..data import VimeoSepTuplet, batch_iterator, synthesize_qmap
from ..models import StemBaselineModule, StemROIModule
from ..models.priors import MeanScaleHyperpriorModule
from ..parallel import init_train_state
from ..parallel.train_step import _detached, _grads, _Stepper
from ..utils.config import TrainStemRoiConfig
from .checkpoints import CheckpointManager
from .logging import MetricsLogger
from .losses import (
    pixelwise_rate_distortion_loss,
    quality2lambda,
    rate_distortion_loss,
)
from .optimizers import configure_optimizers
from .train_image import check_on, nchw, synthetic_batches, training_device

MODES = ("roi", "baseline")
GUARDS = ("per_frame", "none")
EVAL_LEVELS = (0, 25, 50, 75, 100)  # train_stem_roi.py:452-457


def _losses_fn(mode: str, lmbda: float):
    """loss(out, target, λ-map) of the mode: the pixelwise loss on the
    λ-map (roi), else the rate-distortion loss at ``lmbda``."""
    if mode == "roi":
        return lambda out, x, lmap: pixelwise_rate_distortion_loss(out, x,
                                                                   lmap)
    return lambda out, x, lmap: rate_distortion_loss(out, x, lmbda)


def run_sequence(i_module, p_module, frames, qmap, generator, mode: str,
                 lmbda: float, train: bool = True):
    """The loss dicts of frames 0..T-1 of ``frames`` (B, T, 3, H, W): frame
    0 through the I-model, each later one through the P-model conditioned
    on the previous reconstruction, not detached. ``qmap`` (B, 1, H, W)
    conditions both models and gives the λ-map in ROI mode."""
    use_qmap = mode == "roi"
    loss = _losses_fn(mode, lmbda)
    lmap = quality2lambda(qmap) if use_qmap else None
    extra = (qmap,) if use_qmap else ()
    x0 = frames[:, 0]
    out = i_module(x0, *extra, train=train, generator=generator)
    losses = [loss(out, x0, lmap)]
    for t in range(1, frames.shape[1]):
        x = frames[:, t]
        out = p_module(x, out["x_hat"], *extra, train=train,
                       generator=generator)
        losses.append(loss(out, x, lmap))
    return losses


def make_joint_sequence_step(i_module, p_module, optimizers_i, optimizers_p,
                             mode: str = "roi", loss_threshold: float = 3.0,
                             guard: str = "per_frame", lmbda: float = 1e-2):
    """step(state_i, state_p, frames (B, T, 3, H, W), qmap (B, 1, H, W),
    generator) → (state_i, state_p, metrics). ``lmbda`` applies in the
    baseline (single-rate) mode; the ROI mode takes its λ-map from the
    quality map."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if guard not in GUARDS:
        raise ValueError(f"unknown guard {guard!r}")
    s_i, s_p = _Stepper(i_module, optimizers_i), _Stepper(p_module,
                                                          optimizers_p)

    def step(state_i, state_p, frames, qmap, generator):
        s_i.check(state_i)
        s_p.check(state_p)
        losses = run_sequence(i_module, p_module, frames, qmap, generator,
                              mode, lmbda)
        n_i = len(s_i.main_params)
        params = s_i.main_params + s_p.main_params
        last = losses[-1]
        if guard == "per_frame":
            total = [torch.zeros_like(p) for p in params]
            valid = torch.ones((), device=frames.device)
            for t, lt in enumerate(losses):
                ok = (torch.isfinite(lt["loss"])
                      & (lt["loss"] <= loss_threshold))
                valid = valid * ok.float()
                grads = torch.autograd.grad(
                    lt["loss"], params, allow_unused=True,
                    retain_graph=t < len(losses) - 1)
                for acc, g in zip(total, grads):
                    if g is not None:
                        acc.add_(torch.nan_to_num(g) * valid)
            metrics = {k: last[k] for k in ("loss", "bpp_loss", "mse_loss")}
            metrics["valid_frames"] = valid * len(losses)
        else:
            tot = sum(lt["loss"] for lt in losses)
            total = _grads(tot, params)
            metrics = {k: last[k] for k in ("loss", "bpp_loss", "mse_loss")}
            metrics["total_loss"] = tot
        state_i = s_i.apply_both(state_i, total[:n_i], s_i.aux_grads()[1])
        state_p = s_p.apply_both(state_p, total[n_i:], s_p.aux_grads()[1])
        return state_i, state_p, _detached(metrics)

    return step


def make_joint_eval_step(i_module, p_module, mode: str = "roi"):
    """The deterministic joint loss at a fixed quality map, the mean over
    the frames (the reference's 5-level validation,
    train_stem_roi.py:658-716); the baseline at the default λ, as in the
    JAX package. step(frames, qmap) → 0-dim tensor."""

    @torch.no_grad()
    def step(frames, qmap):
        losses = run_sequence(i_module, p_module, frames, qmap, None, mode,
                              1e-2, train=False)
        return sum(lt["loss"] for lt in losses) / frames.shape[1]

    return step


def build_modules(config: TrainStemRoiConfig, device):
    """The (I, P) modules of the mode from ``config.seed``, on ``device``:
    stem_roi_i and stem_roi (roi), or MeanScaleHyperpriorModule(128, 192)
    and stem_baselinev2 (baseline, train_stem_roi.py:214-215)."""
    gen = torch.Generator().manual_seed(config.seed)
    ebc, m = config.entropy_bottleneck_channels, config.in_channels
    if config.mode == "roi":
        i_module = StemROIModule(ebc, m, conditional=False, generator=gen)
        p_module = StemROIModule(ebc, m, conditional=True, generator=gen)
    else:
        i_module = MeanScaleHyperpriorModule(128, 192, generator=gen)
        p_module = StemBaselineModule(ebc, m, separate_condition_encoder=True,
                                      generator=gen)
    return i_module.to(device), p_module.to(device)


def train_stem_roi(config: TrainStemRoiConfig,
                   max_steps: Optional[int] = None, modules=None):
    """Train; returns ((state_i, state_p), final metrics). ``modules``: a
    pre-built (I, P) module pair on ``config.device`` in place of
    ``build_modules``'s."""
    if config.mode not in MODES:
        raise ValueError(f"unknown mode {config.mode!r}")
    device = training_device(config)
    generator = torch.Generator(device=device).manual_seed(config.seed)
    pyrandom = random.Random(config.seed)
    i_module, p_module = modules or build_modules(config, device)
    check_on(i_module, device)
    check_on(p_module, device)
    cs = config.cropsize

    opt_i = configure_optimizers(i_module, config.learning_rate,
                                 config.aux_learning_rate,
                                 config.clip_max_norm)
    opt_p = configure_optimizers(p_module, config.learning_rate,
                                 config.aux_learning_rate,
                                 config.clip_max_norm)
    state_i = init_train_state(i_module, opt_i)
    state_p = init_train_state(p_module, opt_p)
    step = make_joint_sequence_step(
        i_module, p_module, opt_i, opt_p, mode=config.mode,
        loss_threshold=config.loss_skip_threshold, lmbda=config.lmbda)
    eval_step = make_joint_eval_step(i_module, p_module, config.mode)

    logger = MetricsLogger(config.workdir)
    ckpt = CheckpointManager(os.path.join(config.workdir, "ckpt"), "stem_roi")
    if config.data_root:
        dataset = VimeoSepTuplet(config.data_root, True, cs, rng=pyrandom)
        batches = batch_iterator(dataset, config.batch_size, seed=config.seed)
    else:
        batches = synthetic_batches((config.batch_size, 3, cs, cs, 3),
                                    config.seed)

    def validate(eval_batch) -> dict:
        """The eval losses at the reference's 5 uniform quality levels."""
        frames = nchw(eval_batch, device)
        return {f"eval_loss_l{level}": float(eval_step(frames, torch.full(
            (len(eval_batch), 1, cs, cs), level / 100.0, device=device)))
            for level in EVAL_LEVELS}

    total = max_steps if max_steps is not None else (
        config.epochs * (config.steps_per_epoch or 10**9))
    iteration = 0
    metrics = {}
    eval_batch = None
    for batch in batches:
        if iteration >= total:
            break
        batch = np.asarray(batch)
        if eval_batch is None:
            eval_batch = batch  # a fixed probe batch, as in the JAX package
        qmap = np.stack([synthesize_qmap(cs, rng=pyrandom)
                         for _ in range(batch.shape[0])])
        state_i, state_p, metrics = step(state_i, state_p, nchw(batch, device),
                                         nchw(qmap, device), generator)
        iteration += 1
        if iteration % 100 == 0:
            logger.log(iteration, **{k: float(v) for k, v in metrics.items()})
        if iteration % 10000 == 0:
            logger.log(iteration, **validate(eval_batch))

    ckpt.save(
        {
            "train_state_i": state_i.tree(),
            "train_state_p": state_p.tree(),
            "counters": {"iteration": np.asarray(iteration)},
        },
        metric=float(metrics.get("loss", np.inf)),
    )
    logger.close()
    return (state_i, state_p), metrics


def main(argv=None):
    from ..utils.config import parse_config

    train_stem_roi(parse_config(TrainStemRoiConfig, argv))


if __name__ == "__main__":
    main()
