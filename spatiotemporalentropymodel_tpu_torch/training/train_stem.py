"""STEM single-rate training loop (stem/trainSTEM.py:100-295 parity).

Counterpart of spatiotemporalentropymodel_tpu/training/train_stem.py. A
frozen I-frame model gives the latents (getY); the STEM entropy model
trains on the rate-only EM loss; frame 0 conditions frames 1..k through a
detached carry; each batch is subsampled in time (trainSTEM.py:176-182);
main/aux Adam split with the gradient clip; the plateau LR schedule; a
validation and a checkpoint every ``eval_every`` iterations and at the end.

``step_mode="per_frame"`` takes one update per P-frame, the reference's
recipe; ``"per_sequence"`` takes one update on the mean loss of the
sequence (the deferred recipe of train_stem_roi.py:628-631).
``data_parallel`` shards each batch of ``per_sequence`` steps over every
visible card (``parallel/train_step.py::data_parallel_step``), as the JAX
package does; ``per_frame`` steps ignore it, as they do there.

Runs on ``config.device`` (``cuda`` unless ``device="cpu"``); with no card
and no ``device="cpu"`` it raises. Synthetic batches from a NumPy seed when
``data_root`` is None, the JAX package's for the same seed. ``resume``
restores the latest checkpoint of ``workdir`` with the generator's, the
subsampling's and the batches' positions, so a resumed run continues as an
uninterrupted one would.

    python -m spatiotemporalentropymodel_tpu_torch.training.train_stem \\
        --device cuda --i-checkpoint artifacts/trained/hero/ckpt_i_0.012.pkl.gz \\
        --data-root vimeo_septuplet --workdir runs/train_stem
"""

import os
import random
from typing import Optional

import numpy as np
import torch

from ..data import VimeoSepTuplet, batch_iterator, subsample_frames
from ..models import STEMModule
from ..parallel import (
    data_parallel_step,
    init_train_state,
    make_stem_eval_step,
    make_stem_frame_step,
    make_stem_train_step,
)
from ..utils.config import TrainStemConfig
from ..zoo import create_model
from .checkpoints import CheckpointManager, load_checkpoint
from .logging import MetricsLogger
from .optimizers import (
    ReduceLROnPlateau,
    configure_optimizers,
    set_main_learning_rate,
)
from .train_image import (
    check_on, load_rng_tree, nchw, rng_tree, synthetic_batches,
    training_device,
    training_mesh,
)

STEP_MODES = ("per_frame", "per_sequence")


def build_i_model(config, device):
    """The frozen I-frame codec that gives the latents
    (trainSTEM.py:104-121): the zoo's ``i_model`` at ``i_quality``, its
    weights (and codec tables) from ``i_checkpoint``'s ``"model"`` entry
    where one is given."""
    model = create_model(config.i_model, config.i_quality, device=device)
    if config.i_checkpoint:
        model.load_state_leaves(load_checkpoint(config.i_checkpoint)["model"])
    return model


def latents_fn(i_model):
    """(B, T, H, W, 3) images on the device, NCHW per frame (B, T, 3, H, W)
    → (B, T, M, h, w) latent sequences, with no gradient.

    As the reference's getY (trainSTEM.py:199-207): frame 0, the
    conditioning carry, is the *quantized* latent (``_, y_condition =
    getY(images[0])``) and the P-frame targets 1..T-1 are the *raw*
    latents (``y_cur, _ = getY(images[t])``)."""

    @torch.no_grad()
    def fn(frames, generator, train: bool):
        b, t = frames.shape[:2]
        y, y_q = i_model.module.get_y(frames.flatten(0, 1), train=train,
                                      generator=generator)
        y = y.unflatten(0, (b, t))
        y_q = y_q.unflatten(0, (b, t))
        return torch.cat([y_q[:, :1], y[:, 1:]], dim=1)

    return fn


def train_stem(config: TrainStemConfig, max_steps: Optional[int] = None,
               i_model=None, module=None):
    """Train; returns (state, final metrics). ``i_model``: a pre-built
    frozen I-frame codec in place of ``build_i_model``'s; ``module``: a
    pre-built STEMModule (e.g. with given weights) in place of one drawn
    from ``config.seed``. Both on ``config.device``."""
    if config.step_mode not in STEP_MODES:
        raise ValueError(f"unknown step_mode {config.step_mode!r}")
    device = training_device(config)
    generator = torch.Generator(device=device).manual_seed(config.seed)
    pyrandom = random.Random(config.seed)

    if i_model is None:
        i_model = build_i_model(config, device)
    check_on(i_model.module, device)
    get_latents = latents_fn(i_model)
    if module is None:
        module = STEMModule(
            config.variant, config.entropy_bottleneck_channels,
            config.in_channels,
            torch.Generator().manual_seed(config.seed)).to(device)
    check_on(module, device)

    optimizers = configure_optimizers(
        module, config.learning_rate, config.aux_learning_rate,
        config.clip_max_norm)
    state = init_train_state(module, optimizers)
    if config.step_mode == "per_sequence":
        seq_step = make_stem_train_step(module, optimizers)
        if config.data_parallel:
            seq_step = data_parallel_step(seq_step, training_mesh(device))
    else:  # per_frame ignores data_parallel, as the JAX package's does
        frame_step = make_stem_frame_step(module, optimizers)
    eval_step = make_stem_eval_step(module)

    logger = MetricsLogger(config.workdir)
    ckpt = CheckpointManager(os.path.join(config.workdir, "ckpt"), "stem")
    scheduler = ReduceLROnPlateau()
    iteration = 0
    if config.resume:
        restored = ckpt.restore_latest()
        if restored is not None:
            state.load_tree(restored["train_state"])
            iteration = int(restored["counters"]["iteration"])
            scheduler.load_state_dict(
                {k: float(v) for k, v in restored["scheduler"].items()})
            load_rng_tree(restored["rng"], generator, pyrandom)

    if config.data_root:
        dataset = VimeoSepTuplet(config.data_root, True, config.cropsize,
                                 rng=pyrandom)
        batches = batch_iterator(dataset, config.batch_size, seed=config.seed,
                                 start=iteration)
        eval_dataset = VimeoSepTuplet(config.data_root, False,
                                      config.cropsize)
        eval_batches = lambda: batch_iterator(  # noqa: E731
            eval_dataset, config.batch_size, shuffle=False, epochs=1)
    else:
        shape = (config.batch_size, 7, config.cropsize, config.cropsize, 3)
        batches = synthetic_batches(shape, config.seed, start=iteration)
        eval_batches = lambda: iter(  # noqa: E731
            [next(synthetic_batches(shape, config.seed + 10**6))])

    def validate(max_batches: int = 4) -> float:
        total, n = 0.0, 0
        for eb in eval_batches():
            if n >= max_batches:
                break
            lat = get_latents(nchw(eb, device), generator, False)
            total += float(eval_step(lat))
            n += 1
        return total / max(n, 1)

    total = max_steps if max_steps is not None else (
        config.epochs * (config.steps_per_epoch or 10**9))
    metrics = {}
    for batch in batches:
        if iteration >= total:
            break
        batch = subsample_frames(np.asarray(batch), pyrandom)
        latents = get_latents(nchw(batch, device), generator, True)
        if config.step_mode == "per_sequence":
            state, metrics = seq_step(state, latents, generator)
        else:
            y_cond = latents[:, 0]
            for t in range(1, latents.shape[1]):
                state, metrics, y_cond = frame_step(
                    state, latents[:, t], y_cond, generator)
        iteration += 1

        if iteration % 100 == 0:
            logger.log(iteration, **{k: float(v) for k, v in metrics.items()})
        if iteration % max(1, config.eval_every) == 0 or iteration >= total:
            loss = validate()
            logger.log(iteration, eval_loss=loss)
            scale = scheduler.step(loss)
            set_main_learning_rate(optimizers.main,
                                   config.learning_rate * scale)
            ckpt.save(
                {
                    "train_state": state.tree(),
                    "counters": {"iteration": np.asarray(iteration)},
                    "scheduler": {k: np.asarray(v) for k, v in
                                  scheduler.state_dict().items()},
                    "rng": rng_tree(generator, pyrandom),
                },
                metric=loss,
            )

    logger.close()
    return state, metrics


def main(argv=None):
    from ..utils.config import parse_config

    train_stem(parse_config(TrainStemConfig, argv))


if __name__ == "__main__":
    main()
