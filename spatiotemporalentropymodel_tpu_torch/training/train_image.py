"""Image-codec training loop (compressai_examples/train.py:119-399 parity).

Counterpart of spatiotemporalentropymodel_tpu/training/train_image.py: RD
loss (λ·255²·MSE + bpp), the main/aux Adam split, the gradient clip and a
checkpoint at the end. Synthetic batches from a NumPy seed when
``data_root`` is None (the reference's seeded fake-dataset regression,
test_train.py), the JAX package's batches for the same seed.

Runs on ``config.device`` (``cuda`` unless ``device="cpu"``); with no card
and no ``device="cpu"`` it raises. ``data_parallel`` shards each batch over
every visible card (``parallel/train_step.py::data_parallel_step``); the
checkpoint holds the first card's state. ``resume`` restores the latest
checkpoint of ``workdir`` with the noise generator's state and the batch
position, so a resumed run continues as an uninterrupted one would (the
JAX package's loop ignores ``resume``).

    python -m spatiotemporalentropymodel_tpu_torch.training.train_image \\
        --device cuda --data-root DIR --workdir runs/train_image
"""

import os
from typing import Optional

import numpy as np
import torch

from ..data import ImageFolder, batch_iterator, to_device
from ..parallel import (
    Mesh, data_parallel_step, init_train_state, make_image_train_step,
    make_mesh,
)
from ..utils.config import TrainImageConfig
from ..zoo import create_model
from .checkpoints import CheckpointManager
from .logging import MetricsLogger
from .optimizers import configure_optimizers


def training_device(config) -> torch.device:
    """``config.device``; raises for a card that is not there (no quiet
    fallback to the CPU)."""
    device = torch.device(config.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {config.device!r} asked for, but torch "
                           f"finds no CUDA card; pass device='cpu' to train "
                           f"on the CPU")
    return device


def training_mesh(device) -> Mesh:
    """The data-parallel mesh of a run on ``device``: every visible card
    (``make_mesh()``, the JAX package's choice) for a card, the CPU alone
    for the CPU."""
    if device.type == "cuda":
        return make_mesh()
    return Mesh((device,))


def check_on(module, device) -> None:
    """Raise unless ``module``'s parameters are on ``device``'s type."""
    on = next(module.parameters()).device
    if on.type != device.type:
        raise ValueError(f"the model is on {on}, the config's device is "
                         f"{device}")


def synthetic_batches(shape, seed: int = 0, start: int = 0):
    """Endless float32 batches in [0, 1) of ``shape`` from
    ``np.random.default_rng(seed)``, the first ``start`` drawn and
    dropped."""
    rng = np.random.default_rng(seed)
    for _ in range(start):
        rng.random(shape, np.float32)
    while True:
        yield rng.random(shape, np.float32)


def nchw(batch, device) -> torch.Tensor:
    """An NHWC (…, H, W, 3) host batch → (…, 3, H, W) f32 on ``device``."""
    x = to_device(np.asarray(batch, np.float32), device)
    return x.movedim(-1, -3).contiguous()


def rng_tree(generator, pyrandom=None):
    """The noise generator's state (and a ``random.Random``'s) as a
    checkpoint saves them."""
    tree = {"generator": generator.get_state().numpy()}
    if pyrandom is not None:
        version, words, gauss = pyrandom.getstate()
        tree["pyrandom"] = {"version": version, "gauss_next": gauss,
                            "state": np.asarray(words, np.int64)}
    return tree


def load_rng_tree(tree, generator, pyrandom=None) -> None:
    generator.set_state(torch.from_numpy(np.asarray(tree["generator"])))
    if pyrandom is not None:
        p = tree["pyrandom"]
        pyrandom.setstate((p["version"], tuple(int(v) for v in p["state"]),
                           p["gauss_next"]))


def train_image(config: TrainImageConfig, max_steps: Optional[int] = None,
                model=None):
    """Train; returns (state, final metrics). ``model``: a pre-built
    CompressionModel on ``config.device`` (e.g. with loaded weights, to fine
    tune) in place of the zoo's ``config.model`` at ``config.quality``."""
    device = training_device(config)
    generator = torch.Generator(device=device).manual_seed(config.seed)
    if model is None:
        model = create_model(config.model, config.quality, device=device)
    module = model.module
    check_on(module, device)

    optimizers = configure_optimizers(
        module, config.learning_rate, config.aux_learning_rate,
        config.clip_max_norm)
    state = init_train_state(module, optimizers)
    step = make_image_train_step(module, optimizers, config.lmbda)
    if config.data_parallel:
        step = data_parallel_step(step, training_mesh(device))

    logger = MetricsLogger(config.workdir)
    ckpt = CheckpointManager(os.path.join(config.workdir, "ckpt"), "image")
    iteration = 0
    if config.resume:
        restored = ckpt.restore_latest()
        if restored is not None:
            state.load_tree(restored["train_state"])
            iteration = int(restored["counters"]["iteration"])
            load_rng_tree(restored["rng"], generator)

    if config.data_root:
        dataset = ImageFolder(config.data_root, "train", config.cropsize)
        batches = batch_iterator(dataset, config.batch_size, seed=config.seed,
                                 start=iteration)
    else:
        batches = synthetic_batches(
            (config.batch_size, config.cropsize, config.cropsize, 3),
            config.seed, start=iteration)

    total = max_steps if max_steps is not None else (
        config.epochs * (config.steps_per_epoch or 10**9))
    metrics = {}
    for batch in batches:
        if iteration >= total:
            break
        state, metrics = step(state, nchw(batch, device), generator)
        iteration += 1
        if iteration % 100 == 0:
            logger.log(iteration, **{k: float(v) for k, v in metrics.items()})

    ckpt.save(
        {
            "train_state": state.tree(),
            "counters": {"iteration": np.asarray(iteration)},
            "rng": rng_tree(generator),
        },
        metric=float(metrics.get("loss", np.inf)),
    )
    logger.close()
    return state, metrics


def main(argv=None):
    from ..utils.config import parse_config

    train_image(parse_config(TrainImageConfig, argv))


if __name__ == "__main__":
    main()
