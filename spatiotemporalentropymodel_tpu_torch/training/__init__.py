from .checkpoints import (
    CheckpointManager,
    load_checkpoint,
    load_trees,
    save_checkpoint,
)
from .logging import MetricsLogger
from .losses import (
    em_loss,
    pixelwise_rate_distortion_loss,
    quality2lambda,
    rate_distortion_loss,
)
from .optimizers import (
    MovingAverage,
    OptimizerPair,
    ReduceLROnPlateau,
    clip_by_global_norm,
    configure_optimizers,
    get_main_learning_rate,
    set_main_learning_rate,
)

__all__ = [
    "CheckpointManager",
    "load_checkpoint",
    "load_trees",
    "save_checkpoint",
    "MetricsLogger",
    "em_loss",
    "rate_distortion_loss",
    "pixelwise_rate_distortion_loss",
    "quality2lambda",
    "MovingAverage",
    "OptimizerPair",
    "ReduceLROnPlateau",
    "clip_by_global_norm",
    "configure_optimizers",
    "get_main_learning_rate",
    "set_main_learning_rate",
]
