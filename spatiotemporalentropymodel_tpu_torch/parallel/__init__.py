from .train_step import (
    TrainState,
    init_train_state,
    make_image_train_step,
    make_stem_eval_step,
    make_stem_frame_step,
    make_stem_train_step,
)

__all__ = [
    "TrainState",
    "init_train_state",
    "make_image_train_step",
    "make_stem_train_step",
    "make_stem_frame_step",
    "make_stem_eval_step",
]
