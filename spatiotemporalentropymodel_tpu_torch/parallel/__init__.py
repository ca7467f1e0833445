from .mesh import (
    DATA_AXIS,
    Mesh,
    batch_sharded,
    make_mesh,
    replicate,
    replicated,
    shard_batch,
)
from .spatial import (
    SP_AXIS,
    Sharded,
    frame_sharding,
    make_spatial_mesh,
    shard_frame,
    spatial_apply,
)
from .train_step import (
    TrainState,
    data_parallel_step,
    init_train_state,
    make_image_train_step,
    make_stem_eval_step,
    make_stem_frame_step,
    make_stem_train_step,
)

__all__ = [
    "DATA_AXIS",
    "SP_AXIS",
    "make_spatial_mesh",
    "frame_sharding",
    "shard_frame",
    "spatial_apply",
    "Sharded",
    "make_mesh",
    "Mesh",
    "replicated",
    "batch_sharded",
    "shard_batch",
    "replicate",
    "TrainState",
    "init_train_state",
    "make_image_train_step",
    "make_stem_train_step",
    "make_stem_frame_step",
    "make_stem_eval_step",
    "data_parallel_step",
]
