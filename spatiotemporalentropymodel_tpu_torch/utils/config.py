"""Typed configuration of the training and evaluation entry points.

Counterpart of spatiotemporalentropymodel_tpu/utils/config.py: dataclasses
bound to the command line by ``parse_config``, with the JAX package's
defaults, plus ``device`` (the port's entry points run on ``cuda`` unless
the caller asks for ``cpu``). ``data_parallel`` shards the batch over the
visible cards where the JAX package does (``train_image``, ``train_stem``
per_sequence) and is read nowhere else, as there: ``TrainStemRoiConfig``'s
is unused in both packages.
"""

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional


def _add_dataclass_args(parser: argparse.ArgumentParser, cls) -> None:
    for f in dataclasses.fields(cls):
        name = "--" + f.name.replace("_", "-")
        default = f.default if f.default is not dataclasses.MISSING else None
        if f.type in ("bool", bool):
            parser.add_argument(
                name, type=lambda v: v.lower() in ("1", "true", "yes"),
                default=default)
        elif f.type in ("int", int):
            parser.add_argument(name, type=int, default=default)
        elif f.type in ("float", float):
            parser.add_argument(name, type=float, default=default)
        else:
            parser.add_argument(name, type=str, default=default)


def parse_config(cls, argv=None):
    parser = argparse.ArgumentParser(description=cls.__doc__)
    _add_dataclass_args(parser, cls)
    ns = parser.parse_args(argv)
    kwargs = {
        f.name: getattr(ns, f.name)
        for f in dataclasses.fields(cls)
        if getattr(ns, f.name) is not None
    }
    return cls(**kwargs)


@dataclass
class TrainImageConfig:
    """Image-codec training (compressai_examples/train.py parity)."""

    model: str = "mbt2018-mean"
    quality: int = 4
    data_root: Optional[str] = None  # None → synthetic smoke data
    cropsize: int = 256
    batch_size: int = 16
    learning_rate: float = 1e-4
    aux_learning_rate: float = 1e-3
    lmbda: float = 1e-2
    clip_max_norm: float = 1.0
    epochs: int = 100
    steps_per_epoch: int = 0  # 0 → full dataset
    seed: int = 0
    workdir: str = "runs/train_image"
    data_parallel: bool = False
    resume: bool = False
    device: str = "cuda"


@dataclass
class TrainStemConfig:
    """STEM single-rate training (stem/trainSTEM.py parity)."""

    variant: str = "res"
    in_channels: int = 192
    entropy_bottleneck_channels: int = 256
    i_model: str = "mbt2018-mean"
    i_quality: int = 4
    i_checkpoint: Optional[str] = None
    data_root: Optional[str] = None
    cropsize: int = 256
    batch_size: int = 4
    learning_rate: float = 1e-4
    aux_learning_rate: float = 1e-3
    clip_max_norm: float = 1.0
    epochs: int = 50
    steps_per_epoch: int = 0
    eval_every: int = 20000  # iterations (trainSTEM.py:229)
    step_mode: str = "per_frame"  # "per_frame" (faithful) | "per_sequence"
    seed: int = 0
    workdir: str = "runs/train_stem"
    data_parallel: bool = False
    resume: bool = False
    device: str = "cuda"


@dataclass
class TrainStemRoiConfig:
    """Joint I+P / ROI training (stem_roi/train_stem_roi.py parity)."""

    mode: str = "roi"  # "baseline" (single-rate joint) | "roi" (variable-rate)
    in_channels: int = 192
    entropy_bottleneck_channels: int = 256
    data_root: Optional[str] = None
    cropsize: int = 256
    batch_size: int = 4
    learning_rate: float = 1e-4
    aux_learning_rate: float = 1e-3
    clip_max_norm: float = 1.0
    lmbda: float = 1e-2  # baseline mode single-rate lambda
    epochs: int = 50
    steps_per_epoch: int = 0
    loss_skip_threshold: float = 3.0  # train_stem_roi.py:526-529
    seed: int = 0
    workdir: str = "runs/train_stem_roi"
    data_parallel: bool = False
    resume: bool = False
    device: str = "cuda"


@dataclass
class EvalStemConfig:
    """GOP video evaluation (stem/evalSTEM.py parity)."""

    dataset_root: Optional[str] = None
    dataset: str = "uvg"  # uvg (GOP 12) | hevc (GOP 10)
    n_gops: int = 3
    variant: str = "res"
    stem_checkpoint: Optional[str] = None
    i_model: str = "mbt2018-mean"
    i_quality: int = 4
    i_checkpoint: Optional[str] = None
    entropy_estimation: bool = False
    out_json: Optional[str] = None
    logfile: Optional[str] = None
    device: str = "cuda"
