"""Model registry, quality configurations and CompressAI checkpoints.

Counterpart of spatiotemporalentropymodel_tpu/zoo/__init__.py
(compressai/zoo/__init__.py:17-24, compressai/zoo/image.py:131-215). A
name's position in ``model_architectures`` is the model id that the image
and video containers record, so the six names stand here in the JAX
package's order. ``load_torch_checkpoint`` fills a zoo image model from a
CompressAI ``.pth.tar`` (zoo/convert.py), ``load_video_torch_checkpoint``
a STEM variant or a model of the ROI family. ``stpm_charm``, the
channel-autoregressive STEM, has no CompressAI counterpart to load from.
"""

from ..models import (
    Cheng2020Anchor,
    Cheng2020Attention,
    FactorizedPrior,
    JointAutoregressiveHierarchicalPriors,
    MeanScaleHyperprior,
    ScaleHyperprior,
    SpatioTemporalPriorModel,
    SpatioTemporalPriorModelChannelAR,
    StemBaseline,
    StemBaselineV2,
    StemROI,
    StemROIWoGsc,
    StemROI_I,
)
from .convert import KEY_MAPS, convert_state_dict, rename_key

model_architectures = {
    "bmshj2018-factorized": FactorizedPrior,
    "bmshj2018-hyperprior": ScaleHyperprior,
    "mbt2018-mean": MeanScaleHyperprior,
    "mbt2018": JointAutoregressiveHierarchicalPriors,
    "cheng2020-anchor": Cheng2020Anchor,
    "cheng2020-attn": Cheng2020Attention,
}

# quality index → constructor args (zoo/image.py:131-188)
cfgs = {
    "bmshj2018-factorized": {q: (128, 192) for q in range(1, 6)}
    | {q: (192, 320) for q in range(6, 9)},
    "bmshj2018-hyperprior": {q: (128, 192) for q in range(1, 6)}
    | {q: (192, 320) for q in range(6, 9)},
    "mbt2018-mean": {q: (128, 192) for q in range(1, 5)}
    | {q: (192, 320) for q in range(5, 9)},
    "mbt2018": {q: (192, 192) for q in range(1, 5)}
    | {q: (192, 320) for q in range(5, 9)},
    "cheng2020-anchor": {q: (128,) for q in range(1, 4)}
    | {q: (192,) for q in range(4, 7)},
    "cheng2020-attn": {q: (128,) for q in range(1, 4)}
    | {q: (192,) for q in range(4, 7)},
}

# STEM variants by reference class name (README parity)
stem_models = {
    "stpm_without_spm_tpm": lambda **kw: SpatioTemporalPriorModel(
        variant="without_spm_tpm", **kw
    ),
    "stpm_without_spm": lambda **kw: SpatioTemporalPriorModel(
        variant="without_spm", **kw
    ),
    "stpm_without_tpm": lambda **kw: SpatioTemporalPriorModel(
        variant="without_tpm", **kw
    ),
    "stpm": lambda **kw: SpatioTemporalPriorModel(variant="full", **kw),
    "stpm_res": lambda **kw: SpatioTemporalPriorModel(variant="res", **kw),
    # beyond the reference: the channel-autoregressive STEM (models/charm.py)
    "stpm_charm": SpatioTemporalPriorModelChannelAR,
}

# the ROI / pixel-domain video family (stem_roi.py class names)
roi_models = {
    "stem_baseline": StemBaseline,
    "stem_baselinev2": StemBaselineV2,
    "stem_roi": StemROI,
    "stem_roi_wo_gsc": StemROIWoGsc,
    "stem_roi_i": StemROI_I,
}

# video model name → its key map (zoo/convert.py)
_VIDEO_KEY_MAP = {
    "stem_baseline": "stem-baseline",
    "stem_baselinev2": "stem-baseline",
    "stem_roi": "stem-roi",
    "stem_roi_wo_gsc": "stem-roi",
    "stem_roi_i": "stem-roi",
    **dict.fromkeys(stem_models, "stem"),
}


def create_model(architecture: str, quality: int = 1, device="cuda",
                 **kwargs):
    """A zoo model at a quality level (zoo/image.py:191-215, without the
    pretrained download), on ``device``."""
    if architecture not in model_architectures:
        raise ValueError(f'Invalid architecture name "{architecture}"')
    if quality not in cfgs[architecture]:
        raise ValueError(f'Invalid quality value "{quality}"')
    return model_architectures[architecture](*cfgs[architecture][quality],
                                             device=device, **kwargs)


def _install_tables(model, state):
    """The checkpoint's own CDF tables where it ships them (streams byte
    compatible with the reference's), else ``update(force=True)``."""
    from .convert import tables_from_state_dict

    tables = tables_from_state_dict(
        state, bottleneck_names=model.bottleneck_names,
        has_gaussian=model.has_gaussian)
    if tables is not None:
        model.set_tables(tables)
    else:
        model.update(force=True)


def _torch_state(path_or_state):
    """A CompressAI checkpoint's state dict from its path or as loaded."""
    import torch

    state = path_or_state
    if isinstance(state, (str, bytes)) or hasattr(state, "__fspath__"):
        state = torch.load(state, map_location="cpu")
    return state.get("state_dict", state)


def load_torch_checkpoint(architecture: str, path, quality: int = 1,
                          device="cuda"):
    """A zoo image model at ``quality`` on ``device`` with its parameters
    from a CompressAI ``.pth.tar`` checkpoint: keys normalized by
    ``rename_key`` and mapped by the architecture's ``KEY_MAPS`` entry, the
    codec tables those the checkpoint ships or rebuilt
    (zoo/__init__.py:160-190 of the JAX package). Both sides are torch
    layouts, so nothing is transposed."""
    state = _torch_state(path)
    key_map = KEY_MAPS.get(architecture)
    if key_map is None:
        raise NotImplementedError(
            f"no checkpoint key map for architecture {architecture!r}")
    model = create_model(architecture, quality, device=device)
    model.module.load_state_dict(
        convert_state_dict(state, model.module, key_map), strict=True)
    _install_tables(model, state)
    return model


def load_video_torch_checkpoint(name: str, path_or_state, device="cuda",
                                **kwargs):
    """A video model (a STEM variant or the ROI family) on ``device`` from a
    CompressAI checkpoint, as the reference trains them (stem/trainSTEM.py,
    stem_roi/train_stem_roi.py): ``path_or_state`` a ``.pth.tar`` path or a
    loaded state dict; ``kwargs`` the model's constructor arguments
    (zoo/__init__.py:110-140 of the JAX package). The tables are those the
    checkpoint ships, else rebuilt."""
    if name in roi_models:
        build = roi_models[name]
    elif name in stem_models:
        build = stem_models[name]
    else:
        raise ValueError(f'Invalid video model name "{name}"')
    state = _torch_state(path_or_state)
    model = build(device=device, **kwargs)
    model.module.load_state_dict(convert_state_dict(
        state, model.module, KEY_MAPS[_VIDEO_KEY_MAP[name]]), strict=True)
    _install_tables(model, state)
    return model


__all__ = ["model_architectures", "stem_models", "roi_models", "cfgs",
           "create_model", "load_torch_checkpoint",
           "load_video_torch_checkpoint", "convert_state_dict", "rename_key",
           "KEY_MAPS"]
