"""Model registry and quality configurations.

Counterpart of spatiotemporalentropymodel_tpu/zoo/__init__.py
(compressai/zoo/__init__.py:17-24, compressai/zoo/image.py:131-215). A
name's position in ``model_architectures`` is the model id that the image
and video containers record, so all six names stand here in the JAX
package's order, the three whose models the port lacks as constructors that
raise. The torch-checkpoint converters of the JAX zoo are not ported.
"""

from ..models import (
    FactorizedPrior,
    MeanScaleHyperprior,
    ScaleHyperprior,
    SpatioTemporalPriorModel,
)

_LATER = "ROADMAP.md, Queue 1 item 5 (other models)"


def _not_ported(name: str, module: str):
    def build(*args, **kwargs):
        raise NotImplementedError(
            f"{name} is not ported to the PyTorch package yet: it needs "
            f"{module} ({_LATER})")

    build.__name__ = name
    return build


model_architectures = {
    "bmshj2018-factorized": FactorizedPrior,
    "bmshj2018-hyperprior": ScaleHyperprior,
    "mbt2018-mean": MeanScaleHyperprior,
    "mbt2018": _not_ported(
        "mbt2018", "JointAutoregressiveHierarchicalPriors (models/priors.py)"),
    "cheng2020-anchor": _not_ported(
        "cheng2020-anchor", "Cheng2020Anchor (models/waseda.py)"),
    "cheng2020-attn": _not_ported(
        "cheng2020-attn", "Cheng2020Attention (models/waseda.py)"),
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
    "stpm_charm": _not_ported(
        "stpm_charm", "SpatioTemporalPriorModelChannelAR (models/charm.py)"),
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


__all__ = ["model_architectures", "stem_models", "cfgs", "create_model"]
