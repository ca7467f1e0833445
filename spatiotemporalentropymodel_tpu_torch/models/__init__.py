from .priors import MeanScaleHyperprior, MeanScaleHyperpriorModule
from .stem import STEMModule, SpatioTemporalPriorModel

__all__ = [
    "MeanScaleHyperprior",
    "MeanScaleHyperpriorModule",
    "STEMModule",
    "SpatioTemporalPriorModel",
]
