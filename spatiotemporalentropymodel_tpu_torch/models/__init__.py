from . import ar_wavefront
from .priors import MeanScaleHyperprior, MeanScaleHyperpriorModule
from .stem import (
    STEM_VARIANTS,
    STEMModule,
    SpatioTemporalPriorModel,
    SpatioTemporalPriorModel_Res,
    SpatioTemporalPriorModelFull,
    SpatioTemporalPriorModelWithoutSPM,
    SpatioTemporalPriorModelWithoutSPMTPM,
    SpatioTemporalPriorModelWithoutTPM,
)

__all__ = [
    "ar_wavefront",
    "MeanScaleHyperprior",
    "MeanScaleHyperpriorModule",
    "STEM_VARIANTS",
    "STEMModule",
    "SpatioTemporalPriorModel",
    "SpatioTemporalPriorModel_Res",
    "SpatioTemporalPriorModelFull",
    "SpatioTemporalPriorModelWithoutSPM",
    "SpatioTemporalPriorModelWithoutSPMTPM",
    "SpatioTemporalPriorModelWithoutTPM",
]
