from . import ar_wavefront
from .priors import (
    FactorizedPrior,
    FactorizedPriorModule,
    MeanScaleHyperprior,
    MeanScaleHyperpriorModule,
    ScaleHyperprior,
    ScaleHyperpriorModule,
)
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
    "FactorizedPrior",
    "FactorizedPriorModule",
    "MeanScaleHyperprior",
    "MeanScaleHyperpriorModule",
    "ScaleHyperprior",
    "ScaleHyperpriorModule",
    "STEM_VARIANTS",
    "STEMModule",
    "SpatioTemporalPriorModel",
    "SpatioTemporalPriorModel_Res",
    "SpatioTemporalPriorModelFull",
    "SpatioTemporalPriorModelWithoutSPM",
    "SpatioTemporalPriorModelWithoutSPMTPM",
    "SpatioTemporalPriorModelWithoutTPM",
]
