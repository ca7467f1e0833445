from . import ar_wavefront
from .priors import (
    FactorizedPrior,
    FactorizedPriorModule,
    JointAutoregressiveHierarchicalPriors,
    JointAutoregressiveModule,
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
from .waseda import (
    Cheng2020Anchor,
    Cheng2020AnchorModule,
    Cheng2020Attention,
    Cheng2020AttentionModule,
)

__all__ = [
    "ar_wavefront",
    "Cheng2020Anchor",
    "Cheng2020AnchorModule",
    "Cheng2020Attention",
    "Cheng2020AttentionModule",
    "JointAutoregressiveHierarchicalPriors",
    "JointAutoregressiveModule",
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
