from .blocks import (
    AttentionBlock,
    ResidualBlock,
    ResidualBlockUpsample,
    ResidualBlockWithStride,
    SFT,
    SFTResblk,
    adaptive_avg_pool,
    leaky_relu,
)
from .conv import (
    Analysis,
    Conv,
    Deconv,
    LeakyReLU,
    ReLU,
    Sequential,
    SubpelConv3x3,
    Synthesis,
    conv,
    conv1x1,
    conv3x3,
    deconv,
    pixel_shuffle,
)
from .gdn import GDN, GDN1
from .masked_conv import MaskedConv2d, make_causal_mask

__all__ = ["AttentionBlock", "ResidualBlock", "ResidualBlockUpsample",
           "ResidualBlockWithStride", "SFT", "SFTResblk",
           "adaptive_avg_pool", "leaky_relu", "Analysis", "Conv", "Deconv",
           "LeakyReLU", "ReLU", "Sequential", "SubpelConv3x3", "Synthesis",
           "conv", "conv1x1", "conv3x3", "deconv",
           "pixel_shuffle", "GDN", "GDN1", "MaskedConv2d", "make_causal_mask"]
