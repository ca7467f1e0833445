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
    Conv,
    Deconv,
    LeakyReLU,
    ReLU,
    Sequential,
    SubpelConv3x3,
    pixel_shuffle,
)
from .gdn import GDN
from .masked_conv import MaskedConv2d, make_causal_mask

__all__ = ["AttentionBlock", "ResidualBlock", "ResidualBlockUpsample",
           "ResidualBlockWithStride", "SFT", "SFTResblk",
           "adaptive_avg_pool", "leaky_relu", "Conv", "Deconv",
           "LeakyReLU", "ReLU", "Sequential", "SubpelConv3x3",
           "pixel_shuffle", "GDN", "MaskedConv2d", "make_causal_mask"]
