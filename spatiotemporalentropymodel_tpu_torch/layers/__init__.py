from .conv import Conv, Deconv, LeakyReLU, ReLU, Sequential
from .gdn import GDN
from .masked_conv import MaskedConv2d, make_causal_mask

__all__ = ["Conv", "Deconv", "LeakyReLU", "ReLU", "Sequential", "GDN",
           "MaskedConv2d", "make_causal_mask"]
