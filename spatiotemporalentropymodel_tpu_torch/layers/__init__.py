from .conv import Conv, Deconv, Sequential
from .gdn import GDN

__all__ = ["Conv", "Deconv", "Sequential", "GDN"]
