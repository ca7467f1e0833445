from .gop import (
    HEVC_GOP,
    UVG_GOP,
    ArraySequence,
    GOPDataset,
    GOPFrame,
    GOPSequence,
)
from .png import read_png, write_png

__all__ = ["GOPFrame", "ArraySequence", "GOPSequence", "GOPDataset",
           "UVG_GOP", "HEVC_GOP", "read_png", "write_png"]
