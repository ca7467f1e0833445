from .gop import (
    HEVC_GOP,
    UVG_GOP,
    ArraySequence,
    GOPDataset,
    GOPFrame,
    GOPSequence,
)
from .image_folder import ImageFolder
from .pipeline import batch_iterator, prefetch_to_device, to_device
from .png import read_png, write_png
from .qmap import gradient_qmap, synthesize_qmap, uniform_qmap
from .vimeo import (
    TEMPORAL_SUBSAMPLES,
    VimeoSepTuplet,
    VimeoSepTupletQMap,
    subsample_frames,
)

__all__ = ["GOPFrame", "ArraySequence", "GOPSequence", "GOPDataset",
           "UVG_GOP", "HEVC_GOP", "read_png", "write_png", "ImageFolder",
           "batch_iterator", "prefetch_to_device", "to_device",
           "VimeoSepTuplet", "VimeoSepTupletQMap", "TEMPORAL_SUBSAMPLES",
           "subsample_frames", "synthesize_qmap", "uniform_qmap",
           "gradient_qmap"]
