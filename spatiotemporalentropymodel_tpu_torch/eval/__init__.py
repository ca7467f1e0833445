from . import (
    bench_codecs,
    codec,
    eval_model,
    eval_stem,
    eval_stem_roi,
    find_close,
    metrics,
    plot,
    rd_data,
    update_model,
)
from .metrics import actual_bpp, estimate_bpp, ms_ssim, psnr, ssim
from .pipeline import StemVideoPipeline

__all__ = [
    "metrics",
    "psnr",
    "ssim",
    "ms_ssim",
    "estimate_bpp",
    "actual_bpp",
    "codec",
    "eval_model",
    "eval_stem",
    "update_model",
    "bench_codecs",
    "find_close",
    "plot",
    "rd_data",
    "StemVideoPipeline",
]
