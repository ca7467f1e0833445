from . import base, cdf
from .bottleneck import EntropyBottleneck
from .bottleneck import update_tables as update_bottleneck_tables
from .gaussian import (
    GaussianConditional,
    build_indexes,
    get_scale_table,
    likelihood as gaussian_likelihood,
    standardized_cumulative,
)
from .gaussian import update_tables as update_gaussian_tables
from .tables import CodecTables

__all__ = [
    "base",
    "cdf",
    "EntropyBottleneck",
    "GaussianConditional",
    "CodecTables",
    "update_bottleneck_tables",
    "update_gaussian_tables",
    "build_indexes",
    "get_scale_table",
    "gaussian_likelihood",
    "standardized_cumulative",
]
