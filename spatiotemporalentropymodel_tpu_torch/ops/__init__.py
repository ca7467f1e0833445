from .bound import lower_bound
from .parametrizers import NonNegativeParametrizer
from .quantize import (
    dequantize,
    quantize,
    quantize_dequantize,
    quantize_noise,
    quantize_symbols,
    ste_round,
)

__all__ = [
    "lower_bound",
    "NonNegativeParametrizer",
    "ste_round",
    "quantize",
    "quantize_dequantize",
    "quantize_noise",
    "quantize_symbols",
    "dequantize",
]
