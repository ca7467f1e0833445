from .bound import lower_bound, upper_bound
from .parametrizers import NonNegativeParametrizer
from .padding import crop_to, pad_to_multiple
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
    "upper_bound",
    "NonNegativeParametrizer",
    "ste_round",
    "quantize",
    "quantize_dequantize",
    "quantize_noise",
    "quantize_symbols",
    "dequantize",
    "pad_to_multiple",
    "crop_to",
]
