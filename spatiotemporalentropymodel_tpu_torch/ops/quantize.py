"""Quantization primitives: the dequantize and symbols modes, ``ste_round``.

Counterpart of spatiotemporalentropymodel_tpu/ops/quantize.py
(compressai/entropy_models/entropy_models.py:122-163, compressai/ops/ops.py:
18-32). ``torch.round`` rounds half to even, like ``jnp.round``. The noise
mode (training) waits for the training slice.
"""

import torch


def ste_round(x):
    """Straight-through rounding: forward=round, gradient=identity."""
    return x + (torch.round(x) - x).detach()


def quantize_dequantize(x, means=None):
    """round(x - means) + means (eval-time forward quantization)."""
    if means is not None:
        return torch.round(x - means) + means
    return torch.round(x)


def quantize_symbols(x, means=None):
    """round(x - means) as int32 symbols (coding path)."""
    if means is not None:
        x = x - means
    return torch.round(x).to(torch.int32)


def dequantize(symbols, means=None, dtype=torch.float32):
    """Inverse of :func:`quantize_symbols`."""
    if means is not None:
        return symbols.to(means.dtype) + means
    return symbols.to(dtype)


def quantize(x, mode: str, means=None):
    """Dispatcher over the eval modes of the reference's quantize API."""
    if mode == "dequantize":
        return quantize_dequantize(x, means)
    if mode == "symbols":
        return quantize_symbols(x, means)
    raise ValueError(f'Invalid quantization mode: "{mode}"')
