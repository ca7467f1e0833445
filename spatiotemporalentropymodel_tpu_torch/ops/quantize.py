"""Quantization primitives: the noise, dequantize and symbols modes, and
``ste_round``.

Counterpart of spatiotemporalentropymodel_tpu/ops/quantize.py
(compressai/entropy_models/entropy_models.py:122-163, compressai/ops/ops.py:
18-32). ``torch.round`` rounds half to even, like ``jnp.round``. The noise
mode (training) draws from an explicit ``torch.Generator`` that the caller
passes, never from the global RNG, as the JAX package takes an explicit key.
"""

import torch


def ste_round(x):
    """Straight-through rounding: forward=round, gradient=identity."""
    return x + (torch.round(x) - x).detach()


def quantize_noise(x, generator):
    """Additive uniform U(-0.5, 0.5) noise (training-time quantization
    proxy), drawn from ``generator`` on x's device."""
    if generator is None:
        raise ValueError("quantize_noise needs an explicit torch.Generator")
    u = torch.rand(x.shape, generator=generator, device=x.device,
                   dtype=x.dtype)
    return x + (u - 0.5)


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


def quantize(x, mode: str, means=None, generator=None):
    """Dispatcher mirroring the reference's 3-mode quantize API."""
    if mode == "noise":
        return quantize_noise(x, generator)
    if mode == "dequantize":
        return quantize_dequantize(x, means)
    if mode == "symbols":
        return quantize_symbols(x, means)
    raise ValueError(f'Invalid quantization mode: "{mode}"')
