"""GaussianConditional — conditional N(μ, σ) entropy model for the latent y.

Counterpart of spatiotemporalentropymodel_tpu/entropy/gaussian.py
(compressai/entropy_models/entropy_models.py:473-604): scale table of 64
log-spaced values in [0.11, 256] (models/priors.py:185-193); likelihood via
the complementary error function; per-element CDF-row index = count of
table entries < scale. ``update_tables`` is the JAX package's float64 NumPy
code, copied.
"""

import math

import numpy as np
import scipy.special
import scipy.stats
import torch
from torch import nn

from ..ops.bound import lower_bound
from ..ops.quantize import quantize_dequantize, quantize_noise
from .cdf import build_table_rows
from .tables import CodecTables

SCALES_MIN = 0.11
SCALES_MAX = 256.0
SCALES_LEVELS = 64


def get_scale_table(
    smin: float = SCALES_MIN, smax: float = SCALES_MAX, levels: int = SCALES_LEVELS
) -> np.ndarray:
    """Log-spaced scale table (models/priors.py:190-193), float64 host array."""
    return np.exp(np.linspace(math.log(smin), math.log(smax), levels))


def standardized_cumulative(x):
    """Φ(x) evaluated as ½·erfc(−x/√2) (entropy_models.py:521-526)."""
    const = -(2**-0.5)
    return 0.5 * torch.special.erfc(const * x)


def likelihood(values, scales, scale_bound: float = SCALES_MIN):
    """P(round(v) | σ) for zero-centered values (means already subtracted)."""
    scales = lower_bound(scales, scale_bound)
    values = torch.abs(values)
    upper = standardized_cumulative((0.5 - values) / scales)
    lower = standardized_cumulative((-0.5 - values) / scales)
    return upper - lower


class GaussianConditional(nn.Module):
    def __init__(self, scale_bound: float = SCALES_MIN,
                 likelihood_bound: float = 1e-9):
        super().__init__()
        self.scale_bound = float(scale_bound)
        self.likelihood_bound = float(likelihood_bound)

    def forward(self, inputs, scales, means=None, train: bool = False,
                generator=None):
        """(inputs, σ, μ) → (outputs, likelihoods). Parity:
        entropy_models.py:588-596: in train mode noise from ``generator`` on
        the inputs, else rounding around μ."""
        if train:
            outputs = quantize_noise(inputs, generator)
        else:
            outputs = quantize_dequantize(inputs, means)
        values = outputs - means if means is not None else outputs
        lk = likelihood(values.float(), scales.float(), self.scale_bound)
        if self.likelihood_bound > 0:
            lk = lower_bound(lk, self.likelihood_bound)
        return outputs, lk


def build_indexes(scales, scale_table, scale_bound: float = SCALES_MIN):
    """Map each σ to its CDF row: #{table[:-1] entries < σ}
    (entropy_models.py:598-604, vectorized). ``scale_table`` is cast to σ's
    dtype, as in the JAX package."""
    scales = torch.clamp_min(scales, scale_bound)
    table = torch.as_tensor(scale_table, dtype=scales.dtype,
                            device=scales.device)
    return torch.searchsorted(table[:-1].contiguous(), scales.contiguous(),
                              right=False).to(torch.int32)


def update_tables(
    scale_table=None, tail_mass: float = 1e-9, precision: int = 16
) -> CodecTables:
    """Build coding tables for a scale table.

    Parity: GaussianConditional.update (entropy_models.py:543-568) — pmf
    support ±ceil(σ·Φ⁻¹(1−tail/2)) per scale, pmf from CDF differences at
    integer offsets, 2·lower tail mass escape bucket. Host float64.
    """
    if scale_table is None:
        scale_table = get_scale_table()
    scale_table = np.asarray(scale_table, np.float64)

    multiplier = -scipy.stats.norm.ppf(tail_mass / 2)
    pmf_center = np.ceil(scale_table * multiplier).astype(np.int64)
    pmf_length = 2 * pmf_center + 1
    max_length = int(pmf_length.max())

    samples = np.abs(
        np.arange(max_length, dtype=np.int64)[None, :] - pmf_center[:, None]
    ).astype(np.float64)
    s = scale_table[:, None]

    def phi(x):
        return 0.5 * scipy.special.erfc(-(2**-0.5) * x)

    upper = phi((0.5 - samples) / s)
    lower = phi((-0.5 - samples) / s)
    pmf = upper - lower
    tail = 2 * lower[:, :1]

    cdf = build_table_rows(pmf, tail, pmf_length, max_length, precision)
    return CodecTables(
        cdf=cdf,
        cdf_length=(pmf_length + 2).astype(np.int32),
        offset=(-pmf_center).astype(np.int32),
        scale_table=scale_table,
    )
