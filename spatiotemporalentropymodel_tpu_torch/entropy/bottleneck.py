"""EntropyBottleneck — Ballé-2018 non-parametric factorized prior.

Counterpart of spatiotemporalentropymodel_tpu/entropy/bottleneck.py
(compressai/entropy_models/entropy_models.py:282-470): per-channel monotone
CDF as a 5-stage composition of softplus-matmul + bias + tanh-gated
nonlinearity; ``quantiles`` (C, 1, 3) track (lower tail, median, upper tail).
The forward runs the eval (dequantize) mode on NCHW input; training noise
waits for the training slice. Table construction (``update_tables``,
``solve_quantiles``) is the JAX package's float64 NumPy code, copied, over a
dict of NumPy parameters (``numpy_params``).
"""

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.bound import lower_bound
from ..ops.quantize import quantize_dequantize
from .cdf import build_table_rows
from .tables import CodecTables


class EntropyBottleneck(nn.Module):
    def __init__(self, channels: int, tail_mass: float = 1e-9,
                 init_scale: float = 10.0,
                 filters: Tuple[int, ...] = (3, 3, 3, 3),
                 likelihood_bound: float = 1e-9, generator=None):
        super().__init__()
        self.channels = int(channels)
        self.tail_mass = float(tail_mass)
        self.filters = tuple(filters)
        self.likelihood_bound = float(likelihood_bound)
        f = (1,) + self.filters + (1,)
        scale = init_scale ** (1 / (len(self.filters) + 1))
        c = self.channels
        for i in range(len(self.filters) + 1):
            init = math.log(math.expm1(1 / scale / f[i + 1]))
            self.register_parameter(
                f"matrix{i}", nn.Parameter(torch.full((c, f[i + 1], f[i]), init))
            )
            self.register_parameter(
                f"bias{i}",
                nn.Parameter(
                    torch.rand((c, f[i + 1], 1), generator=generator) - 0.5
                ),
            )
            if i < len(self.filters):
                self.register_parameter(
                    f"factor{i}", nn.Parameter(torch.zeros(c, f[i + 1], 1))
                )
        self.quantiles = nn.Parameter(
            torch.tensor([[-init_scale, 0.0, init_scale]]).repeat(c, 1, 1)
        )

    # ---- core math -------------------------------------------------------

    def _logits_cumulative(self, x, stop_gradient: bool):
        """x: (C, 1, N) → logits (C, 1, N). Parity: entropy_models.py:388-407."""
        logits = x
        for i in range(len(self.filters) + 1):
            matrix = getattr(self, f"matrix{i}")
            bias = getattr(self, f"bias{i}")
            if stop_gradient:
                matrix, bias = matrix.detach(), bias.detach()
            logits = torch.einsum("cof,cfn->con", F.softplus(matrix),
                                  logits) + bias
            if i < len(self.filters):
                factor = getattr(self, f"factor{i}")
                if stop_gradient:
                    factor = factor.detach()
                logits = logits + torch.tanh(factor) * torch.tanh(logits)
        return logits

    def _likelihood(self, values):
        """values: (C, 1, N). Sign trick for numerical stability
        (entropy_models.py:409-422)."""
        lower = self._logits_cumulative(values - 0.5, stop_gradient=False)
        upper = self._logits_cumulative(values + 0.5, stop_gradient=False)
        sign = -torch.sign(lower + upper).detach()
        return torch.abs(torch.sigmoid(sign * upper)
                         - torch.sigmoid(sign * lower))

    def medians(self):
        return self.quantiles[:, 0, 1]

    def forward(self, x):
        """x: NCHW → (x_hat, likelihoods), both NCHW (eval mode).

        Parity: entropy_models.py:424-452 (channel-major reshape, dequantize
        around the medians, likelihood with lower bound)."""
        b, c, h, w = x.shape
        perm = x.permute(1, 0, 2, 3).reshape(c, 1, -1)
        outputs = quantize_dequantize(perm, self.medians()[:, None, None])
        likelihood = self._likelihood(outputs)
        if self.likelihood_bound > 0:
            likelihood = lower_bound(likelihood, self.likelihood_bound)
        outputs = outputs.reshape(c, b, h, w).permute(1, 0, 2, 3)
        likelihood = likelihood.reshape(c, b, h, w).permute(1, 0, 2, 3)
        return outputs, likelihood

    def aux_loss(self):
        """|logits(quantiles) − target|.sum() (entropy_models.py:383-386)."""
        logits = self._logits_cumulative(self.quantiles, stop_gradient=True)
        t = math.log(2 / self.tail_mass - 1)
        target = torch.tensor([-t, 0.0, t], device=logits.device)
        return torch.abs(logits - target).sum()

    def numpy_params(self):
        """The parameters as a dict of NumPy arrays (the input of
        ``update_tables`` / ``solve_quantiles``)."""
        return {k: v.detach().cpu().numpy() for k, v in self.named_parameters()}


# ---- host-side table construction (pure; float64) -------------------------


def _np_logits_cumulative(params, x):
    """NumPy float64 mirror of the logits chain for update()."""
    n_stages = len([k for k in params if k.startswith("matrix")])
    logits = x
    for i in range(n_stages):
        m = np.asarray(params[f"matrix{i}"], np.float64)
        b = np.asarray(params[f"bias{i}"], np.float64)
        logits = np.einsum("cof,cfn->con", np.logaddexp(0.0, m), logits) + b
        if f"factor{i}" in params:
            fac = np.asarray(params[f"factor{i}"], np.float64)
            logits = logits + np.tanh(fac) * np.tanh(logits)
    return logits


def solve_quantiles(params, tail_mass: float = 1e-9) -> np.ndarray:
    """Directly solve the aux objective: logits(q) = (−t, 0, +t) per channel.

    The reference trains the quantiles by SGD on
    ``|logits(quantiles) − target|`` with a separate Adam
    (entropy_models.py:383-386, utils.py:104-135). The logits chain is
    strictly monotone in x, so the optimum has a closed form by bisection —
    this converges the aux loss to ~0 in one host call (float64, ~90
    iterations). Returns a (C, 1, 3) array to store as the ``quantiles``
    param before ``update_tables``.
    """
    target = np.log(2.0 / tail_mass - 1.0)
    targets = np.array([-target, 0.0, target], np.float64)

    c = np.asarray(params["bias0"]).shape[0]
    lo = np.full((c, 1, 3), -1e4, np.float64)
    hi = np.full((c, 1, 3), 1e4, np.float64)
    for _ in range(90):
        mid = 0.5 * (lo + hi)
        val = _np_logits_cumulative(params, mid)
        too_low = val < targets[None, None, :]
        lo = np.where(too_low, mid, lo)
        hi = np.where(too_low, hi, mid)
    return 0.5 * (lo + hi)


def update_tables(params, precision: int = 16) -> CodecTables:
    """Build coding tables from an EntropyBottleneck param subtree.

    Parity: EntropyBottleneck.update (entropy_models.py:341-381) — integer pmf
    support derived from the learned quantiles, pmf sampled at ±1/2 offsets,
    2-sided tail mass appended as the escape bucket. Runs once post-training,
    in float64 on host for reproducibility.
    """
    quantiles = np.asarray(params["quantiles"], np.float64)  # (C, 1, 3)
    medians = quantiles[:, 0, 1]

    minima = np.clip(np.ceil(medians - quantiles[:, 0, 0]).astype(np.int64), 0, None)
    maxima = np.clip(np.ceil(quantiles[:, 0, 2] - medians).astype(np.int64), 0, None)

    offset = -minima
    pmf_start = medians - minima
    pmf_length = maxima + minima + 1
    max_length = int(pmf_length.max())

    samples = np.arange(max_length, dtype=np.float64)
    samples = samples[None, None, :] + pmf_start[:, None, None]  # (C, 1, L)

    lower = _np_logits_cumulative(params, samples - 0.5)
    upper = _np_logits_cumulative(params, samples + 0.5)
    sign = -np.sign(lower + upper)

    def sigmoid(v):
        return 0.5 * (1.0 + np.tanh(0.5 * v))

    pmf = np.abs(sigmoid(sign * upper) - sigmoid(sign * lower))[:, 0, :]
    tail_mass = sigmoid(lower[:, 0, :1]) + sigmoid(-upper[:, 0, -1:])

    cdf = build_table_rows(pmf, tail_mass, pmf_length, max_length, precision)
    return CodecTables(
        cdf=cdf,
        cdf_length=(pmf_length + 2).astype(np.int32),
        offset=offset.astype(np.int32),
        medians=medians,
    )
