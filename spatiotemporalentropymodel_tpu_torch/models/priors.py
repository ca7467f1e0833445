"""MeanScaleHyperprior (mbt2018-mean), the I-frame model of the P-frame path.

Counterpart of spatiotemporalentropymodel_tpu/models/priors.py::
MeanScaleHyperprior (compressai/models/priors.py:316-402), NCHW. Every layer
is here so the whole parameter tree carries across from the JAX package
(convert.py); the serving slices call ``analysis`` (g_a) and ``get_x``
(g_s + clamp), which cast their input to the compute dtype as the JAX
package's ``_apply`` does. The I-frame ``compress``/``decompress`` wait for a
later slice.
"""

import torch
from torch import nn

from ..entropy import EntropyBottleneck, GaussianConditional
from ..layers import GDN, Conv, Deconv, Sequential
from .base import CompressionModel


class MeanScaleHyperpriorModule(nn.Module):
    """priors.py:316-402 — h_s outputs (σ, μ); getY/getX STEM hooks."""

    def __init__(self, N: int, M: int, generator=None):
        super().__init__()
        n, m, g = N, M, generator
        self.g_a = Sequential([
            Conv(3, n, 5, 2, g), GDN(n), Conv(n, n, 5, 2, g), GDN(n),
            Conv(n, n, 5, 2, g), GDN(n), Conv(n, m, 5, 2, g),
        ])
        self.g_s = Sequential([
            Deconv(m, n, 5, 2, g), GDN(n, inverse=True),
            Deconv(n, n, 5, 2, g), GDN(n, inverse=True),
            Deconv(n, n, 5, 2, g), GDN(n, inverse=True),
            Deconv(n, 3, 5, 2, g),
        ])
        self.h_a = Sequential([
            Conv(m, n, 3, 1, g), nn.LeakyReLU(0.01), Conv(n, n, 5, 2, g),
            nn.LeakyReLU(0.01), Conv(n, n, 5, 2, g),
        ])
        self.h_s = Sequential([
            Deconv(n, m, 5, 2, g), nn.LeakyReLU(0.01),
            Deconv(m, m * 3 // 2, 5, 2, g), nn.LeakyReLU(0.01),
            Conv(m * 3 // 2, m * 2, 3, 1, g),
        ])
        self.entropy_bottleneck = EntropyBottleneck(n, generator=g)
        self.gaussian_conditional = GaussianConditional()

    def get_x(self, y_hat):
        """getX hook (priors.py:397-402): synthesize and clamp to [0, 1]."""
        return torch.clamp(self.g_s(y_hat), 0.0, 1.0)


class MeanScaleHyperprior(CompressionModel):
    """priors.py:316-402. Weights are drawn from ``seed`` with an explicit
    CPU generator, then moved to ``device``."""

    has_gaussian = True

    def __init__(self, N: int, M: int, device="cuda", seed: int = 0):
        gen = torch.Generator().manual_seed(seed)
        super().__init__(MeanScaleHyperpriorModule(N, M, gen), device)
        self.N, self.M = N, M

    @torch.no_grad()
    def analysis(self, x):
        """g_a only. The JAX package's ``analysis`` also runs h_a, which its
        pipeline drops unused; eager PyTorch would run it."""
        return self.module.g_a(self._cast_in(x))

    @torch.no_grad()
    def get_x(self, y_hat):
        return self.module.get_x(self._cast_in(y_hat))
