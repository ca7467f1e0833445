"""Generalized Divisive Normalization, channel-second (NCHW).

Counterpart of spatiotemporalentropymodel_tpu/layers/gdn.py
(compressai/layers/gdn.py:22-96): ``norm = conv1x1(x², γ) + β`` then
``x · rsqrt(norm)`` (``x · sqrt(norm)`` for IGDN), run as the fused kernel
``ops/kernels.py::gdn_fused``. β and γ are stored in sqrt space (the
non-negative reparametrization), γ as (out, in) like the torch conv weight.
"""

import torch
from torch import nn

from ..ops import kernels
from ..ops.parametrizers import NonNegativeParametrizer


class GDN(nn.Module):
    """y[o] = x[o] / sqrt(beta[o] + sum_i gamma[o,i] * x[i]^2)  (inverse: *sqrt)."""

    def __init__(self, channels: int, inverse: bool = False,
                 beta_min: float = 1e-6, gamma_init: float = 0.1):
        super().__init__()
        self.channels = int(channels)
        self.inverse = bool(inverse)
        self.beta_reparam = NonNegativeParametrizer(minimum=beta_min)
        self.gamma_reparam = NonNegativeParametrizer()
        c = self.channels
        self.beta = nn.Parameter(self.beta_reparam.init(torch.ones(c)))
        self.gamma = nn.Parameter(
            self.gamma_reparam.init(gamma_init * torch.eye(c))
        )

    def forward(self, x):
        beta_v = self.beta_reparam(self.beta)
        gamma_v = self.gamma_reparam(self.gamma)
        return kernels.gdn_fused(x, gamma_v.t().contiguous(), beta_v,
                                 self.inverse)
