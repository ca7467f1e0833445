"""Generalized Divisive Normalization, channel-second (NCHW).

Counterpart of spatiotemporalentropymodel_tpu/layers/gdn.py
(compressai/layers/gdn.py:22-96): ``norm = conv1x1(x², γ) + β`` then
``x · rsqrt(norm)`` (``x · sqrt(norm)`` for IGDN), run as the fused kernel
``ops/kernels.py::gdn_fused``. β and γ are stored in sqrt space (the
non-negative reparametrization), γ as (out, in) like the torch conv weight.
At bf16 (``set_compute_dtype``) the reparametrization runs in bf16, as in the
JAX package, and the kernel takes γᵀ and β in f32 (x in and out stays bf16).
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

    def kernel_weights(self):
        """(γᵀ, β) in value space as the kernels take them: reparametrized
        at the parameters' dtype, then f32 and contiguous. The fused
        GDN + conv kernels read them here too (the JAX package's
        ``return_weights=True``)."""
        beta_v = self.beta_reparam(self.beta)
        gamma_v = self.gamma_reparam(self.gamma)
        return gamma_v.t().float().contiguous(), beta_v.float()

    def forward(self, x):
        gamma_t, beta_v = self.kernel_weights()
        return kernels.gdn_fused(x, gamma_t, beta_v, self.inverse)
