"""Non-negative reparametrization for GDN beta/gamma.

Counterpart of spatiotemporalentropymodel_tpu/ops/parametrizers.py
(compressai/ops/parametrizers.py:21-45): parameters are stored as
``sqrt(value + pedestal)`` with ``pedestal = (2**-18)**2``; the forward maps
back via ``lower_bound(v, bound)**2 - pedestal``.
"""

import torch

from .bound import lower_bound


class NonNegativeParametrizer:
    """Stateless transform between parameter space and value space."""

    def __init__(self, minimum: float = 0.0, reparam_offset: float = 2**-18):
        self.minimum = float(minimum)
        self.reparam_offset = float(reparam_offset)
        self.pedestal = self.reparam_offset**2
        self.bound = (self.minimum + self.pedestal) ** 0.5

    def init(self, x):
        """Map an initial value into parameter (sqrt) space."""
        return torch.sqrt(torch.clamp_min(x + self.pedestal, self.pedestal))

    def __call__(self, x):
        """Map a stored parameter back to its non-negative value."""
        out = lower_bound(x, self.bound)
        return out**2 - self.pedestal
