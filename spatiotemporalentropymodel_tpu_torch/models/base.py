"""CompressionModel host wrapper (f32).

Counterpart of spatiotemporalentropymodel_tpu/models/base.py
(compressai/models/priors.py:42-106): a thin host object around

  * an ``nn.Module`` (``self.module``) holding the architecture and weights,
    on ``self.device``,
  * explicit :class:`CodecTables` per entropy-model instance
    (``self.tables``), built by the pure NumPy ``update`` functions.

bf16 serving (``set_compute_dtype``) waits for the bf16 slice.
"""

from typing import Any, Dict

import torch

from ..coders import get_coder
from ..entropy import (
    get_scale_table,
    update_bottleneck_tables,
    update_gaussian_tables,
)


class CompressionModel:
    """Base wrapper; subclasses set ``module`` and implement the codec path."""

    # names of EntropyBottleneck submodules of ``module``
    bottleneck_names = ("entropy_bottleneck",)
    # whether the model owns a GaussianConditional (scale-table driven)
    has_gaussian = False

    def __init__(self, module, device="cuda"):
        self.device = torch.device(device)
        self.module = module.to(self.device).eval()
        self.tables: Dict[str, Any] = {}

    @property
    def coder(self):
        return get_coder()

    def update(self, scale_table=None, force: bool = False) -> bool:
        """(Re)build codec tables from parameters (priors.py:77-96).

        Returns True if tables were (re)computed.
        """
        if self.tables and not force:
            return False
        for name in self.bottleneck_names:
            eb = self.module.get_submodule(name)
            self.tables[name] = update_bottleneck_tables(eb.numpy_params())
        if self.has_gaussian:
            if scale_table is None:
                scale_table = get_scale_table()
            self.tables["gaussian_conditional"] = update_gaussian_tables(
                scale_table
            )
        return True

    def _require_tables(self):
        if not self.tables:
            raise RuntimeError("Uninitialized CDFs. Run update() first")
