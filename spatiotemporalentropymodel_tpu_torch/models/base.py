"""CompressionModel host wrapper.

Counterpart of spatiotemporalentropymodel_tpu/models/base.py
(compressai/models/priors.py:42-106): a thin host object around

  * an ``nn.Module`` (``self.module``) holding the architecture and weights,
    on ``self.device``,
  * explicit :class:`CodecTables` per entropy-model instance
    (``self.tables``), built by the pure NumPy ``update`` functions,
  * a serving compute dtype (``set_compute_dtype``): f32 by default, bf16
    for the transform nets with f32 entropy math.
"""

from typing import Any, Dict

import numpy as np
import torch

from ..coders import get_coder
from ..entropy import (
    get_scale_table,
    update_bottleneck_tables,
    update_gaussian_tables,
)
from ..ops import kernels


def _nhwc_flat(t, b):
    """NCHW (b, c, h, w) → (b, h·w·c) in the JAX package's NHWC order."""
    return t.permute(0, 2, 3, 1).reshape(b, -1)


def _as_bytes(t):
    return t.contiguous().view(torch.uint8).reshape(-1)


def _nchw(t, dtype=torch.float32):
    """A ``dtype`` copy with the canonical NCHW strides. ``.contiguous()`` is
    not enough: a permuted tensor with a size-1 dimension counts as
    contiguous yet keeps channels-last strides, which steer the convs to
    other algorithms, and then the decoder's (σ, μ) and ŷ would differ from
    the encoder's in the last bit."""
    return torch.empty(t.shape, dtype=dtype, device=t.device).copy_(t)


def _to_nchw(plane_nhwc: np.ndarray, device):
    """Host NHWC int plane → device NCHW int32 tensor, canonical strides."""
    t = torch.from_numpy(np.ascontiguousarray(plane_nhwc, np.int32))
    return _nchw(t.to(device).permute(0, 3, 1, 2), torch.int32)


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

    # serving compute dtype of the transform nets; None = float32. The
    # fused codec expressions cast back to f32 before quantization and CDF
    # indexing whatever it is.
    compute_dtype = None

    @torch.no_grad()
    def set_compute_dtype(self, dtype=None):
        """Serve the transform nets at ``dtype`` (e.g. ``torch.bfloat16``);
        models/base.py:90-112 of the JAX package.

        Casts the floating parameters of ``module`` and marks inputs for
        casting (``_cast_in``); the codec tables stay exact. Call AFTER the
        weights are final and AFTER ``update()``, so the tables come from
        full-precision quantiles. The cast is lossy: ``None`` serves f32
        again, but only reloading the weights recovers them exactly.
        """
        self.compute_dtype = dtype
        target = torch.float32 if dtype is None else dtype
        for p in self.module.parameters():
            if p.is_floating_point():
                p.data = p.data.to(target)

    def _cast(self, t):
        """A net input in the compute dtype, with the canonical NCHW
        strides on encoder and decoder alike (see ``_nchw``); f32 inputs
        pass as they are when no compute dtype is set."""
        if self.compute_dtype is None:
            return t
        return _nchw(t, self.compute_dtype)

    def _cast_in(self, t):
        """An input in the compute dtype (models/base.py:114-119)."""
        if self.compute_dtype is not None and t.is_floating_point():
            return t.to(self.compute_dtype)
        return t

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
        # device copies of the constants every frame reads (an upload per
        # frame would also sync the stream)
        self._medians = torch.as_tensor(
            self.tables["entropy_bottleneck"].medians, dtype=torch.float32,
            device=self.device,
        ).view(1, -1, 1, 1)
        if self.has_gaussian:
            self._scale_table = kernels.scale_table_tensor(
                self.tables["gaussian_conditional"].scale_table, self.device
            )
        return True

    def _require_tables(self):
        if not self.tables:
            raise RuntimeError("Uninitialized CDFs. Run update() first")
