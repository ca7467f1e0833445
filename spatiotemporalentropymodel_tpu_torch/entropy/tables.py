"""Codec-table containers (a copy of spatiotemporalentropymodel_tpu/entropy/tables.py).

The reference stores quantized CDF tables in registered torch buffers mutated
by ``update()`` (entropy_models.py:92-95, 341-381, 543-568) and needs a
buffer-resize dance on checkpoint load (models/utils.py:46-109). Here tables
are a plain immutable pytree of host NumPy arrays produced by pure ``update``
functions — they serialize with the checkpoint like any other array and never
require shape surgery.
"""

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class CodecTables:
    """Quantized CDF rows + metadata for one entropy model instance.

    cdf:        (rows, max_len+2) int32, each row [0, ..., 2^16] left-aligned
    cdf_length: (rows,) int32 — valid entries per row (pmf_length + 2)
    offset:     (rows,) int32 — symbol offset per row
    scale_table:(levels,) float64 — only for GaussianConditional
    medians:    (channels,) float64 — only for EntropyBottleneck
    """

    cdf: np.ndarray
    cdf_length: np.ndarray
    offset: np.ndarray
    scale_table: Optional[np.ndarray] = None
    medians: Optional[np.ndarray] = None

    @property
    def rows(self) -> int:
        return int(self.cdf.shape[0])

    def asdict(self):
        return {
            k: v
            for k, v in dataclasses.asdict(self).items()
            if v is not None
        }

    @classmethod
    def fromdict(cls, d):
        return cls(
            cdf=np.asarray(d["cdf"], np.int32),
            cdf_length=np.asarray(d["cdf_length"], np.int32),
            offset=np.asarray(d["offset"], np.int32),
            scale_table=(
                np.asarray(d["scale_table"], np.float64)
                if d.get("scale_table") is not None
                else None
            ),
            medians=(
                np.asarray(d["medians"], np.float64)
                if d.get("medians") is not None
                else None
            ),
        )
