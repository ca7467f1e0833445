"""GOP-structured test sequences.

Counterpart of spatiotemporalentropymodel_tpu/data/gop.py: a sequence
yields its frames in order, each flagged intra every gop_size-th frame
(1-indexed: index % gop_size == 1, evalSTEM.py:180-209). Here a sequence is
built from frames already in memory (``ArraySequence``); the PNG directory
reader comes with the port of ``data/``.
"""

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np


@dataclass
class GOPFrame:
    image: np.ndarray  # (H, W, 3) float32 in [0, 1]
    index: int  # 1-based frame index within the sequence
    is_intra: bool


class ArraySequence:
    """One sequence of (H, W, 3) uint8 frames, read as the PNG reader reads
    a file: float32 / 255."""

    def __init__(self, frames: Sequence[np.ndarray], gop_size: int,
                 name: str = "seq"):
        self.frames = list(frames)
        self.gop_size = gop_size
        self.name = name

    def __len__(self):
        return len(self.frames)

    def __iter__(self) -> Iterator[GOPFrame]:
        for i, f in enumerate(self.frames):
            idx = i + 1
            yield GOPFrame(np.asarray(f, np.float32) / 255.0, idx,
                           idx % self.gop_size == 1)
