"""GOP-structured test sequences (UVG / HEVC class B PNG dirs).

Counterpart of spatiotemporalentropymodel_tpu/data/gop.py: a sequence
yields its frames in order, each flagged intra every gop_size-th frame
(1-indexed: index % gop_size == 1, evalSTEM.py:180-209). ``GOPSequence``
reads a directory of frame PNGs through ``data/png.py`` (the first
``gop_size * n_gops`` frames, in numeric order), ``GOPDataset`` every
sequence directory under a root, and ``ArraySequence`` takes frames already
in memory. The port reads PNG only: a ``.jpg`` or ``.bmp`` frame raises.
"""

import os
import re
from dataclasses import dataclass
from typing import Iterator, Optional, Sequence

import numpy as np

from .png import read_png

# evalSTEM.py:180-187: GOP 12 for UVG (36 frames/seq), GOP 10 for HEVC (30)
UVG_GOP = 12
HEVC_GOP = 10


def _numeric_key(name: str):
    nums = re.findall(r"\d+", name)
    return (int(nums[-1]) if nums else 0, name)


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


class GOPSequence:
    """One sequence = one directory of frame PNGs."""

    def __init__(self, frame_dir: str, gop_size: int,
                 n_frames: Optional[int] = None):
        self.frame_dir = frame_dir
        self.gop_size = gop_size
        files = sorted(
            (
                f
                for f in os.listdir(frame_dir)
                if f.lower().endswith((".png", ".jpg", ".bmp"))
            ),
            key=_numeric_key,
        )
        if n_frames is not None:
            files = files[:n_frames]
        self.files = files
        self.name = os.path.basename(frame_dir.rstrip("/"))

    def __len__(self):
        return len(self.files)

    def __iter__(self) -> Iterator[GOPFrame]:
        for i, fname in enumerate(self.files):
            arr = read_png(os.path.join(self.frame_dir, fname))
            idx = i + 1
            yield GOPFrame(arr.astype(np.float32) / 255.0, idx,
                           idx % self.gop_size == 1)


class GOPDataset:
    """All sequences under a root directory (one subdir per sequence)."""

    def __init__(self, root: str, gop_size: int = UVG_GOP,
                 n_gops: Optional[int] = None):
        self.root = root
        self.gop_size = gop_size
        n_frames = gop_size * n_gops if n_gops else None
        self.sequences = [
            GOPSequence(os.path.join(root, d), gop_size, n_frames)
            for d in sorted(os.listdir(root))
            if os.path.isdir(os.path.join(root, d))
        ]

    def __iter__(self):
        return iter(self.sequences)

    def __len__(self):
        return len(self.sequences)
