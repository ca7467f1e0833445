"""Vimeo-90k septuplet loader (host-side NumPy, NHWC).

Counterpart of spatiotemporalentropymodel_tpu/data/vimeo.py
(stem/dataset_vidseq.py:25-103: 7-frame sequences from
sep_trainlist/sep_testlist, the same random crop across all frames, 50 %
temporal reversal) and of the training-time temporal subsampling of
trainSTEM.py:176-182. Frames are read with ``data/png.py`` (no PIL); the
crops and reversals come from the same ``random.Random`` draws as the JAX
package's, so a seed gives the same samples. Batches are NHWC float32 in
[0, 1]; the train loops move them to the card as NCHW.
"""

import os
import random
from typing import Optional

import numpy as np

from .png import read_png

# trainSTEM.py:176-182: random temporal subsampling per batch
TEMPORAL_SUBSAMPLES = (
    (0, 2, 4, 6),  # frames 1,3,5,7 (1-indexed in the reference)
    (0, 3, 6),     # frames 1,4,7
    (0, 6),        # frames 1,7
    (0, 1, 2, 3, 4, 5, 6),
)


def _load_image(path: str) -> np.ndarray:
    return read_png(path).astype(np.float32) / 255.0


class VimeoSepTuplet:
    """Indexable dataset of 7-frame sequences: (7, H, W, 3) float32 arrays,
    one crop for all frames of a sequence (dataset_vidseq.py:12-22),
    training sequences reversed with p = 0.5 (:81-83)."""

    def __init__(self, data_root: str, is_training: bool = True,
                 cropsize: int = 256, rng: Optional[random.Random] = None):
        self.data_root = data_root
        self.image_root = os.path.join(data_root, "sequences")
        self.training = is_training
        self.cropsize = cropsize
        self.rng = rng or random.Random()
        list_file = os.path.join(
            data_root, "sep_trainlist.txt" if is_training else "sep_testlist.txt"
        )
        with open(list_file) as f:
            self.seqlist = [line.strip() for line in f if line.strip()]

    def __len__(self):
        return len(self.seqlist)

    def _crop_params(self, h, w):
        cs = self.cropsize
        if h == cs and w == cs:
            return 0, 0
        if self.training:
            return self.rng.randint(0, h - cs), self.rng.randint(0, w - cs)
        return int(round((h - cs) / 2)), int(round((w - cs) / 2))

    def _frame_path(self, seq: str, i: int) -> str:
        # Vimeo-90k names frames im1.png..im7.png; f%03d.png for older
        # fixtures, as in the JAX package
        p = os.path.join(self.image_root, seq, f"im{i}.png")
        if os.path.exists(p):
            return p
        return os.path.join(self.image_root, seq, f"f{i:03d}.png")

    def __getitem__(self, index: int) -> np.ndarray:
        seq = self.seqlist[index]
        frames = [_load_image(self._frame_path(seq, i)) for i in range(1, 8)]
        h, w = frames[0].shape[:2]
        top, left = self._crop_params(h, w)
        cs = self.cropsize
        frames = [f[top : top + cs, left : left + cs] for f in frames]
        if self.training and self.rng.random() >= 0.5:
            frames = frames[::-1]
        return np.stack(frames)  # (7, cs, cs, 3)


def subsample_frames(batch: np.ndarray, rng: Optional[random.Random] = None):
    """Apply the trainSTEM temporal subsampling to a (B, 7, H, W, C) batch."""
    rng = rng or random
    idx = rng.choice(TEMPORAL_SUBSAMPLES)
    return batch[:, list(idx)]
