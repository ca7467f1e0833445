"""Flat image-folder dataset (train/test split subdirectories).

Counterpart of spatiotemporalentropymodel_tpu/data/image_folder.py
(compressai/datasets/utils.py:21-66): root/{train,test} directories of
images; a missing split raises. The port reads PNG only (``data/png.py``,
no PIL): a split that holds JPEG or BMP files, which the JAX package reads
through PIL, raises rather than being read as a smaller dataset.
"""

import random
from pathlib import Path
from typing import Optional

import numpy as np

from .png import read_png

_OTHER_IMAGES = (".jpg", ".jpeg", ".bmp")


class ImageFolder:
    def __init__(self, root: str, split: str = "train",
                 cropsize: Optional[int] = None, training: bool = True,
                 rng: Optional[random.Random] = None):
        splitdir = Path(root) / split
        if not splitdir.is_dir():
            raise RuntimeError(f'Invalid directory "{splitdir}"')
        files = sorted(splitdir.iterdir())
        other = [p.name for p in files if p.suffix.lower() in _OTHER_IMAGES]
        if other:
            raise ValueError(f"{splitdir}: the port reads PNG only, found "
                             f"{other[:3]}")
        self.samples = [p for p in files if p.suffix.lower() == ".png"]
        self.cropsize = cropsize
        self.training = training
        self.rng = rng or random.Random()

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, index: int) -> np.ndarray:
        arr = read_png(self.samples[index]).astype(np.float32) / 255.0
        if self.cropsize:
            cs = self.cropsize
            h, w = arr.shape[:2]
            if self.training:
                top = self.rng.randint(0, max(h - cs, 0))
                left = self.rng.randint(0, max(w - cs, 0))
            else:
                top, left = (h - cs) // 2, (w - cs) // 2
            arr = arr[top : top + cs, left : left + cs]
        return arr
