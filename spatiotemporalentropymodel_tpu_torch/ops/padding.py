"""Spatial padding helpers for codec inputs.

Counterpart of spatiotemporalentropymodel_tpu/ops/padding.py, on NCHW
tensors: the reference pads inputs to a multiple of 64 before coding and
crops after decoding (stem/evalSTEM.py:41-52). Padding is zeros.
"""

import torch.nn.functional as F


def pad_to_multiple(x, multiple: int = 64, mode: str = "constant"):
    """Pad an NCHW batch so H and W are multiples of ``multiple``, at the
    bottom and right. Returns (padded, (H, W)), the original size."""
    h, w = x.shape[2], x.shape[3]
    ph = (multiple - h % multiple) % multiple
    pw = (multiple - w % multiple) % multiple
    if ph == 0 and pw == 0:
        return x, (h, w)
    return F.pad(x, (0, pw, 0, ph), mode=mode), (h, w)


def crop_to(x, size):
    """Crop an NCHW batch back to (H, W)."""
    h, w = size
    return x[:, :, :h, :w]


def pad_centered(x, multiple: int = 64):
    """Centred padding to a multiple of ``multiple`` (evalSTEM's). Returns
    (padded, pads) with pads = (top, bottom, left, right)."""
    h, w = x.shape[2], x.shape[3]
    new_h = (h + multiple - 1) // multiple * multiple
    new_w = (w + multiple - 1) // multiple * multiple
    top = (new_h - h) // 2
    left = (new_w - w) // 2
    pads = (top, new_h - h - top, left, new_w - w - left)
    return F.pad(x, (pads[2], pads[3], pads[0], pads[1])), pads


def crop_centered(x, pads):
    """Inverse of :func:`pad_centered`."""
    top, bottom, left, right = pads
    h, w = x.shape[2], x.shape[3]
    return x[:, :, top:h - bottom, left:w - right]
