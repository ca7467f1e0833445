"""Color-space transforms (BT.709 RGB↔YCbCr, YUV 444↔420), NCHW.

Counterpart of spatiotemporalentropymodel_tpu/data/transforms.py, which is
NHWC. These follow the reference's own layout, NCHW
(compressai/transforms/functional.py:26-135), as the rest of the port does:
a frame is (N, 3, H, W) or (3, H, W), a plane (N, 1, H, W).
"""

from typing import Tuple

import torch
import torch.nn.functional as F

# ITU-R BT.709: (K_r, K_g, K_b), K_g = 1 − K_r − K_b
YCBCR_WEIGHTS = {"ITU-R_BT.709": (0.2126, 0.7152, 0.0722)}


def _check(x):
    if x.dim() not in (3, 4) or x.shape[-3] != 3:
        raise ValueError(
            "Expected an NCHW or CHW tensor with 3 channels, got "
            f"shape {tuple(x.shape)}"
        )


def rgb2ycbcr(rgb):
    _check(rgb)
    kr, kg, kb = YCBCR_WEIGHTS["ITU-R_BT.709"]
    r, g, b = rgb.unbind(-3)
    y = kr * r + kg * g + kb * b
    cb = 0.5 * (b - y) / (1 - kb) + 0.5
    cr = 0.5 * (r - y) / (1 - kr) + 0.5
    return torch.stack([y, cb, cr], dim=-3)


def ycbcr2rgb(ycbcr):
    _check(ycbcr)
    kr, kg, kb = YCBCR_WEIGHTS["ITU-R_BT.709"]
    y, cb, cr = ycbcr.unbind(-3)
    r = y + (2 - 2 * kr) * (cr - 0.5)
    b = y + (2 - 2 * kb) * (cb - 0.5)
    g = (y - kr * r - kb * b) / kg
    return torch.stack([r, g, b], dim=-3)


def yuv_444_to_420(yuv, mode: str = "avg_pool"):
    """(N, 3, H, W) → (y (N, 1, H, W), u (N, 1, H/2, W/2), v (N, 1, H/2,
    W/2)), u and v by a 2×2 average pool."""
    if mode != "avg_pool":
        raise ValueError(f'Invalid downsampling mode "{mode}".')
    if isinstance(yuv, (tuple, list)):
        y, u, v = yuv
    else:
        y, u, v = yuv.split(1, dim=1)
    return y, F.avg_pool2d(u, 2), F.avg_pool2d(v, 2)


def yuv_420_to_444(yuv: Tuple, mode: str = "bilinear",
                   return_tuple: bool = False):
    """(y, u, v) → (N, 3, H, W), u and v upsampled ×2: bilinear (half-pixel
    centres, the edge sample repeated at the border, as
    ``jax.image.resize`` gives it for ×2) or nearest."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f'Invalid upsampling mode "{mode}".')
    y, u, v = yuv

    def _up(t):
        if mode == "nearest":
            return t.repeat_interleave(2, dim=-2).repeat_interleave(2, dim=-1)
        return F.interpolate(t, scale_factor=2, mode="bilinear",
                             align_corners=False)

    u, v = _up(u), _up(v)
    if return_tuple:
        return y, u, v
    return torch.cat([y, u, v], dim=1)
