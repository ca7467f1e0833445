"""Quality-map synthesis for variable-rate / ROI training.

A copy of spatiotemporalentropymodel_tpu/data/qmap.py, NumPy only, with its
draws in the same order, so the same ``random.Random(seed)`` gives the same
map byte for byte (stem_roi/stem_roi_dataset.py:105-146): per training
sample the Qmap is 30% uniform (with a high-rate bias branch), 30% a linear
gradient between two random levels (randomly transposed), 40% a sum of 1-20
axis-aligned Gaussian kernels on the pixel grid, rescaled to a random peak.
Output normalized to [0, 1], shape (H, W, 1) float32, host-side like the
frames (the models take it as (B, 1, H, W) on the device). Test maps are
uniform at a fixed level.
"""

import random
from typing import Optional, Tuple

import numpy as np


def synthesize_qmap(
    size: int,
    level_range: Tuple[int, int] = (0, 100),
    p_uniform: float = 0.3,
    rng: Optional[random.Random] = None,
) -> np.ndarray:
    rng = rng or random
    top = level_range[1]
    qmap = np.zeros((size, size), np.float64)
    sample = rng.random()
    if sample < p_uniform:
        tmp = rng.random()
        if tmp < 0.01:
            qmap[:] = 0
        elif tmp < 0.20:
            qmap[:] = (top + 1) * (1 - tmp)  # high-rate bias branch
        else:
            qmap[:] = (top + 1) * rng.random()
    elif sample < 2 * p_uniform:
        v1 = rng.random() * top
        v2 = rng.random() * top
        qmap = np.tile(np.linspace(v1, v2, size), (size, 1))
        if rng.random() < 0.5:
            qmap = qmap.T
    else:
        ii, jj = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
        n_kernels = int(1 + rng.random() * 20)
        for _ in range(n_kernels):
            mu_x = size * rng.random()
            mu_y = size * rng.random()
            var_x = 2000 * rng.random() + 1000
            var_y = 2000 * rng.random() + 1000
            # axis-aligned bivariate normal density on the pixel grid
            log_p = (
                -0.5 * ((ii - mu_x) ** 2 / var_x + (jj - mu_y) ** 2 / var_y)
                - 0.5 * np.log((2 * np.pi) ** 2 * var_x * var_y)
            )
            qmap += np.exp(log_p)
        qmap *= 100 / qmap.max() * (0.5 * rng.random() + 0.5)

    qmap = qmap.astype(np.float32) / top
    return qmap[..., None]  # (H, W, 1)


def uniform_qmap(size: int, level: float, level_max: int = 100) -> np.ndarray:
    """Eval-mode uniform map at a fixed level (stem_roi_dataset.py:139-146)."""
    return np.full((size, size, 1), level / level_max, np.float32)


def gradient_qmap(shape: Tuple[int, int], v1: float, v2: float,
                  horizontal: bool = True, level_max: int = 100) -> np.ndarray:
    """Gradient test maps (eval levels −1/−2, eval_stem_roi.py:33-104)."""
    h, w = shape
    if horizontal:
        q = np.tile(np.linspace(v1, v2, w), (h, 1))
    else:
        q = np.tile(np.linspace(v1, v2, h)[:, None], (1, w))
    return (q / level_max).astype(np.float32)[..., None]
