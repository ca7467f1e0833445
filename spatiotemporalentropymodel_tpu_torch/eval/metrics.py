"""Quality and rate metrics: PSNR, SSIM, MS-SSIM and bits per pixel.

Counterpart of spatiotemporalentropymodel_tpu/eval/metrics.py, on NCHW
tensors. PSNR is −10·log10(MSE) on [0, 1] images and MS-SSIM follows
pytorch_msssim's computation order (gaussian window 11, σ = 1.5, the
standard 5-scale weights), as the reference evaluates (stem/evalSTEM.py:
16-33, 131-141). Images in another float dtype are compared in f32.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F


def mse(a, b):
    return torch.mean((a.float() - b.float()) ** 2)


def psnr(a, b, max_val: float = 1.0):
    """−10·log10(MSE / max²) (evalSTEM.py:24-27)."""
    return -10.0 * torch.log10(mse(a, b) / (max_val ** 2))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5):
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    g /= g.sum()
    return torch.from_numpy(np.outer(g, g).astype(np.float32))


def _filter2d(x, kernel):
    """Depthwise 'valid' 2-D filter on NCHW."""
    c = x.shape[1]
    k = kernel.to(x.device)[None, None].expand(c, 1, *kernel.shape)
    return F.conv2d(x, k, groups=c)


def _ssim_per_channel(a, b, max_val, kernel_size, sigma):
    """SSIM and contrast-structure means over H, W → (B, C) each."""
    c1 = (0.01 * max_val) ** 2
    c2 = (0.03 * max_val) ** 2
    kernel = _gaussian_kernel(kernel_size, sigma)
    mu_a = _filter2d(a, kernel)
    mu_b = _filter2d(b, kernel)
    mu_aa, mu_bb, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_aa = _filter2d(a * a, kernel) - mu_aa
    sigma_bb = _filter2d(b * b, kernel) - mu_bb
    sigma_ab = _filter2d(a * b, kernel) - mu_ab
    cs_map = (2 * sigma_ab + c2) / (sigma_aa + sigma_bb + c2)
    ssim_map = ((2 * mu_ab + c1) / (mu_aa + mu_bb + c1)) * cs_map
    return ssim_map.mean(dim=(2, 3)), cs_map.mean(dim=(2, 3))


def ssim(a, b, max_val: float = 1.0, kernel_size: int = 11,
         sigma: float = 1.5, return_cs: bool = False):
    """Single-scale SSIM (mean over N, C, H, W)."""
    s, cs = _ssim_per_channel(a.float(), b.float(), max_val, kernel_size,
                              sigma)
    if return_cs:
        return s.mean(), cs.mean()
    return s.mean()


_MSSSIM_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _avg_pool2(x):
    """2×2 average pool as ``F.avg_pool2d(x, 2, padding=dim % 2)``: odd
    dims zero-padded on both sides, the pad counted in the mean (the JAX
    package's order of sums)."""
    ph, pw = x.shape[2] % 2, x.shape[3] % 2
    if ph or pw:
        x = F.pad(x, (pw, pw, ph, ph))
    oh = (x.shape[2] - 2) // 2 + 1
    ow = (x.shape[3] - 2) // 2 + 1
    x = (x[:, :, 0:2 * oh:2] + x[:, :, 1:2 * oh:2]) * 0.5
    return (x[:, :, :, 0:2 * ow:2] + x[:, :, :, 1:2 * ow:2]) * 0.5


def ms_ssim(a, b, max_val: float = 1.0, kernel_size: int = 11,
            sigma: float = 1.5):
    """Multi-scale SSIM, standard 5-scale weights (Wang et al. 2003), in
    pytorch_msssim's order: per-(batch, channel) cs/ssim means, relu'd
    stack, weighted geometric product per (B, C), one mean at the end."""
    a, b = a.float(), b.float()
    levels = len(_MSSSIM_WEIGHTS)
    min_side = min(a.shape[2], a.shape[3])
    least = (kernel_size - 1) * 2 ** (levels - 1)
    if min_side <= least:
        raise ValueError(
            f"ms_ssim needs min(H, W) > {least} for {levels} scales with "
            f"kernel_size={kernel_size}; got {min_side}")
    vals = []
    for i in range(levels):
        s, cs = _ssim_per_channel(a, b, max_val, kernel_size, sigma)
        vals.append(s if i == levels - 1 else cs)
        if i < levels - 1:
            a, b = _avg_pool2(a), _avg_pool2(b)
    stack = torch.relu(torch.stack(vals))  # (levels, B, C)
    weights = torch.tensor(_MSSSIM_WEIGHTS, device=stack.device)
    return torch.prod(stack ** weights[:, None, None], dim=0).mean()


def ms_ssim_or_nan(a, b, **kw) -> float:
    """``ms_ssim`` where the input meets the 5-scale size contract, else
    NaN."""
    try:
        return float(ms_ssim(a, b, **kw))
    except ValueError:
        return float("nan")


def estimate_bpp(likelihoods, num_pixels: int) -> float:
    """Estimated bits per pixel from model likelihoods (evalSTEM.py:
    133-136): −Σ log2 over every likelihood tensor of the dict, summed in
    f64."""
    total = 0.0
    for key in sorted(likelihoods):
        lk = likelihoods[key]
        total += float(torch.log(lk.float()).sum(dtype=torch.float64))
    return total / (-math.log(2) * num_pixels)


def _stream_bytes(strings) -> int:
    if isinstance(strings, (list, tuple)):
        return sum(_stream_bytes(s) for s in strings)
    return len(strings)


def actual_bpp(strings, num_pixels: int, counts=None) -> float:
    """Bits per pixel from the bitstream lengths (evalSTEM.py:131-132),
    through any nesting of string lists. ``counts``, CDF-row counts that a
    container carries, are charged at their wire cost
    (``entropy/transport.py::pack_counts``)."""
    nbytes = _stream_bytes(strings)
    if counts is not None:
        from ..entropy.transport import pack_counts

        c = np.asarray(counts)
        nbytes += len(pack_counts(c.reshape(-1, c.shape[-1])))
    return nbytes * 8.0 / num_pixels
