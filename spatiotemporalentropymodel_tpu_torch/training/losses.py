"""Rate / rate-distortion losses.

Counterpart of spatiotemporalentropymodel_tpu/training/losses.py (root
utils.py:8-101 of the reference: EMLoss, RateDistortionLoss,
PixelwiseRateDistortionLoss, quality2lambda). Pure functions over the
models' output dicts with NCHW targets; all return {"loss", ...} dicts of
scalar tensors.
"""

import math

import torch

_LOG2 = math.log(2.0)


def _bpp(likelihoods, num_pixels):
    return torch.sum(torch.log(likelihoods)) / (-_LOG2 * num_pixels)


def em_loss(output, target, upscale: int = 16):
    """Rate-only loss for STEM training (utils.py:8-27).

    The reference normalizes bpp by *image* pixels (EMLoss is called with
    the image, utils.py:19-21). The train steps hold latents, so `target`
    is the latent (B, M, h, w) and ``num_pixels`` is its B·h·w scaled by the
    fixed ×16 analysis stride (``upscale``); pass ``upscale=1`` when
    `target` is the image itself.
    """
    n, h, w = target.shape[0], target.shape[2], target.shape[3]
    num_pixels = n * h * w * upscale * upscale
    y_bpp = _bpp(output["likelihoods"]["y"], num_pixels)
    z_bpp = _bpp(output["likelihoods"]["z"], num_pixels)
    return {"y_bpp_loss": y_bpp, "z_bpp_loss": z_bpp, "loss": y_bpp + z_bpp}


def rate_distortion_loss(output, target, lmbda: float = 1e-2):
    """λ·255²·MSE + bpp (utils.py:30-50). target: NCHW image in [0, 1]."""
    n, h, w = target.shape[0], target.shape[2], target.shape[3]
    num_pixels = n * h * w
    bpp = sum(_bpp(lk, num_pixels) for lk in output["likelihoods"].values())
    mse = torch.mean((output["x_hat"] - target) ** 2)
    return {"bpp_loss": bpp, "mse_loss": mse,
            "loss": lmbda * 255**2 * mse + bpp}


def pixelwise_rate_distortion_loss(output, target, lmbdamap):
    """Per-pixel λ-map distortion (utils.py:53-74). lmbdamap: (B, 1, H, W)."""
    n, h, w = target.shape[0], target.shape[2], target.shape[3]
    num_pixels = n * h * w
    bpp = sum(torch.sum(-torch.log2(lk)) / num_pixels
              for lk in output["likelihoods"].values())
    mse = (output["x_hat"] - target) ** 2
    weighted = torch.mean(torch.broadcast_to(lmbdamap, mse.shape) * mse)
    return {"bpp_loss": bpp, "mse_loss": weighted,
            "loss": 255**2 * weighted + bpp}


def quality2lambda(qmap):
    """Quality-map → λ-map fitted curve (utils.py:97-101)."""
    return 0.002 * torch.exp(3.4409 * qmap)
