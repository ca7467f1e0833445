"""Batch image-codec evaluation over a directory of images.

Counterpart of spatiotemporalentropymodel_tpu/eval/eval_model.py
(compressai/utils/eval_model/__main__.py:256-302): per-image ×64 padding,
real coding or --entropy-estimation, PSNR/MS-SSIM/bpp + timing, JSON results
consumed by the plot CLI. The port reads PNG only (``data/png.py``): a file
with another image suffix raises.

Usage:
  python -m spatiotemporalentropymodel_tpu_torch.eval.eval_model DIR \\
      -a bmshj2018-factorized -q 1 2 [--checkpoint CKPT] \\
      [--entropy-estimation] [-o OUT.json] [--device cuda|cpu]
"""

import argparse
import json
import os
import time
from typing import Dict, List

import torch

from ..ops.padding import crop_centered, pad_centered
from .codec import _load_image, to_device
from .metrics import actual_bpp, estimate_bpp, ms_ssim_or_nan, psnr

IMG_EXTENSIONS = (".png", ".jpg", ".jpeg", ".bmp", ".ppm")


def collect_images(rootpath: str) -> List[str]:
    return sorted(
        os.path.join(rootpath, f)
        for f in os.listdir(rootpath)
        if os.path.splitext(f)[1].lower() in IMG_EXTENSIONS
    )


def _load(path, device):
    """(1, 3, H, W) f32 on ``device``, from a PNG file."""
    if os.path.splitext(path)[1].lower() != ".png":
        raise ValueError(f"{path}: the port reads PNG images only (JPEG, "
                         f"BMP and PPM input is not ported)")
    return to_device(_load_image(path), device)


def _clock(device) -> float:
    """perf_counter after the device's queued work has finished."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


@torch.no_grad()
def eval_image(model, x, entropy_estimation: bool = False) -> Dict[str, float]:
    """x (1, 3, H, W) in [0, 1] on the model's device."""
    h, w = x.shape[2], x.shape[3]
    num_pixels = h * w
    x_padded, pads = pad_centered(x, 64)

    if entropy_estimation:
        out = model.forward(x_padded)
        bpp = float(estimate_bpp(out["likelihoods"], num_pixels))
        x_hat = out["x_hat"]
        enc_t = dec_t = float("nan")
    else:
        t0 = _clock(x.device)
        enc = model.compress(x_padded)
        enc_t = _clock(x.device) - t0
        t0 = _clock(x.device)
        dec = model.decompress(enc["strings"], enc["shape"])
        x_hat = dec["x_hat"]
        dec_t = _clock(x.device) - t0
        bpp = actual_bpp(enc["strings"], num_pixels)

    x_hat = crop_centered(x_hat.float(), pads)
    return {
        "psnr": float(psnr(x, x_hat)),
        "ms-ssim": ms_ssim_or_nan(x, x_hat),
        "bpp": bpp,
        "encoding_time": enc_t,
        "decoding_time": dec_t,
    }


def eval_model(model, filepaths: List[str],
               entropy_estimation: bool = False) -> Dict[str, float]:
    metrics: Dict[str, float] = {}
    for path in filepaths:
        rv = eval_image(model, _load(path, model.device), entropy_estimation)
        for k, v in rv.items():
            metrics[k] = metrics.get(k, 0.0) + v
    return {k: v / len(filepaths) for k, v in metrics.items()}


def main(argv=None):
    from ..zoo import create_model, model_architectures

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("dataset", help="image directory")
    parser.add_argument("-a", "--architecture", required=True,
                        choices=list(model_architectures))
    parser.add_argument("-q", "--qualities", type=int, nargs="+", default=[1])
    parser.add_argument("--checkpoint", help="framework checkpoint path")
    parser.add_argument("--entropy-estimation", action="store_true")
    parser.add_argument("-o", "--output")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run the models on")
    args = parser.parse_args(argv)

    filepaths = collect_images(args.dataset)
    if not filepaths:
        raise SystemExit("no images found")

    results = {"name": args.architecture, "results": {}}
    for q in args.qualities:
        model = create_model(args.architecture, q, device=args.device)
        if args.checkpoint:
            from ..training.checkpoints import load_checkpoint

            model.load_state_leaves(load_checkpoint(args.checkpoint)["model"])
        model.update()
        metrics = eval_model(model, filepaths, args.entropy_estimation)
        for k, v in metrics.items():
            results["results"].setdefault(k, []).append(v)

    output = json.dumps(results, indent=2)
    print(output)
    if args.output:
        with open(args.output, "w") as f:
            f.write(output)
    return results


if __name__ == "__main__":
    main()
