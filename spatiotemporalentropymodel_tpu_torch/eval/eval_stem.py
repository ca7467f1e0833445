"""GOP-structured video evaluation (stem/evalSTEM.py parity).

Counterpart of spatiotemporalentropymodel_tpu/eval/eval_stem.py, with its
calls in the same order. Per sequence, per frame (evalSTEM.py:156-230):
I-frames (index % GOP == 1) go through the image codec (pad ×64 → compress →
decompress → carry ŷ); P-frames through the STEM model conditioned on the
carried latent. Reports PSNR, MS-SSIM, actual bpp (stream lengths, and the
row counts a container carries) and estimated bpp (likelihoods) side by
side (evalSTEM.py:131-141). ``entropy_estimation=True`` skips the coder
(eval_model's --entropy-estimation equivalent). Frames go to the I-model's
device as (1, 3, H, W) f32.

  python -m spatiotemporalentropymodel_tpu_torch.eval.eval_stem \\
      --dataset-root DIR [--dataset uvg|hevc] [--n-gops 3] [--variant res] \\
      [--i-checkpoint CKPT] [--stem-checkpoint CKPT] [--out-json OUT] \\
      [--logfile LOG] [--entropy-estimation true] [--device cuda|cpu]
"""

import json
import math
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from ..ops.padding import crop_centered, pad_centered
from .metrics import actual_bpp, estimate_bpp, ms_ssim_or_nan, psnr


def _frame_tensor(image, device):
    """(H, W, 3) f32 → (1, 3, H, W) on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(image, -1, 0)))[None].to(device)


@torch.no_grad()
def eval_sequence(
    i_model,
    stem,
    sequence: Iterable,
    entropy_estimation: bool = False,
    compute_msssim: bool = True,
    logfile: Optional[str] = None,
    report_estimated_bpp: bool = True,
    pipeline=None,
) -> Dict[str, float]:
    """Evaluate one GOP sequence; returns the metrics averaged over its
    frames, and "frames".

    ``report_estimated_bpp=False`` skips the extra ``forward()`` that only
    produces the estimated-bpp column. ``pipeline``: an optional
    eval/pipeline.StemVideoPipeline (parallel variants); P-frames then run
    its sparse-transport serving path instead of the model API.
    ``logfile``: a line per frame is appended to it.
    """
    log_f = open(logfile, "a") if logfile else None
    sums = {"psnr": 0.0, "ms_ssim": 0.0, "bpp": 0.0, "bpp_est": 0.0,
            "enc_time": 0.0, "dec_time": 0.0}
    n = 0
    y_conditioned = None

    try:
        for frame in sequence:
            x = _frame_tensor(frame.image, i_model.device)
            h, w = x.shape[2], x.shape[3]
            num_pixels = h * w
            x_padded, pads = pad_centered(x, 64)

            if frame.is_intra or y_conditioned is None:
                if entropy_estimation or report_estimated_bpp:
                    fwd = i_model.forward(x_padded)
                    bpp_est = estimate_bpp(fwd["likelihoods"], num_pixels)
                else:
                    bpp_est = float("nan")
                if entropy_estimation:
                    x_hat, y_conditioned = fwd["x_hat"], fwd["y_hat"]
                    bpp = bpp_est
                else:
                    t0 = time.time()
                    enc = i_model.compress(x_padded)
                    enc_t = time.time() - t0
                    t0 = time.time()
                    dec = i_model.decompress(enc["strings"], enc["shape"])
                    dec_t = time.time() - t0
                    x_hat, y_conditioned = dec["x_hat"], dec["y_hat"]
                    bpp = actual_bpp(enc["strings"], num_pixels)
                    sums["enc_time"] += enc_t
                    sums["dec_time"] += dec_t
            elif pipeline is not None and not entropy_estimation:
                if report_estimated_bpp:
                    y_cur, _ = i_model.get_y(x_padded)
                    fwd = stem.forward(y_cur, y_conditioned)
                    bpp_est = estimate_bpp(fwd["likelihoods"], num_pixels)
                else:
                    bpp_est = float("nan")
                t0 = time.time()
                enc, _ = pipeline.encode_frame(x_padded, y_conditioned)
                enc_t = time.time() - t0
                t0 = time.time()
                x_hat, y_hat = pipeline.decode_frame(enc,
                                                     y_cond=y_conditioned)
                dec_t = time.time() - t0
                bpp = actual_bpp(enc["strings"], num_pixels,
                                 counts=enc.get("counts"))
                sums["enc_time"] += enc_t
                sums["dec_time"] += dec_t
                y_conditioned = y_hat
            else:
                y_cur, _ = i_model.get_y(x_padded)
                if entropy_estimation:
                    out = stem.forward(y_cur, y_conditioned)
                    bpp = bpp_est = estimate_bpp(out["likelihoods"],
                                                 num_pixels)
                    y_hat = out["y_hat"]
                else:
                    if report_estimated_bpp:
                        fwd = stem.forward(y_cur, y_conditioned)
                        bpp_est = estimate_bpp(fwd["likelihoods"],
                                               num_pixels)
                    else:
                        bpp_est = float("nan")
                    t0 = time.time()
                    enc = stem.compress(y_cur, y_conditioned)
                    enc_t = time.time() - t0
                    # what some models' containers carry beside the strings
                    # (charm: the transport taken and its per-group counts)
                    # goes back into decompress, so the decoder takes the
                    # encoder's transport
                    kw = {}
                    if "transport" in enc:
                        kw["transport_mode"] = enc["transport"]
                    if enc.get("counts") is not None:
                        kw["counts"] = enc["counts"]
                    t0 = time.time()
                    dec = stem.decompress(enc["strings"], enc["shape"],
                                          y_conditioned, **kw)
                    dec_t = time.time() - t0
                    y_hat = dec["y_hat"]
                    bpp = actual_bpp(enc["strings"], num_pixels,
                                     counts=enc.get("counts"))
                    sums["enc_time"] += enc_t
                    sums["dec_time"] += dec_t
                y_conditioned = y_hat
                x_hat = i_model.get_x(y_hat)

            x_hat = crop_centered(x_hat, pads)
            p = float(psnr(x, x_hat))
            m = ms_ssim_or_nan(x, x_hat) if compute_msssim else float("nan")
            sums["psnr"] += p
            sums["ms_ssim"] += 0.0 if math.isnan(m) else m
            sums["bpp"] += bpp
            sums["bpp_est"] += 0.0 if math.isnan(bpp_est) else bpp_est
            n += 1
            if log_f:
                kind = "I" if frame.is_intra else "P"
                log_f.write(
                    f"{frame.index:04d} {kind} psnr={p:.4f} msssim={m:.6f} "
                    f"bpp={bpp:.6f} bpp_est={bpp_est:.6f}\n"
                )
    finally:
        if log_f:
            log_f.close()
    return {k: v / max(n, 1) for k, v in sums.items()} | {"frames": n}


def eval_dataset(
    i_model,
    stem,
    dataset,
    entropy_estimation: bool = False,
    compute_msssim: bool = True,
    logfile: Optional[str] = None,
    out_json: Optional[str] = None,
    report_estimated_bpp: bool = True,
    use_pipeline: bool = False,
) -> Dict:
    """Evaluate every sequence; returns {sequence name: metrics, "average":
    the means of psnr, ms_ssim, bpp and bpp_est over the sequences}, and
    writes it to ``out_json`` where one is given. ``use_pipeline=True``
    (parallel variants) runs P-frames through one StemVideoPipeline."""
    pipeline = None
    if use_pipeline:
        from .pipeline import StemVideoPipeline

        pipeline = StemVideoPipeline(i_model, stem)
    results = {}
    for seq in dataset:
        results[seq.name] = eval_sequence(
            i_model, stem, seq, entropy_estimation, compute_msssim, logfile,
            report_estimated_bpp=report_estimated_bpp, pipeline=pipeline,
        )
    keys = ["psnr", "ms_ssim", "bpp", "bpp_est"]
    avg = {
        k: float(np.mean([r[k] for r in results.values()])) for k in keys
    } if results else {}
    results["average"] = avg
    if out_json:
        with open(out_json, "w") as f:
            json.dump(results, f, indent=2)
    return results


def main(argv=None):
    """The GOP evaluation of a STEM variant (EB 256, M 192) behind a zoo
    I-model, each from its checkpoint's ``"model"`` entry where one is
    given (else the seeded initialisation), on ``--device``; prints the
    averages as JSON."""
    from ..data import GOPDataset, HEVC_GOP, UVG_GOP
    from ..models import SpatioTemporalPriorModel
    from ..training.checkpoints import load_checkpoint
    from ..utils.config import EvalStemConfig, parse_config
    from ..zoo import create_model

    config = parse_config(EvalStemConfig, argv)
    gop = UVG_GOP if config.dataset == "uvg" else HEVC_GOP

    i_model = create_model(config.i_model, config.i_quality,
                           device=config.device)
    if config.i_checkpoint:
        i_model.load_state_leaves(
            load_checkpoint(config.i_checkpoint)["model"])
    i_model.update()

    stem = SpatioTemporalPriorModel(variant=config.variant,
                                    device=config.device)
    if config.stem_checkpoint:
        stem.load_state_leaves(
            load_checkpoint(config.stem_checkpoint)["model"])
    stem.update()

    dataset = GOPDataset(config.dataset_root, gop, config.n_gops)
    results = eval_dataset(
        i_model, stem, dataset, config.entropy_estimation,
        logfile=config.logfile, out_json=config.out_json,
    )
    print(json.dumps(results.get("average", {}), indent=2))


if __name__ == "__main__":
    main()
