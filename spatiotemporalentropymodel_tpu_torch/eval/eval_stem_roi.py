"""ROI / variable-rate evaluation (stem_roi/eval_stem_roi.py and
eval_stem_baseline.py parity).

Counterpart of spatiotemporalentropymodel_tpu/eval/eval_stem_roi.py, with
its calls in the same order. Per GOP sequence: I-frames through the
variable-rate I-model (stem_roi_i), P-frames through stem_roi conditioned
on the previous *reconstruction*, padded (:230-246); uniform quality maps
at a sweep of levels (11 in the reference, :427), the gradient test maps
(levels −1 and −2), and the rate-control sweep ``eval_rc`` over the
target levels {0.30, 0.45, 0.55, 0.70} (:368-376). Frames and maps are
padded centred to a multiple of 64 before coding and the reconstruction
cropped back before the metrics. Reports PSNR, MS-SSIM, the streams' bpp
and the likelihoods' bpp per level. Frames go to the I-model's device as
(1, 3, H, W) f32, the maps as (1, 1, H, W).
"""

import json
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..data.qmap import gradient_qmap, uniform_qmap
from ..ops.padding import crop_centered, pad_centered
from .eval_stem import _frame_tensor
from .metrics import actual_bpp, estimate_bpp, ms_ssim_or_nan, psnr

DEFAULT_LEVELS = [0, 10, 20, 30, 40, 50, 60, 70, 80, 90, 100]
RC_LEVELS = [0.30, 0.45, 0.55, 0.70]


def _make_qmap(shape, level, level_max=100):
    """(H, W, 1) f32: uniform at level ≥ 0; the horizontal (−1) or
    vertical (−2) gradient map."""
    h, w = shape
    if level == -1:
        return gradient_qmap((h, w), 0, level_max, horizontal=True)
    if level == -2:
        return gradient_qmap((h, w), 0, level_max, horizontal=False)
    return uniform_qmap(max(h, w), level, level_max)[:h, :w]


def _scores(x, x_hat, pads) -> Dict[str, float]:
    x_hat_c = crop_centered(x_hat, pads)
    return {"psnr": float(psnr(x, x_hat_c)),
            "ms-ssim": ms_ssim_or_nan(x, x_hat_c)}


def _code(model, fwd_args, enc_args, dec_args, num_pixels,
          entropy_estimation) -> Dict:
    """The forward's bpp, then (unless ``entropy_estimation``) compress and
    decompress, timed: {"x_hat" (padded), "bpp", "estimate_bpp",
    "encoding_time", "decoding_time"}."""
    fwd = model.forward(*fwd_args)
    bpp_est = float(estimate_bpp(fwd["likelihoods"], num_pixels))
    if entropy_estimation:
        return {"x_hat": fwd["x_hat"], "bpp": bpp_est,
                "estimate_bpp": bpp_est, "encoding_time": 0.0,
                "decoding_time": 0.0}
    t0 = time.time()
    enc = model.compress(*enc_args)
    enc_t = time.time() - t0
    t0 = time.time()
    dec = model.decompress(enc["strings"], enc["shape"], *dec_args)
    dec_t = time.time() - t0
    return {"x_hat": dec["x_hat"], "bpp": actual_bpp(enc["strings"],
                                                      num_pixels),
            "estimate_bpp": bpp_est, "encoding_time": enc_t,
            "decoding_time": dec_t}


@torch.no_grad()
def inference_i(model_i, x, qmap, entropy_estimation=False) -> Dict:
    """One I-frame: x (1, 3, H, W), qmap (H, W, 1) NumPy. "x_hat" is the
    padded reconstruction, which the next frame is conditioned on."""
    x_padded, pads = pad_centered(x, 64)
    q_padded, _ = pad_centered(_map_tensor(qmap, x.device), 64)
    out = _code(model_i, (x_padded, q_padded), (x_padded, q_padded), (),
                x.shape[2] * x.shape[3], entropy_estimation)
    return out | _scores(x, out["x_hat"], pads)


@torch.no_grad()
def inference_p(model_p, x, x_conditioned, qmap,
                entropy_estimation=False) -> Dict:
    """One P-frame conditioned on the padded previous reconstruction."""
    x_padded, pads = pad_centered(x, 64)
    q_padded, _ = pad_centered(_map_tensor(qmap, x.device), 64)
    args = (x_padded, x_conditioned, q_padded)
    out = _code(model_p, args, args, (x_conditioned,),
                x.shape[2] * x.shape[3], entropy_estimation)
    return out | _scores(x, out["x_hat"], pads)


def _map_tensor(qmap, device):
    """(H, W, 1) NumPy → (1, 1, H, W) f32 on ``device``."""
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(qmap, np.float32), -1, 0)))[None].to(device)


_KEYS = ("psnr", "ms-ssim", "bpp", "estimate_bpp")


def eval_sequence_at_level(model_i, model_p, sequence, level,
                           entropy_estimation=False) -> Dict[str, float]:
    """One sequence at one quality level, the reconstruction carried
    across frames: the means over its frames, and "frames"."""
    sums = dict.fromkeys(_KEYS, 0.0)
    n = 0
    x_conditioned = None
    for frame in sequence:
        x = _frame_tensor(frame.image, model_i.device)
        qmap = _make_qmap(x.shape[2:], level)
        if frame.is_intra or x_conditioned is None:
            out = inference_i(model_i, x, qmap, entropy_estimation)
        else:
            out = inference_p(model_p, x, x_conditioned, qmap,
                              entropy_estimation)
        x_conditioned = out["x_hat"]
        for k in sums:
            sums[k] += out[k]
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()} | {"frames": n}


def eval_levels(model_i, model_p, dataset, levels: Optional[List] = None,
                entropy_estimation=False, out_json=None) -> Dict:
    """The level sweep over every sequence: {str(level): the means over
    the sequences} (eval_stem_roi._eval_stem_roi parity)."""
    levels = DEFAULT_LEVELS if levels is None else levels
    results = {}
    for level in levels:
        per_seq = [eval_sequence_at_level(model_i, model_p, seq, level,
                                          entropy_estimation)
                   for seq in dataset]
        results[str(level)] = {k: float(np.mean([r[k] for r in per_seq]))
                               for k in _KEYS}
    if out_json:
        with open(out_json, "w") as f:
            json.dump(results, f, indent=2)
    return results


def eval_rc(model_i, model_p, dataset, levels: Optional[List[float]] = None,
            entropy_estimation=False) -> Dict:
    """The rate-control sweep at fractional uniform levels (eval_rc
    parity, eval_stem_roi.py:368-376)."""
    levels = RC_LEVELS if levels is None else levels
    return eval_levels(model_i, model_p, dataset, [v * 100 for v in levels],
                       entropy_estimation)


# ---- the single-rate pixel-domain baseline (eval_stem_baseline.py) -------


@torch.no_grad()
def inference_p_baseline(model_p, x, x_conditioned,
                         entropy_estimation=False) -> Dict:
    """A P-frame through stem_baseline(v2): image in, image out, no map."""
    x_padded, pads = pad_centered(x, 64)
    out = _code(model_p, (x_padded, x_conditioned),
                (x_padded, x_conditioned), (x_conditioned,),
                x.shape[2] * x.shape[3], entropy_estimation)
    return out | _scores(x, out["x_hat"], pads)


@torch.no_grad()
def eval_baseline_sequence(model_i, model_p, sequence,
                           entropy_estimation=False) -> Dict[str, float]:
    """A GOP sequence through (an image codec, stem_baseline) with the
    reconstruction carried (stem_roi/eval_stem_baseline.py:30-330);
    ``model_i`` takes no quality map."""
    sums = dict.fromkeys(_KEYS, 0.0)
    n = 0
    x_conditioned = None
    for frame in sequence:
        x = _frame_tensor(frame.image, model_i.device)
        if frame.is_intra or x_conditioned is None:
            x_padded, pads = pad_centered(x, 64)
            out = _code(model_i, (x_padded,), (x_padded,), (),
                        x.shape[2] * x.shape[3], entropy_estimation)
            out |= _scores(x, out["x_hat"], pads)
        else:
            out = inference_p_baseline(model_p, x, x_conditioned,
                                       entropy_estimation)
        x_conditioned = out["x_hat"]
        for k in sums:
            sums[k] += out[k]
        n += 1
    return {k: v / max(n, 1) for k, v in sums.items()} | {"frames": n}
