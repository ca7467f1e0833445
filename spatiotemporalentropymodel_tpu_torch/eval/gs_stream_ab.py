"""g_s of each decoded ŷ on the main stream or on a side stream: which one
serves more frames/s in the wavefront serving loop.

    python3 -m spatiotemporalentropymodel_tpu_torch.eval.gs_stream_ab \
        [--frames 6] [--turns 3]

Needs one CUDA card. Builds chip_smoke.py's res_wavefront_bf16
configuration (MeanScaleHyperprior(192, 192) and STEM res with EB 256 and
wavefront tile (1, 4), both bf16, 4 streams of 1088×1920, y_cur = y_cond +
0.2·ε with g_a run on the pixel frame) and serves ``frames`` P-frames per
run through WavefrontVideoPipeline's encode and decode, then g_s of ŷ:
queued on the current stream ("main"), or on a side stream after an event
on ŷ ("side"), with the next frame's work going on at once in both. The
runs go main, side, side, main in each turn; the script prints each run's
wall frames/s, each mode's median and the card's name and power limit.
"""

import argparse
import statistics
import subprocess
import time

import torch

from ..coders import rans
from ..models import MeanScaleHyperprior, SpatioTemporalPriorModel
from ..ops import kernels
from .pipeline import WavefrontVideoPipeline
from .workload import realistic_stem, wavefront_y_cur

B, H, W = 4, 1088, 1920
N = M = 192
EBC = 256
TILE = (1, 4)


def _gs_side(imodel, side, y_hat):
    ready = torch.cuda.Event()
    ready.record()
    side.wait_event(ready)
    y_hat.record_stream(side)
    with torch.cuda.stream(side):
        return imodel.get_x(y_hat)


def _serve(pipe, side, x_pix, y_cond, gen, frames: int) -> float:
    """Wall frames/s of ``frames`` P-frames, g_s on ``side`` or, with None,
    on the current stream."""
    imodel = pipe.i_model
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        y_cur = wavefront_y_cur(imodel, x_pix, y_cond, gen)
        enc = pipe.encode_frame(y_cur, y_cond)
        y_hat = pipe.decode_frame(enc, y_cond)
        if side is None:
            imodel.get_x(y_hat)
        else:
            _gs_side(imodel, side, y_hat)
        y_cond = y_hat
    torch.cuda.synchronize()
    return frames * B / (time.perf_counter() - t0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    kernels.load()
    rans.load()
    imodel = MeanScaleHyperprior(N, M, device="cuda", seed=0)
    stem = SpatioTemporalPriorModel(variant="res",
                                    entropy_bottleneck_channels=EBC,
                                    in_channels=M, wavefront_tile=TILE,
                                    device="cuda", seed=1)
    realistic_stem(stem)
    imodel.set_compute_dtype(torch.bfloat16)
    stem.set_compute_dtype(torch.bfloat16)
    pipe = WavefrontVideoPipeline(imodel, stem)
    side = torch.cuda.Stream()
    gen = torch.Generator(device="cuda").manual_seed(5)
    y_cond = 0.5 * torch.randn((B, M, H // 16, W // 16), generator=gen,
                               device="cuda")
    x_pix = torch.rand((B, 3, H, W), generator=gen, device="cuda")
    for s in (None, side):  # warm-up: cuDNN set-up, the allocator's pools
        _serve(pipe, s, x_pix, y_cond, gen, 1)
    fps = {"main": [], "side": []}
    for turn in range(args.turns):
        for mode in ("main", "side", "side", "main"):
            f = _serve(pipe, side if mode == "side" else None, x_pix, y_cond,
                       gen, args.frames)
            fps[mode].append(f)
            print(f"turn {turn} {mode}: {f:.3f} frames/s", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    med = {k: statistics.median(v) for k, v in fps.items()}
    print(f"median frames/s over {args.turns * 2} runs of {args.frames} "
          f"P-frames × {B}: main {med['main']:.3f}, side {med['side']:.3f} "
          f"(side/main {med['side'] / med['main']:.4f}) | card: {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
