"""The flagship's serving loop from two trees of the port, in turns: its
frames/s and its stage times, so a change to the AR codec is measured
against another commit on one card.

    python3 -m spatiotemporalentropymodel_tpu_torch.eval.flagship_ab \
        --tree DIR [--frames 6] [--turns 2]

Needs one CUDA card. Each run is a process of its own that imports the
package of one tree: this checkout ("this") or the tree at DIR, e.g. a git
archive of another commit ("other"), in the order this, other, other, this
in each turn. A run builds chip_smoke.py's res_wavefront_bf16
configuration (MeanScaleHyperprior(192, 192) and STEM res with EB 256 and
wavefront tile (1, 4), both bf16, 4 streams of 1088×1920, y_cur = y_cond +
0.2·ε with g_a run on the pixel frame), serves ``frames`` P-frames through
WavefrontVideoPipeline.serve_latent and prints their wall frames/s, then
one frame's stages with the codec's stage clock (median of 3). Its
``stage_ms`` are host milliseconds: the stage clock no longer
synchronises, so a stage holds device time only where it waits on a copy
(a tree before the spans of utils/trace.py gave device time, synchronised
at each stage). The script prints every run, each tree's medians and the
card's name and power limit.
"""

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

THIS = Path(__file__).resolve().parents[2]

# one run, in a process whose sys.path starts at the tree; only the API
# every tree of the port has since the flagship came in
_RUN = r"""
import json, sys, time
sys.path.insert(0, sys.argv[1])
import torch
from spatiotemporalentropymodel_tpu_torch.coders import rans
from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
    WavefrontVideoPipeline)
from spatiotemporalentropymodel_tpu_torch.eval.workload import (
    realistic_stem, wavefront_y_cur)
from spatiotemporalentropymodel_tpu_torch.models import (
    MeanScaleHyperprior, SpatioTemporalPriorModel)
from spatiotemporalentropymodel_tpu_torch.ops import kernels

B, H, W, M, EBC, TILE = 4, 1088, 1920, 192, 256, (1, 4)
frames = int(sys.argv[2])
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
kernels.load()
rans.load()
imodel = MeanScaleHyperprior(M, M, device="cuda", seed=0)
stem = SpatioTemporalPriorModel(variant="res",
                                entropy_bottleneck_channels=EBC,
                                in_channels=M, wavefront_tile=TILE,
                                device="cuda", seed=1)
realistic_stem(stem)
imodel.set_compute_dtype(torch.bfloat16)
stem.set_compute_dtype(torch.bfloat16)
pipe = WavefrontVideoPipeline(imodel, stem)
gen = torch.Generator(device="cuda").manual_seed(5)
y_cond = 0.5 * torch.randn((B, M, H // 16, W // 16), generator=gen,
                           device="cuda")
x_pix = torch.rand((B, 3, H, W), generator=gen, device="cuda")
y_cur = wavefront_y_cur(imodel, x_pix, y_cond, gen)
pipe.serve_latent(y_cur, y_cond)  # warm-up: cuDNN set-up, the pools
torch.cuda.synchronize()
yc = y_cond
t0 = time.perf_counter()
for k in range(frames):
    y_cur = wavefront_y_cur(imodel, x_pix, yc, gen)
    _, yc, _ = pipe.serve_latent(y_cur, yc, frame=k)
torch.cuda.synchronize()
fps = frames * B / (time.perf_counter() - t0)
stages = []
for _ in range(3):
    stem._codec_stats = {}
    pipe.serve_latent(y_cur, y_cond)
    torch.cuda.synchronize()
    stages.append({k: 1e3 * v for k, v in stem._codec_stats.items()
                   if k.endswith("_s")})
    stem._codec_stats = None
med = {k: sorted(s[k] for s in stages)[1] for k in stages[0]}
print("RESULT " + json.dumps({"fps": fps, "stage_ms": med}), flush=True)
"""


def _run(tree: Path, frames: int) -> dict:
    res = subprocess.run([sys.executable, "-c", _RUN, str(tree),
                          str(frames)], cwd=tree, capture_output=True,
                         text=True, check=False, timeout=900)
    if res.returncode != 0:
        raise SystemExit(f"run in {tree} failed:\n{res.stdout}\n"
                         f"{res.stderr}")
    line = next(s for s in res.stdout.splitlines()
                if s.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, type=Path,
                    help="the other tree's root")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    trees = {"this": THIS, "other": args.tree.resolve()}
    runs = {"this": [], "other": []}
    for turn in range(args.turns):
        for name in ("this", "other", "other", "this"):
            r = _run(trees[name], args.frames)
            runs[name].append(r)
            print(f"turn {turn} {name}: {r['fps']:.3f} frames/s, stage ms "
                  + ", ".join(f"{k} {v:.2f}"
                              for k, v in r["stage_ms"].items()),
                  flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    for name, rs in runs.items():
        fps = statistics.median(r["fps"] for r in rs)
        stage = {k: statistics.median(r["stage_ms"][k] for r in rs)
                 for k in rs[0]["stage_ms"]}
        print(f"{name} ({trees[name]}): median {fps:.3f} frames/s over "
              f"{len(rs)} runs of {args.frames} P-frames × 4, median stage "
              f"ms " + ", ".join(f"{k} {v:.2f}" for k, v in stage.items())
              + f" | card: {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
