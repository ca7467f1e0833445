"""RD-curve plotting from eval-JSON results.

Counterpart of spatiotemporalentropymodel_tpu/eval/plot.py, the same code
(it never touched JAX). Parity: compressai/utils/plot (195 LoC) +
results/draw_stem_rdcurve.py: load one or more result JSONs ({"name",
"results": {"bpp": [...], "psnr": [...]}}), overlay the published
baselines from rd_data, render with matplotlib when available, else emit a
CSV table.
"""

import argparse
import json
import sys
from typing import Dict, List

from . import rd_data


def load_results(paths: List[str]) -> List[Dict]:
    out = []
    for p in paths:
        with open(p) as f:
            out.append(json.load(f))
    return out


def _as_series(results: Dict, metric: str):
    r = results["results"]
    return r["bpp"], r[metric]


def plot(
    results: List[Dict],
    metric: str = "psnr",
    baselines: str = "uvg",
    output=None,
    title="RD curves",
):
    base = {"uvg": rd_data.UVG, "hevc-b": rd_data.HEVC_B, "none": {}}[baselines]
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        _csv(results, metric, base, output)
        return

    fig, ax = plt.subplots(figsize=(7, 5))
    for name, series in base.items():
        ax.plot(series["bpp"], series["psnr"], "--o", label=f"{name} (ref)",
                alpha=0.6)
    for res in results:
        bpp, vals = _as_series(res, metric)
        ax.plot(bpp, vals, "-s", label=res.get("name", "result"))
    ax.set_xlabel("bpp")
    ax.set_ylabel(metric.upper())
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend()
    fig.tight_layout()
    if output:
        fig.savefig(output, dpi=150)
    else:
        fig.savefig("rd_curve.png", dpi=150)


def _csv(results, metric, base, output):
    lines = ["series,bpp," + metric]
    for name, series in base.items():
        for b, v in zip(series["bpp"], series["psnr"]):
            lines.append(f"{name} (ref),{b},{v}")
    for res in results:
        bpp, vals = _as_series(res, metric)
        for b, v in zip(bpp, vals):
            lines.append(f"{res.get('name', 'result')},{b},{v}")
    text = "\n".join(lines)
    if output:
        with open(output, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text + "\n")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("results", nargs="+", help="result JSON files")
    parser.add_argument("-m", "--metric", default="psnr")
    parser.add_argument("-b", "--baselines", default="uvg",
                        choices=["uvg", "hevc-b", "none"])
    parser.add_argument("-o", "--output")
    parser.add_argument("-t", "--title", default="RD curves")
    args = parser.parse_args(argv)
    plot(load_results(args.results), args.metric, args.baselines, args.output,
         args.title)


if __name__ == "__main__":
    main()
