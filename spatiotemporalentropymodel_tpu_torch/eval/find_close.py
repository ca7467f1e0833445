"""Binary-search a codec's quality to hit a target metric value.

Counterpart of spatiotemporalentropymodel_tpu/eval/find_close.py, the same
code (it never touched JAX). Parity: compressai/utils/find_close
(__main__.py:54-88): bisect the quality parameter of a codec wrapper until
the chosen metric (psnr / ms-ssim / bpp) is as close as possible to the
target.
"""

import argparse
from typing import Callable, Tuple


def find_closest(
    eval_at_quality: Callable[[int], dict],
    target: float,
    metric: str,
    qmin: int,
    qmax: int,
) -> Tuple[int, dict]:
    """Bisect integer quality in [qmin, qmax]; metric assumed monotone in q.

    Returns (best_quality, its metrics).
    """
    best_q, best_rv, best_err = qmin, None, float("inf")
    lo, hi = qmin, qmax
    while lo <= hi:
        mid = (lo + hi) // 2
        rv = eval_at_quality(mid)
        err = abs(rv[metric] - target)
        if err < best_err:
            best_q, best_rv, best_err = mid, rv, err
        if rv[metric] < target:
            lo = mid + 1
        else:
            hi = mid - 1
    return best_q, best_rv


def main(argv=None):
    from .bench_codecs import get_codec

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("codec", help="codec name (jpeg/webp/...)")
    parser.add_argument("image")
    parser.add_argument("target", type=float)
    parser.add_argument("-m", "--metric", default="psnr",
                        choices=["psnr", "ms-ssim", "bpp"])
    args = parser.parse_args(argv)

    codec = get_codec(args.codec)

    def eval_at(q):
        return codec.run(args.image, q)

    q, rv = find_closest(eval_at, args.target, args.metric,
                         *codec.quality_range)
    print(f"quality={q} {rv}")


if __name__ == "__main__":
    main()
