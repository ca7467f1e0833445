"""Standard-codec baselines for RD comparison.

Counterpart of spatiotemporalentropymodel_tpu/eval/bench_codecs.py
(compressai/utils/bench, codecs.py): JPEG / WebP / JPEG2000 through Pillow;
BPG / VTM / HM / AV1 / TFCI through external programs, each raising
``RuntimeError`` where its program is absent. A thread pool fans out over
(quality × image), as the JAX package's does. PSNR and MS-SSIM come from
the port's ``eval/metrics.py``, on the CPU: no model runs here.

Pillow is imported inside the functions that read or write images, never
at module level: the port runs without it (the card's machine has none),
and there a Pillow codec raises ``ImportError`` naming Pillow, as a codec
whose program is absent raises ``RuntimeError``.

    python -m spatiotemporalentropymodel_tpu_torch.eval.bench_codecs \\
        jpeg DIR -q 10 30 50 [-o OUT.json]
"""

import argparse
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from .metrics import ms_ssim_or_nan, psnr


def _image_module():
    """PIL.Image, or ImportError naming Pillow where it is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("the Pillow codecs (jpeg, webp, jpeg2000) and "
                          "reading their images need Pillow, which is not "
                          "installed") from e
    return Image


def _load(path) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1], as the JAX package reads an image."""
    with _image_module().open(path) as im:
        return np.asarray(im.convert("RGB"), np.float32) / 255.0


def _metrics(ref: np.ndarray, rec: np.ndarray, nbytes: int) -> Dict[str, float]:
    a = torch.from_numpy(np.ascontiguousarray(ref)).permute(2, 0, 1)[None]
    b = torch.from_numpy(np.ascontiguousarray(rec)).permute(2, 0, 1)[None]
    num_pixels = ref.shape[0] * ref.shape[1]
    return {
        "psnr": float(psnr(a, b)),
        "ms-ssim": ms_ssim_or_nan(a, b),
        "bpp": nbytes * 8.0 / num_pixels,
    }


class PillowCodec:
    """JPEG / WebP / JPEG2000 through Pillow (codecs.py:180-297 parity)."""

    fmt = "JPEG"
    quality_range = (1, 95)

    def run(self, image_path: str, quality: int) -> Dict[str, float]:
        image = _image_module()
        ref = _load(image_path)
        buf = io.BytesIO()
        t0 = time.time()
        with image.open(image_path) as im:
            im.convert("RGB").save(buf, format=self.fmt, quality=quality)
        enc_t = time.time() - t0
        nbytes = buf.tell()
        buf.seek(0)
        t0 = time.time()
        with image.open(buf) as im:
            rec = np.asarray(im.convert("RGB"), np.float32) / 255.0
        dec_t = time.time() - t0
        rv = _metrics(ref, rec, nbytes)
        rv["encoding_time"] = enc_t
        rv["decoding_time"] = dec_t
        return rv


class JPEG(PillowCodec):
    fmt = "JPEG"


class WebP(PillowCodec):
    fmt = "WEBP"
    quality_range = (1, 100)


class JPEG2000(PillowCodec):
    fmt = "JPEG2000"
    quality_range = (1, 100)

    def run(self, image_path, quality):
        image = _image_module()
        ref = _load(image_path)
        buf = io.BytesIO()
        with image.open(image_path) as im:
            # Pillow maps quality via quality_layers (compression ratios)
            im.convert("RGB").save(
                buf, format="JPEG2000", quality_mode="rates",
                quality_layers=[max(1, 101 - quality)],
            )
        nbytes = buf.tell()
        buf.seek(0)
        with image.open(buf) as im:
            rec = np.asarray(im.convert("RGB"), np.float32) / 255.0
        return _metrics(ref, rec, nbytes)


class BinaryCodec:
    """An external codec program; ``run`` raises where it is absent."""

    binary = ""
    quality_range = (1, 51)

    def available(self) -> bool:
        return shutil.which(self.binary) is not None

    def run(self, image_path: str, quality: int) -> Dict[str, float]:
        raise NotImplementedError


class BPG(BinaryCodec):
    """BPG via bpgenc/bpgdec (codecs.py:298-379 parity)."""

    binary = "bpgenc"
    quality_range = (0, 51)

    def run(self, image_path, quality):
        if not self.available():
            raise RuntimeError("bpgenc binary not found")
        ref = _load(image_path)
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "out.bpg")
            rec_png = os.path.join(d, "rec.png")
            subprocess.run(
                ["bpgenc", "-q", str(quality), "-o", out, image_path],
                check=True,
            )
            nbytes = os.path.getsize(out)
            subprocess.run(["bpgdec", "-o", rec_png, out], check=True)
            rec = _load(rec_png)
        return _metrics(ref, rec, nbytes)


class VTM(BinaryCodec):
    binary = "EncoderApp"


class HM(BinaryCodec):
    binary = "TAppEncoder"


class AV1(BinaryCodec):
    binary = "aomenc"


class TFCI(BinaryCodec):
    """tensorflow/compression `tfci.py` driver (codecs.py:380-436 parity).

    Runs ``python <tfci_path> compress <model>-<quality> in out`` and the
    matching ``decompress``; raises where the script is absent. ``model`` ∈
    the three TF-compression releases the reference lists.
    """

    MODELS = (
        "bmshj2018-factorized-mse",
        "bmshj2018-hyperprior-mse",
        "mbt2018-mean-mse",
    )
    quality_range = (1, 8)

    def __init__(self, tfci_path: str = "tfci.py",
                 model: str = MODELS[0]):
        if model not in self.MODELS:
            raise ValueError(f"invalid TFCI model {model!r}")
        self.tfci_path = tfci_path
        self.model = model

    def available(self) -> bool:
        return os.path.isfile(self.tfci_path)

    def run(self, image_path, quality):
        if not self.available():
            raise RuntimeError(f"tfci script not found: {self.tfci_path}")
        if not 1 <= quality <= 8:
            raise ValueError(f"Invalid quality value: {quality} (1, 8)")
        ref = _load(image_path)
        with tempfile.TemporaryDirectory() as d:
            out = os.path.join(d, "out.tfci")
            rec_png = os.path.join(d, "rec.png")
            t0 = time.time()
            subprocess.run(
                [sys.executable, self.tfci_path, "compress",
                 f"{self.model}-{quality:d}", image_path, out],
                check=True,
            )
            enc_t = time.time() - t0
            nbytes = os.path.getsize(out)
            t0 = time.time()
            subprocess.run(
                [sys.executable, self.tfci_path, "decompress", out, rec_png],
                check=True,
            )
            dec_t = time.time() - t0
            rec = _load(rec_png)
        rv = _metrics(ref, rec, nbytes)
        rv["encoding_time"] = enc_t
        rv["decoding_time"] = dec_t
        return rv


_CODECS = {
    "jpeg": JPEG,
    "webp": WebP,
    "jpeg2000": JPEG2000,
    "bpg": BPG,
    "vtm": VTM,
    "hm": HM,
    "av1": AV1,
    "tfci": TFCI,
}


def get_codec(name: str):
    if name not in _CODECS:
        raise ValueError(f"unknown codec {name!r} (available: {list(_CODECS)})")
    return _CODECS[name]()


def bench(codec_name: str, image_paths: List[str], qualities: List[int],
          workers: int = 4) -> Dict:
    codec = get_codec(codec_name)
    jobs: List[Tuple[int, str]] = [
        (q, p) for q in qualities for p in image_paths
    ]

    def work(job):
        q, p = job
        return q, codec.run(p, q)

    results: Dict[int, Dict[str, float]] = {}
    with ThreadPoolExecutor(max_workers=workers) as pool:
        for q, rv in pool.map(work, jobs):
            acc = results.setdefault(q, {})
            for k, v in rv.items():
                acc[k] = acc.get(k, 0.0) + v / len(image_paths)
    return {
        "name": codec_name,
        "results": {
            k: [results[q][k] for q in qualities]
            for k in next(iter(results.values()))
        },
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("codec", choices=list(_CODECS))
    parser.add_argument("dataset")
    parser.add_argument("-q", "--qualities", type=int, nargs="+",
                        default=[10, 30, 50, 70, 90])
    parser.add_argument("-j", "--workers", type=int, default=4)
    parser.add_argument("-o", "--output")
    args = parser.parse_args(argv)

    from .eval_model import collect_images

    paths = collect_images(args.dataset)
    out = bench(args.codec, paths, args.qualities, args.workers)
    text = json.dumps(out, indent=2)
    print(text)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)


if __name__ == "__main__":
    main()
