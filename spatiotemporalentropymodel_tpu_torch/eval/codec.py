"""File-level image codec CLI with a real bitstream container (.bin).

Counterpart of spatiotemporalentropymodel_tpu/eval/codec.py
(compressai_examples/codec.py), writing the same files byte for byte: a
2-byte header (model id, metric<<4 | quality−1), the original (h, w) as
big-endian u32, the latent shape and the string count, then length-prefixed
strings (codec.py:92-117, 150-220). Images are centre-padded to ×64
(codec.py:119-148). A model id is the model's position in
``zoo.model_architectures``. The port reads and writes PNG only
(``data/png.py``). ``--coder`` picks the entropy coder (``rans``, the
default, ``rans_interleaved`` or ``numpy``); a file decodes with the coder
that wrote it, which the header does not record.

Usage:
  python -m spatiotemporalentropymodel_tpu_torch.eval.codec encode IMG \\
      -o OUT.bin --model bmshj2018-factorized --quality 1 \\
      [--checkpoint CKPT] [--coder CODER] [--device cuda|cpu]
  python -m spatiotemporalentropymodel_tpu_torch.eval.codec decode OUT.bin \\
      -o REC.png [--coder CODER] [--device cuda|cpu]
"""

import argparse
import struct
import time
from pathlib import Path

import numpy as np
import torch

from ..data.png import read_png, write_png
from ..ops.padding import crop_centered, pad_centered
from ..zoo import create_model, model_architectures

model_ids = {name: i for i, name in enumerate(model_architectures)}
metric_ids = {"mse": 0, "ms-ssim": 1}


def _inverse(d):
    return {v: k for k, v in d.items()}


def get_header(model_name: str, metric: str, quality: int):
    code = (metric_ids[metric] << 4) | ((quality - 1) & 0x0F)
    return model_ids[model_name], code


def parse_header(header):
    model_id, code = header
    return (
        _inverse(model_ids)[model_id],
        _inverse(metric_ids)[code >> 4],
        (code & 0x0F) + 1,
    )


def _write_uints(fd, values):
    fd.write(struct.pack(f">{len(values)}I", *values))


def _read_uints(fd, n):
    return struct.unpack(f">{n}I", fd.read(4 * n))


def _build_model(model_name, quality, checkpoint=None, device="cuda"):
    """The zoo model, from a checkpoint's ``"model"`` entry (its parameters
    and the codec tables saved with them) or, without one, at the seeded
    initialisation; then ``update()``, which keeps tables already there."""
    model = create_model(model_name, quality, device=device)
    if checkpoint:
        from ..training.checkpoints import load_checkpoint

        ckpt = load_checkpoint(checkpoint)
        if "model" not in ckpt:
            raise KeyError(f"{checkpoint} has no 'model' entry (it has "
                           f"{sorted(ckpt)})")
        model.load_state_leaves(ckpt["model"])
    model.update()
    return model


def _load_image(path) -> np.ndarray:
    """(1, H, W, 3) float32 in [0, 1], as the JAX package's loader gives
    it."""
    return read_png(path).astype(np.float32)[None] / 255.0


def to_device(x_nhwc, device):
    """An NHWC float array → the (B, 3, H, W) f32 tensor on ``device`` that
    the models take."""
    x = torch.from_numpy(np.ascontiguousarray(x_nhwc, np.float32))
    return x.to(device).permute(0, 3, 1, 2).contiguous()


def to_png_array(x_hwc) -> np.ndarray:
    """A decoded (H, W, 3) frame → uint8 as the JAX package saves it:
    clip to [0, 1], ×255, truncate."""
    return (np.clip(x_hwc, 0, 1) * 255).astype(np.uint8)


def encode(image_path, output, model_name="bmshj2018-factorized", quality=1,
           metric="mse", checkpoint=None, model=None, device="cuda"):
    t0 = time.time()
    x = _load_image(image_path)
    h, w = x.shape[1], x.shape[2]
    x_padded, _ = pad_centered(to_device(x, device), 64)
    if model is None:
        model = _build_model(model_name, quality, checkpoint, device)
    out = model.compress(x_padded)
    shape = out["shape"]

    with Path(output).open("wb") as f:
        f.write(struct.pack(">2B", *get_header(model_name, metric, quality)))
        _write_uints(f, (h, w))
        _write_uints(f, (shape[0], shape[1], len(out["strings"])))
        for group in out["strings"]:
            s = group[0]
            _write_uints(f, (len(s),))
            f.write(s)

    size = Path(output).stat().st_size
    bpp = size * 8.0 / (h * w)
    print(f"{bpp:.3f} bpp | Encoded in {time.time() - t0:.2f}s")
    return {"bpp": bpp, "bytes": size}


def decode(input_path, output=None, checkpoint=None, model=None,
           device="cuda"):
    """Returns x̂ as a (1, h, w, 3) float32 NumPy array, cropped centred;
    optionally writes it to the PNG ``output``."""
    t0 = time.time()
    with Path(input_path).open("rb") as f:
        model_name, metric, quality = parse_header(
            struct.unpack(">2B", f.read(2))
        )
        h, w = _read_uints(f, 2)
        sh, sw, n_strings = _read_uints(f, 3)
        strings = []
        for _ in range(n_strings):
            (length,) = _read_uints(f, 1)
            strings.append([f.read(length)])

    if model is None:
        model = _build_model(model_name, quality, checkpoint, device)
    out = model.decompress(strings, (sh, sw))

    x_hat = out["x_hat"]
    ph, pw = x_hat.shape[2], x_hat.shape[3]
    top, left = (ph - h) // 2, (pw - w) // 2
    x_hat = crop_centered(x_hat, (top, ph - h - top, left, pw - w - left))
    x_hat = x_hat.float().permute(0, 2, 3, 1).cpu().numpy()
    print(f"Model: {model_name}, metric: {metric}, quality: {quality}")
    print(f"Decoded in {time.time() - t0:.2f}s")

    if output is not None:
        write_png(output, to_png_array(x_hat[0]))
    return x_hat


def main(argv=None):
    import spatiotemporalentropymodel_tpu_torch as stem_torch

    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p):
        p.add_argument("--checkpoint")
        p.add_argument("-c", "--coder",
                       choices=stem_torch.available_entropy_coders(),
                       default=stem_torch.get_entropy_coder())
        p.add_argument("--device", default="cuda",
                       help="torch device to run the models on")

    enc = sub.add_parser("encode")
    enc.add_argument("image")
    enc.add_argument("-o", "--output", required=True)
    enc.add_argument("--model", default="bmshj2018-factorized",
                     choices=list(model_ids))
    enc.add_argument("--quality", type=int, default=1)
    enc.add_argument("--metric", default="mse", choices=list(metric_ids))
    common(enc)
    dec = sub.add_parser("decode")
    dec.add_argument("input")
    dec.add_argument("-o", "--output")
    common(dec)
    args = parser.parse_args(argv)

    stem_torch.set_entropy_coder(args.coder)
    if args.command == "encode":
        encode(args.image, args.output, args.model, args.quality, args.metric,
               args.checkpoint, device=args.device)
    else:
        decode(args.input, args.output, args.checkpoint, device=args.device)


if __name__ == "__main__":
    main()
