"""File-level GOP video codec with a real bitstream container (.stemv).

Counterpart of spatiotemporalentropymodel_tpu/eval/video_codec.py, writing
and reading the same files byte for byte: PNG frames → ONE .stemv file →
decoded PNGs, for the three P-frame families:

  family 0  parallel STEM (without_spm/without_spm_tpm) through the
            streaming sparse-transport pipeline (eval/pipeline.py); the
            container carries CDF-row counts so file decode is fetch-free
  family 1  wavefront/tiled-wavefront SPM variants incl. the reference's
            headline SpatioTemporalPriorModel_Res — the tile shape rides the
            header so decode rebuilds the exact codec
  family 2  the channel-autoregressive charm (models/charm.py) — the group
            count and the lrp/residual flags ride the header

Container format v5 (big-endian):

  magic  b"STMV", u8 version
  u8 i_model_id, u8 i_quality
  u8 stem_family (0/1/2), u8 stem_variant_id, u16 stem_channels (EBC)
  u16 in_channels (M)
  u8 cfg0, u8 cfg1    family 1: wavefront tile (th, tw), (0,0) = untiled
                      family 2: (groups, flags bit0=lrp bit1=residual)
  u8 flags            bit0: wavefront stream symbol order of every
                      wavefront stream in the file (the family-1 STEM's and
                      an AR I-model's y) — 1 = v2 grouped-by-CDF-row per
                      round, 0 = v1 lane order; decode sets both models'
                      ``wavefront_format`` from it
  u64 stem_params_hash, u64 i_params_hash
                      (blake2b-8 over the weight trees: decoding with the
                       wrong checkpoint fails loudly instead of silently
                       emitting random-init garbage)
  u8 gop, u32 n_frames, u32 h, u32 w          (original size, pre-×64-pad)
  per frame:
    u8 ftype            0 = I, 1 = P sparse, 2 = P dense (int8 overflow),
                        3 = P wavefront, 4 = P charm sparse, 5 = P charm dense
    u16 zh, u16 zw      hyper-latent spatial shape
    ftype 1: varint-packed CDF-row counts (1 vector; transport.pack_counts)
    ftype 4: varint-packed counts (groups vectors)
    then n_strings × (u32 len, bytes): 2 for ftypes 0-3 (y, z),
    groups+1 for ftypes 4-5 (y per group, then z)

The I-model is a mean-scale model whose ``decompress`` returns ŷ:
mbt2018-mean, or one of the autoregressive mbt2018, cheng2020-anchor and
cheng2020-attn, whose y streams are wavefront streams.

Frames are (H, W, 3) float arrays in [0, 1] at the API, as in the JAX
package; the models take NCHW tensors on their device. Decoded frames come
back as (H, W, 3) float32 NumPy arrays.

Usage:
  python -m spatiotemporalentropymodel_tpu_torch.eval.video_codec encode \\
      DIR -o OUT.stemv [--gop 12] [--stem-family parallel|wavefront|charm] \\
      [--charm-groups G] [--no-charm-lrp] \\
      [--i-model mbt2018-mean|mbt2018|cheng2020-anchor|cheng2020-attn] \\
      [--i-quality Q] [--i-checkpoint CKPT] [--stem-checkpoint CKPT] \\
      [--device cuda|cpu]
  python -m spatiotemporalentropymodel_tpu_torch.eval.video_codec decode \\
      OUT.stemv -o OUTDIR [--i-checkpoint CKPT] [--stem-checkpoint CKPT] \\
      [--device cuda|cpu]
"""

import argparse
import hashlib
import struct
import time
from pathlib import Path

import numpy as np

from ..convert import jax_leaves
from ..data.png import write_png
from ..entropy.transport import pack_counts, unpack_counts
from ..models import ar_wavefront as _wf
from ..ops.padding import pad_centered
from .codec import (
    _inverse,
    _load_image,
    _read_uints,
    _write_uints,
    model_ids,
    to_device,
    to_png_array,
)

MAGIC = b"STMV"
VERSION = 5
UNSPECIFIED = 0xFF  # model ids for API users who pass models directly

FAMILY_PARALLEL, FAMILY_WAVEFRONT, FAMILY_CHARM = 0, 1, 2

# all five STEM variants are representable; families split them by codec path
STEM_VARIANT_IDS = {
    "without_spm_tpm": 0, "without_spm": 1,  # family 0 (parallel)
    "without_tpm": 2, "full": 3, "res": 4,   # family 1 (wavefront)
}
PARALLEL_VARIANTS = ("without_spm_tpm", "without_spm")
WAVEFRONT_VARIANTS = ("without_tpm", "full", "res")

FTYPE_I, FTYPE_P_SPARSE, FTYPE_P_DENSE = 0, 1, 2
FTYPE_P_WAVEFRONT, FTYPE_P_CHARM, FTYPE_P_CHARM_DENSE = 3, 4, 5
CHARM_FTYPES = (FTYPE_P_CHARM, FTYPE_P_CHARM_DENSE)


def params_hash(model) -> int:
    """Stable 64-bit digest of a model's weights: blake2b-8 over each
    leaf's path and bytes, in the JAX package's leaf order and layout
    (``convert.jax_leaves``), so both packages hash the same weights to
    the same value, at f32 and at bf16."""
    h = hashlib.blake2b(digest_size=8)
    for path, leaf in jax_leaves(model.module):
        # jax.tree_util.keystr of a path of dict keys: ['g_a']['layers_0']…
        h.update("".join(f"[{k!r}]" for k in path).encode())
        h.update(np.ascontiguousarray(leaf).tobytes())
    return int.from_bytes(h.digest(), "big")


def read_header(f):
    """Validate magic/version and return the header dict (file position is
    left at the first frame record)."""
    magic = f.read(4)
    if magic != MAGIC:
        raise ValueError(f"not a .stemv container (magic {magic!r})")
    (version,) = struct.unpack(">B", f.read(1))
    if version != VERSION:
        raise ValueError(
            f"unsupported .stemv version {version} (this build reads v5; "
            "v4 predates the grouped wavefront stream order, v3 shipped raw "
            "u32 count vectors — neither has a decoder in this revision)"
        )
    i_id, i_q, family, sv_id, s_ch, m_ch, cfg0, cfg1, flags = struct.unpack(
        ">4B2H3B", f.read(11)
    )
    stem_hash, i_hash = struct.unpack(">2Q", f.read(16))
    gop, n_frames, h, w = struct.unpack(">B3I", f.read(13))
    return {
        "i_model_id": i_id, "i_quality": i_q, "stem_family": family,
        "stem_variant_id": sv_id, "stem_channels": s_ch, "in_channels": m_ch,
        "cfg0": cfg0, "cfg1": cfg1, "flags": flags,
        "stem_params_hash": stem_hash, "i_params_hash": i_hash,
        "gop": gop, "n_frames": n_frames, "h": h, "w": w,
    }


def _write_frame(f, ftype, shape, strings, counts=None):
    """One record: type and ẑ shape, a sparse record's counts, then the
    strings (y then z; a charm record's y per group, then z)."""
    f.write(struct.pack(">B2H", ftype, *shape))
    if ftype in (FTYPE_P_SPARSE, FTYPE_P_CHARM):
        # varint-packed used rows only (a trained model touches ~20-30 of
        # the 64 scale-table rows)
        c = np.asarray(counts)
        f.write(pack_counts(c.reshape(-1, c.shape[-1]) if c.ndim > 1
                            else c[None]))
    if ftype in CHARM_FTYPES:
        flat = list(strings[0][0]) + [strings[1][0]]
    else:
        flat = [group[0] for group in strings]
    for s in flat:
        _write_uints(f, (len(s),))
        f.write(s)


def _read_frame(f, groups: int = 0):
    """(ftype, (zh, zw), flat row counts or None, [[y], [z]]) of one record;
    a charm record's y entry is its ``groups`` strings."""
    ftype, zh, zw = struct.unpack(">B2H", f.read(5))
    counts = None
    if ftype in (FTYPE_P_SPARSE, FTYPE_P_CHARM):
        counts = unpack_counts(f).reshape(-1)  # flat, caller reshapes
    n_strings = groups + 1 if ftype in CHARM_FTYPES else 2
    flat = []
    for _ in range(n_strings):
        (length,) = _read_uints(f, 1)
        flat.append(f.read(length))
    if ftype in CHARM_FTYPES:
        strings = [[flat[:-1]], [flat[-1]]]
    else:
        strings = [[s] for s in flat]
    return ftype, (zh, zw), counts, strings


def _stem_family(stem) -> int:
    from ..models import SpatioTemporalPriorModelChannelAR

    if isinstance(stem, SpatioTemporalPriorModelChannelAR):
        return FAMILY_CHARM
    return FAMILY_WAVEFRONT if stem.use_spm else FAMILY_PARALLEL


def _wavefront_models(i_model, stem, family):
    """The models whose streams are wavefront streams: a family-1 STEM and
    an AR I-model (one with a ``wavefront_format``)."""
    return ([stem] if family == FAMILY_WAVEFRONT else []) + (
        [i_model] if hasattr(i_model, "wavefront_format") else [])


class _LatentCodec:
    """Family 1 and 2 file codec legs: the I-model's analysis and synthesis
    around the STEM's own compress/decompress (the evalSTEM.py:93-153 inner
    loop, with the decoder-consistent ŷ carry)."""

    def __init__(self, i_model, stem, family: int):
        self.i_model = i_model
        self.stem = stem
        self.family = family

    def encode(self, x_padded, y_cond):
        """(ftype, ẑ shape, counts or None, strings, the decoder's ŷ)."""
        y_cur = self.i_model.analysis(x_padded)
        enc = self.stem.compress(y_cur, y_cond)
        shape = tuple(enc["shape"])
        if self.family == FAMILY_CHARM:
            counts = enc.get("counts")
            dec = self.stem.decompress(enc["strings"], shape, y_cond,
                                       transport_mode=enc["transport"],
                                       counts=counts)
            ftype = (FTYPE_P_CHARM if enc["transport"] == "sparse"
                     else FTYPE_P_CHARM_DENSE)
        else:
            dec = self.stem.decompress(enc["strings"], shape, y_cond)
            ftype, counts = FTYPE_P_WAVEFRONT, None
        return ftype, shape, counts, enc["strings"], dec["y_hat"]

    def decode(self, ftype, shape, counts, strings, y_cond):
        if self.family == FAMILY_CHARM:
            if counts is not None:  # the file holds them flat
                counts = counts.reshape(1, self.stem.groups, -1)
            dec = self.stem.decompress(
                strings, shape, y_cond,
                transport_mode=("sparse" if ftype == FTYPE_P_CHARM
                                else "dense"),
                counts=counts)
        else:
            dec = self.stem.decompress(strings, shape, y_cond)
        y_hat = dec["y_hat"]
        return self.i_model.get_x(y_hat), y_hat


def encode_video(frames, i_model, stem, output, gop: int = 12,
                 pipeline=None, meta=None) -> dict:
    """frames: iterable of (H, W, 3) float arrays in [0, 1] (all same size).

    The conditioning carry is the decoder-consistent ŷ throughout — the
    parallel pipeline returns it from its fused encode (and its dense
    fallback from a decode); the wavefront and charm legs replicate the
    decoder (evalSTEM.py:144-153 carries out_dec['y_hat']).

    meta: optional {"i_model", "i_quality"} recorded in the header so the
    decode CLI can rebuild the exact I-model; the STEM family/variant/config
    and both params hashes are always derived from the models themselves."""
    from .pipeline import StemVideoPipeline

    if not 1 <= gop <= 255:
        raise ValueError(f"gop must be in [1, 255] (container u8), got {gop}")
    family = _stem_family(stem)
    if family == FAMILY_PARALLEL:
        pipe = pipeline or StemVideoPipeline(i_model, stem,
                                             transport_mode="sparse")
    else:
        pipe = _LatentCodec(i_model, stem, family)
    y_cond = None
    n_frames = 0
    h = w = None
    body = []
    t0 = time.time()
    for t, img in enumerate(frames):
        x = to_device(np.asarray(img, np.float32)[None], i_model.device)
        if h is None:
            h, w = x.shape[2], x.shape[3]
        elif (x.shape[2], x.shape[3]) != (h, w):
            raise ValueError(
                f"frame {t} is {x.shape[2]}x{x.shape[3]}, but the sequence "
                f"started at {h}x{w} — .stemv holds one fixed-size sequence"
            )
        x_padded, _ = pad_centered(x, 64)
        if t % gop == 0:
            enc = i_model.compress(x_padded)
            dec = i_model.decompress(enc["strings"], tuple(enc["shape"]))
            if "y_hat" not in dec:
                raise ValueError(
                    f"I-frame model {type(i_model).__name__} does not expose "
                    "the latent in decompress(); the video codec needs a "
                    "mean-scale family model (mbt2018-mean, mbt2018, "
                    "cheng2020-*) whose decode returns y_hat for the "
                    "P-frame conditioning"
                )
            y_cond = dec["y_hat"]
            body.append((FTYPE_I, tuple(enc["shape"]), None, enc["strings"]))
        elif family == FAMILY_PARALLEL:
            enc, carry = pipe.encode_frame(x_padded, y_cond)
            if enc.get("transport") == "sparse":
                y_cond = carry  # decoder-consistent ŷ
                body.append((FTYPE_P_SPARSE, tuple(enc["shape"]),
                             enc["counts"], enc["strings"]))
            else:  # dense fallback: replicate the decoder for the carry
                _, y_cond = pipe.decode_frame(enc, y_cond=y_cond)
                body.append((FTYPE_P_DENSE, tuple(enc["shape"]), None,
                             enc["strings"]))
        else:
            ftype, shape, counts, strings, y_cond = pipe.encode(x_padded,
                                                                y_cond)
            body.append((ftype, shape, counts, strings))
        n_frames += 1

    meta = meta or {}
    i_id = model_ids.get(meta.get("i_model"), UNSPECIFIED)
    sv_id = STEM_VARIANT_IDS.get(getattr(stem, "variant", None), UNSPECIFIED)
    if family == FAMILY_WAVEFRONT and stem.wavefront_tile:
        cfg0, cfg1 = stem.wavefront_tile
    elif family == FAMILY_CHARM:
        cfg0 = stem.groups
        cfg1 = int(stem.module.lrp) | (int(stem.residual) << 1)
    else:
        cfg0 = cfg1 = 0
    # bit0 covers every wavefront stream in the file: the family-1 STEM
    # streams and an AR I-model's y streams; one flag, so the two models
    # must agree at encode time (video_codec.py:302-320 of the JAX package)
    fmts = {type(m).__name__: _wf.wire_format(m.wavefront_format, m.coder)
            for m in _wavefront_models(i_model, stem, family)}
    if len(set(fmts.values())) > 1:
        raise ValueError(
            f"wavefront stream orders disagree ({fmts}); the .stemv header "
            "records ONE order for the whole file — set both models' "
            "wavefront_format to the same value")
    flags = int("grouped" in fmts.values())
    ebc = stem.module.entropy_bottleneck_channels
    with Path(output).open("wb") as f:
        f.write(MAGIC + struct.pack(">B", VERSION))
        f.write(struct.pack(
            ">4B2H3B", i_id, int(meta.get("i_quality", 0)) & 0xFF,
            family, sv_id, ebc, stem.in_channels, cfg0, cfg1, flags,
        ))
        f.write(struct.pack(">2Q", params_hash(stem), params_hash(i_model)))
        f.write(struct.pack(">B3I", gop, n_frames, h, w))
        for ftype, shape, counts, strings in body:
            _write_frame(f, ftype, shape, strings, counts)

    size = Path(output).stat().st_size
    bpp = size * 8.0 / (h * w * n_frames)
    print(f"{n_frames} frames | {bpp:.4f} bpp | "
          f"encoded in {time.time() - t0:.2f}s")
    return {"bpp": bpp, "bytes": size, "frames": n_frames}


def _check_family(family: int):
    if family not in (FAMILY_PARALLEL, FAMILY_WAVEFRONT, FAMILY_CHARM):
        raise ValueError(f"unknown .stemv STEM family {family}")


def decode_video(input_path, i_model, stem, output_dir=None, pipeline=None,
                 verify_params: bool = True):
    """Returns the decoded frames as a list of (H, W, 3) float32 arrays;
    optionally writes frame_%04d.png into output_dir.

    verify_params: check the header's weight hashes against the supplied
    models — decoding with the wrong (or randomly initialized) weights
    raises instead of silently emitting garbage frames."""
    from .pipeline import StemVideoPipeline

    with Path(input_path).open("rb") as f:
        hdr = read_header(f)
        family = hdr["stem_family"]
        _check_family(family)
        groups = hdr["cfg0"] if family == FAMILY_CHARM else 0
        gop, n_frames = hdr["gop"], hdr["n_frames"]
        h, w = hdr["h"], hdr["w"]
        records = [_read_frame(f, groups) for _ in range(n_frames)]

    if verify_params:
        for name, model, key, flag in (
            ("stem", stem, "stem_params_hash", "--stem-checkpoint"),
            ("I-frame", i_model, "i_params_hash", "--i-checkpoint"),
        ):
            got = params_hash(model)
            if got != hdr[key]:
                raise ValueError(
                    f"{name} model weights do not match this .stemv file "
                    f"(header {hdr[key]:016x}, supplied {got:016x}). Pass "
                    f"the checkpoint the encoder used ({flag}), or "
                    f"verify_params=False to override."
                )

    if _stem_family(stem) != family:
        raise ValueError(
            f"supplied STEM model is family {_stem_family(stem)}, but the "
            f"file was encoded with family {family}"
        )
    # decode wavefront streams in the symbol order the file was written in
    # (the models are restored afterwards — decoding a file must not
    # silently reconfigure the caller's encoder)
    saved_fmt = {m: m.wavefront_format
                 for m in _wavefront_models(i_model, stem, family)}
    for m in saved_fmt:
        m.wavefront_format = "grouped" if hdr["flags"] & 1 else "lane"
    if family == FAMILY_PARALLEL:
        pipe = pipeline or StemVideoPipeline(i_model, stem,
                                             transport_mode="sparse")
    else:
        pipe = _LatentCodec(i_model, stem, family)
    t0 = time.time()
    frames = []
    y_cond = None
    try:
        for ftype, shape, counts, strings in records:
            if ftype == FTYPE_I:
                dec = i_model.decompress(strings, shape)
                if "y_hat" not in dec:
                    raise ValueError(
                        f"I-frame model {type(i_model).__name__} does not "
                        "expose the latent in decompress(); use a mean-scale "
                        "family model (mbt2018-mean, mbt2018, cheng2020-*) "
                        "for .stemv decode"
                    )
                x_hat, y_cond = dec["x_hat"], dec["y_hat"]
            elif family == FAMILY_PARALLEL:
                enc = {"strings": strings, "shape": shape,
                       "transport": ("sparse" if ftype == FTYPE_P_SPARSE
                                     else "dense")}
                if ftype == FTYPE_P_SPARSE:
                    enc["counts"] = counts[None]  # batch of one sequence
                x_hat, y_cond = pipe.decode_frame(enc, y_cond=y_cond)
            else:
                x_hat, y_cond = pipe.decode(ftype, shape, counts, strings,
                                            y_cond)
            x_np = x_hat[0].float().permute(1, 2, 0).cpu().numpy()
            ph, pw = x_np.shape[0], x_np.shape[1]
            top, left = (ph - h) // 2, (pw - w) // 2
            frames.append(x_np[top:top + h, left:left + w])
    finally:
        for m, fmt in saved_fmt.items():
            m.wavefront_format = fmt
    print(f"{len(frames)} frames decoded in {time.time() - t0:.2f}s "
          f"(gop {gop})")

    if output_dir is not None:
        out = Path(output_dir)
        out.mkdir(parents=True, exist_ok=True)
        for i, fr in enumerate(frames):
            write_png(out / f"frame_{i:04d}.png", to_png_array(fr))
    return frames


def _load_frames(path):
    files = sorted(
        p for p in Path(path).iterdir()
        if p.suffix.lower() in (".png", ".jpg", ".jpeg")
    )
    if not files:
        raise FileNotFoundError(f"no image frames under {path}")
    return [_load_image(p)[0] for p in files]


def _build_models(args):
    """The I-model (zoo, optional checkpoint) and the STEM (optional
    checkpoint's ``"model"`` entry, else the seeded initialisation), both
    on ``args.device`` with their tables."""
    from ..models import (
        SpatioTemporalPriorModel,
        SpatioTemporalPriorModelChannelAR,
    )
    from .codec import _build_model

    i_model = _build_model(args.i_model, args.i_quality, args.i_checkpoint,
                           args.device)
    if args.stem_family == "charm":
        stem = SpatioTemporalPriorModelChannelAR(
            groups=args.charm_groups,
            entropy_bottleneck_channels=args.stem_channels,
            in_channels=i_model.M,
            lrp=args.charm_lrp,
            device=args.device,
        )
    else:
        tile = tuple(args.wavefront_tile) if args.wavefront_tile else None
        want = (WAVEFRONT_VARIANTS if args.stem_family == "wavefront"
                else PARALLEL_VARIANTS)
        if args.stem_variant not in want:
            raise ValueError(
                f"stem variant {args.stem_variant!r} is not in family "
                f"{args.stem_family!r} (choose from {want})"
            )
        stem = SpatioTemporalPriorModel(
            variant=args.stem_variant,
            entropy_bottleneck_channels=args.stem_channels,
            in_channels=i_model.M,
            wavefront_tile=tile,
            device=args.device,
        )
    if args.stem_checkpoint:
        from ..training.checkpoints import load_checkpoint

        ckpt = load_checkpoint(args.stem_checkpoint)
        if "model" not in ckpt:
            raise KeyError(f"{args.stem_checkpoint} has no 'model' entry "
                           f"(it has {sorted(ckpt)})")
        stem.load_state_leaves(ckpt["model"])
    stem.update()
    return i_model, stem


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p):
        # restricted to architectures whose decompress() exposes y_hat
        # (the P-frame conditioning latent)
        p.add_argument("--i-model", default="mbt2018-mean",
                       choices=("mbt2018-mean", "mbt2018", "cheng2020-anchor",
                                "cheng2020-attn"))
        p.add_argument("--i-quality", type=int, default=3)
        p.add_argument("--i-checkpoint")
        p.add_argument("--stem-family", default="parallel",
                       choices=("parallel", "wavefront", "charm"))
        p.add_argument("--stem-variant", default="without_spm",
                       choices=tuple(STEM_VARIANT_IDS))
        p.add_argument("--stem-channels", type=int, default=256)
        p.add_argument("--stem-checkpoint")
        p.add_argument("--wavefront-tile", type=int, nargs=2,
                       metavar=("TH", "TW"))
        p.add_argument("--charm-groups", type=int, default=4)
        p.add_argument("--charm-lrp", action=argparse.BooleanOptionalAction,
                       default=True)
        p.add_argument("--device", default="cuda",
                       help="torch device to run the models on")

    def gop_type(v):
        v = int(v)
        if not 1 <= v <= 255:
            raise argparse.ArgumentTypeError("gop must be in [1, 255]")
        return v

    enc = sub.add_parser("encode")
    enc.add_argument("frames_dir")
    enc.add_argument("-o", "--output", required=True)
    enc.add_argument("--gop", type=gop_type, default=12)
    common(enc)
    dec = sub.add_parser("decode")
    dec.add_argument("input")
    dec.add_argument("-o", "--output-dir", required=True)
    dec.add_argument("--no-verify-params", action="store_true",
                     help="skip the weight-hash check (decodes garbage if "
                          "the weights differ from the encoder's)")
    common(dec)
    args = parser.parse_args(argv)

    if args.command == "encode":
        if args.stem_family == "wavefront" and args.stem_variant not in \
                WAVEFRONT_VARIANTS:
            args.stem_variant = "res"
        frames = _load_frames(args.frames_dir)
        i_model, stem = _build_models(args)
        encode_video(frames, i_model, stem, args.output, gop=args.gop,
                     meta={"i_model": args.i_model,
                           "i_quality": args.i_quality})
    else:
        # validate magic/version and adopt the recorded model configuration
        # BEFORE building anything (codec.py:104's precedent)
        with Path(args.input).open("rb") as f:
            hdr = read_header(f)
        family = hdr["stem_family"]
        _check_family(family)
        if hdr["i_model_id"] != UNSPECIFIED:
            args.i_model = _inverse(model_ids)[hdr["i_model_id"]]
            args.i_quality = hdr["i_quality"]
        args.stem_family = ("parallel", "wavefront", "charm")[family]
        args.stem_channels = hdr["stem_channels"]
        if family == FAMILY_CHARM:
            args.charm_groups = hdr["cfg0"]
            args.charm_lrp = bool(hdr["cfg1"] & 1)
        else:
            args.stem_variant = _inverse(STEM_VARIANT_IDS)[
                hdr["stem_variant_id"]]
            if family == FAMILY_WAVEFRONT and hdr["cfg0"]:
                args.wavefront_tile = (hdr["cfg0"], hdr["cfg1"])
        i_model, stem = _build_models(args)
        decode_video(args.input, i_model, stem, args.output_dir,
                     verify_params=not args.no_verify_params)


if __name__ == "__main__":
    main()
