"""CompressAI checkpoint → the port's models: the key maps and the
converter CLI.

Counterpart of spatiotemporalentropymodel_tpu/zoo/convert.py
(compressai/zoo/pretrained.py:16-44). Both sides are torch
layouts: Conv2d (O, I, kh, kw), ConvTranspose2d (I, O, kh, kw), GDN β and γ
in their reparametrized space, the entropy bottleneck's matrices, biases,
factors and quantiles, and the masked conv's weight as stored (its mask is
applied again in the forward, layers/masked_conv.py). So a parameter's
value carries over as it is, and only its name changes: the port's
``Sequential`` keeps its layers under ``layers.<i>``, where CompressAI's
``nn.Sequential`` has ``<i>``; a ``SubpelConv3x3``'s conv is ``conv``
here and ``0`` there; an ``AttentionBlock``'s residual units are ``a_<i>``,
``b_<i>`` and ``b_out`` here and ``conv_a.<i>``, ``conv_b.<i>`` and
``conv_b.3`` there, each unit's convs ``conv_<j>`` here and ``conv.<0|2|4>``
there; an SFT's shared conv is ``mlp_shared`` here and ``mlp_shared.0``
(a Sequential with its ReLU) there.

``KEY_MAPS[name]`` maps a port parameter name to its CompressAI key,
driven by the layer kinds of each ``Sequential`` and of the ROI family's
top-level layers, as the JAX package's maps are (convert.py:279-400
there): the six image architectures, ``"stem"`` (the five STEM variants),
``"stem-baseline"`` (stem_baseline and v2) and ``"stem-roi"`` (stem_roi,
stem_roi_wo_gsc, stem_roi_i; the parameters a model lacks are simply not
asked for). ``main`` converts a ``.pth.tar`` into the port's checkpoint
file.
"""

from typing import Any, Dict, Mapping

import numpy as np
import torch


def rename_key(key: str) -> str:
    """Normalize legacy checkpoint keys (zoo/pretrained.py:16-38): the
    DataParallel ``module.`` prefix, ``downsample`` → ``skip`` and the old
    entropy-bottleneck names ``_biases.N`` → ``_biasN`` and the like."""
    if key.startswith("module."):
        key = key[7:]
    if ".downsample." in key:
        key = key.replace("downsample", "skip")
    for legacy, new in (("._biases.", "._bias"),
                        ("._matrices.", "._matrix"),
                        ("._factors.", "._factor")):
        if legacy in key:
            key = key.replace(legacy, new)
    return key


def _to_numpy(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def tables_from_state_dict(state_dict,
                           bottleneck_names=("entropy_bottleneck",),
                           has_gaussian=True):
    """The CDF tables a CompressAI checkpoint ships as buffers
    (``_quantized_cdf``, ``_offset``, ``_cdf_length`` and the Gaussian
    conditional's ``scale_table``, entropy_models.py:92-95 there), adopted
    as they are so the streams are the reference's byte for byte; None when
    it ships none (convert.py::tables_from_state_dict of the JAX
    package)."""
    from ..entropy.tables import CodecTables

    renamed = {rename_key(k): _to_numpy(v) for k, v in state_dict.items()}
    first = f"{bottleneck_names[0]}._quantized_cdf"
    if first not in renamed or renamed[first].size == 0:
        return None
    tables = {}
    for name in bottleneck_names:
        tables[name] = CodecTables(
            cdf=renamed[f"{name}._quantized_cdf"].astype(np.int32),
            cdf_length=renamed[f"{name}._cdf_length"].astype(np.int32),
            offset=renamed[f"{name}._offset"].astype(np.int32),
            medians=renamed[f"{name}.quantiles"][:, 0, 1].astype(np.float64),
        )
    gc = "gaussian_conditional"
    if has_gaussian and renamed.get(f"{gc}._quantized_cdf",
                                    np.empty(0)).size:
        tables[gc] = CodecTables(
            cdf=renamed[f"{gc}._quantized_cdf"].astype(np.int32),
            cdf_length=renamed[f"{gc}._cdf_length"].astype(np.int32),
            offset=renamed[f"{gc}._offset"].astype(np.int32),
            scale_table=renamed[f"{gc}.scale_table"].astype(np.float64),
        )
    return tables


# the convs of a CompressAI ResidualUnit: Sequential(conv1x1, ReLU, conv3x3,
# ReLU, conv1x1) (layers/layers.py:177-189)
_RU_CONV_IDX = {"conv_0": 0, "conv_1": 2, "conv_2": 4}


def resolve_block(prefix: str, kind: str, sub, leaf: str) -> str:
    """The CompressAI key of one parameter inside a layer.

    prefix: the layer's CompressAI name (e.g. "g_a.0"); kind: its kind;
    sub: the port's submodule names below the layer; leaf: the parameter's
    name ("weight", "bias", "beta", "gamma")."""
    if kind in ("conv", "deconv", "gdn"):
        return f"{prefix}.{leaf}"
    if kind == "subpel":  # CompressAI: Sequential(conv3x3, PixelShuffle)
        return f"{prefix}.0.{leaf}"
    name = sub[0]
    if kind in ("rbs", "rb"):  # conv1, conv2, skip, gdn
        return f"{prefix}.{name}.{leaf}"
    if kind == "rbu":  # subpel_conv, conv, igdn, upsample
        if name in ("subpel_conv", "upsample"):
            return resolve_block(f"{prefix}.{name}", "subpel", sub[1:], leaf)
        return f"{prefix}.{name}.{leaf}"
    if kind == "attn":  # a_i, b_i residual units and b_out
        if name == "b_out":
            return f"{prefix}.conv_b.3.{leaf}"
        branch, i = name.split("_")
        return (f"{prefix}.conv_{branch}.{i}.conv.{_RU_CONV_IDX[sub[1]]}"
                f".{leaf}")
    if kind == "sft":  # mlp_shared is Sequential(conv, ReLU) there
        suffix = ".0" if name == "mlp_shared" else ""
        return f"{prefix}.{name}{suffix}.{leaf}"
    if kind == "sftres":  # norm_0, norm_1 SFTs and conv_0, conv_1
        if name.startswith("norm_"):
            return resolve_block(f"{prefix}.{name}", "sft", sub[1:], leaf)
        return f"{prefix}.{name}.{leaf}"
    raise ValueError(f"unknown layer kind {kind!r} at {prefix}")


def sequential_key_map(seq_kinds: Mapping[str, Mapping[int, str]],
                       top_kinds: Mapping[str, str] = None):
    """The key map of a model whose top level is named ``Sequential``
    stacks, ``seq_kinds`` {"g_a": {0: "conv", 1: "gdn", …}, …} giving each
    layer's kind (``resolve_block``), and layers of their own,
    ``top_kinds`` {"ga4": "conv", "ga1_SFT": "sft", …} (the ROI family's);
    the entropy bottleneck and the context model map by name. Returns
    fn(port name) → CompressAI key, or None for a parameter the checkpoint
    does not hold."""

    def key_map(name: str):
        parts = name.split(".")
        top, leaf = parts[0], parts[-1]
        if top_kinds and top in top_kinds:
            return resolve_block(top, top_kinds[top], parts[1:-1], leaf)
        if top == "entropy_bottleneck":
            return (f"{top}.{leaf}" if leaf == "quantiles"
                    else f"{top}._{leaf}")
        if top == "context_prediction":
            return name
        if top in seq_kinds and len(parts) >= 4 and parts[1] == "layers":
            kind = seq_kinds[top].get(int(parts[2]))
            if kind is not None:
                return resolve_block(f"{top}.{parts[2]}", kind, parts[3:-1],
                                     leaf)
        return None

    return key_map


def convert_state_dict(state_dict: Mapping[str, Any], module,
                       key_map) -> Dict[str, torch.Tensor]:
    """The state dict of ``module`` (every parameter, f32) from a CompressAI
    one: each parameter's key through ``key_map`` after ``rename_key``.
    Raises on a missing key, a parameter with no key, or a shape that
    differs."""
    renamed = {rename_key(k): v for k, v in state_dict.items()}
    out = {}
    for name, p in module.named_parameters():
        key = key_map(name)
        if key is None:
            raise KeyError(f"no checkpoint key for parameter {name}")
        if key not in renamed:
            raise KeyError(f"checkpoint missing key {key!r} for parameter "
                           f"{name}")
        v = _to_numpy(renamed[key]).astype(np.float32)
        if v.shape != tuple(p.shape):
            raise ValueError(f"shape mismatch for {name}: checkpoint "
                             f"{v.shape} vs model {tuple(p.shape)}")
        out[name] = torch.from_numpy(np.ascontiguousarray(v))
    return out


# per-architecture Sequential layouts (torch index → kind)
_CONV_GDN_GA = {0: "conv", 1: "gdn", 2: "conv", 3: "gdn", 4: "conv", 5: "gdn",
                6: "conv"}
_DECONV_GDN_GS = {0: "deconv", 1: "gdn", 2: "deconv", 3: "gdn", 4: "deconv",
                  5: "gdn", 6: "deconv"}
# convs (or two transposed convs and a conv) with activations between:
# h_a/h_s, STEM's TPM/HE/HD/EPM, the ROI family's quality-map heads and
# stages, hs and wmap_generator (a stack of two convs asks for 0 and 2
# only); the decoder's quality-map stages start with a transposed conv
# (stem_roi.py:379-429, 473-491)
_CONV3 = {0: "conv", 2: "conv", 4: "conv"}
_DECONV2_CONV = {0: "deconv", 2: "deconv", 4: "conv"}
_HYPER = {"h_a": _CONV3, "h_s": _DECONV2_CONV}
_QMAP_UP = {0: "deconv", 2: "conv"}
_CONV_GDN_STAGE = {0: "conv", 1: "gdn"}
_DECONV_IGDN_STAGE = {0: "deconv", 1: "gdn"}
_CHENG_HYPER = {
    "h_a": {0: "conv", 2: "conv", 4: "conv", 6: "conv", 8: "conv"},
    "h_s": {0: "conv", 2: "subpel", 4: "conv", 6: "subpel", 8: "conv"},
}

KEY_MAPS = {
    "bmshj2018-factorized": sequential_key_map(
        {"g_a": _CONV_GDN_GA, "g_s": _DECONV_GDN_GS}),
    "bmshj2018-hyperprior": sequential_key_map(
        {"g_a": _CONV_GDN_GA, "g_s": _DECONV_GDN_GS, **_HYPER}),
    "mbt2018-mean": sequential_key_map(
        {"g_a": _CONV_GDN_GA, "g_s": _DECONV_GDN_GS, **_HYPER}),
    "mbt2018": sequential_key_map(
        {"g_a": _CONV_GDN_GA, "g_s": _DECONV_GDN_GS, **_HYPER,
         "entropy_parameters": _CONV3}),
    # Cheng2020 (waseda.py:29-138): residual/attention transforms, a 3×3
    # hyper pair with sub-pixel upsampling, mbt2018's entropy machinery
    "cheng2020-anchor": sequential_key_map({
        "g_a": {0: "rbs", 1: "rb", 2: "rbs", 3: "rb", 4: "rbs", 5: "rb",
                6: "conv"},
        "g_s": {0: "rb", 1: "rbu", 2: "rb", 3: "rbu", 4: "rb", 5: "rbu",
                6: "rb", 7: "subpel"},
        **_CHENG_HYPER, "entropy_parameters": _CONV3}),
    "cheng2020-attn": sequential_key_map({
        "g_a": {0: "rbs", 1: "rb", 2: "rbs", 3: "attn", 4: "rb", 5: "rbs",
                6: "rb", 7: "conv", 8: "attn"},
        "g_s": {0: "attn", 1: "rb", 2: "rbu", 3: "rb", 4: "rbu", 5: "attn",
                6: "rb", 7: "rbu", 8: "rb", 9: "subpel"},
        **_CHENG_HYPER, "entropy_parameters": _CONV3}),
    "stem": sequential_key_map({"HE": _CONV3, "HD": _DECONV2_CONV,
                                "TPM": _CONV3, "EPM": _CONV3}),
    # stem_baseline / stem_baselinev2 (stem_roi.py:21-348)
    "stem-baseline": sequential_key_map({
        "PEncoder": _CONV_GDN_GA, "ConditionEncoder": _CONV_GDN_GA,
        "PDecoder": _DECONV_GDN_GS, "TPM": _CONV3, "HE": _CONV3,
        "HD": _DECONV2_CONV, "EPM": _CONV3}),
    # the stem_roi family (stem_roi.py:353-1325)
    "stem-roi": sequential_key_map(
        {
            "ga1": _CONV_GDN_STAGE, "ga2": _CONV_GDN_STAGE,
            "ga3": _CONV_GDN_STAGE,
            "qmap_feature_ga1": _CONV3, "qmap_feature_ga2": _CONV3,
            "qmap_feature_ga3": _CONV3, "qmap_feature_ga4": _CONV3,
            "qmap_feature_ha1": _CONV3, "qmap_feature_ha2": _CONV3,
            "qmap_feature_ha3": _CONV3,
            "qmap_feature_gs0": _CONV3, "qmap_feature_gs1": _QMAP_UP,
            "qmap_feature_gs2": _QMAP_UP, "qmap_feature_gs3": _QMAP_UP,
            "hs": _DECONV2_CONV, "wmap_generator": _DECONV2_CONV,
            "gs1": _DECONV_IGDN_STAGE, "gs2": _DECONV_IGDN_STAGE,
            "gs3": _DECONV_IGDN_STAGE,
            "ConditionEncoder": _CONV_GDN_GA, "TPM": _CONV3, "EPM": _CONV3,
        },
        top_kinds={
            "ga4": "conv", "gs4": "deconv",
            "ha1": "conv", "ha2": "conv", "ha3": "conv",
            "ga1_SFT": "sft", "ga2_SFT": "sft", "ga3_SFT": "sft",
            "ha1_SFT": "sft", "ha2_SFT": "sft",
            "gs1_SFT": "sft", "gs2_SFT": "sft", "gs3_SFT": "sft",
            "ga4_SFTResB1": "sftres", "ga4_SFTResB2": "sftres",
            "ha3_ResB1": "sftres", "ha3_ResB2": "sftres",
            "gs0_SFTResB1": "sftres", "gs0_SFTResB2": "sftres",
        },
    ),
}


def main(argv=None):
    """Checkpoint-converter CLI: a CompressAI ``.pth.tar`` → the port's
    checkpoint file, whose ``"model"`` entry loads through
    ``training.checkpoints.load_checkpoint`` and
    ``CompressionModel.load_state_leaves`` (the codec CLIs'
    ``--checkpoint``), with the tables the checkpoint ships adopted as
    they are (convert.py:400-475 of the JAX package).

      python -m spatiotemporalentropymodel_tpu_torch.zoo.convert IN.pth.tar \\
          -o OUT.ckpt --arch mbt2018-mean --quality 3
      python -m spatiotemporalentropymodel_tpu_torch.zoo.convert IN.pth.tar \\
          -o OUT.ckpt --video stem_roi --in-channels 192 --ebc 256
    """
    import argparse
    import hashlib
    from pathlib import Path

    from . import (
        load_torch_checkpoint, load_video_torch_checkpoint,
        model_architectures, roi_models, stem_models,
    )
    from ..training.checkpoints import save_checkpoint

    parser = argparse.ArgumentParser(description=main.__doc__)
    parser.add_argument("checkpoint", help="torch .pth.tar input")
    parser.add_argument("-o", "--output", required=True)
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument("--arch", choices=sorted(model_architectures))
    group.add_argument("--video",
                       choices=sorted(list(stem_models) + list(roi_models)))
    parser.add_argument("--quality", type=int, default=1,
                        help="zoo quality index (image archs)")
    parser.add_argument("--in-channels", type=int, default=192)
    parser.add_argument("--ebc", type=int, default=256,
                        help="entropy bottleneck channels (video archs)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    if args.video:
        if args.video == "stpm_charm":
            raise SystemExit(
                "stpm_charm is a beyond-reference architecture with no "
                "torch counterpart to convert from")
        model = load_video_torch_checkpoint(
            args.video, args.checkpoint, device=args.device,
            in_channels=args.in_channels,
            entropy_bottleneck_channels=args.ebc)
        name = args.video
    else:
        model = load_torch_checkpoint(args.arch, args.checkpoint,
                                      args.quality, device=args.device)
        name = f"{args.arch} q{args.quality}"

    save_checkpoint({"model": model.state_tree()}, args.output)
    blob = Path(args.output).read_bytes()
    sha = hashlib.sha256(blob).hexdigest()[:8]
    n_params = sum(p.numel() for p in model.module.parameters())
    print(f"{name}: {n_params:,} params, tables {sorted(model.tables)} -> "
          f"{args.output} ({len(blob):,} bytes, sha256 {sha})")


if __name__ == "__main__":
    main()
