"""Time the kernels of two builds in turns, without their Python wrappers.

    python3 -m spatiotemporalentropymodel_tpu_torch.ops.kernel_ab \
        --csrc DIR [--rounds N] [--out FILE]

Needs one CUDA card and nvcc. It builds the kernel library of another
tree's ``ops/csrc`` (e.g. a ``git archive`` of the parent commit) beside
this tree's (``build.build``), and launches the C entries whose arguments
both trees share, on the same inputs and in one process: quantize_and_index
at the y plane of 4 × 1088 × 1920 frames (its contiguous f32 entry),
gdn_fused's f32 entry at g_a's first GDN (4 × 192 × 544 × 960) and its
bf16 entry at g_s's first IGDN (4 × 192 × 136 × 240), gdn_conv_fused at
g_a's three stages, the wide g_s kernel at 272 × 480 and 136 × 240 (C =
192) and the narrow one (g_s's packed tail, igdn_deconv_tail_packed) at
544 × 960 → 3. For each, N rounds of this, other, other, this, each timed
with CUDA events over 20 launches. The wrappers' host time (argument
checks, packing) is left out, so the ratio is the kernels' alone. An entry the
other tree lacks (quantize_and_index's strided f32 and bf16 entries, which
read (σ, μ) as the halves of one (B, 2M, H, W) tensor) is timed in this
tree's build alone, 2N times, and so are the widths trees before them
refuse: gdn_conv_fused at 192 → 320 on one 192 × 136 × 240 input (g_a's
last stage of the zoo's N = 192, M = 320 models), and gdn_fused at 256
on the same shapes as at 192. deconv_k5s2_f32 (f32 g_s's transposed
convs) runs at g_s's four shapes of 4 × 1088 × 1920 pictures: 192 → 192
from 68 × 120, 136 × 240 and 272 × 480, 192 → 3 from 544 × 960; and
conv_k5s2_f32 (f32 g_a's convs) at g_a's four: 3 → 192 from 1088 × 1920,
192 → 192 from 544 × 960, 272 × 480 and 136 × 240.

Prints one JSON line per kernel and shape: the median ms per launch of
each build over its 2N timings, their spread and the ratio other / this
(null where the other tree lacks the entry).
"""

import argparse
import ctypes
import json
from pathlib import Path

import torch

from . import kernels
from .build import build

ITERS = 20
VP, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
SIGNATURES = {
    "stem_quantize_and_index_f32": [VP, VP, VP, VP, I32, ctypes.c_float, VP,
                                    VP, I64, VP],
    "stem_quantize_and_index_f32_strided": [VP] * 3 + [I64] * 5 + [
        VP, I32, ctypes.c_float, VP, VP, VP],
    "stem_quantize_and_index_bf16": [VP] * 3 + [I64] * 5 + [
        VP, I32, ctypes.c_float, VP, VP, VP],
    "stem_gdn_fused_f32": [VP] * 4 + [I64, I32, I64, I32, VP],
    "stem_gdn_fused_bf16": [VP] * 4 + [I64, I32, I64, I32, VP],
    "stem_gdn_conv_fused_bf16": [VP] * 6 + [I64, I32, I32, I32, I32, VP],
    "stem_igdn_deconv_wide_bf16": [VP] * 6 + [I64, I32, I32, I32, I32, VP],
    "stem_igdn_deconv_narrow_bf16": [VP] * 6 + [I64] + [I32] * 5 + [VP],
    "stem_deconv_k5s2_f32": [VP] * 4 + [I64, I32, I32, I32, I32, VP],
    "stem_conv_k5s2_f32": [VP] * 4 + [I64, I32, I32, I32, I32, VP],
}


def _open(path):
    lib = ctypes.CDLL(str(path))
    for name, args in SIGNATURES.items():
        if not hasattr(lib, name):  # an older tree's build
            continue
        getattr(lib, name).restype = I32
        getattr(lib, name).argtypes = args
    return lib


def _cases(gen):
    """(label, entry, arguments but the stream, whether the other tree
    takes them) per case, and the tensors the arguments point into (keep
    them alive)."""
    from ..entropy import get_scale_table

    dev, c, b = "cuda", 192, 4
    keep, cases = [], []
    shape = (b, c, 68, 120)
    means = 2.0 * torch.randn(shape, generator=gen, device=dev)
    y = means + 3.0 * torch.randn(shape, generator=gen, device=dev)
    scales = torch.exp(4.0 * torch.rand(shape, generator=gen, device=dev)
                       - 3.0)
    table = kernels.scale_table_tensor(get_scale_table(), dev)
    sym = torch.empty(shape, dtype=torch.int32, device=dev)
    idx = torch.empty(shape, dtype=torch.uint8, device=dev)
    keep += [means, y, scales, table, sym, idx]
    cases.append((f"quantize_and_index {list(shape)}",
                  "stem_quantize_and_index_f32",
                  (y.data_ptr(), means.data_ptr(), scales.data_ptr(),
                   table.data_ptr(), table.numel() - 1, 0.11, sym.data_ptr(),
                   idx.data_ptr(), y.numel()), True))
    # (σ, μ) as the halves of one (B, 2M, H, W) tensor, as on the paths
    per = y.numel() // b
    for dtype, entry in (
            (torch.float32, "stem_quantize_and_index_f32_strided"),
            (torch.bfloat16, "stem_quantize_and_index_bf16")):
        yd = y.to(dtype)
        both = torch.cat([scales, means], dim=1).to(dtype)
        keep += [yd, both]
        cases.append((f"{entry} {list(shape)}, (σ, μ) halves", entry,
                      (yd.data_ptr(), both[:, c:].data_ptr(),
                       both.data_ptr(), b, per, per, 2 * per, 2 * per,
                       table.data_ptr(), table.numel() - 1, 0.11,
                       sym.data_ptr(), idx.data_ptr()), True))
    for cg in (c, 256):  # gdn_fused, its f32 and bf16 entries
        gt = (0.02 * torch.rand((cg, cg), generator=gen, device=dev)
              + 0.1 * torch.eye(cg, device=dev)).t().contiguous()
        bg = 1.0 + torch.rand((cg,), generator=gen, device=dev)
        for entry, dtype, k, (h, w), inverse in (
                ("stem_gdn_fused_f32", torch.float32, 3, (544, 960), 0),
                ("stem_gdn_fused_bf16", torch.bfloat16, 2, (136, 240), 1)):
            x = torch.randn((b, cg, h, w), generator=gen,
                            device=dev).to(dtype)
            out, gp = torch.empty_like(x), kernels.split_gamma_pieces(gt, k)
            keep += [gt, bg, x, out, gp]
            cases.append((f"{entry} {[b, cg, h, w]}", entry,
                          (x.data_ptr(), gp.data_ptr(), bg.data_ptr(),
                           out.data_ptr(), b, cg, h * w, inverse), cg == c))
    gamma = (0.02 * torch.rand((c, c), generator=gen, device=dev)
             + 0.1 * torch.eye(c, device=dev))
    gs = kernels.split_gamma(gamma.t().contiguous())
    beta = 1.0 + torch.rand((c,), generator=gen, device=dev)
    bias = 0.1 * torch.randn((c,), generator=gen, device=dev)
    weight = (torch.randn((c, c, 5, 5), generator=gen, device=dev)
              * (2.0 / (25 * c)) ** 0.5).to(torch.bfloat16)
    wc, ww = kernels.pack_conv_weight(weight), kernels.pack_wide_weight(weight)
    keep += [gs, beta, bias, wc, ww]
    for entry, sizes, wp, out_hw in (
            ("stem_gdn_conv_fused_bf16", ((544, 960), (272, 480), (136, 240)),
             wc, lambda h, w: ((h + 1) // 2, (w + 1) // 2)),
            ("stem_igdn_deconv_wide_bf16", ((272, 480), (136, 240)), ww,
             lambda h, w: (2 * h, 2 * w))):
        for h, w in sizes:
            x = torch.randn((b, c, h, w), generator=gen,
                            device=dev).to(torch.bfloat16)
            out = torch.empty((b, c, *out_hw(h, w)), dtype=torch.bfloat16,
                              device=dev)
            keep += [x, out]
            cases.append((f"{entry} {[b, c, h, w]}", entry,
                          (x.data_ptr(), gs.data_ptr(), beta.data_ptr(),
                           wp.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
                           c, c, h, w), True))
    # the narrow kernel C → 3 from 544 × 960, its weights, bias and rows as
    # kernels._narrow_launch hands them over
    f, (h, w) = 3, (544, 960)
    weight = (torch.randn((c, f, 5, 5), generator=gen, device=dev)
              * (2.0 / (25 * c)) ** 0.5).to(torch.bfloat16)
    _, _, rows_o, live = kernels._narrow_index(torch.device(dev), f)
    bias_m = torch.where(live, (0.1 * torch.randn(
        (f,), generator=gen, device=dev))[rows_o], 0.0)
    wn = kernels.pack_narrow_weight(weight)
    x = torch.randn((b, c, h, w), generator=gen, device=dev).to(torch.bfloat16)
    out = torch.empty((b, f, 2 * h, 2 * w), dtype=torch.bfloat16, device=dev)
    keep += [wn, bias_m, x, out]
    cases.append((f"stem_igdn_deconv_narrow_bf16 {[b, c, h, w]} → {f}",
                  "stem_igdn_deconv_narrow_bf16",
                  (x.data_ptr(), gs.data_ptr(), beta.data_ptr(),
                   wn.data_ptr(), bias_m.data_ptr(), out.data_ptr(), b, c, f,
                   kernels.narrow_rows(f), h, w), True))
    o, (h, w) = 320, (136, 240)
    weight = (torch.randn((o, c, 5, 5), generator=gen, device=dev)
              * (2.0 / (25 * c)) ** 0.5).to(torch.bfloat16)
    wc, bias = kernels.pack_conv_weight(weight), torch.zeros(o, device=dev)
    x = torch.randn((1, c, h, w), generator=gen, device=dev).to(torch.bfloat16)
    out = torch.empty((1, o, h // 2, w // 2), dtype=torch.bfloat16, device=dev)
    keep += [wc, bias, x, out]
    cases.append((f"stem_gdn_conv_fused_bf16 {[1, c, h, w]} → {o}",
                  "stem_gdn_conv_fused_bf16",
                  (x.data_ptr(), gs.data_ptr(), beta.data_ptr(),
                   wc.data_ptr(), bias.data_ptr(), out.data_ptr(), 1, c, o,
                   h, w), False))
    for o, (h, w) in ((c, (68, 120)), (c, (136, 240)), (c, (272, 480)),
                      (3, (544, 960))):
        weight = (torch.randn((c, o, 5, 5), generator=gen, device=dev)
                  * (2.0 / (25 * c)) ** 0.5)
        wk = kernels.pack_deconv_f32_weight(weight)
        bias = 0.1 * torch.randn((o,), generator=gen, device=dev)
        x = torch.randn((b, c, h, w), generator=gen, device=dev)
        out = torch.empty((b, o, 2 * h, 2 * w), device=dev)
        keep += [wk, bias, x, out]
        cases.append((f"stem_deconv_k5s2_f32 {[b, c, h, w]} → {o}",
                      "stem_deconv_k5s2_f32",
                      (x.data_ptr(), wk.data_ptr(), bias.data_ptr(),
                       out.data_ptr(), b, c, o, h, w), True))
    for ci, (h, w) in ((3, (1088, 1920)), (c, (544, 960)), (c, (272, 480)),
                       (c, (136, 240))):
        weight = (torch.randn((c, ci, 5, 5), generator=gen, device=dev)
                  * (2.0 / (25 * ci)) ** 0.5)
        wk = kernels.pack_conv_f32_weight(weight)
        bias = 0.1 * torch.randn((c,), generator=gen, device=dev)
        x = torch.randn((b, ci, h, w), generator=gen, device=dev)
        out = torch.empty((b, c, h // 2, w // 2), device=dev)
        keep += [wk, bias, x, out]
        cases.append((f"stem_conv_k5s2_f32 {[b, ci, h, w]} → {c}",
                      "stem_conv_k5s2_f32",
                      (x.data_ptr(), wk.data_ptr(), bias.data_ptr(),
                       out.data_ptr(), b, ci, c, h, w), True))
    return cases, keep


def _ms(fn, args, stream):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        rc = fn(*args, stream)
        if rc != 0:
            raise RuntimeError(f"launch failed with error {rc}")
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / ITERS


def run(other: Path, rounds: int):
    libs = {"this": _open(build()), "other": _open(build(other))}
    gen = torch.Generator(device="cuda").manual_seed(31)
    cases, _keep = _cases(gen)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for label, entry, args, shared in cases:
        fns = {k: getattr(lib, entry) for k, lib in libs.items()
               if hasattr(lib, entry) and (shared or k == "this")}
        for fn in fns.values():  # warm-up
            for _ in range(3):
                fn(*args, stream)
        order = (("this", "other", "other", "this") if "other" in fns
                 else ("this", "this"))
        times = {k: [] for k in fns}
        for _ in range(rounds):
            for who in order:
                times[who].append(_ms(fns[who], args, stream))
        med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
        other = med.get("other")
        row = dict(case=label, this_ms=med["this"], other_ms=other,
                   ratio=None if other is None else other / med["this"],
                   this_range=[min(times["this"]), max(times["this"])],
                   other_range=([min(times["other"]), max(times["other"])]
                                if other is not None else None),
                   launches_per_timing=ITERS, timings=2 * rounds)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--csrc", type=Path, required=True,
                    help="the other tree's ops/csrc")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the rows to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab needs a CUDA card")
    rows = run(args.csrc.resolve(), args.rounds)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(rows, indent=1))


if __name__ == "__main__":
    main()
