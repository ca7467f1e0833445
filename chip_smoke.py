#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port's serving paths: the P-frame path
in f32 and bf16, the bf16 g_s chain under the JAX package's wide knobs, and
the I-frame codec.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and g++; imports no JAX. Phases:

  1. device   — fail without CUDA; print the card's name and power limit; pin
                f32 numerics (no TF32) and deterministic cuDNN, so encoder
                and decoder compute bit-identical (σ, μ) from ẑ.
  2. build    — the CUDA kernels (nvcc, one process per source) and the rANS
                coder (g++), in parallel, from the checkout's sources.
  3. kernels  — each kernel against its plain PyTorch version on the card at
                the serving paths' shapes, timed with CUDA events beside its
                bound, its plain version and the nearest library call:
                gdn_fused f32 (rtol 1e-5, atol 1e-6) and bf16 (rtol 2⁻⁷: one
                bf16 step); quantize_and_index exact, with crafted ties,
                saturation and table-edge scales; gdn_conv_fused at g_a's
                three stages, igdn_deconv_wide_packed at 272×480,
                igdn_deconv_tail_packed at 544×960, igdn_deconv_wide at
                136×240 and igdn_deconv_fused at 544×960, each at
                max|kernel − plain| ≤ 2⁻⁶·max|plain| (the kernels round the
                (I)GDN'd window to bf16 for the tensor cores; the plain g_s
                versions keep it f32, as the JAX refs do).
  4. paths    — MeanScaleHyperprior(192, 192) and a without_spm STEM (EB 256)
                from seeds, the benchmark workload's weight surgery (at f32),
                then StemVideoPipeline(sparse) encodes 3 P-frames of
                4×3×1088×1920 with encode_frames and decodes them with
                decode_frames: first in f32, then after
                set_compute_dtype(bf16) on both models. In each, every frame
                must take the sparse transport, the encoder's carried ŷ must
                equal the decoder's ŷ exactly, x̂ must be finite and of the
                right shape, bpp finite and below 1. Then, on the bf16
                models: bf16_wide decodes the same streams under the wide
                knobs (ops/kernels.py::WIDE_KNOBS), with ŷ equal to the
                default decode's, mean|Δx̂| ≤ 2e-3 and the unclamped g_s
                outputs within 2⁻⁵·max|default|; iframe_bf16 and
                iframe_bf16_wide compress and decompress frame 0 with the
                I-frame codec, with encoder ŷ == decoder ŷ and streams that
                repeat. On every path each kernel must have launched exactly
                as often as the path calls it.
  5. report   — one JSON line of kernels, then the card, then the result line.

Exits non-zero, printing no result line, on any failure.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

B, H, W = 4, 1088, 1920
N = M = 192
EBC = 256
P_FRAMES = 3
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores
BF16_TC_FLOPS_PER_S = 989e12  # H100 SXM, bf16 dense on the tensor cores
GDN_RTOL, GDN_ATOL = 1e-5, 1e-6
GDN_BF16_RTOL = 2**-7  # one bf16 step: only the f32 summation order differs
FUSED_TOL = 2**-6  # max|kernel − plain| ≤ FUSED_TOL · max|plain|
# the wide path: mean|x̂_wide − x̂_default| (the mean criterion of
# tests/test_torch_bf16_pipeline.py), and max|Δ| of the unclamped g_s outputs
# over max|default| (FUSED_TOL's scale, doubled for one differing stage
# carried through two more)
WIDE_X_MEAN = 2e-3
WIDE_GS_TOL = 2**-5
KERNELS = ("gdn_fused", "gdn_fused_bf16", "quantize_and_index",
           "gdn_conv_fused", "igdn_deconv_wide_packed",
           "igdn_deconv_tail_packed", "igdn_deconv_fused", "igdn_deconv_wide")
PK = "spatiotemporalentropymodel_tpu/ops/pallas_kernels.py"
CSRC = "spatiotemporalentropymodel_tpu_torch/ops/csrc"


def log(*args):
    print(*args, flush=True)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median ms of fn() over `iters` runs, each timed with CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def timed_ms(torch, fn):
    """(host ms of fn() between two synchronisations, its result)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3, out


def bound(bytes_moved: float, ops: float, tc_ops: float = 0.0):
    """Least ms for the work: bytes over the memory rate, or the operations
    over their units' peak rates, f32 on the CUDA cores (``ops``) and bf16
    on the tensor cores (``tc_ops``); the two units run side by side, so
    the larger of their times bounds the operations."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / F32_FLOPS_PER_S, tc_ops / BF16_TC_FLOPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_gdn(torch, kernels):
    """gdn_fused, forward and inverse, at the three g_a/g_s widths."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    c = N
    # a dense non-negative γ exercises the whole channel reduction
    gamma = (0.02 * torch.rand((c, c), generator=gen, device="cuda")
             + 0.1 * torch.eye(c, device="cuda"))
    gamma_t = gamma.t().contiguous()
    beta = 1.0 + torch.rand((c,), generator=gen, device="cuda")
    worst_abs = worst_rel = 0.0
    timing = None
    for hh, ww in ((544, 960), (272, 480), (136, 240)):
        x = torch.randn((B, c, hh, ww), generator=gen, device="cuda")
        for inverse in (False, True):
            out = kernels.gdn_fused(x, gamma_t, beta, inverse)
            ref = kernels._gdn_ref(x, gamma_t, beta, inverse)
            torch.cuda.synchronize()
            err = (out - ref).abs()
            abs_err = float(err.max())
            rel_err = float((err / ref.abs().clamp_min(GDN_ATOL)).max())
            ok = bool(torch.allclose(out, ref, rtol=GDN_RTOL, atol=GDN_ATOL))
            log(f"  gdn_fused {'inv' if inverse else 'fwd'} "
                f"({B * hh * ww}, {c}): max abs {abs_err:.3e} "
                f"max rel {rel_err:.3e} ok={ok}")
            if not ok:
                raise AssertionError(
                    f"gdn_fused disagrees with its plain version at "
                    f"{tuple(x.shape)} inverse={inverse}")
            worst_abs = max(worst_abs, abs_err)
            worst_rel = max(worst_rel, rel_err)
            del out, ref, err
        if timing is None:  # the largest shape: g_a's first / g_s's last
            rows = B * hh * ww
            xsq_rows = (x * x).permute(0, 2, 3, 1).reshape(rows, c).contiguous()
            ms = cuda_ms(lambda: kernels.gdn_fused(x, gamma_t, beta, False))
            plain_ms = cuda_ms(
                lambda: kernels._gdn_ref(x, gamma_t, beta, False))
            # the nearest single library call: the norm's product alone
            lib_ms = cuda_ms(lambda: torch.addmm(beta, xsq_rows, gamma_t))
            b_ms, b_by = bound(2 * rows * c * 4 + c * c * 4 + c * 4,
                               2 * rows * c * c + 4 * rows * c)
            timing = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by,
                          shape=[rows, c])
            del xsq_rows
        del x
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst_abs, max_rel_err=worst_rel, **timing)


def check_qidx(torch, kernels, table):
    """quantize_and_index at the y plane's shape, exact, with crafted
    ties, saturation and table-edge scales."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    shape = (B, M, H // 16, W // 16)
    n = B * M * (H // 16) * (W // 16)
    means = 2.0 * torch.randn(shape, generator=gen, device="cuda")
    y = means + 3.0 * torch.randn(shape, generator=gen, device="cuda")
    scales = torch.exp(4.0 * torch.rand(shape, generator=gen, device="cuda")
                       - 3.0)
    yf, mf, sf = y.view(-1), means.view(-1), scales.view(-1)
    k = torch.arange(-40, 41, device="cuda", dtype=torch.float32)
    ties = k + 0.5  # y − μ exactly on ±k.5
    mf[:ties.numel()] = 0.0
    yf[:ties.numel()] = ties
    big = torch.tensor([3e9, -3e9, 2.0**30 + 128, -(2.0**30) - 128, 1e38],
                       device="cuda")
    o = ties.numel()
    mf[o:o + big.numel()] = 0.0
    yf[o:o + big.numel()] = big
    t = table.to(torch.float32)
    edges = torch.cat([
        t, torch.nextafter(t, torch.full_like(t, -1.0)),
        torch.nextafter(t, torch.full_like(t, 1e9)),
        torch.tensor([0.11, 0.0, -1.0, 0.05], device="cuda"),
        torch.nextafter(torch.tensor([0.11], device="cuda"),
                        torch.tensor([1.0], device="cuda")),
    ])
    sf[:edges.numel()] = edges
    sym, idx = kernels.quantize_and_index(y, means, scales, table)
    sym_ref, idx_ref = kernels._qidx_ref(y, means, scales, table, 0.11)
    torch.cuda.synchronize()
    bad_sym = int((sym != sym_ref).sum())
    bad_idx = int((idx != idx_ref).sum())
    # the largest difference over both outputs, in int64 (symbols span ±2³⁰)
    max_abs_err = float(max(
        (sym.long() - sym_ref.long()).abs().max(),
        (idx.long() - idx_ref.long()).abs().max()))
    log(f"  quantize_and_index {shape}: symbol mismatches {bad_sym}, "
        f"index mismatches {bad_idx}, max abs err {max_abs_err} "
        f"(must be 0)")
    if bad_sym or bad_idx:
        raise AssertionError("quantize_and_index disagrees with its plain "
                             "version")
    ms = cuda_ms(lambda: kernels.quantize_and_index(y, means, scales, table))
    plain_ms = cuda_ms(
        lambda: kernels._qidx_ref(y, means, scales, table, 0.11))
    levels = table.numel() - 1
    b_ms, b_by = bound(n * (3 * 4 + 4 + 1) + table.numel() * 4,
                       n * (levels + 5))
    return dict(max_abs_err=max_abs_err, ms=ms, plain_ms=plain_ms,
                library_ms=None,
                bound_ms=b_ms, bound_by=b_by, shape=list(shape))


def _gdn_params(torch, gen, c):
    """A dense non-negative γᵀ (the whole channel reduction matters) and β,
    both f32, as the kernels take them."""
    gamma = (0.02 * torch.rand((c, c), generator=gen, device="cuda")
             + 0.1 * torch.eye(c, device="cuda"))
    beta = 1.0 + torch.rand((c,), generator=gen, device="cuda")
    return gamma.t().contiguous(), beta


def _kaiming(torch, gen, shape, fan_in):
    """bf16 weights at the models' init scale (layers/conv.py)."""
    w = torch.randn(shape, generator=gen, device="cuda")
    return (w * (2.0 / fan_in) ** 0.5).to(torch.bfloat16)


def _scaled_err(torch, out, ref, name):
    """max|out − ref|, held to FUSED_TOL · max|ref|."""
    err = float((out.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    ok = bool(torch.isfinite(out).all()) and err <= FUSED_TOL * scale
    log(f"  {name} {tuple(out.shape)}: max abs {err:.4g}, max|plain| "
        f"{scale:.4g}, ratio {err / scale:.3e} (limit {FUSED_TOL:.3e}) "
        f"ok={ok}")
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version at "
                             f"{tuple(out.shape)}")
    return err


def check_gdn_bf16(torch, kernels):
    """gdn_fused's bf16 entry at g_s's first IGDN: (4, 192, 136, 240)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    c = N
    gamma_t, beta = _gdn_params(torch, gen, c)
    x = torch.randn((B, c, H // 8, W // 8), generator=gen,
                    device="cuda").to(torch.bfloat16)
    worst = 0.0
    for inverse in (False, True):
        out = kernels.gdn_fused(x, gamma_t, beta, inverse)
        ref = kernels._gdn_ref(x.float(), gamma_t, beta,
                               inverse).to(torch.bfloat16)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        ok = bool(torch.allclose(out.float(), ref.float(),
                                 rtol=GDN_BF16_RTOL, atol=GDN_ATOL))
        log(f"  gdn_fused bf16 {'inv' if inverse else 'fwd'} "
            f"{tuple(x.shape)}: max abs {err:.3e} ok={ok}")
        if not ok:
            raise AssertionError("gdn_fused bf16 disagrees with its plain "
                                 "version")
        worst = max(worst, err)
    rows = x.numel() // c
    xsq_rows = (x.float() ** 2).permute(0, 2, 3, 1).reshape(rows, c)
    xsq_rows = xsq_rows.contiguous()
    ms = cuda_ms(lambda: kernels.gdn_fused(x, gamma_t, beta, True))
    plain_ms = cuda_ms(lambda: kernels._gdn_ref(
        x.float(), gamma_t, beta, True).to(torch.bfloat16))
    lib_ms = cuda_ms(lambda: torch.addmm(beta, xsq_rows, gamma_t))
    b_ms, b_by = bound(2 * rows * c * 2 + c * c * 4 + c * 4,
                       2 * rows * c * c + 4 * rows * c)
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                shape=[rows, c])


def _norm_ops(pixels, c):
    """f32 operations of a (I)GDN over ``pixels`` pixels of c channels."""
    return 2 * pixels * c * c + 4 * pixels * c


def check_gdn_conv(torch, F, kernels):
    """gdn_conv_fused at g_a's three GDN→conv stages; the row reports the
    first (544×960 → 272×480), the log every stage."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    c = o = N
    gamma_t, beta = _gdn_params(torch, gen, c)
    weight = _kaiming(torch, gen, (o, c, 5, 5), 25 * c)
    bias = 0.1 * torch.randn((o,), generator=gen, device="cuda")
    stages, worst = [], 0.0
    for hh, ww in ((H // 2, W // 2), (H // 4, W // 4), (H // 8, W // 8)):
        x = torch.randn((B, c, hh, ww), generator=gen,
                        device="cuda").to(torch.bfloat16)
        out = kernels.gdn_conv_fused(x, gamma_t, beta, weight, bias)
        ref = kernels._gdn_conv_ref(x, gamma_t, beta, weight, bias)
        torch.cuda.synchronize()
        worst = max(worst, _scaled_err(torch, out, ref, "gdn_conv_fused"))
        del out, ref
        g = kernels._gdn_ref(x.float(), gamma_t, beta,
                             False).to(torch.bfloat16)
        bias16 = bias.to(torch.bfloat16)
        pix_in, pix_out = B * hh * ww, B * (hh // 2) * (ww // 2)
        b_ms, b_by = bound(
            pix_in * c * 2 + pix_out * o * 2 + o * c * 25 * 2 + c * c * 4
            + (c + o) * 4,
            _norm_ops(pix_in, c), 2 * pix_out * o * c * 25)
        stages.append(dict(
            shape=[B, c, hh, ww],
            ms=cuda_ms(lambda: kernels.gdn_conv_fused(x, gamma_t, beta,
                                                      weight, bias)),
            plain_ms=cuda_ms(lambda: kernels._gdn_conv_ref(
                x, gamma_t, beta, weight, bias)),
            library_ms=cuda_ms(lambda: F.conv2d(g, weight, bias16, 2, 2)),
            bound_ms=b_ms, bound_by=b_by))
        log(f"    stage {hh}×{ww}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages[-1].items()
            if k.endswith("ms")))
        del x, g
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, stages=stages, **{
        k: stages[0][k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                  "bound_by", "shape")})


def _igdn_deconv_row(torch, F, kernels, name, fn, x, f, gen):
    """One IGDN → k5 s2 deconv kernel C → f on x against its plain version,
    with its times, bound and library yardstick. Returns (row, output)."""
    c = x.shape[1]
    gamma_t, beta = _gdn_params(torch, gen, c)
    weight = _kaiming(torch, gen, (c, f, 5, 5), 25 * c)
    bias = 0.1 * torch.randn((f,), generator=gen, device="cuda")
    out = fn(x, gamma_t, beta, weight, bias)
    ref = kernels._igdn_deconv_ref(x, gamma_t, beta, weight, bias)
    torch.cuda.synchronize()
    err = _scaled_err(torch, out, ref, name)
    del ref
    g = kernels._gdn_ref(x.float(), gamma_t, beta, True).to(torch.bfloat16)
    bias16 = bias.to(torch.bfloat16)
    pix = x.numel() // c
    b_ms, b_by = bound(
        x.numel() * 2 + out.numel() * 2 + c * f * 25 * 2 + c * c * 4
        + (c + f) * 4,
        _norm_ops(pix, c), 2 * pix * c * f * 25)
    row = dict(
        max_abs_err=err, shape=list(x.shape),
        ms=cuda_ms(lambda: fn(x, gamma_t, beta, weight, bias)),
        plain_ms=cuda_ms(lambda: kernels._igdn_deconv_ref(
            x, gamma_t, beta, weight, bias)),
        library_ms=cuda_ms(lambda: F.conv_transpose2d(
            g, weight, bias16, 2, 2, 1)),
        bound_ms=b_ms, bound_by=b_by)
    log(f"    {name} {tuple(x.shape)} → {f}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in row.items() if k.endswith("ms")))
    del g
    return row, out


def check_gs_pair(torch, F, kernels):
    """igdn_deconv_wide_packed at 272×480 → 544×960 (N→N), then
    igdn_deconv_tail_packed on its output, 544×960 → 1088×1920 (N→3)."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn((B, N, H // 4, W // 4), generator=gen,
                    device="cuda").to(torch.bfloat16)
    wide, mid = _igdn_deconv_row(torch, F, kernels,
                                 "igdn_deconv_wide_packed",
                                 kernels.igdn_deconv_wide_packed, x, N, gen)
    del x
    # the tail reads the wide kernel's output, as on the path
    tail, _ = _igdn_deconv_row(torch, F, kernels, "igdn_deconv_tail_packed",
                               kernels.igdn_deconv_tail_packed, mid, 3, gen)
    del mid
    torch.cuda.empty_cache()
    return wide, tail


def check_gs_lone(torch, F, kernels):
    """The wide chain's kernels at their first and last shapes:
    igdn_deconv_wide at 136×240 → 272×480 (N→N; 240 columns leave a
    partial 32-column tile) and igdn_deconv_fused at 544×960 → 1088×1920
    (N→3)."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    x = torch.randn((B, N, H // 8, W // 8), generator=gen,
                    device="cuda").to(torch.bfloat16)
    wide, _ = _igdn_deconv_row(torch, F, kernels, "igdn_deconv_wide",
                               kernels.igdn_deconv_wide, x, N, gen)
    x = torch.randn((B, N, H // 2, W // 2), generator=gen,
                    device="cuda").to(torch.bfloat16)
    fused, _ = _igdn_deconv_row(torch, F, kernels, "igdn_deconv_fused",
                                kernels.igdn_deconv_fused, x, 3, gen)
    del x
    torch.cuda.empty_cache()
    return fused, wide


def expected_launches(bf16: bool):
    """Launches per kernel over P_FRAMES encoded and decoded frames: g_a
    runs 3 GDN stages per frame, g_s 3 IGDN stages, the STEM one quantizer;
    at bf16 g_a's stages fuse into their convs and g_s's last two into the
    packed pair, leaving its first IGDN to gdn_fused's bf16 entry."""
    want = dict.fromkeys(KERNELS, 0)
    want["quantize_and_index"] = P_FRAMES
    if bf16:
        want.update(gdn_conv_fused=3 * P_FRAMES, gdn_fused_bf16=P_FRAMES,
                    igdn_deconv_wide_packed=P_FRAMES,
                    igdn_deconv_tail_packed=P_FRAMES)
    else:
        want["gdn_fused"] = 6 * P_FRAMES
    return want


def run_slice(torch, kernels, card, bf16: bool):
    from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
        StemVideoPipeline, _Download, _shape4,
    )
    from spatiotemporalentropymodel_tpu_torch.eval.workload import (
        match_latent_to_prior, realistic_stem,
    )
    from spatiotemporalentropymodel_tpu_torch.models import (
        MeanScaleHyperprior, SpatioTemporalPriorModel,
    )

    tag = "bf16" if bf16 else "f32"
    t0 = time.perf_counter()
    imodel = MeanScaleHyperprior(N, M, device="cuda", seed=0)
    stem = SpatioTemporalPriorModel(EBC, M, device="cuda", seed=1)
    realistic_stem(stem)
    gen = torch.Generator(device="cuda").manual_seed(0)
    frames = [torch.rand((B, 3, H, W), generator=gen, device="cuda")
              for _ in range(P_FRAMES)]
    y_cond = 0.5 * torch.randn((B, M, H // 16, W // 16), generator=gen,
                               device="cuda")
    factor = match_latent_to_prior(imodel, stem, frames[0], y_cond)
    imodel.update()  # the I-frame codec's tables (the bf16_wide phase)
    if bf16:  # after the surgery and update(), as set_compute_dtype needs
        imodel.set_compute_dtype(torch.bfloat16)
        stem.set_compute_dtype(torch.bfloat16)
    pipe = StemVideoPipeline(imodel, stem, transport_mode="sparse")
    log(f"  {tag}: models + tables + surgery: {time.perf_counter() - t0:.1f}"
        f" s (g_a last conv scaled per channel by {float(factor.min()):.4g}"
        f"..{float(factor.max()):.4g})")

    # warm-up frame (cuDNN set-up), outside the counted run
    enc, _ = pipe.encode_frame(frames[0], y_cond)
    pipe.decode_frame(enc, y_cond=y_cond)
    torch.cuda.synchronize()

    # ---- the main path, counted ----
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    encs = list(pipe.encode_frames(frames, y_cond))
    decoded = list(pipe.decode_frames(encs, y_cond))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    log(f"  {tag} main path: {P_FRAMES} P-frames × {B} in {wall:.3f} s, "
        f"launches {launches}")

    # ---- checks ----
    transports = [e["transport"] for e in encs]
    if transports != ["sparse"] * P_FRAMES:
        raise AssertionError(f"{tag}: not every frame took the sparse "
                             f"transport: {transports}")
    want = expected_launches(bf16)
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")
    # the encoder's carry, recomputed frame by frame through encode_frame
    # (same device expressions as encode_frames), against the decoder's ŷ;
    # the streams must also repeat byte for byte
    y_enc = y_cond
    bpps = []
    for i, (enc, (x_hat, y_dec)) in enumerate(zip(encs, decoded)):
        enc2, y_enc = pipe.encode_frame(frames[i], y_enc)
        if enc2["strings"] != enc["strings"]:
            raise AssertionError(f"{tag} frame {i}: encode_frame and "
                                 f"encode_frames streams differ")
        if not torch.equal(y_enc, y_dec):
            diff = int((y_enc != y_dec).sum())
            raise AssertionError(f"{tag} frame {i}: encoder ŷ != decoder ŷ "
                                 f"at {diff} elements")
        if tuple(x_hat.shape) != (B, 3, H, W):
            raise AssertionError(f"{tag} frame {i}: x̂ shape "
                                 f"{tuple(x_hat.shape)}")
        if x_hat.dtype != (torch.bfloat16 if bf16 else torch.float32):
            raise AssertionError(f"{tag} frame {i}: x̂ dtype {x_hat.dtype}")
        if not bool(torch.isfinite(x_hat).all()):
            raise AssertionError(f"{tag} frame {i}: x̂ not finite")
        n_bytes = sum(len(s) for g in enc["strings"] for s in g)
        n_bytes += enc["counts"].nbytes
        bpps.append(n_bytes * 8 / (B * H * W))
    bpp = sum(bpps) / len(bpps)
    if not (all(b == b for b in bpps) and max(bpps) < 1.0):
        raise AssertionError(f"{tag}: bpp out of range: {bpps}")
    log(f"  {tag} checks: all sparse, launches exact, encoder ŷ == decoder ŷ "
        f"exactly on {P_FRAMES} frames, x̂ finite, bpp per frame {bpps}")

    # ---- stage breakdown (synchronised, median of 3) ----
    timed = partial(timed_ms, torch)
    stages = {k: [] for k in ("g_a", "enc_dispatch", "host_rans_enc",
                              "host_rans_dec", "dec_dispatch")}
    x = frames[0]
    for _ in range(3):
        ms, y_cur = timed(lambda: pipe.analysis(x))
        stages["g_a"].append(ms)
        ms, (packed, _) = timed(
            lambda: stem.fused_encode_sparse_carry_expr(y_cur, y_cond))
        ms_dl, buf = timed(lambda: _Download(packed).result())
        stages["enc_dispatch"].append(ms + ms_dl)
        ms, enc = timed(lambda: pipe.code_sparse_buffer(buf, _shape4(y_cur)))
        stages["host_rans_enc"].append(ms)
        ms, host = timed(lambda: pipe._host_decode_sparse(enc))
        stages["host_rans_dec"].append(ms)
        ms, _ = timed(lambda: pipe._device_decode_sparse(*host, y_cond))
        stages["dec_dispatch"].append(ms)
    med = {k: sorted(v)[1] for k, v in stages.items()}
    fps = P_FRAMES * B / wall
    log(f"  {tag} slice: bpp {bpp:.5f}, end-to-end {fps:.3f} frames/s "
        f"({P_FRAMES}×{B} frames of {H}×{W}, encode+decode), stage ms "
        + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
        + f" | card: {card}")
    return launches, dict(imodel=imodel, pipe=pipe, frames=frames,
                          y_cond=y_cond, encs=encs, decoded=decoded,
                          dec_dispatch_ms=med["dec_dispatch"])


def _want(**counts):
    want = dict.fromkeys(KERNELS, 0)
    want.update(counts)
    return want


def _check_launches(kernels, tag, want):
    got = dict(kernels.LAUNCHES)
    if got != want:
        raise AssertionError(f"{tag}: launches {got}, expected {want}")
    return got


def run_wide_decode(torch, kernels, card, ctx):
    """bf16_wide: the bf16 slice's P-frames decoded again under the JAX
    package's wide knobs, where g_s runs igdn_deconv_wide twice and
    igdn_deconv_fused once, held against the default decode."""
    pipe, encs, y_cond = ctx["pipe"], ctx["encs"], ctx["y_cond"]
    g_s = ctx["imodel"].module.g_s
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with kernels.knobs(**kernels.WIDE_KNOBS):
        decoded = list(pipe.decode_frames(encs, y_cond))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _check_launches(kernels, "bf16_wide", _want(
        igdn_deconv_wide=2 * P_FRAMES, igdn_deconv_fused=P_FRAMES))
    log(f"  bf16_wide decode: {P_FRAMES} P-frames × {B} in {wall:.3f} s, "
        f"launches {launches}")
    for i, ((x_w, y_w), (x_d, y_d)) in enumerate(zip(decoded,
                                                     ctx["decoded"])):
        if not torch.equal(y_w, y_d):
            raise AssertionError(f"bf16_wide frame {i}: ŷ differs from the "
                                 f"default decode's")
        if (tuple(x_w.shape) != (B, 3, H, W)
                or not bool(torch.isfinite(x_w).all())):
            raise AssertionError(f"bf16_wide frame {i}: x̂ of shape "
                                 f"{tuple(x_w.shape)} or not finite")
        mean = float((x_w.float() - x_d.float()).abs().mean())
        log(f"    frame {i}: mean|x̂_wide − x̂_default| {mean:.3e} "
            f"(limit {WIDE_X_MEAN:.0e})")
        if mean > WIDE_X_MEAN:
            raise AssertionError(f"bf16_wide frame {i}: x̂ mean difference "
                                 f"{mean} > {WIDE_X_MEAN}")
    # frame 0's ŷ through g_s under both knob sets, before the clamp
    y0 = ctx["imodel"]._cast_in(ctx["decoded"][0][1])
    with torch.no_grad():
        ref = g_s(y0).float()
        with kernels.knobs(**kernels.WIDE_KNOBS):
            out = g_s(y0).float()
    err, scale = float((out - ref).abs().max()), float(ref.abs().max())
    log(f"    g_s(ŷ₀) unclamped: max|Δ| {err:.4g}, max|default| {scale:.4g}, "
        f"ratio {err / scale:.3e} (limit {WIDE_GS_TOL:.3e})")
    if not err <= WIDE_GS_TOL * scale:
        raise AssertionError("bf16_wide: g_s outputs differ beyond the "
                             "tolerance")
    host = pipe._host_decode_sparse(encs[0])
    times = []
    with kernels.knobs(**kernels.WIDE_KNOBS):
        for _ in range(3):
            times.append(timed_ms(torch, lambda: pipe._device_decode_sparse(
                *host, y_cond))[0])
    log(f"  bf16_wide checks: launches exact, ŷ == default ŷ on {P_FRAMES} "
        f"frames, x̂ finite and close; dec_dispatch ms {sorted(times)[1]:.2f}"
        f" (wide) vs {ctx['dec_dispatch_ms']:.2f} (default) | card: {card}")
    return launches


def run_iframe(torch, kernels, card, ctx, wide: bool):
    """The I-frame codec on frames[0] in bf16: compress, decompress, under
    the default or the wide knobs."""
    tag = "iframe_bf16_wide" if wide else "iframe_bf16"
    imodel, x = ctx["imodel"], ctx["frames"][0]
    with kernels.knobs(**(kernels.WIDE_KNOBS if wide else {})):
        imodel.decompress(**imodel.compress(x))  # warm-up (cuDNN set-up)
        kernels.reset_launch_counts()
        ms_c, enc = timed_ms(torch, lambda: imodel.compress(x))
        ms_d, dec = timed_ms(torch, lambda: imodel.decompress(**enc))
        gs = (dict(igdn_deconv_wide=2, igdn_deconv_fused=1) if wide else
              dict(gdn_fused_bf16=1, igdn_deconv_wide_packed=1,
                   igdn_deconv_tail_packed=1))
        launches = _check_launches(kernels, tag, _want(
            gdn_conv_fused=3, quantize_and_index=1, **gs))
        _, y_enc = imodel.fused_encode_expr(x)
        if imodel.compress(x)["strings"] != enc["strings"]:
            raise AssertionError(f"{tag}: streams differ between two "
                                 f"compress calls")
    if not torch.equal(y_enc, dec["y_hat"]):
        diff = int((y_enc != dec["y_hat"]).sum())
        raise AssertionError(f"{tag}: encoder ŷ != decoder ŷ at {diff} "
                             f"elements")
    x_hat = dec["x_hat"]
    if (tuple(x_hat.shape) != (B, 3, H, W) or x_hat.dtype != torch.bfloat16
            or not bool(torch.isfinite(x_hat).all())):
        raise AssertionError(f"{tag}: x̂ {tuple(x_hat.shape)} "
                             f"{x_hat.dtype}, or not finite")
    bpp = sum(len(s) for g in enc["strings"] for s in g) * 8 / (B * H * W)
    if bpp != bpp or bpp <= 0:
        raise AssertionError(f"{tag}: bpp {bpp}")
    log(f"  {tag}: compress {ms_c:.2f} ms, decompress {ms_d:.2f} ms "
        f"({B}×3×{H}×{W}), bpp {bpp:.5f}, encoder ŷ == decoder ŷ, streams "
        f"repeat, launches {launches} | card: {card}")
    return launches


def main() -> int:
    try:
        import torch
    except ImportError as e:
        log(f"FAIL: torch not importable: {e}")
        return 2
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; this check needs a "
            "CUDA card")
        return 2

    # ---- 1. device ----
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.deterministic = True
    log(f"[1/5] device: {torch.cuda.get_device_name(0)} × "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    # ---- 2. build ----
    from spatiotemporalentropymodel_tpu_torch.coders import build as rans_build
    from spatiotemporalentropymodel_tpu_torch.coders import rans
    from spatiotemporalentropymodel_tpu_torch.ops import build as cu_build
    from spatiotemporalentropymodel_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        futs = [pool.submit(cu_build.build), pool.submit(rans_build.build)]
        paths = [f.result() for f in futs]
    kernels.load()
    rans.load()
    log(f"[2/5] build: {time.perf_counter() - t0:.1f} s "
        f"({', '.join(p.name for p in paths)})")

    # ---- 3. kernels vs plain ----
    import torch.nn.functional as F
    from spatiotemporalentropymodel_tpu_torch.entropy import get_scale_table

    log("[3/5] kernels vs plain versions on the card")
    table = kernels.scale_table_tensor(get_scale_table(), "cuda")
    results = {"gdn_fused": check_gdn(torch, kernels)}
    results["quantize_and_index"] = check_qidx(torch, kernels, table)
    results["gdn_fused_bf16"] = check_gdn_bf16(torch, kernels)
    results["gdn_conv_fused"] = check_gdn_conv(torch, F, kernels)
    wide, tail = check_gs_pair(torch, F, kernels)
    results["igdn_deconv_wide_packed"] = wide
    results["igdn_deconv_tail_packed"] = tail
    fused, wide = check_gs_lone(torch, F, kernels)
    results["igdn_deconv_fused"] = fused
    results["igdn_deconv_wide"] = wide
    for name, res in results.items():
        lib = res["library_ms"]
        log(f"  {name}: {res['ms']:.3f} ms (plain {res['plain_ms']:.3f}, "
            f"library {'none' if lib is None else f'{lib:.3f}'}, bound "
            f"{res['bound_ms']:.3f} by {res['bound_by']}), max abs err "
            f"{res['max_abs_err']:.4g}")
    log(f"  launches so far {dict(kernels.LAUNCHES)} (comparisons, not "
        f"counted below)")

    # ---- 4. the slices ----
    by_path = {}
    for bf16 in (False, True):
        tag = "bf16" if bf16 else "f32"
        log(f"[4/5] slice: StemVideoPipeline(sparse), {tag}, "
            f"{P_FRAMES} P-frames of {B}×3×{H}×{W}")
        by_path[tag], ctx = run_slice(torch, kernels, card, bf16)
        if not bf16:
            del ctx
        torch.cuda.empty_cache()
    log(f"[4/5] slice: the bf16 models under the wide knobs "
        f"{kernels.WIDE_KNOBS}: P-frame decode, then the I-frame codec")
    by_path["bf16_wide"] = run_wide_decode(torch, kernels, card, ctx)
    for wide in (False, True):
        tag = "iframe_bf16_wide" if wide else "iframe_bf16"
        by_path[tag] = run_iframe(torch, kernels, card, ctx, wide)
    if (kernels.FUSE_GS_PACKED, kernels.FUSE_IGDN_DECONV_WIDE) != (True,
                                                                   False):
        raise AssertionError("the default knobs were not restored")
    del ctx
    torch.cuda.empty_cache()

    # ---- 5. report ----
    replaces = {
        "gdn_fused": (f"{PK}:150", "kernels.cu"),
        "gdn_fused_bf16": (f"{PK}:150", "kernels.cu"),
        "quantize_and_index": (f"{PK}:214", "kernels.cu"),
        "gdn_conv_fused": (f"{PK}:945", "gdn_conv.cu"),
        "igdn_deconv_wide_packed": (f"{PK}:1389", "igdn_deconv.cu"),
        "igdn_deconv_tail_packed": (f"{PK}:1561", "igdn_deconv.cu"),
        "igdn_deconv_fused": (f"{PK}:387", "igdn_deconv.cu"),
        "igdn_deconv_wide": (f"{PK}:1267", "igdn_deconv.cu"),
    }
    rows = []
    for name, res in results.items():
        line, src = replaces[name]
        per_path = {tag: counts[name] for tag, counts in by_path.items()}
        rows.append({
            "name": name, "route": "cuda", "source": f"{CSRC}/{src}",
            "replaces": line, "launches": sum(per_path.values()),
            "launches_by_path": per_path,
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"],
            "shape": res["shape"],
            **({"stages": res["stages"]} if "stages" in res else {}),
        })
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
