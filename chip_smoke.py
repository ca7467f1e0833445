#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port's serving paths: the P-frame path
in f32 and bf16, the bf16 g_s chain under the JAX package's wide knobs, the
I-frame codec, the flagship STEM res through WavefrontVideoPipeline, the
trained hero models (artifacts/trained/hero) read with jax blocked, the
file codecs (.stemv video, .bin images) with their CLIs, training
(train_image, train_stem), and the autoregressive image models (mbt2018,
Cheng2020) with their files and CompressAI checkpoints.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and g++; imports no JAX, and blocks it. Phases:

  1. device   — fail without CUDA; print the card's name and power limit; pin
                f32 numerics (no TF32) and deterministic cuDNN, so encoder
                and decoder compute bit-identical (σ, μ) from ẑ.
  2. build    — the CUDA kernels (nvcc, one process per source) and the rANS
                coder (g++), in parallel, from the checkout's sources.
  3. kernels  — each kernel against its plain PyTorch version on the card at
                the serving paths' shapes, timed with CUDA events beside its
                bound, its plain version and the nearest library call:
                gdn_fused f32 (rtol 1e-5, atol 1e-6) and bf16 (rtol 2⁻⁷: one
                bf16 step), each with a bound that holds for any split of
                its norm between the CUDA cores and the tensor cores
                (gdn_bound);
                quantize_and_index, f32 and bf16 entries, exact, with
                crafted ties, saturation and table-edge scales, (σ, μ) the
                halves of one tensor, and at an odd, misaligned shape
                (timed through the wrapper and alone, with torch.bucketize
                as the index half's yardstick); gdn_conv_fused at g_a's
                three stages, igdn_deconv_wide_packed at 272×480,
                igdn_deconv_tail_packed at 544×960, igdn_deconv_wide at
                136×240 and igdn_deconv_fused at 544×960, each at
                max|kernel − plain| ≤ 2⁻⁶·max|plain| (the kernels round the
                (I)GDN'd window to bf16 for the tensor cores; the plain g_s
                versions keep it f32, as the JAX refs do). The fused rows'
                bound holds for any split of the norm between the CUDA
                cores and the tensor cores (fused_bound); gdn_conv_fused
                and the g_s rows also time the unfused pair of library
                calls (pair_ms: the norm's torch.addmm, then the bf16 conv).
                Then the hero I-model's widths (N = 128, M = 192, B = 1),
                rows of their own: gdn_conv_fused 128→128 at 544×960 and
                272×480 and 128→192 at 136×240, gdn_fused_bf16 at 128,
                igdn_deconv_wide_packed at 128 and igdn_deconv_tail_packed
                at 128→3; and gdn_conv_fused 192→320 at 1×192×136×240
                (mbt2018's last g_a stage at quality 5-8), its own row.
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
                repeat. Then res_wavefront_bf16, the JAX bench's wavefront
                server (bench.py:648-689) at S = 4 streams as in its
                res_pipelined_4stream_measured section (bench.py:853,
                1803-1805): STEM res (EB 256, bf16) with wavefront tile
                (1, 4) and MeanScaleHyperprior(192, 192) serve 3 P-frames
                of 4×3×1088×1920 with serve_latent, y_cur = y_cond + 0.2·ε
                with g_a run on the pixel frame
                (eval/workload.py::wavefront_y_cur). The I-model runs in
                bf16 here, where the JAX bench keeps it f32: bf16 is the
                package's serving dtype, and only the bf16 g_a and g_s
                reach the ported kernels. Per frame the encoder's
                reconstruction + y_cond must equal the decoder's ŷ bit for
                bit, the stream must decode (with the encoder's indexes) to
                the encoder's symbols, a second encode must repeat the
                streams, x̂ must be finite bf16 of the frames' shape and bpp
                in (0.15, 0.30). With it the serial AR codec runs on a small
                f32 res model (M = 32) at a 4×8 latent: its symbols decode
                and its ŷ is the untiled wavefront's within 1e-4.
                batch_invariance: each of the 4 streams of frame 1, coded
                alone, gives the batched streams byte for byte and the
                batched ŷ bit for bit.
                The hero models (eval/workload.py::load_hero: I, res and
                without_spm from their checkpoints, no jax):
                hero_eval runs eval_dataset on the hero GOP eval set
                (2 × 24 frames of 256², GOP 12) in f32 with the model API,
                as tools/bakeoff.py::_eval_cfg did, each variant's bpp
                within 5 % and PSNR within 0.3 dB of hero.json, then prints
                MS-SSIM of one decoded I-frame; hero_serving_1080p codes
                the serving probe's 4 frames of 1088×1920 (an I-frame, 3
                P-frames) through StemVideoPipeline(sparse) with
                without_spm, B = 1, in f32 (held to hero.json's
                serving_1080p with the same band) and bf16 (held to the
                port's f32 with it), encoder ŷ == decoder ŷ on every frame;
                gop_forward runs the same P-frames through
                StemVideoPipeline.gop_forward in f32 and bf16, each frame's
                bpp_est equal to estimate_bpp of stem.forward on the same
                latents (rtol 1e-5); then the hero res serves them through
                WavefrontVideoPipeline, tile (1, 4), bf16, held by
                exactness only.
                file_codecs: the .stemv files of the hero models on the
                serving probe's frames cut to 1080×1920 (rows 4-1083; the
                codec pads them to 1088), GOP 4, through encode_video and
                decode_video(output_dir): without_spm (family 0) in f32,
                then bf16, every P record sparse, the header's hashes the
                models' params_hash, the PNGs (read by data/png.py) the
                decoded frames as decode_video converts them, the frames
                and streams the in-memory chain's and the file's size its
                records' to the byte; the same in f32 on the probe's
                own 1088-row frames, whose P-frames' bpp and PSNR must
                fall in the band of hero.json's 1080p serving figures
                (the 1080-row files' padding rows cost bits, so they are
                held by exactness only); the hero res at tile (1, 4) in
                bf16 (family 1), its tile in the header and its frames the
                model-API chain's; data/png.py's writer and reader on a
                1080p frame, and its reader on one whose rows all use the
                Paeth filter, each read exact and timed; then both CLIs
                through main(argv): video_codec
                with the hero I checkpoint and a seeded STEM (its decode
                decode_video's), codec with the hero I checkpoint and
                bmshj2018-factorized/-hyperprior at quality 1 (strings
                compress's, the PNG decompress's).
                training: one make_image_train_step of MSH(64, 64) at
                2×64×64 on the card and on the CPU from the same weights
                with the same fed noise (x + 0.45·sin(7x + k) in place of
                the draws), TF32 off: loss within 1e-4 relative, each
                gradient leaf within 1e-4 of its max|g|, each parameter
                within 1e-6 where the two gradients pin Adam's first step
                (else 2·lr, counted). train_image with TrainImageConfig's
                defaults (mbt2018-mean q4 = MSH(128, 192), 16×256²
                synthetic batches), 3 steps: finite metrics, every main
                parameter moved, the aux step moved quantiles only, 6
                gdn_fused launches (C = 128) per forward, the checkpoint
                read back through load_checkpoint + load_jax_leaves to the
                trained parameters; then that step's gradients with
                gdn_fused's kernel against its plain version: each leaf's
                max|Δg| within 2× that of the plain runs with every (I)GDN
                output moved by 1e-5 relative (the f32 row's rtol), with
                random signs or all up: the network's own amplification,
                measured in the same call. train_stem
                with TrainStemConfig's defaults (res, M 192, EB 256, 4 ×
                7 × 256²) and the hero I checkpoint: one batch per_frame
                (a step per P-frame), 2 per_sequence, each with its
                validation and checkpoint, then resume for a 3rd: finite
                metrics, the carry handed back detached, 3 gdn_fused
                launches per get_y call. Each trainer's ms per step and
                steps/s (synchronised, the first step apart) and its peak
                memory; gdn_fused's forward kernel, plain forward and
                backward (_KernelFn: the plain version recomputed and
                differentiated) at g_a's first GDN, 16×128×128×128, beside
                the forward's bound.
                image_ar: from seeds on the probe's first 1088×1920 frame,
                the wavefront codec's compress then decompress (321
                rounds) of mbt2018 at quality 5 (N 192, M 320) and of
                Cheng2020-attn at quality 6, each in bf16 then f32:
                encoder ŷ == decoder ŷ bit for bit, a second compress
                repeats the strings, x̂ finite, bpp finite, compress and
                decompress ms; a bf16 mbt2018 round trip launches
                gdn_conv_fused twice at 192→192 and once at 192→320,
                gdn_fused_bf16 once and the packed g_s pair once, a
                Cheng2020 one gdn_fused 3 + 3 times. batch_invariance_ar:
                mbt2018 at quality 4, bf16, the two first frames batched,
                each coded alone giving the batched strings and ŷ. The
                serial mbt2018 (8, 12) at a 4×8 latent against its
                wavefront ŷ within 1e-4. Then the .bin CLI through
                main(argv) with cheng2020-anchor at quality 3 on a 256²
                PNG, a .stemv (family 0, GOP 4) with a seeded mbt2018 at
                quality 4 as the I-model and the hero without_spm STEM,
                and load_torch_checkpoint of a CompressAI-keyed file
                written from a seeded mbt2018 at quality 5 (the same
                parameters and strings).
                On every path each kernel must have launched exactly as
                often as the path calls it, and on the hero and image_ar
                paths at the widths it runs at.
  5. report   — one JSON line of kernels (a row per kernel, its launches
                summed and by every path that launched it; then a row per
                kernel at the hero widths and at 192→320, name@widths, its
                launches at them), then the card, then the result line.

Exits non-zero, printing no result line, on any failure.
"""

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from functools import partial

import numpy as np

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
RES_TILE = (1, 4)  # the JAX bench's wavefront tile (bench.py:692)
RES_BPP = (0.15, 0.30)  # the JAX package codes this workload at ≈ 0.223
SERIAL_M, SERIAL_HW = 32, (4, 8)
SERIAL_ATOL = 1e-4  # serial vs wavefront ŷ (JAX tests/test_stem.py:123-125)
HERO_N = 128  # the hero I-model's N (artifacts/trained/hero/hero.json)
# hero_eval and hero_serving_1080p against hero.json: bpp within 5 %, PSNR
# within 0.3 dB (the JAX figures came from another device's arithmetic; the
# CPU tests hold the port to the JAX package tightly)
HERO_BPP_REL, HERO_PSNR_DB = 0.05, 0.3
GOP_RTOL = 1e-5  # gop_forward's bpp_est vs estimate_bpp of stem.forward
KERNELS = ("gdn_fused", "gdn_fused_bf16", "quantize_and_index",
           "quantize_and_index_bf16", "gdn_conv_fused",
           "igdn_deconv_wide_packed", "igdn_deconv_tail_packed",
           "igdn_deconv_fused", "igdn_deconv_wide")
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


def _norm_ops(pixels, c):
    """f32 operations of a (I)GDN over ``pixels`` pixels of c channels."""
    return 2 * pixels * c * c + 4 * pixels * c


def bound(bytes_moved: float, ops: float):
    """Least ms for the work: bytes over the memory rate, or f32 operations
    over the CUDA cores' peak, whichever is larger."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gdn_bound(bytes_moved: float, pixels: int, c: int, products: int):
    """Least ms for a standalone (I)GDN on any design. Its norm, 2·pixels·C²
    products, can run in f32 on the CUDA cores (a = its f32 operations /
    67 TFLOP/s) or as `products` bf16 products on the tensor cores (b =
    products · 2·pixels·C² / 989 TFLOP/s: 6 keep an f32 x² and γ, 3 a bf16
    x²), and a design may split it between the two: the operations take
    a·b/(a + b), both units finishing together. The bound is the larger of
    that and the bytes over the memory rate."""
    a = _norm_ops(pixels, c) / F32_FLOPS_PER_S
    b = products * 2 * pixels * c * c / BF16_TC_FLOPS_PER_S
    t_ops = a * b / (a + b) * 1e3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_bound(bytes_moved: float, norm_pixels: int, c: int,
                conv_ops: float):
    """Least ms for a fused (I)GDN + conv on any design. The conv runs on the
    bf16 tensor cores (c = conv_ops / 989 TFLOP/s); the norm, 2·pixels·C²
    products, can run in f32 on the CUDA cores (a = its f32 operations /
    67 TFLOP/s) or as three bf16 products on the tensor cores (b = 3 ·
    2·pixels·C² / 989 TFLOP/s), and a design may split it between the two.
    The operations take c where a ≤ c (the CUDA cores keep up); otherwise
    a·(b + c)/(a + b), the norm shared so that both units finish together.
    The bound is the larger of that and the bytes over the memory rate."""
    a = _norm_ops(norm_pixels, c) / F32_FLOPS_PER_S
    b = 3 * 2 * norm_pixels * c * c / BF16_TC_FLOPS_PER_S
    cc = conv_ops / BF16_TC_FLOPS_PER_S
    t_ops = (cc if a <= cc else a * (b + cc) / (a + b)) * 1e3
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _norm_rows(torch, x):
    """x² of NCHW x as (pixels, C) f32 rows: the operand of the norm's
    library product (torch.addmm)."""
    c = x.shape[1]
    return (x.float() ** 2).permute(0, 2, 3, 1).reshape(-1, c).contiguous()


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
            xsq_rows = _norm_rows(torch, x)
            ms = cuda_ms(lambda: kernels.gdn_fused(x, gamma_t, beta, False))
            plain_ms = cuda_ms(
                lambda: kernels._gdn_ref(x, gamma_t, beta, False))
            # the nearest single library call: the norm's product alone
            lib_ms = cuda_ms(lambda: torch.addmm(beta, xsq_rows, gamma_t))
            b_ms, b_by = gdn_bound(2 * rows * c * 4 + c * c * 4 + c * 4,
                                   rows, c, 6)
            timing = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                          bound_ms=b_ms, bound_by=b_by,
                          shape=[rows, c])
            del xsq_rows
        del x
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst_abs, max_rel_err=worst_rel, **timing)


def _qidx_crafted(torch, table, shape, dtype, gen):
    """(y, μ, σ) in ``dtype`` on the card: random, then y − μ on ±k.5 ties
    and beyond ±2³⁰, and σ on every table entry and the bound 0.11, each
    rounded to dtype and one step of dtype either side of it, and on 0,
    −1 and 0.05."""
    means = 2.0 * torch.randn(shape, generator=gen, device="cuda")
    y = means + 3.0 * torch.randn(shape, generator=gen, device="cuda")
    scales = torch.exp(4.0 * torch.rand(shape, generator=gen, device="cuda")
                       - 3.0)
    y, means, scales = (t.to(dtype) for t in (y, means, scales))
    yf, mf, sf = y.view(-1), means.view(-1), scales.view(-1)
    special = torch.cat([
        torch.arange(-40, 41, device="cuda") + 0.5,
        torch.tensor([3e9, -3e9, 2.0**30 + 128, -(2.0**30) - 128, 1e38],
                     device="cuda")]).to(dtype)
    mf[:special.numel()], yf[:special.numel()] = 0.0, special
    t = torch.cat([table, torch.tensor([0.11], device="cuda")]).to(dtype)
    if dtype == torch.bfloat16:  # positive: ±1 in the bits is ±1 step
        lo = (t.view(torch.int16) - 1).view(dtype)
        hi = (t.view(torch.int16) + 1).view(dtype)
    else:
        lo = torch.nextafter(t, torch.full_like(t, -1.0))
        hi = torch.nextafter(t, torch.full_like(t, 1e9))
    edges = torch.cat([t, lo, hi, torch.tensor([0.0, -1.0, 0.05],
                                               device="cuda").to(dtype)])
    sf[:edges.numel()] = edges
    return y, means, scales


def _qidx_exact(torch, kernels, table, y, means, scales, label):
    """Both outputs against the plain version; the largest difference."""
    sym, idx = kernels.quantize_and_index(y, means, scales, table)
    sym_ref, idx_ref = kernels._qidx_plain(y, means, scales, table, 0.11)
    torch.cuda.synchronize()
    bad_sym = int((sym != sym_ref).sum())
    bad_idx = int((idx != idx_ref).sum())
    # the largest difference over both outputs, in int64 (symbols span ±2³⁰)
    err = float(max((sym.long() - sym_ref.long()).abs().max(),
                    (idx.long() - idx_ref.long()).abs().max()))
    log(f"  {label}: symbol mismatches {bad_sym}, index mismatches "
        f"{bad_idx}, max abs err {err} (must be 0)")
    if bad_sym or bad_idx:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def _entry_ms(torch, kernels, entry, args, launches=20):
    """ms per launch of a C entry called directly, without its wrapper: the
    kernel alone."""
    fn = getattr(kernels._lib(), entry)
    stream = torch.cuda.current_stream().cuda_stream
    for _ in range(3):
        fn(*args, stream)
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(launches):
            rc = fn(*args, stream)
            if rc != 0:
                raise AssertionError(f"{entry}: launch failed with error "
                                     f"{rc}")
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return sorted(times)[2]


def check_qidx(torch, kernels, table, dtype):
    """One entry of quantize_and_index at the y plane's shape, exact, with
    crafted ties, saturation and table-edge scales, (σ, μ) the two halves
    of one (B, 2M, H/16, W/16) tensor as EPM and h_s hand them over; then
    at an odd shape whose inputs start off 16-byte alignment. Times the
    wrapper, the kernel alone, the plain version and torch.bucketize of the
    clamped f32 σ (the index half only)."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    name, entry = kernels._QIDX_ENTRIES[dtype]
    b, h, w = B, H // 16, W // 16
    shape = (b, M, h, w)
    n = b * M * h * w
    y, means, scales = _qidx_crafted(torch, table, shape, dtype, gen)
    both = torch.cat([scales, means], dim=1)
    scales, means = both.chunk(2, dim=1)
    err = _qidx_exact(torch, kernels, table, y, means, scales,
                      f"{name} {shape}, (σ, μ) halves of {tuple(both.shape)}")
    # odd sizes, each input 1, 2, 3 elements past a 16-byte boundary
    odd = (3, 37, 17, 29)
    views = []
    for k, t in zip((1, 2, 3),
                    _qidx_crafted(torch, table, odd, dtype, gen)):
        flat = torch.empty(t.numel() + k, dtype=dtype, device="cuda")
        flat[k:] = t.reshape(-1)
        views.append(flat[k:].view(odd))
    err = max(err, _qidx_exact(torch, kernels, table, *views,
                               f"{name} {odd}, misaligned by 1, 2, 3"))
    del views

    ms = cuda_ms(lambda: kernels.quantize_and_index(y, means, scales, table))
    sym = torch.empty(shape, dtype=torch.int32, device="cuda")
    idx = torch.empty(shape, dtype=torch.uint8, device="cuda")
    per = n // b
    alone_ms = _entry_ms(torch, kernels, entry, (
        y.data_ptr(), means.data_ptr(), scales.data_ptr(), b, per, per,
        2 * per, 2 * per, table.data_ptr(), table.numel() - 1, 0.11,
        sym.data_ptr(), idx.data_ptr()))
    plain_ms = cuda_ms(
        lambda: kernels._qidx_plain(y, means, scales, table, 0.11))
    s32 = torch.clamp_min(scales.float(), 0.11).contiguous()
    edges = table[:-1].contiguous()
    lib_ms = cuda_ms(lambda: torch.bucketize(s32, edges))
    steps = (table.numel() - 1).bit_length()  # the search's steps
    in_bytes = 3 * y.element_size()  # 12 B in f32, 6 B in bf16
    b_ms, b_by = bound(n * (in_bytes + 4 + 1) + table.numel() * 4,
                       n * (2 * steps + 5))
    log(f"  {name}: wrapper {ms:.4f} ms, alone {alone_ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bucketize (index half only) {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms by {b_by} ({in_bytes + 5} B per element)")
    return dict(max_abs_err=err, ms=ms, alone_ms=alone_ms, plain_ms=plain_ms,
                library_ms=lib_ms, library="torch.bucketize, index half only",
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


def check_gdn_entry(torch, kernels, b=B, c=N, size=(H // 8, W // 8),
                    dtype=None, timed_inverse=True, seed=13):
    """gdn_fused's bf16 entry (or ``dtype``'s) on (b, c, *size), by default
    at g_s's first IGDN, forward and inverse against the plain version
    (bf16: rtol 2⁻⁷; f32: rtol 1e-5, atol 1e-6), the inverse (or the
    forward) timed beside its bound and torch.addmm (the norm's
    product)."""
    dtype = dtype or torch.bfloat16
    bf16 = dtype == torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gamma_t, beta = _gdn_params(torch, gen, c)
    x = torch.randn((b, c, *size), generator=gen, device="cuda").to(dtype)
    worst = 0.0
    for inverse in (False, True):
        out = kernels.gdn_fused(x, gamma_t, beta, inverse)
        ref = kernels._gdn_ref(x.float(), gamma_t, beta, inverse).to(dtype)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        ok = bool(torch.allclose(out.float(), ref.float(),
                                 rtol=GDN_BF16_RTOL if bf16 else GDN_RTOL,
                                 atol=GDN_ATOL))
        log(f"  gdn_fused {'bf16' if bf16 else 'f32'} "
            f"{'inv' if inverse else 'fwd'} {tuple(x.shape)}: max abs "
            f"{err:.3e} ok={ok}")
        if not ok:
            raise AssertionError(f"gdn_fused disagrees with its plain "
                                 f"version at {tuple(x.shape)} {dtype}")
        worst = max(worst, err)
    rows = x.numel() // c
    xsq_rows = _norm_rows(torch, x)
    ms = cuda_ms(lambda: kernels.gdn_fused(x, gamma_t, beta, timed_inverse))
    plain_ms = cuda_ms(lambda: kernels._gdn_ref(
        x.float(), gamma_t, beta, timed_inverse).to(dtype))
    lib_ms = cuda_ms(lambda: torch.addmm(beta, xsq_rows, gamma_t))
    size = x.element_size()
    b_ms, b_by = gdn_bound(2 * rows * c * size + c * c * 4 + c * 4, rows, c,
                           3 if bf16 else 6)
    del x, xsq_rows
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                shape=[rows, c])


def check_gdn_conv(torch, F, kernels, b=B, c=N, o=N,
                   sizes=((H // 2, W // 2), (H // 4, W // 4),
                          (H // 8, W // 8))):
    """gdn_conv_fused C → O at g_a's GDN→conv stages of the given input
    sizes (by default all three of the 192-wide model); the row reports
    the first, the log every stage."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    gamma_t, beta = _gdn_params(torch, gen, c)
    weight = _kaiming(torch, gen, (o, c, 5, 5), 25 * c)
    bias = 0.1 * torch.randn((o,), generator=gen, device="cuda")
    stages, worst = [], 0.0
    for hh, ww in sizes:
        x = torch.randn((b, c, hh, ww), generator=gen,
                        device="cuda").to(torch.bfloat16)
        out = kernels.gdn_conv_fused(x, gamma_t, beta, weight, bias)
        ref = kernels._gdn_conv_ref(x, gamma_t, beta, weight, bias)
        torch.cuda.synchronize()
        worst = max(worst, _scaled_err(torch, out, ref, "gdn_conv_fused"))
        del out, ref
        g = kernels._gdn_ref(x.float(), gamma_t, beta,
                             False).to(torch.bfloat16)
        bias16 = bias.to(torch.bfloat16)
        xsq = _norm_rows(torch, x)
        pix_in, pix_out = b * hh * ww, b * (hh // 2) * (ww // 2)
        b_ms, b_by = fused_bound(
            pix_in * c * 2 + pix_out * o * 2 + o * c * 25 * 2 + c * c * 4
            + (c + o) * 4,
            pix_in, c, 2 * pix_out * o * c * 25)
        stages.append(dict(
            shape=[b, c, hh, ww],
            ms=cuda_ms(lambda: kernels.gdn_conv_fused(x, gamma_t, beta,
                                                      weight, bias)),
            plain_ms=cuda_ms(lambda: kernels._gdn_conv_ref(
                x, gamma_t, beta, weight, bias)),
            library_ms=cuda_ms(lambda: F.conv2d(g, weight, bias16, 2, 2)),
            # the unfused pair: the norm's product, then the conv
            pair_ms=cuda_ms(lambda: (torch.addmm(beta, xsq, gamma_t),
                                     F.conv2d(g, weight, bias16, 2, 2))),
            bound_ms=b_ms, bound_by=b_by))
        log(f"    stage {c}→{o} {hh}×{ww}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in stages[-1].items()
            if k.endswith("ms")))
        del x, g, xsq
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst, stages=stages, **{
        k: stages[0][k] for k in ("ms", "plain_ms", "library_ms", "pair_ms",
                                  "bound_ms", "bound_by", "shape")})


def _igdn_deconv_row(torch, F, kernels, name, fn, x, f, gen):
    """One IGDN → k5 s2 deconv kernel C → f on x against its plain version,
    with its times, bound, library yardstick and the unfused pair of
    library calls. Returns (row, output)."""
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
    b_ms, b_by = fused_bound(
        x.numel() * 2 + out.numel() * 2 + c * f * 25 * 2 + c * c * 4
        + (c + f) * 4,
        pix, c, 2 * pix * c * f * 25)
    row = dict(
        max_abs_err=err, shape=list(x.shape),
        ms=cuda_ms(lambda: fn(x, gamma_t, beta, weight, bias)),
        plain_ms=cuda_ms(lambda: kernels._igdn_deconv_ref(
            x, gamma_t, beta, weight, bias)),
        library_ms=cuda_ms(lambda: F.conv_transpose2d(
            g, weight, bias16, 2, 2, 1)),
        bound_ms=b_ms, bound_by=b_by)
    xsq = _norm_rows(torch, x)  # the unfused pair: the norm, then the deconv
    row["pair_ms"] = cuda_ms(lambda: (
        torch.addmm(beta, xsq, gamma_t),
        F.conv_transpose2d(g, weight, bias16, 2, 2, 1)))
    del xsq
    log(f"    {name} {tuple(x.shape)} → {f}: " + ", ".join(
        f"{k} {v:.3f}" for k, v in row.items()
        if k.endswith("ms") and v is not None))
    del g
    return row, out


def check_gs_pair(torch, F, kernels, b=B, c=N):
    """igdn_deconv_wide_packed at 272×480 → 544×960 (C→C), then
    igdn_deconv_tail_packed on its output, 544×960 → 1088×1920 (C→3)."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    x = torch.randn((b, c, H // 4, W // 4), generator=gen,
                    device="cuda").to(torch.bfloat16)
    wide, mid = _igdn_deconv_row(torch, F, kernels,
                                 "igdn_deconv_wide_packed",
                                 kernels.igdn_deconv_wide_packed, x, c, gen)
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
    packed pair, leaving its first IGDN to gdn_fused's bf16 entry, and the
    quantizer reads the bf16 nets' outputs through its bf16 entry."""
    want = dict.fromkeys(KERNELS, 0)
    if bf16:
        want.update(gdn_conv_fused=3 * P_FRAMES, gdn_fused_bf16=P_FRAMES,
                    quantize_and_index_bf16=P_FRAMES,
                    igdn_deconv_wide_packed=P_FRAMES,
                    igdn_deconv_tail_packed=P_FRAMES)
    else:
        want.update(gdn_fused=6 * P_FRAMES, quantize_and_index=P_FRAMES)
    return want


def run_slice(torch, kernels, card, bf16: bool):
    from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
        StemVideoPipeline,
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
    stem = SpatioTemporalPriorModel(variant="without_spm",
                                    entropy_bottleneck_channels=EBC,
                                    in_channels=M, device="cuda", seed=1)
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

    med = parallel_stages(torch, pipe, frames[0], y_cond)
    fps = P_FRAMES * B / wall
    log(f"  {tag} slice: bpp {bpp:.5f}, end-to-end {fps:.3f} frames/s "
        f"({P_FRAMES}×{B} frames of {H}×{W}, encode+decode), stage ms "
        + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
        + f" | card: {card}")
    return launches, dict(imodel=imodel, pipe=pipe, frames=frames,
                          y_cond=y_cond, encs=encs, decoded=decoded,
                          dec_dispatch_ms=med["dec_dispatch"])


def parallel_stages(torch, pipe, x, y_cond):
    """StemVideoPipeline's stages on frame x, each between two
    synchronisations, ms, median of 3."""
    from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
        _Download, _shape4,
    )

    timed = partial(timed_ms, torch)
    stem = pipe.stem
    stages = {k: [] for k in ("g_a", "enc_dispatch", "host_rans_enc",
                              "host_rans_dec", "dec_dispatch")}
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
    return {k: sorted(v)[1] for k, v in stages.items()}


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
            gdn_conv_fused=3, quantize_and_index_bf16=1, **gs))
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


def _encoder_pass(torch, stem, enc, y_cur, y_cond):
    """The model's encoder over the priors of the decoder's ẑ, as JAX
    tests/test_stem.py:141-166 runs it: (its reconstruction + y_cond NCHW,
    its symbols and CDF-row indexes per stream in wire order)."""
    from spatiotemporalentropymodel_tpu_torch.models import ar_wavefront as wf
    from spatiotemporalentropymodel_tpu_torch.models.base import _nchw

    b, m, h, w = y_cur.shape
    th, tw, nt, serial = stem._ar_dims(h, w)
    with torch.no_grad():
        z_hat = stem._upload(stem._eb_decompress(enc["strings"][1],
                                                 enc["shape"]))
        priors = stem._tiled_priors(z_hat, y_cond, th, tw, nt)
        target = (y_cur - y_cond).permute(0, 2, 3, 1)
        if nt > 1:
            target = wf.tile_plane(target, th, tw)
        coords, valid, rounds, encoder, *_ = stem._wavefront_setup(
            th, tw, serial)
        syms, idxs, recon = encoder(target, priors, rounds, b)
        flat = [wf.flatten_wavefront_grouped(p, coords, valid, b).cpu()
                .numpy() for p in (syms, idxs)]
        if nt > 1:
            recon = wf.untile_plane(recon, b, h, w)
        return _nchw(recon.permute(0, 3, 1, 2)) + y_cond, flat[0], flat[1]


def _check_ar_frame(torch, stem, tag, enc, y_cur, y_cond, y_dec):
    """Encoder reconstruction == decoder ŷ bit for bit, and every stream
    decodes, with the encoder's indexes, to the encoder's symbols."""
    y_enc, sym, idx = _encoder_pass(torch, stem, enc, y_cur, y_cond)
    if not torch.equal(y_enc, y_dec):
        diff = int((y_enc != y_dec).sum())
        raise AssertionError(f"{tag}: encoder ŷ != decoder ŷ at {diff} "
                             f"elements")
    t = stem.tables["gaussian_conditional"]
    for i, s in enumerate(enc["strings"][0]):
        got = stem.coder.make_stream_decoder(s).decode(
            idx[i], t.cdf, t.cdf_length, t.offset)
        if not (got == sym[i]).all():
            raise AssertionError(f"{tag} stream {i}: decoded symbols differ "
                                 f"from the encoder's at "
                                 f"{int((got != sym[i]).sum())} of {got.size}")


def run_res_wavefront(torch, kernels, card):
    """res_wavefront_bf16: the flagship through WavefrontVideoPipeline, then
    the serial AR codec at a small size. Returns the launches."""
    from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
        WavefrontVideoPipeline,
    )
    from spatiotemporalentropymodel_tpu_torch.eval.workload import (
        realistic_stem, wavefront_y_cur,
    )
    from spatiotemporalentropymodel_tpu_torch.models import (
        MeanScaleHyperprior, SpatioTemporalPriorModel,
    )

    tag = "res_wavefront_bf16"
    t0 = time.perf_counter()
    imodel = MeanScaleHyperprior(N, M, device="cuda", seed=0)
    stem = SpatioTemporalPriorModel(variant="res",
                                    entropy_bottleneck_channels=EBC,
                                    in_channels=M, wavefront_tile=RES_TILE,
                                    device="cuda", seed=1)
    realistic_stem(stem)
    imodel.set_compute_dtype(torch.bfloat16)
    stem.set_compute_dtype(torch.bfloat16)
    pipe = WavefrontVideoPipeline(imodel, stem)
    gen = torch.Generator(device="cuda").manual_seed(5)
    y_cond0 = 0.5 * torch.randn((B, M, H // 16, W // 16), generator=gen,
                                device="cuda")
    x_pix = torch.rand((B, 3, H, W), generator=gen, device="cuda")
    log(f"  {tag}: models + tables + surgery: "
        f"{time.perf_counter() - t0:.1f} s")

    # warm-up frame (cuDNN set-up), outside the counted run
    y_cur = wavefront_y_cur(imodel, x_pix, y_cond0, gen)
    pipe.serve_latent(y_cur, y_cond0)
    torch.cuda.synchronize()

    # ---- the main path, counted ----
    kernels.reset_launch_counts()
    gen = torch.Generator(device="cuda").manual_seed(13)
    y_cond, frames = y_cond0, []
    t0 = time.perf_counter()
    for k in range(P_FRAMES):
        y_cur = wavefront_y_cur(imodel, x_pix, y_cond, gen)
        enc, y_hat, x_hat = pipe.serve_latent(y_cur, y_cond, frame=k)
        frames.append((y_cur, y_cond, enc, y_hat, x_hat))
        y_cond = y_hat
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    fps = P_FRAMES * B / wall
    log(f"  {tag} main path: {P_FRAMES} P-frames × {B} in {wall:.3f} s, "
        f"{fps:.3f} frames/s (wall, pipelined), launches {launches}")

    # ---- checks ----
    want = _want(gdn_conv_fused=3 * P_FRAMES, gdn_fused_bf16=P_FRAMES,
                 igdn_deconv_wide_packed=P_FRAMES,
                 igdn_deconv_tail_packed=P_FRAMES)
    if launches != want:
        raise AssertionError(f"{tag}: launches {launches}, expected {want}")
    bpps = []
    for k, (y_cur, y_cond, enc, y_hat, x_hat) in enumerate(frames):
        _check_ar_frame(torch, stem, f"{tag} frame {k}", enc, y_cur, y_cond,
                        y_hat)
        if pipe.encode_frame(y_cur, y_cond)["strings"] != enc["strings"]:
            raise AssertionError(f"{tag} frame {k}: a second encode gave "
                                 f"other streams")
        if (tuple(x_hat.shape) != (B, 3, H, W) or x_hat.dtype != torch.bfloat16
                or not bool(torch.isfinite(x_hat).all())):
            raise AssertionError(f"{tag} frame {k}: x̂ {tuple(x_hat.shape)} "
                                 f"{x_hat.dtype}, or not finite")
        n_bytes = sum(len(s) for g in enc["strings"] for s in g)
        bpps.append(n_bytes * 8 / (B * H * W))
    if not all(RES_BPP[0] < b < RES_BPP[1] for b in bpps):
        raise AssertionError(f"{tag}: bpp {bpps} outside {RES_BPP}")
    bpp = sum(bpps) / len(bpps)
    log(f"  {tag} checks: launches exact, encoder ŷ == decoder ŷ and "
        f"decoded symbols == encoded on {P_FRAMES} frames, streams repeat, "
        f"x̂ finite bf16, bpp per frame {bpps}")
    check_batch_invariance(torch, pipe, frames[1])

    # ---- stage breakdown: one frame with the codec's stage clock on (it
    # synchronises at each boundary), median of 3 ----
    y_cur, y_cond = frames[0][0], frames[0][1]
    runs = []
    for _ in range(3):
        ms_ga, _ = timed_ms(torch, lambda: pipe.analysis(x_pix))
        stem._codec_stats = {}
        _, (_, y_hat, _) = timed_ms(torch, lambda: pipe.serve_latent(
            y_cur, y_cond))
        st, stem._codec_stats = stem._codec_stats, None
        ms_gs, _ = timed_ms(torch, lambda: pipe.synthesis_async(y_hat))
        runs.append(dict(
            g_a=ms_ga, hyper_z_coding=1e3 * st["hyper_s"],
            priors=1e3 * st["priors_s"],
            encode_rounds=1e3 * st["enc_device_s"],
            host_rans_enc=1e3 * st["enc_host_s"],
            decode_rounds=1e3 * st["device_s"],
            host_rans_dec=1e3 * st["host_rans_s"], g_s=ms_gs,
            rounds=st["rounds"]))
    med = {k: sorted(r[k] for r in runs)[1] for k in runs[0]}
    rounds = 3 * (RES_TILE[0] - 1) + RES_TILE[1]
    if med["rounds"] != rounds:
        raise AssertionError(f"{tag}: {med['rounds']} decode rounds, "
                             f"expected {rounds}")
    log(f"  {tag}: bpp {bpp:.5f}, {fps:.3f} frames/s ({P_FRAMES}×{B} frames "
        f"of {H}×{W}, pipelined serve_latent), {rounds} rounds per frame, "
        f"stage ms " + ", ".join(f"{k} {v:.2f}" for k, v in med.items()
                                  if k != "rounds")
        + f" | card: {card}")
    del frames, pipe, stem, imodel
    torch.cuda.empty_cache()
    run_serial(torch, card)
    return launches


def run_serial(torch, card):
    """The serial AR codec on a small f32 res model, one stream: its
    symbols decode, and its ŷ is the untiled wavefront's within
    SERIAL_ATOL (the two batch different numbers of crops, so their bits
    may differ)."""
    from spatiotemporalentropymodel_tpu_torch.models import (
        SpatioTemporalPriorModel,
    )

    tag = "res_serial_f32"
    stem = SpatioTemporalPriorModel(variant="res",
                                    entropy_bottleneck_channels=SERIAL_M,
                                    in_channels=SERIAL_M, ar_mode="serial",
                                    device="cuda", seed=3)
    stem.update()
    gen = torch.Generator(device="cuda").manual_seed(21)
    shape = (1, SERIAL_M, *SERIAL_HW)
    y_cur = torch.randn(shape, generator=gen, device="cuda")
    y_cond = y_cur + 0.3 * torch.randn(shape, generator=gen, device="cuda")
    y_hat = {}
    for mode in ("serial", "wavefront"):
        stem.ar_mode = mode
        ms, enc = timed_ms(torch, lambda: stem.compress(y_cur, y_cond))
        ms_d, dec = timed_ms(torch, lambda: stem.decompress(
            enc["strings"], enc["shape"], y_cond))
        _check_ar_frame(torch, stem, f"{tag} {mode}", enc, y_cur, y_cond,
                        dec["y_hat"])
        y_hat[mode] = dec["y_hat"]
        log(f"  {tag} {mode}: compress {ms:.1f} ms, decompress {ms_d:.1f} ms"
            f" at {SERIAL_HW[0]}×{SERIAL_HW[1]}, {len(enc['strings'][0][0])}"
            f" bytes, encoder ŷ == decoder ŷ, symbols decode")
    err = float((y_hat["serial"] - y_hat["wavefront"]).abs().max())
    if not err <= SERIAL_ATOL:
        raise AssertionError(f"{tag}: serial and wavefront ŷ differ by {err}")
    log(f"  {tag}: max|ŷ_serial − ŷ_wavefront| {err:.3e} (limit "
        f"{SERIAL_ATOL:.0e}) | card: {card}")


def check_batch_invariance(torch, pipe, frame):
    """batch_invariance: each stream of a batched frame coded alone gives
    the batched streams byte for byte and the batched ŷ bit for bit."""
    y_cur, y_cond, enc, y_hat = frame[:4]
    s = y_cur.shape[0]
    for i in range(s):
        solo = pipe.encode_frame(y_cur[i:i + 1], y_cond[i:i + 1])
        if (solo["strings"][0][0] != enc["strings"][0][i]
                or solo["strings"][1][0] != enc["strings"][1][i]):
            raise AssertionError(f"batch_invariance stream {i}: its solo "
                                 f"streams differ from the batched ones")
        y_solo = pipe.decode_frame(solo, y_cond[i:i + 1])
        if not torch.equal(y_solo, y_hat[i:i + 1]):
            diff = int((y_solo != y_hat[i:i + 1]).sum())
            raise AssertionError(f"batch_invariance stream {i}: solo ŷ != "
                                 f"batched ŷ at {diff} elements")
    log(f"  batch_invariance: {s} streams of frame 1 coded alone: streams "
        f"equal byte for byte, ŷ bit for bit")


def _within_band(tag, got, ref, psnr_db=HERO_PSNR_DB):
    """bpp within HERO_BPP_REL of ref's, PSNR within psnr_db dB."""
    d_bpp = abs(got["bpp"] - ref["bpp"]) / ref["bpp"]
    d_psnr = abs(got["psnr"] - ref["psnr"])
    ok = d_bpp <= HERO_BPP_REL and d_psnr <= psnr_db
    log(f"    {tag}: bpp {got['bpp']:.5f} vs {ref['bpp']:.5f} "
        f"({100 * d_bpp:.2f} %, limit {100 * HERO_BPP_REL:.0f} %), PSNR "
        f"{got['psnr']:.3f} vs {ref['psnr']:.3f} dB ({d_psnr:.3f} dB, limit "
        f"{psnr_db} dB) ok={ok}")
    if not ok:
        raise AssertionError(f"{tag}: outside the band of {ref}")


def _snap(kernels):
    return dict(kernels.LAUNCHES), dict(kernels.LAUNCHES_BY_WIDTH)


def _check_widths(kernels, tag, want):
    got = dict(kernels.LAUNCHES_BY_WIDTH)
    if got != want:
        raise AssertionError(f"{tag}: launches by width {got}, expected "
                             f"{want}")


def run_hero_eval(torch, kernels, card, models):
    """hero_eval: the hero GOP eval (2 × 24 frames of 256², GOP 12) through
    eval_dataset with the model API in f32, as tools/bakeoff.py::_eval_cfg
    ran it, held to hero.json; then MS-SSIM of one decoded I-frame."""
    from spatiotemporalentropymodel_tpu_torch.eval.eval_stem import (
        eval_dataset,
    )
    from spatiotemporalentropymodel_tpu_torch.eval.metrics import ms_ssim
    from spatiotemporalentropymodel_tpu_torch.eval.workload import (
        hero_config, hero_gop_set,
    )

    ref = hero_config()["eval"]
    seqs = hero_gop_set()
    frames = sum(len(q) for q in seqs)
    n_i = sum(1 for q in seqs for f in q if f.is_intra)
    n_p = frames - n_i
    snaps = {}
    for variant in ("res", "without_spm"):
        tag = f"hero_eval_{variant}"
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        res = eval_dataset(models["i"], models[variant], seqs,
                           compute_msssim=False, report_estimated_bpp=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        # I-frame: forward (g_a, g_s), compress (g_a), decompress (g_s);
        # P-frame: get_y (g_a), get_x (g_s); each GDN stage one gdn_fused
        qidx = n_i + (n_p if variant == "without_spm" else 0)
        gdn = 3 * (4 * n_i + 2 * n_p)
        _check_launches(kernels, tag, _want(gdn_fused=gdn,
                                            quantize_and_index=qidx))
        _check_widths(kernels, tag, {("gdn_fused", HERO_N): gdn,
                                     ("quantize_and_index",): qidx})
        snaps[tag] = _snap(kernels)
        avg = res["average"]
        log(f"  {tag}: {frames} frames in {wall:.1f} s, bpp "
            f"{avg['bpp']:.5f} (hero.json {ref[variant]['bpp']:.5f}), PSNR "
            f"{avg['psnr']:.3f} dB ({ref[variant]['psnr']:.3f}), bpp_est "
            f"{avg['bpp_est']:.5f} ({ref[variant]['bpp_est']:.5f})")
        _within_band(tag, avg, ref[variant])
    frame = next(iter(seqs[0]))
    x = torch.from_numpy(frame.image).permute(2, 0, 1)[None].contiguous()
    x = x.cuda()
    enc = models["i"].compress(x)
    x_hat = models["i"].decompress(enc["strings"], enc["shape"])["x_hat"]
    score = float(ms_ssim(x, x_hat))
    if not 0.0 < score <= 1.0:
        raise AssertionError(f"hero_eval: MS-SSIM {score}")
    log(f"  hero_eval: MS-SSIM of seq0's I-frame (256²) {score:.5f} | "
        f"card: {card}")
    return snaps


def _hero_frames(torch):
    from spatiotemporalentropymodel_tpu_torch.eval.workload import (
        hero_1080p_frames,
    )

    return [torch.from_numpy(f).permute(2, 0, 1)[None].contiguous().cuda()
            .float() / 255.0 for f in hero_1080p_frames()]


def _hero_iframe(torch, i_model, x, tag):
    """The I-frame codec on x: its ŷ (the decoder's, equal to the
    encoder's) and its stream bytes."""
    enc = i_model.compress(x)
    dec = i_model.decompress(enc["strings"], enc["shape"])
    _, y_enc = i_model.fused_encode_expr(x)
    if not torch.equal(y_enc, dec["y_hat"]):
        raise AssertionError(f"{tag}: I-frame encoder ŷ != decoder ŷ")
    return dec["y_hat"]


def run_hero_serving(torch, kernels, card, i_model, stem, frames, tag,
                     bf16):
    """hero_serving_1080p: frame 0 through the I-frame codec, then 3
    P-frames through StemVideoPipeline(sparse) at B = 1, bpp charged as
    tools/bakeoff.py::_serving_1080p charges it (streams plus the row
    counts' raw bytes). Returns ({bpp, psnr, fps}, launch snapshot)."""
    from spatiotemporalentropymodel_tpu_torch.eval.metrics import psnr
    from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
        StemVideoPipeline,
    )

    pipe = StemVideoPipeline(i_model, stem, transport_mode="sparse")
    yc = _hero_iframe(torch, i_model, frames[0], tag)
    enc, _ = pipe.encode_frame(frames[1], yc)  # warm-up (cuDNN set-up)
    pipe.decode_frame(enc, y_cond=yc)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    total, psnrs, p_frames, y_hats = 0, [], len(frames) - 1, []
    for t in range(1, len(frames)):
        y_hats.append(yc)
        enc, y_carry = pipe.encode_frame(frames[t], yc)
        x_hat, yc_next = pipe.decode_frame(enc, y_cond=yc)
        if enc["transport"] != "sparse":
            raise AssertionError(f"{tag} frame {t}: dense transport")
        if not torch.equal(y_carry, yc_next):
            raise AssertionError(f"{tag} frame {t}: encoder ŷ != decoder ŷ")
        total += sum(len(s) for grp in enc["strings"] for s in grp)
        total += enc["counts"].nbytes
        psnrs.append(float(psnr(frames[t], x_hat)))
        yc = yc_next
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    y_hats.append(yc)
    if bf16:
        want = _want(gdn_conv_fused=3 * p_frames, gdn_fused_bf16=p_frames,
                     igdn_deconv_wide_packed=p_frames,
                     igdn_deconv_tail_packed=p_frames,
                     quantize_and_index_bf16=p_frames)
        widths = {("gdn_conv_fused", HERO_N, HERO_N): 2 * p_frames,
                  ("gdn_conv_fused", HERO_N, M): p_frames,
                  ("gdn_fused_bf16", HERO_N): p_frames,
                  ("igdn_deconv_wide_packed", HERO_N, HERO_N): p_frames,
                  ("igdn_deconv_tail_packed", HERO_N, 3): p_frames,
                  ("quantize_and_index_bf16",): p_frames}
    else:
        want = _want(gdn_fused=6 * p_frames, quantize_and_index=p_frames)
        widths = {("gdn_fused", HERO_N): 6 * p_frames,
                  ("quantize_and_index",): p_frames}
    _check_launches(kernels, tag, want)
    _check_widths(kernels, tag, widths)
    snap = _snap(kernels)
    got = dict(bpp=total * 8.0 / (p_frames * H * W),
               psnr=sum(psnrs) / len(psnrs), fps=p_frames / wall)
    med = parallel_stages(torch, pipe, frames[1], yc)
    if bf16:  # x̂ of the same ŷ with g_s's IGDN→deconv pairs unfused
        with kernels.knobs(FUSE_GS_PACKED=False, FUSE_IGDN_DECONV=False):
            plain = [float(psnr(frames[t], i_model.get_x(y_hats[t])))
                     for t in range(1, len(frames))]
        log(f"    {tag}: PSNR {sum(plain) / len(plain):.3f} dB with g_s's "
            f"IGDN→deconv pairs unfused (bf16 layers), for the same ŷ")
    log(f"  {tag}: {p_frames} P-frames of 1×3×{H}×{W} in {wall:.3f} s, "
        f"{got['fps']:.3f} frames/s (host-coded, encode+decode), bpp "
        f"{got['bpp']:.5f}, PSNR {got['psnr']:.3f} dB, encoder ŷ == decoder "
        f"ŷ on every frame, launches exact {widths}; stage ms "
        + ", ".join(f"{k} {v:.2f}" for k, v in med.items())
        + f" | card: {card}")
    return got, snap


def run_gop_forward(torch, kernels, card, i_model, stem, frames, tag,
                    bf16):
    """gop_forward: the P-frames through StemVideoPipeline.gop_forward
    from the I-frame's ŷ; each frame's bpp_est equals estimate_bpp of
    stem.forward on the same latents (rtol GOP_RTOL). Returns (frames/s,
    launch snapshot)."""
    from spatiotemporalentropymodel_tpu_torch.eval.metrics import (
        estimate_bpp,
    )
    from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
        StemVideoPipeline,
    )

    pipe = StemVideoPipeline(i_model, stem)
    y0 = _hero_iframe(torch, i_model, frames[0], tag)
    gop = torch.stack(frames[1:])  # (T, 1, 3, H, W)
    pipe.gop_forward(gop[:1], y0)  # warm-up
    kernels.reset_launch_counts()
    ms, (x_hats, bpps) = timed_ms(torch, lambda: pipe.gop_forward(gop, y0))
    p_frames = gop.shape[0]
    if bf16:
        want = _want(gdn_conv_fused=3 * p_frames, gdn_fused_bf16=p_frames,
                     igdn_deconv_wide_packed=p_frames,
                     igdn_deconv_tail_packed=p_frames)
    else:
        want = _want(gdn_fused=6 * p_frames)
    _check_launches(kernels, tag, want)
    snap = _snap(kernels)
    if (tuple(x_hats.shape) != (p_frames, 1, 3, H, W)
            or not bool(torch.isfinite(x_hats).all())):
        raise AssertionError(f"{tag}: x̂ {tuple(x_hats.shape)} or not "
                             f"finite")
    y_cond, worst = y0, 0.0
    with torch.no_grad():
        for t in range(p_frames):
            out = stem.forward(i_model.analysis(gop[t]), y_cond)
            want_bpp = estimate_bpp(out["likelihoods"], H * W)
            rel = abs(float(bpps[t, 0]) - want_bpp) / want_bpp
            worst = max(worst, rel)
            if not rel <= GOP_RTOL:
                raise AssertionError(f"{tag} frame {t}: bpp_est "
                                     f"{float(bpps[t, 0])} vs estimate_bpp "
                                     f"{want_bpp}")
            y_cond = out["y_hat"]
    fps = p_frames / (ms / 1e3)
    log(f"  {tag}: {p_frames} frames in {ms:.1f} ms, {fps:.3f} frames/s "
        f"(device only, no coding), bpp_est {[float(b) for b in bpps[:, 0]]}"
        f", max rel diff to estimate_bpp {worst:.2e} (limit {GOP_RTOL:.0e}),"
        f" launches exact | card: {card}")
    return fps, snap


def run_hero_res(torch, kernels, card, frames):
    """The hero res through WavefrontVideoPipeline at 1080p, tile (1, 4),
    bf16, B = 1: exactness only (hero.json has no such figure)."""
    from spatiotemporalentropymodel_tpu_torch.eval.metrics import psnr
    from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
        WavefrontVideoPipeline,
    )
    from spatiotemporalentropymodel_tpu_torch.eval.workload import load_hero

    tag = "hero_res_wavefront_bf16"
    models = load_hero(device="cuda", variants=("res",),
                       wavefront_tile=RES_TILE)
    i_model, stem = models["i"], models["res"]
    i_model.set_compute_dtype(torch.bfloat16)
    stem.set_compute_dtype(torch.bfloat16)
    pipe = WavefrontVideoPipeline(i_model, stem)
    yc = _hero_iframe(torch, i_model, frames[0], tag)
    pipe.serve_latent(pipe.analysis(frames[1]), yc)  # warm-up
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    served = []
    for t in range(1, len(frames)):
        y_cur = pipe.analysis(frames[t])
        enc, y_hat, x_hat = pipe.serve_latent(y_cur, yc, frame=t)
        served.append((y_cur, yc, enc, y_hat, x_hat))
        yc = y_hat
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    p_frames = len(served)
    _check_launches(kernels, tag, _want(
        gdn_conv_fused=3 * p_frames, gdn_fused_bf16=p_frames,
        igdn_deconv_wide_packed=p_frames, igdn_deconv_tail_packed=p_frames))
    snap = _snap(kernels)
    total, psnrs = 0, []
    for t, (y_cur, y_cond, enc, y_hat, x_hat) in enumerate(served, 1):
        _check_ar_frame(torch, stem, f"{tag} frame {t}", enc, y_cur, y_cond,
                        y_hat)
        total += sum(len(s) for g in enc["strings"] for s in g)
        psnrs.append(float(psnr(frames[t], x_hat)))
    stem._codec_stats = {}
    y_cur, y_cond = served[0][0], served[0][1]
    ms, _ = timed_ms(torch, lambda: pipe.serve_latent(y_cur, y_cond))
    st, stem._codec_stats = stem._codec_stats, None
    log(f"  {tag}: {p_frames} P-frames of 1×3×{H}×{W} in {wall:.3f} s, "
        f"{p_frames / wall:.3f} frames/s, bpp "
        f"{total * 8.0 / (p_frames * H * W):.5f}, PSNR "
        f"{sum(psnrs) / len(psnrs):.3f} dB, encoder ŷ == decoder ŷ and "
        f"symbols decode on every frame; one frame {ms:.1f} ms: "
        + ", ".join(f"{k} {1e3 * v:.2f}" for k, v in st.items()
                    if k.endswith("_s")) + f" | card: {card}")
    return snap


def run_hero(torch, kernels, card):
    """The trained hero models, read with jax blocked: hero_eval, then
    hero_serving_1080p and gop_forward in f32 and bf16 on the
    without_spm pair, then the hero res through the wavefront pipeline.
    Returns the launch snapshots by path."""
    from spatiotemporalentropymodel_tpu_torch.eval.workload import (
        hero_config, load_hero,
    )

    t0 = time.perf_counter()
    models = load_hero(device="cuda")
    log(f"  hero models (I, res, without_spm) loaded in "
        f"{time.perf_counter() - t0:.1f} s")
    snaps = run_hero_eval(torch, kernels, card, models)
    frames = _hero_frames(torch)
    i_model, stem = models["i"], models["without_spm"]
    served = {}
    for bf16 in (False, True):
        dt = "bf16" if bf16 else "f32"
        if bf16:
            i_model.set_compute_dtype(torch.bfloat16)
            stem.set_compute_dtype(torch.bfloat16)
        tag = f"hero_serving_1080p_{dt}"
        served[dt], snaps[tag] = run_hero_serving(
            torch, kernels, card, i_model, stem, frames, tag, bf16)
        fps, snaps[f"gop_forward_{dt}"] = run_gop_forward(
            torch, kernels, card, i_model, stem, frames,
            f"gop_forward_{dt}", bf16)
        log(f"  {dt}: gop_forward {fps:.3f} frames/s beside the host-coded "
            f"path's {served[dt]['fps']:.3f}")
    _within_band("hero_serving_1080p_f32 vs hero.json", served["f32"],
                 hero_config()["serving_1080p"])
    _within_band("hero_serving_1080p_bf16 vs the port's f32", served["bf16"],
                 served["f32"])
    del models, i_model, stem
    torch.cuda.empty_cache()
    snaps["hero_res_wavefront_bf16"] = run_hero_res(torch, kernels, card,
                                                    frames)
    return snaps


def _file_want(bf16, n_ga, n_gs, n_q):
    """Launches (by kernel, by width) of n_ga hero g_a passes, n_gs g_s
    passes and n_q quantizer calls: per pass 3 GDN stages, fused in bf16 into
    two 128 → 128 and one 128 → 192 gdn_conv_fused (g_a), or gdn_fused_bf16
    then the packed pair (g_s)."""
    if bf16:
        counts = _want(gdn_conv_fused=3 * n_ga, gdn_fused_bf16=n_gs,
                       igdn_deconv_wide_packed=n_gs,
                       igdn_deconv_tail_packed=n_gs,
                       quantize_and_index_bf16=n_q)
        widths = {("gdn_conv_fused", HERO_N, HERO_N): 2 * n_ga,
                  ("gdn_conv_fused", HERO_N, M): n_ga,
                  ("gdn_fused_bf16", HERO_N): n_gs,
                  ("igdn_deconv_wide_packed", HERO_N, HERO_N): n_gs,
                  ("igdn_deconv_tail_packed", HERO_N, 3): n_gs,
                  ("quantize_and_index_bf16",): n_q}
    else:
        counts = _want(gdn_fused=3 * (n_ga + n_gs), quantize_and_index=n_q)
        widths = {("gdn_fused", HERO_N): 3 * (n_ga + n_gs),
                  ("quantize_and_index",): n_q}
    return counts, {k: v for k, v in widths.items() if v}


def _counted(torch, kernels, tag, want, fn):
    """fn() with the launch counts set to 0 just before and checked
    (by kernel and by width) just after, synchronised; returns (s, fn()'s
    result, launch snapshot)."""
    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, widths = want
    _check_launches(kernels, tag, counts)
    _check_widths(kernels, tag, widths)
    return wall, out, _snap(kernels)


def _file_records(vc, path, n):
    with open(path, "rb") as f:
        hdr = vc.read_header(f)
        return hdr, [vc._read_frame(f) for _ in range(n)]


def _record_bytes(pack_counts, strings, counts):
    """A record's size on the wire: 5 bytes of type and ẑ shape, the
    packed row counts of a sparse record, 4 bytes and the payload per
    string."""
    size = 5 + sum(4 + len(g[0]) for g in strings)
    if counts is not None:
        size += len(pack_counts(np.asarray(counts).reshape(1, -1)))
    return size


def run_file_leg(torch, kernels, card, i_model, stem, frames, tmp, tag,
                 bf16):
    """One .stemv leg on the hero without_spm pair (family 0): encode_video
    and decode_video of the frames, GOP = their count, each timed with
    exact launch counts, then decode_video(output_dir) again; every P
    record sparse, the header's hashes the models', the PNGs the decoded
    frames as decode_video converts them, the frames the in-memory chain's
    (I decompress, the pipeline's decode_frame) and the file's size its
    records' to the byte. Returns ({bpp, psnr} of the P-frames over the
    picture's rows, launch snapshots by path)."""
    from spatiotemporalentropymodel_tpu_torch.data.png import read_png
    from spatiotemporalentropymodel_tpu_torch.entropy.transport import (
        pack_counts,
    )
    from spatiotemporalentropymodel_tpu_torch.eval import video_codec as vc
    from spatiotemporalentropymodel_tpu_torch.eval.codec import to_png_array
    from spatiotemporalentropymodel_tpu_torch.eval.metrics import psnr
    from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
        StemVideoPipeline,
    )
    from spatiotemporalentropymodel_tpu_torch.ops.padding import pad_centered

    n = len(frames)
    path, pngs = tmp / f"{tag}.stemv", tmp / f"{tag}_png"
    meta = {"i_model": "mbt2018-mean", "i_quality": 3}
    enc_s, stats, snap_e = _counted(
        torch, kernels, f"{tag}_encode",
        _file_want(bf16, n, 1, n),
        lambda: vc.encode_video(frames, i_model, stem, path, gop=n,
                                meta=meta))
    dec_s, decoded, snap_d = _counted(
        torch, kernels, f"{tag}_decode", _file_want(bf16, 0, n, 0),
        lambda: vc.decode_video(path, i_model, stem))
    t0 = time.perf_counter()
    again = vc.decode_video(path, i_model, stem, output_dir=pngs)
    png_s = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(again, decoded)):
        raise AssertionError(f"{tag}: a second decode differs")
    hdr, records = _file_records(vc, path, n)
    if [r[0] for r in records] != [vc.FTYPE_I] + [vc.FTYPE_P_SPARSE] * (n - 1):
        raise AssertionError(f"{tag}: record types {[r[0] for r in records]}")
    hashes = (vc.params_hash(stem), vc.params_hash(i_model))
    if (hdr["stem_params_hash"], hdr["i_params_hash"]) != hashes:
        raise AssertionError(f"{tag}: header hashes differ from the models'")
    for t, fr in enumerate(decoded):
        if not np.array_equal(read_png(pngs / f"frame_{t:04d}.png"),
                              to_png_array(fr)):
            raise AssertionError(f"{tag} frame {t}: the PNG is not the "
                                 f"decoded frame")
    # the in-memory chain: the same streams, the same frames, the same bytes
    pipe = StemVideoPipeline(i_model, stem, transport_mode="sparse")
    size, yc = 45, None
    top = (-(-frames[0].shape[0] // 64) * 64 - frames[0].shape[0]) // 2
    rows = slice(top, top + frames[0].shape[0])
    for t, fr in enumerate(frames):
        x = torch.from_numpy(fr).permute(2, 0, 1)[None].cuda()
        x, _ = pad_centered(x, 64)
        if t == 0:
            enc = i_model.compress(x)
            dec = i_model.decompress(enc["strings"], enc["shape"])
            x_hat, yc, counts = dec["x_hat"], dec["y_hat"], None
        else:
            enc, _ = pipe.encode_frame(x, yc)
            x_hat, yc = pipe.decode_frame(enc, y_cond=yc)
            counts = enc["counts"]
        if enc["strings"] != records[t][3]:
            raise AssertionError(f"{tag} frame {t}: file streams differ from "
                                 f"the in-memory encode's")
        want = x_hat[0].float().permute(1, 2, 0).cpu().numpy()[rows]
        if not np.array_equal(decoded[t], want):
            raise AssertionError(f"{tag} frame {t}: decoded frame differs "
                                 f"from the in-memory chain's")
        size += _record_bytes(pack_counts, enc["strings"], counts)
    nbytes = path.stat().st_size
    if nbytes != size:
        raise AssertionError(f"{tag}: file of {nbytes} B, records and header "
                             f"{size} B")
    p_bytes = sum(_record_bytes(pack_counts, r[3], r[2]) for r in records[1:])
    h, w = frames[0].shape[:2]
    psnrs = [float(psnr(torch.from_numpy(frames[t]),
                        torch.from_numpy(decoded[t]))) for t in range(1, n)]
    got = dict(bpp=p_bytes * 8.0 / ((n - 1) * h * w),
               psnr=sum(psnrs) / len(psnrs))
    log(f"  {tag}: {n} frames of {h}×{w} (GOP {n}), file {nbytes} B (header "
        f"45 B, P records {p_bytes} B), {stats['bpp']:.5f} bpp in all; "
        f"encode {n / enc_s:.3f} frames/s, decode {n / dec_s:.3f} frames/s "
        f"({png_s:.2f} s with the PNG writes); P-frames {got['bpp']:.5f} bpp, "
        f"{got['psnr']:.3f} dB; sparse records, hashes, PNGs, in-memory "
        f"chain and bytes exact, launches exact | card: {card}")
    return got, {f"{tag}_encode": snap_e, f"{tag}_decode": snap_d}


def run_file_wavefront(torch, kernels, card, frames, tmp):
    """The hero res at tile (1, 4), bf16, through encode_video/decode_video
    (family 1): cfg0, cfg1 = the tile, launches exact, the decoded frames
    the model-API chain's exactly (tests/test_video_codec.py:146-195)."""
    from spatiotemporalentropymodel_tpu_torch.eval import video_codec as vc
    from spatiotemporalentropymodel_tpu_torch.eval.workload import load_hero
    from spatiotemporalentropymodel_tpu_torch.ops.padding import pad_centered

    tag, n = "file_codecs_res_bf16", len(frames)
    models = load_hero(device="cuda", variants=("res",),
                       wavefront_tile=RES_TILE)
    i_model, stem = models["i"], models["res"]
    i_model.set_compute_dtype(torch.bfloat16)
    stem.set_compute_dtype(torch.bfloat16)
    path = tmp / "res.stemv"
    enc_s, stats, snap_e = _counted(
        torch, kernels, f"{tag}_encode", _file_want(True, n, 1, 1),
        lambda: vc.encode_video(frames, i_model, stem, path, gop=n))
    dec_s, decoded, snap_d = _counted(
        torch, kernels, f"{tag}_decode", _file_want(True, 0, n, 0),
        lambda: vc.decode_video(path, i_model, stem))
    hdr, records = _file_records(vc, path, n)
    if (hdr["stem_family"], hdr["cfg0"], hdr["cfg1"]) != (1, *RES_TILE):
        raise AssertionError(f"{tag}: header {hdr}")
    if [r[0] for r in records] != [0] + [vc.FTYPE_P_WAVEFRONT] * (n - 1):
        raise AssertionError(f"{tag}: record types {[r[0] for r in records]}")
    h = frames[0].shape[0]
    top = (-(-h // 64) * 64 - h) // 2
    yc = None
    for t, fr in enumerate(frames):
        x, _ = pad_centered(torch.from_numpy(fr).permute(2, 0, 1)[None]
                            .cuda(), 64)
        if t == 0:
            enc = i_model.compress(x)
            dec = i_model.decompress(enc["strings"], enc["shape"])
            x_hat, yc = dec["x_hat"], dec["y_hat"]
        else:
            enc = stem.compress(i_model.analysis(x), yc)
            yc = stem.decompress(enc["strings"], enc["shape"], yc)["y_hat"]
            x_hat = i_model.get_x(yc)
        want = x_hat[0].float().permute(1, 2, 0).cpu().numpy()[top:top + h]
        if not np.array_equal(decoded[t], want):
            raise AssertionError(f"{tag} frame {t}: decoded frame differs "
                                 f"from the model-API chain's")
    log(f"  {tag}: tile {RES_TILE} in the header, file "
        f"{path.stat().st_size} B, {stats['bpp']:.5f} bpp; encode "
        f"{n / enc_s:.3f} frames/s, decode {n / dec_s:.3f} frames/s; "
        f"decoded frames == the model-API chain, launches exact | card: "
        f"{card}")
    return {f"{tag}_encode": snap_e, f"{tag}_decode": snap_d}


def _paeth_png(path, rgb):
    """rgb as an 8-bit RGB PNG whose rows all use the Paeth filter. The
    encoder's predictors read the original pixels, so it vectorises; the
    reader's depend on the pixels it rebuilds (data/png.py's diagonals)."""
    import struct
    import zlib

    from spatiotemporalentropymodel_tpu_torch.data import png

    h, w, _ = rgb.shape
    x = rgb.astype(np.int16)
    a, b, c = np.zeros_like(x), np.zeros_like(x), np.zeros_like(x)
    a[:, 1:], b[1:], c[1:, 1:] = x[:, :-1], x[:-1], x[:-1, :-1]
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    raw = np.empty((h, 3 * w + 1), np.uint8)
    raw[:, 0] = 4
    raw[:, 1:] = ((x - pred) & 0xFF).reshape(h, 3 * w)
    with open(path, "wb") as f:
        f.write(png.SIGNATURE
                + png._chunk(b"IHDR", struct.pack(">2I5B", w, h, 8, 2, 0, 0,
                                                  0))
                + png._chunk(b"IDAT", zlib.compress(raw.tobytes()))
                + png._chunk(b"IEND", b""))


def run_png(card, frame, tmp):
    """data/png.py on a 1080p frame, timed on the host: the port's writer
    (Up rows) and its reader, then the reader on a file whose rows all use
    the Paeth filter; each read must give the frame back."""
    from spatiotemporalentropymodel_tpu_torch.data.png import (
        read_png, write_png,
    )

    times = {}
    for name, write in (("up", write_png), ("paeth", _paeth_png)):
        path = tmp / f"{name}.png"
        t0 = time.perf_counter()
        write(path, frame)
        t1 = time.perf_counter()
        back = read_png(path)
        times[name] = (t1 - t0, time.perf_counter() - t1)
        if not np.array_equal(back, frame):
            raise AssertionError(f"png: the {name} file reads back wrong")
    h, w = frame.shape[:2]
    log(f"  png ({h}×{w}, host): write_png {times['up'][0]:.3f} s, read_png "
        f"{times['up'][1]:.3f} s (Up rows); read_png of Paeth rows "
        f"{times['paeth'][1]:.3f} s; both read back exactly | card: {card}")


def run_file_clis(torch, kernels, card, frames_u8, tmp):
    """Both CLIs through main(argv), f32, on PNG files that data/png.py
    wrote: video_codec with the hero I checkpoint (mbt2018-mean, quality
    3) and a seeded STEM (EB 128), its decode equal to decode_video of the
    same file; codec with the hero I checkpoint (its strings those of
    MeanScaleHyperprior.compress), then bmshj2018-factorized and
    bmshj2018-hyperprior at quality 1 from their seeds (strings those of
    compress, the decoded PNG that of decompress). Launches exact."""
    from types import SimpleNamespace

    from spatiotemporalentropymodel_tpu_torch.data.png import (
        read_png, write_png,
    )
    from spatiotemporalentropymodel_tpu_torch.eval import codec
    from spatiotemporalentropymodel_tpu_torch.eval import video_codec as vc
    from spatiotemporalentropymodel_tpu_torch.eval.workload import HERO_DIR
    from spatiotemporalentropymodel_tpu_torch.ops.padding import pad_centered

    ckpt = str(HERO_DIR / "ckpt_i_0.012.pkl.gz")
    src = tmp / "cli_frames"
    src.mkdir()
    for t, f in enumerate(frames_u8):
        write_png(src / f"frame_{t:04d}.png", f)
    n, h, w = len(frames_u8), *frames_u8[0].shape[:2]
    snaps = {}
    out = tmp / "cli.stemv"
    args = ["--i-model", "mbt2018-mean", "--i-quality", "3",
            "--i-checkpoint", ckpt, "--stem-channels", "128"]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    vc.main(["encode", str(src), "-o", str(out), "--gop", str(n), *args])
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    _, records = _file_records(vc, out, n)
    kinds = [r[0] for r in records]
    sparse, dense = kinds.count(vc.FTYPE_P_SPARSE), kinds.count(
        vc.FTYPE_P_DENSE)
    if kinds[0] != vc.FTYPE_I or sparse + dense != n - 1:
        raise AssertionError(f"video_codec CLI: record types {kinds}")
    # a dense P-frame encodes twice (the sparse try, then dense) and decodes
    # once for its carry; an I-frame compresses and decompresses
    counts, widths = _file_want(False, 1 + sparse + 2 * dense, 1 + dense,
                                1 + sparse + 2 * dense)
    _check_launches(kernels, "cli_video_encode", counts)
    _check_widths(kernels, "cli_video_encode", widths)
    snaps["cli_video_encode"] = _snap(kernels)
    rec = tmp / "cli_rec"
    snaps["cli_video_decode"] = _counted(
        torch, kernels, "cli_video_decode", _file_want(False, 0, n, 0),
        lambda: vc.main(["decode", str(out), "-o", str(rec),
                         "--i-checkpoint", ckpt]))[2]
    ns = SimpleNamespace(i_model="mbt2018-mean", i_quality=3,
                         i_checkpoint=ckpt, stem_family="parallel",
                         stem_variant="without_spm", stem_channels=128,
                         stem_checkpoint=None, wavefront_tile=None,
                         device="cuda")
    i_model, stem = vc._build_models(ns)
    for t, fr in enumerate(vc.decode_video(out, i_model, stem)):
        if not np.array_equal(read_png(rec / f"frame_{t:04d}.png"),
                              codec.to_png_array(fr)):
            raise AssertionError(f"video_codec CLI frame {t}: its decode "
                                 f"differs from decode_video's")
    log(f"  cli video_codec: {n} frames of {h}×{w}, records {kinds} (the "
        f"STEM at its seeded initialisation), {out.stat().st_size} B; encode "
        f"{n / enc_s:.3f} frames/s with the model build and PNG reads; "
        f"decode == decode_video, launches exact")

    png = src / "frame_0000.png"
    x = codec.to_device(codec._load_image(png), "cuda")
    x_padded, _ = pad_centered(x, 64)
    top, left = (x_padded.shape[2] - h) // 2, (x_padded.shape[3] - w) // 2
    for name, q, ck in (("mbt2018-mean", 3, ckpt),
                        ("bmshj2018-factorized", 1, None),
                        ("bmshj2018-hyperprior", 1, None)):
        tag = f"cli_codec_{name}"
        binf, recf = tmp / f"{name}.bin", tmp / f"{name}.png"
        qidx = int(name != "bmshj2018-factorized")
        cli = ["--model", name, "--quality", str(q)] + (
            ["--checkpoint", ck] if ck else [])
        enc_s, _, snaps[f"{tag}_encode"] = _counted(
            torch, kernels, f"{tag}_encode", _file_want(False, 1, 0, qidx),
            lambda: codec.main(["encode", str(png), "-o", str(binf), *cli]))
        dec_s, _, snaps[f"{tag}_decode"] = _counted(
            torch, kernels, f"{tag}_decode", _file_want(False, 0, 1, 0),
            lambda: codec.main(["decode", str(binf), "-o", str(recf)] + (
                ["--checkpoint", ck] if ck else [])))
        model = codec._build_model(name, q, ck, "cuda")
        enc = model.compress(x_padded)
        with open(binf, "rb") as f:
            f.read(2 + 8 + 12)
            strings = []
            for _ in range(len(enc["strings"])):
                (length,) = codec._read_uints(f, 1)
                strings.append([f.read(length)])
        if strings != enc["strings"]:
            raise AssertionError(f"{tag}: file strings differ from "
                                 f"compress's")
        x_hat = model.decompress(enc["strings"], enc["shape"])["x_hat"]
        x_hat = x_hat[0, :, top:top + h, left:left + w]
        want = x_hat.float().permute(1, 2, 0).cpu().numpy()
        if not np.array_equal(read_png(recf), codec.to_png_array(want)):
            raise AssertionError(f"{tag}: the decoded PNG is not "
                                 f"decompress's x̂")
        log(f"  cli codec {name} q{q}: {binf.stat().st_size} B "
            f"({binf.stat().st_size * 8 / (h * w):.4f} bpp), encode "
            f"{enc_s:.2f} s, decode {dec_s:.2f} s (each with its model "
            f"build and PNG I/O); strings == compress's, PNG == "
            f"decompress's, launches exact")
    log(f"  cli checks held | card: {card}")
    return snaps


def run_file_codecs(torch, kernels, card):
    """file_codecs: the .stemv files of the hero models at 1080×1920 (the
    rows [4:1084] of the serving probe's frames, padded to 1088 by the
    codec), family 0 in f32 then bf16, family 1 in bf16, then both CLIs;
    and family 0 in f32 on the probe's own 1088-row frames, whose P-frames
    are held to hero.json's 1080p serving figures. The 1080-row files are
    held by exactness only: the codec's centred padding puts 4 black rows
    above and below the picture, whose edges cost bits that hero.json's
    frames never paid. Returns the launch snapshots by path."""
    import tempfile
    from pathlib import Path

    from spatiotemporalentropymodel_tpu_torch.eval.workload import (
        hero_1080p_frames, hero_config, load_hero,
    )

    full_u8 = hero_1080p_frames()
    frames_u8 = [f[4:1084] for f in full_u8]
    frames = [f.astype(np.float32) / 255.0 for f in frames_u8]
    models = load_hero(device="cuda", variants=("without_spm",))
    i_model, stem = models["i"], models["without_spm"]
    snaps, got = {}, {}
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        got["f32_1088"], legs = run_file_leg(
            torch, kernels, card, i_model, stem,
            [f.astype(np.float32) / 255.0 for f in full_u8], tmp,
            "file_codecs_f32_1088", False)
        snaps.update(legs)
        _within_band("file_codecs_f32_1088 vs hero.json's 1080p serving",
                     got["f32_1088"], hero_config()["serving_1080p"])
        for bf16 in (False, True):
            dt = "bf16" if bf16 else "f32"
            if bf16:
                i_model.set_compute_dtype(torch.bfloat16)
                stem.set_compute_dtype(torch.bfloat16)
            got[dt], legs = run_file_leg(
                torch, kernels, card, i_model, stem, frames, tmp,
                f"file_codecs_{dt}", bf16)
            snaps.update(legs)
        log("  P-frames over the picture's rows: "
            + ", ".join(f"{k} {v['bpp']:.5f} bpp / {v['psnr']:.3f} dB"
                        for k, v in got.items())
            + " (the 1080-row legs' padding rows cost bits; the 1088-row "
              "leg is the band's)")
        del models, i_model, stem
        torch.cuda.empty_cache()
        snaps.update(run_file_wavefront(torch, kernels, card, frames, tmp))
        torch.cuda.empty_cache()
        run_png(card, frames_u8[0], tmp)
        snaps.update(run_file_clis(torch, kernels, card, frames_u8, tmp))
    return snaps


# ---- training ------------------------------------------------------------

TRAIN_LR = 1e-4  # the trainers' default main learning rate
TRAIN_LOSS_RTOL = 1e-4  # card vs CPU, as the CPU tests hold the port to JAX
TRAIN_GRAD_TOL = 1e-4  # × max|g| of each leaf
TRAIN_PARAM_ATOL = 1e-6  # after one update, where the gradients pin Adam
# kernel vs plain gdn_fused on a training step: each leaf's max|Δg| within
# this many times that of the plain runs with every (I)GDN output moved by
# GDN_RTOL (the f32 row's tolerance; the kernel's measured error is about
# a tenth of it), with random signs or all up
TRAIN_KERNEL_SCALE = 2.0
TRAIN_SMALL = 64  # card vs CPU: MSH(64, 64) at 2×64×64
HERO_I_CKPT = "artifacts/trained/hero/ckpt_i_0.012.pkl.gz"


def _fed_noise(torch):
    """The training tests' fed noise (tests/torch_port_util.py): the
    bottleneck's and the Gaussian conditional's quantize_noise replaced by
    x + 0.45·sin(7·x + k), the identity's gradient, so the card and the
    CPU (and the kernel and the plain runs) see the same noise. Returns
    the undo."""
    from spatiotemporalentropymodel_tpu_torch.entropy import (
        bottleneck, gaussian,
    )

    saved = [(m, m.quantize_noise) for m in (bottleneck, gaussian)]
    for m, k in ((bottleneck, 0.1), (gaussian, 0.7)):
        m.quantize_noise = (lambda x, generator, k=k: x + (
            0.45 * torch.sin(7.0 * x + k)).detach())

    def undo():
        for m, f in saved:
            m.quantize_noise = f

    return undo


def _adam_first(g):
    """Adam's first update over lr: g/(|g| + ε)."""
    return g / (np.abs(g) + 1e-8)


def _first_moments(state):
    """{name: g} of a first step's clipped gradients, from the Adams'
    exp_avg = (1 − β₁)·g, as host arrays."""
    out = {}
    for name, p in state.module.named_parameters():
        opt = next(o for o in state.optimizers[:2] if p in o.state)
        out[name] = (opt.state[p]["exp_avg"] / 0.1).double().cpu().numpy()
    return out


def _check_grads(tag, got, ref, tol):
    worst = 0.0
    for name, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(got[name] - r).max()) / scale
        worst = max(worst, err)
        if err > tol:
            raise AssertionError(f"{tag}: gradient of {name} off by "
                                 f"{err:.3g}·max|g| (limit {tol})")
    return worst


def run_train_card_vs_cpu(torch, kernels):
    """One make_image_train_step of MSH(64, 64) at 2×64×64 from the same
    weights with the same fed noise on the card and on the CPU (TF32 off,
    phase 1): loss within 1e-4 relative, each gradient leaf within 1e-4 of
    its max|g| (from the Adam first moments), each parameter within 1e-6
    where the two gradients give Adam steps under 5e-7 apart, else within
    2·lr (counted)."""
    import copy

    from spatiotemporalentropymodel_tpu_torch.models import (
        MeanScaleHyperprior,
    )
    from spatiotemporalentropymodel_tpu_torch.parallel import (
        init_train_state, make_image_train_step,
    )
    from spatiotemporalentropymodel_tpu_torch.training import (
        configure_optimizers,
    )

    n = TRAIN_SMALL
    cpu = MeanScaleHyperprior(n, n, device="cpu", seed=5).module
    x = torch.from_numpy(np.random.default_rng(5).random(
        (2, 3, 64, 64), dtype=np.float32))
    out = {}
    undo = _fed_noise(torch)
    try:
        for dev, module in (("cpu", cpu),
                            ("cuda", copy.deepcopy(cpu).to("cuda"))):
            opt = configure_optimizers(module, TRAIN_LR)
            state = init_train_state(module, opt)
            state, metrics = make_image_train_step(module, opt)(
                state, x.to(dev), torch.Generator(device=dev))
            out[dev] = ({k: float(v) for k, v in metrics.items()},
                        _first_moments(state),
                        {k: v.detach().double().cpu().numpy()
                         for k, v in module.named_parameters()})
    finally:
        undo()
    (m_cpu, g_cpu, p_cpu), (m_gpu, g_gpu, p_gpu) = out["cpu"], out["cuda"]
    for k, v in m_cpu.items():
        if not (np.isfinite(m_gpu[k])
                and abs(m_gpu[k] - v) <= TRAIN_LOSS_RTOL * abs(v)):
            raise AssertionError(f"train card vs CPU: {k} {m_gpu[k]} vs {v}")
    worst_g = _check_grads("train card vs CPU", g_gpu, g_cpu, TRAIN_GRAD_TOL)
    unpinned = worst_p = 0
    for k, ref in p_cpu.items():
        err = np.abs(p_gpu[k] - ref)
        loose = TRAIN_LR * np.abs(_adam_first(g_gpu[k])
                                  - _adam_first(g_cpu[k])) > (
            TRAIN_PARAM_ATOL / 2)
        unpinned += int(loose.sum())
        worst_p = max(worst_p, float(np.where(loose, 0, err).max()))
        if worst_p > TRAIN_PARAM_ATOL or float(
                np.where(loose, err, 0).max()) > 2 * TRAIN_LR:
            raise AssertionError(f"train card vs CPU: parameter {k} off by "
                                 f"{float(err.max()):.3g}")
    log(f"  card vs CPU, MSH({n}, {n}) one step, fed noise: loss "
        f"{m_gpu['loss']:.6f} vs {m_cpu['loss']:.6f}, gradients within "
        f"{worst_g:.3g}·max|g|, parameters within {worst_p:.3g} "
        f"({unpinned} entries not pinned by the gradients, within 2·lr)")


def _gdn_moved(torch, kernels, mode, eps, device):
    """A stand-in for gdn_fused: its plain version ("plain"), with each
    output scaled by 1 ± eps, the signs drawn from a fixed seed
    ("random"), or by 1 + eps ("scaled")."""
    gen = torch.Generator(device=device).manual_seed(21)

    def plain(v, g, b, inverse=False):
        out = kernels._gdn_plain(v, g, b, bool(inverse))
        if mode == "random":
            sign = torch.empty(out.shape, device=out.device).bernoulli_(
                0.5, generator=gen) * 2 - 1
            out = out * (1 + eps * sign)
        elif mode == "scaled":
            out = out * (1 + eps)
        return out

    return plain


def _kernel_vs_moved(tag, got, ref, moved):
    """Each leaf's max|kernel − plain| (``got``, ``ref``: {name: gradient})
    within TRAIN_KERNEL_SCALE × the largest max|moved − plain| of the
    ``moved`` runs. Returns (the worst ratio, its leaf)."""
    worst, worst_name = 0.0, None
    for name, r in ref.items():
        d_kernel = float(np.abs(got[name] - r).max())
        d_moved = max(float(np.abs(m[name] - r).max()) for m in moved)
        ratio = d_kernel / max(d_moved, 1e-30)
        if ratio > worst:
            worst, worst_name = ratio, name
        if d_kernel > TRAIN_KERNEL_SCALE * d_moved:
            raise AssertionError(
                f"{tag}: gradient of {name} off by {d_kernel:.3g}, the "
                f"{GDN_RTOL}-moved plain runs by {d_moved:.3g} (limit "
                f"×{TRAIN_KERNEL_SCALE})")
    return worst, worst_name


def _image_grads(torch, kernels, module, x, mode, eps=0.0):
    """Gradients of the RD loss of one train forward (fed noise), with
    gdn_fused's kernel (mode "kernel") or _gdn_moved's stand-in of the
    mode."""
    from spatiotemporalentropymodel_tpu_torch.training import (
        rate_distortion_loss,
    )

    fused = kernels.gdn_fused
    if mode != "kernel":
        kernels.gdn_fused = _gdn_moved(torch, kernels, mode, eps, x.device)
    try:
        out = module(x, train=True, generator=None)
        loss = rate_distortion_loss(out, x)["loss"]
        params = list(module.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    finally:
        kernels.gdn_fused = fused
    return {name: g.double().cpu().numpy()
            for (name, _), g in zip(module.named_parameters(), grads)
            if g is not None}


def run_train_kernel_vs_plain(torch, kernels, module, x):
    """The train_image step's gradients on the card at its full shape, with
    gdn_fused's kernel and with its plain version (fed noise both). The
    network amplifies a GDN's error into the gradients (a leaf's gradient
    sums many pixels' terms, and the fed noise and the bottleneck's
    density are steep), so the yardstick is measured in the same call: the
    plain run again with every (I)GDN output moved by 1e-5 relative (the
    f32 row's rtol), once with random signs and once all up (an error that
    sums coherently over the pixels, as a kernel's bias would). Each
    leaf's max|kernel − plain| must stay within TRAIN_KERNEL_SCALE × the
    larger of those runs' max|moved − plain|."""
    undo = _fed_noise(torch)
    try:
        kernels.reset_launch_counts()
        got = _image_grads(torch, kernels, module, x, "kernel")
        if kernels.LAUNCHES["gdn_fused"] != 6:
            raise AssertionError(f"kernel run: {kernels.LAUNCHES}")
        kernels.reset_launch_counts()
        ref = _image_grads(torch, kernels, module, x, "plain")
        moved = [_image_grads(torch, kernels, module, x, m, GDN_RTOL)
                 for m in ("random", "scaled")]
        if kernels.LAUNCHES["gdn_fused"] != 0:
            raise AssertionError(f"plain runs launched: {kernels.LAUNCHES}")
    finally:
        undo()
    worst, worst_name = _kernel_vs_moved("train kernel vs plain", got, ref,
                                         moved)
    scale = max(float(np.abs(r).max()) for r in ref.values())
    rel = max(float(np.abs(got[n] - r).max() / max(np.abs(r).max(), 1e-30))
              for n, r in ref.items())
    log(f"  kernel vs plain gdn_fused on a train_image step "
        f"({tuple(x.shape)}): worst leaf {worst_name} at {worst:.3g}× the "
        f"{GDN_RTOL}-moved plain runs' deviation (limit "
        f"×{TRAIN_KERNEL_SCALE}); "
        f"max|Δg| per leaf up to {rel:.3g}·max|g| (max|g| {scale:.3g})")
    return {"worst_ratio": worst, "max_rel": rel}


def gdn_train_timing(torch, kernels, c=HERO_N, shape=(16, 128, 128)):
    """gdn_fused at the training shape (g_a's first GDN of MSH(128, 192) at
    16×256²): the forward kernel, its plain version, and the backward
    _KernelFn runs (the plain version recomputed with grad and
    differentiated), each timed with CUDA events."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    b, h, w = shape
    x = torch.randn((b, c, h, w), generator=gen, device="cuda")
    gamma_t = (0.02 * torch.rand((c, c), generator=gen, device="cuda")
               + 0.1 * torch.eye(c, device="cuda")).t().contiguous()
    beta = 1.0 + torch.rand((c,), generator=gen, device="cuda")
    fwd = cuda_ms(lambda: kernels.gdn_fused(x, gamma_t, beta))
    plain = cuda_ms(lambda: kernels._gdn_plain(x, gamma_t, beta, False))
    leaves = [t.clone().requires_grad_(True) for t in (x, gamma_t, beta)]
    out = kernels.gdn_fused(*leaves)
    cot = torch.randn(out.shape, generator=gen, device="cuda")
    bwd = cuda_ms(lambda: torch.autograd.grad(out, leaves, cot,
                                              retain_graph=True), iters=10)
    del out, leaves, cot, x
    torch.cuda.empty_cache()
    # the forward's bound, as check_gdn's f32 rows count it
    pixels = b * h * w
    b_ms, b_by = gdn_bound(2 * pixels * c * 4 + c * c * 4 + c * 4, pixels,
                           c, 6)
    return {"shape": [b, c, h, w], "fwd_ms": fwd, "plain_fwd_ms": plain,
            "bwd_ms": bwd, "bound_ms": b_ms, "bound_by": b_by}


def _timed_steps(torch, module_ns, name, times, check=None):
    """Wrap module_ns.<name> (a make_*_step) so each step it makes is timed
    between two synchronisations, its ms appended to ``times``."""
    make = getattr(module_ns, name)

    def make_timed(*args, **kw):
        step = make(*args, **kw)

        def run(*a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = step(*a)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            if check is not None:
                check(out)
            return out

        return run

    setattr(module_ns, name, make_timed)
    return lambda: setattr(module_ns, name, make)


def _finite_metrics(tag, metrics):
    vals = {k: float(v) for k, v in metrics.items()}
    if not all(np.isfinite(v) for v in vals.values()):
        raise AssertionError(f"{tag}: metrics not finite {vals}")
    return vals


def _rate(times):
    """(ms per step after the first, steps/s) of timed steps."""
    rest = times[1:] or times
    ms = float(np.median(rest))
    return ms, 1e3 / ms


def run_train_image(torch, kernels, card, tmp):
    """train_image with TrainImageConfig's defaults (mbt2018-mean q4 =
    MSH(128, 192), 16×256² synthetic batches) for 3 steps: finite metrics,
    every main parameter moved, the aux optimizer moving quantiles only,
    6 gdn_fused launches per forward (C = 128), and the checkpoint read
    back through load_checkpoint + load_jax_leaves."""
    from spatiotemporalentropymodel_tpu_torch.convert import load_jax_leaves
    from spatiotemporalentropymodel_tpu_torch.training import (
        load_checkpoint, train_image as ti,
    )
    from spatiotemporalentropymodel_tpu_torch.utils.config import (
        TrainImageConfig,
    )
    from spatiotemporalentropymodel_tpu_torch.zoo import create_model

    cfg = TrainImageConfig(workdir=str(tmp / "train_image"))
    model = create_model(cfg.model, cfg.quality, device="cuda")
    before = {k: v.detach().clone() for k, v in
              model.module.named_parameters()}
    times, aux_moved = [], []
    configure = ti.configure_optimizers

    def configure_watched(module, *a):
        pair = configure(module, *a)
        step = pair.aux.step

        def aux_step(*sa, **skw):
            snap = {k: v.detach().clone()
                    for k, v in module.named_parameters()}
            out = step(*sa, **skw)
            aux_moved.append(sorted(
                k for k, v in module.named_parameters()
                if not torch.equal(v, snap[k])))
            return out

        pair.aux.step = aux_step
        return pair

    ti.configure_optimizers = configure_watched
    restore = _timed_steps(torch, ti, "make_image_train_step", times)
    torch.cuda.reset_peak_memory_stats()
    try:
        wall, (state, metrics), snap = _counted(
            torch, kernels, "train_image", _file_want(False, 3, 3, 0),
            lambda: ti.train_image(cfg, max_steps=3, model=model))
    finally:
        restore()
        ti.configure_optimizers = configure
    peak = torch.cuda.max_memory_allocated()
    vals = _finite_metrics("train_image", metrics)
    stuck = [k for k, v in model.module.named_parameters()
             if "quantiles" not in k and torch.equal(v, before[k])]
    if stuck or state.step != 3:
        raise AssertionError(f"train_image: parameters that never moved "
                             f"{stuck}, steps {state.step}")
    if aux_moved != [["entropy_bottleneck.quantiles"]] * 3:
        raise AssertionError(f"train_image: the aux step moved {aux_moved}")
    leaves = load_checkpoint(tmp / "train_image" / "ckpt" /
                             "image_latest.pkl")["train_state"]
    fresh = create_model(cfg.model, cfg.quality, device="cuda", seed=9)
    load_jax_leaves(fresh.module, leaves)
    for (k, v), w in zip(model.module.named_parameters(),
                         fresh.module.parameters()):
        if not torch.equal(v, w):
            raise AssertionError(f"train_image checkpoint: {k} differs")
    ms, sps = _rate(times)
    log(f"  train_image MSH(128, 192), {cfg.batch_size}×{cfg.cropsize}²: "
        f"steps {[round(t, 1) for t in times]} ms (the first with cuDNN's "
        f"choices), {ms:.2f} ms/step, {sps:.3f} steps/s, peak "
        f"{peak / 2**30:.2f} GiB; {wall:.1f} s in all; loss "
        f"{vals['loss']:.4f}, bpp {vals['bpp_loss']:.4f}, mse "
        f"{vals['mse_loss']:.5f}, aux {vals['aux_loss']:.2f}; every main "
        f"parameter moved, the aux step only quantiles; checkpoint read "
        f"back equal | card: {card}")
    x = torch.from_numpy(np.random.default_rng(0).random(
        (cfg.batch_size, 3, cfg.cropsize, cfg.cropsize), dtype=np.float32)
    ).cuda()
    kv = run_train_kernel_vs_plain(torch, kernels, model.module, x)
    return snap, {"ms": ms, "steps_per_s": sps, "peak_bytes": peak,
                  "kernel_vs_plain": kv}


def run_train_stem(torch, kernels, card, tmp):
    """train_stem with TrainStemConfig's defaults (res, M 192, EB 256,
    4 × 7 × 256², the I-model from the hero checkpoint): one batch in
    per_frame (a step per P-frame), 2 in per_sequence, each with its
    validation and checkpoint, then a resumed 3rd per_sequence step.
    Finite metrics, the carry handed back detached, 3 gdn_fused launches
    per get_y call."""
    from spatiotemporalentropymodel_tpu_torch.training import (
        load_trees, train_stem as ts,
    )
    from spatiotemporalentropymodel_tpu_torch.utils.config import (
        TrainStemConfig,
    )

    def carry_detached(out):
        if len(out) == 3 and out[2].requires_grad:
            raise AssertionError("per_frame: the carry came back with grad")

    results, snaps = {}, {}
    i_model = ts.build_i_model(
        TrainStemConfig(i_checkpoint=HERO_I_CKPT), torch.device("cuda"))
    for mode, steps, resume, n_get_y in (("per_frame", 1, False, 2),
                                         ("per_sequence", 2, False, 3),
                                         ("per_sequence", 3, True, 2)):
        tag = f"train_stem_{mode}" + ("_resumed" if resume else "")
        cfg = TrainStemConfig(i_checkpoint=HERO_I_CKPT, step_mode=mode,
                              resume=resume,
                              workdir=str(tmp / f"train_stem_{mode}"))
        times = []
        maker = ("make_stem_frame_step" if mode == "per_frame"
                 else "make_stem_train_step")
        restore = _timed_steps(torch, ts, maker, times, carry_detached)
        torch.cuda.reset_peak_memory_stats()
        try:
            wall, (state, metrics), snaps[tag] = _counted(
                torch, kernels, tag, _file_want(False, n_get_y, 0, 0),
                lambda: ts.train_stem(cfg, max_steps=steps, i_model=i_model))
        finally:
            restore()
        peak = torch.cuda.max_memory_allocated()
        vals = _finite_metrics(tag, metrics)
        ckpt = load_trees(tmp / f"train_stem_{mode}" / "ckpt" /
                             "stem_latest.pkl")
        if int(ckpt["counters"]["iteration"]) != steps:
            raise AssertionError(f"{tag}: checkpoint at "
                                 f"{ckpt['counters']['iteration']}")
        ms, sps = _rate(times)
        results[tag] = {"ms": ms, "steps_per_s": sps, "peak_bytes": peak,
                        "updates": state.step}
        log(f"  {tag}: {len(times)} steps {[round(t, 1) for t in times]} "
            f"ms, {ms:.2f} ms/step (after the first), {sps:.3f} steps/s, "
            f"peak {peak / 2**30:.2f} GiB, {wall:.1f} s with validation and "
            f"checkpoint; loss {vals['loss']:.5f}, aux "
            f"{vals['aux_loss']:.2f}; {state.step} updates | card: {card}")
    return snaps, results


def run_training(torch, kernels, card):
    """training: the card against the CPU on a small train_image step, the
    trainers at full width, gdn_fused's kernel against its plain version on
    a training step, and gdn_fused's backward timing at the training
    shape. Returns (launch snapshots by path, results)."""
    import tempfile
    from pathlib import Path

    run_train_card_vs_cpu(torch, kernels)
    with tempfile.TemporaryDirectory() as d:
        tmp = Path(d)
        snaps = {}
        snaps["train_image"], image = run_train_image(torch, kernels, card,
                                                      tmp)
        torch.cuda.empty_cache()
        stem_snaps, stem = run_train_stem(torch, kernels, card, tmp)
        snaps.update(stem_snaps)
    torch.cuda.empty_cache()
    timing = gdn_train_timing(torch, kernels)
    log(f"  gdn_fused at the training shape {timing['shape']}: forward "
        f"kernel {timing['fwd_ms']:.3f} ms, plain forward "
        f"{timing['plain_fwd_ms']:.3f} ms, backward through _KernelFn (the "
        f"plain version recomputed and differentiated) "
        f"{timing['bwd_ms']:.3f} ms; the forward's bound "
        f"{timing['bound_ms']:.4f} ms by {timing['bound_by']} | card: {card}")
    return snaps, {"train_image": image, **stem, "gdn_backward": timing}


# ---- the autoregressive image models ------------------------------------

AR_M = 320  # mbt2018 at quality 5-8: N 192, M 320 (zoo cfgs)
AR_SERIAL = (8, 12, (64, 128))  # serial mbt2018 (N, M) on a 4 × 8 latent


def _ar_want(kind, bf16, n_ga, n_gs, n=N):
    """Launches (by kernel, by width) of n_ga g_a and n_gs g_s passes of an
    AR image model: mbt2018 at quality 5 ("mbt2018", N 192, M 320) or 1-4
    ("mbt2018_192", N = M = 192), whose bf16 g_a runs its three GDN → conv
    stages as gdn_conv_fused and whose bf16 g_s runs its first IGDN as
    gdn_fused_bf16 and the last two stages as the packed pair; or
    Cheng2020 ("cheng", N = n), whose six (I)GDNs feed residual sums, so
    each runs gdn_fused alone. In f32 every (I)GDN is a gdn_fused."""
    if not bf16 or kind == "cheng":
        name = "gdn_fused_bf16" if bf16 else "gdn_fused"
        counts = {name: 3 * (n_ga + n_gs)}
        widths = {(name, n): 3 * (n_ga + n_gs)}
    else:
        m = AR_M if kind == "mbt2018" else N
        counts = dict(gdn_conv_fused=3 * n_ga, gdn_fused_bf16=n_gs,
                      igdn_deconv_wide_packed=n_gs,
                      igdn_deconv_tail_packed=n_gs)
        widths = {("gdn_conv_fused", N, N): (2 if m != N else 3) * n_ga,
                  ("gdn_conv_fused", N, AR_M): n_ga if m != N else 0,
                  ("gdn_fused_bf16", N): n_gs,
                  ("igdn_deconv_wide_packed", N, N): n_gs,
                  ("igdn_deconv_tail_packed", N, 3): n_gs}
    return _want(**counts), {k: v for k, v in widths.items() if v}


def _ar_round_trip(torch, kernels, card, model, x, tag, kind, bf16):
    """compress, then decompress, of x through the model API, timed and
    with the launch counts set to 0 just before and checked just after:
    encoder ŷ == decoder ŷ bit for bit, a second compress repeats the
    strings, x̂ finite of x's shape, bpp finite. Returns its launch
    snapshot."""
    kernels.reset_launch_counts()
    enc_ms, (enc, y_enc) = timed_ms(torch, lambda: model.encode_with_y_hat(x))
    dec_ms, dec = timed_ms(torch, lambda: model.decompress(enc["strings"],
                                                           enc["shape"]))
    # g_a runs once per picture (each its own stream), g_s on the batch
    counts, widths = _ar_want(kind, bf16, x.shape[0], 1)
    _check_launches(kernels, tag, counts)
    _check_widths(kernels, tag, widths)
    snap = _snap(kernels)
    if not torch.equal(dec["y_hat"], y_enc):
        diff = int((dec["y_hat"] != y_enc).sum())
        raise AssertionError(f"{tag}: encoder ŷ != decoder ŷ at {diff} "
                             f"elements")
    if model.compress(x)["strings"] != enc["strings"]:
        raise AssertionError(f"{tag}: a second compress gives other strings")
    x_hat = dec["x_hat"]
    if x_hat.shape != x.shape or not bool(torch.isfinite(x_hat).all()):
        raise AssertionError(f"{tag}: x̂ {tuple(x_hat.shape)} not finite of "
                             f"x's shape {tuple(x.shape)}")
    nbytes = sum(len(s) for group in enc["strings"] for s in group)
    bpp = nbytes * 8.0 / (x.shape[0] * x.shape[2] * x.shape[3])
    if not np.isfinite(bpp):
        raise AssertionError(f"{tag}: bpp {bpp}")
    h, w = y_enc.shape[2:]
    rounds = len(model._wavefront_setup(h, w)[2])
    log(f"  {tag}: {x.shape[0]}×3×{x.shape[2]}×{x.shape[3]}, latent {h}×{w}"
        f", {rounds} rounds: compress {enc_ms:.1f} ms, decompress "
        f"{dec_ms:.1f} ms, {nbytes} B ({bpp:.4f} bpp, seeded weights); "
        f"encoder ŷ == decoder ŷ, strings repeat, launches exact | card: "
        f"{card}")
    return snap, dict(compress_ms=enc_ms, decompress_ms=dec_ms, rounds=rounds,
                      bpp=bpp)


def run_ar_serial(torch, card):
    """The serial mbt2018 codec (N 8, M 12) on a 4 × 8 latent: its symbols
    decode (encoder ŷ == decoder ŷ), and its ŷ is the wavefront's within
    SERIAL_ATOL."""
    from spatiotemporalentropymodel_tpu_torch.models import (
        JointAutoregressiveHierarchicalPriors,
    )

    n, m, (h, w) = AR_SERIAL
    gen = torch.Generator(device="cuda").manual_seed(22)
    x = torch.rand((1, 3, h, w), generator=gen, device="cuda")
    y_hat = {}
    for mode in ("serial", "wavefront"):
        model = JointAutoregressiveHierarchicalPriors(n, m, ar_mode=mode,
                                                      device="cuda", seed=4)
        model.update()
        ms, (enc, y_enc) = timed_ms(torch,
                                    lambda: model.encode_with_y_hat(x))
        y_hat[mode] = model.decompress(enc["strings"], enc["shape"])["y_hat"]
        if not torch.equal(y_hat[mode], y_enc):
            raise AssertionError(f"mbt2018 {mode}: encoder ŷ != decoder ŷ")
        log(f"  mbt2018_serial {mode}: compress {ms:.1f} ms at "
            f"{y_enc.shape[2]}×{y_enc.shape[3]}, symbols decode")
    err = float((y_hat["serial"] - y_hat["wavefront"]).abs().max())
    if not err <= SERIAL_ATOL:
        raise AssertionError(f"mbt2018 serial and wavefront ŷ differ by "
                             f"{err}")
    log(f"  mbt2018_serial: max|ŷ_serial − ŷ_wavefront| {err:.3e} (limit "
        f"{SERIAL_ATOL:.0e}) | card: {card}")


def run_ar_files(torch, kernels, card, frames_u8, tmp):
    """The .bin CLI through main(argv) with cheng2020-anchor at quality 3
    on a 256² PNG (strings compress's, the PNG decompress's); a .stemv of
    the probe's frames with a seeded mbt2018 at quality 4 as the I-model
    and the hero without_spm STEM (family 0, GOP 4; the decoded frames the
    in-memory chain's); load_torch_checkpoint of a CompressAI-keyed
    .pth.tar written from a seeded mbt2018 at quality 5 (the same
    parameters and strings). f32. Returns the launch snapshots."""
    from spatiotemporalentropymodel_tpu_torch import zoo
    from spatiotemporalentropymodel_tpu_torch.data.png import (
        read_png, write_png,
    )
    from spatiotemporalentropymodel_tpu_torch.eval import codec
    from spatiotemporalentropymodel_tpu_torch.eval import video_codec as vc
    from spatiotemporalentropymodel_tpu_torch.eval.pipeline import (
        StemVideoPipeline,
    )
    from spatiotemporalentropymodel_tpu_torch.eval.workload import load_hero
    from spatiotemporalentropymodel_tpu_torch.zoo.convert import KEY_MAPS

    snaps = {}
    # the .bin CLI
    name, q, tag = "cheng2020-anchor", 3, "image_ar_cli_cheng2020-anchor"
    png, binf, recf = tmp / "ar.png", tmp / "ar.bin", tmp / "ar_rec.png"
    write_png(png, frames_u8[0][:256, :256])
    n_cli = zoo.cfgs[name][q][0]  # the CLI's model: N 128 at quality 3
    enc_s, _, snaps[f"{tag}_encode"] = _counted(
        torch, kernels, f"{tag}_encode",
        _ar_want("cheng", False, 1, 0, n_cli),
        lambda: codec.main(["encode", str(png), "-o", str(binf), "--model",
                            name, "--quality", str(q)]))
    dec_s, _, snaps[f"{tag}_decode"] = _counted(
        torch, kernels, f"{tag}_decode",
        _ar_want("cheng", False, 0, 1, n_cli),
        lambda: codec.main(["decode", str(binf), "-o", str(recf)]))
    model = codec._build_model(name, q, None, "cuda")
    x = codec.to_device(codec._load_image(png), "cuda")
    enc = model.compress(x)
    with open(binf, "rb") as f:
        f.read(2 + 8 + 12)
        strings = [[f.read(codec._read_uints(f, 1)[0])]
                   for _ in range(len(enc["strings"]))]
    if strings != enc["strings"]:
        raise AssertionError(f"{tag}: file strings differ from compress's")
    x_hat = model.decompress(enc["strings"], enc["shape"])["x_hat"]
    want = x_hat[0].float().permute(1, 2, 0).cpu().numpy()
    if not np.array_equal(read_png(recf), codec.to_png_array(want)):
        raise AssertionError(f"{tag}: the decoded PNG is not decompress's x̂")
    log(f"  {tag} q{q}: 256² PNG, {binf.stat().st_size} B; encode "
        f"{enc_s:.2f} s, decode {dec_s:.2f} s (each with its model build "
        f"and PNG I/O); strings == compress's, PNG == decompress's, "
        f"launches exact")

    # the .stemv with an AR I-model
    tag = "image_ar_stemv_mbt2018"
    i_model = zoo.create_model("mbt2018", 4, device="cuda", seed=5)
    i_model.update()
    stem = load_hero(device="cuda", variants=("without_spm",))[
        "without_spm"]
    frames = [f.astype(np.float32) / 255.0 for f in frames_u8]
    n, path = len(frames), tmp / "ar.stemv"
    meta = {"i_model": "mbt2018", "i_quality": 4}
    kernels.reset_launch_counts()
    enc_ms, _ = timed_ms(torch, lambda: vc.encode_video(
        frames, i_model, stem, path, gop=n, meta=meta))
    hdr, records = _file_records(vc, path, n)
    kinds = [r[0] for r in records]
    sparse, dense = kinds.count(vc.FTYPE_P_SPARSE), kinds.count(
        vc.FTYPE_P_DENSE)
    if kinds[0] != vc.FTYPE_I or sparse + dense != n - 1 or hdr["flags"]:
        raise AssertionError(f"{tag}: records {kinds}, flags {hdr['flags']}")
    # I: compress (g_a) and decompress (g_s); a sparse P-frame g_a and one
    # quantizer call, a dense one the sparse try and the dense encode (g_a
    # and the quantizer twice) and a decode for its carry (g_s)
    counts, widths = _ar_want("mbt2018_192", False, 1 + sparse + 2 * dense,
                              1 + dense)
    counts["quantize_and_index"] = sparse + 2 * dense
    widths[("quantize_and_index",)] = sparse + 2 * dense
    _check_launches(kernels, f"{tag}_encode", counts)
    _check_widths(kernels, f"{tag}_encode", widths)
    snaps[f"{tag}_encode"] = _snap(kernels)
    dec_s, decoded, snaps[f"{tag}_decode"] = _counted(
        torch, kernels, f"{tag}_decode", _ar_want("mbt2018_192", False, 0, n),
        lambda: vc.decode_video(path, i_model, stem))
    pipe = StemVideoPipeline(i_model, stem, transport_mode="sparse")
    yc = None
    for t, fr in enumerate(frames):
        x = torch.from_numpy(fr).permute(2, 0, 1)[None].cuda()
        if t == 0:
            enc = i_model.compress(x)
            dec = i_model.decompress(enc["strings"], enc["shape"])
            x_hat, yc = dec["x_hat"], dec["y_hat"]
        else:
            enc, _ = pipe.encode_frame(x, yc)
            x_hat, yc = pipe.decode_frame(enc, y_cond=yc)
        if enc["strings"] != records[t][3]:
            raise AssertionError(f"{tag} frame {t}: file streams differ from "
                                 f"the in-memory encode's")
        if not np.array_equal(decoded[t], x_hat[0].float().permute(
                1, 2, 0).cpu().numpy()):
            raise AssertionError(f"{tag} frame {t}: decoded frame differs "
                                 f"from the in-memory chain's")
    log(f"  {tag}: {n} frames of {frames[0].shape[0]}×{frames[0].shape[1]}"
        f" (GOP {n}, records {kinds}), {path.stat().st_size} B; encode "
        f"{n / (enc_ms / 1e3):.3f} frames/s, decode {n / dec_s:.3f} frames/s"
        f"; streams and frames the in-memory chain's, launches exact")
    del stem, pipe, i_model

    # a CompressAI checkpoint of mbt2018 at quality 5
    tag = "image_ar_checkpoint_mbt2018"
    src = zoo.create_model("mbt2018", 5, device="cuda", seed=6)
    src.update()
    key_map = KEY_MAPS["mbt2018"]
    state = {key_map(k): v.detach().cpu()
             for k, v in src.module.named_parameters()}
    ckpt = tmp / "mbt2018.pth.tar"
    torch.save({"state_dict": state}, ckpt)
    got = zoo.load_torch_checkpoint("mbt2018", str(ckpt), 5, device="cuda")
    for (k, a), b in zip(src.module.named_parameters(),
                         got.module.parameters()):
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: {k} differs after the load")
    x = torch.from_numpy(frames[0]).permute(2, 0, 1)[None].cuda()
    if got.compress(x)["strings"] != src.compress(x)["strings"]:
        raise AssertionError(f"{tag}: strings differ after the load")
    log(f"  {tag}: {len(state)} CompressAI keys → the same parameters and "
        f"strings at {x.shape[2]}×{x.shape[3]} | card: {card}")
    return snaps


def run_image_ar(torch, kernels, card):
    """image_ar: the autoregressive image models at full width from seeds
    on the probe's first 1088×1920 frame: mbt2018 at quality 5 (N 192, M
    320) in bf16 then f32; batch_invariance_ar, mbt2018 at quality 4 in
    bf16 on two frames batched; Cheng2020-attn at quality 6 (N 192) in
    bf16 and f32; the serial mbt2018 at a 4 × 8 latent; then the files.
    Returns ({path: launch snapshot}, {path: figures})."""
    import tempfile
    from pathlib import Path

    from spatiotemporalentropymodel_tpu_torch import zoo
    from spatiotemporalentropymodel_tpu_torch.eval.workload import (
        hero_1080p_frames,
    )

    frames_u8 = hero_1080p_frames()
    x2 = torch.from_numpy(np.stack(frames_u8[:2])).permute(0, 3, 1, 2)
    x2 = x2.contiguous().cuda().float() / 255.0
    x = x2[:1]
    snaps, figures = {}, {}
    for name, q, kind in (("mbt2018", 5, "mbt2018"),
                          ("cheng2020-attn", 6, "cheng")):
        for bf16 in (True, False):
            tag = f"image_ar_{name}_q{q}_{'bf16' if bf16 else 'f32'}"
            model = zoo.create_model(name, q, device="cuda", seed=1)
            model.update()
            if bf16:
                model.set_compute_dtype(torch.bfloat16)
            snaps[tag], figures[tag] = _ar_round_trip(
                torch, kernels, card, model, x, tag, kind, bf16)
            del model
            torch.cuda.empty_cache()

    # batch_invariance_ar: each frame coded alone gives the batched strings
    # byte for byte and the batched ŷ bit for bit
    tag = "batch_invariance_ar"
    model = zoo.create_model("mbt2018", 4, device="cuda", seed=2)
    model.update()
    model.set_compute_dtype(torch.bfloat16)
    snaps[tag], figures[tag] = _ar_round_trip(
        torch, kernels, card, model, x2, tag, "mbt2018_192", True)
    enc, y_hat = model.encode_with_y_hat(x2)
    for i in range(2):
        solo, y_solo = model.encode_with_y_hat(x2[i:i + 1])
        if (solo["strings"][0][0] != enc["strings"][0][i]
                or solo["strings"][1][0] != enc["strings"][1][i]):
            raise AssertionError(f"{tag} frame {i}: its solo strings differ "
                                 f"from the batched ones")
        if not torch.equal(y_solo[0], y_hat[i]):
            raise AssertionError(f"{tag} frame {i}: solo ŷ != batched ŷ")
    log(f"  {tag}: each of 2 frames coded alone: strings equal byte for "
        f"byte, ŷ bit for bit")
    del model
    torch.cuda.empty_cache()

    run_ar_serial(torch, card)
    with tempfile.TemporaryDirectory() as d:
        snaps.update(run_ar_files(torch, kernels, card, frames_u8, Path(d)))
    return snaps, figures


# ---- the ROI / pixel-domain STEM family -----------------------------------

ROI_EBC, ROI_M, ROI_N = 256, 192, 128  # TrainStemRoiConfig; the fixed trunk
ROI_NAMES = ("stem_baseline", "stem_baselinev2", "stem_roi",
             "stem_roi_wo_gsc", "stem_roi_i")
ROI_LEVELS = (0, 50, 100, -1)
ROI_RC = (0.45,)
ROI_TRAIN_GRAD_TOL = 2e-3  # × max|g|, f32 against f64, plain GDN
ROI_TIMED = 3  # compress and decompress times: the median of 3


def _roi_model(torch, name, bf16, seed=1):
    """A seeded model of the family, tamed (eval/workload.py::tame_roi: at
    their initialisation the quality-map transforms blow x̂ past f32)."""
    from spatiotemporalentropymodel_tpu_torch import zoo
    from spatiotemporalentropymodel_tpu_torch.eval.workload import tame_roi

    model = zoo.roi_models[name](entropy_bottleneck_channels=ROI_EBC,
                                 in_channels=ROI_M, device="cuda", seed=seed)
    tame_roi(model.module)
    model.update()
    if bf16:
        model.set_compute_dtype(torch.bfloat16)
    return model


def _roi_want(name, bf16, frames=1):
    """Launches (by kernel, by width) of ``frames`` compress + decompress
    round trips, B = 1. The pixel encoders (the baselines' PEncoder and
    ConditionEncoder, the ROI P-models' ConditionEncoder) run 3 GDNs each
    (bf16: 3 gdn_conv_fused, 128 → 128 twice and 128 → M): a baseline runs
    3 (x_cur and x_cond, then x_cond to decode), a ROI P-model 2; the ROI
    g_a and g_s run 3 GDNs each, alone; the baselines' PDecoder 3 IGDNs
    (bf16: its first alone, then the packed pair); quantize_and_index
    once per compress."""
    n = ROI_N
    baseline = name.startswith("stem_baseline")
    n_enc = 3 if baseline else (0 if name == "stem_roi_i" else 2)
    n_alone = 0 if baseline else 6
    q = "quantize_and_index_bf16" if bf16 else "quantize_and_index"
    counts, widths = {q: 1}, {(q,): 1}
    if bf16:
        g = n_alone + int(baseline)
        counts.update(gdn_conv_fused=3 * n_enc, gdn_fused_bf16=g)
        widths.update({("gdn_conv_fused", n, n): 2 * n_enc,
                       ("gdn_conv_fused", n, ROI_M): n_enc,
                       ("gdn_fused_bf16", n): g})
        if baseline:
            counts.update(igdn_deconv_wide_packed=1,
                          igdn_deconv_tail_packed=1)
            widths.update({("igdn_deconv_wide_packed", n, n): 1,
                           ("igdn_deconv_tail_packed", n, 3): 1})
    else:
        g = 3 * n_enc + n_alone + 3 * int(baseline)
        counts["gdn_fused"] = g
        widths[("gdn_fused", n)] = g
    counts = {k: v * frames for k, v in counts.items()}
    widths = {k: v * frames for k, v in widths.items() if v}
    return _want(**counts), widths


def _add_snap(total, snap):
    for part, add in zip(total, snap):
        for k, v in add.items():
            part[k] = part.get(k, 0) + v


def _roi_round_trip(torch, kernels, model, args, cond, tag, want):
    """compress, then decompress with no quality map, counted: encoder ŷ ==
    decoder ŷ bit for bit, x̂ finite and in [0, 1], launches exact; then
    ROI_TIMED − 1 more round trips for the times, each compress's strings
    the first's. Returns (snapshot, figures)."""
    kernels.reset_launch_counts()
    enc_ms, (enc, y_enc) = timed_ms(torch,
                                    lambda: model.encode_with_y_hat(*args))
    dec_ms, dec = timed_ms(torch, lambda: model.decompress(
        enc["strings"], enc["shape"], *cond))
    _check_launches(kernels, tag, want[0])
    _check_widths(kernels, tag, want[1])
    snap = _snap(kernels)
    if not torch.equal(dec["y_hat"], y_enc):
        diff = int((dec["y_hat"] != y_enc).sum())
        raise AssertionError(f"{tag}: encoder ŷ != decoder ŷ at {diff} "
                             f"elements")
    x_hat = dec["x_hat"]
    if not (bool(torch.isfinite(x_hat).all()) and float(x_hat.min()) >= 0
            and float(x_hat.max()) <= 1):
        raise AssertionError(f"{tag}: x̂ not finite in [0, 1]")
    enc_t, dec_t = [enc_ms], [dec_ms]
    for _ in range(ROI_TIMED - 1):
        ms, again = timed_ms(torch, lambda: model.compress(*args))
        enc_t.append(ms)
        if again["strings"] != enc["strings"]:
            raise AssertionError(f"{tag}: a second compress gives other "
                                 f"strings")
        dec_t.append(timed_ms(torch, lambda: model.decompress(
            enc["strings"], enc["shape"], *cond))[0])
    nbytes = sum(len(s) for group in enc["strings"] for s in group)
    x = args[0]
    bpp = nbytes * 8.0 / (x.shape[2] * x.shape[3])
    return snap, dict(compress_ms=float(np.median(enc_t)),
                      decompress_ms=float(np.median(dec_t)), bytes=nbytes,
                      bpp=bpp, x_hat_shape=list(x_hat.shape))


def _roi_inputs(torch, frames_u8, rows=None):
    """(x_cur, x_cond, qmap) on the card: the probe's frames 1 and 0 and a
    synthesize_qmap map (random.Random(3)) cut to the frame, (1, 1, H, W);
    ``rows`` cuts the frames' rows."""
    import random

    from spatiotemporalentropymodel_tpu_torch.data import synthesize_qmap

    rows = rows or slice(None)
    xs = [torch.from_numpy(f[rows]).permute(2, 0, 1)[None].contiguous()
          .cuda().float() / 255.0 for f in frames_u8[:2]]
    h, w = xs[0].shape[2:]
    q = synthesize_qmap(max(h, w), rng=random.Random(3))[:h, :w]
    return xs[1], xs[0], torch.from_numpy(
        np.ascontiguousarray(q[None, :, :, 0]))[None].cuda()


def _roi_args(name, x, xc, q):
    if name == "stem_roi_i":
        return (x, q), ()
    return ((x, xc, q) if name.startswith("stem_roi") else (x, xc)), (xc,)


def run_roi_models(torch, kernels, card, frames_u8, total):
    """The five models at EB 256, M 192 from seeds (tamed) on one
    1088×1920 pair, f32 then bf16; then stem_roi on the pair cut to rows
    4-1083, unpadded (its hyper-encoder's map is the 1080 → 68 resize)."""
    figures = {}
    x, xc, q = _roi_inputs(torch, frames_u8)
    for bf16 in (False, True):
        for name in ROI_NAMES:
            tag = f"roi_{name}_{'bf16' if bf16 else 'f32'}"
            model = _roi_model(torch, name, bf16)
            args, cond = _roi_args(name, x, xc, q)
            snap, figures[tag] = _roi_round_trip(
                torch, kernels, model, args, cond, tag,
                _roi_want(name, bf16))
            _add_snap(total, snap)
            f = figures[tag]
            log(f"  {tag}: 1×3×{H}×{W}: compress {f['compress_ms']:.1f} ms, "
                f"decompress {f['decompress_ms']:.1f} ms (median of "
                f"{ROI_TIMED}), {f['bytes']} B ({f['bpp']:.4f} bpp, seeded "
                f"weights); encoder ŷ == decoder ŷ, x̂ in [0, 1], strings "
                f"repeat, launches exact | card: {card}")
            del model
        torch.cuda.empty_cache()
    tag = "roi_stem_roi_unpadded_1080"
    x, xc, q = _roi_inputs(torch, frames_u8, slice(4, 1084))
    model = _roi_model(torch, "stem_roi", False)
    args, cond = _roi_args("stem_roi", x, xc, q)
    snap, f = _roi_round_trip(torch, kernels, model, args, cond, tag,
                              _roi_want("stem_roi", False))
    _add_snap(total, snap)
    if f["x_hat_shape"] != [1, 3, H, W]:
        raise AssertionError(f"{tag}: x̂ {f['x_hat_shape']}")
    figures[tag] = f
    h = x.shape[2]
    log(f"  {tag}: 1×3×{h}×{W} unpadded (latent {-(-h // 16)}×{W // 16}, "
        f"the map resized {h} → {-(-h // 16)} rows): compress "
        f"{f['compress_ms']:.1f} ms, decompress "
        f"{f['decompress_ms']:.1f} ms, {f['bytes']} B; encoder ŷ == decoder "
        f"ŷ, launches exact")
    del model
    torch.cuda.empty_cache()
    return figures


def run_roi_eval(torch, kernels, card, frames_u8, total):
    """eval_levels on a 3-frame GOP of 1088×1920 (stem_roi_i, then stem_roi
    conditioned on the padded reconstruction) at ROI_LEVELS, then eval_rc
    at ROI_RC, in f32: every compress's streams decode to its encoder's ŷ
    exactly, bpp and PSNR finite, the launches exact."""
    from spatiotemporalentropymodel_tpu_torch.data import ArraySequence
    from spatiotemporalentropymodel_tpu_torch.eval import eval_stem_roi

    model_i = _roi_model(torch, "stem_roi_i", False, seed=2)
    model_p = _roi_model(torch, "stem_roi", False, seed=3)
    checked = []
    for model in (model_i, model_p):
        def compress(*a, _m=model):
            enc, y_enc = type(_m).encode_with_y_hat(_m, *a)
            _m._y_enc = y_enc
            return enc

        def decompress(*a, _m=model):
            dec = type(_m).decompress(_m, *a)
            if not torch.equal(dec["y_hat"], _m._y_enc):
                raise AssertionError("roi eval: encoder ŷ != decoder ŷ")
            checked.append(1)
            return dec

        model.compress, model.decompress = compress, decompress
    seq = ArraySequence(frames_u8[:3], gop_size=3)
    # per level an I-frame (stem_roi_i: a forward, 6 GDNs, and a round
    # trip, 6) and two P-frames (stem_roi: a forward, 9, and a round trip,
    # 12), each compress one quantize_and_index
    n_lv = len(ROI_LEVELS) + len(ROI_RC)
    g, nq = n_lv * (12 + 2 * 21), 3 * n_lv
    want = (_want(gdn_fused=g, quantize_and_index=nq),
            {("gdn_fused", ROI_N): g, ("quantize_and_index",): nq})
    tag = "roi_eval"
    wall, (levels, rc), snap = _counted(
        torch, kernels, tag, want,
        lambda: (eval_stem_roi.eval_levels(model_i, model_p, [seq],
                                           list(ROI_LEVELS)),
                 eval_stem_roi.eval_rc(model_i, model_p, [seq],
                                       list(ROI_RC))))
    _add_snap(total, snap)
    if len(checked) != nq:
        raise AssertionError(f"{tag}: {len(checked)} decodes checked")
    for level, r in {**levels, **rc}.items():
        if not (np.isfinite(r["psnr"]) and np.isfinite(r["bpp"])
                and r["bpp"] > 0):
            raise AssertionError(f"{tag} level {level}: {r}")
        # MS-SSIM is NaN below its 5-scale size and not asked for here
        r.pop("ms-ssim")
    log(f"  {tag}: a 3-frame GOP of {H}×{W}, levels {list(ROI_LEVELS)} and "
        f"rc {list(ROI_RC)}: "
        + ", ".join(f"{k}: {v['bpp']:.4f} bpp / {v['psnr']:.2f} dB"
                    for k, v in {**levels, **rc}.items())
        + f" (seeded weights); {len(checked)} decodes == their encoder's ŷ"
        f", launches exact; {wall:.1f} s | card: {card}")
    del model_i, model_p
    torch.cuda.empty_cache()
    return {"levels": levels, "rc": rc, "seconds": wall}


def run_roi_train_card_vs_cpu(torch, kernels):
    """One joint step of each recipe (roi: stem_roi_i + stem_roi at EB 16,
    M 12, tamed; baseline: MeanScaleHyperprior(16, 16) + stem_baselinev2)
    on a 2-frame 2×64² sequence, from the same weights with the same fed
    noise: on the CPU in f64 and f32, and on the card with the gdn_fused
    kernel, with its plain version, and with the plain version's outputs
    moved by GDN_RTOL (random signs; all up). The card's loss within 1e-4
    relative of the CPU's; the CPU's and the card's plain f32 gradients
    within ROI_TRAIN_GRAD_TOL of each leaf's max|g| of the f64 run's; the
    kernel's gradients off the card's plain ones by at most
    TRAIN_KERNEL_SCALE × the nudged runs' largest deviation, leaf by leaf
    (the training phase's criterion, _kernel_vs_moved): the SFT and quality-map gradients
    are sums that cancel to a small part of their terms, so a GDN output
    moved by its f32 tolerance moves them by up to a tenth of max|g|."""
    import copy
    import random

    from spatiotemporalentropymodel_tpu_torch.data import synthesize_qmap
    from spatiotemporalentropymodel_tpu_torch.eval.workload import tame_roi
    from spatiotemporalentropymodel_tpu_torch.models import (
        MeanScaleHyperprior, StemBaselineModule, StemROIModule,
    )
    from spatiotemporalentropymodel_tpu_torch.parallel import (
        init_train_state,
    )
    from spatiotemporalentropymodel_tpu_torch.training import (
        configure_optimizers, train_stem_roi as tr,
    )

    rng = np.random.default_rng(7)
    frames = torch.from_numpy(rng.random((2, 2, 3, 64, 64),
                                         dtype=np.float32))
    q = torch.from_numpy(np.stack([synthesize_qmap(
        64, rng=random.Random(i))[None, :, :, 0] for i in range(2)]))
    real = kernels.gdn_fused
    # (tag, device, dtype, the gdn_fused stand-in's mode and eps or None)
    runs = (("cpu64", "cpu", torch.float64, None),
            ("cpu", "cpu", torch.float32, None),
            ("kernel", "cuda", torch.float32, None),
            ("plain", "cuda", torch.float32, ("plain", 0.0)),
            ("nudged", "cuda", torch.float32, ("random", GDN_RTOL)),
            ("up", "cuda", torch.float32, ("scaled", GDN_RTOL)))
    undo = _fed_noise(torch)
    try:
        for mode in ("roi", "baseline"):
            g = torch.Generator().manual_seed(5)
            if mode == "roi":
                cpu = (StemROIModule(16, 12, conditional=False, generator=g),
                       StemROIModule(16, 12, generator=g))
            else:
                cpu = (MeanScaleHyperprior(16, 16, device="cpu",
                                           seed=5).module,
                       StemBaselineModule(16, 12, True, generator=g))
            for m in cpu:
                tame_roi(m)
            out = {}
            for tag, dev, dtype, gdn in runs:
                if gdn is not None:
                    kernels.gdn_fused = _gdn_moved(torch, kernels, *gdn, dev)
                try:
                    mods = [copy.deepcopy(m).to(dev, dtype) for m in cpu]
                    opts = [configure_optimizers(m, TRAIN_LR) for m in mods]
                    states = [init_train_state(m, o)
                              for m, o in zip(mods, opts)]
                    step = tr.make_joint_sequence_step(
                        *mods, *opts, mode=mode, loss_threshold=1e9)
                    *states, metrics = step(
                        *states, frames.to(dev, dtype), q.to(dev, dtype),
                        torch.Generator(device=dev))
                finally:
                    kernels.gdn_fused = real
                out[tag] = (float(metrics["loss"]),
                            [_first_moments(s) for s in states])
            loss = {k: v[0] for k, v in out.items()}
            if not abs(loss["kernel"] - loss["cpu"]) <= (
                    TRAIN_LOSS_RTOL * abs(loss["cpu"])):
                raise AssertionError(f"roi train card vs CPU ({mode}): loss "
                                     f"{loss['kernel']} vs {loss['cpu']}")
            grads = {k: v[1] for k, v in out.items()}
            worst = {k: max(_check_grads(
                f"roi train {k} f32 vs f64 ({mode})", a, b,
                ROI_TRAIN_GRAD_TOL) for a, b in zip(grads[k], grads["cpu64"]))
                for k in ("cpu", "plain")}
            # the I- and P-modules' leaves in one dict each
            flat = {k: {f"{i}.{n}": g for i, d in enumerate(v)
                        for n, g in d.items()} for k, v in grads.items()}
            ratio, _ = _kernel_vs_moved(
                f"roi train kernel vs plain ({mode})", flat["kernel"],
                flat["plain"], [flat["nudged"], flat["up"]])
            log(f"  roi train card vs CPU, {mode}: one joint step, fed "
                f"noise: loss {loss['kernel']:.6f} vs {loss['cpu']:.6f} "
                f"(f64 {loss['cpu64']:.6f}); f32 gradients off the f64 "
                f"run's by {worst['cpu']:.3g} (CPU) and {worst['plain']:.3g} "
                f"(card, plain GDN) of max|g| (limit {ROI_TRAIN_GRAD_TOL}); "
                f"the kernel's off the plain ones by at most {ratio:.3g}× "
                f"the nudged runs' deviation (limit {TRAIN_KERNEL_SCALE})")
    finally:
        undo()


def _unmoved(torch, modules, before):
    """The parameters of ``modules`` equal to their ``before`` copies."""
    return [f"{i}.{k}" for i, m in enumerate(modules)
            for k, v in m.named_parameters() if torch.equal(v, before[i][k])]


def _params(modules):
    return [{k: v.detach().clone() for k, v in m.named_parameters()}
            for m in modules]


def run_roi_train(torch, kernels, card, total):
    """train_stem_roi in both modes at TrainStemRoiConfig's defaults (EB
    256, M 192, 4 × 256², the JAX package's synthetic 3-frame batches),
    but for loss_skip_threshold, 3 steps, the weights tamed (roi): finite
    metrics, every frame valid, every parameter of both modules moved, the
    checkpoint, the gdn_fused launches of the forwards (6 for the I-frame,
    9 per P-frame); then one step of each on a 7-frame batch (a Vimeo
    septuplet's length), every frame valid and every parameter moved
    again. The seeded weights' losses (400-470 on the card) are far past
    the default threshold 3.0, which would mask every frame's gradient, so
    that no main parameter would move: the threshold is 1e9, as in the
    card-vs-CPU check. ms per step with the first apart, steps/s, peak
    memory."""
    import tempfile
    from pathlib import Path

    from spatiotemporalentropymodel_tpu_torch.eval.workload import tame_roi
    from spatiotemporalentropymodel_tpu_torch.parallel import (
        init_train_state,
    )
    from spatiotemporalentropymodel_tpu_torch.training import (
        configure_optimizers, load_trees, train_stem_roi as tr,
    )
    from spatiotemporalentropymodel_tpu_torch.utils.config import (
        TrainStemRoiConfig,
    )

    results = {}
    steps, frames = 3, 3
    with tempfile.TemporaryDirectory() as d:
        for mode in ("roi", "baseline"):
            tag = f"roi_train_{mode}"
            cfg = TrainStemRoiConfig(mode=mode, workdir=str(Path(d) / mode),
                                     loss_skip_threshold=1e9)
            modules = tr.build_modules(cfg, torch.device("cuda"))
            for m in modules:
                tame_roi(m)
            before = _params(modules)
            times = []
            restore = _timed_steps(torch, tr, "make_joint_sequence_step",
                                   times)
            torch.cuda.reset_peak_memory_stats()
            n = steps * (6 + 9 * (frames - 1))
            try:
                wall, ((st_i, st_p), metrics), snap = _counted(
                    torch, kernels, tag,
                    (_want(gdn_fused=n), {("gdn_fused", ROI_N): n}),
                    lambda: tr.train_stem_roi(cfg, steps, modules))
            finally:
                restore()
            _add_snap(total, snap)
            peak = torch.cuda.max_memory_allocated()
            vals = _finite_metrics(tag, metrics)
            stuck = _unmoved(torch, modules, before)
            if vals["valid_frames"] != frames or stuck:
                raise AssertionError(f"{tag}: valid frames "
                                     f"{vals['valid_frames']}, parameters "
                                     f"that never moved {stuck}")
            ckpt = load_trees(Path(d) / mode / "ckpt" / "stem_roi_latest.pkl")
            if int(ckpt["counters"]["iteration"]) != steps or \
                    st_i.step != steps or st_p.step != steps:
                raise AssertionError(f"{tag}: {st_i.step}, {st_p.step} "
                                     f"updates")
            ms, sps = _rate(times)
            # one step on a septuplet, the same modules
            x7 = torch.rand((cfg.batch_size, 7, 3, cfg.cropsize,
                             cfg.cropsize), device="cuda")
            q7 = torch.rand((cfg.batch_size, 1, cfg.cropsize, cfg.cropsize),
                            device="cuda")
            opts = [configure_optimizers(m, cfg.learning_rate)
                    for m in modules]
            states = [init_train_state(m, o) for m, o in zip(modules, opts)]
            step7 = tr.make_joint_sequence_step(
                *modules, *opts, mode=mode,
                loss_threshold=cfg.loss_skip_threshold, lmbda=cfg.lmbda)
            before = _params(modules)
            torch.cuda.reset_peak_memory_stats()
            kernels.reset_launch_counts()
            ms7, out7 = timed_ms(torch, lambda: step7(
                *states, x7, q7, torch.Generator(device="cuda")))
            n7 = 6 + 9 * 6
            _check_launches(kernels, f"{tag}_7", _want(gdn_fused=n7))
            _add_snap(total, _snap(kernels))
            peak7 = torch.cuda.max_memory_allocated()
            vals7 = _finite_metrics(f"{tag}_7", out7[2])
            stuck = _unmoved(torch, modules, before)
            if vals7["valid_frames"] != 7 or stuck:
                raise AssertionError(f"{tag}_7: valid frames "
                                     f"{vals7['valid_frames']}, parameters "
                                     f"that never moved {stuck}")
            results[tag] = {"ms": ms, "steps_per_s": sps, "peak_bytes": peak,
                            "septuplet_ms": ms7, "septuplet_peak_bytes": peak7,
                            "valid_frames": vals["valid_frames"],
                            "septuplet_valid_frames": vals7["valid_frames"],
                            "loss_skip_threshold": cfg.loss_skip_threshold}
            n_params = sum(len(b) for b in before)
            log(f"  {tag}: {cfg.batch_size}×{frames}×{cfg.cropsize}² "
                f"synthetic, {len(times)} steps "
                f"{[round(t, 1) for t in times]} ms, {ms:.1f} ms/step (after "
                f"the first), {sps:.3f} steps/s, peak {peak / 2**30:.2f} GiB, "
                f"{wall:.1f} s with the checkpoint; loss {vals['loss']:.4f}, "
                f"valid frames {vals['valid_frames']:.0f} of {frames}; a "
                f"7-frame step {ms7:.1f} ms, peak {peak7 / 2**30:.2f} GiB, "
                f"loss {vals7['loss']:.4f}, valid frames "
                f"{vals7['valid_frames']:.0f} of 7; all {n_params} parameters "
                f"moved in both runs (threshold "
                f"{cfg.loss_skip_threshold:g}) | card: {card}")
            del modules, states, opts, step7, out7, st_i, st_p, before
            torch.cuda.empty_cache()
    return results


def run_roi_checkpoints(torch, card, frames_u8):
    """load_video_torch_checkpoint on CompressAI-keyed state dicts written
    from a seeded stem_roi (EB 256, M 192, tamed) and a seeded STEM res:
    the same parameters, and compress gives the source model's strings
    (stem_roi on the 1088×1920 pair, res on latents of its size)."""
    from spatiotemporalentropymodel_tpu_torch import zoo
    from spatiotemporalentropymodel_tpu_torch.zoo.convert import KEY_MAPS

    x, xc, q = _roi_inputs(torch, frames_u8)
    gen = torch.Generator(device="cuda").manual_seed(4)
    lat = [torch.randn((1, ROI_M, H // 16, W // 16), generator=gen,
                       device="cuda") for _ in range(2)]
    for name, key_map, args in (
            ("stem_roi", "stem-roi", (x, xc, q)),
            ("stpm_res", "stem", lat)):
        if name == "stem_roi":
            src = _roi_model(torch, name, False, seed=6)
        else:
            src = zoo.stem_models[name](entropy_bottleneck_channels=ROI_EBC,
                                        in_channels=ROI_M, device="cuda",
                                        seed=6)
            src.update()
        km = KEY_MAPS[key_map]
        state = {"state_dict": {km(k): v.detach().cpu()
                                for k, v in src.module.named_parameters()}}
        got = zoo.load_video_torch_checkpoint(
            name, state, device="cuda", entropy_bottleneck_channels=ROI_EBC,
            in_channels=ROI_M)
        for (k, a), b in zip(src.module.named_parameters(),
                             got.module.parameters()):
            if not torch.equal(a, b):
                raise AssertionError(f"roi checkpoint {name}: {k} differs")
        if got.compress(*args)["strings"] != src.compress(*args)["strings"]:
            raise AssertionError(f"roi checkpoint {name}: strings differ")
        log(f"  roi_checkpoint {name} ({key_map}): "
            f"{len(state['state_dict'])} CompressAI keys → the same "
            f"parameters and strings | card: {card}")
        del src, got
    torch.cuda.empty_cache()


def run_roi(torch, kernels, card):
    """roi: the ROI / pixel-domain STEM family at full width from seeds —
    the five models' round trips in f32 and bf16 and stem_roi unpadded at
    1080 rows, eval_levels and eval_rc, train_stem_roi in both modes (and
    the card against the CPU on a small joint step), and the video
    checkpoint loader. Returns ({"roi": launch snapshot}, figures)."""
    from spatiotemporalentropymodel_tpu_torch.eval.workload import (
        hero_1080p_frames,
    )

    t0 = time.perf_counter()
    frames_u8 = hero_1080p_frames()
    total = ({}, {})
    figures = {"models": run_roi_models(torch, kernels, card, frames_u8,
                                        total)}
    figures["eval"] = run_roi_eval(torch, kernels, card, frames_u8, total)
    run_roi_train_card_vs_cpu(torch, kernels)
    figures["train"] = run_roi_train(torch, kernels, card, total)
    run_roi_checkpoints(torch, card, frames_u8)
    figures["seconds"] = time.perf_counter() - t0
    log(f"  roi phase: {figures['seconds']:.1f} s | card: {card}")
    return {"roi": total}, figures


def main() -> int:
    # the port and this script never import jax: block it, so an import of
    # it anywhere below fails (the hero checkpoints are read without it)
    sys.modules["jax"] = None
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
    for dtype in (torch.float32, torch.bfloat16):
        name = kernels._QIDX_ENTRIES[dtype][0]
        results[name] = check_qidx(torch, kernels, table, dtype)
    results["gdn_fused_bf16"] = check_gdn_entry(torch, kernels)
    results["gdn_conv_fused"] = check_gdn_conv(torch, F, kernels)
    wide, tail = check_gs_pair(torch, F, kernels)
    results["igdn_deconv_wide_packed"] = wide
    results["igdn_deconv_tail_packed"] = tail
    fused, wide = check_gs_lone(torch, F, kernels)
    results["igdn_deconv_fused"] = fused
    results["igdn_deconv_wide"] = wide
    # the hero I-model's widths (N = 128, M = 192, one picture), rows of
    # their own: name@widths
    log(f"  the hero widths, N = {HERO_N}, M = {M}, B = 1")
    hero_rows = {
        ("gdn_conv_fused", HERO_N, HERO_N): check_gdn_conv(
            torch, F, kernels, 1, HERO_N, HERO_N,
            ((H // 2, W // 2), (H // 4, W // 4))),
        ("gdn_conv_fused", HERO_N, M): check_gdn_conv(
            torch, F, kernels, 1, HERO_N, M, ((H // 8, W // 8),)),
        ("gdn_fused_bf16", HERO_N): check_gdn_entry(torch, kernels, 1,
                                                    HERO_N),
    }
    wide, tail = check_gs_pair(torch, F, kernels, 1, HERO_N)
    hero_rows[("igdn_deconv_wide_packed", HERO_N, HERO_N)] = wide
    hero_rows[("igdn_deconv_tail_packed", HERO_N, 3)] = tail
    # mbt2018's g_a at quality 5-8 (N 192, M 320), its last stage, B = 1
    log(f"  mbt2018's last g_a stage, {N} → {AR_M}, B = 1")
    hero_rows[("gdn_conv_fused", N, AR_M)] = check_gdn_conv(
        torch, F, kernels, 1, N, AR_M, ((H // 8, W // 8),))
    # the ROI trunk's first GDN, 1×128×544×960, f32 and bf16
    log(f"  the ROI trunk's GDN, C = {ROI_N}, 1×{ROI_N}×{H // 2}×{W // 2}")
    roi_rows = {(name, ROI_N): check_gdn_entry(
        torch, kernels, 1, ROI_N, (H // 2, W // 2), dtype, False, 17)
        for name, dtype in (("gdn_fused", torch.float32),
                            ("gdn_fused_bf16", torch.bfloat16))}
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
    log(f"[4/5] slice: res_wavefront_bf16, STEM res tile {RES_TILE} through "
        f"WavefrontVideoPipeline, {P_FRAMES} P-frames of {B}×3×{H}×{W}, "
        f"with batch_invariance; then the serial AR codec at "
        f"{SERIAL_HW[0]}×{SERIAL_HW[1]}")
    by_path["res_wavefront_bf16"] = run_res_wavefront(torch, kernels, card)
    log("[4/5] the trained hero models (N 128, M 192, EB 128) with jax "
        "blocked: hero_eval, hero_serving_1080p, gop_forward")
    hero = run_hero(torch, kernels, card)
    log("[4/5] file_codecs: .stemv files of the hero models at 1080×1920 "
        "(family 0 f32 and bf16, family 1 bf16), then both CLIs")
    hero.update(run_file_codecs(torch, kernels, card))
    log("[4/5] training: card vs CPU on a small step, train_image MSH(128, "
        "192) at 16×256², train_stem res (M 192, EB 256) at 4×7×256² from "
        "the hero I checkpoint, kernel vs plain on a training step")
    train_snaps, training = run_training(torch, kernels, card)
    hero.update(train_snaps)
    torch.cuda.empty_cache()
    log("[4/5] image_ar: mbt2018 q5 (N 192, M 320) and Cheng2020-attn q6 at "
        f"{H}×{W} from seeds, bf16 and f32; batch_invariance_ar (mbt2018 q4,"
        " 2 frames, bf16); the serial mbt2018; the .bin CLI, a .stemv with "
        "an mbt2018 I-model, a CompressAI checkpoint")
    ar_snaps, image_ar = run_image_ar(torch, kernels, card)
    hero.update(ar_snaps)
    torch.cuda.empty_cache()
    log(f"[4/5] roi: the five ROI-family models (EB {ROI_EBC}, M {ROI_M}) "
        f"at {H}×{W} from seeds, f32 and bf16, and stem_roi unpadded at "
        f"1080 rows; eval_levels and eval_rc on a 3-frame GOP; "
        f"train_stem_roi in both modes; the video checkpoint loader")
    roi_snaps, roi = run_roi(torch, kernels, card)
    hero.update(roi_snaps)
    by_width = {}
    for tag, (counts, widths) in hero.items():
        by_path[tag] = counts
        by_width[tag] = widths

    # ---- 5. report ----
    replaces = {
        "gdn_fused": (f"{PK}:150", "kernels.cu"),
        "gdn_fused_bf16": (f"{PK}:150", "kernels.cu"),
        "quantize_and_index": (f"{PK}:214", "kernels.cu"),
        "quantize_and_index_bf16": (f"{PK}:214", "kernels.cu"),
        "gdn_conv_fused": (f"{PK}:945", "gdn_conv.cu"),
        "igdn_deconv_wide_packed": (f"{PK}:1389", "igdn_deconv.cu"),
        "igdn_deconv_tail_packed": (f"{PK}:1561", "igdn_deconv.cu"),
        "igdn_deconv_fused": (f"{PK}:387", "igdn_deconv.cu"),
        "igdn_deconv_wide": (f"{PK}:1267", "igdn_deconv.cu"),
    }
    def row(name, kernel, res, per_path):
        line, src = replaces[kernel]
        return {
            "name": name, "route": "cuda", "source": f"{CSRC}/{src}",
            "replaces": line, "launches": sum(per_path.values()),
            "launches_by_path": {k: v for k, v in per_path.items() if v},
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"],
            "pair_ms": res.get("pair_ms"), "alone_ms": res.get("alone_ms"),
            **({"library": res["library"]} if "library" in res else {}),
            "shape": res["shape"],
            **({"stages": res["stages"]} if "stages" in res else {}),
        }

    # a row per kernel, its launches on every path; then a row per kernel
    # at the hero widths and at mbt2018's 192 → 320, its launches at those
    # widths on the hero and image_ar paths
    rows = [row(name, name, res,
                {tag: counts[name] for tag, counts in by_path.items()})
            for name, res in results.items()]
    # the f32 gdn_fused row: its training shape's forward and backward
    next(r for r in rows if r["name"] == "gdn_fused")["train"] = (
        training["gdn_backward"])
    log(json.dumps({"training": {k: v for k, v in training.items()
                                 if k != "gdn_backward"}}))
    log(json.dumps({"image_ar": image_ar}))
    log(json.dumps({"roi": roi}))
    roi_shape = f"1x{ROI_N}x{H // 2}x{W // 2}"
    for key, res, suffix in (
            [(k, r, "") for k, r in hero_rows.items()]
            + [(k, r, f":{roi_shape}") for k, r in roi_rows.items()]):
        per_path = {tag: widths.get(key, 0)
                    for tag, widths in by_width.items()}
        if not sum(per_path.values()):
            raise AssertionError(f"{key}: never launched on the hero paths")
        rows.append(row(f"{key[0]}@{'x'.join(map(str, key[1:]))}{suffix}",
                        key[0], res, per_path))
    log(json.dumps({"kernels": rows}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
