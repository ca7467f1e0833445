"""The serving paths' kernels: CUDA wrappers and their plain versions.

Counterpart of spatiotemporalentropymodel_tpu/ops/pallas_kernels.py, one
wrapper per Pallas kernel:

  * ``gdn_fused``          — GDN/IGDN ``x · rsqrt(β + x²·γᵀ)`` (``sqrt`` for
    IGDN) over the channel axis, f32 math, f32 or bf16 I/O (``_gdn_ref`` is
    the plain form).
  * ``quantize_and_index`` — (y, μ, σ) → int32 saturated symbols and uint8
    CDF-row indexes (``_qidx_ref`` is the plain form).
  * ``gdn_conv_fused``     — ``conv_k5s2(GDN(x)) + b``, bf16 (the three g_a
    stages of the bf16 path; ``_gdn_conv_ref``).
  * ``igdn_deconv_wide_packed`` / ``igdn_deconv_tail_packed`` — IGDN fused
    into g_s's last two k5 s2 transposed convs, N→N then N→3, bf16
    (``_igdn_deconv_ref``). On the TPU the pair passes a phase-major packed
    tensor; here the tensor between them is the logical NCHW output.
  * ``igdn_deconv_wide`` / ``igdn_deconv_fused`` — the lone IGDN → k5 s2
    transposed conv, wide (N→N) and narrow (N→F, F ≤ 32), bf16
    (``_igdn_deconv_ref``). They run the same CUDA kernels as the packed
    pair, since the port's pair already writes and reads the logical layout.

Each wrapper launches its hand-written kernel (csrc/*.cu) for a CUDA
tensor and runs the plain PyTorch version only for a tensor on the CPU, where
the tests run. On a CUDA tensor it launches or raises; it never falls back.
``LAUNCHES`` counts the launches per kernel (the bf16 entry of ``gdn_fused``
as ``gdn_fused_bf16``), so a caller can show that a path went through the
kernels. The kernels' layout is the port's: channel-second (NCHW) for the
GDN and conv kernels, any layout for the elementwise quantizer.

Every wrapper but ``quantize_and_index`` (integer outputs) is differentiable
on both devices: its backward recomputes the plain version and differentiates
it, as the JAX package's ``custom_vjp`` rules do (``_KernelFn``).

The ``FUSE_*`` knobs mirror the JAX package's A/B knobs of the same names,
with its defaults; ``layers/conv.py::Sequential`` reads them at every call.
"""

import contextlib
import ctypes
from functools import lru_cache, partial

import numpy as np
import torch
import torch.nn.functional as F

from ..entropy.base import SYMBOL_MAX

# launches per kernel; each wrapper adds one where it launches, nowhere else
LAUNCHES = {
    "gdn_fused": 0,
    "gdn_fused_bf16": 0,
    "quantize_and_index": 0,
    "gdn_conv_fused": 0,
    "igdn_deconv_wide_packed": 0,
    "igdn_deconv_tail_packed": 0,
    "igdn_deconv_fused": 0,
    "igdn_deconv_wide": 0,
}

# channel counts the fused GDN + conv kernels are instantiated for
# (gdn_conv.cu, igdn_deconv.cu)
FUSED_CHANNELS = (64, 128, 192)

# the JAX package's peephole knobs (pallas_kernels.py:1341, :513, :262,
# :1151), with its defaults
FUSE_GS_PACKED = True
FUSE_GDN_CONV = True
FUSE_IGDN_DECONV = True
FUSE_IGDN_DECONV_WIDE = False

# the JAX package's "wide" g_s chain (tools/gs_packed_tune.py): the lone
# IGDN→Deconv pairs in place of the packed quadruple
WIDE_KNOBS = {"FUSE_GS_PACKED": False, "FUSE_IGDN_DECONV": True,
              "FUSE_IGDN_DECONV_WIDE": True}


@contextlib.contextmanager
def knobs(**values):
    """Set ``FUSE_*`` knobs for the length of a ``with`` block, e.g.
    ``with knobs(**WIDE_KNOBS):``; the old values come back after it."""
    g = globals()
    unknown = [k for k in values if not k.startswith("FUSE_") or k not in g]
    if unknown:
        raise KeyError(f"unknown knobs {unknown}")
    old = {k: g[k] for k in values}
    g.update(values)
    try:
        yield
    finally:
        g.update(old)


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@lru_cache(maxsize=1)
def _lib():
    from .build import build

    lib = ctypes.CDLL(str(build()))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in ("stem_gdn_fused_f32", "stem_gdn_fused_bf16"):
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = [vp, vp, vp, vp, i64, i32, i64, i32, vp]
    for name in ("stem_gdn_conv_fused_bf16", "stem_igdn_deconv_wide_bf16"):
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = [vp] * 6 + [i64, i32, i32, i32, i32, vp]
    lib.stem_igdn_deconv_narrow_bf16.restype = i32
    lib.stem_igdn_deconv_narrow_bf16.argtypes = (
        [vp] * 6 + [i64, i32, i32, i32, i32, i32, vp])
    lib.stem_quantize_and_index_f32.restype = i32
    lib.stem_quantize_and_index_f32.argtypes = [
        vp, vp, vp, vp, i32, ctypes.c_float, vp, vp, i64, vp,
    ]
    return lib


def load() -> None:
    """Build (if needed) and load the kernel library."""
    _lib()


def _check_cuda(name, pairs):
    """Every (tensor, dtype) pair: the first tensor's device, that dtype,
    contiguous; or raise."""
    dev = pairs[0][0].device
    for t, dtype in pairs:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


class _KernelFn(torch.autograd.Function):
    """One differentiable kernel call: forward runs ``launch`` on a CUDA
    tensor (the kernel) or ``plain`` on a CPU tensor (the plain version), and
    raises on any other device; backward recomputes ``plain`` with grad and
    differentiates it, as the JAX package's VJPs differentiate their
    ``_*_ref`` (pallas_kernels.py:164-182, :461-491, :1093, :1291, :1414,
    :1621). Each gradient comes back in its input's dtype."""

    @staticmethod
    def forward(ctx, name, plain, launch, *inputs):
        ctx.plain = plain
        ctx.save_for_backward(*inputs)
        x = inputs[0]
        if x.device.type == "cpu":
            return plain(*inputs)
        if x.device.type != "cuda":
            raise ValueError(f"{name}: unsupported device {x.device}")
        return launch(*inputs)

    @staticmethod
    def backward(ctx, grad):
        inputs = ctx.saved_tensors
        wanted = ctx.needs_input_grad[3:]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(w)
                      for t, w in zip(inputs, wanted)]
            out = ctx.plain(*leaves)
        live = [t for t, w in zip(leaves, wanted) if w]
        got = iter(torch.autograd.grad(out, live, grad.to(out.dtype),
                                       allow_unused=True))
        return (None, None, None,
                *(next(got) if w else None for w in wanted))


# ---------------------------------------------------------------------------
# fused GDN
# ---------------------------------------------------------------------------


def _gdn_ref(x, gamma_t, beta, inverse: bool):
    """Plain form on channel-second x (B, C, ...): norm = x² @ γᵀ + β over C.
    Mirrors pallas_kernels.py::_gdn_ref."""
    norm = torch.einsum("bi...,io->bo...", x * x, gamma_t)
    norm = norm + beta.view(1, -1, *([1] * (x.dim() - 2)))
    norm = torch.sqrt(norm) if inverse else torch.rsqrt(norm)
    return x * norm


def _gdn_plain(x, gamma_t, beta, inverse: bool):
    """``gdn_fused``'s plain version: f32 math, x's dtype out."""
    return _gdn_ref(x.float(), gamma_t.float(), beta.float(),
                    inverse).to(x.dtype)


def _gdn_launch(x, gamma_t, beta, inverse: bool):
    f32 = torch.float32
    if x.dtype == torch.bfloat16:
        name, entry, io = "gdn_fused_bf16", _lib().stem_gdn_fused_bf16, x.dtype
    else:
        name, entry, io = "gdn_fused", _lib().stem_gdn_fused_f32, f32
    _check_cuda(name, [(x, io), (gamma_t, f32), (beta, f32)])
    b, c = x.shape[0], x.shape[1]
    if gamma_t.shape != (c, c) or beta.shape != (c,):
        raise ValueError(
            f"{name}: x {tuple(x.shape)} needs gamma_t ({c}, {c}) and "
            f"beta ({c},), got {tuple(gamma_t.shape)}, {tuple(beta.shape)}"
        )
    out = torch.empty_like(x)
    p = x.numel() // max(b * c, 1)
    rc = entry(
        x.data_ptr(), gamma_t.data_ptr(), beta.data_ptr(), out.data_ptr(),
        b, c, p, int(bool(inverse)), _stream(x.device),
    )
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def gdn_fused(x, gamma_t, beta, inverse: bool = False):
    """Fused GDN over channel-second x (B, C, ...), f32 or bf16. gamma_t is
    (in, out) = γ transposed and beta is (C,), both f32 on the card. Output
    has x's shape and dtype; the math is f32."""
    inverse = bool(inverse)
    return _KernelFn.apply("gdn_fused", partial(_gdn_plain, inverse=inverse),
                           partial(_gdn_launch, inverse=inverse),
                           x, gamma_t, beta)


# ---------------------------------------------------------------------------
# fused quantize + scale-table index
# ---------------------------------------------------------------------------


def _qidx_ref(y, means, scales, table, scale_bound):
    """Plain form; mirrors pallas_kernels.py::_qidx_ref (round half to even,
    searchsorted-left over table[:-1])."""
    sym = torch.clamp(
        torch.round(y - means), -float(SYMBOL_MAX), float(SYMBOL_MAX)
    ).to(torch.int32)
    s = torch.clamp_min(scales, scale_bound)
    idx = torch.searchsorted(table[:-1].contiguous(), s.contiguous(),
                             right=False)
    return sym, idx.to(torch.uint8)


def scale_table_tensor(table, device) -> torch.Tensor:
    """The scale table as the f32 tensor the quantizer compares against
    (pallas_kernels.py:217 casts it to f32 the same way)."""
    return torch.as_tensor(np.asarray(table, np.float32), device=device)


def quantize_and_index(y, means, scales, table, scale_bound: float = 0.11):
    """(y, μ, σ) → (int32 symbols, uint8 CDF-row indexes), elementwise.

    ``table``: the f32 scale table (see ``scale_table_tensor``) on y's
    device; passing it ready avoids an upload (and a stream sync) per call.
    """
    if not isinstance(table, torch.Tensor):
        table = scale_table_tensor(table, y.device)
    if y.device.type == "cpu":
        return _qidx_ref(y.float(), means.float(), scales.float(),
                         table.float(), scale_bound)
    if y.device.type != "cuda":
        raise ValueError(f"quantize_and_index: unsupported device {y.device}")
    _check_cuda("quantize_and_index",
                [(t, torch.float32) for t in (y, means, scales, table)])
    if means.shape != y.shape or scales.shape != y.shape:
        raise ValueError("quantize_and_index: y, means, scales must match")
    if not 1 <= table.numel() <= 256:
        raise ValueError("quantize_and_index: scale table of 1..256 entries")
    sym = torch.empty(y.shape, dtype=torch.int32, device=y.device)
    idx = torch.empty(y.shape, dtype=torch.uint8, device=y.device)
    rc = _lib().stem_quantize_and_index_f32(
        y.data_ptr(), means.data_ptr(), scales.data_ptr(), table.data_ptr(),
        table.numel() - 1, float(scale_bound), sym.data_ptr(), idx.data_ptr(),
        y.numel(), _stream(y.device),
    )
    _raise_on(rc, "quantize_and_index")
    LAUNCHES["quantize_and_index"] += 1
    return sym, idx


# ---------------------------------------------------------------------------
# GDN fused into the k5 s2 convs of g_a and g_s (bf16)
# ---------------------------------------------------------------------------


def _gdn_conv_ref(x, gamma_t, beta, weight, bias):
    """Plain form of ``gdn_conv_fused``; mirrors pallas_kernels.py::
    _gdn_conv_ref: GDN in f32 rounded to x's dtype, the k5 s2 conv in x's
    dtype, then the bias in x's dtype. weight (O, C, 5, 5), bias (O,)."""
    y = _gdn_ref(x.float(), gamma_t.float(), beta.float(), False).to(x.dtype)
    out = F.conv2d(y, weight.to(y.dtype), None, 2, 2)
    return (out + bias.to(out.dtype).view(1, -1, 1, 1)).to(x.dtype)


def _igdn_deconv_ref(x, gamma_t, beta, weight, bias):
    """Plain form of the g_s kernels; mirrors pallas_kernels.py::
    _igdn_deconv_ref (of which _igdn_deconv_wide_packed_ref and
    _igdn_deconv_tail_packed_ref are the TPU's packed layouts): IGDN, the
    k5 s2 transposed conv and its bias in f32, one rounding to x's dtype.
    weight (C, O, 5, 5) as ConvTranspose2d stores it, bias (O,)."""
    y = _gdn_ref(x.float(), gamma_t.float(), beta.float(), True)
    return F.conv_transpose2d(y, weight.float(), bias.float(), 2, 2,
                              1).to(x.dtype)


def gdn_conv_supported(in_ch: int, out_ch: int) -> bool:
    return in_ch == out_ch and in_ch in FUSED_CHANNELS


def igdn_deconv_wide_supported(in_ch: int, out_ch: int) -> bool:
    return in_ch == out_ch and in_ch in FUSED_CHANNELS


def igdn_deconv_tail_supported(in_ch: int, out_ch: int) -> bool:
    return in_ch in FUSED_CHANNELS and 1 <= out_ch <= 4


def igdn_deconv_fused_supported(in_ch: int, out_ch: int) -> bool:
    """The narrow kernel's widths: F·4 ≤ 128 GEMM rows, as the JAX gate's
    ``features · stride² ≤ 128`` (pallas_kernels.py:357)."""
    return in_ch in FUSED_CHANNELS and 1 <= out_ch <= 32


def _check_fused(name, x, gamma_t, beta, weight, bias, w_shape, supported):
    """The checks every fused GDN + conv wrapper makes on a CUDA tensor."""
    f32, bf16 = torch.float32, torch.bfloat16
    _check_cuda(name, [(x, bf16), (gamma_t, f32), (beta, f32),
                       (weight, bf16), (bias, f32)])
    if x.dim() != 4:
        raise ValueError(f"{name}: x must be (B, C, H, W), got "
                         f"{tuple(x.shape)}")
    c = x.shape[1]
    if (gamma_t.shape != (c, c) or beta.shape != (c,)
            or weight.shape != w_shape or bias.dim() != 1):
        raise ValueError(
            f"{name}: x {tuple(x.shape)} needs gamma_t ({c}, {c}), beta "
            f"({c},), weight {w_shape} and a bias vector; got "
            f"{tuple(gamma_t.shape)}, {tuple(beta.shape)}, "
            f"{tuple(weight.shape)}, {tuple(bias.shape)}")
    if not supported:
        raise ValueError(f"{name}: no kernel for x {tuple(x.shape)} and "
                         f"weight {tuple(weight.shape)}")


@lru_cache(maxsize=None)
def _tap_index(device):
    """ConvTranspose2d (k5, s2, p2, op1) kernel indexes of the sub-pixel
    form: for output phase a·2 + b and neighbour (dy + 1)·3 + (dx + 1),
    dy, dx ∈ {-1, 0, 1}, the tap ky = a + 2 − 2·dy, kx = b + 2 − 2·dx, or 5
    (a zero row of ``_padded_taps``) past the 5×5 kernel. Returns (ky, kx),
    each (4, 9), on ``device``."""
    ky = torch.empty((4, 9), dtype=torch.long)
    kx = torch.empty((4, 9), dtype=torch.long)
    for a in range(2):
        for b in range(2):
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    tap = (dy + 1) * 3 + (dx + 1)
                    ky[a * 2 + b, tap] = min(a + 2 - 2 * dy, 5)
                    kx[a * 2 + b, tap] = min(b + 2 - 2 * dx, 5)
    return ky.to(device), kx.to(device)


def narrow_rows(f: int) -> int:
    """GEMM rows of the narrow kernel for F outputs: 16 (one m-tile) for
    F ≤ 4, else 4F rounded up to pairs of m-tiles, 32 rows each
    (igdn_deconv.cu::igdn_deconv_narrow_kernel)."""
    return 16 if f <= 4 else 32 * -(-f // 8)


@lru_cache(maxsize=None)
def _narrow_index(device, f: int):
    """The narrow kernel's GEMM rows m = o·4 + a·2 + b (live for o < F, zero
    weights and bias past that) × 9 taps: (ky, kx) (9, rows), the output
    channel of each row (rows,) and the live mask (rows,), on ``device``."""
    ky, kx = _tap_index(device)
    m = torch.arange(narrow_rows(f), device=device)
    live = m < 4 * f
    rows_o = torch.where(live, m // 4, 0)
    ky_m = torch.where(live[:, None], ky[m % 4], 5).t().contiguous()
    kx_m = kx[m % 4].t().contiguous()
    return ky_m, kx_m, rows_o, live


def _padded_taps(weight):
    """(C, O, 5, 5) → (6, 6, O, C) [ky][kx][o][c], row and column 5 zero."""
    c, o = weight.shape[:2]
    wt = weight.new_zeros((6, 6, o, c))
    wt[:5, :5] = weight.permute(2, 3, 1, 0)
    return wt


def _gdn_conv_launch(x, gamma_t, beta, weight, bias):
    c = x.shape[1] if x.dim() == 4 else -1
    o = weight.shape[0]
    _check_fused("gdn_conv_fused", x, gamma_t, beta, weight, bias,
                 (o, c, 5, 5), gdn_conv_supported(c, o))
    b, _, h, w = x.shape
    wp = weight.permute(2, 3, 0, 1).contiguous()  # [ky][kx][o][c]
    out = torch.empty((b, o, (h + 1) // 2, (w + 1) // 2), dtype=x.dtype,
                      device=x.device)
    rc = _lib().stem_gdn_conv_fused_bf16(
        x.data_ptr(), gamma_t.data_ptr(), beta.data_ptr(), wp.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, c, o, h, w, _stream(x.device))
    _raise_on(rc, "gdn_conv_fused")
    LAUNCHES["gdn_conv_fused"] += 1
    return out


def gdn_conv_fused(x, gamma_t, beta, weight, bias):
    """``conv_k5s2(GDN(x)) + b`` on NCHW bf16 x (B, C, H, W) → (B, O,
    ⌈H/2⌉, ⌈W/2⌉) bf16. gamma_t (C, C) = γ transposed and beta (C,) in f32,
    weight (O, C, 5, 5) bf16 (the Conv's own), bias (O,) f32."""
    return _KernelFn.apply("gdn_conv_fused", _gdn_conv_ref, _gdn_conv_launch,
                           x, gamma_t, beta, weight, bias)


def _wide_launch(name, x, gamma_t, beta, weight, bias):
    """The wide IGDN → k5 s2 deconv kernel, counted under ``name``."""
    c = x.shape[1] if x.dim() == 4 else -1
    o = weight.shape[1] if weight.dim() == 4 else -1
    _check_fused(name, x, gamma_t, beta, weight, bias, (c, o, 5, 5),
                 igdn_deconv_wide_supported(c, o))
    b, _, h, w = x.shape
    ky, kx = _tap_index(x.device)
    wp = _padded_taps(weight)[ky, kx]  # (4 phases, 9 taps, O, C)
    out = torch.empty((b, o, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    rc = _lib().stem_igdn_deconv_wide_bf16(
        x.data_ptr(), gamma_t.data_ptr(), beta.data_ptr(), wp.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, c, o, h, w, _stream(x.device))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def _narrow_launch(name, supported, x, gamma_t, beta, weight, bias):
    """The narrow IGDN → k5 s2 deconv kernel (F ≤ 32 outputs), counted
    under ``name``; ``supported(c, f)`` is the wrapper's gate."""
    c = x.shape[1] if x.dim() == 4 else -1
    f = weight.shape[1] if weight.dim() == 4 else -1
    _check_fused(name, x, gamma_t, beta, weight, bias, (c, f, 5, 5),
                 supported(c, f))
    b, _, h, w = x.shape
    ky_m, kx_m, rows_o, live = _narrow_index(x.device, f)
    wp = _padded_taps(weight)[ky_m, kx_m, rows_o]  # (9 taps, rows, C)
    bias_m = torch.where(live, bias[rows_o], 0.0)
    out = torch.empty((b, f, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    rc = _lib().stem_igdn_deconv_narrow_bf16(
        x.data_ptr(), gamma_t.data_ptr(), beta.data_ptr(), wp.data_ptr(),
        bias_m.data_ptr(), out.data_ptr(), b, c, f, narrow_rows(f), h, w,
        _stream(x.device))
    _raise_on(rc, name)
    LAUNCHES[name] += 1
    return out


def igdn_deconv_wide_packed(x, gamma_t, beta, weight, bias):
    """IGDN then the k5 s2 transposed conv N→N on NCHW bf16 x (B, C, H, W)
    → (B, O, 2H, 2W) bf16, the logical layout (the port's counterpart of the
    TPU's phase-major packed output). gamma_t (C, C) and beta (C,) f32,
    weight (C, O, 5, 5) bf16 (the Deconv's own), bias (O,) f32."""
    name = "igdn_deconv_wide_packed"
    return _KernelFn.apply(name, _igdn_deconv_ref,
                           partial(_wide_launch, name),
                           x, gamma_t, beta, weight, bias)


def igdn_deconv_wide(x, gamma_t, beta, weight, bias):
    """The lone wide IGDN → k5 s2 transposed conv N→N (pallas_kernels.py::
    igdn_deconv_wide), NCHW bf16 x (B, C, H, W) → (B, O, 2H, 2W) bf16 in the
    shuffled (logical) layout: the kernel of ``igdn_deconv_wide_packed``,
    counted on its own. Arguments as there."""
    name = "igdn_deconv_wide"
    return _KernelFn.apply(name, _igdn_deconv_ref,
                           partial(_wide_launch, name),
                           x, gamma_t, beta, weight, bias)


def igdn_deconv_tail_packed(x, gamma_t, beta, weight, bias):
    """IGDN then the narrow k5 s2 transposed conv N→F (F ≤ 4, g_s's RGB
    tail) on NCHW bf16 x (B, C, H, W), the output of
    ``igdn_deconv_wide_packed`` → (B, F, 2H, 2W) bf16. gamma_t (C, C) and
    beta (C,) f32, weight (C, F, 5, 5) bf16, bias (F,) f32."""
    name = "igdn_deconv_tail_packed"
    return _KernelFn.apply(
        name, _igdn_deconv_ref,
        partial(_narrow_launch, name, igdn_deconv_tail_supported),
        x, gamma_t, beta, weight, bias)


def igdn_deconv_fused(x, gamma_t, beta, weight, bias):
    """The lone narrow IGDN → k5 s2 transposed conv N→F, F ≤ 32
    (pallas_kernels.py::igdn_deconv_fused), NCHW bf16 x (B, C, H, W) →
    (B, F, 2H, 2W) bf16. gamma_t (C, C) and beta (C,) f32, weight
    (C, F, 5, 5) bf16, bias (F,) f32."""
    name = "igdn_deconv_fused"
    return _KernelFn.apply(
        name, _igdn_deconv_ref,
        partial(_narrow_launch, name, igdn_deconv_fused_supported),
        x, gamma_t, beta, weight, bias)
