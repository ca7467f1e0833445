"""The serving paths' kernels: CUDA wrappers and their plain versions.

Counterpart of spatiotemporalentropymodel_tpu/ops/pallas_kernels.py, one
wrapper per Pallas kernel:

  * ``gdn_fused``          — GDN/IGDN ``x · rsqrt(β + x²·γᵀ)`` (``sqrt`` for
    IGDN) over the channel axis, f32 math, f32 or bf16 I/O (``_gdn_ref`` is
    the plain form).
  * ``quantize_and_index`` — (y, μ, σ), f32 or bf16, → int32 saturated
    symbols and uint8 CDF-row indexes (``_qidx_ref`` is the plain form).
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

And two kernels with no Pallas counterpart (the JAX package left f32
convs and transposed convs to XLA):

  * ``deconv_k5s2_f32``    — the k5 s2 transposed conv + bias in f32 FMA on
    the CUDA cores, g_s's f32 Deconvs (``_deconv_k5s2_plain``, its four
    sub-pixel phase convs).
  * ``conv_k5s2_f32``      — the k5 s2 conv + bias in f32 FMA on the CUDA
    cores, g_a's f32 Convs (``_conv_k5s2_plain``, its four parity-plane
    convs).

Each wrapper launches its hand-written kernel (csrc/*.cu) for a CUDA
tensor and runs the plain PyTorch version only for a tensor on the CPU, where
the tests run. On a CUDA tensor it launches or raises; it never falls back.
``LAUNCHES`` counts the launches per kernel (the bf16 entries of
``gdn_fused`` and ``quantize_and_index`` as ``gdn_fused_bf16`` and
``quantize_and_index_bf16``), so a caller can show that a path went through
the kernels; ``LAUNCHES_BY_WIDTH`` splits the same launches by channel
widths. The kernels' layout is the port's: channel-second (NCHW) for
the GDN and conv kernels; the elementwise quantizer takes any shape whose
batch items (dimension 0) are each contiguous.

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
    "quantize_and_index_bf16": 0,
    "gdn_conv_fused": 0,
    "igdn_deconv_wide_packed": 0,
    "igdn_deconv_tail_packed": 0,
    "igdn_deconv_fused": 0,
    "igdn_deconv_wide": 0,
    "deconv_k5s2_f32": 0,
    "conv_k5s2_f32": 0,
}

# launches per (kernel, its channel widths): the same launches as LAUNCHES,
# split by the widths (C for gdn_fused, (C, O) for the GDN + conv kernels,
# none for quantize_and_index), so a path's count at one model width shows
LAUNCHES_BY_WIDTH = {}


def _count(name, *widths) -> None:
    """One launch of kernel ``name`` at ``widths``: the one place a wrapper
    counts it."""
    LAUNCHES[name] += 1
    key = (name, *widths)
    LAUNCHES_BY_WIDTH[key] = LAUNCHES_BY_WIDTH.get(key, 0) + 1


# channel counts the fused GDN + conv kernels are instantiated for
# (gdn_conv.cu, igdn_deconv.cu); ``gdn_fused`` takes any C
FUSED_CHANNELS = (64, 128, 192, 256)

# (C, O) pairs ``gdn_conv_fused`` is instantiated for (gdn_conv.cu): C = O
# at each width, and g_a's last stage of the N = 128, M = 192, the
# N = 192, M = 320 and the N = 256, M = 320 models
GDN_CONV_PAIRS = ((64, 64), (128, 128), (192, 192), (256, 256), (128, 192),
                  (192, 320), (256, 320))

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
    LAUNCHES_BY_WIDTH.clear()


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
    for name in ("stem_deconv_k5s2_f32", "stem_conv_k5s2_f32"):
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = [vp] * 4 + [i64, i32, i32, i32, i32, vp]
    for _, name in _QIDX_ENTRIES.values():
        getattr(lib, name).restype = i32
        getattr(lib, name).argtypes = (
            [vp] * 3 + [i64] * 5 + [vp, i32, ctypes.c_float, vp, vp, vp])
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
    """The raw handle of the current stream on ``device`` (a tensor's, so
    it has an index), as PyTorch's generated kernels read it:
    ``torch.cuda.current_stream()`` builds a Stream object per call, about
    6 µs more host time per wrapper call on an H100 machine (PERF.md §6)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _on_card(device, launch, *args):
    """launch(*args) with ``device`` the current card. The kernels launch
    through the CUDA runtime, which sends a launch to the current card
    whatever card its tensors and stream are on, so a tensor on another card
    than the current one (a mesh's shard on cuda:1) makes its card current
    for the launch and restores the previous one after."""
    if device.index == torch.cuda.current_device():
        return launch(*args)
    with torch.cuda.device(device):
        return launch(*args)


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
        return _on_card(x.device, launch, *inputs)

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
    p = x.numel() // max(b * c, 1)
    cp = -(-c // 64) * 64  # the kernel's channels: a multiple of 64
    xk = x.reshape(b, c, p)
    if cp != c:  # zero channels: no x², no output, β = 1 keeps rsqrt finite
        xk = F.pad(xk, (0, 0, 0, cp - c))
        gamma_t = F.pad(gamma_t, (0, cp - c, 0, cp - c))
        beta = F.pad(beta, (0, cp - c), value=1.0)
    # γ in as many bf16 pieces as x² needs: 2 for a bf16 x, 3 for an f32 x
    gamma = split_gamma_pieces(gamma_t, 2 if io == torch.bfloat16 else 3)
    out = torch.empty_like(xk)
    rc = entry(
        xk.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
        b, cp, p, int(bool(inverse)), _stream(x.device),
    )
    _raise_on(rc, name)
    _count(name, c)
    return out[:, :c].reshape(x.shape) if cp != c else out.view(x.shape)


def gdn_fused(x, gamma_t, beta, inverse: bool = False):
    """Fused GDN over channel-second x (B, C, ...), f32 or bf16. gamma_t is
    (in, out) = γ transposed and beta is (C,), both f32 on the card. Output
    has x's shape and dtype; the math is f32. The card's kernel takes any
    C that is a multiple of 64 and any batch; other C run zero-padded to
    the next multiple of 64."""
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


def _qidx_plain(y, means, scales, table, scale_bound):
    """``quantize_and_index``'s plain version: ``_qidx_ref`` on f32 casts of
    the inputs, as the JAX wrapper casts them (pallas_kernels.py:223-225)."""
    return _qidx_ref(y.float(), means.float(), scales.float(), table.float(),
                     scale_bound)


def scale_table_tensor(table, device) -> torch.Tensor:
    """The scale table as the f32 tensor the quantizer compares against
    (pallas_kernels.py:217 casts it to f32 the same way). The kernel's
    search counts #{t < σ} only over a non-decreasing table, so this
    raises on any other."""
    t = np.asarray(table, np.float32)
    if t.ndim != 1 or not np.all(t[1:] >= t[:-1]):  # a NaN fails too
        raise ValueError("quantize_and_index: the scale table must be a "
                         "non-decreasing vector")
    return torch.as_tensor(t, device=device)


# the quantizer's LAUNCHES name and C entry per input dtype
# (kernels.cu::launch_qidx)
_QIDX_ENTRIES = {
    torch.float32: ("quantize_and_index",
                    "stem_quantize_and_index_f32_strided"),
    torch.bfloat16: ("quantize_and_index_bf16",
                     "stem_quantize_and_index_bf16"),
}
_QIDX_MAX_ROWS = 65535  # the kernel's grid.y


@lru_cache(maxsize=64)
def _contiguous_strides(shape):
    """The strides PyTorch gives a contiguous tensor of ``shape``."""
    strides, step = [], 1
    for size in reversed(shape):
        strides.append(step)
        step *= max(size, 1)
    return tuple(reversed(strides))


def _qidx_rows(tensors, n, strides):
    """(rows, per, [(tensor, batch stride)]): the kernel's rows of the n
    elements of each tensor, where ``strides`` are the contiguous strides
    of their shape. A tensor goes as it is where it is contiguous or where
    each batch item (dimension 0) is; else as a contiguous copy. All go as
    one row of n where each is contiguous."""
    rows = tensors[0].shape[0] if strides else 1
    per = n // rows
    strided, one_row = [], True
    for t in tensors:
        st = t.stride()
        if st == strides:
            strided.append((t, per))
            continue
        if rows <= _QIDX_MAX_ROWS and st[1:] == strides[1:]:
            stride = st[0]
        else:  # (a tensor contiguous but for a size-1 dimension's stride
            t, stride = t.contiguous(), per  # comes back as it is)
        strided.append((t, stride))
        one_row = one_row and stride == per
    # one row where all are contiguous: the fewest scalar edges
    return (1, n, strided) if one_row else (rows, per, strided)


def quantize_and_index(y, means, scales, table, scale_bound: float = 0.11):
    """(y, μ, σ) → (int32 symbols, uint8 CDF-row indexes), elementwise, in
    y's shape.

    y, μ and σ share one dtype, f32 or bf16; the math is f32, as after the
    JAX wrapper's casts (bf16 → f32 is exact). On the card each batch item
    (dimension 0) of each input must be contiguous, or it is copied: the
    two channel-halves of a (B, 2M, H, W) tensor from ``chunk`` go in as
    they are. ``table``: the f32 scale table (see ``scale_table_tensor``)
    on y's device; passing it ready avoids an upload (and a stream sync)
    per call.
    """
    if not y.dtype == means.dtype == scales.dtype in _QIDX_ENTRIES:
        raise TypeError(f"quantize_and_index: y, means, scales must share "
                        f"f32 or bf16, got {y.dtype}, {means.dtype}, "
                        f"{scales.dtype}")
    if not isinstance(table, torch.Tensor):
        table = scale_table_tensor(table, y.device)
    if y.is_cuda:
        return _on_card(y.device, _qidx_launch, y, means, scales, table,
                        scale_bound)
    if y.device.type == "cpu":
        return _qidx_plain(y, means, scales, table, scale_bound)
    raise ValueError(f"quantize_and_index: unsupported device {y.device}")


def _qidx_launch(y, means, scales, table, scale_bound):
    """The kernel on CUDA tensors. The host time before the launch is what
    a lone call adds to the kernel's, so the checks are the few that keep
    the kernel's memory accesses in bounds, and the outputs' views are cut
    after the launch."""
    name, entry = _QIDX_ENTRIES[y.dtype]
    dev = y.get_device()
    if not means.get_device() == scales.get_device() == table.get_device() \
            == dev:
        raise ValueError("quantize_and_index: tensors on different devices")
    if table.dtype != torch.float32 or not table.is_contiguous():
        raise TypeError("quantize_and_index: the table must be contiguous "
                        "f32")
    shape = y.shape
    if means.shape != shape or scales.shape != shape:
        raise ValueError("quantize_and_index: y, means, scales must match")
    levels = table.numel() - 1
    if not 0 <= levels <= 255:
        raise ValueError("quantize_and_index: scale table of 1..256 entries")
    n = y.numel()
    strides = _contiguous_strides(shape)
    # one allocation: the symbols, then the indexes from a 16-byte boundary
    # (the kernel stores 16-byte and 8-byte words)
    off = -(-4 * n // 16) * 16
    buf = torch.empty(off + -(-n // 16) * 16, dtype=torch.uint8,
                      device=y.device)
    if n:
        rows, per, ((yk, ys), (mk, ms), (sk, ss)) = _qidx_rows(
            (y, means, scales), n, strides)
        ptr = buf.data_ptr()
        rc = getattr(_lib(), entry)(
            yk.data_ptr(), mk.data_ptr(), sk.data_ptr(), rows, per, ys, ms,
            ss, table.data_ptr(), levels, float(scale_bound), ptr, ptr + off,
            _stream(y.device))
        _raise_on(rc, name)
        _count(name)
    return (buf.view(torch.int32).as_strided(shape, strides),
            buf.as_strided(shape, strides, off))


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
    return (in_ch, out_ch) in GDN_CONV_PAIRS


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
    """GEMM rows of the narrow kernel for F outputs, its wgmma width N: 16
    for F ≤ 4, else 4F rounded up to a multiple of 32
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


def split_gamma(gamma_t):
    """γᵀ (C, C) f32 → γ's split for the tensor-core norm (gdn_window_tc.cuh),
    (C/32, C, 64) bf16: stage k, row o holds hi = bf16(γ[o][i]) for the 32
    input channels i = 32k .. 32k + 31, then lo = bf16(γ[o][i] − hi), so
    hi + lo is γ to 2⁻¹⁶ relative."""
    g = gamma_t.t().float()
    hi = g.to(torch.bfloat16)
    lo = (g - hi.float()).to(torch.bfloat16)
    c = g.shape[0]
    return torch.cat([hi.reshape(c, c // 32, 32), lo.reshape(c, c // 32, 32)],
                     dim=2).permute(1, 0, 2).contiguous()


def split_gamma_pieces(gamma_t, k: int):
    """γᵀ (C, C) f32 → γ in k bf16 pieces for ``gdn_fused``
    (kernels.cu::gdn_kernel), (C/64 · k, C, 64): stage kc·k + j, row o
    holds piece j of γ[o][i] for the 64 input channels i = 64·kc ..
    64·kc + 63. Piece j is the bf16 rounding of what pieces 0 .. j − 1
    leave, so with k = 3 they sum to γ exactly (an f32 has 24 significant
    bits, a bf16 8) and with k = 2 to γ within 2⁻¹⁶ relative."""
    c = gamma_t.shape[0]
    out = torch.empty((c // 64, k, c, 64), dtype=torch.bfloat16,
                      device=gamma_t.device)
    dst = out.permute(1, 0, 3, 2)  # [j][kc][i % 64][o]
    rest = gamma_t.float().view(c // 64, 64, c)  # γᵀ[i][o] as [kc][i % 64][o]
    for j in range(k):  # 2k − 1 kernels: each launch costs host time
        dst[j].copy_(rest)
        if j + 1 < k:
            rest = rest - dst[j]
    return out.view(k * (c // 64), c, 64)


def _stage_major(taps):
    """(T, O, C) per-tap weights → (T, C/64, O, 64): one ring stage (64
    input channels of one tap, all O rows) after another."""
    t, o, c = taps.shape
    return taps.reshape(t, o, c // 64, 64).permute(0, 2, 1, 3).contiguous()


def pack_conv_weight(weight):
    """Conv2d weight (O, C, 5, 5) → ``gdn_conv_fused``'s (25, C/64, O, 64),
    taps ky·5 + kx."""
    o, c = weight.shape[:2]
    return _stage_major(weight.permute(2, 3, 0, 1).reshape(25, o, c))


def wide_taps():
    """The wide kernel's 25 taps in its order: phase a·2 + b, then dy, then
    dx (dy from −1 for a = 0, from 0 for a = 1; dx likewise with b), each as
    (phase, dy, dx, ky, kx) with ky = a + 2 − 2·dy and kx = b + 2 − 2·dx
    (igdn_deconv.cu::igdn_deconv_wide_kernel)."""
    taps = []
    for ph in range(4):
        a, b = ph >> 1, ph & 1
        for dy in range(-1 + a, 2):
            for dx in range(-1 + b, 2):
                taps.append((ph, dy, dx, a + 2 - 2 * dy, b + 2 - 2 * dx))
    return taps


def pack_wide_weight(weight):
    """ConvTranspose2d weight (C, O, 5, 5) → the wide kernel's
    (25, C/64, O, 64), taps in ``wide_taps()`` order."""
    _, _, _, ky, kx = zip(*wide_taps())
    return _stage_major(weight.permute(2, 3, 1, 0)[list(ky), list(kx)])


def _gdn_conv_launch(x, gamma_t, beta, weight, bias):
    c = x.shape[1] if x.dim() == 4 else -1
    o = weight.shape[0]
    _check_fused("gdn_conv_fused", x, gamma_t, beta, weight, bias,
                 (o, c, 5, 5), gdn_conv_supported(c, o))
    b, _, h, w = x.shape
    gs, wp = split_gamma(gamma_t), pack_conv_weight(weight)
    out = torch.empty((b, o, (h + 1) // 2, (w + 1) // 2), dtype=x.dtype,
                      device=x.device)
    rc = _lib().stem_gdn_conv_fused_bf16(
        x.data_ptr(), gs.data_ptr(), beta.data_ptr(), wp.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, c, o, h, w, _stream(x.device))
    _raise_on(rc, "gdn_conv_fused")
    _count("gdn_conv_fused", c, o)
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
    gs, wp = split_gamma(gamma_t), pack_wide_weight(weight)
    out = torch.empty((b, o, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    rc = _lib().stem_igdn_deconv_wide_bf16(
        x.data_ptr(), gs.data_ptr(), beta.data_ptr(), wp.data_ptr(),
        bias.data_ptr(), out.data_ptr(), b, c, o, h, w, _stream(x.device))
    _raise_on(rc, name)
    _count(name, c, o)
    return out


def _narrow_taps(weight):
    """ConvTranspose2d weight (C, F, 5, 5) → the narrow kernel's GEMM
    weights per tap, (9, rows, C): row o·4 + a·2 + b of tap (dy + 1)·3 +
    (dx + 1), zero past 4F and where the tap is past the 5×5 kernel."""
    ky_m, kx_m, rows_o, _ = _narrow_index(weight.device, weight.shape[1])
    return _padded_taps(weight)[ky_m, kx_m, rows_o]


def pack_narrow_weight(weight):
    """ConvTranspose2d weight (C, F, 5, 5) → the narrow kernel's
    (9, C/64, rows, 64): one ring stage (64 input channels of one tap, all
    rows) after another (igdn_deconv.cu::igdn_deconv_narrow_kernel)."""
    return _stage_major(_narrow_taps(weight))


def _narrow_launch(name, supported, x, gamma_t, beta, weight, bias):
    """The narrow IGDN → k5 s2 deconv kernel (F ≤ 32 outputs), counted
    under ``name``; ``supported(c, f)`` is the wrapper's gate."""
    c = x.shape[1] if x.dim() == 4 else -1
    f = weight.shape[1] if weight.dim() == 4 else -1
    _check_fused(name, x, gamma_t, beta, weight, bias, (c, f, 5, 5),
                 supported(c, f))
    b, _, h, w = x.shape
    _, _, rows_o, live = _narrow_index(x.device, f)
    gs, wp = split_gamma(gamma_t), pack_narrow_weight(weight)
    bias_m = torch.where(live, bias[rows_o], 0.0)
    out = torch.empty((b, f, 2 * h, 2 * w), dtype=x.dtype, device=x.device)
    rc = _lib().stem_igdn_deconv_narrow_bf16(
        x.data_ptr(), gs.data_ptr(), beta.data_ptr(), wp.data_ptr(),
        bias_m.data_ptr(), out.data_ptr(), b, c, f, narrow_rows(f), h, w,
        _stream(x.device))
    _raise_on(rc, name)
    _count(name, c, f)
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


# ---------------------------------------------------------------------------
# the k5 s2 transposed conv of g_s, f32 (no Pallas counterpart)
# ---------------------------------------------------------------------------


def deconv_k5s2_f32_supported(in_ch: int, out_ch: int) -> bool:
    """The widths deconv_f32.cu takes: O a multiple of 32 with C a multiple
    of 16 (the wide variant, g_s's N → N), or 1 ≤ O ≤ 3 with C a multiple
    of 8 (the narrow one, g_s's N → 3): C in whole stages."""
    if in_ch <= 0:
        return False
    if out_ch > 0 and out_ch % 32 == 0:
        return in_ch % 16 == 0
    return 1 <= out_ch <= 3 and in_ch % 8 == 0


def _phase_taps(a: int):
    """(kernel indexes, first row of the 1-padded input) of output phase a
    along one axis: rows i − 1, i, i + 1 take ky = 4, 2, 0 for a = 0; rows
    i, i + 1 take ky = 3, 1 for a = 1 (ky = a + 2 − 2·dy)."""
    return ([4, 2, 0], 0) if a == 0 else ([3, 1], 1)


def _deconv_k5s2_plain(x, weight, bias):
    """``deconv_k5s2_f32``'s plain version: ConvTranspose2d(k5, s2, p2,
    op1) as the kernel computes it, four stride-1 convs over the input
    padded by one, one per output phase (a, b) with 3×3, 3×2, 2×3 and 2×2
    taps, interleaved into (B, O, 2H, 2W); then the bias. weight (C, O, 5,
    5) as ConvTranspose2d stores it, bias (O,)."""
    b_, _, h, w = x.shape
    xp = F.pad(x, (1, 1, 1, 1))
    rows = []
    for a in range(2):
        ky, r0 = _phase_taps(a)
        cols = []
        for b in range(2):
            kx, c0 = _phase_taps(b)
            k = weight[:, :, ky][:, :, :, kx].transpose(0, 1)
            cols.append(F.conv2d(xp[:, :, r0:, c0:], k))
        rows.append(torch.stack(cols, dim=-1))  # (B, O, H, W, 2)
    out = torch.stack(rows, dim=3).reshape(b_, -1, 2 * h, 2 * w)
    return out + bias.to(out.dtype).view(1, -1, 1, 1)


def pack_deconv_f32_weight(weight):
    """ConvTranspose2d weight (C, O, 5, 5) → deconv_f32.cu's (C, 25, opad):
    [c][ky·5 + kx], then the output channels in groups of Q (4 for O a
    multiple of 32, else 3, one group), each group padded to 4 with zeros."""
    c, o = weight.shape[:2]
    taps = weight.permute(0, 2, 3, 1).reshape(c, 25, o)
    if o % 32 == 0:
        return taps.contiguous()
    return F.pad(taps, (0, 4 - o))


def _deconv_launch(x, weight, bias):
    name = "deconv_k5s2_f32"
    f32 = torch.float32
    _check_cuda(name, [(x, f32), (weight, f32), (bias, f32)])
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"{name}: x (B, C, H, W) and weight (C, O, 5, 5), "
                         f"got {tuple(x.shape)}, {tuple(weight.shape)}")
    b, c, h, w = x.shape
    o = weight.shape[1]
    if (weight.shape != (c, o, 5, 5) or bias.shape != (o,)
            or not deconv_k5s2_f32_supported(c, o) or b > 65535):
        raise ValueError(f"{name}: no kernel for x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)} and bias {tuple(bias.shape)}")
    wk = pack_deconv_f32_weight(weight)
    out = torch.empty((b, o, 2 * h, 2 * w), dtype=f32, device=x.device)
    rc = _lib().stem_deconv_k5s2_f32(
        x.data_ptr(), wk.data_ptr(), bias.data_ptr(), out.data_ptr(), b, c,
        o, h, w, _stream(x.device))
    _raise_on(rc, name)
    _count(name, c, o)
    return out


def deconv_k5s2_f32(x, weight, bias):
    """ConvTranspose2d(k5, s2, padding 2, output_padding 1) + bias on NCHW
    f32 x (B, C, H, W) → (B, O, 2H, 2W) f32, in f32 FMA on the CUDA cores
    (deconv_f32.cu). weight (C, O, 5, 5) and bias (O,) f32, the Deconv's
    own; the widths ``deconv_k5s2_f32_supported`` names."""
    return _KernelFn.apply("deconv_k5s2_f32", _deconv_k5s2_plain,
                           _deconv_launch, x, weight, bias)


# ---------------------------------------------------------------------------
# the k5 s2 conv of g_a, f32 (no Pallas counterpart)
# ---------------------------------------------------------------------------


def conv_k5s2_f32_supported(in_ch: int, out_ch: int) -> bool:
    """The widths the port routes to conv_f32.cu: O a multiple of 32 (the
    kernel's channel blocks), with C = 3 (the narrow variant, g_a's first
    conv) or C a multiple of 16 (the wide one, g_a's N → N and N → M, which
    takes C in stages of 8)."""
    if out_ch <= 0 or out_ch % 32:
        return False
    return in_ch == 3 or (in_ch > 0 and in_ch % 16 == 0)


def _conv_k5s2_plain(x, weight, bias):
    """``conv_k5s2_f32``'s plain version: Conv2d(k5, s2, p2) as four
    stride-1 convs, one per parity plane (r, s) of the input padded by two,
    with the kernel's taps ky ≡ r, kx ≡ s (mod 2): 3×3, 3×2, 2×3 and 2×2
    taps, summed into (B, O, ⌈H/2⌉, ⌈W/2⌉); then the bias. weight (O, C, 5,
    5) as Conv2d stores it, bias (O,)."""
    h, w = x.shape[-2:]
    ho, wo = (h + 1) // 2, (w + 1) // 2
    xp = F.pad(x, (2, 2, 2, 2))
    out = 0
    for r in range(2):
        for s in range(2):
            out = out + F.conv2d(xp[:, :, r::2, s::2],
                                 weight[:, :, r::2, s::2])[..., :ho, :wo]
    return out + bias.to(out.dtype).view(1, -1, 1, 1)


def pack_conv_f32_weight(weight):
    """Conv2d weight (O, C, 5, 5) → conv_f32.cu's (C, 25, O): [c][ky·5 +
    kx][o]."""
    o, c = weight.shape[:2]
    return weight.permute(1, 2, 3, 0).reshape(c, 25, o).contiguous()


def _conv_launch(x, weight, bias):
    name = "conv_k5s2_f32"
    f32 = torch.float32
    _check_cuda(name, [(x, f32), (weight, f32), (bias, f32)])
    if x.dim() != 4 or weight.dim() != 4:
        raise ValueError(f"{name}: x (B, C, H, W) and weight (O, C, 5, 5), "
                         f"got {tuple(x.shape)}, {tuple(weight.shape)}")
    b, c, h, w = x.shape
    o = weight.shape[0]
    if (weight.shape != (o, c, 5, 5) or bias.shape != (o,)
            or not conv_k5s2_f32_supported(c, o) or b > 65535):
        raise ValueError(f"{name}: no kernel for x {tuple(x.shape)}, weight "
                         f"{tuple(weight.shape)} and bias {tuple(bias.shape)}")
    wk = pack_conv_f32_weight(weight)
    out = torch.empty((b, o, (h + 1) // 2, (w + 1) // 2), dtype=f32,
                      device=x.device)
    rc = _lib().stem_conv_k5s2_f32(
        x.data_ptr(), wk.data_ptr(), bias.data_ptr(), out.data_ptr(), b, c,
        o, h, w, _stream(x.device))
    _raise_on(rc, name)
    _count(name, c, o)
    return out


def conv_k5s2_f32(x, weight, bias):
    """Conv2d(k5, s2, padding 2) + bias on NCHW f32 x (B, C, H, W) → (B, O,
    ⌈H/2⌉, ⌈W/2⌉) f32, in f32 FMA on the CUDA cores (conv_f32.cu). weight
    (O, C, 5, 5) and bias (O,) f32, the Conv's own; the widths
    ``conv_k5s2_f32_supported`` names."""
    return _KernelFn.apply("conv_k5s2_f32", _conv_k5s2_plain, _conv_launch,
                           x, weight, bias)
