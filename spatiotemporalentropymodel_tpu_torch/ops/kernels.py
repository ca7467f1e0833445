"""The f32 serving path's two kernels: CUDA wrappers and their plain versions.

Counterpart of spatiotemporalentropymodel_tpu/ops/pallas_kernels.py for the
two Pallas kernels that the f32 P-frame path engages:

  * ``gdn_fused``          — GDN/IGDN ``x · rsqrt(β + x²·γᵀ)`` (``sqrt`` for
    IGDN) over the channel axis, f32 math (``_gdn_ref`` is the plain form).
  * ``quantize_and_index`` — (y, μ, σ) → int32 saturated symbols and uint8
    CDF-row indexes (``_qidx_ref`` is the plain form).

Each wrapper launches its hand-written kernel (csrc/kernels.cu) for a CUDA
tensor and runs the plain PyTorch version only for a tensor on the CPU, where
the tests run. On a CUDA tensor it launches or raises; it never falls back.
``LAUNCHES`` counts the launches per kernel, so a caller can show that a path
went through the kernels. The kernels' layout is the port's: channel-second
(NCHW) for GDN, any layout for the elementwise quantizer.
"""

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..entropy.base import SYMBOL_MAX

# launches per kernel; each wrapper adds one where it launches, nowhere else
LAUNCHES = {"gdn_fused": 0, "quantize_and_index": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@lru_cache(maxsize=1)
def _lib():
    from .build import build

    lib = ctypes.CDLL(str(build()))
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.stem_gdn_fused_f32.restype = i32
    lib.stem_gdn_fused_f32.argtypes = [vp, vp, vp, vp, i64, i32, i64, i32, vp]
    lib.stem_quantize_and_index_f32.restype = i32
    lib.stem_quantize_and_index_f32.argtypes = [
        vp, vp, vp, vp, i32, ctypes.c_float, vp, vp, i64, vp,
    ]
    return lib


def load() -> None:
    """Build (if needed) and load the kernel library."""
    _lib()


def _check_cuda(name, *tensors):
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expected float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


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


def gdn_fused(x, gamma_t, beta, inverse: bool = False):
    """Fused GDN over channel-second x (B, C, ...). gamma_t is (in, out) =
    γ transposed; beta is (C,). Output has x's shape and dtype."""
    if x.device.type == "cpu":
        return _gdn_ref(x.float(), gamma_t.float(), beta.float(),
                        inverse).to(x.dtype)
    if x.device.type != "cuda":
        raise ValueError(f"gdn_fused: unsupported device {x.device}")
    _check_cuda("gdn_fused", x, gamma_t, beta)
    b, c = x.shape[0], x.shape[1]
    if gamma_t.shape != (c, c) or beta.shape != (c,):
        raise ValueError(
            f"gdn_fused: x {tuple(x.shape)} needs gamma_t ({c}, {c}) and "
            f"beta ({c},), got {tuple(gamma_t.shape)}, {tuple(beta.shape)}"
        )
    out = torch.empty_like(x)
    p = x.numel() // max(b * c, 1)
    rc = _lib().stem_gdn_fused_f32(
        x.data_ptr(), gamma_t.data_ptr(), beta.data_ptr(), out.data_ptr(),
        b, c, p, int(bool(inverse)), _stream(x.device),
    )
    _raise_on(rc, "gdn_fused")
    LAUNCHES["gdn_fused"] += 1
    return out


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
    _check_cuda("quantize_and_index", y, means, scales, table)
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
