"""ctypes bindings for the native rANS coder.

The port's own copy of spatiotemporalentropymodel_tpu/coders/rans.py, cut to
the functions the serving path and the golden-bitstream tests use: the
single-stream indexed coder, the run-based grouped container of the sparse
transport, and the acceleration tables.
"""

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np

from .build import build

_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


@lru_cache(maxsize=1)
def _lib():
    lib = ctypes.CDLL(str(build()))

    lib.stem_pmf_to_quantized_cdf.restype = ctypes.c_int
    lib.stem_pmf_to_quantized_cdf.argtypes = [
        _f64p, ctypes.c_int32, ctypes.c_int32, _i32p,
    ]

    lib.stem_encode_with_indexes.restype = ctypes.c_int64
    lib.stem_encode_with_indexes.argtypes = [
        _i32p, _i32p, ctypes.c_int64, _i32p, ctypes.c_int32, ctypes.c_int32,
        _i32p, _i32p, _u8p, ctypes.c_int64, ctypes.c_void_p,
    ]

    lib.stem_decode_with_indexes.restype = ctypes.c_int
    lib.stem_decode_with_indexes.argtypes = [
        _u8p, ctypes.c_int64, _i32p, ctypes.c_int64, _i32p, ctypes.c_int32,
        ctypes.c_int32, _i32p, _i32p, _i32p,
    ]

    lib.stem_build_enc_table.restype = None
    lib.stem_build_enc_table.argtypes = [
        _i32p, ctypes.c_int32, ctypes.c_int32, _i32p, _u8p,
    ]
    lib.stem_enc_sym_bytes.restype = ctypes.c_int32
    lib.stem_enc_sym_bytes.argtypes = []

    lib.stem_encode_runs.restype = ctypes.c_int64
    lib.stem_encode_runs.argtypes = [
        _i32p, ctypes.c_int64, _i32p, ctypes.c_int32, _i32p, ctypes.c_int32,
        _i32p, _i32p, ctypes.c_void_p, ctypes.c_int32, _u8p, ctypes.c_int64,
    ]

    lib.stem_decode_runs.restype = ctypes.c_int64
    lib.stem_decode_runs.argtypes = [
        _u8p, ctypes.c_int64, _i32p, ctypes.c_int32, ctypes.c_int64, _i32p,
        ctypes.c_int32, _i32p, _i32p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]

    lib.stem_expand_sparse.restype = None
    lib.stem_expand_sparse.argtypes = [
        _u8p, ctypes.c_void_p, ctypes.c_int64, _i32p,
    ]

    lib.stem_decode_with_indexes_lut.restype = ctypes.c_int
    lib.stem_decode_with_indexes_lut.argtypes = [
        _u8p, ctypes.c_int64, _i32p, ctypes.c_int64, _i32p, ctypes.c_int32,
        ctypes.c_int32, _i32p, _i32p, ctypes.c_void_p, ctypes.c_void_p, _i32p,
    ]

    lib.stem_build_lut.restype = None
    lib.stem_build_lut.argtypes = [
        _i32p, ctypes.c_int32, ctypes.c_int32, _i32p,
        np.ctypeslib.ndpointer(dtype=np.int16, flags="C_CONTIGUOUS"),
    ]

    lib.stem_build_dom.restype = None
    lib.stem_build_dom.argtypes = [
        _i32p, ctypes.c_int32, ctypes.c_int32, _i32p, _i32p,
    ]

    return lib


def load() -> None:
    """Build (if needed) and load the coder library; raises on failure."""
    _lib()


def _as_i32(a):
    return np.ascontiguousarray(a, dtype=np.int32)


def pmf_to_quantized_cdf(pmf, precision: int = 16) -> np.ndarray:
    pmf = np.ascontiguousarray(pmf, dtype=np.float64)
    out = np.empty(pmf.shape[0] + 1, dtype=np.int32)
    rc = _lib().stem_pmf_to_quantized_cdf(pmf, pmf.shape[0], precision, out)
    if rc != 0:
        raise ValueError(f"pmf_to_quantized_cdf failed (rc={rc})")
    return out


def _prep(symbols, indexes, cdfs, cdf_lengths, offsets):
    symbols = _as_i32(symbols).reshape(-1)
    indexes = _as_i32(indexes).reshape(-1)
    cdfs = _as_i32(cdfs)
    assert cdfs.ndim == 2
    return symbols, indexes, cdfs, _as_i32(cdf_lengths), _as_i32(offsets)


def build_enc_table(cdfs, cdf_lengths) -> np.ndarray:
    """Reciprocal encoder-symbol table (rows, cols-1) × 24-byte EncSym —
    removes the per-symbol integer division from every encode path while
    emitting byte-identical streams (rans.cpp::enc_put_sym)."""
    cdfs = _as_i32(cdfs)
    lengths = _as_i32(cdf_lengths)
    esym_bytes = int(_lib().stem_enc_sym_bytes())
    out = np.zeros(cdfs.shape[0] * (cdfs.shape[1] - 1) * esym_bytes, np.uint8)
    _lib().stem_build_enc_table(cdfs, cdfs.shape[0], cdfs.shape[1], lengths,
                                out)
    return out


def _esym_ptr(esym):
    return None if esym is None else esym.ctypes.data


def encode_with_indexes(symbols, indexes, cdfs, cdf_lengths, offsets,
                        esym=None) -> bytes:
    symbols, indexes, cdfs, lengths, offs = _prep(
        symbols, indexes, cdfs, cdf_lengths, offsets
    )
    n = symbols.shape[0]
    cap = 4 * n + 1024
    while True:
        out = np.empty(cap, dtype=np.uint8)
        rc = _lib().stem_encode_with_indexes(
            symbols, indexes, n, cdfs, cdfs.shape[0], cdfs.shape[1],
            lengths, offs, out, cap, _esym_ptr(esym),
        )
        if rc >= 0:
            return out[:rc].tobytes()
        cap = -rc  # retry with the exact required size


class DecodeLUT(NamedTuple):
    """Decode acceleration tables: the O(1) direct-lookup table plus the
    per-row dominant-symbol shortcut (rans.cpp::decode_lane `dom` path)."""

    lut: np.ndarray  # (rows, 2^16) int16
    dom: np.ndarray  # (rows, 3) int32 {symbol, cdf[sym], cdf[sym+1]}


def _lut_ptrs(lut):
    if lut is None:
        return None, None
    if isinstance(lut, DecodeLUT):
        return lut.lut.ctypes.data, lut.dom.ctypes.data
    return lut.ctypes.data, None  # bare (rows, 2^16) array


def build_lut(cdfs, cdf_lengths) -> DecodeLUT:
    """Decode acceleration tables (O(1) lookup + dominant-symbol shortcut)."""
    cdfs = _as_i32(cdfs)
    lengths = _as_i32(cdf_lengths)
    lut = np.zeros((cdfs.shape[0], 1 << 16), np.int16)
    _lib().stem_build_lut(cdfs, cdfs.shape[0], cdfs.shape[1], lengths, lut)
    dom = np.zeros((cdfs.shape[0], 3), np.int32)
    _lib().stem_build_dom(cdfs, cdfs.shape[0], cdfs.shape[1], lengths, dom)
    return DecodeLUT(lut, dom)


def decode_with_indexes(data: bytes, indexes, cdfs, cdf_lengths, offsets,
                        lut=None):
    indexes = _as_i32(indexes).reshape(-1)
    cdfs = _as_i32(cdfs)
    lengths, offs = _as_i32(cdf_lengths), _as_i32(offsets)
    n = indexes.shape[0]
    out = np.empty(n, dtype=np.int32)
    buf = np.frombuffer(data, dtype=np.uint8)
    lut_ptr, dom_ptr = _lut_ptrs(lut)
    if lut_ptr is not None:
        rc = _lib().stem_decode_with_indexes_lut(
            buf, buf.shape[0], indexes, n, cdfs, cdfs.shape[0], cdfs.shape[1],
            lengths, offs, lut_ptr, dom_ptr, out,
        )
    else:
        rc = _lib().stem_decode_with_indexes(
            buf, buf.shape[0], indexes, n, cdfs, cdfs.shape[0], cdfs.shape[1],
            lengths, offs, out,
        )
    if rc != 0:
        raise ValueError(f"rans decode failed (rc={rc})")
    return out


def encode_runs(symbols, counts, cdfs, cdf_lengths, offsets,
                esym=None) -> bytes:
    """Encode grouped-by-CDF-row symbols; rows derive from the run-length
    `counts` (levels,) vector — no per-symbol index array. One lane: the
    single-stream container of the JAX package's "rans" coder
    (rans.cpp::stem_encode_runs)."""
    symbols = _as_i32(symbols).reshape(-1)
    counts = _as_i32(counts).reshape(-1)
    cdfs = _as_i32(cdfs)
    lengths, offs = _as_i32(cdf_lengths), _as_i32(offsets)
    n = symbols.shape[0]
    n_lanes = 1
    cap = 4 * n + 64 * n_lanes + 1024
    while True:
        out = np.empty(cap, dtype=np.uint8)
        rc = _lib().stem_encode_runs(
            symbols, n, counts, counts.shape[0], cdfs, cdfs.shape[1],
            lengths, offs, _esym_ptr(esym), n_lanes, out, cap,
        )
        if rc >= 0:
            return out[:rc].tobytes()
        if rc in (-1, -3):
            raise ValueError(f"encode_runs failed (rc={rc})")
        cap = -rc


def decode_runs(data: bytes, counts, n: int, cdfs, cdf_lengths, offsets,
                lut=None):
    """Decode a run-based container → dense int32 symbols (n,)."""
    counts = _as_i32(counts).reshape(-1)
    cdfs = _as_i32(cdfs)
    lengths, offs = _as_i32(cdf_lengths), _as_i32(offsets)
    out = np.empty(n, dtype=np.int32)
    buf = np.frombuffer(data, dtype=np.uint8)
    lut_ptr, dom_ptr = _lut_ptrs(lut)
    rc = _lib().stem_decode_runs(
        buf, buf.shape[0], counts, counts.shape[0], n, cdfs, cdfs.shape[1],
        lengths, offs, lut_ptr, dom_ptr, out.ctypes.data, None, None, 0,
    )
    if rc < 0:
        raise ValueError(f"run-based rans decode failed (rc={rc})")
    return out


def decode_runs_packed(data: bytes, counts, n: int, cap: int, cdfs,
                       cdf_lengths, offsets, lut=None):
    """Decode a run-based container straight into the decode-payload format:
    (maskbits u8 (n/8,), values i8 (cap,), nz). Returns None on values-plane
    overflow (caller falls back to the dense path)."""
    counts = _as_i32(counts).reshape(-1)
    cdfs = _as_i32(cdfs)
    lengths, offs = _as_i32(cdf_lengths), _as_i32(offsets)
    maskbits = np.empty((n + 7) // 8, dtype=np.uint8)
    values = np.zeros(cap, dtype=np.int8)
    buf = np.frombuffer(data, dtype=np.uint8)
    lut_ptr, dom_ptr = _lut_ptrs(lut)
    rc = _lib().stem_decode_runs(
        buf, buf.shape[0], counts, counts.shape[0], n, cdfs, cdfs.shape[1],
        lengths, offs, lut_ptr, dom_ptr, None, maskbits.ctypes.data,
        values.ctypes.data, int(cap),
    )
    if rc == -5:
        return None
    if rc < 0:
        raise ValueError(f"run-based packed decode failed (rc={rc})")
    return maskbits, values, int(rc)


def expand_sparse(maskbits, values, n: int) -> np.ndarray:
    """(bitmask, compacted int8 values) → dense int32 symbols (n,)."""
    maskbits = np.ascontiguousarray(maskbits, np.uint8).reshape(-1)
    values = np.ascontiguousarray(values, np.int8).reshape(-1)
    out = np.empty(n, dtype=np.int32)
    _lib().stem_expand_sparse(maskbits, values.ctypes.data, n, out)
    return out
