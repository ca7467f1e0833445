"""ctypes bindings for the native rANS coder.

The port's own copy of spatiotemporalentropymodel_tpu/coders/rans.py: the
single-stream indexed coder, the interleaved multi-lane container, the
run-based grouped container of the sparse transport, the acceleration
tables, and the stateful stream decoder with the segmented run encoder of
the autoregressive (wavefront and serial) codecs.

The module itself is the ``"rans"`` coder of ``coders.get_coder``: its
capability flags below are the ones the transport and the AR codecs branch
on (the JAX package's ``NativeCoder``). The single-stream container is
bitstream-compatible with the reference's ``compressai.ans``.
"""

import ctypes
from functools import lru_cache
from typing import NamedTuple

import numpy as np

from .build import build

_i32p = np.ctypeslib.ndpointer(dtype=np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")

# the coder surface (coders/__init__.py of the JAX package, NativeCoder)
name = "rans"
supports_lut = True
# the run-based grouped container (counts-derived rows, chunked lanes, the
# fused packed decode): the sparse transport's fast path
supports_runs = True
# segmented single-stream run coding (the wavefront v2 order)
supports_stream_runs = True
n_lanes = 1  # one stream


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

    lib.stem_encode_interleaved.restype = ctypes.c_int64
    lib.stem_encode_interleaved.argtypes = [
        _i32p, _i32p, ctypes.c_int64, _i32p, ctypes.c_int32, ctypes.c_int32,
        _i32p, _i32p, ctypes.c_int32, _u8p, ctypes.c_int64, ctypes.c_void_p,
    ]

    lib.stem_decode_interleaved.restype = ctypes.c_int
    lib.stem_decode_interleaved.argtypes = [
        _u8p, ctypes.c_int64, _i32p, ctypes.c_int64, _i32p, ctypes.c_int32,
        ctypes.c_int32, _i32p, _i32p, _i32p, ctypes.c_void_p, ctypes.c_void_p,
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

    lib.stem_encode_runs_segmented.restype = ctypes.c_int64
    lib.stem_encode_runs_segmented.argtypes = [
        _i32p, ctypes.c_int64, _i32p, ctypes.c_int32, ctypes.c_int32, _i32p,
        ctypes.c_int32, _i32p, _i32p, ctypes.c_void_p, _u8p, ctypes.c_int64,
    ]

    lib.stem_dec_create.restype = ctypes.c_void_p
    lib.stem_dec_create.argtypes = [_u8p, ctypes.c_int64]
    lib.stem_dec_destroy.restype = None
    lib.stem_dec_destroy.argtypes = [ctypes.c_void_p]
    lib.stem_dec_decode.restype = ctypes.c_int
    lib.stem_dec_decode.argtypes = [
        ctypes.c_void_p, _i32p, ctypes.c_int64, _i32p, ctypes.c_int32,
        ctypes.c_int32, _i32p, _i32p, _i32p,
    ]
    lib.stem_dec_decode_lut.restype = ctypes.c_int
    lib.stem_dec_decode_lut.argtypes = [
        ctypes.c_void_p, _i32p, ctypes.c_int64, _i32p, ctypes.c_int32,
        ctypes.c_int32, _i32p, _i32p, ctypes.c_void_p, ctypes.c_void_p,
        _i32p,
    ]
    lib.stem_dec_decode_runs.restype = ctypes.c_int
    lib.stem_dec_decode_runs.argtypes = [
        ctypes.c_void_p, _i32p, ctypes.c_int32, ctypes.c_int64, _i32p,
        ctypes.c_int32, _i32p, _i32p, ctypes.c_void_p, ctypes.c_void_p, _i32p,
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


def encode_interleaved(symbols, indexes, cdfs, cdf_lengths, offsets,
                       n_lanes: int = 8, esym=None) -> bytes:
    """Encode into the interleaved container: symbol i goes to lane
    i % n_lanes, one rANS stream per lane, so the lanes decode in parallel
    (rans.cpp::stem_encode_interleaved). Not the reference's format."""
    symbols, indexes, cdfs, lengths, offs = _prep(
        symbols, indexes, cdfs, cdf_lengths, offsets
    )
    n = symbols.shape[0]
    n_lanes = max(1, min(int(n_lanes), max(1, n)))
    cap = 4 * n + 64 * n_lanes + 1024
    while True:
        out = np.empty(cap, dtype=np.uint8)
        rc = _lib().stem_encode_interleaved(
            symbols, indexes, n, cdfs, cdfs.shape[0], cdfs.shape[1],
            lengths, offs, n_lanes, out, cap, _esym_ptr(esym),
        )
        if rc >= 0:
            return out[:rc].tobytes()
        cap = -rc


def decode_interleaved(data: bytes, indexes, cdfs, cdf_lengths, offsets,
                       lut=None):
    """Decode an interleaved container (its lane count in its header)."""
    indexes = _as_i32(indexes).reshape(-1)
    cdfs = _as_i32(cdfs)
    lengths, offs = _as_i32(cdf_lengths), _as_i32(offsets)
    n = indexes.shape[0]
    out = np.empty(n, dtype=np.int32)
    buf = np.frombuffer(data, dtype=np.uint8)
    lut_ptr, dom_ptr = _lut_ptrs(lut)
    rc = _lib().stem_decode_interleaved(
        buf, buf.shape[0], indexes, n, cdfs, cdfs.shape[0], cdfs.shape[1],
        lengths, offs, out, lut_ptr, dom_ptr,
    )
    if rc != 0:
        raise ValueError(f"interleaved rans decode failed (rc={rc})")
    return out


def encode_stream(symbols, indexes, cdfs, cdf_lengths, offsets,
                  esym=None) -> bytes:
    """Plain single-stream encode: the format a ``StreamDecoder`` reads, one
    round or pixel after another (coders/__init__.py::encode_stream of the
    JAX package)."""
    return encode_with_indexes(symbols, indexes, cdfs, cdf_lengths, offsets,
                               esym)


def encode_runs_segmented(symbols, seg_counts, cdfs, cdf_lengths, offsets,
                          esym=None) -> bytes:
    """Encode per-segment grouped-by-row symbols as ONE plain stream (the
    wavefront v2 format): ``seg_counts`` is (n_segs, levels); segment s holds
    the next sum(seg_counts[s]) symbols, grouped by CDF row. The stream is
    consumed incrementally by StreamDecoder.decode_runs, one call per
    segment."""
    symbols = _as_i32(symbols).reshape(-1)
    seg_counts = _as_i32(seg_counts)
    if seg_counts.ndim != 2:
        raise ValueError("seg_counts must be (n_segs, levels)")
    cdfs = _as_i32(cdfs)
    lengths, offs = _as_i32(cdf_lengths), _as_i32(offsets)
    n = symbols.shape[0]
    cap = 4 * n + 1024
    while True:
        out = np.empty(cap, dtype=np.uint8)
        rc = _lib().stem_encode_runs_segmented(
            symbols, n, seg_counts, seg_counts.shape[0], seg_counts.shape[1],
            cdfs, cdfs.shape[1], lengths, offs, _esym_ptr(esym), out, cap,
        )
        if rc >= 0:
            return out[:rc].tobytes()
        if rc == -3:
            raise ValueError("encode_runs_segmented: seg_counts must cover "
                             "every symbol")
        cap = -rc


def encode_runs(symbols, counts, cdfs, cdf_lengths, offsets,
                esym=None, n_lanes: int = 1) -> bytes:
    """Encode grouped-by-CDF-row symbols; rows derive from the run-length
    `counts` (levels,) vector — no per-symbol index array. Contiguous-chunk
    lane container (rans.cpp::stem_encode_runs): one lane for the "rans"
    coder, eight for "rans_interleaved"; the decoder reads the count from
    the header."""
    symbols = _as_i32(symbols).reshape(-1)
    counts = _as_i32(counts).reshape(-1)
    cdfs = _as_i32(cdfs)
    lengths, offs = _as_i32(cdf_lengths), _as_i32(offsets)
    n = symbols.shape[0]
    n_lanes = max(1, min(int(n_lanes), max(1, n // 8)))
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


class StreamDecoder:
    """Stateful decoder of one plain stream for autoregressive decode: each
    call decodes the next symbols (set_stream/decode_stream parity,
    rans_interface.cpp:277-350)."""

    def __init__(self, data: bytes):
        self._h = None
        self._buf = np.frombuffer(data, dtype=np.uint8).copy()
        self._h = _lib().stem_dec_create(self._buf, self._buf.shape[0])

    def decode(self, indexes, cdfs, cdf_lengths, offsets, lut=None):
        """The next len(indexes) symbols, each coded with its CDF row."""
        indexes = _as_i32(indexes).reshape(-1)
        cdfs = _as_i32(cdfs)
        lengths, offs = _as_i32(cdf_lengths), _as_i32(offsets)
        out = np.empty(indexes.shape[0], dtype=np.int32)
        lut_ptr, dom_ptr = _lut_ptrs(lut)
        if lut_ptr is not None:
            rc = _lib().stem_dec_decode_lut(
                self._h, indexes, indexes.shape[0], cdfs, cdfs.shape[0],
                cdfs.shape[1], lengths, offs, lut_ptr, dom_ptr, out,
            )
        else:
            rc = _lib().stem_dec_decode(
                self._h, indexes, indexes.shape[0], cdfs, cdfs.shape[0],
                cdfs.shape[1], lengths, offs, out,
            )
        if rc != 0:
            raise ValueError(f"stream decode failed (rc={rc})")
        return out

    def decode_runs(self, counts, cdfs, cdf_lengths, offsets, lut=None):
        """Decode the next segment of a runs-segmented stream: `counts`
        (levels,) gives the per-CDF-row symbol counts in grouped order.
        Returns int32 symbols (sum(counts),)."""
        counts = _as_i32(counts).reshape(-1)
        cdfs = _as_i32(cdfs)
        lengths, offs = _as_i32(cdf_lengths), _as_i32(offsets)
        n = int(counts.sum())
        out = np.empty(n, dtype=np.int32)
        lut_ptr, dom_ptr = _lut_ptrs(lut)
        rc = _lib().stem_dec_decode_runs(
            self._h, counts, counts.shape[0], n, cdfs, cdfs.shape[1],
            lengths, offs, lut_ptr, dom_ptr, out,
        )
        if rc != 0:
            raise ValueError(f"stream run decode failed (rc={rc})")
        return out

    def close(self):
        if self._h is not None:
            _lib().stem_dec_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()


def make_stream_decoder(data: bytes) -> StreamDecoder:
    """A StreamDecoder over a plain stream (``encode_stream`` or
    ``encode_runs_segmented``)."""
    return StreamDecoder(data)
