"""Pure-NumPy rANS coder: the executable specification of the wire format.

The port's copy of spatiotemporalentropymodel_tpu/coders/_numpy_rans.py,
the same format as the reference's native coder
(compressai/cpp_exts/rans/rans_interface.cpp + third_party/ryg_rans/rans64.h):

- 64-bit-state rANS, lower bound L = 2^31, renormalizing by emitting 32-bit
  little words; the encoder consumes symbols in reverse and writes the stream
  backwards; flush stores the final state as two 32-bit words (lo, hi).
- 16-bit probability precision; out-of-range symbols escape to the last CDF
  bucket and the raw value is coded as (unary-capped nibble count, nibbles) in
  4-bit raw "bypass" chunks.

The C++ coder (csrc/rans.cpp) writes the same bytes. This one is slow (a
Python loop per symbol): the "numpy" coder of ``get_coder``, for small planes.
"""

import numpy as np

PRECISION = 16
BYPASS_PRECISION = 4
MAX_BYPASS_VAL = (1 << BYPASS_PRECISION) - 1
RANS_L = 1 << 31
_MASK32 = (1 << 32) - 1


class _BackwardWriter:
    """Collects 32-bit words emitted back-to-front."""

    def __init__(self):
        self._words = []  # appended in emission order; final layout reverses

    def put(self, word: int):
        self._words.append(word & _MASK32)

    def tobytes(self) -> bytes:
        return np.asarray(self._words[::-1], dtype="<u4").tobytes()


def _enc_put(state: int, out: _BackwardWriter, start: int, freq: int) -> int:
    x_max = ((RANS_L >> PRECISION) << 32) * freq
    if state >= x_max:
        out.put(state)
        state >>= 32
    return ((state // freq) << PRECISION) + (state % freq) + start


def _enc_put_bits(state: int, out: _BackwardWriter, val: int, nbits: int) -> int:
    freq = 1 << (16 - nbits)
    x_max = ((RANS_L >> 16) << 32) * freq
    if state >= x_max:
        out.put(state)
        state >>= 32
    return (state << nbits) | val


class _ForwardReader:
    def __init__(self, data: bytes):
        n_words = len(data) // 4
        self._words = np.frombuffer(data[: n_words * 4], dtype="<u4")
        self._pos = 0

    def get(self) -> int:
        if self._pos >= self._words.shape[0]:
            return 0  # exhausted (corrupt stream) — same as the C++ reader
        w = int(self._words[self._pos])
        self._pos += 1
        return w


def _build_symbol_list(symbols, indexes, cdfs, cdfs_sizes, offsets):
    """Forward pass producing (start, freq, is_bypass) triples."""
    syms = []
    for i in range(len(symbols)):
        cdf_idx = int(indexes[i])
        cdf = cdfs[cdf_idx]
        max_value = int(cdfs_sizes[cdf_idx]) - 2
        value = int(symbols[i]) - int(offsets[cdf_idx])

        raw_val = 0
        if value < 0:
            raw_val = -2 * value - 1
            value = max_value
        elif value >= max_value:
            raw_val = 2 * (value - max_value)
            value = max_value

        syms.append((int(cdf[value]), int(cdf[value + 1]) - int(cdf[value]), False))

        if value == max_value:
            n_bypass = 0
            while (raw_val >> (n_bypass * BYPASS_PRECISION)) != 0:
                n_bypass += 1
            val = n_bypass
            while val >= MAX_BYPASS_VAL:
                syms.append((MAX_BYPASS_VAL, MAX_BYPASS_VAL + 1, True))
                val -= MAX_BYPASS_VAL
            syms.append((val, val + 1, True))
            for j in range(n_bypass):
                chunk = (raw_val >> (j * BYPASS_PRECISION)) & MAX_BYPASS_VAL
                syms.append((chunk, chunk + 1, True))
    return syms


def encode_with_indexes(symbols, indexes, cdfs, cdfs_sizes, offsets) -> bytes:
    """Encode int32 symbols; mirrors RansEncoder.encode_with_indexes
    (rans_interface.cpp:193-204)."""
    syms = _build_symbol_list(symbols, indexes, cdfs, cdfs_sizes, offsets)

    state = RANS_L
    out = _BackwardWriter()
    for start, freq, bypass in reversed(syms):
        if bypass:
            state = _enc_put_bits(state, out, start, BYPASS_PRECISION)
        else:
            state = _enc_put(state, out, start, freq)
    # Flush the 64-bit state. Words are appended in emission order and the
    # buffer is reversed at the end, so appending (hi, lo) yields a stream that
    # starts [lo, hi, ...] — the layout Rans64EncFlush/DecInit use.
    out.put(state >> 32)
    out.put(state & _MASK32)
    return out.tobytes()


class StreamDecoder:
    """Stateful forward decoder; mirrors RansDecoder.set_stream/decode_stream
    (rans_interface.cpp:277-350)."""

    def __init__(self, data: bytes):
        self._reader = _ForwardReader(data)
        lo = self._reader.get()
        hi = self._reader.get()
        self._state = lo | (hi << 32)

    def _get_bits(self, nbits: int) -> int:
        x = self._state
        val = x & ((1 << nbits) - 1)
        x >>= nbits
        if x < RANS_L:
            x = (x << 32) | self._reader.get()
        self._state = x
        return val

    def _advance(self, start: int, freq: int):
        mask = (1 << PRECISION) - 1
        x = self._state
        x = freq * (x >> PRECISION) + (x & mask) - start
        if x < RANS_L:
            x = (x << 32) | self._reader.get()
        self._state = x

    def decode(self, indexes, cdfs, cdfs_sizes, offsets) -> np.ndarray:
        out = np.empty(len(indexes), dtype=np.int32)
        for i in range(len(indexes)):
            cdf_idx = int(indexes[i])
            cdf = cdfs[cdf_idx]
            size = int(cdfs_sizes[cdf_idx])
            max_value = size - 2
            offset = int(offsets[cdf_idx])

            cum_freq = self._state & ((1 << PRECISION) - 1)
            # first position with cdf > cum_freq, minus one
            s = int(np.searchsorted(cdf[:size], cum_freq, side="right")) - 1
            self._advance(int(cdf[s]), int(cdf[s + 1]) - int(cdf[s]))

            value = s
            if value == max_value:
                val = self._get_bits(BYPASS_PRECISION)
                n_bypass = val
                while val == MAX_BYPASS_VAL:
                    val = self._get_bits(BYPASS_PRECISION)
                    n_bypass += val
                raw_val = 0
                for j in range(n_bypass):
                    val = self._get_bits(BYPASS_PRECISION)
                    raw_val |= val << (j * BYPASS_PRECISION)
                value = raw_val >> 1
                if raw_val & 1:
                    value = -value - 1
                else:
                    value += max_value
            out[i] = value + offset
        return out


def decode_with_indexes(data, indexes, cdfs, cdfs_sizes, offsets) -> np.ndarray:
    """Stateless one-shot decode (rans_interface.cpp:206-275)."""
    return StreamDecoder(data).decode(indexes, cdfs, cdfs_sizes, offsets)
