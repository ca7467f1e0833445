"""Plain rANS: the wire format of the codec's entropy coder, in Python.

A copy of the format that the program's spec, ``coders/_numpy_rans.py``,
sets out (itself CompressAI's ``rans_interface.cpp`` over ryg_rans'
``rans64.h``): a 64-bit state with lower bound 2^31, 32-bit words emitted
backwards, 16-bit probabilities, symbols outside a row's support escaped to
its last bucket and sent as 4-bit bypass chunks. The loops below keep the
state in a Python int and hoist the table lookups out of them; the bytes
are the spec's.

``encode_runs`` and ``decode_runs`` add the sparse transport's container:
a u32 header 0x80000000 | lanes (one lane here), the lane's byte length as
a u32, then the lane's stream.
"""

import numpy as np

PRECISION = 16
BYPASS = 4
MAX_BYPASS = (1 << BYPASS) - 1
RANS_L = 1 << 31
MASK32 = (1 << 32) - 1
CHUNKED = 0x80000000


def _words_to_bytes(words):
    return np.asarray(words[::-1], dtype="<u4").tobytes()


def _symbol_list(symbols, rows, cdf, length, offset):
    """(start, freq) per coded symbol in order, with the bypass chunks of
    escaped values as (value, 0) entries."""
    rows = np.asarray(rows, np.int64)
    value = np.asarray(symbols, np.int64) - offset[rows]
    max_value = length[rows].astype(np.int64) - 2
    esc = (value < 0) | (value >= max_value)
    v = np.where(esc, max_value, value)
    start = cdf[rows, v].astype(np.int64)
    freq = cdf[rows, v + 1].astype(np.int64) - start
    if not esc.any():
        return start.tolist(), freq.tolist()
    starts, freqs = [], []
    for i in range(len(value)):
        starts.append(int(start[i]))
        freqs.append(int(freq[i]))
        if not esc[i]:
            continue
        raw = (-2 * int(value[i]) - 1 if value[i] < 0
               else 2 * (int(value[i]) - int(max_value[i])))
        n = 0
        while raw >> (n * BYPASS):
            n += 1
        val = n
        while val >= MAX_BYPASS:
            starts.append(MAX_BYPASS)
            freqs.append(0)
            val -= MAX_BYPASS
        starts.append(val)
        freqs.append(0)
        for j in range(n):
            starts.append((raw >> (j * BYPASS)) & MAX_BYPASS)
            freqs.append(0)
    return starts, freqs


def encode(symbols, rows, tables) -> bytes:
    """One stream of ``symbols`` coded with the CDF rows ``rows``."""
    starts, freqs = _symbol_list(symbols, rows, tables.cdf, tables.length,
                                 tables.offset)
    x = RANS_L
    out = []
    put = out.append
    for s, f in zip(reversed(starts), reversed(freqs)):
        if f:
            if x >= f << 47:  # ((L >> 16) << 32) · f
                put(x & MASK32)
                x >>= 32
            x = ((x // f) << PRECISION) + (x % f) + s
        else:  # a bypass chunk: 4 raw bits
            if x >= 1 << 59:
                put(x & MASK32)
                x >>= 32
            x = (x << BYPASS) | s
    put(x >> 32)
    put(x & MASK32)
    return _words_to_bytes(out)


class Decoder:
    """A forward decoder over one stream; ``decode`` may be called again
    for the next part of the stream (the autoregressive rounds)."""

    def __init__(self, data: bytes, tables):
        n = len(data) // 4
        self.words = np.frombuffer(data[:n * 4], dtype="<u4").tolist()
        self.pos = 2
        self.x = (self.words[0] | (self.words[1] << 32)) if n >= 2 else 0
        self.t = tables
        self._lut = {}

    def _next(self):
        if self.pos >= len(self.words):
            return 0  # exhausted: a corrupt stream decodes to garbage
        w = self.words[self.pos]
        self.pos += 1
        return w

    def _row(self, r):
        lut = self._lut.get(r)
        if lut is None:
            size = int(self.t.length[r])
            cdf = self.t.cdf[r, :size].astype(np.int64)
            sym = np.searchsorted(cdf, np.arange(1 << PRECISION),
                                  side="right") - 1
            lut = (sym.tolist(), cdf.tolist(), size - 2,
                   int(self.t.offset[r]))
            self._lut[r] = lut
        return lut

    def _bits(self):
        x = self.x
        val = x & MAX_BYPASS
        x >>= BYPASS
        if x < RANS_L:
            x = (x << 32) | self._next()
        self.x = x
        return val

    def decode(self, rows) -> np.ndarray:
        rows = np.asarray(rows, np.int64).tolist()
        out = [0] * len(rows)
        mask = (1 << PRECISION) - 1
        x = self.x
        for i, r in enumerate(rows):
            sym, cdf, max_value, off = self._row(r)
            s = sym[x & mask]
            lo = cdf[s]
            x = (cdf[s + 1] - lo) * (x >> PRECISION) + (x & mask) - lo
            if x < RANS_L:
                x = (x << 32) | self._next()
            if s == max_value:
                self.x = x
                val = self._bits()
                n = val
                while val == MAX_BYPASS:
                    val = self._bits()
                    n += val
                raw = 0
                for j in range(n):
                    raw |= self._bits() << (j * BYPASS)
                s = -(raw >> 1) - 1 if raw & 1 else (raw >> 1) + max_value
                # a corrupt stream decodes to garbage: keep it in int32
                s = max(-(1 << 31) - off, min(s, (1 << 31) - 1 - off))
                x = self.x
            out[i] = s + off
        self.x = x
        return np.asarray(out, np.int32)


def encode_runs(symbols, counts, tables) -> bytes:
    """The sparse transport's one-lane container of grouped symbols; rows
    follow from the per-row counts."""
    rows = np.repeat(np.arange(len(counts)), counts)
    body = encode(symbols, rows, tables)
    head = np.asarray([CHUNKED | 1, len(body)], dtype="<u4").tobytes()
    return head + body


def decode_runs(data: bytes, counts, tables):
    """Symbols of a one-lane container, or None where it is not one."""
    if len(data) < 8:
        return None
    head, n = np.frombuffer(data[:8], dtype="<u4").tolist()
    if head != CHUNKED | 1 or n != len(data) - 8:
        return None
    rows = np.repeat(np.arange(len(counts)), counts)
    return Decoder(data[8:], tables).decode(rows)
