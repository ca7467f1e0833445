// Native rANS entropy coder: the PyTorch port's own copy of the JAX
// package's coder (spatiotemporalentropymodel_tpu/coders/csrc/rans.cpp),
// byte for byte the same wire format.
//
//   * 64-bit-state rANS, normalization interval lower bound L = 2^31,
//     renormalizes by emitting 32-bit little-endian words; the encoder
//     consumes symbols in reverse and the stream is laid out
//     [state_lo, state_hi, words...] front-to-back.
//   * 16-bit probability precision. Out-of-range symbols escape into the last
//     CDF bucket, then the raw magnitude is coded in 4-bit bypass chunks:
//     a 15-capped unary-ish nibble count followed by the nibbles.
//
// Exposed as a plain C ABI (loaded via ctypes — no pybind11 dependency):
// batched array in/out, zero Python-list marshalling.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr uint32_t kPrecision = 16;
constexpr uint32_t kBypassBits = 4;
constexpr int32_t kMaxBypassVal = (1 << kBypassBits) - 1;
constexpr uint64_t kRansL = 1ull << 31;

// Precomputed per-(row, symbol) encoder entry: x/freq via the fixed-point
// reciprocal scheme of the public-domain ryg_rans Rans64EncSymbolInit
// (third_party/ryg_rans/rans64.h is the behavioral spec for the TRICK; the
// emitted bytes are identical to the division path, verified by the golden
// and spec-identity tests). Integer division is ~20-40 cycles; this is ~5.
struct EncSym {
  uint64_t rcp_freq;
  uint32_t freq;
  uint32_t bias;
  uint32_t cmpl_freq;
  uint32_t rcp_shift;
};

inline void enc_sym_init(EncSym& s, uint32_t start, uint32_t freq) {
  s.freq = freq;
  s.cmpl_freq = (1u << kPrecision) - freq;
  if (freq < 2) {
    s.rcp_freq = ~0ull;
    s.rcp_shift = 0;
    s.bias = start + (1u << kPrecision) - 1;
  } else {
    uint32_t shift = 0;
    while (freq > (1u << shift)) shift++;
    s.rcp_freq = static_cast<uint64_t>(
        (((static_cast<__uint128_t>(1) << (shift + 63)) + freq - 1) / freq));
    s.rcp_shift = shift - 1;
    s.bias = start;
  }
}

class BackwardBuf {
 public:
  void put(uint32_t w) { words_.push_back(w); }
  // Final stream = words in reverse emission order.
  size_t nbytes() const { return words_.size() * 4; }
  void copy_reversed(uint8_t* dst) const {
    for (size_t i = 0; i < words_.size(); ++i) {
      uint32_t w = words_[words_.size() - 1 - i];
      std::memcpy(dst + 4 * i, &w, 4);
    }
  }

 private:
  std::vector<uint32_t> words_;
};

inline void enc_put(uint64_t& x, BackwardBuf& out, uint32_t start,
                    uint32_t freq) {
  const uint64_t x_max = ((kRansL >> kPrecision) << 32) * freq;
  if (x >= x_max) {
    out.put(static_cast<uint32_t>(x));
    x >>= 32;
  }
  x = ((x / freq) << kPrecision) + (x % freq) + start;
}

// Reciprocal-multiply variant of enc_put: byte-identical output (the state
// recursion is the same function of (start, freq); only the division is
// replaced). q = floor(x / freq) = mulhi(x, rcp) >> shift, then
// x' = x + bias + q·cmpl_freq == (q << 16) + (x − q·freq) + start.
inline void enc_put_sym(uint64_t& x, BackwardBuf& out, const EncSym& s) {
  const uint64_t x_max = ((kRansL >> kPrecision) << 32) * s.freq;
  if (x >= x_max) {
    out.put(static_cast<uint32_t>(x));
    x >>= 32;
  }
  const uint64_t q = static_cast<uint64_t>(
      (static_cast<__uint128_t>(x) * s.rcp_freq) >> 64) >> s.rcp_shift;
  x = x + s.bias + q * s.cmpl_freq;
}

inline void enc_put_bits(uint64_t& x, BackwardBuf& out, uint32_t val,
                         uint32_t nbits) {
  const uint32_t freq = 1u << (16 - nbits);
  const uint64_t x_max = ((kRansL >> 16) << 32) * freq;
  if (x >= x_max) {
    out.put(static_cast<uint32_t>(x));
    x >>= 32;
  }
  x = (x << nbits) | val;
}

// Direct reverse-order encoder: no symbol buffering. Iterates the input
// backwards and, within each escaped symbol, emits the bypass tokens in the
// exact reverse of the forward emission order ([escape, count tokens,
// nibbles] forward → nibbles high-to-low, count tokens last-to-first, escape)
// so the stream is bit-identical to the buffered path.
void encode_direct(const int32_t* symbols, const int32_t* indexes, int64_t n,
                   const int32_t* cdfs, int32_t cols, const int32_t* cdf_sizes,
                   const int32_t* offsets, int64_t lane, int64_t stride,
                   BackwardBuf& out, const EncSym* esym = nullptr) {
  uint64_t x = kRansL;
  // last index of this lane
  int64_t start_i = -1;
  for (int64_t i = lane; i < n; i += stride) start_i = i;
  for (int64_t i = start_i; i >= lane; i -= stride) {
    const int32_t cdf_idx = indexes[i];
    const int32_t* cdf = cdfs + static_cast<int64_t>(cdf_idx) * cols;
    const int32_t max_value = cdf_sizes[cdf_idx] - 2;
    int32_t value = symbols[i] - offsets[cdf_idx];

    uint64_t raw_val = 0;
    bool escaped = false;
    if (value < 0) {
      raw_val = static_cast<uint64_t>(-2ll * value - 1);
      value = max_value;
      escaped = true;
    } else if (value >= max_value) {
      raw_val = static_cast<uint64_t>(2ll * (value - max_value));
      value = max_value;
      escaped = true;
    }

    if (escaped) {
      int32_t n_bypass = 0;
      while ((raw_val >> (n_bypass * kBypassBits)) != 0) ++n_bypass;
      // nibbles, highest chunk first (reverse of forward j = 0..n-1)
      for (int32_t j = n_bypass - 1; j >= 0; --j) {
        enc_put_bits(
            x, out,
            static_cast<uint32_t>((raw_val >> (j * kBypassBits)) &
                                  kMaxBypassVal),
            kBypassBits);
      }
      // count tokens: forward emits (15 × k, rem); reverse emits rem, 15 × k
      int32_t v = n_bypass;
      enc_put_bits(x, out, static_cast<uint32_t>(v % kMaxBypassVal),
                   kBypassBits);
      for (int32_t k = v / kMaxBypassVal; k > 0; --k) {
        enc_put_bits(x, out, static_cast<uint32_t>(kMaxBypassVal),
                     kBypassBits);
      }
    }
    if (esym) {
      enc_put_sym(x, out, esym[static_cast<int64_t>(cdf_idx) * (cols - 1) +
                               value]);
    } else {
      enc_put(x, out, cdf[value],
              static_cast<uint32_t>(cdf[value + 1] - cdf[value]));
    }
  }
  out.put(static_cast<uint32_t>(x >> 32));
  out.put(static_cast<uint32_t>(x));
}

// ---- decoder core -------------------------------------------------------

class ForwardReader {
 public:
  ForwardReader(const uint8_t* data, int64_t nbytes)
      : data_(data), end_(data + nbytes) {}
  uint32_t get() {
    uint32_t w = 0;
    if (data_ + 4 <= end_) {
      std::memcpy(&w, data_, 4);
      data_ += 4;
    }
    return w;
  }

 private:
  const uint8_t* data_;
  const uint8_t* end_;
};

struct DecState {
  uint64_t x;
  ForwardReader rd;
  DecState(const uint8_t* data, int64_t nbytes) : x(0), rd(data, nbytes) {
    const uint64_t lo = rd.get();
    const uint64_t hi = rd.get();
    x = lo | (hi << 32);
  }
  uint32_t get_bits(uint32_t nbits) {
    const uint32_t val = static_cast<uint32_t>(x & ((1u << nbits) - 1));
    x >>= nbits;
    if (x < kRansL) x = (x << 32) | rd.get();
    return val;
  }
  void advance(uint32_t start, uint32_t freq) {
    const uint64_t mask = (1ull << kPrecision) - 1;
    x = freq * (x >> kPrecision) + (x & mask) - start;
    if (x < kRansL) x = (x << 32) | rd.get();
  }
};

// lut: optional (rows, 1<<precision) int16 direct symbol-lookup table
// (lut[row][cum_freq] = symbol index); falls back to binary search when null.
// dom: optional (rows, 3) int32 per-row dominant-symbol shortcut
// {symbol, cdf[symbol], cdf[symbol+1]} — at production rates one symbol per
// row carries almost all mass, and this 12-byte check (hot in L1) skips the
// random access into the multi-MB LUT for the overwhelming majority of
// symbols.
void decode_lane(DecState& st, const int32_t* indexes, int64_t n,
                 const int32_t* cdfs, int32_t cols, const int32_t* cdf_sizes,
                 const int32_t* offsets, int64_t lane, int64_t stride,
                 int32_t* out, const int16_t* lut = nullptr,
                 const int32_t* dom = nullptr) {
  for (int64_t i = lane; i < n; i += stride) {
    const int32_t cdf_idx = indexes[i];
    const int32_t* cdf = cdfs + static_cast<int64_t>(cdf_idx) * cols;
    const int32_t size = cdf_sizes[cdf_idx];
    const int32_t max_value = size - 2;

    const uint32_t cum = static_cast<uint32_t>(st.x & ((1u << kPrecision) - 1));
    int32_t value;
    if (dom != nullptr &&
        static_cast<int32_t>(cum) >= dom[cdf_idx * 3 + 1] &&
        static_cast<int32_t>(cum) < dom[cdf_idx * 3 + 2]) {
      value = dom[cdf_idx * 3];
    } else if (lut != nullptr) {
      value = lut[(static_cast<int64_t>(cdf_idx) << kPrecision) + cum];
    } else {
      // binary search: last s with cdf[s] <= cum (cdf strictly increasing)
      const int32_t* it = std::upper_bound(cdf, cdf + size,
                                           static_cast<int32_t>(cum));
      value = static_cast<int32_t>(it - cdf) - 1;
    }
    st.advance(cdf[value], cdf[value + 1] - cdf[value]);

    if (value == max_value) {
      uint32_t val = st.get_bits(kBypassBits);
      uint32_t n_bypass = val;
      while (val == static_cast<uint32_t>(kMaxBypassVal)) {
        val = st.get_bits(kBypassBits);
        n_bypass += val;
      }
      uint32_t raw_val = 0;
      for (uint32_t j = 0; j < n_bypass; ++j) {
        raw_val |= st.get_bits(kBypassBits) << (j * kBypassBits);
      }
      value = static_cast<int32_t>(raw_val >> 1);
      if (raw_val & 1) {
        value = -value - 1;
      } else {
        value += max_value;
      }
    }
    out[i] = value + offsets[cdf_idx];
  }
}

// ---- run-based (grouped-by-CDF-row) paths ---------------------------------
//
// The sparse transport ships symbols grouped by CDF row with a 64-entry
// per-row count vector (entropy/transport.py). Deriving the row from the
// runs — instead of materializing a per-symbol index plane — removes a
// 4-byte load per symbol and lets every per-row constant (cdf pointer,
// max_value, offset, LUT row, dominant-symbol window) hoist out of the
// inner loop.

// Encode symbols[lo, hi) (grouped order, rows from row_starts) in reverse
// onto an existing rANS state — the shared core of the run-based encoders.
void encode_rows_reverse(uint64_t& x, const int32_t* symbols,
                         const int64_t* row_starts, int32_t levels,
                         const int32_t* cdfs, int32_t cols,
                         const int32_t* cdf_sizes, const int32_t* offsets,
                         const EncSym* esym, int64_t lo, int64_t hi,
                         BackwardBuf& out) {
  for (int32_t r = levels - 1; r >= 0; --r) {
    const int64_t s = std::max(row_starts[r], lo);
    const int64_t e = std::min(row_starts[r + 1], hi);
    if (s >= e) continue;
    const int32_t* cdf = cdfs + static_cast<int64_t>(r) * cols;
    const int32_t max_value = cdf_sizes[r] - 2;
    const int32_t off = offsets[r];
    const EncSym* erow =
        esym ? esym + static_cast<int64_t>(r) * (cols - 1) : nullptr;
    for (int64_t i = e - 1; i >= s; --i) {
      int32_t value = symbols[i] - off;
      uint64_t raw_val = 0;
      bool escaped = false;
      if (value < 0) {
        raw_val = static_cast<uint64_t>(-2ll * value - 1);
        value = max_value;
        escaped = true;
      } else if (value >= max_value) {
        raw_val = static_cast<uint64_t>(2ll * (value - max_value));
        value = max_value;
        escaped = true;
      }
      if (escaped) {
        int32_t n_bypass = 0;
        while ((raw_val >> (n_bypass * kBypassBits)) != 0) ++n_bypass;
        for (int32_t j = n_bypass - 1; j >= 0; --j) {
          enc_put_bits(x, out,
                       static_cast<uint32_t>((raw_val >> (j * kBypassBits)) &
                                             kMaxBypassVal),
                       kBypassBits);
        }
        enc_put_bits(x, out, static_cast<uint32_t>(n_bypass % kMaxBypassVal),
                     kBypassBits);
        for (int32_t k = n_bypass / kMaxBypassVal; k > 0; --k) {
          enc_put_bits(x, out, static_cast<uint32_t>(kMaxBypassVal),
                       kBypassBits);
        }
      }
      if (erow) {
        enc_put_sym(x, out, erow[value]);
      } else {
        enc_put(x, out, cdf[value],
                static_cast<uint32_t>(cdf[value + 1] - cdf[value]));
      }
    }
  }
}

// Encode symbols[lo, hi) (grouped order, rows from counts) as one complete
// lane stream (own state init + flush).
void encode_runs_range(const int32_t* symbols, const int64_t* row_starts,
                       int32_t levels, const int32_t* cdfs, int32_t cols,
                       const int32_t* cdf_sizes, const int32_t* offsets,
                       const EncSym* esym, int64_t lo, int64_t hi,
                       BackwardBuf& out) {
  uint64_t x = kRansL;
  encode_rows_reverse(x, symbols, row_starts, levels, cdfs, cols, cdf_sizes,
                      offsets, esym, lo, hi, out);
  out.put(static_cast<uint32_t>(x >> 32));
  out.put(static_cast<uint32_t>(x));
}

// Decode symbols[lo, hi) (grouped order). When `maskbits`/`values` are given
// the decoded plane is emitted directly as (bitmask, compacted int8
// nonzeros) — the decode-payload format the device unpacks — and `out` may
// be null; `lo` must then be a multiple of 8. Returns the number of
// nonzeros, or -1 if they exceed `cap`.
int64_t decode_runs_range(DecState& st, const int64_t* row_starts,
                          int32_t levels, const int32_t* cdfs, int32_t cols,
                          const int32_t* cdf_sizes, const int32_t* offsets,
                          const int16_t* lut, const int32_t* dom, int64_t lo,
                          int64_t hi, int32_t* out, uint8_t* maskbits,
                          int8_t* values, int64_t cap) {
  int64_t nz = 0;
  uint8_t curbits = 0;
  int nbit = static_cast<int>(lo & 7);  // 0 when packing (lo 8-aligned)
  uint8_t* mb = maskbits ? maskbits + (lo >> 3) : nullptr;
  for (int32_t r = 0; r < levels; ++r) {
    const int64_t s = std::max(row_starts[r], lo);
    const int64_t e = std::min(row_starts[r + 1], hi);
    if (s >= e) continue;
    const int32_t* cdf = cdfs + static_cast<int64_t>(r) * cols;
    const int32_t size = cdf_sizes[r];
    const int32_t max_value = size - 2;
    const int32_t off = offsets[r];
    const int16_t* lrow =
        lut ? lut + (static_cast<int64_t>(r) << kPrecision) : nullptr;
    int32_t dom_sym = -1, dom_lo = 0, dom_hi = 0;
    if (dom) {
      dom_sym = dom[r * 3];
      dom_lo = dom[r * 3 + 1];
      dom_hi = dom[r * 3 + 2];
    }
    for (int64_t i = s; i < e; ++i) {
      const int32_t cum =
          static_cast<int32_t>(st.x & ((1u << kPrecision) - 1));
      int32_t value;
      if (dom_sym >= 0 && cum >= dom_lo && cum < dom_hi) {
        value = dom_sym;
      } else if (lrow) {
        value = lrow[cum];
      } else {
        const int32_t* it = std::upper_bound(cdf, cdf + size, cum);
        value = static_cast<int32_t>(it - cdf) - 1;
      }
      st.advance(cdf[value], cdf[value + 1] - cdf[value]);
      if (value == max_value) {
        uint32_t val = st.get_bits(kBypassBits);
        uint32_t n_bypass = val;
        while (val == static_cast<uint32_t>(kMaxBypassVal)) {
          val = st.get_bits(kBypassBits);
          n_bypass += val;
        }
        uint32_t raw_val = 0;
        for (uint32_t j = 0; j < n_bypass; ++j) {
          raw_val |= st.get_bits(kBypassBits) << (j * kBypassBits);
        }
        value = static_cast<int32_t>(raw_val >> 1);
        if (raw_val & 1) {
          value = -value - 1;
        } else {
          value += max_value;
        }
      }
      const int32_t sym = value + off;
      if (out) out[i] = sym;
      if (mb) {
        if (sym != 0) {
          curbits |= static_cast<uint8_t>(1u << nbit);
          if (nz >= cap) return -1;
          // saturate (encoder guaranteed int8; only corrupt streams differ)
          values[nz++] = static_cast<int8_t>(
              std::min(127, std::max(-128, sym)));
        }
        if (++nbit == 8) {
          *mb++ = curbits;
          curbits = 0;
          nbit = 0;
        }
      }
    }
  }
  if (mb && nbit) *mb = curbits;
  return nz;
}

// Contiguous-chunk lane split for the run-based container: lane boundaries
// are 8-symbol aligned so each lane owns whole bitmask bytes.
inline int64_t lane_step(int64_t n, int32_t n_lanes) {
  return ((n / n_lanes) + 7) & ~static_cast<int64_t>(7);
}

std::vector<int64_t> counts_prefix(const int32_t* counts, int32_t levels) {
  std::vector<int64_t> starts(levels + 1, 0);
  for (int32_t r = 0; r < levels; ++r) starts[r + 1] = starts[r] + counts[r];
  return starts;
}

constexpr uint32_t kChunkedFlag = 0x80000000u;

}  // namespace

extern "C" {

// ---- CDF quantizer (behavioral spec: ops.cpp:24-81 / cdf.py) -------------

int stem_pmf_to_quantized_cdf(const double* pmf, int32_t n, int32_t precision,
                              int32_t* out /* n+1 */) {
  const int64_t scale = 1ll << precision;
  std::vector<int64_t> cdf(n + 1);
  cdf[0] = 0;
  for (int32_t i = 0; i < n; ++i) {
    // round half away from zero, like std::round
    const double v = pmf[i] * static_cast<double>(scale);
    cdf[i + 1] = static_cast<int64_t>(v + 0.5);
  }
  int64_t total = 0;
  for (auto c : cdf) total += c;
  if (total <= 0) return -1;
  for (auto& c : cdf) c = (scale * c) / total;
  for (int32_t i = 1; i <= n; ++i) cdf[i] += cdf[i - 1];
  cdf[n] = scale;

  for (int32_t i = 0; i < n; ++i) {
    if (cdf[i] == cdf[i + 1]) {
      int64_t best_freq = INT64_MAX;
      int32_t best_steal = -1;
      for (int32_t j = 0; j < n; ++j) {
        const int64_t freq = cdf[j + 1] - cdf[j];
        if (freq > 1 && freq < best_freq) {
          best_freq = freq;
          best_steal = j;
        }
      }
      if (best_steal < 0) return -2;
      if (best_steal < i) {
        for (int32_t j = best_steal + 1; j <= i; ++j) cdf[j]--;
      } else {
        for (int32_t j = i + 1; j <= best_steal; ++j) cdf[j]++;
      }
    }
  }
  for (int32_t i = 0; i <= n; ++i) out[i] = static_cast<int32_t>(cdf[i]);
  return 0;
}

// ---- single-stream (reference-format) ------------------------------------

// Returns bytes written, or -(bytes needed) if out_cap is too small.
int64_t stem_encode_with_indexes(const int32_t* symbols, const int32_t* indexes,
                                 int64_t n, const int32_t* cdfs, int32_t rows,
                                 int32_t cols, const int32_t* cdf_sizes,
                                 const int32_t* offsets, uint8_t* out,
                                 int64_t out_cap, const uint8_t* esym) {
  (void)rows;
  BackwardBuf buf;
  encode_direct(symbols, indexes, n, cdfs, cols, cdf_sizes, offsets, 0, 1,
                buf, reinterpret_cast<const EncSym*>(esym));
  const int64_t nbytes = static_cast<int64_t>(buf.nbytes());
  if (nbytes > out_cap) return -nbytes;
  buf.copy_reversed(out);
  return nbytes;
}

int stem_decode_with_indexes(const uint8_t* data, int64_t nbytes,
                             const int32_t* indexes, int64_t n,
                             const int32_t* cdfs, int32_t rows, int32_t cols,
                             const int32_t* cdf_sizes, const int32_t* offsets,
                             int32_t* out) {
  (void)rows;
  DecState st(data, nbytes);
  decode_lane(st, indexes, n, cdfs, cols, cdf_sizes, offsets, 0, 1, out);
  return 0;
}

int stem_decode_with_indexes_lut(const uint8_t* data, int64_t nbytes,
                                 const int32_t* indexes, int64_t n,
                                 const int32_t* cdfs, int32_t rows,
                                 int32_t cols, const int32_t* cdf_sizes,
                                 const int32_t* offsets, const int16_t* lut,
                                 const int32_t* dom, int32_t* out) {
  (void)rows;
  DecState st(data, nbytes);
  decode_lane(st, indexes, n, cdfs, cols, cdf_sizes, offsets, 0, 1, out, lut,
              dom);
  return 0;
}

// Build the direct-lookup table: lut[row][cum] = symbol index with
// cdf[sym] <= cum < cdf[sym+1]. One-time cost per table set.
void stem_build_lut(const int32_t* cdfs, int32_t rows, int32_t cols,
                    const int32_t* cdf_sizes, int16_t* lut /*rows<<16*/) {
  const int64_t span = 1ll << kPrecision;
  for (int32_t r = 0; r < rows; ++r) {
    const int32_t* cdf = cdfs + static_cast<int64_t>(r) * cols;
    int16_t* row = lut + static_cast<int64_t>(r) * span;
    const int32_t size = cdf_sizes[r];
    for (int32_t s = 0; s + 1 < size; ++s) {
      for (int32_t c = cdf[s]; c < cdf[s + 1]; ++c) {
        row[c] = static_cast<int16_t>(s);
      }
    }
  }
}

// Per-row dominant-symbol shortcut table: {argmax-freq symbol, its cdf
// start, its cdf end} per row (see decode_lane's `dom` fast path).
void stem_build_dom(const int32_t* cdfs, int32_t rows, int32_t cols,
                    const int32_t* cdf_sizes, int32_t* dom /*rows*3*/) {
  for (int32_t r = 0; r < rows; ++r) {
    const int32_t* cdf = cdfs + static_cast<int64_t>(r) * cols;
    const int32_t size = cdf_sizes[r];
    int32_t best = 0, best_freq = -1;
    for (int32_t s = 0; s + 1 < size; ++s) {
      const int32_t f = cdf[s + 1] - cdf[s];
      if (f > best_freq) {
        best_freq = f;
        best = s;
      }
    }
    // (the escape bucket is a valid shortcut too: decode_lane's bypass
    // handling keys off the VALUE, not the lookup method)
    dom[r * 3 + 0] = best;
    dom[r * 3 + 1] = cdf[best];
    dom[r * 3 + 2] = cdf[best + 1];
  }
}

// Build the reciprocal encoder-symbol table: (rows, cols-1) EncSym entries,
// 24 bytes each (see EncSym). One-time cost per table set, like the LUT.
void stem_build_enc_table(const int32_t* cdfs, int32_t rows, int32_t cols,
                          const int32_t* cdf_sizes, uint8_t* out) {
  EncSym* tab = reinterpret_cast<EncSym*>(out);
  for (int32_t r = 0; r < rows; ++r) {
    const int32_t* cdf = cdfs + static_cast<int64_t>(r) * cols;
    EncSym* row = tab + static_cast<int64_t>(r) * (cols - 1);
    const int32_t size = cdf_sizes[r];
    for (int32_t s = 0; s + 1 < size; ++s) {
      enc_sym_init(row[s], static_cast<uint32_t>(cdf[s]),
                   static_cast<uint32_t>(cdf[s + 1] - cdf[s]));
    }
  }
}

int32_t stem_enc_sym_bytes() { return static_cast<int32_t>(sizeof(EncSym)); }

// ---- run-based grouped container ------------------------------------------
//
// Wire layout: [u32 kChunkedFlag | n_lanes][u32 payload_len[lane]...]
// [payloads...]. Lane l owns the contiguous symbol range
// [l·step, min((l+1)·step, n)) with step 8-aligned; per-symbol CDF rows are
// derived from the run-length `counts` vector on BOTH sides, so no index
// plane exists anywhere. The flag bit keeps the round-robin interleaved
// container (stem_decode_interleaved) from silently mis-parsing these.

int64_t stem_encode_runs(const int32_t* symbols, int64_t n,
                         const int32_t* counts, int32_t levels,
                         const int32_t* cdfs, int32_t cols,
                         const int32_t* cdf_sizes, const int32_t* offsets,
                         const uint8_t* esym, int32_t n_lanes, uint8_t* out,
                         int64_t out_cap) {
  if (n_lanes < 1) return -1;
  const auto starts = counts_prefix(counts, levels);
  if (starts[levels] != n) return -3;  // counts must cover every symbol
  const int64_t step = lane_step(n, n_lanes);
  std::vector<BackwardBuf> bufs(n_lanes);
  const EncSym* et = reinterpret_cast<const EncSym*>(esym);

  auto work = [&](int32_t lane) {
    const int64_t lo = std::min<int64_t>(lane * step, n);
    const int64_t hi = std::min<int64_t>(lo + step, n);
    encode_runs_range(symbols, starts.data(), levels, cdfs, cols, cdf_sizes,
                      offsets, et, lo, hi, bufs[lane]);
  };
  const unsigned hw = std::thread::hardware_concurrency();
  if (n_lanes > 1 && hw > 1) {
    std::vector<std::thread> threads;
    for (int32_t l = 0; l < n_lanes; ++l) threads.emplace_back(work, l);
    for (auto& t : threads) t.join();
  } else {
    for (int32_t l = 0; l < n_lanes; ++l) work(l);
  }

  int64_t total = 4 + 4 * static_cast<int64_t>(n_lanes);
  for (auto& b : bufs) total += static_cast<int64_t>(b.nbytes());
  if (total > out_cap) return -total;
  uint32_t head = kChunkedFlag | static_cast<uint32_t>(n_lanes);
  std::memcpy(out, &head, 4);
  int64_t off = 4;
  for (auto& b : bufs) {
    uint32_t len = static_cast<uint32_t>(b.nbytes());
    std::memcpy(out + off, &len, 4);
    off += 4;
  }
  for (auto& b : bufs) {
    b.copy_reversed(out + off);
    off += static_cast<int64_t>(b.nbytes());
  }
  return total;
}

// Decode a run-based container. Exactly one of two output modes:
//  * out != null           → dense int32 symbols (n)
//  * maskbits/values != null → decode-payload packing (bitmask + compacted
//    int8 nonzeros, values capacity `cap`); returns total nonzeros
// Returns <0 on malformed container / capacity overflow.
int64_t stem_decode_runs(const uint8_t* data, int64_t nbytes,
                         const int32_t* counts, int32_t levels, int64_t n,
                         const int32_t* cdfs, int32_t cols,
                         const int32_t* cdf_sizes, const int32_t* offsets,
                         const int16_t* lut, const int32_t* dom, int32_t* out,
                         uint8_t* maskbits, int8_t* values, int64_t cap) {
  if (nbytes < 4) return -1;
  uint32_t head = 0;
  std::memcpy(&head, data, 4);
  if (!(head & kChunkedFlag)) return -4;  // not a chunked container
  const int32_t n_lanes = static_cast<int32_t>(head & ~kChunkedFlag);
  if (n_lanes < 1 || nbytes < 4 + 4 * static_cast<int64_t>(n_lanes))
    return -1;
  const auto starts = counts_prefix(counts, levels);
  if (starts[levels] != n) return -3;
  const int64_t step = lane_step(n, n_lanes);

  std::vector<int64_t> lens(n_lanes), offs_(n_lanes);
  int64_t off = 4 + 4 * static_cast<int64_t>(n_lanes);
  for (int32_t l = 0; l < n_lanes; ++l) {
    uint32_t len = 0;
    std::memcpy(&len, data + 4 + 4 * l, 4);
    lens[l] = len;
    offs_[l] = off;
    off += len;
  }
  if (off > nbytes) return -2;

  if (maskbits) std::memset(maskbits, 0, static_cast<size_t>((n + 7) / 8));
  // each lane packs into its own scratch, then compact (values order is
  // global nonzero order)
  std::vector<std::vector<int8_t>> scratch(n_lanes);
  std::vector<int64_t> lane_nz(n_lanes, 0);
  bool overflow = false;

  auto work = [&](int32_t lane) {
    const int64_t lo = std::min<int64_t>(lane * step, n);
    const int64_t hi = std::min<int64_t>(lo + step, n);
    DecState st(data + offs_[lane], lens[lane]);
    int8_t* vals = nullptr;
    if (maskbits) {
      scratch[lane].resize(static_cast<size_t>(hi - lo));
      vals = scratch[lane].data();
    }
    const int64_t nz = decode_runs_range(
        st, starts.data(), levels, cdfs, cols, cdf_sizes, offsets, lut, dom,
        lo, hi, out, maskbits, vals, maskbits ? hi - lo : 0);
    if (nz < 0)
      overflow = true;
    else
      lane_nz[lane] = nz;
  };
  const unsigned hw = std::thread::hardware_concurrency();
  if (n_lanes > 1 && hw > 1) {
    std::vector<std::thread> threads;
    for (int32_t l = 0; l < n_lanes; ++l) threads.emplace_back(work, l);
    for (auto& t : threads) t.join();
  } else {
    for (int32_t l = 0; l < n_lanes; ++l) work(l);
  }
  if (overflow) return -5;
  if (!maskbits) return 0;
  int64_t nz_total = 0;
  for (int32_t l = 0; l < n_lanes; ++l) {
    if (nz_total + lane_nz[l] > cap) return -5;
    std::memcpy(values + nz_total, scratch[l].data(),
                static_cast<size_t>(lane_nz[l]));
    nz_total += lane_nz[l];
  }
  return nz_total;
}

// Segmented run-based SINGLE-stream encoder (the wavefront v2 format):
// symbols are a concatenation of n_segs segments (one per wavefront decode
// round), each segment grouped by CDF row; seg_counts is (n_segs, levels)
// row-major. The output is a plain single-lane stream — stem_dec_create +
// stem_dec_decode_runs consume it segment-by-segment, so every per-row
// constant hoists out of both coding loops while the stream stays
// incrementally decodable across AR rounds.
int64_t stem_encode_runs_segmented(const int32_t* symbols, int64_t n,
                                   const int32_t* seg_counts, int32_t n_segs,
                                   int32_t levels, const int32_t* cdfs,
                                   int32_t cols, const int32_t* cdf_sizes,
                                   const int32_t* offsets, const uint8_t* esym,
                                   uint8_t* out, int64_t out_cap) {
  const EncSym* et = reinterpret_cast<const EncSym*>(esym);
  // segment base offsets
  std::vector<int64_t> seg_base(n_segs + 1, 0);
  for (int32_t s = 0; s < n_segs; ++s) {
    int64_t tot = 0;
    for (int32_t r = 0; r < levels; ++r)
      tot += seg_counts[static_cast<int64_t>(s) * levels + r];
    seg_base[s + 1] = seg_base[s] + tot;
  }
  if (seg_base[n_segs] != n) return -3;

  BackwardBuf buf;
  uint64_t x = kRansL;
  std::vector<int64_t> starts(levels + 1);
  for (int32_t s = n_segs - 1; s >= 0; --s) {
    const int32_t* cnt = seg_counts + static_cast<int64_t>(s) * levels;
    starts[0] = seg_base[s];
    for (int32_t r = 0; r < levels; ++r) starts[r + 1] = starts[r] + cnt[r];
    encode_rows_reverse(x, symbols, starts.data(), levels, cdfs, cols,
                        cdf_sizes, offsets, et, seg_base[s], seg_base[s + 1],
                        buf);
  }
  buf.put(static_cast<uint32_t>(x >> 32));
  buf.put(static_cast<uint32_t>(x));

  const int64_t nbytes = static_cast<int64_t>(buf.nbytes());
  if (nbytes > out_cap) return -nbytes;
  buf.copy_reversed(out);
  return nbytes;
}

// (bitmask, compacted int8 values) → dense int32 symbols; the encode-side
// unpack (entropy/transport.py::unpack_encode) without the Python scatter.
void stem_expand_sparse(const uint8_t* maskbits, const int8_t* values,
                        int64_t n, int32_t* out) {
  int64_t vi = 0;
  for (int64_t byte = 0; byte < (n + 7) / 8; ++byte) {
    const uint8_t m = maskbits[byte];
    const int64_t base = byte * 8;
    if (m == 0) {
      std::memset(out + base, 0, sizeof(int32_t) * std::min<int64_t>(8, n - base));
      continue;
    }
    for (int b = 0; b < 8 && base + b < n; ++b) {
      out[base + b] = (m >> b) & 1 ? values[vi++] : 0;
    }
  }
}

// ---- stateful stream decoder (for autoregressive decode) -----------------

struct StreamDec {
  std::vector<uint8_t> data;
  DecState st;
  StreamDec(const uint8_t* d, int64_t nb)
      : data(d, d + nb), st(data.data(), nb) {}
};

void* stem_dec_create(const uint8_t* data, int64_t nbytes) {
  return new StreamDec(data, nbytes);
}

void stem_dec_destroy(void* h) { delete static_cast<StreamDec*>(h); }

int stem_dec_decode(void* h, const int32_t* indexes, int64_t n,
                    const int32_t* cdfs, int32_t rows, int32_t cols,
                    const int32_t* cdf_sizes, const int32_t* offsets,
                    int32_t* out) {
  (void)rows;
  StreamDec* d = static_cast<StreamDec*>(h);
  decode_lane(d->st, indexes, n, cdfs, cols, cdf_sizes, offsets, 0, 1, out);
  return 0;
}

// LUT-accelerated variant for the wavefront/AR round loop: O(1) symbol
// lookup + per-row dominant-symbol window instead of the per-symbol binary
// search (same stream position semantics as stem_dec_decode).
int stem_dec_decode_lut(void* h, const int32_t* indexes, int64_t n,
                        const int32_t* cdfs, int32_t rows, int32_t cols,
                        const int32_t* cdf_sizes, const int32_t* offsets,
                        const int16_t* lut, const int32_t* dom,
                        int32_t* out) {
  (void)rows;
  StreamDec* d = static_cast<StreamDec*>(h);
  decode_lane(d->st, indexes, n, cdfs, cols, cdf_sizes, offsets, 0, 1, out,
              lut, dom);
  return 0;
}

// Run-based segment decode on the stateful stream: decode the next n symbols
// whose CDF rows are given (grouped order) by `counts` — one call per
// wavefront round on a stem_encode_runs_segmented stream. Row constants and
// acceleration tables hoist per run instead of re-resolving per symbol.
int stem_dec_decode_runs(void* h, const int32_t* counts, int32_t levels,
                         int64_t n, const int32_t* cdfs, int32_t cols,
                         const int32_t* cdf_sizes, const int32_t* offsets,
                         const int16_t* lut, const int32_t* dom,
                         int32_t* out) {
  StreamDec* d = static_cast<StreamDec*>(h);
  const auto starts = counts_prefix(counts, levels);
  if (starts[levels] != n) return -3;
  const int64_t rc = decode_runs_range(d->st, starts.data(), levels, cdfs,
                                       cols, cdf_sizes, offsets, lut, dom, 0,
                                       n, out, nullptr, nullptr, 0);
  return rc < 0 ? static_cast<int>(rc) : 0;
}

// ---- interleaved multi-lane container -------------------------------------
//
// Layout: [u32 n_lanes][u32 payload_len[lane]...][payload lane 0][lane 1]...
// Symbol i belongs to lane (i % n_lanes). Each lane is an independent
// single-stream bitstream, so lanes encode and decode in parallel.

int64_t stem_encode_interleaved(const int32_t* symbols, const int32_t* indexes,
                                int64_t n, const int32_t* cdfs, int32_t rows,
                                int32_t cols, const int32_t* cdf_sizes,
                                const int32_t* offsets, int32_t n_lanes,
                                uint8_t* out, int64_t out_cap,
                                const uint8_t* esym) {
  (void)rows;
  if (n_lanes < 1) return -1;
  std::vector<BackwardBuf> bufs(n_lanes);

  auto work = [&](int32_t lane) {
    encode_direct(symbols, indexes, n, cdfs, cols, cdf_sizes, offsets, lane,
                  n_lanes, bufs[lane],
                  reinterpret_cast<const EncSym*>(esym));
  };

  const unsigned hw = std::thread::hardware_concurrency();
  if (n_lanes > 1 && hw > 1) {
    std::vector<std::thread> threads;
    for (int32_t l = 0; l < n_lanes; ++l) threads.emplace_back(work, l);
    for (auto& t : threads) t.join();
  } else {
    for (int32_t l = 0; l < n_lanes; ++l) work(l);
  }

  int64_t total = 4 + 4 * static_cast<int64_t>(n_lanes);
  for (auto& b : bufs) total += static_cast<int64_t>(b.nbytes());
  if (total > out_cap) return -total;

  uint32_t lanes_u32 = static_cast<uint32_t>(n_lanes);
  std::memcpy(out, &lanes_u32, 4);
  int64_t off = 4;
  for (auto& b : bufs) {
    uint32_t len = static_cast<uint32_t>(b.nbytes());
    std::memcpy(out + off, &len, 4);
    off += 4;
  }
  for (auto& b : bufs) {
    b.copy_reversed(out + off);
    off += static_cast<int64_t>(b.nbytes());
  }
  return total;
}

int stem_decode_interleaved(const uint8_t* data, int64_t nbytes,
                            const int32_t* indexes, int64_t n,
                            const int32_t* cdfs, int32_t rows, int32_t cols,
                            const int32_t* cdf_sizes, const int32_t* offsets,
                            int32_t* out, const int16_t* lut,
                            const int32_t* dom) {
  (void)rows;
  if (nbytes < 4) return -1;
  uint32_t n_lanes = 0;
  std::memcpy(&n_lanes, data, 4);
  if (n_lanes < 1 || nbytes < 4 + 4 * static_cast<int64_t>(n_lanes)) return -1;

  std::vector<int64_t> lens(n_lanes), starts(n_lanes);
  int64_t off = 4 + 4 * static_cast<int64_t>(n_lanes);
  for (uint32_t l = 0; l < n_lanes; ++l) {
    uint32_t len = 0;
    std::memcpy(&len, data + 4 + 4 * l, 4);
    lens[l] = len;
    starts[l] = off;
    off += len;
  }
  if (off > nbytes) return -2;

  auto work = [&](uint32_t lane) {
    DecState st(data + starts[lane], lens[lane]);
    decode_lane(st, indexes, n, cdfs, cols, cdf_sizes, offsets, lane, n_lanes,
                out, lut, dom);
  };

  const unsigned hw = std::thread::hardware_concurrency();
  if (n_lanes > 1 && hw > 1) {
    std::vector<std::thread> threads;
    for (uint32_t l = 0; l < n_lanes; ++l) threads.emplace_back(work, l);
    for (auto& t : threads) t.join();
  } else {
    for (uint32_t l = 0; l < n_lanes; ++l) work(l);
  }
  return 0;
}

}  // extern "C"
