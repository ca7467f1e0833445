// Hand-written CUDA kernels of the port's serving paths, for sm_90a:
// gdn_fused (f32, and bf16 I/O with f32 math) and quantize_and_index (f32
// or bf16 in) here; the fused GDN + conv kernels in gdn_conv.cu and
// igdn_deconv.cu.
//
// Plain C ABI (extern "C"): each launcher takes raw device pointers, sizes
// and a cudaStream_t, launches on that stream, does not synchronise, and
// returns cudaGetLastError() so the Python wrapper (ops/kernels.py) can raise
// on a refused launch. Built with nvcc into a hash-named shared library and
// loaded with ctypes (ops/build.py); no PyTorch headers.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gdn_window_tc.cuh"

namespace {

using stem::tc::bf16;
namespace tc = stem::tc;

// ---------------------------------------------------------------------------
// gdn_fused
//
// Replaces spatiotemporalentropymodel_tpu/ops/pallas_kernels.py::gdn_fused
// (_gdn_pallas / _gdn_kernel). Computes, on NCHW x viewed as (B, C, P):
//
//   out[b, o, p] = x[b, o, p] * rsqrt(beta[o] + sum_i gamma_t[i, o] * x[b, i, p]^2)
//
// (sqrt instead of rsqrt for IGDN) at f32 accuracy, for any C that is a
// multiple of 64 (the wrapper zero-pads the others) and any B. The bf16
// entry takes x and writes out in bf16, with f32 math and one rounding at
// the end, as the TPU kernel casts x to f32 and the result back
// (_gdn_kernel).
//
// Bound on the H100: bytes. The f32 entry at (2088960, 192) moves 3.2 GB
// (0.958 ms at 3.35 TB/s); its norm, 1.5e11 products, takes 2.3 ms on the
// CUDA cores in f32 but 0.93 ms as six bf16 products on the tensor cores,
// and less shared between the two (PERF.md §6, kernel table).
//
// Design (gdn_kernel, both entries): the norm is a GEMM on wgmma with the
// pixels as rows. A block takes 128 pixels of one image (blockIdx.x runs
// over the tiles of every image, so any batch fits the grid), one
// warpgroup per 64, and their output channels in chunks of NC (one chunk
// of all C up to 192; wgmma m64nNCk16, NC/2 f32 accumulators per thread).
//   1. The window, x in its own type channel-major [C][128 + pad], arrives
//      by 16-byte cp.async along P (plain loads when a row of P is not a
//      whole number of 16-byte chunks). A row is 16 bytes longer than its
//      128 pixels, ≡ 4 words mod 32, so the 8 pixels × 4 channel pairs of
//      an A fragment fall in distinct banks. Where the window and a ring of
//      64-row slots do not fit in a block's shared memory (f32 past 384
//      channels, bf16 past 704), there is no window: the squares and the
//      rescale read x from device memory (L1/L2) in the same pattern.
//   2. x² is split exactly into K bf16 pieces, s₀ + … + s_{K−1}, each the
//      bf16 rounding of what the earlier ones leave; the wrapper splits γ
//      the same way (ops/kernels.py::split_gamma_pieces), and
//      norm = Σ s_i·g_j over i + j < K, summed in f32 on the tensor cores.
//      f32 entry: K = 3, six products (an f32 x² has 24 significant bits;
//      the dropped terms are below 3·2⁻²⁴ of the norm). bf16 entry: K = 2,
//      three products (a bf16 square has 16 bits, so s₀ + s₁ is exact; γ
//      keeps 16 bits). A ring stage is one γ piece for 64 input channels,
//      a chunk's NC rows × 128 bytes in the header's 3-slot cp.async ring,
//      read by both warpgroups; a warp computes the pieces of its 16 pixels
//      × 64 channels from the window and keeps them in registers across the
//      K stages that use them (again for each chunk).
//   3. x·rsqrt(β + norm) in f32 on the accumulators, x read again. With one
//      chunk the result is rounded to the I/O type into the window in place
//      (a warp owns its 16 pixels over all channels), then stored with
//      16-byte stores along P. With several chunks a later chunk still
//      reads the squares of the channels an earlier one has finished, so
//      each chunk goes straight from its accumulators to `out` (8 pixels
//      contiguous per channel and warp).
// Chunks (launch_gdn): NC = C up to 192 (then C is a template constant
// and the rescale runs in place, the design before the chunks); past that
// the fewest chunks of 64, 128 or 192 whose ring fits beside the window
// (the smallest such NC), e.g. 2 × 128 at 256 (f32: window 135,168 B +
// ring 49,152 B), 128 + 128 + 64 at 320 (f32), 6 × 64 at 384 (f32);
// without a window, chunks of 128 (f32 at 512: 4).
// Shared memory at C = 192: window 101,376 B (f32) or 52,224 B (bf16) +
// ring 73,728 B + up to 1,024 B of alignment: 176,128 or 126,976 B, so one
// block per SM. Registers (nvcc -Xptxas -v), one chunk at C = 192 / 128 /
// 64: 203 / 156 / 106 (f32), 182 / 139 / 90 (bf16); chunks of 192 / 128 /
// 64 with a window: 189 / 175 / 143 (f32), 180 / 158 / 126 (bf16); of
// 128 without: 169 (f32), 158 (bf16); no spills.
// Measured (PERF.md §6, kernel table) on an NVIDIA H100 80GB HBM3 at 700 W,
// through the wrapper (γ's split included): f32 2.24-2.35 ms at (2088960, 192),
// 2.3-2.4× its byte bound; bf16 0.22-0.23 ms at (130560, 192), bound
// 0.030 ms; f32 5.25 ms at (2088960, 256), 4.1× its byte bound of 1.28 ms
// (PERF.md §6). Alone (ops/kernel_ab.py, the same card): f32 2.13 ms at
// (2088960, 192) and 4.76 at 256, bf16 0.142 ms at (130560, 192) and
// 0.233 at 256.
// ---------------------------------------------------------------------------

constexpr int kGdnTile = 128;       // pixels per block
constexpr size_t kMaxSmem = 232448;  // shared memory a block may have

template <typename T>
struct GdnIo {
  static constexpr int kStride = kGdnTile + 16 / sizeof(T);  // window row
  static constexpr int kChunk = 16 / sizeof(T);  // pixels per 16 bytes
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ void cp_async_zfill(uint32_t dst, const void* src,
                                               bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// The K bf16 pieces of the squares of two values, packed in pairs (the
// first value in the low half): piece i is the bf16 rounding of what
// pieces 0 .. i − 1 leave, each remainder exact in f32.
template <int K>
__device__ __forceinline__ void split_squares(float a, float b,
                                              uint32_t (&p)[K]) {
  a *= a;
  b *= b;
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    p[i] = *reinterpret_cast<const uint32_t*>(&h);
    const float2 f = __bfloat1622float2(h);
    a -= f.x;
    b -= f.y;
  }
}

// Shared memory of gdn_kernel at C channels: the window (if WIN), the
// ring's alignment slack and its kStages slots of NC rows.
template <typename T, int NC, bool WIN>
constexpr size_t gdn_smem(int C) {
  return (WIN ? static_cast<size_t>(C) * GdnIo<T>::kStride * sizeof(T) : 0) +
         1024 + static_cast<size_t>(tc::kStages) * NC * tc::kRowBytes;
}

// gamma_p: (C/64 · K, C, 64) bf16, γ's K pieces, stage kc·K + j = piece j
// of input channels 64·kc .. 64·kc + 63 for every output row o
// (ops/kernels.py::split_gamma_pieces); ring stage (r·C/64 + kc)·K + j is
// that stage's rows r·NC .. r·NC + NC − 1 (fewer in a last, partial chunk;
// the slot's other rows give columns that are never stored). C is a
// multiple of 64; tiles = ⌈P / 128⌉, blockIdx.x = b·tiles + tile. ONE: one
// chunk of all channels, C = NC known at compile time (the widths up to
// 192), rescaled in the window; else chunks, with a window if WIN.
template <typename T, int NC, int K, bool INVERSE, bool WIN, bool ONE>
__global__ void __launch_bounds__(tc::kThreads, 1)
gdn_kernel(const T* __restrict__ x, const bf16* __restrict__ gamma_p,
           const float* __restrict__ beta, T* __restrict__ out, int c_arg,
           int P, int tiles) {
  static_assert(WIN || !ONE, "one chunk is rescaled in the window");
  using Io = GdnIo<T>;
  constexpr int S = Io::kStride;
  constexpr int kRowChunks = kGdnTile / Io::kChunk;
  const int C = ONE ? NC : c_arg;
  const int KC = C / 64, rounds = ONE ? 1 : (C + NC - 1) / NC;
  extern __shared__ __align__(16) unsigned char smem[];
  T* win = reinterpret_cast<T*>(smem);
  const uint32_t win_u32 = tc::smem_u32(smem);
  const int b = blockIdx.x / tiles;
  const int p0 = (blockIdx.x - b * tiles) * kGdnTile;
  const long long base = static_cast<long long>(b) * C * P;
  const T* xb = x + base;
  T* ob = out + base;
  const bool vec = (P % Io::kChunk) == 0 &&
                   (reinterpret_cast<uintptr_t>(x) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;

  // the window: one cp.async group, complete at the ring's first stage
  if constexpr (WIN) {
    if (vec) {
#pragma unroll 4
      for (int e = threadIdx.x; e < C * kRowChunks; e += tc::kThreads) {
        const int c = e / kRowChunks, j = (e % kRowChunks) * Io::kChunk;
        const bool valid = p0 + j < P;
        cp_async_zfill(
            win_u32 + (c * S + j) * sizeof(T),
            valid ? xb + static_cast<long long>(c) * P + p0 + j : xb, valid);
      }
    } else {
      for (int e = threadIdx.x; e < C * kGdnTile; e += tc::kThreads) {
        const int c = e / kGdnTile, j = e % kGdnTile;
        win[c * S + j] = p0 + j < P
                             ? xb[static_cast<long long>(c) * P + p0 + j]
                             : from_f32<T>(0.f);
      }
    }
  }
  tc::cp_async_commit();
  const uint32_t win_end =
      win_u32 + (WIN ? static_cast<uint32_t>(C * S * sizeof(T)) : 0u);
  const auto ring = tc::make_ring_fn<NC>(
      (win_end + 1023u) & ~1023u, rounds * KC * K,
      [=](uint32_t dst, int q) {
        if constexpr (ONE) {
          tc::load_stage<NC>(dst, gamma_p + q * (NC * 64));
        } else {
          const int r = q / (KC * K), i = q - r * (KC * K);
          const int rows = C - r * NC < NC ? C - r * NC : NC;
          tc::load_rows(dst, gamma_p + (static_cast<long long>(i) * C +
                                        r * NC) * 64, rows);
        }
      });
  ring.prefetch();

  // x[c][pixel j of the tile] in f32: from the window, or from device
  // memory past the image's P pixels as 0
  auto xat = [&](int c, int j) -> float {
    if constexpr (WIN) {
      return to_f32(win[c * S + j]);
    } else {
      return p0 + j < P ? to_f32(xb[static_cast<long long>(c) * P + p0 + j])
                        : 0.f;
    }
  };

  // warp w: pixels m0 .. m0 + 15 of the tile as A rows (warps 0-3 the first
  // warpgroup's 64, 4-7 the second's); this lane's rows m0 + g and
  // m0 + g + 8, its channels 2t, 2t + 1, 2t + 8 and 2t + 9 of each k-step
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = 16 * warp;

#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    float acc[NC / 8][4];
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 1
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t s[4][4][K];  // [k-step][A fragment register][piece]
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const uint32_t slot = ring.next((r * KC + kc) * K + j);
        if (j == 0) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            // fragment register i: rows + 8·(i & 1), channels + 8·(i >> 1)
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int c = kc * 64 + kk * 16 + (i >> 1) * 8 + 2 * t;
              const int px = m0 + g + (i & 1) * 8;
              split_squares<K>(xat(c, px), xat(c + 1, px), s[kk][i]);
            }
          }
        }
        tc::wgmma_fence();
        const uint64_t d = tc::ring_desc(slot);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
          for (int i = K - 1 - j; i >= 0; --i) {  // the small products first
            const uint32_t a[4] = {s[kk][0][i], s[kk][1][i], s[kk][2][i],
                                   s[kk][3][i]};
            tc::wgmma<NC>(acc, a, d + kk * 2);
          }
        }
        tc::wgmma_commit();
        tc::wgmma_wait_all();
      }
    }

    // acc[nt][e]: pixel m0 + g + 8·(e / 2), channel o = r·NC + 8·nt + 2t +
    // e % 2
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt) {
      const int o2 = r * NC + 8 * nt + 2 * t;  // channels o2, o2 + 1
      if (!ONE && o2 >= C) continue;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(beta + o2));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o2 + (e & 1), px = m0 + g + 8 * (e >> 1);
        const float n = acc[nt][e] + ((e & 1) ? bb.y : bb.x);
        const float v = xat(o, px);
        const T y = from_f32<T>(INVERSE ? v * sqrtf(n) : v * rsqrtf(n));
        if constexpr (ONE)
          win[o * S + px] = y;
        else if (p0 + px < P)
          ob[static_cast<long long>(o) * P + p0 + px] = y;
      }
    }
  }
  if constexpr (!ONE) return;
  __syncthreads();
  if (vec) {
#pragma unroll 4
    for (int e = threadIdx.x; e < C * kRowChunks; e += tc::kThreads) {
      const int c = e / kRowChunks, j = (e % kRowChunks) * Io::kChunk;
      if (p0 + j < P)
        *reinterpret_cast<uint4*>(ob + static_cast<long long>(c) * P + p0 +
                                  j) =
            *reinterpret_cast<const uint4*>(win + c * S + j);
    }
  } else {
    for (int e = threadIdx.x; e < C * kGdnTile; e += tc::kThreads) {
      const int c = e / kGdnTile, j = e % kGdnTile;
      if (p0 + j < P) ob[static_cast<long long>(c) * P + p0 + j] = win[c * S + j];
    }
  }
}

// K = 3 pieces for f32 x, 2 for bf16 x
template <typename T, int NC, bool WIN, bool ONE = false>
int launch_gdn_c(const T* x, const bf16* gamma_p, const float* beta, T* out,
                 long long batch, int C, int P, int inverse,
                 cudaStream_t stream) {
  constexpr int K = sizeof(T) == 4 ? 3 : 2;
  const long long tiles = (P + kGdnTile - 1) / kGdnTile;
  if (batch * tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = gdn_smem<T, NC, WIN>(C);
  const auto kernel = inverse ? gdn_kernel<T, NC, K, true, WIN, ONE>
                              : gdn_kernel<T, NC, K, false, WIN, ONE>;
  cudaError_t err = tc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(batch * tiles), tc::kThreads, smem,
           stream>>>(x, gamma_p, beta, out, C, P, static_cast<int>(tiles));
  return static_cast<int>(cudaGetLastError());
}

// The chunks of C (a multiple of 64): all C in one up to 192; else the
// fewest chunks of 64, 128 or 192 whose ring fits beside the window (the
// smallest such NC), else chunks of 128 without a window.
template <typename T>
int launch_gdn(const T* x, const void* gamma_p, const float* beta, T* out,
               long long batch, int C, long long P, int inverse,
               void* stream) {
  if (batch == 0 || P == 0) return 0;
  if (C <= 0 || C % 64 != 0 || P > 0x7fffffffLL - kGdnTile)
    return cudaErrorInvalidValue;
  const bf16* g = static_cast<const bf16*>(gamma_p);
  const int p = static_cast<int>(P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 64)
    return launch_gdn_c<T, 64, true, true>(x, g, beta, out, batch, C, p,
                                           inverse, s);
  if (C == 128)
    return launch_gdn_c<T, 128, true, true>(x, g, beta, out, batch, C, p,
                                            inverse, s);
  if (C == 192)
    return launch_gdn_c<T, 192, true, true>(x, g, beta, out, batch, C, p,
                                            inverse, s);
  int nc = 0;
  const size_t fit[3] = {gdn_smem<T, 64, true>(C), gdn_smem<T, 128, true>(C),
                         gdn_smem<T, 192, true>(C)};
  for (int k = 2; k >= 0; --k) {
    const int cand = 64 * (k + 1);
    if (fit[k] <= kMaxSmem &&
        (nc == 0 || (C + cand - 1) / cand <= (C + nc - 1) / nc))
      nc = cand;
  }
  if (nc == 64) return launch_gdn_c<T, 64, true>(x, g, beta, out, batch, C, p,
                                                 inverse, s);
  if (nc == 128)
    return launch_gdn_c<T, 128, true>(x, g, beta, out, batch, C, p, inverse,
                                      s);
  if (nc == 192)
    return launch_gdn_c<T, 192, true>(x, g, beta, out, batch, C, p, inverse,
                                      s);
  return launch_gdn_c<T, 128, false>(x, g, beta, out, batch, C, p, inverse,
                                     s);
}

// ---------------------------------------------------------------------------
// quantize_and_index
//
// Replaces spatiotemporalentropymodel_tpu/ops/pallas_kernels.py::
// quantize_and_index (_qidx_kernel). Elementwise, on (y, mu, sigma) all f32
// or all bf16, upcast to f32 in registers as the JAX wrapper's astype(f32):
//
//   sym = int32(clip(rint(y - mu), -2^30, 2^30))      (round half to even)
//   idx = uint8(#{t in table : t < max(sigma, bound)})
//
// where `table` is the f32-cast scale table without its last entry.
//
// Bound on the H100: bytes. 17 B per element in f32 (4 + 4 + 4 read, 4 + 1
// written), 11 B in bf16 (2 + 2 + 2 read, 4 + 1 written): 0.032 and
// 0.0206 ms at (4, 192, 68, 120) and 3.35 TB/s.
//
// Design.
// - The index is a search, not a count. The TPU kernel compares every
//   element with all 63 entries, which its wide VPU does cheaply; as a loop
//   over shared memory that is 63 loads, compares and adds per element,
//   and the first port, which ran it so, reached 45 % of the byte bound
//   (0.0712 ms, PERF.md §6). Here the
//   table sits in shared memory padded with +inf to 2^k entries
//   (2^k > n_table), and k branchless steps i += (t[i + h - 1] < s) ? h : 0,
//   h = 2^(k-1) .. 1, return #{t < s} for any non-decreasing table
//   (ops/kernels.py::scale_table_tensor checks that once): 6 loads for the
//   63 entries, 8 for 255. Entry t lives in slot t + t/32, so that the
//   entries one step can read fall in distinct banks.
// - 16-byte vectors: a thread takes one vector of each input, 4 f32 or 8
//   bf16 elements, by read-only streaming loads issued before it waits for
//   the table, and stores its symbols as int4s and its indexes as one 4- or
//   8-byte word. One vector per thread; at 48 B per thread, three resident
//   blocks of 256 keep the ~25 KB per SM in flight that 3.35 TB/s needs at
//   about 1 us of latency.
// - Rows: blockIdx.y is a batch item. Each input has its own batch stride
//   (a batch item is contiguous), so the two channel-halves of a
//   (B, 2M, H, W) tensor go in as they are; the outputs are contiguous. A
//   row whose five pointers sit at the same offset within a vector takes a
//   scalar head up to the vector boundary, vectors, then a scalar tail; a
//   row whose offsets differ takes the same element ranges by scalar loads
//   and stores.
// ---------------------------------------------------------------------------

constexpr int kQidxThreads = 256;
constexpr int kMaxTable = 255;  // entries compared: a uint8 index
constexpr int kQidxSlots = 256 + 256 / 32;  // 2^8 entries, a gap per 32
constexpr float kSymbolMax = 1073741824.0f;  // 1 << 30, exact in f32

__device__ __forceinline__ int qidx_slot(int t) { return t + (t >> 5); }

struct QidxF32 {
  using T = float;
  static constexpr int kVec = 4;
  static __device__ __forceinline__ float load(const T* p) {
    return __ldcs(p);
  }
  static __device__ __forceinline__ void load_vec(const T* p, float* v) {
    const float4 q = __ldcs(reinterpret_cast<const float4*>(p));
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  }
};

// bf16 as its bits: the f32 with the same upper 16 bits, exactly
struct QidxBf16 {
  using T = unsigned short;
  static constexpr int kVec = 8;
  static __device__ __forceinline__ float load(const T* p) {
    return __uint_as_float(static_cast<uint32_t>(__ldcs(p)) << 16);
  }
  static __device__ __forceinline__ void load_vec(const T* p, float* v) {
    const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ int32_t qidx_symbol(float y, float mu) {
  const float q = rintf(y - mu);
  return static_cast<int32_t>(fminf(fmaxf(q, -kSymbolMax), kSymbolMax));
}

// #{t < max(sigma, bound)} over the padded table; fmaxf(NaN, bound) = bound
__device__ __forceinline__ uint32_t qidx_index(const float* s_t, int steps,
                                               float sigma, float bound) {
  const float s = fmaxf(sigma, bound);
  int i = 0;
  for (int h = (1 << steps) >> 1; h > 0; h >>= 1)
    i += (s_t[qidx_slot(i + h - 1)] < s) ? h : 0;
  return static_cast<uint32_t>(i);
}

template <class Io>
__device__ __forceinline__ uint32_t qidx_phase(const void* p, size_t bytes) {
  return static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p) / bytes) &
         (Io::kVec - 1);
}

template <class Io>
__global__ void __launch_bounds__(kQidxThreads)
qidx_kernel(const typename Io::T* __restrict__ y,
            const typename Io::T* __restrict__ means,
            const typename Io::T* __restrict__ scales, long long y_stride,
            long long means_stride, long long scales_stride, long long per,
            const float* __restrict__ table, int n_table, int steps,
            float bound, int32_t* __restrict__ sym,
            uint8_t* __restrict__ idx) {
  using T = typename Io::T;
  constexpr int V = Io::kVec;
  __shared__ float s_t[kQidxSlots];
  const long long b = blockIdx.y;
  const T* yr = y + b * y_stride;
  const T* mr = means + b * means_stride;
  const T* sr = scales + b * scales_stride;
  int32_t* symr = sym + b * per;
  uint8_t* idxr = idx + b * per;

  const uint32_t phase = qidx_phase<Io>(yr, sizeof(T));
  const bool vec = qidx_phase<Io>(mr, sizeof(T)) == phase &&
                   qidx_phase<Io>(sr, sizeof(T)) == phase &&
                   qidx_phase<Io>(symr, sizeof(int32_t)) == phase &&
                   qidx_phase<Io>(idxr, 1) == phase;
  long long head = vec ? (V - phase) & (V - 1) : 0;
  if (head > per) head = per;
  const long long n_vec = (per - head) / V;
  const long long e0 =
      head + (static_cast<long long>(blockIdx.x) * kQidxThreads +
              threadIdx.x) * V;
  const bool active = e0 < head + n_vec * V;

  float fy[V], fm[V], fs[V];
  if (active) {
    if (vec) {
      Io::load_vec(yr + e0, fy);
      Io::load_vec(mr + e0, fm);
      Io::load_vec(sr + e0, fs);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        fy[j] = Io::load(yr + e0 + j);
        fm[j] = Io::load(mr + e0 + j);
        fs[j] = Io::load(sr + e0 + j);
      }
    }
  }
  const float inf = __int_as_float(0x7f800000);
  for (int t = threadIdx.x; t < (1 << steps) - 1; t += kQidxThreads)
    s_t[qidx_slot(t)] = t < n_table ? table[t] : inf;
  __syncthreads();

  if (active) {
    int32_t q[V];
    uint32_t c[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      q[j] = qidx_symbol(fy[j], fm[j]);
      c[j] = 0;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) fs[j] = fmaxf(fs[j], bound);
    // qidx_index's steps, the V searches side by side so their loads overlap
    for (int h = (1 << steps) >> 1; h > 0; h >>= 1) {
#pragma unroll
      for (int j = 0; j < V; ++j)
        c[j] += (s_t[qidx_slot(static_cast<int>(c[j]) + h - 1)] < fs[j]) ? h
                                                                        : 0;
    }
    if (vec) {
#pragma unroll
      for (int j = 0; j < V; j += 4)
        *reinterpret_cast<int4*>(symr + e0 + j) =
            make_int4(q[j], q[j + 1], q[j + 2], q[j + 3]);
      uint32_t w[V / 4];
#pragma unroll
      for (int k = 0; k < V / 4; ++k)
        w[k] = c[4 * k] | (c[4 * k + 1] << 8) | (c[4 * k + 2] << 16) |
               (c[4 * k + 3] << 24);
      if constexpr (V == 4) {
        *reinterpret_cast<uint32_t*>(idxr + e0) = w[0];
      } else {
        *reinterpret_cast<uint2*>(idxr + e0) = make_uint2(w[0], w[1]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        symr[e0 + j] = q[j];
        idxr[e0 + j] = static_cast<uint8_t>(c[j]);
      }
    }
  }

  // the scalar head and tail of the row, fewer than V elements each
  if (blockIdx.x == 0) {
    const long long tail = per - head - n_vec * V;
    const long long t = threadIdx.x;
    const long long e = t < head ? t : head + n_vec * V + (t - head);
    if (t < head + tail) {
      symr[e] = qidx_symbol(Io::load(yr + e), Io::load(mr + e));
      idxr[e] = static_cast<uint8_t>(
          qidx_index(s_t, steps, Io::load(sr + e), bound));
    }
  }
}

template <class Io>
int launch_qidx(const void* y, const void* means, const void* scales,
                long long rows, long long per, long long y_stride,
                long long means_stride, long long scales_stride,
                const float* table, int n_table, float bound, int32_t* sym,
                uint8_t* idx, void* stream) {
  if (rows <= 0 || per <= 0) return 0;
  if (n_table < 0 || n_table > kMaxTable || rows > 65535)
    return cudaErrorInvalidValue;
  int steps = 0;  // 2^steps > n_table: the search ends on any of n_table + 1
  while ((1 << steps) <= n_table) ++steps;
  const long long vecs = (per + Io::kVec - 1) / Io::kVec;
  const long long blocks = (vecs + kQidxThreads - 1) / kQidxThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  using T = typename Io::T;
  qidx_kernel<Io><<<dim3(static_cast<unsigned>(blocks),
                         static_cast<unsigned>(rows)),
                    kQidxThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(means),
      static_cast<const T*>(scales), y_stride, means_stride, scales_stride,
      per, table, n_table, steps, bound, sym, idx);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// x and out (B, C, P) f32; gamma_p (C/64 · 3, C, 64) bf16 = γ in three
// pieces (ops/kernels.py::split_gamma_pieces); beta (C,) f32. C a
// multiple of 64, B·⌈P/128⌉ < 2³¹.
int stem_gdn_fused_f32(const float* x, const void* gamma_p, const float* beta,
                       float* out, long long batch, int C, long long P,
                       int inverse, void* stream) {
  return launch_gdn(x, gamma_p, beta, out, batch, C, P, inverse, stream);
}

// x and out (B, C, P) bf16; gamma_p (C/64 · 2, C, 64) bf16 = γ in two
// pieces (ops/kernels.py::split_gamma_pieces); beta (C,) f32. C a
// multiple of 64, B·⌈P/128⌉ < 2³¹.
int stem_gdn_fused_bf16(const void* x, const void* gamma_p,
                        const float* beta, void* out, long long batch, int C,
                        long long P, int inverse, void* stream) {
  return launch_gdn(static_cast<const bf16*>(x), gamma_p, beta,
                    static_cast<bf16*>(out), batch, C, P, inverse, stream);
}

// Contiguous f32 y, means and scales of n elements; table holds n_table + 1
// f32 entries, non-decreasing; sym int32 and idx uint8, n each.
int stem_quantize_and_index_f32(const float* y, const float* means,
                                const float* scales, const float* table,
                                int n_table, float bound, int32_t* sym,
                                uint8_t* idx, long long n, void* stream) {
  return launch_qidx<QidxF32>(y, means, scales, 1, n, n, n, n, table,
                              n_table, bound, sym, idx, stream);
}

// rows batch items of per elements each: item b of y at y + b·y_stride
// elements (likewise means, scales), contiguous; sym and idx contiguous,
// rows·per each. rows ≤ 65535.
int stem_quantize_and_index_f32_strided(
    const float* y, const float* means, const float* scales, long long rows,
    long long per, long long y_stride, long long means_stride,
    long long scales_stride, const float* table, int n_table, float bound,
    int32_t* sym, uint8_t* idx, void* stream) {
  return launch_qidx<QidxF32>(y, means, scales, rows, per, y_stride,
                              means_stride, scales_stride, table, n_table,
                              bound, sym, idx, stream);
}

// The same with bf16 y, means and scales.
int stem_quantize_and_index_bf16(
    const void* y, const void* means, const void* scales, long long rows,
    long long per, long long y_stride, long long means_stride,
    long long scales_stride, const float* table, int n_table, float bound,
    int32_t* sym, uint8_t* idx, void* stream) {
  return launch_qidx<QidxBf16>(y, means, scales, rows, per, y_stride,
                               means_stride, scales_stride, table, n_table,
                               bound, sym, idx, stream);
}

}  // extern "C"
