// conv_k5s2_f32: the k5 s2 convolution with bias of g_a's Conv layers
// (Conv2d(k = 5, s = 2, padding 2), then + bias: out (B, O, ⌈H/2⌉, ⌈W/2⌉)
// from x (B, C, H, W)), f32 in and out, in true f32 FMA on the CUDA cores
// (no TF32, no bf16 split), for sm_90a. The forward counterpart of
// deconv_f32.cu.
//
// Replaces no Pallas kernel: the JAX package left f32 convs to XLA
// (spatiotemporalentropymodel_tpu/layers/conv.py::Conv; its bf16
// gdn_conv_fused stays as it is), and the port called cuDNN (F.conv2d), whose
// f32 implicit GEMMs ran the f32 analysis transform at about 31 % of its
// bound (PERF.md §5). It serves the f32 g_a chain only
// (layers/conv.py::Analysis); h_a and the STEM's HE keep cuDNN, so ẑ and the
// coder's (σ, μ) keep their bits.
//
// Bound on the H100:
//   * wide (C a multiple of 8; g_a's N → N and N → M stages): operations.
//     At C = O = 192 a stage does 25 multiply-adds per output pixel and
//     channel pair: 241 GFLOP a 1088×1920 picture at the 544×960 → 272×480
//     stage against 0.5 GB of input and output, far above the 67 TFLOP/s :
//     3.35 TB/s line of f32 on the CUDA cores.
//   * narrow (C = 3; g_a's first conv, 1088×1920 → 544×960): 15 GFLOP
//     against 401 MB of output a picture, 0.22 ms by operations and 0.13 ms
//     by bytes: close to the line, so the stores have to be whole 16-byte
//     words and run under the products.
//
// Design (both variants, one template):
//   * A block takes TR output rows × TC output columns of one image and NB
//     = 32 output channels; a thread 16 output pixels along a row × Q = 4
//     channels (64 running sums), a warp 4 neighbouring rows × 8 channel
//     groups of one 16-column group, TR · TC = 512 pixels a block.
//   * Polyphase taps in registers. Output (i, j) reads input row 2i + ky − 2
//     and column 2j + kx − 2, so P neighbouring outputs of one kernel row
//     read the 2P + 3 consecutive input columns 2j − 2 … 2j + 2P: one
//     8-byte, P/2 16-byte and one 4-byte shared-memory word. Tap kx takes
//     the registers kx, kx + 2, …, kx + 2P − 2: the even taps (kx = 0, 2, 4)
//     the even columns, the odd taps the odd ones, the stride-1 convs of
//     the four parity planes (3×3, 3×2, 2×3 and 2×2 taps, 25 in all). No
//     stride-2 address ever reaches shared memory (no 2-way bank conflict
//     from the stride), and the tile is staged as it lies in device memory.
//     Per input channel, kernel row and 8 columns a thread does 6 x loads,
//     5 weight loads (one float4: its Q channels, per tap) and 160 FMAs.
//   * Banks: a warp's 4 rows read staged rows 2 apart; a staged row is ≡ 12
//     mod 16 words long, so they fall in 4 bank groups. The 8 channel groups
//     read 128 contiguous bytes of weights.
//   * The input channels go in stages of KC: the x tile (2TR + 3 rows ×
//     2TC + 3 columns; 16-byte cp.async along rows where the rows are
//     16-byte aligned, zero-filled past the image) and the stage's weights
//     [c][tap][NB] are staged in shared memory, double-buffered, so the
//     next stage's copy runs under this stage's FMAs.
//     blockIdx.x runs over the channel blocks first, so the O/32 blocks that
//     read one x tile run together and find it in L2.
//   * Wide: KC = 8, 24 stages at C = 192, 221 KB of shared memory, one block
//     an SM; tiles of 8 × 64 or 16 × 32 output pixels, whichever covers the
//     output in fewer blocks. Two-level sums, as deconv_f32.cu's: per stage
//     each output sums the stage's KC × 25 products in a register of its
//     own, then adds that to its running sum (C / KC terms). A thread takes
//     a stage in two halves of 8 columns, so 32 partial sums are live, not
//     64: on an H100 at 4 × 192 × 544 × 960 that ran 3 % faster than whole
//     rows of 16 (23.5 against 24.3 ms, bit-identical), for 12 x and 10
//     weight loads a row where 10 and 5 did.
//   * Narrow: the 3 channels in one stage: all 75 taps × 32 channels of
//     weights in shared memory, single-buffered (41 KB), sums in one level
//     (75 terms), two blocks an SM, so one block's loads and stores run
//     under the other's FMAs.
//   * Stores: NCHW, bias added to the f32 sum in the epilogue. Wide: a
//     thread's 16 columns of one row and channel as four 16-byte stores.
//     Narrow, whose stores weigh: through shared memory, so a warp writes
//     whole rows, neighbouring lanes on neighbouring 16-byte words
//     (store_rows; on an H100 2.08 against 2.39 ms at 4 × 3 × 1088 × 1920
//     → 192).
//   * Sum order fixed (stage, channel, ky, kx), no atomics, no split of the
//     channels across blocks: a launch repeats bit for bit.
//
// Plain C ABI as kernels.cu: the launcher returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 4;             // output channels a thread
constexpr int kCG = 8;            // channel groups a block
constexpr int kNB = kQ * kCG;     // output channels a block
constexpr int kP = 16;            // output columns a thread

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes, or zeros where `bytes` is 0
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

// 16 bytes, the part past `bytes` zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// TR output rows a tile, KC input channels a stage
template <int TR, int KC>
struct Geometry {
  static_assert(TR % 4 == 0 && (kThreads / kCG) % TR == 0, "");
  static constexpr int kTC = kP * (kThreads / kCG / TR);  // output columns
  static constexpr int kRows = 2 * TR + 3;                // input rows
  // a staged row: input column 2·j0 − 4 + u at word u (j0 the tile's first
  // output column), so every thread's 16-byte words start on a 16-byte
  // boundary; ≡ 12 mod 16 words long, so rows 2 apart lie 24 words apart
  // mod 32, in other bank groups
  static constexpr int kXStride = (2 * kTC + 8) / 16 * 16 + 12;
  static_assert(kXStride >= 2 * kTC + 5 && kXStride % 16 == 12, "");
  static constexpr int kXChan = kRows * kXStride;
  static constexpr int kStage = KC * kXChan + KC * 25 * kNB;  // floats
};

// one stage: x channels c0 .. c0 + KC − 1 of image n, input rows gy0 ..
// gy0 + 2TR + 2, columns gx0 − 2 .. gx0 + 2TC, and their weights
template <int TR, int KC>
__device__ __forceinline__ void load_stage(float* stage, const float* xn,
                                           const float* wk, int c0, int H,
                                           int W, int gy0, int gx0, int wcol,
                                           int opad, bool vec) {
  using G = Geometry<TR, KC>;
  constexpr int kRowsAll = KC * G::kRows;
  const long long hw = static_cast<long long>(H) * W;
  if (vec) {  // the 2TC middle columns of each row as 16-byte words, then
              // the halo (2 columns left, 1 right) as 4-byte ones
    constexpr int kWords = G::kTC / 2;
    for (int e = threadIdx.x; e < kRowsAll * kWords; e += kThreads) {
      const int row = e / kWords, v = e % kWords;
      const int kc = row / G::kRows, rr = row - kc * G::kRows;
      const int gy = gy0 + rr, gx = gx0 + 4 * v;
      const int left = gy >= 0 && gy < H ? min(max(W - gx, 0), 4) : 0;
      cp_async16(
          smem_u32(stage + kc * G::kXChan + rr * G::kXStride + 4 + 4 * v),
          left ? xn + (c0 + kc) * hw + static_cast<long long>(gy) * W + gx
               : xn,
          4 * left);
    }
    for (int e = threadIdx.x; e < kRowsAll * 3; e += kThreads) {
      // k = 0, 1: columns gx0 − 2, gx0 − 1; k = 2: column gx0 + 2TC
      const int row = e / 3, k = e - row * 3;
      const int kc = row / G::kRows, rr = row - kc * G::kRows;
      const int gy = gy0 + rr;
      const int gx = k < 2 ? gx0 - 2 + k : gx0 + 2 * G::kTC;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async4(smem_u32(stage + kc * G::kXChan + rr * G::kXStride +
                         (k < 2 ? 2 + k : 4 + 2 * G::kTC)),
                ok ? xn + (c0 + kc) * hw + static_cast<long long>(gy) * W + gx
                   : xn,
                ok ? 4 : 0);
    }
  } else {  // rows not 16-byte aligned: every element on its own
    constexpr int kPer = 2 * G::kTC + 3;
    for (int e = threadIdx.x; e < kRowsAll * kPer; e += kThreads) {
      const int row = e / kPer, u = e - row * kPer;
      const int kc = row / G::kRows, rr = row - kc * G::kRows;
      const int gy = gy0 + rr, gx = gx0 - 2 + u;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async4(smem_u32(stage + kc * G::kXChan + rr * G::kXStride + 2 + u),
                ok ? xn + (c0 + kc) * hw + static_cast<long long>(gy) * W + gx
                   : xn,
                ok ? 4 : 0);
    }
  }
  float* ws = stage + KC * G::kXChan;
  constexpr int kVec = kNB / 4;
  for (int e = threadIdx.x; e < KC * 25 * kVec; e += kThreads) {
    const int row = e / kVec, v = e - row * kVec;  // row = kc · 25 + tap
    cp_async16(smem_u32(ws + row * kNB + 4 * v),
               wk + (static_cast<long long>(c0) * 25 + row) * opad + wcol +
                   4 * v,
               16);
  }
}

// a stage's products of the thread's PP output columns from column P0 on
// into sum[pixel][channel]: xs at the thread's first staged row and column
// (2j − 2), ws at its channel group's weights
template <int TR, int KC, int PP, int P0>
__device__ __forceinline__ void stage_products(float (&sum)[PP][kQ],
                                               const float* xs,
                                               const float* ws) {
  using G = Geometry<TR, KC>;
  constexpr int kN = 2 * PP + 3;  // input columns 2j − 2 .. 2j + 2PP
#pragma unroll 2
  for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
    for (int ky = 0; ky < 5; ++ky) {
      const float* xrow =
          xs + kc * G::kXChan + ky * G::kXStride + 2 * P0;
      float xr[kN];
      const float2 h = *reinterpret_cast<const float2*>(xrow);
      xr[0] = h.x, xr[1] = h.y;
#pragma unroll
      for (int k = 0; k < PP / 2; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(xrow + 2 + 4 * k);
        xr[2 + 4 * k] = v.x, xr[3 + 4 * k] = v.y;
        xr[4 + 4 * k] = v.z, xr[5 + 4 * k] = v.w;
      }
      xr[kN - 1] = xrow[kN - 1];
#pragma unroll
      for (int kx = 0; kx < 5; ++kx) {
        const float4 w4 = *reinterpret_cast<const float4*>(
            ws + (kc * 25 + ky * 5 + kx) * kNB);
        const float w[kQ] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int p = 0; p < PP; ++p)
#pragma unroll
          for (int q = 0; q < kQ; ++q)
            sum[p][q] = fmaf(xr[2 * p + kx], w[q], sum[p][q]);
      }
    }
  }
}

// a stage's products of half the thread's columns (from P0 on), summed in
// registers of their own, then added to the running sums
template <int TR, int KC, int P0>
__device__ __forceinline__ void stage_half(float (&acc)[kP][kQ],
                                           const float* xs,
                                           const float* ws) {
  constexpr int kH = kP / 2;
  float part[kH][kQ];
#pragma unroll
  for (int p = 0; p < kH; ++p)
#pragma unroll
    for (int q = 0; q < kQ; ++q) part[p][q] = 0.f;
  stage_products<TR, KC, kH, P0>(part, xs, ws);
#pragma unroll
  for (int p = 0; p < kH; ++p)
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[P0 + p][q] += part[p][q];
}

// the narrow variant's stores: per channel q of a thread's 4, the block's 8
// channels of it × TR rows × TC columns pass through shared memory (the x
// tile's place; buffer row tr · 8 + cg, ≡ 4 mod 32 words long, so a quarter
// warp's 8 channel groups write 8 bank groups), then leave as whole rows of
// 16-byte words, neighbouring lanes on neighbouring words
template <int TR>
__device__ __forceinline__ void store_rows(const float (&acc)[kP][kQ],
                                           float* buf,
                                           const float* __restrict__ bias,
                                           float* __restrict__ out, int n,
                                           int O, int Ho, int Wo, int i0,
                                           int j0, int ob, int cg, int brow,
                                           int pg, bool vec_out) {
  using G = Geometry<TR, 1>;
  constexpr int kRowF = G::kTC + 4;
  constexpr int kW4 = G::kTC / 4;  // 16-byte words a row
  static_assert(kRowF % 32 == 4, "");
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    __syncthreads();  // the x tile's, or the last channel's, reads are done
    float* dst = buf + brow * kRowF + kP * pg;
    const float bo = bias[ob * kNB + cg * kQ + q];
#pragma unroll
    for (int k = 0; k < kP / 4; ++k)
      *reinterpret_cast<float4*>(dst + 4 * k) = make_float4(
          acc[4 * k][q] + bo, acc[4 * k + 1][q] + bo, acc[4 * k + 2][q] + bo,
          acc[4 * k + 3][q] + bo);
    __syncthreads();
    for (int e = threadIdx.x; e < kCG * TR * kW4; e += kThreads) {
      const int row = e / kW4, v = e - row * kW4;
      const int r = row / kCG, c = row - r * kCG;
      const int i = i0 + r, j = j0 + 4 * v;
      if (i >= Ho || j >= Wo) continue;
      float* orow = out + ((static_cast<long long>(n) * O + ob * kNB +
                            c * kQ + q) * Ho + i) * Wo;
      const float4 val =
          *reinterpret_cast<const float4*>(buf + row * kRowF + 4 * v);
      if (vec_out && j + 4 <= Wo) {
        *reinterpret_cast<float4*>(orow + j) = val;
      } else {
        const float vals[4] = {val.x, val.y, val.z, val.w};
        for (int u = 0; u < 4 && j + u < Wo; ++u) orow[j + u] = vals[u];
      }
    }
  }
}

// x (B, C, H, W); wk (C, 25, opad) = weight[o][c][ky][kx] at [c][ky·5 + kx]
// [o] (opad = nob · 32); bias (O,); out (B, O, Ho, Wo). grid (nob · tiles_x
// · tiles_y, B). ONE: C == KC, one stage, single-buffered, one-level sums.
template <int TR, int KC, int MINB, bool ONE>
__global__ void __launch_bounds__(kThreads, MINB)
    conv_k5s2_f32_kernel(const float* __restrict__ x,
                         const float* __restrict__ wk,
                         const float* __restrict__ bias,
                         float* __restrict__ out, int C, int O, int H, int W,
                         int Ho, int Wo, int tiles_x, int nob, int vec_in,
                         int vec_out) {
  using G = Geometry<TR, KC>;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int cg = t % kCG, rest = t / kCG;
  const int tr = rest % TR, pg = rest / TR;
  int bid = blockIdx.x;
  const int ob = bid % nob;
  bid /= nob;
  const int i0 = (bid / tiles_x) * TR, j0 = (bid % tiles_x) * G::kTC;
  const int n = blockIdx.y;
  const int opad = nob * kNB, wcol = ob * kNB;
  const float* xn = x + static_cast<long long>(n) * C * H * W;
  const int gy0 = 2 * i0 - 2, gx0 = 2 * j0;
  // the thread's first staged row (input row 2i − 2) and column (2j − 2)
  const int xoff = 2 * tr * G::kXStride + 2 * kP * pg + 2;

  float acc[kP][kQ];
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int q = 0; q < kQ; ++q) acc[p][q] = 0.f;

  load_stage<TR, KC>(smem, xn, wk, 0, H, W, gy0, gx0, wcol, opad, vec_in);
  cp_async_commit();
  if constexpr (ONE) {
    cp_async_wait<0>();
    __syncthreads();
    stage_products<TR, KC, kP, 0>(acc, smem + xoff,
                                  smem + KC * G::kXChan + cg * kQ);
    static_assert(kCG * TR * (G::kTC + 4) <= G::kStage, "");
    store_rows<TR>(acc, smem, bias, out, n, O, Ho, Wo, i0, j0, ob, cg,
                   tr * kCG + cg, pg, vec_out);
    return;
  }
  const int stages = C / KC;
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages)
      load_stage<TR, KC>(smem + ((s + 1) & 1) * G::kStage, xn, wk,
                         (s + 1) * KC, H, W, gy0, gx0, wcol, opad, vec_in);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* xs = smem + (s & 1) * G::kStage;
    const float* ws = xs + KC * G::kXChan + cg * kQ;
    stage_half<TR, KC, 0>(acc, xs + xoff, ws);
    stage_half<TR, KC, kP / 2>(acc, xs + xoff, ws);
    __syncthreads();  // the next stage's copy overwrites this buffer
  }

  const int i = i0 + tr, jx = j0 + kP * pg;
  if (i >= Ho) return;
  const bool full = vec_out && jx + kP <= Wo;
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int o = ob * kNB + cg * kQ + q;
    const float bo = bias[o];
    float* row =
        out + ((static_cast<long long>(n) * O + o) * Ho + i) * Wo + jx;
    if (full) {
#pragma unroll
      for (int k = 0; k < kP / 4; ++k)
        *reinterpret_cast<float4*>(row + 4 * k) = make_float4(
            acc[4 * k][q] + bo, acc[4 * k + 1][q] + bo,
            acc[4 * k + 2][q] + bo, acc[4 * k + 3][q] + bo);
    } else {
#pragma unroll
      for (int p = 0; p < kP; ++p)
        if (jx + p < Wo) row[p] = acc[p][q] + bo;
    }
  }
}

template <int TR, int KC, int MINB, bool ONE>
int launch(const float* x, const float* wk, const float* bias, float* out,
           long long batch, int C, int O, int H, int W, void* stream) {
  using G = Geometry<TR, KC>;
  if ((ONE ? C != KC : C % KC != 0) || O < kNB || O % kNB != 0 ||
      batch < 1 || batch > 65535 || H < 1 || W < 1)
    return cudaErrorInvalidValue;
  const int ho = (H + 1) / 2, wo = (W + 1) / 2;
  const int tiles_x = (wo + G::kTC - 1) / G::kTC;
  const int tiles_y = (ho + TR - 1) / TR;
  const int nob = O / kNB;
  const long long blocks = static_cast<long long>(nob) * tiles_x * tiles_y;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  constexpr int kSmemBytes = (ONE ? 1 : 2) * G::kStage * 4;
  auto kernel = conv_k5s2_f32_kernel<TR, KC, MINB, ONE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  // 16-byte rows in: W a multiple of 4 and x on a 16-byte boundary; out:
  // Wo a multiple of 4
  const int vec_in = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_out =
      wo % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(batch)),
           kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, wk, bias, out, C, O, H, W, ho, wo, tiles_x, nob, vec_in, vec_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, C, H, W) f32 contiguous; wk (C, 25, O) f32, the weights as
// ops/kernels.py::pack_conv_f32_weight lays them out; bias (O,) f32; out (B,
// O, ⌈H/2⌉, ⌈W/2⌉) f32. O a multiple of 32, and C = 3 (narrow) or a
// multiple of 8 (wide); B ≤ 65535.
int stem_conv_k5s2_f32(const float* x, const float* wk, const float* bias,
                       float* out, long long batch, int C, int O, int H,
                       int W, void* stream) {
  if (C == 3)
    return launch<8, 3, 2, true>(x, wk, bias, out, batch, C, O, H, W, stream);
  if (C % 8 != 0) return cudaErrorInvalidValue;
  // 16 × 32 tiles where they cover the output in fewer blocks than 8 × 64
  // (544×960 → 272×480: 255 against 272 an image and channel block)
  const int ho = (H + 1) / 2, wo = (W + 1) / 2;
  const long long tall = static_cast<long long>((ho + 15) / 16) *
                         ((wo + 31) / 32);
  const long long wide = static_cast<long long>((ho + 7) / 8) *
                         ((wo + 63) / 64);
  if (tall < wide)
    return launch<16, 8, 1, false>(x, wk, bias, out, batch, C, O, H, W,
                                   stream);
  return launch<8, 8, 1, false>(x, wk, bias, out, batch, C, O, H, W, stream);
}

}  // extern "C"
