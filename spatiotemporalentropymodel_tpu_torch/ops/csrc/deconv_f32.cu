// deconv_k5s2_f32: the k5 s2 transposed convolution with bias of g_s's
// Deconv layers (ConvTranspose2d(k = 5, s = 2, padding 2, output_padding 1),
// then + bias: out (B, O, 2H, 2W) from x (B, C, H, W)), f32 in and out, in
// true f32 FMA on the CUDA cores (no TF32, no bf16 split), for sm_90a.
//
// Replaces no Pallas kernel: the JAX package left f32 transposed convs to
// XLA (spatiotemporalentropymodel_tpu/layers/conv.py::Deconv), and the port
// called cuDNN (F.conv_transpose2d), whose dgrad and FFT kernels ran the f32
// synthesis transform at about 12 % of its bound (PERF.md §5). It serves the
// f32 g_s chain only (layers/conv.py::Synthesis); h_s and the STEM's HD keep
// cuDNN, so the coder's (σ, μ) keep their bits.
//
// Bound on the H100: operations. g_s's N → N stages at C = O = 192 do 50
// multiply-adds per input pixel and channel pair (25 taps × 2): 241 GFLOP a
// 1088×1920 picture at the 272×480 stage against 0.2 GB of input and output,
// far above the 67 TFLOP/s : 3.35 TB/s line of f32 on the CUDA cores. The
// N → 3 stage (544×960 → 1088×1920) does 15 GFLOP against 0.4 GB, close to
// that line.
//
// Design (both variants, one template):
//   * Sub-pixel phases. Output (2i + a, 2j + b) takes kernel row ky = a + 2
//     − 2·dy from input row i + dy: dy ∈ {−1, 0, 1} for a = 0, {0, 1} for
//     a = 1; columns alike. The four phases are stride-1 convs with 3×3, 3×2,
//     2×3 and 2×2 taps, 25 in all: no multiply by an inserted zero.
//   * A block takes a tile of TR × TC input pixels of one image and NB = Q ×
//     CG output channels; a thread 8 input pixels along a row × the 4 phases
//     (32 output pixels) × Q channels, all in registers. The input tile with
//     its 1-pixel halo serves all four phases: per input channel and phase
//     a thread reads 10 x values of each of its 2 or 3 rows and a weight
//     vector (one float4: its Q channels) per tap, and does 25 × 8 × Q FMAs
//     over the four phases.
//   * The input channels go in stages of KC: the x tile (16-byte cp.async
//     along rows where the rows are 16-byte aligned, zero-filled past the
//     image) and the stage's weights [c][tap][NB] are staged in shared
//     memory, double-buffered, so the next stage's copy runs under this
//     stage's FMAs. Weights are read from L2: a block reads its channel
//     slice of them once.
//   * Wide (O a multiple of 32; g_s's N → N): Q = 4, CG = 8, a warp is one
//     input row of 32 pixels × 32 channels, a block 8 rows × 32 columns,
//     stages of 16 channels.
//     128 accumulators and 32 partial sums a thread, one block an SM.
//     Weight reads are 128 bytes a warp (one wavefront), x reads 4
//     distinct 16-byte words.
//     blockIdx.x runs over the channel blocks first, so the blocks that read
//     one x tile run together and find it in L2.
//   * Narrow (O ≤ 3; g_s's N → 3): Q = 3, CG = 1, every thread of a block
//     on the same 3 channels (weights broadcast), a block 32 rows × 64
//     columns, stages of 8 channels. A row of the x tile is ≡ 4 words mod 8
//     long, so the 4 rows a warp reads fall in other banks.
//   * Stores: NCHW, a thread's 16 output columns of one row (b = 0 and 1
//     interleaved) as four 16-byte stores; bias added in the epilogue.
//   * Two-level sums: per stage, each phase's outputs sum the stage's KC
//     channels × taps (at most 144 terms) in registers of their own, then
//     add that to the output's running sum (C / KC terms). One running sum
//     over all 4·C … 9·C terms read about 5 times cuDNN's rounding error
//     against float64 at C = 192 on the H100 (PERF.md); two levels cut it
//     about 4-fold, for x reloaded per phase (40 x reads a channel, not 12).
//   * Sum order fixed (stage, phase, channel, dy, dx), no atomics, no split
//     of the channels across blocks: a launch repeats bit for bit.
//
// Plain C ABI as kernels.cu: the launcher returns cudaGetLastError().

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

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

// Q output channels a thread, CG channel groups a block, TC input columns
// a tile, KC input channels a stage
template <int Q, int CG, int TC, int KC>
struct Geometry {
  static_assert(Q >= 1 && Q <= 4 && TC % 8 == 0, "");
  static constexpr int kNB = Q * CG;     // output channels of a block
  static constexpr int kWRow = 4 * CG;   // floats of a staged weight row
  static constexpr int kPGRow = TC / 8;  // 8-pixel groups of a tile row
  static constexpr int kTR = kThreads / CG / kPGRow;  // input rows a tile
  static_assert(kTR * kPGRow * CG == kThreads, "");
  // a staged x row: column j0 − 1 + u at word u + 3, so the tile's columns
  // j0 .. j0 + TC − 1 start on a 16-byte boundary; the length is ≡ 4 mod 8
  // words, so rows r and r + 1 fall in other bank groups
  static constexpr int kXStride = TC + 12;
  static constexpr int kXChan = (kTR + 2) * kXStride;
  static constexpr int kStage = KC * kXChan + KC * 25 * kWRow;  // floats
  static constexpr int kSmemBytes = 2 * kStage * 4;
};

// one stage: x channels c0 .. c0 + KC − 1 of image n, rows r0 − 1 .. r0 +
// kTR, columns j0 − 1 .. j0 + TC, and their weights
template <int Q, int CG, int TC, int KC>
__device__ __forceinline__ void load_stage(float* stage, const float* xn,
                                           const float* wk, int c0, int H,
                                           int W, int r0, int j0, int wcol,
                                           int opad, bool vec) {
  using G = Geometry<Q, CG, TC, KC>;
  constexpr int kRows = KC * (G::kTR + 2);
  const long long hw = static_cast<long long>(H) * W;
  if (vec) {  // per row: the TC middle columns as 16-byte words, the halo 4
    constexpr int kPer = TC / 4 + 2;
    for (int e = threadIdx.x; e < kRows * kPer; e += kThreads) {
      const int row = e / kPer, v = e - row * kPer;
      const int kc = row / (G::kTR + 2), rr = row - kc * (G::kTR + 2);
      const int gy = r0 - 1 + rr;
      const bool in_row = gy >= 0 && gy < H;
      const float* src_row =
          xn + (c0 + kc) * hw + static_cast<long long>(gy) * W;
      float* dst_row = stage + kc * G::kXChan + rr * G::kXStride;
      if (v < TC / 4) {
        const int gx = j0 + 4 * v;
        const int left = in_row ? min(max(W - gx, 0), 4) : 0;
        cp_async16(smem_u32(dst_row + 4 + 4 * v), left ? src_row + gx : xn,
                   4 * left);
      } else {
        const int gx = v == TC / 4 ? j0 - 1 : j0 + TC;
        const bool ok = in_row && gx >= 0 && gx < W;
        cp_async4(smem_u32(dst_row + (v == TC / 4 ? 3 : TC + 4)),
                  ok ? src_row + gx : xn, ok ? 4 : 0);
      }
    }
  } else {  // rows not 16-byte aligned: every element on its own
    constexpr int kPer = TC + 2;
    for (int e = threadIdx.x; e < kRows * kPer; e += kThreads) {
      const int row = e / kPer, u = e - row * kPer;
      const int kc = row / (G::kTR + 2), rr = row - kc * (G::kTR + 2);
      const int gy = r0 - 1 + rr, gx = j0 - 1 + u;
      const bool ok = gy >= 0 && gy < H && gx >= 0 && gx < W;
      cp_async4(smem_u32(stage + kc * G::kXChan + rr * G::kXStride + u + 3),
                ok ? xn + (c0 + kc) * hw + static_cast<long long>(gy) * W + gx
                   : xn,
                ok ? 4 : 0);
    }
  }
  float* ws = stage + KC * G::kXChan;
  constexpr int kVec = G::kWRow / 4;
  for (int e = threadIdx.x; e < KC * 25 * kVec; e += kThreads) {
    const int row = e / kVec, v = e - row * kVec;  // row = kc · 25 + tap
    cp_async16(smem_u32(ws + row * G::kWRow + 4 * v),
               wk + (static_cast<long long>(c0) * 25 + row) * opad + wcol +
                   4 * v,
               16);
  }
}

// x (B, C, H, W); wk (C, 25, opad) = weight[c][o][ky][kx] at [c][ky·5 + kx]
// [ob·4CG + cg·4 + q] for o = ob·NB + cg·Q + q, zero elsewhere; bias (O,);
// out (B, O, 2H, 2W). grid (nob · tiles_x · tiles_y, B).
template <int Q, int CG, int TC, int KC, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
    deconv_k5s2_f32_kernel(const float* __restrict__ x,
                           const float* __restrict__ wk,
                           const float* __restrict__ bias,
                           float* __restrict__ out, int C, int O, int H,
                           int W, int tiles_x, int nob, int vec_in,
                           int vec_out) {
  using G = Geometry<Q, CG, TC, KC>;
  extern __shared__ __align__(16) float smem[];
  const int t = threadIdx.x;
  const int cg = t % CG, pgi = t / CG;
  const int pg = pgi % G::kPGRow, tr = pgi / G::kPGRow;
  int bid = blockIdx.x;
  const int ob = bid % nob;
  bid /= nob;
  const int r0 = (bid / tiles_x) * G::kTR, j0 = (bid % tiles_x) * TC;
  const int n = blockIdx.y;
  const int opad = nob * G::kWRow, wcol = ob * G::kWRow;
  const float* xn = x + static_cast<long long>(n) * C * H * W;

  float acc[2][2][8][Q];  // [a][b][pixel][channel]
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int p = 0; p < 8; ++p)
#pragma unroll
        for (int q = 0; q < Q; ++q) acc[a][b][p][q] = 0.f;

  const int stages = C / KC;
  load_stage<Q, CG, TC, KC>(smem, xn, wk, 0, H, W, r0, j0, wcol, opad,
                            vec_in);
  cp_async_commit();
  for (int s = 0; s < stages; ++s) {
    if (s + 1 < stages)
      load_stage<Q, CG, TC, KC>(smem + ((s + 1) & 1) * G::kStage, xn, wk,
                                (s + 1) * KC, H, W, r0, j0, wcol, opad,
                                vec_in);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* xs = smem + (s & 1) * G::kStage;
    const float* ws = xs + KC * G::kXChan + cg * 4;
    xs += tr * G::kXStride + 8 * pg + 3;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        // the stage's partial sums of phase (a, b), added to acc after it
        float part[8][Q];
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int q = 0; q < Q; ++q) part[p][q] = 0.f;
#pragma unroll 2
        for (int kc = 0; kc < KC; ++kc) {
          const float* xc = xs + kc * G::kXChan;
          const float* wc = ws + kc * 25 * G::kWRow;
#pragma unroll
          for (int dyi = a; dyi < 3; ++dyi) {  // input row i + dyi − 1
            const int ky = (a == 0 ? 4 : 5) - 2 * dyi;
            const float* xrow = xc + dyi * G::kXStride;
            float xr[10];  // columns j − 1 .. j + 8 of the 8 pixels
            xr[0] = xrow[0];
            const float4 lo = *reinterpret_cast<const float4*>(xrow + 1);
            const float4 hi = *reinterpret_cast<const float4*>(xrow + 5);
            xr[1] = lo.x, xr[2] = lo.y, xr[3] = lo.z, xr[4] = lo.w;
            xr[5] = hi.x, xr[6] = hi.y, xr[7] = hi.z, xr[8] = hi.w;
            xr[9] = xrow[9];
#pragma unroll
            for (int dxi = b; dxi < 3; ++dxi) {  // input column j + dxi − 1
              const int kx = (b == 0 ? 4 : 5) - 2 * dxi;
              const float4 w4 = *reinterpret_cast<const float4*>(
                  wc + (ky * 5 + kx) * G::kWRow);
              const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
              for (int p = 0; p < 8; ++p)
#pragma unroll
                for (int q = 0; q < Q; ++q)
                  part[p][q] = fmaf(xr[p + dxi], w[q], part[p][q]);
            }
          }
        }
#pragma unroll
        for (int p = 0; p < 8; ++p)
#pragma unroll
          for (int q = 0; q < Q; ++q) acc[a][b][p][q] += part[p][q];
      }
    }
    __syncthreads();  // the next stage's copy overwrites this buffer
  }

  const int iy = r0 + tr, jx = j0 + 8 * pg;
  if (iy >= H) return;
  const bool full = vec_out && jx + 8 <= W;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int o = ob * G::kNB + cg * Q + q;
    if (o >= O) continue;
    const float bo = bias[o];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float* row = out + ((static_cast<long long>(n) * O + o) * 2 * H +
                          2 * iy + a) * 2 * W + 2 * jx;
      if (full) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          *reinterpret_cast<float4*>(row + 4 * k) = make_float4(
              acc[a][0][2 * k][q] + bo, acc[a][1][2 * k][q] + bo,
              acc[a][0][2 * k + 1][q] + bo, acc[a][1][2 * k + 1][q] + bo);
      } else {
#pragma unroll
        for (int p = 0; p < 8; ++p)
          if (jx + p < W)
            *reinterpret_cast<float2*>(row + 2 * p) = make_float2(
                acc[a][0][p][q] + bo, acc[a][1][p][q] + bo);
      }
    }
  }
}

template <int Q, int CG, int TC, int KC, int MINB>
int launch(const float* x, const float* wk, const float* bias, float* out,
           long long batch, int C, int O, int H, int W, void* stream) {
  using G = Geometry<Q, CG, TC, KC>;
  if (C % KC != 0 || batch < 1 || batch > 65535 || H < 1 || W < 1)
    return cudaErrorInvalidValue;
  const int tiles_x = (W + TC - 1) / TC, tiles_y = (H + G::kTR - 1) / G::kTR;
  const int nob = (O + G::kNB - 1) / G::kNB;
  const long long blocks = static_cast<long long>(nob) * tiles_x * tiles_y;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  auto kernel = deconv_k5s2_f32_kernel<Q, CG, TC, KC, MINB>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmemBytes);
  if (err != cudaSuccess) return err;
  // 16-byte rows in: W a multiple of 4 and x on a 16-byte boundary; out:
  // 2W a multiple of 4
  const int vec_in = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int vec_out =
      W % 2 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  kernel<<<dim3(static_cast<unsigned>(blocks), static_cast<unsigned>(batch)),
           kThreads, G::kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      x, wk, bias, out, C, O, H, W, tiles_x, nob, vec_in, vec_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x (B, C, H, W) f32 contiguous; wk (C, 25, opad) f32, the weights as
// ops/kernels.py::pack_deconv_f32_weight lays them out for this O; bias
// (O,) f32; out (B, O, 2H, 2W) f32. O a multiple of 32 (C a multiple of 16)
// or 1 ≤ O ≤ 3 (C a multiple of 8); B ≤ 65535.
int stem_deconv_k5s2_f32(const float* x, const float* wk, const float* bias,
                         float* out, long long batch, int C, int O, int H,
                         int W, void* stream) {
  if (O >= 1 && O <= 3)
    return launch<3, 1, 64, 8, 1>(x, wk, bias, out, batch, C, O, H, W,
                                  stream);
  if (O % 32 == 0)
    return launch<4, 8, 32, 16, 1>(x, wk, bias, out, batch, C, O, H, W,
                                   stream);
  return cudaErrorInvalidValue;
}

}  // extern "C"
