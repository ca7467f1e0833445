// IGDN fused into g_s's k5 s2 transposed convs, bf16 in and out, for
// sm_90a: one wide kernel (C → O = C) and one narrow kernel (C → F ≤ 32).
//
// Replaces spatiotemporalentropymodel_tpu/ops/pallas_kernels.py::
//   * igdn_deconv_wide (_igdn_deconv_wide_call / _igdn_deconv_wide_kernel)
//     and igdn_deconv_wide_packed (the same call, phase-major output
//     columns): igdn_deconv_wide_kernel;
//   * igdn_deconv_fused (_igdn_deconv_kernel) and igdn_deconv_tail_packed
//     (_tail_packed_kernel): igdn_deconv_narrow_kernel.
// On the TPU the packed pair passes a phase-major packed tensor; here the one
// tensor between the two is the logical NCHW (B, O, 2H, 2W) bf16 output of
// the wide kernel, which the narrow one reads as its input (a channel-second
// layout has no lane tiling to serve). So the lone and the packed variants of
// each TPU kernel are one CUDA kernel here, counted apart by the wrappers.
//
// Both compute, on NCHW x (B, C, H, W) bf16 with ConvTranspose2d weight
// W[c][o][ky][kx] (k5, stride 2, padding 2, output_padding 1) and bias (O,):
//
//   g[c]  = bf16( x[c] · sqrt(β[c] + Σ_i γᵀ[i][c] · x[i]²) )          (f32 math)
//   out[o, 2m+a, 2n+b] = bf16( b[o] + Σ_{c, dy, dx} W[c][o][a+2-2dy][b+2-2dx]
//                                                  · g[c, m+dy, n+dx] )
//
// over dy, dx ∈ {-1, 0, 1} with a tap only where its kernel index is ≤ 4:
// the sub-pixel form of the transposed conv (layers/conv.py::_subpixel_kernel
// in the JAX package), 25 useful taps for every 2 × 2 output phases.
//
// Both kernels: one block per 8 × 32 input tile of one image. Its window of
// 10 × 34 pixels × C (136 KB at C = 192, opt-in dynamic shared memory) is
// loaded once and IGDN'd in place in f32 (gdn_window.cuh); the deconv then
// runs on the tensor cores (mma.sync, f32 accumulators) reading the window.
// A partial tile at the right or bottom edge loads zeros past the image and
// stores nothing there.
//
// igdn_deconv_wide_kernel (C → O = C): bound on the H100 by the 9.6e11 useful
// deconv operations (0.97 ms on the bf16 tensor cores) at 272 × 480 → 544 ×
// 960; the norm adds 3.9e10 f32 operations. Each of the 4 output phases is
// its own implicit GEMM (M = O, N = 64 pixels, K = taps·C), so no zero tap is
// multiplied; 4 pixel sub-tiles × 4 phases per block.
//
// igdn_deconv_narrow_kernel (C → F ≤ 32): at F = 3 bound by its IGDN, 1.5e11
// f32 norm operations at 544 × 960 × 192 (2.3 ms on the CUDA cores); the
// deconv is rows × 9 × C per pixel on the tensor cores. All 4 phases share
// one GEMM of M = rows (row = o·4 + a·2 + b; rows ≥ 4F are zero) over the 9
// taps of the 3 × 3 neighbourhood, the unused (phase, tap) weights being
// zero. rows = 16 (one m-tile) for F ≤ 4, else 32·⌈F/8⌉ ≤ 128; a warp runs
// the m-tiles MG = 1 or 2 at a time, so its accumulators stay at 16·MG
// floats whatever F is.

#include "gdn_window.cuh"

namespace stem {
namespace {

constexpr int kTileH = 8, kTileW = 32;    // input pixels per block
constexpr int kWinH = kTileH + 2;         // 10 rows
constexpr int kWinW = kTileW + 2;         // 34 columns
constexpr int kSlots = kWinH * kWinW;     // 340

__device__ __forceinline__ int deconv_slot(int r, int c) {
  return r * kWinW + c;
}

// Output element (row o, input pixel (iy, ix), phase (a, b)) of NCHW
// (B, n_out, 2H, 2W).
__device__ __forceinline__ long long out_index(int o, int iy, int ix, int a,
                                               int b, int H, int W) {
  return (static_cast<long long>(o) * 2 * H + 2 * iy + a) * (2LL * W) +
         2 * ix + b;
}

// Warps: 4 along O (O/4 each) × 2 along the 64 pixels of a sub-tile (two
// input rows × 32 columns; 4 n-tiles of 8 per warp).
// w: (4 phases, 9 taps, O, C) bf16, phase a·2 + b, tap (dy+1)·3 + (dx+1).
template <int C, int O>
__global__ void __launch_bounds__(kThreads, 1)
igdn_deconv_wide_kernel(const bf16* __restrict__ x,
                        const float* __restrict__ gamma_t,
                        const float* __restrict__ beta,
                        const bf16* __restrict__ w,
                        const float* __restrict__ bias, bf16* __restrict__ out,
                        int H, int W, int tiles_w) {
  static_assert(O % 64 == 0, "output channels must be a multiple of 64");
  constexpr int MT = O / 64;
  constexpr int NT = 4;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* win = reinterpret_cast<bf16*>(smem);
  float* gs = reinterpret_cast<float*>(
      smem + static_cast<size_t>(kSlots) * Window<C>::kStride * sizeof(bf16));

  const int b = blockIdx.y;
  const int iy0 = (blockIdx.x / tiles_w) * kTileH;
  const int ix0 = (blockIdx.x % tiles_w) * kTileW;
  load_window<C>(win, x + static_cast<long long>(b) * C * H * W, H, W,
                 iy0 - 1, ix0 - 1, kWinH, kWinW, deconv_slot);
  gdn_window<C, true>(win, kSlots, gs, gamma_t, beta);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 3) * (O / 4);
  const int wn = warp >> 2;
  const bf16* wl = w + static_cast<long long>(m0 + g) * C + 2 * t;
  bf16* ob = out + static_cast<long long>(b) * O * 4 * H * W;

  for (int sub = 0; sub < kTileH / 2; ++sub) {
    // n-tile j = 4·wn + nt: tile row 2·sub + j / 4, columns (j % 4)·8 + 0..7;
    // slot of the tap (dy, dx) = (-1, -1)
    int slot[NT];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int j = 4 * wn + nt;
      slot[nt] = (2 * sub + (j >> 2)) * kWinW + (j & 3) * 8 + g;
    }
    for (int ph = 0; ph < 4; ++ph) {
      const int pa = ph >> 1, pb = ph & 1;
      float acc[MT][NT][4];
      init_bias(acc, bias, m0, O);
      for (int dy = pa ? 0 : -1; dy <= 1; ++dy) {
        for (int dx = pb ? 0 : -1; dx <= 1; ++dx) {
          const int tap = ph * 9 + (dy + 1) * 3 + (dx + 1);
          mma_tap<C, MT, NT>(acc, win, slot, (dy + 1) * kWinW + (dx + 1),
                             wl + static_cast<long long>(tap) * O * C);
        }
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int j = 4 * wn + nt;
        const int iy = iy0 + 2 * sub + (j >> 2);
        if (iy >= H) continue;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ix = ix0 + (j & 3) * 8 + 2 * t + (q & 1);
          if (ix >= W) continue;
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int o = m0 + 16 * mt + g + (q >> 1) * 8;
            ob[out_index(o, iy, ix, pa, pb, H, W)] =
                __float2bfloat16_rn(acc[mt][nt][q]);
          }
        }
      }
    }
  }
}

// Warps: one input row of the tile each (4 n-tiles of 8 columns), every
// row of the GEMM in `groups` passes of MG m-tiles (16·MG rows) each.
// w: (9 taps, rows, C) bf16, row o·4 + a·2 + b; bias_m: (rows,) f32;
// rows = 16·MG·groups.
template <int C, int MG>
__global__ void __launch_bounds__(kThreads, 1)
igdn_deconv_narrow_kernel(const bf16* __restrict__ x,
                          const float* __restrict__ gamma_t,
                          const float* __restrict__ beta,
                          const bf16* __restrict__ w,
                          const float* __restrict__ bias_m,
                          bf16* __restrict__ out, int F, int groups, int H,
                          int W, int tiles_w) {
  constexpr int NT = 4;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* win = reinterpret_cast<bf16*>(smem);
  float* gs = reinterpret_cast<float*>(
      smem + static_cast<size_t>(kSlots) * Window<C>::kStride * sizeof(bf16));

  const int b = blockIdx.y;
  const int iy0 = (blockIdx.x / tiles_w) * kTileH;
  const int ix0 = (blockIdx.x % tiles_w) * kTileW;
  load_window<C>(win, x + static_cast<long long>(b) * C * H * W, H, W,
                 iy0 - 1, ix0 - 1, kWinH, kWinW, deconv_slot);
  gdn_window<C, true>(win, kSlots, gs, gamma_t, beta);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int slot[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) slot[nt] = warp * kWinW + nt * 8 + g;

  // MG = 1 is the F ≤ 4 case: one pass, with a constant row count
  const int passes = MG == 1 ? 1 : groups;
  const int rows = 16 * MG * passes;
  const int iy = iy0 + warp;
  bf16* ob = out + static_cast<long long>(b) * F * 4 * H * W;
  for (int grp = 0; grp < passes; ++grp) {
    const int m0 = 16 * MG * grp;
    float acc[MG][NT][4];
    init_bias(acc, bias_m, m0, rows);
    const bf16* wl = w + static_cast<long long>(m0 + g) * C + 2 * t;
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int off = (tap / 3) * kWinW + tap % 3;
      mma_tap<C, MG, NT>(acc, win, slot, off,
                         wl + static_cast<long long>(tap) * rows * C);
    }
    if (iy >= H) continue;
#pragma unroll
    for (int mt = 0; mt < MG; ++mt) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int ix = ix0 + nt * 8 + 2 * t + (q & 1);
          const int row = m0 + 16 * mt + g + (q >> 1) * 8;
          if (ix >= W || row >= 4 * F) continue;
          ob[out_index(row >> 2, iy, ix, (row >> 1) & 1, row & 1, H, W)] =
              __float2bfloat16_rn(acc[mt][nt][q]);
        }
      }
    }
  }
}

bool grid_of(long long batch, int H, int W, int* tiles_w, long long* tiles) {
  *tiles_w = (W + kTileW - 1) / kTileW;
  *tiles = static_cast<long long>((H + kTileH - 1) / kTileH) * *tiles_w;
  return batch <= 65535 && *tiles <= 0x7fffffffLL;
}

template <int C, int O>
int launch_wide(const bf16* x, const float* gamma_t, const float* beta,
                const bf16* w, const float* bias, bf16* out, long long batch,
                int H, int W, cudaStream_t stream) {
  int tiles_w;
  long long tiles;
  if (!grid_of(batch, H, W, &tiles_w, &tiles)) return cudaErrorInvalidValue;
  const size_t smem = Window<C>::bytes(kSlots);
  cudaError_t err = allow_smem(igdn_deconv_wide_kernel<C, O>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  igdn_deconv_wide_kernel<C, O>
      <<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(batch)),
         kThreads, smem, stream>>>(x, gamma_t, beta, w, bias, out, H, W,
                                   tiles_w);
  return static_cast<int>(cudaGetLastError());
}

template <int C, int MG>
int launch_narrow(const bf16* x, const float* gamma_t, const float* beta,
                  const bf16* w, const float* bias_m, bf16* out,
                  long long batch, int F, int groups, int H, int W,
                  cudaStream_t stream) {
  int tiles_w;
  long long tiles;
  if (!grid_of(batch, H, W, &tiles_w, &tiles)) return cudaErrorInvalidValue;
  const size_t smem = Window<C>::bytes(kSlots);
  cudaError_t err = allow_smem(igdn_deconv_narrow_kernel<C, MG>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  igdn_deconv_narrow_kernel<C, MG>
      <<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(batch)),
         kThreads, smem, stream>>>(x, gamma_t, beta, w, bias_m, out, F,
                                   groups, H, W, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_narrow_rows(const bf16* x, const float* gamma_t, const float* beta,
                       const bf16* w, const float* bias_m, bf16* out,
                       long long batch, int F, int rows, int H, int W,
                       cudaStream_t stream) {
  if (rows == 16)
    return launch_narrow<C, 1>(x, gamma_t, beta, w, bias_m, out, batch, F, 1,
                               H, W, stream);
  return launch_narrow<C, 2>(x, gamma_t, beta, w, bias_m, out, batch, F,
                             rows / 32, H, W, stream);
}

}  // namespace
}  // namespace stem

extern "C" {

// x (B, C, H, W) bf16; gamma_t (C, C) f32; beta (C,) f32; w (4, 9, O, C)
// bf16 (see igdn_deconv_wide_kernel); bias (O,) f32; out (B, O, 2H, 2W)
// bf16. C = O ∈ {64, 128, 192}.
int stem_igdn_deconv_wide_bf16(const void* x, const float* gamma_t,
                               const float* beta, const void* w,
                               const float* bias, void* out, long long batch,
                               int C, int O, int H, int W, void* stream) {
  using stem::bf16;
  if (batch == 0 || H == 0 || W == 0) return 0;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 64 && O == 64)
    return stem::launch_wide<64, 64>(xb, gamma_t, beta, wb, bias, ob, batch, H,
                                     W, s);
  if (C == 128 && O == 128)
    return stem::launch_wide<128, 128>(xb, gamma_t, beta, wb, bias, ob, batch,
                                       H, W, s);
  if (C == 192 && O == 192)
    return stem::launch_wide<192, 192>(xb, gamma_t, beta, wb, bias, ob, batch,
                                       H, W, s);
  return cudaErrorInvalidValue;
}

// x (B, C, H, W) bf16; gamma_t (C, C) f32; beta (C,) f32; w (9, rows, C)
// bf16 (see igdn_deconv_narrow_kernel); bias_m (rows,) f32; out
// (B, F, 2H, 2W) bf16. C ∈ {64, 128, 192}, 1 ≤ F ≤ 32, rows = 16 for F ≤ 4
// and 32·⌈F/8⌉ otherwise (ops/kernels.py::narrow_rows).
int stem_igdn_deconv_narrow_bf16(const void* x, const float* gamma_t,
                                 const float* beta, const void* w,
                                 const float* bias_m, void* out,
                                 long long batch, int C, int F, int rows,
                                 int H, int W, void* stream) {
  using stem::bf16;
  if (batch == 0 || H == 0 || W == 0) return 0;
  if (F < 1 || F > 32) return cudaErrorInvalidValue;
  if (rows != (F <= 4 ? 16 : 32 * ((F + 7) / 8))) return cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 64)
    return stem::launch_narrow_rows<64>(xb, gamma_t, beta, wb, bias_m, ob,
                                        batch, F, rows, H, W, s);
  if (C == 128)
    return stem::launch_narrow_rows<128>(xb, gamma_t, beta, wb, bias_m, ob,
                                         batch, F, rows, H, W, s);
  if (C == 192)
    return stem::launch_narrow_rows<192>(xb, gamma_t, beta, wb, bias_m, ob,
                                         batch, F, rows, H, W, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
