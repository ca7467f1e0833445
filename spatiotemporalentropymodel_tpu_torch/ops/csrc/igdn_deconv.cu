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
// Both kernels: one block per 8 × 32 input tile of one image, whose window
// of 10 × 34 pixels × C is loaded once and IGDN'd in place; the deconv then
// runs on the tensor cores (f32 accumulators) reading the window.
// A partial tile at the right or bottom edge loads zeros past the image and
// stores nothing there.
//
// igdn_deconv_wide_kernel (C → O = C), on gdn_window_tc.cuh: bound on the
// H100 by the 9.6e11 useful deconv operations (0.97 ms at the bf16
// tensor-core peak) at 272 × 480 → 544 × 960; its norm, 3.9e10 f32
// operations, runs on the tensor cores as a split-bf16 GEMM at f32
// accuracy. Each of the 4 output phases is its own implicit GEMM on wgmma
// (pixels as rows, N = O, K = taps·C; 9, 6, 6 and 4 taps, so no zero tap is
// multiplied) over 128 input pixels (4 rows × 32), in 2 passes per block:
// each warpgroup takes 64 pixels (two rows of 32; a warp 16, loaded from
// the window with ldmatrix) × all O channels, 96 f32 accumulators per
// thread. The weights, 64 channels of one tap a stage, stream through the
// 3-slot cp.async ring that both warpgroups read, so each staged tile
// serves 128 pixels: 3.7 MB of L2 traffic per block at C = 192. Shared
// memory at C = 192: window 340 × 400 B = 136,000 B + ring 73,728 B + up
// to 1,024 B of alignment = 210,752 B.
// Registers (nvcc -Xptxas -v): 192 / 142 / 103 at C = 192 / 128 / 64, no
// spills. Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W:
// 4.11 ms at 272 × 480 and 1.54 ms at 136 × 240; a block at 272 × 480
// takes about 423k cycles, 6 % window load, 16 % norm, 78 % conv
// (ops/phase_probe.py; PERF.md §5-6).
//
// igdn_deconv_narrow_kernel (C → F ≤ 32), on gdn_window.cuh: at F = 3 bound
// by its IGDN, 1.5e11 f32 norm operations at 544 × 960 × 192 (2.3 ms on the
// CUDA cores; 0.44 ms if the norm shares the tensor cores, as the wide
// kernel's does); the deconv is rows × 9 × C per pixel on the tensor cores.
// All 4 phases share one GEMM of M = rows (row = o·4 + a·2 + b; rows ≥ 4F
// are zero) over the 9 taps of the 3 × 3 neighbourhood, the unused (phase,
// tap) weights being zero. rows = 16 (one m-tile) for F ≤ 4, else
// 32·⌈F/8⌉ ≤ 128; a warp runs the m-tiles MG = 1 or 2 at a time, so its
// accumulators stay at 16·MG floats whatever F is (mma.sync, weights read
// from L2, the window normalised on the CUDA cores 64 pixels at a time).

#include "gdn_window.cuh"
#include "gdn_window_tc.cuh"

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

// Warpgroups: 2 along the 128 pixels of a pass (two input rows × 32
// columns each), every O channel; warp w of a warpgroup owns 16 pixels
// (row w / 2, columns (w % 2)·16 + 0..15).
// gamma_s: (C/32, C, 64) bf16 (ops/kernels.py::split_gamma); w: (25, C/64,
// O, 64) bf16, the 25 taps of the sub-pixel form in phase order (phase
// a·2 + b, then dy, then dx; ops/kernels.py::pack_wide_weight).
template <int C>
__global__ void __launch_bounds__(tc::kThreads, 1)
igdn_deconv_wide_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ gamma_s,
                        const float* __restrict__ beta,
                        const bf16* __restrict__ w,
                        const float* __restrict__ bias, bf16* __restrict__ out,
                        int H, int W, int tiles_w) {
  constexpr int O = C;
  constexpr int KC = C / 64;   // ring stages per tap
  constexpr int KN = C / 32;   // ring stages per norm round
  constexpr int kPassRows = 4;
  constexpr int kNorm = tc::norm_stages<C>(kSlots);
  constexpr int kPassStages = 25 * KC;
  constexpr int kStagesAll = kNorm + (kTileH / kPassRows) * kPassStages;
  using L = tc::Layout<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* win = reinterpret_cast<bf16*>(smem);
  const uint32_t win_u32 = tc::smem_u32(smem);

  STEM_PHASE(0);
  auto src = [=](int q) -> const bf16* {
    return q < kNorm ? gamma_s + (q % KN) * (C * 64)
                     : w + ((q - kNorm) % kPassStages) * (O * 64);
  };
  const auto ring =
      tc::make_ring<C>(tc::ring_base<C>(smem, kSlots), kStagesAll, src);
  ring.prefetch();

  const int b = blockIdx.y;
  const int iy0 = (blockIdx.x / tiles_w) * kTileH;
  const int ix0 = (blockIdx.x % tiles_w) * kTileW;
  tc::load_window_tc<C>(win, x + static_cast<long long>(b) * C * H * W, H, W,
                        iy0 - 1, ix0 - 1, kWinH, kWinW, deconv_slot);
  STEM_PHASE(1);
  int q = tc::gdn_window_tc<C, true>(win, kSlots, ring, 0, beta);
  STEM_PHASE(2);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = 2 * (warp >> 2) + ((warp & 3) >> 1);  // row in the pass
  const int wcol = (warp & 1) * 16;                      // first column
  bf16* ob = out + static_cast<long long>(b) * O * 4 * H * W;

#pragma unroll 1
  for (int pass = 0; pass < kTileH / kPassRows; ++pass) {
    // this warp's 16 pixels as A rows, at the tap (dy, dx) = (-1, -1)
    const int row = pass * kPassRows + wrow;
    const uint32_t apix = tc::a_row<C>(win_u32, row * kWinW + wcol, kSlots);
#pragma unroll 1
    for (int ph = 0; ph < 4; ++ph) {
      const int pa = ph >> 1, pb = ph & 1;
      // acc[j][e]: pixel wcol + g + 8·(e / 2), channel o = 8j + 2t + e % 2
      float acc[O / 8][4];
      tc::init_bias<O>(acc, bias, 0);
#pragma unroll 1
      for (int dy = pa ? 0 : -1; dy <= 1; ++dy) {
#pragma unroll 1
        for (int dx = pb ? 0 : -1; dx <= 1; ++dx) {
          const uint32_t off =
              ((dy + 1) * kWinW + (dx + 1)) * (L::kStride * 2);
#pragma unroll 1
          for (int kc = 0; kc < KC; ++kc)
            tc::conv_stage_wg<O>(acc, ring.next(q++), apix, off + kc * 128);
        }
      }
      const int iy = iy0 + row;
      if (iy < H) {
        const long long plane8 = 8 * 4LL * H * W;  // 8 output channels
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ix = ix0 + wcol + g + 8 * (e >> 1);
          if (ix >= W) continue;
          bf16* dst = ob + out_index(2 * t + (e & 1), iy, ix, pa, pb, H, W);
#pragma unroll
          for (int j = 0; j < O / 8; ++j, dst += plane8)
            *dst = __float2bfloat16_rn(acc[j][e]);
        }
      }
    }
  }
  STEM_PHASE(3);
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

template <int C>
int launch_wide(const bf16* x, const bf16* gamma_s, const float* beta,
                const bf16* w, const float* bias, bf16* out, long long batch,
                int H, int W, cudaStream_t stream) {
  int tiles_w;
  long long tiles;
  if (!grid_of(batch, H, W, &tiles_w, &tiles)) return cudaErrorInvalidValue;
  const size_t smem = tc::Layout<C>::bytes(kSlots);
  cudaError_t err = tc::allow_smem(igdn_deconv_wide_kernel<C>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  igdn_deconv_wide_kernel<C>
      <<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(batch)),
         tc::kThreads, smem, stream>>>(x, gamma_s, beta, w, bias, out, H, W,
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

// x (B, C, H, W) bf16; gamma_s (C/32, C, 64) bf16 = γ split into hi and
// lo (ops/kernels.py::split_gamma); beta (C,) f32; w (25, C/64, O, 64) bf16
// (see igdn_deconv_wide_kernel); bias (O,) f32; out (B, O, 2H, 2W) bf16.
// C = O ∈ {64, 128, 192}.
int stem_igdn_deconv_wide_bf16(const void* x, const void* gamma_s,
                               const float* beta, const void* w,
                               const float* bias, void* out, long long batch,
                               int C, int O, int H, int W, void* stream) {
  using stem::bf16;
  if (batch == 0 || H == 0 || W == 0) return 0;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gs = static_cast<const bf16*>(gamma_s);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C != O) return cudaErrorInvalidValue;
  if (C == 64)
    return stem::launch_wide<64>(xb, gs, beta, wb, bias, ob, batch, H, W, s);
  if (C == 128)
    return stem::launch_wide<128>(xb, gs, beta, wb, bias, ob, batch, H, W, s);
  if (C == 192)
    return stem::launch_wide<192>(xb, gs, beta, wb, bias, ob, batch, H, W, s);
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
