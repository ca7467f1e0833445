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
// Both kernels run on gdn_window_tc.cuh: one block of two warpgroups per
// 8 × 32 input tile of one image, whose window of 10 × 34 pixels × C is
// loaded once and IGDN'd in place on the tensor cores (split-bf16 norm at
// f32 accuracy); the deconv then runs on wgmma with the window pixels as
// rows (ldmatrix), its weights streaming through the header's 3-slot
// cp.async ring after γ's split, so every staged tile serves all the
// block's pixels. A partial tile at the right or bottom edge loads zeros
// past the image and stores nothing there.
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
// At C = 256 the ring of 3 × 256 rows would not fit beside the window
// (340 × 528 B = 179,520 B), so O runs in two groups of 128 (wgmma N 128,
// 64 accumulators per thread) over one window, the norm in two chunks of
// 128, and the ring holds 128 rows: 229,696 B.
// Registers (nvcc -Xptxas -v): 198 / 146 / 103 at C = 192 / 128 / 64, 167
// at 256, no spills. Measured (PERF.md §6, kernel table) on an NVIDIA H100
// 80GB HBM3 at 700 W: 4.11 ms at 272 × 480 and 1.54 ms at 136 × 240; a
// block at 272 × 480 takes about 423k cycles, 6 % window load, 16 % norm,
// 78 % conv (PERF.md §5-6). At C = 256: 6.65 ms at 272 × 480, 2.08 ms at
// 136 × 240.
//
// igdn_deconv_narrow_kernel (C → F ≤ 32): bound on the H100 by its norm,
// 1.5e11 f32 operations at F = 3 and 544 × 960 × 192 against 1.2e10 of
// deconv: 0.44 ms with the norm shared between the CUDA cores and the
// tensor cores (PERF.md §6, kernel table), 2.3 ms on the CUDA cores
// alone, so it runs on the tensor cores as the wide kernel's does. All 4
// phases share one implicit GEMM on wgmma with the pixels as rows and
// N = rows GEMM columns (row = o·4 + a·2 + b; rows ≥ 4F are zero) over the
// 9 taps of the 3 × 3 neighbourhood, K = 9·C, the unused (phase, tap)
// weights being zero. rows = 16 (wgmma m64n16) for F ≤ 4, else
// 32·⌈F/8⌉ ≤ 128. Each warpgroup takes MT = 2 m-tiles of 64 pixels at
// once where N ≤ 64 (one sweep over the weights), else one at a time in two
// sweeps, so the accumulators stay at ≤ 64 per thread. A ring stage holds
// KS = C/64 chunks of 64 channels (a whole tap) where the slot has room
// (KS·rows ≤ the norm's chunk of rows: C up to 192, 128 at 256), else one:
// 9 stages a sweep at F ≤ 4 and C = 192, each issuing all its wgmmas
// before one wait. Shared memory at C = 192: window 136,000 B + ring 3 ×
// 192 rows × 128 B = 73,728 B + up to 1,024 B = 210,752 B; at C = 256
// 179,520 B + 3 × 128 rows × 128 B + 1,024 B = 229,696 B. Registers (nvcc
// -Xptxas -v) at C = 256 / 192 / 128 / 64: 170 / 143 / 110 / 93 (rows
// 16), 190 / 154 / 122 / 91 (32), 143 / 190 / 154 / 123 (64), 147 / 145 /
// 135 / 157 (96), 163 / 168 / 164 / 182 (128), no spills.
// Measured (PERF.md §6, kernel table) on an NVIDIA H100 80GB HBM3 at 700 W:
// 3.75-3.93 ms at 544 × 960 → 3 (5.85-5.91 at C = 256); a block takes
// about 98k cycles, 18 % window load, 66 % norm, 16 % conv (PERF.md
// §5-6).

#include "gdn_window_tc.cuh"

namespace stem {
namespace {

using tc::bf16;

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

// The wide kernel's shape at C = O channels: G groups of OG = O / G output
// channels, one after another over the same window (a warpgroup's wgmma N
// = OG), and ring slots of the larger of a norm chunk's rows and OG. Up to
// 192 one group; at 256 two of 128, so that the ring of 3 × 128 rows fits
// beside the window of 264-bf16 slots.
template <int C>
struct Wide {
  static constexpr int G = C <= 192 ? 1 : 2;
  static constexpr int OG = C / G;
  static constexpr int kSlotRows =
      tc::norm_chunk<C>() > OG ? tc::norm_chunk<C>() : OG;
  __host__ __device__ static constexpr size_t smem() {
    return tc::Layout<C>::window_bytes(kSlots) + 1024 +
           static_cast<size_t>(tc::kStages) * kSlotRows * tc::kRowBytes;
  }
};

// Warpgroups: 2 along the 128 pixels of a pass (two input rows × 32
// columns each), every channel of one output group; warp w of a warpgroup
// owns 16 pixels (row w / 2, columns (w % 2)·16 + 0..15).
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
  using S = Wide<C>;
  constexpr int O = C, G = S::G, OG = S::OG;
  static_assert(S::smem() <= 232448, "shared memory of a block");
  constexpr int KC = C / 64;   // ring stages per tap
  constexpr int kPassRows = 4;
  constexpr int kNorm = tc::norm_stages<C>(kSlots);
  constexpr int kGroupStages = 25 * KC;
  constexpr int kPassStages = G * kGroupStages;
  constexpr int kStagesAll = kNorm + (kTileH / kPassRows) * kPassStages;
  using L = tc::Layout<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* win = reinterpret_cast<bf16*>(smem);
  const uint32_t win_u32 = tc::smem_u32(smem);

  const auto ring = tc::make_ring_fn<S::kSlotRows>(
      tc::ring_base<C>(smem, kSlots), kStagesAll, [=](uint32_t dst, int q) {
        if (q < kNorm) {
          tc::load_stage<tc::norm_chunk<C>()>(dst,
                                              tc::norm_src<C>(gamma_s, q));
        } else {  // group s / 25·KC, stage s % 25·KC of the pass
          const int s = (q - kNorm) % kPassStages;
          tc::load_stage<OG>(dst, w + ((s % kGroupStages) * O +
                                       (s / kGroupStages) * OG) * 64);
        }
      });
  ring.prefetch();

  const int b = blockIdx.y;
  const int iy0 = (blockIdx.x / tiles_w) * kTileH;
  const int ix0 = (blockIdx.x % tiles_w) * kTileW;
  tc::load_window_tc<C>(win, x + static_cast<long long>(b) * C * H * W, H, W,
                        iy0 - 1, ix0 - 1, kWinH, kWinW, deconv_slot);
  int q = tc::gdn_window_tc<C, true>(win, kSlots, ring, 0, beta);

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
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll 1
      for (int ph = 0; ph < 4; ++ph) {
        const int pa = ph >> 1, pb = ph & 1;
        // acc[j][e]: pixel wcol + g + 8·(e / 2), channel
        // o = gi·OG + 8j + 2t + e % 2
        float acc[OG / 8][4];
        tc::init_bias<OG>(acc, bias, gi * OG);
#pragma unroll 1
        for (int dy = pa ? 0 : -1; dy <= 1; ++dy) {
#pragma unroll 1
          for (int dx = pb ? 0 : -1; dx <= 1; ++dx) {
            const uint32_t off =
                ((dy + 1) * kWinW + (dx + 1)) * (L::kStride * 2);
#pragma unroll 1
            for (int kc = 0; kc < KC; ++kc)
              tc::conv_stage_wg<OG>(acc, ring.next(q++), apix,
                                    off + kc * 128);
          }
        }
        const int iy = iy0 + row;
        if (iy < H) {
          const long long plane8 = 8 * 4LL * H * W;  // 8 output channels
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ix = ix0 + wcol + g + 8 * (e >> 1);
            if (ix >= W) continue;
            bf16* dst = ob + out_index(gi * OG + 2 * t + (e & 1), iy, ix,
                                       pa, pb, H, W);
#pragma unroll
            for (int j = 0; j < OG / 8; ++j, dst += plane8)
              *dst = __float2bfloat16_rn(acc[j][e]);
          }
        }
      }
    }
  }
}

// One stage of the narrow kernel's GEMM: KS chunks of 64 input channels of
// one tap for MT m-tiles of the warpgroup's pixels (this warp's 16 of m-tile
// mt at apix[mt] + aoff, as a_row addresses them) × all N rows of the ring
// slot wslot (chunk ks at wslot + ks·N·128):
//   acc[mt][n-tile][e] += Σ_c win[pixel + tap][c] · W[tap][row][c].
// Issues every wgmma before it waits for them.
template <int N, int MT, int KS>
__device__ __forceinline__ void narrow_stage(float (&acc)[MT][N / 8][4],
                                             uint32_t wslot,
                                             const uint32_t (&apix)[MT],
                                             uint32_t aoff) {
  uint32_t a[MT][KS][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::ldmatrix_x4(a[mt][ks][kk], apix[mt] + aoff + ks * 128 + kk * 32);
  tc::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    const uint64_t d = tc::ring_desc(wslot + ks * N * tc::kRowBytes);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        tc::wgmma<N>(acc[mt], a[mt][ks][kk], d + kk * 2);
  }
  tc::wgmma_commit();
  tc::wgmma_wait_all();
}

// The narrow kernel's shape at C channels and N GEMM rows: MT m-tiles of 64
// pixels per warpgroup in each of kSweeps sweeps over the weights (4 m-tiles
// a block), and KS chunks of 64 channels per ring stage (a whole tap where
// the slot holds it).
template <int C, int N>
struct Narrow {
  static constexpr int KC = C / 64;
  static constexpr int MT = N <= 64 ? 2 : 1;
  static constexpr int kSweeps = 2 / MT;
  static constexpr int kNormRows = tc::norm_chunk<C>();  // γ's stage rows
  static constexpr int KS = KC * N <= kNormRows ? KC : 1;
  static constexpr int kSlotRows = (kNormRows > KS * N ? kNormRows : KS * N);
  __host__ __device__ static constexpr size_t smem() {
    return tc::Layout<C>::window_bytes(kSlots) + 1024 +
           static_cast<size_t>(tc::kStages) * kSlotRows * tc::kRowBytes;
  }
};

// Warpgroups: 2 along the 128 pixels of a pass (two input rows × 32
// columns each, as the wide kernel's), all N GEMM rows; warp w of a
// warpgroup owns 16 pixels (row w / 2, columns (w % 2)·16 + 0..15).
// gamma_s: (C/32, C, 64) bf16 (ops/kernels.py::split_gamma); w: (9, C/64,
// N, 64) bf16, GEMM row o·4 + a·2 + b of tap (dy + 1)·3 + (dx + 1), zero
// past 4F and where the tap is past the 5 × 5 kernel (ops/kernels.py::
// pack_narrow_weight); bias_m: (N,) f32, zero past 4F.
template <int C, int N>
__global__ void __launch_bounds__(tc::kThreads, 1)
igdn_deconv_narrow_kernel(const bf16* __restrict__ x,
                          const bf16* __restrict__ gamma_s,
                          const float* __restrict__ beta,
                          const bf16* __restrict__ w,
                          const float* __restrict__ bias_m,
                          bf16* __restrict__ out, int F, int H, int W,
                          int tiles_w) {
  using S = Narrow<C, N>;
  static_assert(S::smem() <= 232448, "shared memory of a block");
  constexpr int MT = S::MT, KS = S::KS;
  constexpr int kNorm = tc::norm_stages<C>(kSlots);
  constexpr int kSweepStages = 9 * S::KC / KS;
  constexpr int kStagesAll = kNorm + S::kSweeps * kSweepStages;
  using L = tc::Layout<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* win = reinterpret_cast<bf16*>(smem);
  const uint32_t win_u32 = tc::smem_u32(smem);

  const auto ring = tc::make_ring_fn<S::kSlotRows>(
      tc::ring_base<C>(smem, kSlots), kStagesAll, [=](uint32_t dst, int q) {
        if (q < kNorm)
          tc::load_stage<S::kNormRows>(dst, tc::norm_src<C>(gamma_s, q));
        else
          tc::load_stage<KS * N>(
              dst, w + ((q - kNorm) % kSweepStages) * (KS * N * 64));
      });
  ring.prefetch();

  const int b = blockIdx.y;
  const int iy0 = (blockIdx.x / tiles_w) * kTileH;
  const int ix0 = (blockIdx.x % tiles_w) * kTileW;
  tc::load_window_tc<C>(win, x + static_cast<long long>(b) * C * H * W, H, W,
                        iy0 - 1, ix0 - 1, kWinH, kWinW, deconv_slot);
  int q = tc::gdn_window_tc<C, true>(win, kSlots, ring, 0, beta);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = 2 * (warp >> 2) + ((warp & 3) >> 1);  // row in 4
  const int wcol = (warp & 1) * 16;                      // first column
  bf16* ob = out + static_cast<long long>(b) * F * 4 * H * W;

#pragma unroll 1
  for (int sweep = 0; sweep < S::kSweeps; ++sweep) {
    // m-tile mt: input rows 4·(sweep·MT + mt) + 0..3, this warp's at wrow
    uint32_t apix[MT];
    float acc[MT][N / 8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row = 4 * (sweep * MT + mt) + wrow;
      apix[mt] = tc::a_row<C>(win_u32, row * kWinW + wcol, kSlots);
      tc::init_bias<N>(acc[mt], bias_m, 0);
    }
#pragma unroll 1
    for (int s = 0; s < kSweepStages; ++s) {
      const int tap = s / (S::KC / KS), kc0 = (s % (S::KC / KS)) * KS;
      const uint32_t off =
          ((tap / 3) * kWinW + tap % 3) * (L::kStride * 2) + kc0 * 128;
      narrow_stage<N, MT, KS>(acc, ring.next(q++), apix, off);
    }
    // acc[mt][j][e]: pixel wcol + g + 8·(e / 2) of the m-tile's row, GEMM
    // row n = 8j + 2t + e % 2 = o·4 + a·2 + b; e and e + 1 are b = 0, 1 of
    // one (o, a), two neighbouring output columns
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int iy = iy0 + 4 * (sweep * MT + mt) + wrow;
      if (iy >= H) continue;
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int ix = ix0 + wcol + g + 8 * (e >> 1);
        if (ix >= W) continue;
#pragma unroll
        for (int j = 0; j < N / 8; ++j) {
          const int n = 8 * j + 2 * t;
          if (n >= 4 * F) continue;
          *reinterpret_cast<__nv_bfloat162*>(
              ob + out_index(n >> 2, iy, ix, (n >> 1) & 1, 0, H, W)) =
              __floats2bfloat162_rn(acc[mt][j][e], acc[mt][j][e + 1]);
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
  const size_t smem = Wide<C>::smem();
  cudaError_t err = tc::allow_smem(igdn_deconv_wide_kernel<C>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  igdn_deconv_wide_kernel<C>
      <<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(batch)),
         tc::kThreads, smem, stream>>>(x, gamma_s, beta, w, bias, out, H, W,
                                       tiles_w);
  return static_cast<int>(cudaGetLastError());
}

template <int C, int N>
int launch_narrow(const bf16* x, const bf16* gamma_s, const float* beta,
                  const bf16* w, const float* bias_m, bf16* out,
                  long long batch, int F, int H, int W, cudaStream_t stream) {
  int tiles_w;
  long long tiles;
  if (!grid_of(batch, H, W, &tiles_w, &tiles)) return cudaErrorInvalidValue;
  const size_t smem = Narrow<C, N>::smem();
  cudaError_t err = tc::allow_smem(igdn_deconv_narrow_kernel<C, N>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  igdn_deconv_narrow_kernel<C, N>
      <<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(batch)),
         tc::kThreads, smem, stream>>>(x, gamma_s, beta, w, bias_m, out, F,
                                       H, W, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_narrow_rows(const bf16* x, const bf16* gamma_s, const float* beta,
                       const bf16* w, const float* bias_m, bf16* out,
                       long long batch, int F, int rows, int H, int W,
                       cudaStream_t stream) {
  switch (rows) {
    case 16:
      return launch_narrow<C, 16>(x, gamma_s, beta, w, bias_m, out, batch,
                                  F, H, W, stream);
    case 32:
      return launch_narrow<C, 32>(x, gamma_s, beta, w, bias_m, out, batch,
                                  F, H, W, stream);
    case 64:
      return launch_narrow<C, 64>(x, gamma_s, beta, w, bias_m, out, batch,
                                  F, H, W, stream);
    case 96:
      return launch_narrow<C, 96>(x, gamma_s, beta, w, bias_m, out, batch,
                                  F, H, W, stream);
    case 128:
      return launch_narrow<C, 128>(x, gamma_s, beta, w, bias_m, out, batch,
                                   F, H, W, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace stem

extern "C" {

// x (B, C, H, W) bf16; gamma_s (C/32, C, 64) bf16 = γ split into hi and
// lo (ops/kernels.py::split_gamma); beta (C,) f32; w (25, C/64, O, 64) bf16
// (see igdn_deconv_wide_kernel); bias (O,) f32; out (B, O, 2H, 2W) bf16.
// C = O ∈ {64, 128, 192, 256}.
int stem_igdn_deconv_wide_bf16(const void* x, const void* gamma_s,
                               const float* beta, const void* w,
                               const float* bias, void* out, long long batch,
                               int C, int O, int H, int W, void* stream) {
  using stem::tc::bf16;
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
  if (C == 256)
    return stem::launch_wide<256>(xb, gs, beta, wb, bias, ob, batch, H, W, s);
  return cudaErrorInvalidValue;
}

// x (B, C, H, W) bf16; gamma_s (C/32, C, 64) bf16 = γ split into hi and
// lo (ops/kernels.py::split_gamma); beta (C,) f32; w (9, C/64, rows, 64)
// bf16 (see igdn_deconv_narrow_kernel); bias_m (rows,) f32; out
// (B, F, 2H, 2W) bf16. C ∈ {64, 128, 192, 256}, 1 ≤ F ≤ 32, rows = 16 for F ≤ 4
// and 32·⌈F/8⌉ otherwise (ops/kernels.py::narrow_rows).
int stem_igdn_deconv_narrow_bf16(const void* x, const void* gamma_s,
                                 const float* beta, const void* w,
                                 const float* bias_m, void* out,
                                 long long batch, int C, int F, int rows,
                                 int H, int W, void* stream) {
  using stem::tc::bf16;
  if (batch == 0 || H == 0 || W == 0) return 0;
  if (F < 1 || F > 32) return cudaErrorInvalidValue;
  if (rows != (F <= 4 ? 16 : 32 * ((F + 7) / 8))) return cudaErrorInvalidValue;
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* gs = static_cast<const bf16*>(gamma_s);
  const bf16* wb = static_cast<const bf16*>(w);
  bf16* ob = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C == 64)
    return stem::launch_narrow_rows<64>(xb, gs, beta, wb, bias_m, ob, batch,
                                        F, rows, H, W, s);
  if (C == 128)
    return stem::launch_narrow_rows<128>(xb, gs, beta, wb, bias_m, ob, batch,
                                         F, rows, H, W, s);
  if (C == 192)
    return stem::launch_narrow_rows<192>(xb, gs, beta, wb, bias_m, ob, batch,
                                         F, rows, H, W, s);
  if (C == 256)
    return stem::launch_narrow_rows<256>(xb, gs, beta, wb, bias_m, ob, batch,
                                         F, rows, H, W, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
