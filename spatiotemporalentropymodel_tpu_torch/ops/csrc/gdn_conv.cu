// gdn_conv_fused: conv_k5s2(GDN(x)) + b, bf16 in and out, for sm_90a.
//
// Replaces spatiotemporalentropymodel_tpu/ops/pallas_kernels.py::
// gdn_conv_fused (its three TPU input paths _pair_conv_kernel,
// _pair_conv_halo_kernel and _pair_conv_dma_kernel compute one op). On NCHW
// x (B, C, H, W) bf16, conv weight W[o][c][ky][kx], bias (O,):
//
//   g[c]        = bf16( x[c] · rsqrt(β[c] + Σ_i γᵀ[i][c] · x[i]²) )   (f32 math)
//   out[o, y, x] = bf16( b[o] + Σ_{c,ky,kx} W[o][c][ky][kx] · g[c, 2y+ky-2, 2x+kx-2] )
//
// with the conv summed in f32. The GDN'd input never reaches device memory.
//
// Bound on the H100, at g_a's first stage (4 × 192 × 544 × 960 → 272 × 480):
// 9.6e11 conv operations (0.97 ms on the bf16 tensor cores) and 1.5e11 f32
// norm operations (2.3 ms on the CUDA cores), against 0.3 ms of memory
// traffic. So the norm, not the bytes, is the bound: the norm runs as f32
// FMAs from registers with γᵀ broadcast from shared memory, and the conv runs
// on the tensor cores (mma.sync). Design: one block per 4 × 16 output tile of
// one image, all O channels. Its input window of 11 × 35 pixels × C (154 KB
// at C = 192, opt-in dynamic shared memory) is loaded once, normalised in
// place (gdn_window.cuh) and consumed by the 25 taps of an implicit GEMM
// (M = O, N = 64 pixels, K = 25·C). Halo pixels are normalised again by the
// neighbouring block: 385 window pixels for 256 input pixels of the tile.
// Window columns are stored even ones first, then odd ones, so the stride-2
// taps read consecutive slots (no bank conflicts). wgmma/TMA, a pipelined
// weight stage and a tensor-core norm are later work.

#include "gdn_window.cuh"

namespace stem {
namespace {

constexpr int kTileH = 4, kTileW = 16;           // output pixels per block
constexpr int kWinH = 2 * kTileH + 3;            // 11 input rows
constexpr int kWinW = 2 * kTileW + 3;            // 35 input columns
constexpr int kHalf = (kWinW + 1) / 2;           // 18 even columns
constexpr int kSlots = kWinH * kWinW;            // 385

__device__ __forceinline__ int conv_slot(int r, int c) {
  return r * kWinW + (c & 1) * kHalf + (c >> 1);
}

// Warps: 4 along the output channels (O/4 each = MT m-tiles of 16) × 2 along
// the pixels (32 each = 4 n-tiles of 8, i.e. two output rows of the tile).
template <int C, int O>
__global__ void __launch_bounds__(kThreads, 1)
gdn_conv_kernel(const bf16* __restrict__ x, const float* __restrict__ gamma_t,
                const float* __restrict__ beta, const bf16* __restrict__ w,
                const float* __restrict__ bias, bf16* __restrict__ out, int H,
                int W, int Ho, int Wo, int tiles_w) {
  static_assert(O % 64 == 0, "output channels must be a multiple of 64");
  constexpr int MT = O / 64;
  constexpr int NT = 4;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* win = reinterpret_cast<bf16*>(smem);
  float* gs = reinterpret_cast<float*>(
      smem + static_cast<size_t>(kSlots) * Window<C>::kStride * sizeof(bf16));

  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_w) * kTileH;
  const int ox0 = (blockIdx.x % tiles_w) * kTileW;
  const bf16* xb = x + static_cast<long long>(b) * C * H * W;

  load_window<C>(win, xb, H, W, 2 * oy0 - 2, 2 * ox0 - 2, kWinH, kWinW,
                 conv_slot);
  gdn_window<C, false>(win, kSlots, gs, gamma_t, beta);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp & 3) * (O / 4);
  const int wn = warp >> 2;
  // n-tile j = 4·wn + nt covers output row j / 2, columns (j % 2)·8 + 0..7
  int slot[NT];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int j = 4 * wn + nt;
    slot[nt] = 2 * (j >> 1) * kWinW + (j & 1) * 8 + g;
  }

  float acc[MT][NT][4];
  init_bias(acc, bias, m0, O);
  const bf16* wl = w + static_cast<long long>(m0 + g) * C + 2 * t;
#pragma unroll 1
  for (int ky = 0; ky < 5; ++ky) {
#pragma unroll 1
    for (int kx = 0; kx < 5; ++kx) {
      const int off = ky * kWinW + (kx & 1) * kHalf + (kx >> 1);
      mma_tap<C, MT, NT>(acc, win, slot, off,
                         wl + static_cast<long long>(ky * 5 + kx) * O * C);
    }
  }

  bf16* ob = out + static_cast<long long>(b) * O * Ho * Wo;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int j = 4 * wn + nt;
    const int oy = oy0 + (j >> 1);
    if (oy >= Ho) continue;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int ox = ox0 + (j & 1) * 8 + 2 * t + (q & 1);
      if (ox >= Wo) continue;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int o = m0 + 16 * mt + g + (q >> 1) * 8;
        ob[(static_cast<long long>(o) * Ho + oy) * Wo + ox] =
            __float2bfloat16_rn(acc[mt][nt][q]);
      }
    }
  }
}

template <int C, int O>
int launch(const bf16* x, const float* gamma_t, const float* beta,
           const bf16* w, const float* bias, bf16* out, long long batch,
           int H, int W, cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int tiles_w = (Wo + kTileW - 1) / kTileW;
  const long long tiles =
      static_cast<long long>((Ho + kTileH - 1) / kTileH) * tiles_w;
  if (batch > 65535 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = Window<C>::bytes(kSlots);
  cudaError_t err = allow_smem(gdn_conv_kernel<C, O>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gdn_conv_kernel<C, O>
      <<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(batch)),
         kThreads, smem, stream>>>(x, gamma_t, beta, w, bias, out, H, W, Ho,
                                   Wo, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace stem

extern "C" {

// x (B, C, H, W) bf16; gamma_t (C, C) f32 = γ transposed; beta (C,) f32;
// w (25, O, C) bf16 = the conv weight as [ky·5 + kx][o][c]; bias (O,) f32;
// out (B, O, ⌈H/2⌉, ⌈W/2⌉) bf16. C = O ∈ {64, 128, 192}.
int stem_gdn_conv_fused_bf16(const void* x, const float* gamma_t,
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
    return stem::launch<64, 64>(xb, gamma_t, beta, wb, bias, ob, batch, H, W, s);
  if (C == 128 && O == 128)
    return stem::launch<128, 128>(xb, gamma_t, beta, wb, bias, ob, batch, H, W,
                                  s);
  if (C == 192 && O == 192)
    return stem::launch<192, 192>(xb, gamma_t, beta, wb, bias, ob, batch, H, W,
                                  s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
