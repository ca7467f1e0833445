// Shared device code of the fused (I)GDN + convolution kernels
// (gdn_conv.cu, igdn_deconv.cu), for sm_90a.
//
// Each of those kernels follows the same three steps:
//   1. load_window: the block copies the input window of its output tile from
//      NCHW bf16 device memory into shared memory, pixel-major with the
//      channels contiguous ([slot][C + 8]); pixels outside the image are 0.
//   2. gdn_window: (I)GDN of every window pixel, in place: x² and the channel
//      product with γᵀ (staged 16 rows at a time) in f32 on the CUDA cores,
//      then x·rsqrt(norm) (IGDN: x·sqrt(norm)) rounded to bf16. A pixel's norm
//      needs only its own channels, so a chunk of 64 pixels is normalised in
//      place once every warp has read it. Zero padding stays zero.
//   3. mma_tap: the convolution as an implicit GEMM on the tensor cores
//      (mma.sync m16n8k16, bf16 operands, f32 accumulators): A = weights
//      [tap][M][C] read from device memory (L2-resident), B = window pixels
//      read from shared memory.
//
// The window's pixel stride is C + 8 bf16 = C/2 + 4 words, ≡ 4 (mod 32) for
// C ≡ 0 (mod 64): eight consecutive slots then cover all 32 banks, so both
// the 16-byte norm loads and the 4-byte B-fragment loads of 8 consecutive
// pixels are free of bank conflicts.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace stem {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kNormK = 16;     // γᵀ rows staged per step of the norm
constexpr int kNormPix = 64;   // window pixels normalised per chunk

template <int C>
struct Window {
  static_assert(C % 64 == 0, "channels must be a multiple of 64");
  static constexpr int kStride = C + 8;  // bf16 elements per window slot
  // dynamic shared memory for n_slots window pixels plus the γᵀ stage
  static constexpr size_t bytes(int n_slots) {
    return static_cast<size_t>(n_slots) * kStride * sizeof(bf16) +
           static_cast<size_t>(kNormK) * C * sizeof(float);
  }
};

// Copy rows [y0, y0 + rows) × cols [x0, x0 + cols) of image b (NCHW, C
// channels, H×W) into the window; element (r, c) goes to slot slot_of(r, c).
// Outside the image the window holds 0.
template <int C, typename SlotFn>
__device__ __forceinline__ void load_window(bf16* win,
                                            const bf16* __restrict__ xb,
                                            int H, int W, int y0, int x0,
                                            int rows, int cols,
                                            SlotFn slot_of) {
  constexpr int CP = Window<C>::kStride;
  const int per_ch = rows * cols;
  const int total = C * per_ch;
  const bf16 zero = __float2bfloat16_rn(0.f);
#pragma unroll 4
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int c = e / per_ch;
    const int rem = e - c * per_ch;
    const int r = rem / cols;
    const int col = rem - r * cols;
    const int iy = y0 + r, ix = x0 + col;
    bf16 v = zero;
    if (iy >= 0 && iy < H && ix >= 0 && ix < W)
      v = xb[(static_cast<long long>(c) * H + iy) * W + ix];
    win[slot_of(r, col) * CP + c] = v;
  }
}

__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    out[2 * q] = f.x;
    out[2 * q + 1] = f.y;
  }
}

// The 16 squares x[p][k0 .. k0+16) in f32 (zeros for a slot past the end).
template <int C>
__device__ __forceinline__ void load_squares(const bf16* win, int p, bool valid,
                                             int k0, float (&sq)[kNormK]) {
  constexpr int CP = Window<C>::kStride;
  if (valid) {
    const uint4* src = reinterpret_cast<const uint4*>(win + p * CP + k0);
    unpack8(src[0], sq);
    unpack8(src[1], sq + 8);
#pragma unroll
    for (int k = 0; k < kNormK; ++k) sq[k] *= sq[k];
  } else {
#pragma unroll
    for (int k = 0; k < kNormK; ++k) sq[k] = 0.f;
  }
}

// win[p][o0 .. o0+OW) ← x · rsqrt(norm) (IGDN: x · sqrt(norm)), in bf16.
template <int C, bool INVERSE>
__device__ __forceinline__ void scale_slot(bf16* row,
                                           const float (&acc)[C / 8], int o0,
                                           const float* __restrict__ beta) {
  constexpr int OW = C / 8;
#pragma unroll
  for (int j = 0; j < OW; j += 8) {
    uint4 raw = *reinterpret_cast<const uint4*>(row + o0 + j);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 x = __bfloat1622float2(h[q]);
      const float n0 = acc[j + 2 * q] + __ldg(beta + o0 + j + 2 * q);
      const float n1 = acc[j + 2 * q + 1] + __ldg(beta + o0 + j + 2 * q + 1);
      const float y0 = INVERSE ? x.x * sqrtf(n0) : x.x * rsqrtf(n0);
      const float y1 = INVERSE ? x.y * sqrtf(n1) : x.y * rsqrtf(n1);
      h[q] = __floats2bfloat162_rn(y0, y1);
    }
    *reinterpret_cast<uint4*>(row + o0 + j) = raw;
  }
}

// In-place (I)GDN of window slots [0, n_slots):
//   win[p][o] = x[p][o] · rsqrt(β[o] + Σ_i γᵀ[i][o] · x[p][i]²)
// with f32 squares, sums and (r)sqrt. Warp w owns output channels
// [w·C/8, (w+1)·C/8); lane l owns slots p0 + l and p0 + 32 + l of the chunk.
// gs: kNormK × C floats of shared memory for the γᵀ stage.
template <int C, bool INVERSE>
__device__ void gdn_window(bf16* win, int n_slots, float* gs,
                           const float* __restrict__ gamma_t,
                           const float* __restrict__ beta) {
  constexpr int CP = Window<C>::kStride;
  constexpr int OW = C / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o0 = warp * OW;
  for (int p0 = 0; p0 < n_slots; p0 += kNormPix) {
    const int pa = p0 + lane, pb = p0 + 32 + lane;
    const bool va = pa < n_slots, vb = pb < n_slots;
    float acc_a[OW], acc_b[OW];
#pragma unroll
    for (int o = 0; o < OW; ++o) acc_a[o] = acc_b[o] = 0.f;
    for (int k0 = 0; k0 < C; k0 += kNormK) {
      __syncthreads();  // everyone is done with the previous γᵀ stage
      const float4* src = reinterpret_cast<const float4*>(gamma_t + k0 * C);
      float4* dst = reinterpret_cast<float4*>(gs);
      for (int e = threadIdx.x; e < kNormK * C / 4; e += kThreads)
        dst[e] = __ldg(src + e);
      __syncthreads();
      float sa[kNormK], sb[kNormK];
      load_squares<C>(win, pa, va, k0, sa);
      load_squares<C>(win, pb, vb, k0, sb);
#pragma unroll
      for (int k = 0; k < kNormK; ++k) {
        const float4* g4 = reinterpret_cast<const float4*>(gs + k * C + o0);
#pragma unroll
        for (int j = 0; j < OW / 4; ++j) {
          const float4 g = g4[j];
          acc_a[4 * j] = fmaf(sa[k], g.x, acc_a[4 * j]);
          acc_a[4 * j + 1] = fmaf(sa[k], g.y, acc_a[4 * j + 1]);
          acc_a[4 * j + 2] = fmaf(sa[k], g.z, acc_a[4 * j + 2]);
          acc_a[4 * j + 3] = fmaf(sa[k], g.w, acc_a[4 * j + 3]);
          acc_b[4 * j] = fmaf(sb[k], g.x, acc_b[4 * j]);
          acc_b[4 * j + 1] = fmaf(sb[k], g.y, acc_b[4 * j + 1]);
          acc_b[4 * j + 2] = fmaf(sb[k], g.z, acc_b[4 * j + 2]);
          acc_b[4 * j + 3] = fmaf(sb[k], g.w, acc_b[4 * j + 3]);
        }
      }
    }
    __syncthreads();  // every warp has read this chunk's raw channels
    if (va) scale_slot<C, INVERSE>(win + pa * CP, acc_a, o0, beta);
    if (vb) scale_slot<C, INVERSE>(win + pb * CP, acc_b, o0, beta);
  }
  __syncthreads();  // the normalised window is visible to every warp
}

__device__ __forceinline__ uint32_t ldg32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// d += a · b for one m16n8k16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One tap of the implicit GEMM for a warp's MT × NT tiles of 16 rows × 8
// pixels, over all C input channels:
//   acc[mt][nt] += W[tap][m0 + 16·mt + (0..16)][:] · win[slot(pixel) + off][:]
// wt points at W[tap][m0 + g][2t] (g = lane / 4, t = lane % 4), rows C apart;
// slot[nt] is the window slot of this lane's B column (pixel g of tile nt)
// at offset 0. Fragment layouts are those of the PTX ISA for
// mma.m16n8k16 with .bf16 (A row-major, B column-major).
template <int C, int MT, int NT>
__device__ __forceinline__ void mma_tap(float (&acc)[MT][NT][4],
                                        const bf16* win, const int (&slot)[NT],
                                        int off, const bf16* __restrict__ wt) {
  constexpr int CP = Window<C>::kStride;
  const int t2 = (threadIdx.x & 3) * 2;
#pragma unroll 4
  for (int k0 = 0; k0 < C; k0 += 16) {
    uint32_t a[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const bf16* p = wt + static_cast<long long>(mt) * 16 * C + k0;
      a[mt][0] = ldg32(p);
      a[mt][1] = ldg32(p + 8 * C);
      a[mt][2] = ldg32(p + 8);
      a[mt][3] = ldg32(p + 8 * C + 8);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* q = win + (slot[nt] + off) * CP + k0 + t2;
      const uint32_t b0 = lds32(q), b1 = lds32(q + 8);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
    }
  }
}

// acc[mt][nt] ← bias of its rows: fragment entries 0, 1 are row g, 2, 3 row g+8.
template <int MT, int NT>
__device__ __forceinline__ void init_bias(float (&acc)[MT][NT][4],
                                          const float* __restrict__ bias,
                                          int m0, int n_rows) {
  const int g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = m0 + 16 * mt + g, r1 = r0 + 8;
    const float b0 = r0 < n_rows ? __ldg(bias + r0) : 0.f;
    const float b1 = r1 < n_rows ? __ldg(bias + r1) : 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[mt][nt][0] = acc[mt][nt][1] = b0;
      acc[mt][nt][2] = acc[mt][nt][3] = b1;
    }
  }
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace stem
