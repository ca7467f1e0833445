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
// Design (gdn_window_tc.cuh): one block of two warpgroups per 4 × 16 output
// tile of one image, all O channels (half of them at (192, 320), below).
// Its input window of 11 × 35 pixels × C is loaded once, normalised in
// place on the tensor cores (split-bf16 norm at f32 accuracy on wgmma, 64
// window pixels per warpgroup over all C channels) and consumed by the 25
// taps of an implicit GEMM on wgmma with the 64 output pixels as rows (M =
// 64, K = 25·C): warpgroup wg takes output channels [wg·O/2, (wg + 1)·O/2)
// (N = O/2), its warp w output row w of the tile, whose 16 pixels it loads
// from the window with ldmatrix. γ's hi/lo split (32 channels a stage, C
// rows) and then the weights (64 channels of one tap a stage, O rows)
// stream through a 3-slot cp.async ring of max(C, O) rows a slot that both
// warpgroups read, so a block fetches each weight once: 1.84 MB of L2
// traffic per block at C = O = 192.
// The output width O may differ from C: g_a's last stage of a model with
// N ≠ M, GDN(N) → Conv(N → M), runs at (C, O) = (128, 192) and, in the
// zoo's N = 192, M = 320 models (mbt2018 and mbt2018-mean at quality 5-8,
// bmshj2018-* at 6-8), at (192, 320). There O is split across two blocks
// of OB = 160 channels (grid z; a warpgroup N of 80, wgmma m64n80k16), each
// of which loads and normalises the window itself: all 320 channels in one
// block would need a ring of 320 rows.
// Halo pixels are normalised again by the neighbouring block: 385 window
// pixels for 256 input pixels. Window columns are stored even ones first,
// then odd ones, so a stride-2 tap reads consecutive slots (conflict-free
// ldmatrix rows).
//
// Shared memory at C = O = 192: window 385 × 400 B = 154,000 B + ring 3 ×
// 192 rows × 128 B = 73,728 B + up to 1,024 B to align the ring: 228,752 B
// of the 232,448 B a block may have, so one block per SM. At (128, 192):
// 385 × 272 B = 104,720 B + 73,728 B + 1,024 B = 179,472 B. At (192, 320)
// a block's ring holds max(C, OB) = 192 rows, so it takes the 228,752 B of
// (192, 192); unsplit it would take 154,000 B + 3 × 320 × 128 B = 122,880 B
// + 1,024 B = 277,904 B.
// C = 256: a window slot is 264 bf16 (528 B), so the 4 × 16 tile's 385
// slots (203,280 B) leave the ring no room. A 4 × 14 tile (11 × 31 = 341
// slots, 180,048 B) leaves room for 128-row slots (49,152 B): 230,224 B
// at (256, 256), O in two groups of 128 (wgmma N 64 per warpgroup) over
// one normalised window; a 4 × 13 tile (319 slots, 168,432 B) for 160-row
// slots (61,440 B): 230,896 B at (256, 320), two groups of 160 (N 80).
// The norm runs in two chunks of 128 rows. A warp's A rows past the tile's
// columns read neighbouring slots (up to 3 past the window, still inside
// the block's shared memory) and are never stored.
// Registers (nvcc -Xptxas -v, sm_90a): 158 at (192, 192) and at
// (192, 320), 115 at (128, 192), 114 at (128, 128), 92 at (64, 64), 147 at
// (256, 256), 149 at (256, 320), no spills.
//
// Bound on the H100 at g_a's first stage (4 × 192 × 544 × 960 → 272 × 480):
// 9.6e11 conv operations (0.97 ms at the bf16 tensor-core peak) and 1.5e11
// norm operations, which shared between the CUDA cores and the tensor cores
// (3 bf16 products each there) leave 1.20 ms (PERF.md §6, kernel table).
// Measured (the same table) on an NVIDIA H100 80GB HBM3 at 700 W: 5.52 ms
// at stage 1 and 1.73 / 0.64 ms at stages 2 / 3. A block of stage 1 takes
// about 150k cycles: 13 % window load, 36 % norm, 51 % conv, the conv
// bound by its weight reads from L2 (PERF.md §5-6).
// At (192, 320), mbt2018's 1 × 192 × 136 × 240 stage, on the same card:
// 0.224 ms alone (ops/kernel_ab.py), 0.402 ms through the wrapper, against
// a bound of 0.027 ms by operations and the unfused pair's 0.181 ms. At
// (256, 256): 10.89 / 3.05 ms at 4 × 256 × 544 × 960 / 272 × 480 (bounds
// 2.13 / 0.53 ms), at (256, 320) 1.25 ms at 4 × 256 × 136 × 240.

#include "gdn_window_tc.cuh"

namespace stem {
namespace {

using tc::bf16;

// The block's tile: kTileH × TW output pixels, its input window of
// kWinH × kWinW pixels, even columns first, then odd ones.
template <int TW>
struct Tile {
  static constexpr int kTileH = 4;                  // output rows
  static constexpr int kWinH = 2 * kTileH + 3;      // 11 input rows
  static constexpr int kWinW = 2 * TW + 3;          // input columns
  static constexpr int kHalf = (kWinW + 1) / 2;     // even columns
  static constexpr int kSlots = kWinH * kWinW;
  __device__ __forceinline__ static int slot(int r, int c) {
    return r * kWinW + (c & 1) * kHalf + (c >> 1);
  }
};

// Ring rows a slot: γ's stages have a norm chunk's rows, the weights' OB/G
// (the output channels of one group of one block).
template <int C, int OBG>
__host__ __device__ constexpr int ring_rows() {
  return tc::norm_chunk<C>() > OBG ? tc::norm_chunk<C>() : OBG;
}

template <int C, int OBG, int TW>
__host__ __device__ constexpr size_t smem_bytes() {
  return tc::Layout<C>::window_bytes(Tile<TW>::kSlots) + 1024 +
         static_cast<size_t>(tc::kStages) * ring_rows<C, OBG>() *
             tc::kRowBytes;
}

// gamma_s: (C/32, C, 64) bf16, γ's hi/lo split (ops/kernels.py::
// split_gamma); w: (25, C/64, O, 64) bf16, [ky·5 + kx][c / 64][o][c % 64]
// (pack_conv_weight). The O output channels are split across S blocks of
// OB = O / S (blockIdx.z), each of which normalises the window itself, and
// within a block into G groups of OB / G, one after another over the same
// normalised window. TW: output columns of the tile (16, or fewer where the
// window must leave the ring more room).
template <int C, int O, int S, int TW, int G>
__global__ void __launch_bounds__(tc::kThreads, 1)
gdn_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma_s,
                const float* __restrict__ beta, const bf16* __restrict__ w,
                const float* __restrict__ bias, bf16* __restrict__ out, int H,
                int W, int Ho, int Wo, int tiles_w) {
  using T = Tile<TW>;
  constexpr int OB = O / S;     // output channels of this block
  constexpr int OBG = OB / G;   // output channels of one group
  static_assert(O % S == 0 && OB % G == 0 && OBG % 32 == 0,
                "two warpgroups of OB/(2G) output channels");
  static_assert(TW <= 16, "a warp's 16 A rows cover a tile row");
  static_assert(smem_bytes<C, OBG, TW>() <= 232448,
                "shared memory of a block");
  constexpr int KC = C / 64;   // ring stages per tap
  constexpr int kNorm = tc::norm_stages<C>(T::kSlots);
  constexpr int kGroupStages = 25 * KC;
  constexpr int kStagesAll = kNorm + G * kGroupStages;
  using L = tc::Layout<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* win = reinterpret_cast<bf16*>(smem);
  const uint32_t win_u32 = tc::smem_u32(smem);

  // the block's first output channel; its rows of each weight stage
  const int o0 = S > 1 ? static_cast<int>(blockIdx.z) * OB : 0;
  const bf16* wb = w + o0 * 64;
  const auto ring = tc::make_ring_fn<ring_rows<C, OBG>()>(
      tc::ring_base<C>(smem, T::kSlots), kStagesAll,
      [=](uint32_t dst, int q) {
        if (q < kNorm) {
          tc::load_stage<tc::norm_chunk<C>()>(dst,
                                              tc::norm_src<C>(gamma_s, q));
        } else {
          const int s = q - kNorm;  // group s / 25·KC, stage s % 25·KC
          tc::load_stage<OBG>(dst, wb + ((s % kGroupStages) * O +
                                         (s / kGroupStages) * OBG) * 64);
        }
      });
  ring.prefetch();

  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_w) * T::kTileH;
  const int ox0 = (blockIdx.x % tiles_w) * TW;
  tc::load_window_tc<C>(win, x + static_cast<long long>(b) * C * H * W, H, W,
                        2 * oy0 - 2, 2 * ox0 - 2, T::kWinH, T::kWinW,
                        T::slot);
  const int q0 = tc::gdn_window_tc<C, false>(win, T::kSlots, ring, 0, beta);

  // warpgroup wg: output channels o0 + gi·OBG + [wg·N, (wg + 1)·N) of all
  // the tile's pixels, group gi after group; its warp w: output row w of
  // the tile, as the A rows 0..15 (columns past TW are computed from
  // neighbouring slots and never stored)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, w4 = warp & 3;
  constexpr int N = OBG / 2;
  const uint32_t apix = tc::a_row<C>(win_u32, 2 * w4 * T::kWinW, T::kSlots);
  const uint32_t half = wg * N * tc::kRowBytes;  // the warpgroup's B rows
  const int oy = oy0 + w4;
  bf16* ob = out + static_cast<long long>(b) * O * Ho * Wo;

#pragma unroll 1
  for (int gi = 0; gi < G; ++gi) {
    const int oc = o0 + gi * OBG + wg * N;  // the warpgroup's first channel
    float acc[N / 8][4];
    tc::init_bias<N>(acc, bias, oc);
#pragma unroll 1
    for (int s = 0; s < kGroupStages; ++s) {
      const uint32_t wslot = ring.next(q0 + gi * kGroupStages + s);
      const int tap = s / KC, kc = s - tap * KC;
      const int ky = tap / 5, kx = tap - ky * 5;
      const int off = ky * T::kWinW + (kx & 1) * T::kHalf + (kx >> 1);
      tc::conv_stage_wg<N>(acc, wslot + half, apix,
                           off * (L::kStride * 2) + kc * 128);
    }

    // acc[j][e]: output row w4, column g + 8·(e / 2), channel
    // oc + 8j + 2t + e % 2
    if (oy < Ho) {
      const long long plane8 = 8LL * Ho * Wo;  // 8 output channels
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = g + 8 * (e >> 1), ox = ox0 + col;
        if (col >= TW || ox >= Wo) continue;
        const int o = oc + 2 * t + (e & 1);
        bf16* dst = ob + (static_cast<long long>(o) * Ho + oy) * Wo + ox;
#pragma unroll
        for (int j = 0; j < N / 8; ++j, dst += plane8)
          *dst = __float2bfloat16_rn(acc[j][e]);
      }
    }
  }
}

template <int C, int O, int S = 1, int TW = 16, int G = 1>
int launch(const bf16* x, const bf16* gamma_s, const float* beta,
           const bf16* w, const float* bias, bf16* out, long long batch,
           int H, int W, cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int tiles_w = (Wo + TW - 1) / TW;
  const long long tiles =
      static_cast<long long>((Ho + Tile<TW>::kTileH - 1) / Tile<TW>::kTileH) *
      tiles_w;
  if (batch > 65535 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<C, O / S / G, TW>();
  const auto kernel = gdn_conv_kernel<C, O, S, TW, G>;
  cudaError_t err = tc::allow_smem(kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(batch),
                S),
           tc::kThreads, smem, stream>>>(x, gamma_s, beta, w, bias, out, H,
                                         W, Ho, Wo, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace stem

extern "C" {

// x (B, C, H, W) bf16; gamma_s (C/32, C, 64) bf16 = γ split into hi and lo
// (ops/kernels.py::split_gamma); beta (C,) f32; w (25, C/64, O, 64) bf16 =
// the conv weight as [ky·5 + kx][c / 64][o][c % 64] (pack_conv_weight);
// bias (O,) f32; out (B, O, ⌈H/2⌉, ⌈W/2⌉) bf16. (C, O) ∈ {(64, 64),
// (128, 128), (192, 192), (256, 256), (128, 192), (192, 320), (256, 320)}
// (ops/kernels.py::GDN_CONV_PAIRS).
int stem_gdn_conv_fused_bf16(const void* x, const void* gamma_s,
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
  if (C == 64 && O == 64)
    return stem::launch<64, 64>(xb, gs, beta, wb, bias, ob, batch, H, W, s);
  if (C == 128 && O == 128)
    return stem::launch<128, 128>(xb, gs, beta, wb, bias, ob, batch, H, W,
                                  s);
  if (C == 192 && O == 192)
    return stem::launch<192, 192>(xb, gs, beta, wb, bias, ob, batch, H, W,
                                  s);
  if (C == 128 && O == 192)
    return stem::launch<128, 192>(xb, gs, beta, wb, bias, ob, batch, H, W,
                                  s);
  if (C == 192 && O == 320)
    return stem::launch<192, 320, 2>(xb, gs, beta, wb, bias, ob, batch, H,
                                     W, s);
  // C = 256: a window of 264-bf16 slots leaves the ring room for 128 or
  // 160 rows only at tiles of 4 × 14 and 4 × 13 output pixels, so O runs
  // in two groups of 128 and of 160 over one normalised window
  if (C == 256 && O == 256)
    return stem::launch<256, 256, 1, 14, 2>(xb, gs, beta, wb, bias, ob,
                                            batch, H, W, s);
  if (C == 256 && O == 320)
    return stem::launch<256, 320, 1, 13, 2>(xb, gs, beta, wb, bias, ob,
                                            batch, H, W, s);
  return cudaErrorInvalidValue;
}

}  // extern "C"
