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
// + 1,024 B = 277,904 B. Registers (nvcc -Xptxas -v, sm_90a):
// 149 at (192, 192) and at (192, 320), 111 at (128, 192), 109 at
// (128, 128), 93 at (64, 64), no spills.
//
// Bound on the H100 at g_a's first stage (4 × 192 × 544 × 960 → 272 × 480):
// 9.6e11 conv operations (0.97 ms at the bf16 tensor-core peak) and 1.5e11
// norm operations, which shared between the CUDA cores and the tensor cores
// (3 bf16 products each there) leave 1.20 ms (chip_smoke.py::fused_bound).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 5.52 ms
// at stage 1 and 1.73 / 0.64 ms at stages 2 / 3. A block of stage 1 takes
// about 150k cycles: 13 % window load, 36 % norm, 51 % conv, the conv
// bound by its weight reads from L2 (ops/phase_probe.py; PERF.md §5-6).
// At (192, 320), mbt2018's 1 × 192 × 136 × 240 stage, on the same card:
// 0.224 ms alone (ops/kernel_ab.py), 0.402 ms through the wrapper, against
// a bound of 0.027 ms by operations and the unfused pair's 0.181 ms.

#include "gdn_window_tc.cuh"

namespace stem {
namespace {

using tc::bf16;

constexpr int kTileH = 4, kTileW = 16;           // output pixels per block
constexpr int kWinH = 2 * kTileH + 3;            // 11 input rows
constexpr int kWinW = 2 * kTileW + 3;            // 35 input columns
constexpr int kHalf = (kWinW + 1) / 2;           // 18 even columns
constexpr int kSlots = kWinH * kWinW;            // 385

__device__ __forceinline__ int conv_slot(int r, int c) {
  return r * kWinW + (c & 1) * kHalf + (c >> 1);
}

// Ring rows a slot: γ's stages have C rows, the weights' OB (the output
// channels of one block).
template <int C, int OB>
__host__ __device__ constexpr int ring_rows() {
  return C > OB ? C : OB;
}

template <int C, int OB>
__host__ __device__ constexpr size_t smem_bytes() {
  return tc::Layout<C>::window_bytes(kSlots) + 1024 +
         static_cast<size_t>(tc::kStages) * ring_rows<C, OB>() *
             tc::kRowBytes;
}

// gamma_s: (C/32, C, 64) bf16, γ's hi/lo split (ops/kernels.py::
// split_gamma); w: (25, C/64, O, 64) bf16, [ky·5 + kx][c / 64][o][c % 64]
// (pack_conv_weight). The O output channels are split across S blocks of
// OB = O / S (blockIdx.z), each of which normalises the window itself.
template <int C, int O, int S>
__global__ void __launch_bounds__(tc::kThreads, 1)
gdn_conv_kernel(const bf16* __restrict__ x, const bf16* __restrict__ gamma_s,
                const float* __restrict__ beta, const bf16* __restrict__ w,
                const float* __restrict__ bias, bf16* __restrict__ out, int H,
                int W, int Ho, int Wo, int tiles_w) {
  constexpr int OB = O / S;  // output channels of this block
  static_assert(O % S == 0 && OB % 32 == 0,
                "two warpgroups of OB/2 output channels");
  static_assert(smem_bytes<C, OB>() <= 232448, "shared memory of a block");
  constexpr int KC = C / 64;   // ring stages per tap
  constexpr int KN = C / 32;   // ring stages per norm round
  constexpr int kNorm = tc::norm_stages<C>(kSlots);
  constexpr int kStagesAll = kNorm + 25 * KC;
  using L = tc::Layout<C>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* win = reinterpret_cast<bf16*>(smem);
  const uint32_t win_u32 = tc::smem_u32(smem);

  STEM_PHASE(0);
  // the block's first output channel; its rows of each weight stage
  const int o0 = S > 1 ? static_cast<int>(blockIdx.z) * OB : 0;
  const bf16* wb = w + o0 * 64;
  const auto ring = tc::make_ring_fn<ring_rows<C, OB>()>(
      tc::ring_base<C>(smem, kSlots), kStagesAll, [=](uint32_t dst, int q) {
        if (q < kNorm)
          tc::load_stage<C>(dst, gamma_s + (q % KN) * (C * 64));
        else
          tc::load_stage<OB>(dst, wb + (q - kNorm) * (O * 64));
      });
  ring.prefetch();

  const int b = blockIdx.y;
  const int oy0 = (blockIdx.x / tiles_w) * kTileH;
  const int ox0 = (blockIdx.x % tiles_w) * kTileW;
  tc::load_window_tc<C>(win, x + static_cast<long long>(b) * C * H * W, H, W,
                        2 * oy0 - 2, 2 * ox0 - 2, kWinH, kWinW, conv_slot);
  STEM_PHASE(1);
  const int q0 = tc::gdn_window_tc<C, false>(win, kSlots, ring, 0, beta);
  STEM_PHASE(2);

  // warpgroup wg: output channels o0 + [wg·OB/2, (wg + 1)·OB/2) of all 64
  // pixels;
  // its warp w: output row w of the tile, as the A rows 0..15
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, w4 = warp & 3;
  constexpr int N = OB / 2;
  const uint32_t apix = tc::a_row<C>(win_u32, 2 * w4 * kWinW, kSlots);
  const uint32_t half = wg * N * tc::kRowBytes;  // the warpgroup's B rows

  float acc[N / 8][4];
  tc::init_bias<N>(acc, bias, o0 + wg * N);
#pragma unroll 1
  for (int s = 0; s < 25 * KC; ++s) {
    const uint32_t wslot = ring.next(q0 + s);
    const int tap = s / KC, kc = s - tap * KC;
    const int ky = tap / 5, kx = tap - ky * 5;
    const int off = ky * kWinW + (kx & 1) * kHalf + (kx >> 1);
    tc::conv_stage_wg<N>(acc, wslot + half, apix,
                         off * (L::kStride * 2) + kc * 128);
  }

  // acc[j][e]: output row w4, column g + 8·(e / 2), channel
  // o0 + wg·N + 8j + 2t + e % 2
  const int oy = oy0 + w4;
  bf16* ob = out + static_cast<long long>(b) * O * Ho * Wo;
  if (oy < Ho) {
    const long long plane8 = 8LL * Ho * Wo;  // 8 output channels
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ox = ox0 + g + 8 * (e >> 1);
      if (ox >= Wo) continue;
      const int o = o0 + wg * N + 2 * t + (e & 1);
      bf16* dst = ob + (static_cast<long long>(o) * Ho + oy) * Wo + ox;
#pragma unroll
      for (int j = 0; j < N / 8; ++j, dst += plane8)
        *dst = __float2bfloat16_rn(acc[j][e]);
    }
  }
  STEM_PHASE(3);
}

template <int C, int O, int S = 1>
int launch(const bf16* x, const bf16* gamma_s, const float* beta,
           const bf16* w, const float* bias, bf16* out, long long batch,
           int H, int W, cudaStream_t stream) {
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const int tiles_w = (Wo + kTileW - 1) / kTileW;
  const long long tiles =
      static_cast<long long>((Ho + kTileH - 1) / kTileH) * tiles_w;
  if (batch > 65535 || tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<C, O / S>();
  cudaError_t err = tc::allow_smem(gdn_conv_kernel<C, O, S>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  gdn_conv_kernel<C, O, S>
      <<<dim3(static_cast<unsigned>(tiles), static_cast<unsigned>(batch), S),
         tc::kThreads, smem, stream>>>(x, gamma_s, beta, w, bias, out, H, W,
                                       Ho, Wo, tiles_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace stem

extern "C" {

// x (B, C, H, W) bf16; gamma_s (C/32, C, 64) bf16 = γ split into hi and lo
// (ops/kernels.py::split_gamma); beta (C,) f32; w (25, C/64, O, 64) bf16 =
// the conv weight as [ky·5 + kx][c / 64][o][c % 64] (pack_conv_weight);
// bias (O,) f32; out (B, O, ⌈H/2⌉, ⌈W/2⌉) bf16. (C, O) ∈ {(64, 64),
// (128, 128), (192, 192), (128, 192), (192, 320)}
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
  return cudaErrorInvalidValue;
}

}  // extern "C"
