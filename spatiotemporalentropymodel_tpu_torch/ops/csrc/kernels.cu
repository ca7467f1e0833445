// Hand-written CUDA kernels of the port's serving paths, for sm_90a:
// gdn_fused (f32, and bf16 I/O with f32 math) and quantize_and_index here;
// the fused GDN + conv kernels in gdn_conv.cu and igdn_deconv.cu.
//
// Plain C ABI (extern "C"): each launcher takes raw device pointers, sizes
// and a cudaStream_t, launches on that stream, does not synchronise, and
// returns cudaGetLastError() so the Python wrapper (ops/kernels.py) can raise
// on a refused launch. Built with nvcc into a hash-named shared library and
// loaded with ctypes (ops/build.py); no PyTorch headers.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// ---------------------------------------------------------------------------
// gdn_fused
//
// Replaces spatiotemporalentropymodel_tpu/ops/pallas_kernels.py::gdn_fused
// (_gdn_pallas / _gdn_kernel). Computes, on NCHW x viewed as (B, C, P):
//
//   out[b, o, p] = x[b, o, p] * rsqrt(beta[o] + sum_i gamma_t[i, o] * x[b, i, p]^2)
//
// (sqrt instead of rsqrt for IGDN), f32 throughout. The bf16 entry is the
// same kernel with bf16 loads and stores of x and out (the TPU kernel casts
// x to f32 and the result back the same way, _gdn_kernel); γᵀ, β and the
// math stay f32.
//
// Bound: at the serving widths (C = 192) the channel product is 2·C flops per
// element against 8 bytes moved, so the kernel sits near the f32-FMA /
// bandwidth ridge; memory traffic is what it must keep low. Design: a plain
// SGEMM tiling of the (C_out x C_in) x (C_in x P) product. One block owns a
// 64-output-channel x 64-pixel tile and walks C_in in chunks of 16 through
// shared memory (gamma_t chunk and x^2 chunk, 8 KB — no opt-in needed); each
// of the 256 threads keeps a 4 x 4 accumulator in registers. x^2 and the norm
// never touch device memory. The o-tile index varies fastest over the grid, so
// the C/64 blocks that read the same pixels run together and the re-reads hit
// L2. wgmma/TMA (tf32 would break the f32 contract) are later work.
// ---------------------------------------------------------------------------

constexpr int kTileO = 64;
constexpr int kTileP = 64;
constexpr int kTileK = 16;
constexpr int kGdnThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kGdnThreads)
gdn_kernel(const T* __restrict__ x, const float* __restrict__ gamma_t,
           const float* __restrict__ beta, T* __restrict__ out, int C,
           long long P, int n_otiles, int inverse) {
  __shared__ float s_g[kTileK][kTileO];
  __shared__ float s_x[kTileK][kTileP];

  const long long tile = blockIdx.x;
  const int o0 = static_cast<int>(tile % n_otiles) * kTileO;
  const long long p0 = (tile / n_otiles) * kTileP;
  const long long base = static_cast<long long>(blockIdx.y) * C * P;
  const T* xb = x + base;
  T* ob = out + base;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // pixels tx + 16 j
  const int ty = tid / 16;  // output channels ty + 16 i

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < C; k0 += kTileK) {
#pragma unroll
    for (int r = 0; r < (kTileK * kTileP) / kGdnThreads; ++r) {
      const int e = tid + r * kGdnThreads;
      const int k = e / kTileP;
      const int j = e % kTileP;
      const int i = k0 + k;
      const long long p = p0 + j;
      float v = 0.f;
      if (i < C && p < P) {
        v = to_f32(xb[static_cast<long long>(i) * P + p]);
        v = v * v;
      }
      s_x[k][j] = v;
      const int o = o0 + j;  // kTileO == kTileP
      s_g[k][j] = (i < C && o < C) ? gamma_t[static_cast<long long>(i) * C + o]
                                   : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kTileK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s_g[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s_x[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int o = o0 + ty + 16 * i;
    if (o >= C) continue;
    const float bo = beta[o];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long p = p0 + tx + 16 * j;
      if (p >= P) continue;
      const long long off = static_cast<long long>(o) * P + p;
      const float norm = acc[i][j] + bo;
      const float v = to_f32(xb[off]);
      ob[off] = from_f32<T>(inverse ? v * sqrtf(norm) : v * rsqrtf(norm));
    }
  }
}

// ---------------------------------------------------------------------------
// quantize_and_index
//
// Replaces spatiotemporalentropymodel_tpu/ops/pallas_kernels.py::
// quantize_and_index (_qidx_kernel). Elementwise over any layout:
//
//   sym = int32(clip(rint(y - mu), -2^30, 2^30))      (round half to even)
//   idx = uint8(#{t in table : t < max(sigma, bound)})
//
// where `table` is the f32-cast scale table without its last entry.
//
// Bound: bytes (12 read + 5 written per element; the 63 compares are cheap).
// Design: one grid-stride pass, the table staged once per block in shared
// memory, every thread reading the same entry (broadcast).
// ---------------------------------------------------------------------------

constexpr int kQidxThreads = 256;
constexpr int kMaxTable = 255;
constexpr float kSymbolMax = 1073741824.0f;  // 1 << 30, exact in f32

__global__ void __launch_bounds__(kQidxThreads)
qidx_kernel(const float* __restrict__ y, const float* __restrict__ means,
            const float* __restrict__ scales, const float* __restrict__ table,
            int n_table, float bound, int32_t* __restrict__ sym,
            uint8_t* __restrict__ idx, long long n) {
  __shared__ float s_t[kMaxTable];
  for (int t = threadIdx.x; t < n_table; t += blockDim.x) s_t[t] = table[t];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       e < n; e += stride) {
    float q = rintf(y[e] - means[e]);
    q = fminf(fmaxf(q, -kSymbolMax), kSymbolMax);
    sym[e] = static_cast<int32_t>(q);
    const float s = fmaxf(scales[e], bound);
    int c = 0;
    for (int t = 0; t < n_table; ++t) c += (s_t[t] < s) ? 1 : 0;
    idx[e] = static_cast<uint8_t>(c);
  }
}

template <typename T>
int launch_gdn(const T* x, const float* gamma_t, const float* beta, T* out,
               long long batch, int C, long long P, int inverse,
               void* stream) {
  if (batch == 0 || C == 0 || P == 0) return 0;
  const int n_otiles = (C + kTileO - 1) / kTileO;
  const long long n_tiles = ((P + kTileP - 1) / kTileP) * n_otiles;
  if (batch > 65535 || n_tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(n_tiles),
                  static_cast<unsigned>(batch));
  gdn_kernel<T><<<grid, kGdnThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, gamma_t, beta, out, C, P, n_otiles, inverse);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int stem_gdn_fused_f32(const float* x, const float* gamma_t,
                       const float* beta, float* out, long long batch, int C,
                       long long P, int inverse, void* stream) {
  return launch_gdn(x, gamma_t, beta, out, batch, C, P, inverse, stream);
}

// x and out bf16, gamma_t and beta f32
int stem_gdn_fused_bf16(const void* x, const float* gamma_t,
                        const float* beta, void* out, long long batch, int C,
                        long long P, int inverse, void* stream) {
  return launch_gdn(static_cast<const __nv_bfloat16*>(x), gamma_t, beta,
                    static_cast<__nv_bfloat16*>(out), batch, C, P, inverse,
                    stream);
}

int stem_quantize_and_index_f32(const float* y, const float* means,
                                const float* scales, const float* table,
                                int n_table, float bound, int32_t* sym,
                                uint8_t* idx, long long n, void* stream) {
  if (n == 0) return 0;
  if (n_table < 0 || n_table > kMaxTable) return cudaErrorInvalidValue;
  long long blocks = (n + kQidxThreads - 1) / kQidxThreads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond that
  qidx_kernel<<<static_cast<unsigned>(blocks), kQidxThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      y, means, scales, table, n_table, bound, sym, idx, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
