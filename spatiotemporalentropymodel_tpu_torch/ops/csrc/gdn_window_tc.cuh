// Shared device code of the kernels that run the (I)GDN norm on the tensor
// cores, for sm_90a: the fused (I)GDN + convolution kernels (gdn_conv.cu,
// both kernels of igdn_deconv.cu), which use all three steps below, and
// gdn_fused (kernels.cu), which uses the wgmma wrappers and the ring.
//
// A block of 256 threads (two warpgroups of 4 warps) owns one spatial tile
// of one image:
//   1. load_window_tc: its input window goes from NCHW bf16 device memory to
//      shared memory, pixel-major with the channels contiguous
//      ([slot][C + 8]), 16 bytes per load along W and 16 bytes per store
//      (transposed through registers). Pixels outside the image are 0.
//   2. gdn_window_tc: (I)GDN of every window pixel, in place, as a GEMM on
//      the tensor cores, norm[p][o] = Σ_i x[p][i]² · γ[o][i], at f32
//      accuracy from bf16 operands: x² = s_hi + s_lo exactly (a bf16 square
//      has 16 significant bits) and γ = g_hi + g_lo (to 2⁻¹⁶ relative, split
//      by the wrapper), with norm = s_hi·g_hi + s_hi·g_lo + s_lo·g_hi summed
//      in f32 (the dropped s_lo·g_lo is below 2⁻¹⁶ of the norm). A
//      warpgroup takes 64 window pixels at a time over all C output
//      channels, in chunks of NC ≤ 192 (norm_chunk: C itself up to 192, two
//      of 128 at 256; wgmma m64nNCk16, NC/2 f32 accumulators per thread),
//      so each warp rescales its own 16 pixels, x·rsqrt(β + norm) (IGDN:
//      x·sqrt(β + norm)) rounded to bf16, with no barrier between warps. A
//      chunk's results wait in registers as bf16 until the last chunk's
//      norm is done, since every chunk reads the squares of all C channels.
//   3. conv_stage_wg: the convolution as an implicit GEMM on wgmma (bf16
//      operands, f32 accumulators) with the pixels as rows: A = 16 window
//      pixels per warp in registers, loaded with ldmatrix from any slots
//      (the stride-2 and halo taps), B = the stage's weights in the ring.
//
// Operands that are the same for every pixel of the block (γ's hi/lo split
// for the norm, the conv weights) stream through one ring of kStages slots
// of `rows` × 128 bytes in shared memory, filled with cp.async (16 bytes a
// thread) kStages − 1 stages ahead of the MMAs: one barrier per stage, and
// each tile is fetched from L2 once per block and read by every warpgroup.
// A stage is 64 input channels of one conv tap (or of several, for the
// narrow g_s kernel) for one group of output channels, or 32 input channels
// of γ as [o][hi 0..31 | lo 0..31] for one chunk of the norm's output
// channels; the wrappers lay them out stage after stage
// (ops/kernels.py::split_gamma, pack_conv_weight, pack_wide_weight,
// pack_narrow_weight). A ring slot is wgmma's K-major operand with the
// 128-byte swizzle: 16-byte chunk j of row r lives at chunk j ^ (r & 7),
// slots 1024-byte aligned.
//
// The window's pixel stride is C + 8 bf16 (≡ 16 bytes mod 128 for C ≡ 0 mod
// 64): ldmatrix rows of 8 consecutive slots, the 16-byte window stores and
// the 4-byte stores of the rescale are free of bank conflicts.

#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace stem {

namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;     // ring slots
constexpr int kRowBytes = 128; // one ring row: 64 bf16

template <int C>
struct Layout {
  static_assert(C % 64 == 0, "channels must be a multiple of 64");
  static constexpr int kStride = C + 8;  // bf16 elements per window slot
  // the window; the ring follows at the next 1024-byte boundary of the
  // shared address space (the 128-byte swizzle repeats every 8 rows of 128
  // bytes; ring_base rounds up, so a kernel allots 1024 bytes of slack)
  __host__ __device__ static constexpr size_t window_bytes(int n_slots) {
    return static_cast<size_t>(n_slots) * kStride * sizeof(bf16);
  }
};

// Output channels of one chunk of the norm (gdn_window_tc): all C up to
// 192, else C split into the fewest equal chunks of at most 192 (two of 128
// at C = 256), each one wgmma of NC columns. A γ stage of the ring holds a
// chunk's NC rows.
template <int C>
__host__ __device__ constexpr int norm_chunk() {
  return C / ((C + 191) / 192);
}

// Ring stages of the norm over n_slots window slots (gdn_window_tc): one
// round per 64 slots of each of the two warpgroups, C/32 stages per chunk
// of output channels.
template <int C>
__host__ __device__ constexpr int norm_stages(int n_slots) {
  return ((n_slots + 63) / 64 + 1) / 2 * (C / 32) * (C / norm_chunk<C>());
}

// Device address of the norm's ring stage q in γ's split (C/32, C, 64):
// within a round, chunk by chunk, 32 input channels a stage; a chunk's NC
// rows of a stage are contiguous.
template <int C>
__device__ __forceinline__ const bf16* norm_src(const bf16* gamma_s,
                                                int q) {
  constexpr int KN = C / 32, NC = norm_chunk<C>();
  const int i = q % (KN * (C / NC));
  return gamma_s + ((i % KN) * C + (i / KN) * NC) * 64;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Shared address of the ring after a window of n_slots at smem.
template <int C>
__device__ __forceinline__ uint32_t ring_base(const void* smem, int n_slots) {
  return (smem_u32(smem) + static_cast<uint32_t>(
                               Layout<C>::window_bytes(n_slots)) + 1023u) &
         ~1023u;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// wgmma's descriptor of a ring slot at shared address saddr (1024-byte
// aligned, plus the byte offset of a k-step within the 128-byte rows): rows
// of 128 bytes, K-major, 128-byte swizzle, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t ring_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d[m64 × n16] += a (registers: this warp's 16 rows × 16, as for
// mma.m16n8k16) · B (desc: 16 rows × 16 of K-major bf16, 128-byte
// swizzle), f32 accumulators d[j][e] laid out as mma's for n-tile j.
__device__ __forceinline__ void wgmma_n16(float (&d)[2][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[m64 × n32] += a (registers: this warp's 16 rows × 16, as for
// mma.m16n8k16) · B (desc: 32 rows × 16 of K-major bf16, 128-byte
// swizzle), f32 accumulators d[j][e] laid out as mma's for n-tile j.
__device__ __forceinline__ void wgmma_n32(float (&d)[4][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[m64 × n64] += a (registers: this warp's 16 rows × 16, as for
// mma.m16n8k16) · B (desc: 64 rows × 16 of K-major bf16, 128-byte
// swizzle), f32 accumulators d[j][e] laid out as mma's for n-tile j.
__device__ __forceinline__ void wgmma_n64(float (&d)[8][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[m64 × n80] += a (registers: this warp's 16 rows × 16, as for
// mma.m16n8k16) · B (desc: 80 rows × 16 of K-major bf16, 128-byte
// swizzle), f32 accumulators d[j][e] laid out as mma's for n-tile j.
__device__ __forceinline__ void wgmma_n80(float (&d)[10][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[m64 × n96] += a (registers: this warp's 16 rows × 16, as for
// mma.m16n8k16) · B (desc: 96 rows × 16 of K-major bf16, 128-byte
// swizzle), f32 accumulators d[j][e] laid out as mma's for n-tile j.
__device__ __forceinline__ void wgmma_n96(float (&d)[12][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[m64 × n128] += a (registers: this warp's 16 rows × 16, as for
// mma.m16n8k16) · B (desc: 128 rows × 16 of K-major bf16, 128-byte
// swizzle), f32 accumulators d[j][e] laid out as mma's for n-tile j.
__device__ __forceinline__ void wgmma_n128(float (&d)[16][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d[m64 × n192] += a (registers: this warp's 16 rows × 16, as for
// mma.m16n8k16) · B (desc: 192 rows × 16 of K-major bf16, 128-byte
// swizzle), f32 accumulators d[j][e] laid out as mma's for n-tile j.
__device__ __forceinline__ void wgmma_n192(float (&d)[24][4],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 8][4],
                                      const uint32_t (&a)[4], uint64_t desc) {
  static_assert((N == 16 || N == 80 || N % 32 == 0) && N <= 192,
                "wgmma width");
  if constexpr (N == 16) wgmma_n16(d, a, desc);
  if constexpr (N == 32) wgmma_n32(d, a, desc);
  if constexpr (N == 64) wgmma_n64(d, a, desc);
  if constexpr (N == 80) wgmma_n80(d, a, desc);
  if constexpr (N == 96) wgmma_n96(d, a, desc);
  if constexpr (N == 128) wgmma_n128(d, a, desc);
  if constexpr (N == 192) wgmma_n192(d, a, desc);
}

// One stage, `ROWS` rows of 128 bytes contiguous at src, into the ring slot
// at dst with the swizzle above; 16 bytes per cp.async (threads past the
// stage's chunks issue none).
template <int ROWS>
__device__ __forceinline__ void load_stage(uint32_t dst, const bf16* src) {
  constexpr int kChunks = ROWS * (kRowBytes / 16);
  const char* s = reinterpret_cast<const char*>(src);
#pragma unroll
  for (int k = 0; k < (kChunks + kThreads - 1) / kThreads; ++k) {
    const int i = threadIdx.x + k * kThreads;
    if (kChunks % kThreads != 0 && i >= kChunks) break;
    const int r = i >> 3, j = i & 7;
    cp_async16(dst + r * kRowBytes + ((j ^ (r & 7)) << 4), s + i * 16);
  }
}

// load_stage of `rows` rows, a number known at run time.
__device__ __forceinline__ void load_rows(uint32_t dst, const bf16* src,
                                          int rows) {
  const char* s = reinterpret_cast<const char*>(src);
  for (int i = threadIdx.x; i < rows * (kRowBytes / 16); i += kThreads) {
    const int r = i >> 3, j = i & 7;
    cp_async16(dst + r * kRowBytes + ((j ^ (r & 7)) << 4), s + i * 16);
  }
}

// The ring: stage q of n lives in slot q % kStages, slots SLOT_ROWS rows
// of 128 bytes apart. prefetch issues stages 0 .. kStages − 2; next(q)
// waits for stage q, makes it visible to every warp (the barrier also
// retires stage q − 1, whose slot it refills with stage q + kStages − 1)
// and returns stage q's slot address. load(dst, q) issues the cp.asyncs of
// stage q into the slot at dst.
template <int SLOT_ROWS, typename LoadFn>
struct Ring {
  uint32_t base;
  int n;
  LoadFn load;

  __device__ __forceinline__ uint32_t slot(int q) const {
    return base + (q % kStages) * (SLOT_ROWS * kRowBytes);
  }
  __device__ __forceinline__ void prefetch() const {
#pragma unroll
    for (int q = 0; q < kStages - 1; ++q) {
      if (q < n) load(slot(q), q);
      cp_async_commit();
    }
  }
  __device__ __forceinline__ uint32_t next(int q) const {
    cp_async_wait<kStages - 2>();
    fence_proxy_async();  // the copies are visible to wgmma's reads
    __syncthreads();
    const int ahead = q + kStages - 1;
    if (ahead < n) load(slot(ahead), ahead);
    cp_async_commit();  // possibly empty, so the group count stays uniform
    return slot(q);
  }
};

template <int SLOT_ROWS, typename LoadFn>
__device__ __forceinline__ Ring<SLOT_ROWS, LoadFn> make_ring_fn(
    uint32_t base, int n, LoadFn load) {
  return Ring<SLOT_ROWS, LoadFn>{base, n, load};
}

// A ring whose every stage is `ROWS` rows contiguous at src(q), the device
// address of stage q.
template <int ROWS, typename SrcFn>
__device__ __forceinline__ auto make_ring(uint32_t base, int n, SrcFn src) {
  return make_ring_fn<ROWS>(base, n, [=](uint32_t dst, int q) {
    load_stage<ROWS>(dst, src(q));
  });
}

// Rows [y0, y0 + rows) × cols [x0, x0 + cols) of image xb (NCHW, C
// channels, H×W) into the window; pixel (r, c) goes to slot slot_of(r, c).
// Outside the image the window holds 0.
//
// When W is a multiple of 8 and xb 16-byte aligned, a thread moves 8
// channels × 8 columns per item: 8 loads of 16 bytes along W (the column
// groups aligned to 8, so a group is wholly inside or outside the image),
// a transpose through registers (__byte_perm), and one 16-byte store per
// window pixel. Otherwise a thread gathers 8 channels of one pixel with
// 2-byte loads (neighbouring threads on neighbouring pixels) and stores
// them as one 16-byte word.
template <int C, typename SlotFn>
__device__ __forceinline__ void load_window_tc(bf16* win,
                                               const bf16* __restrict__ xb,
                                               int H, int W, int y0, int x0,
                                               int rows, int cols,
                                               SlotFn slot_of) {
  constexpr int CP = Layout<C>::kStride;
  constexpr int CG = C / 8;  // channel groups of 8
  const long long plane = static_cast<long long>(H) * W;
  if ((W & 7) == 0 && (reinterpret_cast<uintptr_t>(xb) & 15) == 0) {
    const int g0 = x0 >> 3;  // floor(x0 / 8), x0 may be negative
    const int groups = ((x0 + cols - 1) >> 3) - g0 + 1;
    const int items = rows * groups * CG;
#pragma unroll 1
    for (int e = threadIdx.x; e < items; e += kThreads) {
      const int jg = e % groups;
      const int rest = e / groups;
      const int cg = rest % CG;
      const int r = rest / CG;
      const int iy = y0 + r, gx = (g0 + jg) * 8;
      uint4 v[8];
      if (iy >= 0 && iy < H && gx >= 0 && gx < W) {
        const uint4* s = reinterpret_cast<const uint4*>(
            xb + static_cast<long long>(cg * 8) * plane +
            static_cast<long long>(iy) * W + gx);
        const long long step = plane / 8;  // one channel, in uint4
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = __ldg(s + k * step);
      } else {
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] = make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = gx + j - x0;
        if (col < 0 || col >= cols) continue;
        // column j is halfword j % 2 of word j / 2 of each channel's uint4
        const unsigned sel = (j & 1) ? 0x7632u : 0x5410u;
        uint32_t o[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const uint32_t* a = reinterpret_cast<const uint32_t*>(&v[2 * m]);
          const uint32_t* b = reinterpret_cast<const uint32_t*>(&v[2 * m + 1]);
          o[m] = __byte_perm(a[j >> 1], b[j >> 1], sel);
        }
        *reinterpret_cast<uint4*>(win + slot_of(r, col) * CP + cg * 8) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
    return;
  }
  const int npix = rows * cols;
  const int total = npix * CG;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(xb);
#pragma unroll 2
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int cg = e / npix;
    const int p = e - cg * npix;
    const int r = p / cols;
    const int col = p - r * cols;
    const int iy = y0 + r, ix = x0 + col;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
      const unsigned short* s =
          xs + static_cast<long long>(cg * 8) * plane +
          static_cast<long long>(iy) * W + ix;
      unsigned short h[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) h[k] = __ldg(s + k * plane);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        v[k] = static_cast<uint32_t>(h[2 * k]) |
               (static_cast<uint32_t>(h[2 * k + 1]) << 16);
    }
    *reinterpret_cast<uint4*>(win + slot_of(r, col) * CP + cg * 8) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// The squares of 8 bf16 values (an A fragment) split into bf16 hi + lo,
// exactly: hi = bf16(x²), lo = x² − hi.
__device__ __forceinline__ void split_squares(const uint32_t (&x)[4],
                                              uint32_t (&hi)[4],
                                              uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&x[i]);
    float2 s = __bfloat1622float2(v);
    s.x *= s.x;
    s.y *= s.y;
    const __nv_bfloat162 h = __floats2bfloat162_rn(s.x, s.y);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(s.x - hf.x, s.y - hf.y);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = *reinterpret_cast<const uint32_t*>(&l);
  }
}

// This lane's ldmatrix row address for an A fragment (16 rows × 16
// channels, as mma.m16n8k16 takes it) of rows m0 .. m0 + 15 of the window:
// row m0 + (lane & 7) + 8·((lane >> 3) & 1), channels +8 for lanes 16-31.
// Rows past n_slots read slot n_slots − 1 (in the same 64-row unit) and are
// never written back.
template <int C>
__device__ __forceinline__ uint32_t a_row(uint32_t win, int m0, int n_slots) {
  const int lane = threadIdx.x & 31, q = lane >> 3;
  int slot = m0 + (q & 1) * 8 + (lane & 7);
  slot = slot < n_slots ? slot : n_slots - 1;
  return win + slot * (Layout<C>::kStride * 2) + (q >> 1) * 16;
}

// acc[nt] += Σ over the 32 input channels [32·kc, 32·kc + 32) of x² · γ for
// the warpgroup's 64 slots (rows; this warp's 16 at a) and the NC output
// channels of one chunk (8 per n-tile), on wgmma: A = the squares' hi and
// lo from registers, B = the stage of γ's split in the ring slot gslot (hi
// at bytes 0-63 of each row, lo at 64-127). Waits for its wgmmas before
// returning, so the slot may be refilled after the next barrier.
template <int NC>
__device__ __forceinline__ void norm_stage(float (&acc)[NC / 8][4],
                                           uint32_t gslot, uint32_t a,
                                           int kc) {
  uint32_t hi[2][4], lo[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t x[4];
    ldmatrix_x4(x, a + (kc * 32 + kk * 16) * 2);
    split_squares(x, hi[kk], lo[kk]);
  }
  wgmma_fence();
  const uint64_t d = ring_desc(gslot);
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint64_t dh = d + ((kk * 32) >> 4), dl = d + ((64 + kk * 32) >> 4);
    wgmma<NC>(acc, lo[kk], dh);
    wgmma<NC>(acc, hi[kk], dl);
    wgmma<NC>(acc, hi[kk], dh);
  }
  wgmma_commit();
  wgmma_wait_all();
}

// The rescaled values x · rsqrt(β[o] + norm) (IGDN: x · sqrt(β[o] + norm))
// in bf16 pairs, for the warp's slots m0 + g + 8·rh below n_slots and the
// chunk's channels o0 + 8·nt + 2t, +1; acc as norm_stage leaves it (entries
// 0, 1: slot m0 + g; 2, 3: slot m0 + g + 8). x is read from the window,
// which this leaves as it is.
template <int C, int NC, bool INVERSE>
__device__ __forceinline__ void scale_pairs(
    const bf16* win, int m0, int n_slots, const float (&acc)[NC / 8][4],
    const float* __restrict__ beta, int o0, uint32_t (&y)[NC / 8][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int slot = m0 + g + 8 * rh;
    const bf16* row = win + (slot < n_slots ? slot : n_slots - 1) *
                                Layout<C>::kStride;
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt) {
      const int o = o0 + 8 * nt + 2 * t;
      const float2 xv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(row + o));
      const float2 bb = __ldg(reinterpret_cast<const float2*>(beta + o));
      const float n0 = acc[nt][2 * rh] + bb.x;
      const float n1 = acc[nt][2 * rh + 1] + bb.y;
      const float y0 = INVERSE ? xv.x * sqrtf(n0) : xv.x * rsqrtf(n0);
      const float y1 = INVERSE ? xv.y * sqrtf(n1) : xv.y * rsqrtf(n1);
      const __nv_bfloat162 v = __floats2bfloat162_rn(y0, y1);
      y[nt][rh] = *reinterpret_cast<const uint32_t*>(&v);
    }
  }
}

// win[slot][o0 + 8·nt + 2t, +1] ← y[nt][rh] for the warp's slots
// m0 + g + 8·rh below n_slots (scale_pairs' layout).
template <int C, int NC>
__device__ __forceinline__ void store_pairs(bf16* win, int m0, int n_slots,
                                            const uint32_t (&y)[NC / 8][2],
                                            int o0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int slot = m0 + g + 8 * rh;
    if (slot >= n_slots) continue;
    bf16* row = win + slot * Layout<C>::kStride;
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt)
      *reinterpret_cast<uint32_t*>(row + o0 + 8 * nt + 2 * t) = y[nt][rh];
  }
}

// The norm of slots [0, n_slots): in each round, warpgroup wg takes the 64
// slots of unit round·2 + wg (its warp w the 16 from 64·unit + 16·w) and
// runs, chunk by chunk of NC output channels, over the C/32 stages of γ's
// split, ring stages q0 .. q0 + rounds·chunks·C/32 − 1. A warp owns its 16
// slots over all C channels, so it rescales them in place once its last
// chunk's wgmmas are done (the earlier chunks' results wait in registers,
// since each chunk reads the squares of every channel): no other warp reads
// them before the next phase's barrier. Returns the next stage index.
template <int C, bool INVERSE, typename RingT>
__device__ __forceinline__ int gdn_window_tc(bf16* win, int n_slots,
                                             const RingT& ring, int q0,
                                             const float* __restrict__ beta) {
  constexpr int KN = C / 32;
  constexpr int NC = norm_chunk<C>(), kChunks = C / NC;
  constexpr int kGroups = kWarps / 4;  // warpgroups
  static_assert(kGroups == 2, "norm_stages counts two warpgroups");
  static_assert(C % NC == 0 && NC % 32 == 0, "chunks of the norm");
  const int warp = threadIdx.x >> 5;
  const int units = (n_slots + 63) / 64;
  const int rounds = norm_stages<C>(n_slots) / (KN * kChunks);
  const uint32_t wbase = smem_u32(win);
#pragma unroll 1
  for (int r = 0; r < rounds; ++r) {
    const int unit = r * kGroups + (warp >> 2);
    const bool live = unit < units;  // the same for the whole warpgroup
    const int m0 = unit * 64 + 16 * (warp & 3);
    const uint32_t a = a_row<C>(wbase, live ? m0 : 0, n_slots);
    uint32_t y[kChunks][NC / 8][2];
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      float acc[NC / 8][4];
#pragma unroll
      for (int nt = 0; nt < NC / 8; ++nt)
        acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll 1
      for (int kc = 0; kc < KN; ++kc) {
        const uint32_t gslot = ring.next(q0 + (r * kChunks + ch) * KN + kc);
        if (live) norm_stage<NC>(acc, gslot, a, kc);
      }
      if (live) scale_pairs<C, NC, INVERSE>(win, m0, n_slots, acc, beta,
                                            ch * NC, y[ch]);
    }
    if (live) {
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch)
        store_pairs<C, NC>(win, m0, n_slots, y[ch], ch * NC);
    }
  }
  return q0 + rounds * KN * kChunks;
}

// One stage of an implicit GEMM on wgmma, pixels as rows: 64 input
// channels of one tap for the warpgroup's 64 pixels (this warp's 16 at
// apix + aoff, as a_row addresses them; aoff = the tap's slot offset and
// the stage's channel offset, in bytes) × all N output channels of the ring
// slot wslot: acc[n-tile][e] += Σ_c win[pixel + tap][c] · W[o][c]. Waits for
// its wgmmas before returning.
template <int N>
__device__ __forceinline__ void conv_stage_wg(float (&acc)[N / 8][4],
                                              uint32_t wslot, uint32_t apix,
                                              uint32_t aoff) {
  uint32_t a[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) ldmatrix_x4(a[kk], apix + aoff + kk * 32);
  wgmma_fence();
  const uint64_t d = ring_desc(wslot);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma<N>(acc, a[kk], d + kk * 2);
  wgmma_commit();
  wgmma_wait_all();
}

// acc[j][e] ← bias[o0 + 8j + 2t + e % 2]: the bias of each accumulator's
// output channel, pixels as rows (n-tile j of 8 channels from o0).
template <int N>
__device__ __forceinline__ void init_bias(float (&acc)[N / 8][4],
                                          const float* __restrict__ bias,
                                          int o0) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const float2 bb =
        __ldg(reinterpret_cast<const float2*>(bias + o0 + 8 * j + 2 * t));
    acc[j][0] = acc[j][2] = bb.x;
    acc[j][1] = acc[j][3] = bb.y;
  }
}

template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace tc
}  // namespace stem
