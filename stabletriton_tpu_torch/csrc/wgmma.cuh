// The Hopper GEMM mainloop shared by the bf16 linear kernel (linear.cu,
// linear_wgmma_bf16) and the bf16 3x3 conv as an implicit GEMM (conv3x3.cu,
// conv_wgmma_bf16): TMA loads into a ring of shared-memory stages, one
// producer thread, two consumer warpgroups issuing wgmma, and an epilogue
// straight from the accumulator registers. The attention kernels
// (flash_attention.cu: attn_wgmma_bf16, and gemm_wgmma_tf32x3 for f32) and
// the 3xTF32 conv (conv3x3.cu, conv_wgmma_tf32x3) keep that shape with
// rings of their own and use the barriers, TMA loads, descriptors,
// instructions and the 3xTF32 stage below.
//
//   block tile   BM = 128 rows x BN = 128 or 256 columns, K in steps of BK = 64
//                (one 128-byte swizzle row of bf16);
//   warps        warpgroups 0 and 1 consume (64 rows each, m64n128k16 per
//                128 columns); warp 8 produces (one thread issues every TMA
//                load), so a block is 288 threads;
//   A            K-major (K contiguous), one TMA box of 64 x 128 a stage, 128-byte
//                swizzle; the conv's producer loads it as a 4-D box of pixels;
//   B            the (K, N) row-major weight, N contiguous: MN-major for wgmma
//                (transpose flag), one 64-column box per 64 columns of the tile;
//                at BN = 8 (the 3x3 conv to Cout <= 8) the weight as a K-major
//                8-row matrix, one 64 x 8 box a stage, m64n8k16, element stores;
//   stages       full / empty mbarrier pairs; the producer waits for a stage to
//                be released, arms its full barrier with the stage's bytes and
//                issues the loads; a consumer warpgroup waits on the full
//                barrier, issues its wgmmas, and releases the stage one k-step
//                later (one wgmma group stays in flight);
//   occupancy    the epilogue is a third of a block's time at the UNet's
//                shapes (K = 640 ... 1280 is 10-20 steps), so BN = 128 runs two
//                blocks an SM (3 stages and 112 registers a thread each), one
//                block's epilogue overlapping the other's mainloop; BN = 256
//                (128 accumulators a thread) runs one, with 4 stages;
//   grid         blockIdx.x walks the output tiles, column tile fastest (a
//                row tile's blocks run together and share its A rows in L2),
//                so no shape meets CUDA's 65535 limit on grid.y; blockIdx.z
//                is the K split.
//
// TMA fills out-of-range rows, columns and pixels with zeros, so ragged M, N,
// K and the conv's SAME border need no masks in the mainloop. The epilogue
// masks rows and 8-column chunks (N % 8 == 0 is a TMA requirement).
//
// Split K: blockIdx.z takes k-blocks [z * nk / S, (z + 1) * nk / S) and
// writes its f32 partial tile to a workspace (S, M, N); splitk_reduce sums
// the S partials in split order (no atomics: the result repeats bit for bit)
// and applies the epilogue.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec.cuh"

namespace wg {
namespace {

constexpr int BM = 128;
constexpr int BK = 64;
constexpr int THREADS = 288;      // 2 consumer warpgroups + 1 producer warp
constexpr int A_BYTES = BM * BK * 2;
constexpr int BOX_BYTES = BK * 64 * 2;  // one 64-column box of B
constexpr int B_BOX_STRIDE = BOX_BYTES;  // wgmma LBO of the MN-major B
constexpr int SW_ROWS8 = 1024;    // 8 rows of 128 bytes: the swizzle atom (wgmma SBO)

template <int BN>
constexpr int stage_bytes() { return A_BYTES + BK * BN * 2; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------
__device__ __forceinline__ void bar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// wait until the barrier's phase of this parity has completed. A wait past
// 10 s (a lost arrival or transaction count) traps: the launch fails with an
// error instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint64_t start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
    if (start == 0) start = now;
    else if (now - start > 10000000000ull) __trap();
  }
}

// ---------------------------------------------------------------------------
// TMA loads: the box at the given coordinates (innermost first) into shared
// memory, completion counted in bytes on the barrier
// ---------------------------------------------------------------------------
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma boundaries
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// the same for register-A fragments: they stay alive and unmoved until the
// wgmma that reads them asynchronously has been waited for
template <int N>
__device__ __forceinline__ void fence_frag(uint32_t (&f)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int v = 0; v < 4; ++v) asm volatile("" : "+r"(f[i][v])::"memory");
}

// shared-memory matrix descriptor, 128-byte swizzle; lbo / sbo in bytes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// shared-memory matrix descriptor, no swizzle, K-major: 8 x 16-byte core
// matrices of 128 contiguous bytes, lbo bytes apart along K and sbo bytes
// apart along M or N
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}
// A (64 rows x 16 k of a K-major, 128-byte-swizzled tile): rows 128 bytes
// apart, 8-row atoms 1024 apart; the k-th 16-wide slice starts 32 bytes in
__device__ __forceinline__ uint64_t desc_a(uint32_t tile, int row0, int kk) {
  return desc_sw128(tile + row0 * 128 + kk * 32, 16, SW_ROWS8);
}
// B (16 k x 128 n of the MN-major tile): one 64-column box is 64 rows of 128
// bytes; the two boxes of 128 columns lie B_BOX_STRIDE apart (LBO), 8-row
// atoms 1024 apart (SBO); the k-th 16-row slice starts 16 * 128 bytes in
__device__ __forceinline__ uint64_t desc_b(uint32_t tile, int nsub, int kk) {
  return desc_sw128(tile + nsub * 2 * BOX_BYTES + kk * 16 * 128, B_BOX_STRIDE, SW_ROWS8);
}

#define WG_ACC8(b)                                                                     \
  "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), "+f"(d[b + 4]),     \
      "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define WG_ACC64                                                                      \
  WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24), WG_ACC8(32), WG_ACC8(40), WG_ACC8(48), \
      WG_ACC8(56)
#define WG_D64                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "  \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "  \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64 x 128, f32) += A (64 x 16, shared, K-major) * B (16 x 128, shared,
// MN-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", %64, %65, p, 1, 1, 0, 1;\n}\n"
      : WG_ACC64
      : "l"(da), "l"(db), "r"(1));
}
// the same with A from registers (the m16n8k16 A-fragment layout per warp)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#define WG_ACC96 WG_ACC64, WG_ACC8(64), WG_ACC8(72), WG_ACC8(80), WG_ACC8(88)
#define WG_ACC128 \
  WG_ACC96, WG_ACC8(96), WG_ACC8(104), WG_ACC8(112), WG_ACC8(120)
#define WG_D96 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, " \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95}"
#define WG_D128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, " \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, " \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, " \
  "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, " \
  "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, " \
  "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, " \
  "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

#define WG_ACC32 WG_ACC8(0), WG_ACC8(8), WG_ACC8(16), WG_ACC8(24)
#define WG_D32                                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64 x N, f32) += A (64 x 16, shared, K-major) * B (16 x N, shared,
// MN-major) in one instruction, N = 128, 192 or 256: A is read once for the
// whole width
template <int N>
__device__ __forceinline__ void wgmma_ss_wide(float (&d)[N / 2], uint64_t da, uint64_t db) {
  if constexpr (N == 128) {
    wgmma_ss(d, da, db);
  } else if constexpr (N == 192) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %98, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 " WG_D96
        ", %96, %97, p, 1, 1, 0, 1;\n}\n"
        : WG_ACC96
        : "l"(da), "l"(db), "r"(1));
  } else {
    static_assert(N == 256, "wgmma_ss_wide takes N = 128, 192 or 256");
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %130, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG_D128
        ", %128, %129, p, 1, 1, 0, 1;\n}\n"
        : WG_ACC128
        : "l"(da), "l"(db), "r"(1));
  }
}

// d (64 x 64, f32) = A (64 x 16, shared, K-major) * B (16 x 64, shared,
// K-major), plus d when accumulate is nonzero (attention's S = Q K^T: K rows
// are head-dim contiguous, so K^T is K-major as it lies)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_ACC32
      : "l"(da), "l"(db), "r"(accumulate));
}
// d (64 x 64) += A (64 x 16, registers) * B (16 x 64, shared, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_ACC32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// tf32 (k = 8; A and B K-major only: tf32 has no transpose): d (64 x N) =
// A (64 x 8, registers: thread (g = lane / 4, c = lane % 4) of warp w holds
// rows 16 w + g, + 8 at columns c, c + 4) * B (8 x N, shared, K-major), plus
// d when accumulate is nonzero
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_ACC64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[4], const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {%0, %1, %2, %3}"
      ", {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// bf16 with an 8-row K-major B (the 3x3 conv to Cout <= 8, its weight
// padded to 8 rows): d (64 x 8, f32) += A (64 x 16, shared, K-major) *
// B (16 x 8, shared, K-major)
__device__ __forceinline__ void wgmma_ss_n8(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %6, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}"
      ", %4, %5, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1));
}
// the same with A from registers
__device__ __forceinline__ void wgmma_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %9, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}"
      ", {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// One stage of a 3xTF32 product for a consumer warpgroup (the f32 conv and
// the f32 GEMM of attention): the A fragments of its 64 rows from the
// stage's A tile (rows of 32 f32 = 128 bytes, 128-byte swizzle; ldmatrix
// reads the 32-bit words as pairs of b16; lrow: the tile row this lane
// addresses), each value a times a_scale (one f32 rounding, never fused),
// split into big = a with its low 13 mantissa bits cleared (exact in tf32)
// and small = a - big (exact in f32), then a_small w_big + a_big w_small +
// a_big w_big as register-A tf32 wgmmas (k = 8) into part, which starts
// from 0; wb / ws: the stage's (N x 32) K-major tiles of B's big and small
// parts. The dropped a_small w_small is ~2^-22 of a product. Returns when
// the wgmmas are done, so the caller can add part to its running sum in
// f32 (the tensor cores' own f32 accumulation rounds less well, and over
// thousands of k steps that costs digits).
template <int N>
__device__ __forceinline__ void tf32x3_stage(uint32_t a_tile, uint32_t wb, uint32_t ws, int lrow,
                                             float a_scale, float (&part)[N]) {
  const int lane = threadIdx.x % 32;
  uint32_t big[4][4], small[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    ldmatrix_x4(a_tile + lrow * 128 + (((2 * kk + lane / 16) ^ (lrow & 7)) << 4), big[kk]);
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float x = __fmul_rn(__uint_as_float(big[kk][v]), a_scale);
      big[kk][v] = __float_as_uint(x) & 0xFFFFE000u;
      small[kk][v] = __float_as_uint(x - __uint_as_float(big[kk][v]));
    }
  }
  fence_frag(big);
  fence_frag(small);
  fence_acc(part);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_sw128(wb + kk * 32, 16, SW_ROWS8);
    wgmma_tf32_rs(part, small[kk], db, kk);
    wgmma_tf32_rs(part, big[kk], desc_sw128(ws + kk * 32, 16, SW_ROWS8), 1);
    wgmma_tf32_rs(part, big[kk], db, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(part);
  fence_frag(big);
  fence_frag(small);
}

// the 256 consumer threads meet here (named barrier 1; the producer
// warpgroup never joins)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// the ring of stages in dynamic shared memory:
//   [pad to 1024][STAGES x (A tile, B tile)][full[STAGES]][empty[STAGES]]
// ---------------------------------------------------------------------------
template <int BN, int STAGES>
struct Ring {
  static constexpr int STAGE = stage_bytes<BN>();
  uint32_t tiles;
  __device__ uint32_t a(int s) const { return tiles + s * STAGE; }
  __device__ uint32_t b(int s) const { return a(s) + A_BYTES; }
  __device__ uint32_t full(int s) const { return tiles + STAGES * STAGE + 8 * s; }
  __device__ uint32_t empty(int s) const { return full(STAGES + s); }
  static constexpr int bytes() { return 1024 + STAGES * STAGE + 16 * STAGES; }
};

// carve the ring out of the dynamic shared memory; thread 0 initialises the
// barriers (full: the producer's one arrival plus the bytes; empty: one
// arrival per consumer warpgroup) and every thread passes one block barrier
template <int BN, int STAGES>
__device__ __forceinline__ void ring_init(uint8_t* raw, Ring<BN, STAGES>& r) {
  r.tiles = (smem_u32(raw) + 1023u) & ~1023u;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(r.full(s), 1);
      bar_init(r.empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// the producer thread's loop over this split's nk k-steps; load(s, it)
// issues the stage's TMA loads after its full barrier is armed
template <int BN, int STAGES, class Load>
__device__ __forceinline__ void produce(const Ring<BN, STAGES>& r, int nk, Load load) {
  for (int it = 0; it < nk; ++it) {
    const int s = it % STAGES;
    bar_wait(r.empty(s), ((it / STAGES) & 1) ^ 1);
    bar_expect_tx(r.full(s), Ring<BN, STAGES>::STAGE);
    load(s, it);
  }
}

// stage s's B tile: BN / 64 boxes of 64 columns at weight row k
template <int BN, int STAGES>
__device__ __forceinline__ void load_b(const Ring<BN, STAGES>& r, int s, const CUtensorMap* map,
                                       int n0, int k) {
#pragma unroll
  for (int j = 0; j < BN / 64; ++j)
    tma_load_2d(r.b(s) + j * BOX_BYTES, map, r.full(s), n0 + 64 * j, k);
}

// a consumer warpgroup is done with step it's stage: release it to the
// producer, unless the producer will not load that stage again (past step
// nk - STAGES)
template <int BN, int STAGES>
__device__ __forceinline__ void release(const Ring<BN, STAGES>& r, int it, int nk) {
  if (threadIdx.x % 128 == 0 && it + STAGES < nk) bar_arrive(r.empty(it % STAGES));
}

// one consumer warpgroup's loop over nk k-steps, A and B from shared memory
template <int BN, int STAGES>
__device__ __forceinline__ void consume_ss(const Ring<BN, STAGES>& r, int nk, int wgi,
                                           float (&acc)[BN / 128][64]) {
  for (int it = 0; it < nk; ++it) {
    const int s = it % STAGES;
    bar_wait(r.full(s), (it / STAGES) & 1);
#pragma unroll
    for (int j = 0; j < BN / 128; ++j) fence_acc(acc[j]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = desc_a(r.a(s), wgi * 64, kk);
#pragma unroll
      for (int j = 0; j < BN / 128; ++j) wgmma_ss(acc[j], da, desc_b(r.b(s), j, kk));
    }
    wgmma_commit();
#pragma unroll
    for (int j = 0; j < BN / 128; ++j) fence_acc(acc[j]);
    if (it > 0) {
      wgmma_wait<1>();  // step it - 1's wgmmas are done: release its stage
      release(r, it - 1, nk);
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int j = 0; j < BN / 128; ++j) fence_acc(acc[j]);
}

// the same at BN = 8: B is the stage's 8-row K-major tile (one 1 KB box of
// the weight padded to 8 rows), one m64n8k16 a k16 slice
template <int STAGES>
__device__ __forceinline__ void consume_ss_n8(const Ring<8, STAGES>& r, int nk, int wgi,
                                              float (&acc)[4]) {
  for (int it = 0; it < nk; ++it) {
    const int s = it % STAGES;
    bar_wait(r.full(s), (it / STAGES) & 1);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_ss_n8(acc, desc_a(r.a(s), wgi * 64, kk), desc_sw128(r.b(s) + kk * 32, 16, SW_ROWS8));
    wgmma_commit();
    fence_acc(acc);
    if (it > 0) {
      wgmma_wait<1>();
      release(r, it - 1, nk);
    }
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

// ---------------------------------------------------------------------------
// epilogue
// ---------------------------------------------------------------------------
struct Epilogue {
  const void* bias;              // (N,), or (batches, N) per batch, or null
  long long bias_bstride;        // 0: one bias for all rows; N: per batch
  long long rows_per_batch;      // output rows of one batch (the per-batch bias)
  const __nv_bfloat16* residual; // (M, N) or null
  __nv_bfloat16* out;            // (M, N)
  long long M;
  int N;
  int bias_dtype;                // 0 f32, 1 bf16
  int act;                       // 0 none, 1 SiLU, 2 GELU (erf)
};

// bias, residual and activation on 8 f32 sums of row m, columns n..n+7; one
// rounding to bf16, one 16-byte store
__device__ __forceinline__ void epilogue8(const Epilogue& e, long long m, int n, float (&v)[8]) {
  if (e.bias) {
    const long long o = (e.bias_bstride ? (m / e.rows_per_batch) * e.bias_bstride : 0) + n;
    if (e.bias_dtype == 1) {
      const __nv_bfloat16* b = static_cast<const __nv_bfloat16*>(e.bias) + o;
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += __bfloat162float(b[i]);
    } else {
      const float* b = static_cast<const float*>(e.bias) + o;
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] += b[i];
    }
  }
  if (e.residual) {
    float r[8];
    stv::load_vec<__nv_bfloat16, 8>(e.residual + m * e.N + n, r);
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] += r[i];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = stv::act(v[i], e.act);
  stv::store_vec<__nv_bfloat16, 8>(e.out + m * e.N + n, v);
}

// Within a quad of lanes (q = lane % 4), lane q holds p[j] = the columns
// 8j + 2q, 8j + 2q + 1 of one row, j = 0..3. Afterwards o holds the 8
// columns 8q .. 8q + 7: a 4 x 4 transpose across the quad in two xor
// exchanges (lane bit 0, then bit 1).
__device__ __forceinline__ void quad_transpose(float2 (&p)[4], float (&o)[8]) {
  const int q = threadIdx.x % 4;
#pragma unroll
  for (int bit = 1; bit <= 2; bit <<= 1) {
    const bool high = q & bit;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (j & bit) continue;
      const float2 send = high ? p[j] : p[j | bit];
      const float2 got = make_float2(__shfl_xor_sync(0xffffffffu, send.x, bit),
                                     __shfl_xor_sync(0xffffffffu, send.y, bit));
      if (high) p[j] = got;
      else p[j | bit] = got;
    }
  }
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    o[2 * s] = p[s].x;
    o[2 * s + 1] = p[s].y;
  }
}

// A consumer warpgroup's accumulators to the output (split == nullptr) or to
// this split's f32 partial tile. Accumulator i of sub-tile j lies at tile row
// 16 * warp + lane / 4 + 8 * ((i >> 1) & 1) and column 128 j + 8 (i >> 2) +
// 2 (lane % 4) + (i & 1); row_m maps a tile row to its output row, or -1.
template <int BN, class RowMap>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 128][64], int wgi, int n0,
                                           RowMap row_m, const Epilogue& e, float* partial) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long m = row_m(wgi * 64 + warp * 16 + lane / 4 + 8 * h);
#pragma unroll
    for (int j = 0; j < BN / 128; ++j)
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float2 p[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int i = (4 * g + jj) * 4 + 2 * h;
          p[jj] = make_float2(acc[j][i], acc[j][i + 1]);
        }
        float o[8];
        quad_transpose(p, o);
        const int n = n0 + 128 * j + 8 * (4 * g + (lane & 3));
        if (m < 0 || n >= e.N) continue;
        if (partial) {
          float4* dst = reinterpret_cast<float4*>(partial + m * e.N + n);
          dst[0] = make_float4(o[0], o[1], o[2], o[3]);
          dst[1] = make_float4(o[4], o[5], o[6], o[7]);
        } else {
          epilogue8(e, m, n, o);
        }
      }
  }
}

// A consumer warpgroup's m64n8 accumulators to the first e.N (<= 8)
// columns of the output: accumulator 2r + c lies at tile row 16 * warp +
// lane / 4 + 8r and column 2 (lane % 4) + c. Bias, residual and activation
// as in epilogue8, one rounding and an element store each (a row of N < 8
// bf16 is no 16-byte vector).
template <class RowMap>
__device__ __forceinline__ void store_n8(const float (&acc)[4], int wgi, RowMap row_m,
                                         const Epilogue& e) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long m = row_m(wgi * 64 + warp * 16 + lane / 4 + 8 * r);
    if (m < 0) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int n = 2 * (lane % 4) + c;
      if (n >= e.N) continue;
      float v = acc[2 * r + c];
      if (e.bias) {
        const long long o = (e.bias_bstride ? (m / e.rows_per_batch) * e.bias_bstride : 0) + n;
        v += e.bias_dtype == 1 ? __bfloat162float(static_cast<const __nv_bfloat16*>(e.bias)[o])
                               : static_cast<const float*>(e.bias)[o];
      }
      if (e.residual) v += __bfloat162float(e.residual[m * e.N + n]);
      v = stv::act(v, e.act);
      e.out[m * e.N + n] = __float2bfloat16(v);
    }
  }
}

// the S partial tiles of each output summed in split order, then the epilogue;
// one thread per 8 columns of a row
__global__ void __launch_bounds__(256) splitk_reduce(const float* __restrict__ ws, int splits,
                                                     Epilogue e) {
  const long long chunks = e.M * (e.N / 8);
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= chunks) return;
  const long long m = idx / (e.N / 8);
  const int n = static_cast<int>(idx % (e.N / 8)) * 8;
  float v[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int s = 0; s < splits; ++s) {
    const float4* src = reinterpret_cast<const float4*>(ws + (s * e.M + m) * e.N + n);
    const float4 a = src[0], b = src[1];
    v[0] += a.x; v[1] += a.y; v[2] += a.z; v[3] += a.w;
    v[4] += b.x; v[5] += b.y; v[6] += b.z; v[7] += b.w;
  }
  epilogue8(e, m, n, v);
}

// this block's output tile: row tile blockIdx.x / n_tiles, column tile
// blockIdx.x % n_tiles
__device__ __forceinline__ void block_tile(int n_tiles, int& m_tile, int& n_tile) {
  m_tile = static_cast<int>(blockIdx.x) / n_tiles;
  n_tile = static_cast<int>(blockIdx.x) - m_tile * n_tiles;
}

// this split's k-steps of nk in all: [z * nk / S, (z + 1) * nk / S)
__device__ __forceinline__ void split_range(int nk, int splits, int z, int& k0, int& k1) {
  k0 = static_cast<int>(static_cast<long long>(z) * nk / splits);
  k1 = static_cast<int>(static_cast<long long>(z + 1) * nk / splits);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's tensor-map encoder, through the runtime (no -lcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a bf16 (or f32) tensor map (rank <= 4) with 128-byte swizzle (or another)
// and zero fill out of range: dims and box innermost first, strides in bytes of dims
// 1..rank-1. Encoded per launch: the C entry's whole host time, both encodes
// included, is ~5 us on an H100 host, a quarter of the Python wrapper's
// (kernel_table.py --host times the wrappers).
bool make_map(CUtensorMap* map, const void* base, int rank, const uint64_t* dims,
              const uint64_t* strides, const uint32_t* box,
              CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
              CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  EncodeTiled enc = encoder();
  if (!enc) return false;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], e[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = dims[i];
    b[i] = box[i];
    e[i] = 1;
    if (i + 1 < rank) s[i] = strides[i];
  }
  return enc(map, dtype, rank, const_cast<void*>(base), d, s, b, e,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the (K, N) weight as B: boxes of 64 columns x 64 rows
bool make_b_map(CUtensorMap* map, const void* w, long long rows, int n) {
  const uint64_t dims[2] = {static_cast<uint64_t>(n), static_cast<uint64_t>(rows)};
  const uint64_t strides[1] = {static_cast<uint64_t>(n) * 2};
  const uint32_t box[2] = {64, BK};
  return make_map(map, w, 2, dims, strides, box);
}

int launch_reduce(const float* ws, int splits, const Epilogue& e, cudaStream_t stream) {
  const long long chunks = e.M * (e.N / 8);
  splitk_reduce<<<static_cast<unsigned>((chunks + 255) / 256), 256, 0, stream>>>(ws, splits, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace wg
