// Linear layer for Hopper (sm_90a): out = act(x @ w + b), x (M, K) and w
// (K, N) row-major, f32 accumulation, the (N,) f32 bias and the activation
// (SiLU, or the exact erf GELU) applied to the f32 sum in the epilogue, one
// rounding to the input dtype. Computes the function of the Pallas TPU kernel
// stabletriton_tpu/kernels/linear.py:_linear_kernel, whose GELU carries its
// own erf polynomial only because Mosaic has none; here erff.
//
// Ragged M, N and K edges are masked: every shape is right. Three kernels:
//
//   linear_wmma_bf16   - bf16 operands on tensor cores (WMMA 16x16x16, f32
//                        acc), 128x128 block tile, 8 warps of 32x64, K in
//                        steps of 32 through two shared-memory buffers: with
//                        K % 8 == 0, N % 8 == 0 and 16-byte aligned bases the
//                        next tile streams in by cp.async while the current
//                        one is multiplied; otherwise by predicated element
//                        loads. The UNet's GEMMs, M = 128 ... 8192.
//   linear_skinny<T>   - M <= 16 rows (the time-embedding MLPs and the
//                        resnets' time projections run at M = 2): a 128-row
//                        tile would leave 98% of its rows empty. Each block
//                        takes 32 columns; its 16 warps split K, each lane
//                        reads one column of w (a warp reads 32 neighbouring
//                        values of a row), x comes in as warp-wide broadcasts,
//                        and the 16 partial sums meet in shared memory.
//   linear_scalar_f32  - f32 FMA, 64x64 block tile, 4x4 outputs a thread, no
//                        TF32 rounding: the VAE decoder's f32 mid-attention
//                        projections.
//
// What bounds them on the H100: the large GEMMs are compute-bound (hundreds
// of FLOPs a byte); this WMMA kernel has no wgmma or TMA and reaches a
// fraction of the tensor-core rate (PERF.md). The skinny GEMMs are bound by
// reading w once.

#include <mma.h>

#include "vec.cuh"

using namespace nvcuda;

namespace {

using stv::from_f32;
using stv::to_f32;

struct LinearArgs {
  const void* x;      // (M, K)
  const void* w;      // (K, N)
  const float* bias;  // (N,) or null
  void* out;          // (M, N)
  int M, N, K, act;   // act: 0 none, 1 SiLU, 2 GELU (erf)
};

// bias and activation on the f32 sum of output column n
__device__ __forceinline__ float epilogue(const LinearArgs& a, int n, float acc) {
  if (a.bias) acc += a.bias[n];
  if (a.act == 1) acc = acc / (1.f + expf(-acc));
  else if (a.act == 2) acc = 0.5f * acc * (1.f + erff(acc * 0.70710678118654752f));
  return acc;
}

template <typename T>
__device__ __forceinline__ void store_out(const LinearArgs& a, int m, int n, float acc) {
  if (m < a.M && n < a.N)
    static_cast<T*>(a.out)[(long long)m * a.N + n] = from_f32<T>(epilogue(a, n, acc));
}

// ---------------------------------------------------------------------------
// bf16 WMMA kernel
// ---------------------------------------------------------------------------
constexpr int WBM = 128, WBN = 128, WBK = 32, WTHREADS = 256;
constexpr int LDA = WBK + 8;  // bf16 pitch, multiple of 8 (16 bytes)
constexpr int LDB = WBN + 8;

// 16-byte copy global -> shared, zero-filled when !pred (src is then not read)
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

// stage the (WBM x WBK) tile of x and the (WBK x WBN) tile of w at k0
template <bool VEC>
__device__ __forceinline__ void load_tiles(const LinearArgs& a, __nv_bfloat16* As,
                                           __nv_bfloat16* Bs, int m0, int n0, int k0) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    // K and N are multiples of 8: an 8-wide chunk lies wholly in or out
#pragma unroll
    for (int s = 0; s < 2; ++s) {  // A: 128 rows x 4 chunks
      const int idx = tid + s * WTHREADS, row = idx / 4, c = (idx % 4) * 8;
      const int m = m0 + row, k = k0 + c;
      const bool ok = m < a.M && k < a.K;
      cp_async16(As + row * LDA + c, ok ? x + (long long)m * a.K + k : x, ok);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {  // B: 32 rows x 16 chunks
      const int idx = tid + s * WTHREADS, row = idx / 16, c = (idx % 16) * 8;
      const int k = k0 + row, n = n0 + c;
      const bool ok = k < a.K && n < a.N;
      cp_async16(Bs + row * LDB + c, ok ? w + (long long)k * a.N + n : w, ok);
    }
  } else {
    for (int idx = tid; idx < WBM * WBK; idx += WTHREADS) {
      const int mm = idx / WBK, kk = idx % WBK, m = m0 + mm, k = k0 + kk;
      As[mm * LDA + kk] = (m < a.M && k < a.K) ? x[(long long)m * a.K + k]
                                               : __float2bfloat16(0.f);
    }
    for (int idx = tid; idx < WBK * WBN; idx += WTHREADS) {
      const int kk = idx / WBN, nn = idx % WBN, k = k0 + kk, n = n0 + nn;
      Bs[kk * LDB + nn] = (k < a.K && n < a.N) ? w[(long long)k * a.N + n]
                                               : __float2bfloat16(0.f);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(WTHREADS) linear_wmma_bf16(LinearArgs a) {
  __shared__ __align__(128) __nv_bfloat16 As[2][WBM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[2][WBK * LDB];
  __shared__ __align__(128) float stage[8][16 * 16];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.x * WBM, n0 = blockIdx.y * WBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (a.K + WBK - 1) / WBK;
  load_tiles<VEC>(a, As[0], Bs[0], m0, n0, 0);
  cp_async_commit();
  for (int t = 0; t < nk; ++t) {
    // the buffer refilled here was last read in step t - 1, behind its
    // trailing barrier
    if (t + 1 < nk) load_tiles<VEC>(a, As[(t + 1) & 1], Bs[(t + 1) & 1], m0, n0, (t + 1) * WBK);
    cp_async_commit();
    cp_async_wait_one();  // every copy but the newest group (tile t + 1) has landed
    __syncthreads();
    const __nv_bfloat16* as = As[t & 1];
    const __nv_bfloat16* bs = Bs[t & 1];
#pragma unroll
    for (int kk = 0; kk < WBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], bs + kk * LDB + wn * 64 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: each 16x16 fragment through the warp's shared scratch, then
  // each lane finishes 8 of its elements
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int mb = m0 + wm * 32 + i * 16, nb = n0 + wn * 64 + j * 16;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int idx = lane + 32 * e;
        store_out<__nv_bfloat16>(a, mb + idx / 16, nb + idx % 16, st[idx]);
      }
      __syncwarp();
    }
}

// ---------------------------------------------------------------------------
// skinny kernel: M <= SKINNY_MAX_M
// ---------------------------------------------------------------------------
constexpr int SKINNY_MAX_M = 16, KCOLS = 32, KSLICES = 16;

template <typename T>
__global__ void __launch_bounds__(KCOLS * KSLICES) linear_skinny(LinearArgs a) {
  __shared__ float part[KSLICES][SKINNY_MAX_M][KCOLS + 1];
  const int lane = threadIdx.x % KCOLS, g = threadIdx.x / KCOLS;
  const int n = blockIdx.x * KCOLS + lane;
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  float acc[SKINNY_MAX_M];
#pragma unroll
  for (int m = 0; m < SKINNY_MAX_M; ++m) acc[m] = 0.f;
  if (n < a.N) {
#pragma unroll 4
    for (int k = g; k < a.K; k += KSLICES) {
      const float wv = to_f32(w[(long long)k * a.N + n]);
#pragma unroll
      for (int m = 0; m < SKINNY_MAX_M; ++m)
        if (m < a.M) acc[m] = fmaf(to_f32(x[(long long)m * a.K + k]), wv, acc[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < SKINNY_MAX_M; ++m) part[g][m][lane] = acc[m];
  __syncthreads();
  for (int m = g; m < a.M; m += KSLICES) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < KSLICES; ++i) s += part[i][m][lane];
    store_out<T>(a, m, n, s);
  }
}

// ---------------------------------------------------------------------------
// scalar f32 kernel: BM=64 x BN=64 tile, BK=16, 256 threads, 4x4 outputs each
// at rows tm + 16*i and columns tn + 16*j (conflict-free shared reads)
// ---------------------------------------------------------------------------
constexpr int SBM = 64, SBN = 64, SBK = 16, STHREADS = 256;

__global__ void __launch_bounds__(STHREADS) linear_scalar_f32(LinearArgs a) {
  __shared__ float As[SBK][SBM + 4];
  __shared__ float Bs[SBK][SBN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * SBM, n0 = blockIdx.y * SBN;
  const int tm = tid / 16, tn = tid % 16;
  const float* x = static_cast<const float*>(a.x);
  const float* w = static_cast<const float*>(a.w);
  float acc[4][4] = {};

  for (int k0 = 0; k0 < a.K; k0 += SBK) {
    // A: consecutive threads take consecutive k (one row of x)
    for (int idx = tid; idx < SBM * SBK; idx += STHREADS) {
      const int kk = idx % SBK, mm = idx / SBK, m = m0 + mm, k = k0 + kk;
      As[kk][mm] = (m < a.M && k < a.K) ? x[(long long)m * a.K + k] : 0.f;
    }
    for (int idx = tid; idx < SBK * SBN; idx += STHREADS) {
      const int kk = idx / SBN, nn = idx % SBN, k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < a.K && n < a.N) ? w[(long long)k * a.N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][tm + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tn + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) store_out<float>(a, m0 + tm + 16 * i, n0 + tn + 16 * j, acc[i][j]);
}

}  // namespace

// x (M, K), w (K, N), out (M, N) contiguous, of one dtype (0 = f32, 1 =
// bf16); bias (N,) f32 or null. act: 0 none, 1 SiLU, 2 GELU. variant: 0 the
// scalar f32 kernel, 1 the bf16 WMMA kernel, 2 the skinny kernel (M <= 16);
// vec (WMMA only): 1 when K and N are multiples of 8 and x and w 16-byte
// aligned. Returns a cudaError_t (0 on success).
extern "C" int st_linear(const void* x, const void* w, const float* bias, void* out, int M,
                         int N, int K, int act, int dtype, int variant, int vec,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const LinearArgs a{x, w, bias, out, M, N, K, act};
  if (act < 0 || act > 2 || M <= 0 || N <= 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (variant == 2) {
    if (M > SKINNY_MAX_M) return (int)cudaErrorInvalidValue;
    const dim3 grid((N + KCOLS - 1) / KCOLS);
    if (dtype == 1)
      linear_skinny<__nv_bfloat16><<<grid, KCOLS * KSLICES, 0, stream>>>(a);
    else if (dtype == 0)
      linear_skinny<float><<<grid, KCOLS * KSLICES, 0, stream>>>(a);
    else
      return (int)cudaErrorInvalidValue;
  } else if (variant == 1 && dtype == 1) {
    const dim3 grid((M + WBM - 1) / WBM, (N + WBN - 1) / WBN);
    if (vec)
      linear_wmma_bf16<true><<<grid, WTHREADS, 0, stream>>>(a);
    else
      linear_wmma_bf16<false><<<grid, WTHREADS, 0, stream>>>(a);
  } else if (variant == 0 && dtype == 0) {
    const dim3 grid((M + SBM - 1) / SBM, (N + SBN - 1) / SBN);
    linear_scalar_f32<<<grid, STHREADS, 0, stream>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
