// Linear layer for Hopper (sm_90a): out = act(x @ w + b), x (M, K) and w
// (K, N) row-major, f32 accumulation, the (N,) bias (read in its own dtype,
// f32 or bf16) and the activation (SiLU, or the exact erf GELU: stv::act)
// applied to the f32 sum in the epilogue, one rounding to the input dtype.
// Computes the function of the Pallas TPU kernel
// stabletriton_tpu/kernels/linear.py:_linear_kernel, whose GELU carries its
// own erf polynomial only because Mosaic has none; here erff.
//
// Four kernels:
//
//   linear_wgmma_bf16  - bf16 with K % 8 == 0, N % 8 == 0 and 16-byte aligned
//                        operands (what TMA takes): the Hopper mainloop of
//                        wgmma.cuh, TMA loads into 3 stages (BN = 128, two
//                        blocks an SM) or 4 (BN = 256, one block), two
//                        consumer warpgroups of m64n128k16
//                        wgmma, the epilogue from the accumulator registers
//                        with 16-byte stores. A split-K count from the
//                        wrapper's planner fills the card where the output
//                        tiles alone do not (the cross K/V precompute: 40
//                        tiles); the splits meet in splitk_reduce. The UNet's
//                        GEMMs, M = 128 ... 8192.
//   linear_wmma_bf16   - bf16 shapes TMA cannot take (K or N not a multiple of
//                        8, a misaligned base): WMMA 16x16x16, 128x128 block
//                        tile, 8 warps of 32x64, K in steps of 32 through two
//                        shared-memory buffers filled by predicated element
//                        loads. Every shape is right.
//   linear_skinny<T>   - M <= 16 rows (the time-embedding MLPs and the
//                        resnets' time projections run at M = 2): a 128-row
//                        tile would leave 98% of its rows empty. Each block
//                        takes 32 columns; its 16 warps split K, each lane
//                        reads one column of w (a warp reads 32 neighbouring
//                        values of a row), x comes in as warp-wide broadcasts,
//                        and the 16 partial sums meet in shared memory.
//   gemm_wgmma_tf32x3<2> - f32 with M > 16 (the VAE decoder's mid-attention
//                        projections, (16384, 512) @ (512, 512) an image at
//                        1024^2): the 3xTF32 GEMM of tf32_gemm.cuh, shared
//                        with the f32 attention, in its plain-GEMM mode. A is
//                        x as it lies (K-major), B is w^T (N, K) split into a
//                        big part exact in tf32 and the small rest by
//                        tf32_split_t, launched first by the same C entry
//                        (tf32 wgmma has no transpose); the GEMM splits x the
//                        same way in registers and sums three tf32 products,
//                        so the result keeps ~f32 accuracy on the tensor
//                        cores. TMA takes rows of 16 bytes (K % 4 == 0) from
//                        16-byte aligned bases: the wrapper pads K or copies
//                        x where it must.
//
// What bounds them on the H100: the large GEMMs are compute-bound (hundreds
// of FLOPs a byte, against the card's ~295 FLOP/B balance), so the wgmma
// kernels keep the tensor cores fed from a TMA ring and store straight from
// registers; grids of fewer tiles than the 132 SMs split K (bf16). The f32
// GEMM is bound by the tf32 rate over three (165 TFLOP/s), against the 67 of
// f32 FMAs outside the tensor cores. The skinny GEMMs are bound by reading w
// once.

#include <mma.h>

#include "tf32_gemm.cuh"
#include "vec.cuh"
#include "wgmma.cuh"

using namespace nvcuda;

namespace {

using stv::from_f32;
using stv::to_f32;

struct LinearArgs {
  const void* x;      // (M, K)
  const void* w;      // (K, N)
  const void* bias;   // (N,) of bias_dtype, or null
  void* out;          // (M, N)
  int M, N, K, act;   // act: 0 none, 1 SiLU, 2 GELU (erf)
  int bias_dtype;     // 0 f32, 1 bf16
};

// bias and activation on the f32 sum of output column n
__device__ __forceinline__ float epilogue(const LinearArgs& a, int n, float acc) {
  if (a.bias) acc += stv::load_param(a.bias, a.bias_dtype, n);
  return stv::act(acc, a.act);
}

template <typename T>
__device__ __forceinline__ void store_out(const LinearArgs& a, int m, int n, float acc) {
  if (m < a.M && n < a.N)
    static_cast<T*>(a.out)[(long long)m * a.N + n] = from_f32<T>(epilogue(a, n, acc));
}

// ---------------------------------------------------------------------------
// bf16 WMMA kernel, for the shapes TMA cannot take: element loads, so no
// alignment or multiple of 8 is assumed
// ---------------------------------------------------------------------------
constexpr int WBM = 128, WBN = 128, WBK = 32, WTHREADS = 256;
constexpr int LDA = WBK + 8;  // bf16 pitch, multiple of 8 (16 bytes)
constexpr int LDB = WBN + 8;

// stage the (WBM x WBK) tile of x and the (WBK x WBN) tile of w at k0
__device__ __forceinline__ void load_tiles(const LinearArgs& a, __nv_bfloat16* As,
                                           __nv_bfloat16* Bs, int m0, int n0, int k0) {
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);
  for (int idx = threadIdx.x; idx < WBM * WBK; idx += WTHREADS) {
    const int mm = idx / WBK, kk = idx % WBK, m = m0 + mm, k = k0 + kk;
    As[mm * LDA + kk] = (m < a.M && k < a.K) ? x[(long long)m * a.K + k] : __float2bfloat16(0.f);
  }
  for (int idx = threadIdx.x; idx < WBK * WBN; idx += WTHREADS) {
    const int kk = idx / WBN, nn = idx % WBN, k = k0 + kk, n = n0 + nn;
    Bs[kk * LDB + nn] = (k < a.K && n < a.N) ? w[(long long)k * a.N + n] : __float2bfloat16(0.f);
  }
}

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
  load_tiles(a, As[0], Bs[0], m0, n0, 0);
  for (int t = 0; t < nk; ++t) {
    // the buffer refilled here was last read in step t - 1, behind its
    // trailing barrier
    if (t + 1 < nk) load_tiles(a, As[(t + 1) & 1], Bs[(t + 1) & 1], m0, n0, (t + 1) * WBK);
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
// the B operand of the f32 GEMM: w (Kw, N) row-major -> big / small (N, K)
// K-major, w^T with zero columns at k >= Kw, split as tf32x3_stage splits A
// (big = w with its low 13 mantissa bits cleared, exact in tf32; small = w -
// big, exact in f32). A 32 x 32 tile a block through shared memory, so the
// reads (along n) and the writes (along k) are both coalesced. Its plain
// version is kernels/linear.py tf32_weight.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256) tf32_split_t(const float* __restrict__ w,
                                                    float* __restrict__ big,
                                                    float* __restrict__ small, int Kw, int N,
                                                    int K) {
  __shared__ float tile[32][33];
  const int k0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + tx;
    tile[i][tx] = (k < Kw && n < N) ? w[(long long)k * N + n] : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + tx;
    if (n < N && k < K) {
      const float v = tile[tx][i];
      const float b = __uint_as_float(__float_as_uint(v) & 0xFFFFE000u);
      big[(long long)n * K + k] = b;
      small[(long long)n * K + k] = v - b;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 wgmma kernel (the mainloop of wgmma.cuh): block tile 128 x BN, split
// blockIdx.z of the K steps
// ---------------------------------------------------------------------------
struct WgmmaArgs {
  wg::Epilogue e;
  float* ws;  // (splits, M, N) f32 partials when splits > 1
  int K, splits;
};

template <int BN, int STAGES, int CTAS>
__global__ void __launch_bounds__(wg::THREADS, CTAS)
    linear_wgmma_bf16(const __grid_constant__ CUtensorMap tmap_x,
                      const __grid_constant__ CUtensorMap tmap_w, WgmmaArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  wg::Ring<BN, STAGES> r;
  wg::ring_init(smem, r);
  int mt, nt;
  wg::block_tile((a.e.N + BN - 1) / BN, mt, nt);
  const int n0 = nt * BN, m0 = mt * wg::BM;
  int k0, k1;
  wg::split_range((a.K + wg::BK - 1) / wg::BK, a.splits, blockIdx.z, k0, k1);
  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    if (threadIdx.x == 256) {
      const CUtensorMap* mx = &tmap_x;
      const CUtensorMap* mw = &tmap_w;
      wg::produce(r, k1 - k0, [&](int s, int it) {
        const int k = (k0 + it) * wg::BK;
        wg::tma_load_2d(r.a(s), mx, r.full(s), k, m0);
        wg::load_b(r, s, mw, n0, k);
      });
    }
  } else {
    float acc[BN / 128][64];
#pragma unroll
    for (int j = 0; j < BN / 128; ++j)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;
    wg::consume_ss(r, k1 - k0, wgi, acc);
    const long long M = a.e.M;
    wg::store_tile<BN>(
        acc, wgi, n0, [&](int row) -> long long { return m0 + row < M ? m0 + row : -1; }, a.e,
        a.splits > 1 ? a.ws + blockIdx.z * M * a.e.N : nullptr);
  }
}

template <int BN, int STAGES, int CTAS>
int launch_wgmma(const CUtensorMap& tx, const CUtensorMap& tw, const WgmmaArgs& a,
                 cudaStream_t stream) {
  constexpr int smem = wg::Ring<BN, STAGES>::bytes();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        linear_wgmma_bf16<BN, STAGES, CTAS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  const long long tiles = (a.e.M + wg::BM - 1) / wg::BM * ((a.e.N + BN - 1) / BN);
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, 1, a.splits);
  linear_wgmma_bf16<BN, STAGES, CTAS><<<grid, wg::THREADS, smem, stream>>>(tx, tw, a);
  return (int)cudaGetLastError();
}

}  // namespace

// x (M, K), w (K, N), out (M, N) contiguous, of one dtype (0 = f32, 1 =
// bf16); bias (N,) of bias_dtype (0 = f32, 1 = bf16) or null. act: 0 none,
// 1 SiLU, 2 GELU. variant: 1 the bf16 WMMA kernel, 2 the skinny kernel (M <=
// 16, either dtype). Returns a cudaError_t (0 on success).
extern "C" int st_linear(const void* x, const void* w, const void* bias, int bias_dtype,
                         void* out, int M, int N, int K, int act, int dtype, int variant,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const LinearArgs a{x, w, bias, out, M, N, K, act, bias_dtype};
  if (act < 0 || act > 2 || M <= 0 || N <= 0 || K < 0 || bias_dtype < 0 || bias_dtype > 1)
    return (int)cudaErrorInvalidValue;
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
    linear_wmma_bf16<<<grid, WTHREADS, 0, stream>>>(a);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The bf16 wgmma GEMM: x (M, K), w (K, N), out (M, N) contiguous bf16 with
// K % 8 == 0, N % 8 == 0 and 16-byte aligned bases (TMA's terms); bias (N,)
// of bias_dtype or null; act as st_linear. bn: the block tile's width (128
// or 256); splits: the K split (1 <= splits <= ceil(K / 64)), with ws a
// (splits, M, N) f32 workspace when splits > 1. Returns a cudaError_t.
extern "C" int st_linear_wgmma(const void* x, const void* w, const void* bias, int bias_dtype,
                               void* out, float* ws, int M, int N, int K, int act, int bn,
                               int splits, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nk = (K + wg::BK - 1) / wg::BK;
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (act < 0 || act > 2 || M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8 || !aligned ||
      bias_dtype < 0 || bias_dtype > 1 || (bn != 128 && bn != 256) || splits < 1 ||
      splits > nk || (splits > 1 && !ws))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, tw;
  const uint64_t xdims[2] = {(uint64_t)K, (uint64_t)M};
  const uint64_t xstrides[1] = {(uint64_t)K * 2};
  const uint32_t xbox[2] = {wg::BK, wg::BM};
  if (!wg::make_map(&tx, x, 2, xdims, xstrides, xbox) || !wg::make_b_map(&tw, w, K, N))
    return (int)cudaErrorInvalidValue;
  const wg::Epilogue e{bias, 0, M, nullptr, static_cast<__nv_bfloat16*>(out), M, N, bias_dtype,
                       act};
  const WgmmaArgs a{e, ws, K, splits};
  const int code = bn == 256 ? launch_wgmma<256, 4, 1>(tx, tw, a, stream)
                             : launch_wgmma<128, 3, 2>(tx, tw, a, stream);
  if (code != 0 || splits == 1) return code;
  return wg::launch_reduce(ws, splits, e, stream);
}

// The f32 linear on the 3xTF32 wgmma kernel, two launches: tf32_split_t
// makes B from w, then gemm_wgmma_tf32x3<2>. x (M, K) f32 with K % 4 == 0
// and a 16-byte aligned base; w (Kw, N) f32 row-major with Kw <= K (x's
// columns at or past Kw meet zero rows); ws: 2 N K f32 scratch, 16-byte
// aligned (big, then small); out (M, N) f32 8-byte aligned; bias (N,) of
// bias_dtype (0 = f32, 1 = bf16) or null; act as st_linear. Returns a
// cudaError_t (0 on success).
extern "C" int st_linear_tf32x3(const float* x, const float* w, float* ws, const void* bias,
                                int bias_dtype, float* out, int M, int N, int K, int Kw, int act,
                                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto a16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  if (act < 0 || act > 2 || M <= 0 || N <= 0 || K <= 0 || K % 4 || Kw < 0 || Kw > K ||
      (N + 31) / 32 > 65535 || bias_dtype < 0 || bias_dtype > 1 || !a16(x) || !a16(ws) ||
      reinterpret_cast<uintptr_t>(out) % 8)
    return (int)cudaErrorInvalidValue;
  const long long tiles = (M + wg::BM - 1) / wg::BM * (long long)((N + TG_BN - 1) / TG_BN);
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  float* w_big = ws;
  float* w_small = ws + (long long)N * K;
  CUtensorMap tx, tb, ts;
  if (!f32_map(&tx, x, K, M, 1, K, (uint64_t)M * K) ||
      !f32_map(&tb, w_big, K, N, 1, K, (uint64_t)N * K) ||
      !f32_map(&ts, w_small, K, N, 1, K, (uint64_t)N * K))
    return (int)cudaErrorInvalidValue;
  tf32_split_t<<<dim3((K + 31) / 32, (N + 31) / 32), 256, 0, stream>>>(w, w_big, w_small, Kw, N,
                                                                        K);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Tf32GemmArgs g{};
  g.M = M, g.N = N, g.K = K, g.n_tiles = (N + TG_BN - 1) / TG_BN;
  g.a_row0 = 0, g.a_col0 = 0, g.a_heads = 1, g.a_head_cols = 0, g.a_scale = 1.f;
  g.out = out, g.out_b = 0, g.out_ld = N, g.out_row0 = 0, g.heads = 1, g.head_cols = 0;
  g.bias = bias, g.bias_dtype = bias_dtype, g.act = act;
  return launch_tf32_gemm<2>(tx, tb, ts, g, 1, stream);
}
