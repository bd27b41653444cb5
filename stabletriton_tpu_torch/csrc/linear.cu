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
//                        tile would leave 98% of its rows empty. w is read
//                        once as 16-byte vectors by enough blocks to fill
//                        the card (a column slice each, K split over a
//                        thread block cluster), x staged once in shared
//                        memory, the splits summed in rank order through
//                        distributed shared memory.
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

#include <cooperative_groups.h>
#include <mma.h>

#include "tf32_gemm.cuh"
#include "vec.cuh"
#include "wgmma.cuh"

using namespace nvcuda;
namespace cg = cooperative_groups;

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
// skinny kernel: M <= SKINNY_MAX_M. Bound by reading w once (2 FLOPs a
// weight at M = 2), so the design is about bytes in flight: a block of 256
// threads takes `cols` output columns (BC = cols / V 16-byte vectors of a w
// row, BC in {8, 4, 2}) and `rows` rows of K; its threads read w as 16-byte
// vectors, neighbouring lanes on neighbouring addresses, RP = 256 / BC rows
// a pass, each thread a group of U passes in flight ahead of its FMAs. x
// (M x rows) is staged once in shared memory as f32. The K split's blocks
// form one thread block cluster (cluster rank = split): each block sums its
// 8 warps in shared memory, then the cluster's blocks read each other's
// partials through distributed shared memory and add them in rank order.
// Every sum runs in a fixed order (a thread's FMA chain along k, an
// xor-butterfly over a warp's rows, the warps in order, the splits in
// order) with no atomics and no workspace, so two launches give the same
// bits. The wrapper's planner (kernels/linear.py skinny_plan) picks cols and
// the split: whole 128-byte lines of a row where N allows, and enough
// blocks to fill the 132 SMs where K allows.
// ---------------------------------------------------------------------------
constexpr int SKINNY_MAX_M = 16, SK_THREADS = 256, SK_WARPS = SK_THREADS / 32;
constexpr int SK_MAX_SPLITS = 8;  // the portable cluster size
constexpr int SK_XROWS = 256;     // rows of x a shared-memory stage holds (a multiple of RP)

struct SkinnyArgs {
  LinearArgs a;
  int cols, splits, rows;  // columns and K rows a block takes; blocks a cluster
};

// V values of T at w + off as the raw 16 bytes of one vector: one 16-byte
// load (VEC: aligned, N a multiple of V) or element loads of the `valid`
// leading columns (the rest zero)
template <typename T, bool VEC>
__device__ __forceinline__ uint4 load_w(const T* w, long long off, int valid) {
  constexpr int V = 16 / sizeof(T);
  if constexpr (VEC) {
    return valid > 0 ? __ldg(reinterpret_cast<const uint4*>(w + off)) : make_uint4(0, 0, 0, 0);
  } else {
    uint4 raw = make_uint4(0, 0, 0, 0);
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (i < valid) e[i] = w[off + i];
    return raw;
  }
}

template <typename T, int MM, bool VEC>
__global__ void __launch_bounds__(SK_THREADS) linear_skinny(SkinnyArgs sa) {
  constexpr int V = 16 / sizeof(T);
  constexpr int MAX_COLS = 8 * V;
  constexpr int U = MM <= 4 ? 8 : 4;  // passes a thread keeps in flight
  constexpr int XS = SK_XROWS * MM, RED = SK_WARPS * MM * MAX_COLS;
  __shared__ __align__(16) float buf[XS > RED ? XS : RED];  // x stage, then warp partials
  __shared__ float part[MM * MAX_COLS];                      // the block's partial sums

  const LinearArgs& a = sa.a;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int slice = blockIdx.x / sa.splits;
  const int cols = sa.cols, bc = cols / V, rp = SK_THREADS / bc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cv = lane % bc;              // this thread's vector in the slice
  const int r = warp * (32 / bc) + lane / bc;  // its row in a pass
  const int n = slice * cols + cv * V;   // its first column
  const int valid = min(V, a.N - n);
  const T* x = static_cast<const T*>(a.x);
  const T* w = static_cast<const T*>(a.w);
  const int k0 = split * sa.rows, k1 = min(a.K, k0 + sa.rows);

  float acc[MM][V];
#pragma unroll
  for (int m = 0; m < MM; ++m)
#pragma unroll
    for (int i = 0; i < V; ++i) acc[m][i] = 0.f;

  for (int c0 = k0; c0 < k1; c0 += SK_XROWS) {
    const int c1 = min(k1, c0 + SK_XROWS);
    // the first group of w loads goes out before x is staged
    uint4 nxt[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = c0 + r + u * rp;
      nxt[u] = k < c1 ? load_w<T, VEC>(w, (long long)k * a.N + n, valid) : make_uint4(0, 0, 0, 0);
    }
    // x's (M x chunk) values, a thread's loads all issued before its stores
    constexpr int XI = SK_XROWS * MM / SK_THREADS;
    float xv[XI];
#pragma unroll
    for (int j = 0; j < XI; ++j) {
      const int i = tid + j * SK_THREADS, m = i / (c1 - c0), kk = i % (c1 - c0);
      xv[j] = m < a.M ? to_f32(x[(long long)m * a.K + c0 + kk]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < XI; ++j) {
      const int i = tid + j * SK_THREADS, m = i / (c1 - c0), kk = i % (c1 - c0);
      if (m < MM) buf[kk * MM + m] = xv[j];
    }
    __syncthreads();
    for (int kb = c0 + r; kb < c1; kb += U * rp) {
      uint4 cur[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        cur[u] = nxt[u];
        const int k = kb + (U + u) * rp;
        nxt[u] = k < c1 ? load_w<T, VEC>(w, (long long)k * a.N + n, valid)
                        : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int k = kb + u * rp;
        if (k < c1) {
          const T* e = reinterpret_cast<const T*>(&cur[u]);
          const float* xk = buf + (k - c0) * MM;
#pragma unroll
          for (int m = 0; m < MM; ++m) {
            const float xv = xk[m];
#pragma unroll
            for (int i = 0; i < V; ++i) acc[m][i] = fmaf(xv, to_f32(e[i]), acc[m][i]);
          }
        }
      }
    }
    __syncthreads();  // buf is restaged or reused for the warp partials
  }

  // the warp's rows (lanes cv, cv + bc, ...) meet in an xor butterfly, all
  // of a thread's sums at each step, so their shuffles overlap
  for (int o = bc; o < 32; o <<= 1) {
#pragma unroll
    for (int m = 0; m < MM; ++m)
#pragma unroll
      for (int i = 0; i < V; ++i) acc[m][i] += __shfl_xor_sync(0xffffffffu, acc[m][i], o);
  }
  if (lane < bc) {
#pragma unroll
    for (int m = 0; m < MM; ++m)
#pragma unroll
      for (int i = 0; i < V; ++i) buf[(warp * MM + m) * MAX_COLS + cv * V + i] = acc[m][i];
  }
  __syncthreads();
  for (int o = tid; o < a.M * cols; o += SK_THREADS) {
    const int m = o / cols, c = o % cols;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < SK_WARPS; ++q) s += buf[(q * MM + m) * MAX_COLS + c];
    part[o] = s;
  }
  cluster.sync();  // every split's partials are in its block's shared memory
  for (int o = split * SK_THREADS + tid; o < a.M * cols; o += sa.splits * SK_THREADS) {
    const int m = o / cols, nc = slice * cols + o % cols;
    if (nc >= a.N) continue;
    float p[SK_MAX_SPLITS];  // every split's partial in flight at once
#pragma unroll
    for (int q = 0; q < SK_MAX_SPLITS; ++q)
      p[q] = q < sa.splits ? cluster.map_shared_rank(part, q)[o] : 0.f;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < SK_MAX_SPLITS; ++q)
      if (q < sa.splits) s += p[q];
    static_cast<T*>(a.out)[(long long)m * a.N + nc] = from_f32<T>(epilogue(a, nc, s));
  }
  cluster.sync();  // no block leaves while another reads its partials
}

template <typename T, int MM, bool VEC>
int launch_skinny(const SkinnyArgs& sa, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((sa.a.N + sa.cols - 1) / sa.cols * sa.splits));
  cfg.blockDim = dim3(SK_THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sa.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaLaunchKernelEx(&cfg, linear_skinny<T, MM, VEC>, sa);
  return (int)cudaGetLastError();
}

template <typename T, bool VEC>
int launch_skinny_m(const SkinnyArgs& sa, cudaStream_t stream) {
  if (sa.a.M <= 2) return launch_skinny<T, 2, VEC>(sa, stream);
  if (sa.a.M <= 4) return launch_skinny<T, 4, VEC>(sa, stream);
  if (sa.a.M <= 8) return launch_skinny<T, 8, VEC>(sa, stream);
  return launch_skinny<T, 16, VEC>(sa, stream);
}

template <typename T>
int launch_skinny_t(const SkinnyArgs& sa, cudaStream_t stream) {
  const bool vec = reinterpret_cast<uintptr_t>(sa.a.w) % 16 == 0 &&
                   ((long long)sa.a.N * sizeof(T)) % 16 == 0;
  return vec ? launch_skinny_m<T, true>(sa, stream) : launch_skinny_m<T, false>(sa, stream);
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

// The bf16 WMMA kernel: x (M, K), w (K, N), out (M, N) contiguous bf16 (dtype
// 1; any alignment); bias (N,) of bias_dtype (0 = f32, 1 = bf16) or null.
// act: 0 none, 1 SiLU, 2 GELU. variant: 1 (the WMMA kernel; the only one).
// Returns a cudaError_t (0 on success).
extern "C" int st_linear(const void* x, const void* w, const void* bias, int bias_dtype,
                         void* out, int M, int N, int K, int act, int dtype, int variant,
                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const LinearArgs a{x, w, bias, out, M, N, K, act, bias_dtype};
  if (act < 0 || act > 2 || M <= 0 || N <= 0 || K < 0 || bias_dtype < 0 || bias_dtype > 1 ||
      variant != 1 || dtype != 1)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + WBM - 1) / WBM, (N + WBN - 1) / WBN);
  linear_wmma_bf16<<<grid, WTHREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The skinny kernel's integer arguments, one struct: a launch's signature
// fixes them, so the wrapper keeps one per signature and the call passes
// six pointers (ctypes converts each argument on every call)
struct SkinnyDims {
  int M, N, K, act, dtype, bias_dtype, cols, splits, rows;
};

// The skinny kernel, M <= 16: x (M, K), w (K, N), out (M, N) contiguous, of
// one dtype (0 = f32, 1 = bf16; any alignment: 16-byte vector loads of w
// where its base is aligned and N * sizeof a multiple of 16, element loads
// otherwise); bias (N,) of bias_dtype or null; act as st_linear. The launch
// from the wrapper's planner: blocks of `cols` columns (8, 4 or 2 vectors of
// 16 bytes) over `rows` rows of K, `splits` of them (a cluster) covering K.
// Returns a cudaError_t (0 on success).
extern "C" int st_linear_skinny(const void* x, const void* w, const void* bias, void* out,
                                void* stream_ptr, const SkinnyDims* d) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!d) return (int)cudaErrorInvalidValue;
  const int M = d->M, N = d->N, K = d->K, act = d->act, dtype = d->dtype;
  const int bias_dtype = d->bias_dtype, cols = d->cols, splits = d->splits, rows = d->rows;
  const int v = dtype == 1 ? 8 : 4;
  const int bc = cols / v;
  if (act < 0 || act > 2 || M <= 0 || M > SKINNY_MAX_M || N <= 0 || K < 0 || bias_dtype < 0 ||
      bias_dtype > 1 || (dtype != 0 && dtype != 1) || cols != bc * v ||
      (bc != 8 && bc != 4 && bc != 2) || splits < 1 || splits > SK_MAX_SPLITS || rows < 1 ||
      (long long)splits * rows < K || (long long)(splits - 1) * rows >= (K > 0 ? K : 1) ||
      (long long)(N + cols - 1) / cols * splits > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const SkinnyArgs sa{{x, w, bias, out, M, N, K, act, bias_dtype}, cols, splits, rows};
  return dtype == 1 ? launch_skinny_t<__nv_bfloat16>(sa, stream)
                    : launch_skinny_t<float>(sa, stream);
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
