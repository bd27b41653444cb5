// Non-causal multi-head attention over channel-packed operands, for Hopper
// (sm_90a). Computes the function of five Pallas TPU kernels of
// stabletriton_tpu/kernels/flash_attention.py:
//   _packed_single_kv_kernel (K1, whole KV in one block, heads packed),
//   _packed_flash_kernel     (K2, KV blocked, heads packed),
//   _flash_kernel            (K3, head-major, KV blocked),
//   _single_kv_kernel_bh     (K4, head-major, whole KV in one block),
//   _single_kv_kernel        (K5, all heads, tiny KV of at most 128 keys).
// JAX splits K1-K4 by VMEM and lane packing; on Hopper one templated kernel
// (attn_wgmma_bf16<D>) computes all four in bf16. The routing rule that names
// each launch's class lives in kernels/flash_attention.py.
//
// Numerics follow the JAX kernels: q is multiplied by scale*log2(e) (the
// caller passes it already rounded to the operand dtype) and rounded to the
// operand dtype, as JAX's `q * asarray(scale * LOG2E, q.dtype)`; the
// shift-free base-2 softmax p = exp2(min(s, 80)) (no running max, so no
// rescale of the accumulator between KV tiles); padded keys give p = 0
// (exp2(-1e30) == 0); f32 row sum l of the unrounded p, f32 accumulator of
// bf16(p) . v; output acc / max(l, 1e-30), rounded once.
//
// Operands are addressed by (base, batch stride, row stride, column offset),
// so q, k and v may be column slices of one fused (B, S, 3C) QKV buffer or
// of a fused (B, Sk, 2C) KV buffer: no split copies are made.
//
// Three kernels:
//   attn_wgmma_bf16<D>   - bf16, D in {40, 64, 80, 160}: TMA + wgmma, a loop
//                          over KV tiles of 64 keys. K1-K4.
//   attn_tiny_kv_bf16<D> - bf16, the same D, Sk <= 128: the head's whole K and
//                          V staged once, one score pass, no KV loop. K5.
//   gemm_wgmma_tf32x3<MODE> - f32, D in {64, 512} (the VAE's mid-block, h=1,
//                          d=512): attention as two launches of one 3xTF32
//                          GEMM a chunk of query rows, S = Q K^T with the
//                          softmax numerator in its epilogue, then O = P V
//                          divided by the row sums. K3 in f32. The GEMM is
//                          in tf32_gemm.cuh, shared with the f32 linear.
//
// What bounds them on the H100. Attention does 4*D FLOPs per score element
// against one exp2 on the SFU (16 a clock an SM against ~4,000 bf16 FLOPs
// on the tensor cores), so at D = 64 the exponentials take as long as both
// products; the score matrix never reaches device memory. The operations
// bound of chip_smoke.py counts only the products, at the bf16 tensor-core
// peak.
//
// attn_wgmma_bf16<D>: a block is 128 query rows of one (batch, head): two
// consumer warpgroups of 64 rows and one producer warp (288 threads). The
// producer loads the block's Q tile once and then keeps K and V tiles of 64
// keys in flight through a ring of 2-4 stages (TMA, 128-byte swizzle, full /
// empty mbarrier pairs; the ring depth shrinks as D grows so Q and the ring
// fit in shared memory). Each consumer warpgroup computes its 64 x 64 score
// tile S = Q K^T with wgmma into registers (Q and K both K-major in shared
// memory: a K row is head-dim contiguous), takes p = exp2(min(s, 80)) on the
// accumulator fragments, masks keys at or past Sk by index (TMA's zero fill
// past Sk would give s = 0, p = 1), sums the unrounded p per row in
// registers, rounds p to bf16 in registers and feeds it as the register-A
// operand of O += P V (V MN-major through the transpose flag): no score or P
// tile goes through shared memory. The shift-free softmax needs no running
// max and no rescale, so O and the row sums accumulate across KV tiles; the
// row sums are reduced over the quad of lanes sharing a row once, at the end.
// At D <= 64 a block takes 96 registers a thread and 80 KB, so two blocks
// fit an SM and four consumer warpgroups can interleave their exponentials
// and products. (A second score buffer, to compute the next tile's S under
// this tile's exponentials, took 156 registers, left one block an SM and
// measured slower.)
//
// Head dims. Q, K and V are read as boxes of 64 columns (one 128-byte
// swizzle row): NB = ceil(D / 64) boxes at the head's first column, so a box
// also holds the next head's columns (or, past the operand's last column,
// TMA's zeros). Q's columns at or past D are zeroed when Q is prescaled in
// shared memory, so S = Q K^T sums over ceil(D / 16) k16 steps and the
// extra K columns add exactly 0; O's columns at or past D are computed and
// never stored. Padding cost: S over 48 columns at D = 40 (20%), none at 64,
// 80 and 160; O over 64 NB columns, 60% at D = 40 and 80, 20% at 160.
// Shared memory: Q 16 KB and a stage (K + V) 16 KB per box; 4 / 3 / 2
// stages at NB = 1 / 2 / 3 (80 / 128 / 144 KB). Registers: O takes 32 NB
// f32 a thread (96 at D = 160) beside the 32 of S and 16 of P.
//
// q's prescale: Q arrives by TMA as it lies and each consumer warpgroup
// multiplies its 64 rows by qscale in place, rounding to bf16 (JAX's
// q * asarray(scale * LOG2E, q.dtype)), before its first wgmma.
//
// attn_tiny_kv_bf16<D> (WMMA 16x16x16 tiles, 4 warps of 16 query rows)
// stages the head dim padded to a multiple of 16 with zero columns (20% at
// D = 40). At Sk = 77 it reads q once and writes the output once (5.2 MB
// each at B = 2, Sq = 4096, C = 320); its products are small and the bound
// is the per-block fixed work (staging a head's K and V, the softmax pass),
// which it keeps to one pass over the key fragments up to the last real key
// (5 of the 8 fragments of its 128-row K buffer at Sk = 77). At D = 160 its
// shared memory (159 KB) leaves one block per SM.
//
// gemm_wgmma_tf32x3<MODE> (tf32_gemm.cuh). At d = 512 the two products are 4 Sq Sk D = 550
// GFLOP at S = 16384, and f32 accuracy is kept (one tf32 product alone is
// ~1e-3 off) by 3xTF32, the scheme of the f32 conv (conv3x3.cu
// conv_wgmma_tf32x3): A split into big / small in registers, B's big and
// small parts from shared memory, a_small b_big + a_big b_small + a_big
// b_big on the tensor cores, each stage's sum carried into the running sum
// in f32 adds (wgmma.cuh tf32x3_stage). Bound: 3 x 550 GFLOP at the tf32
// peak, 3.3 ms; the f32 FMA peak would give 8.2 ms. A fused flash kernel
// does not fit at d = 512: a 64-row Q tile in big and small tf32 is 256 KB,
// over the 227 KB of shared memory a block may use. So the score matrix
// goes through device memory in f32, a chunk of query rows at a time (P
// at most 256 MiB; the wrapper picks the rows), ~0.6 ms of writes and reads
// at 16384^2:
//   MODE 0: S = (Q qscale) K^T, a 128 x 128 tile a block (A = Q read in
//           place, scaled in registers as JAX's q * f32(scale log2e), one
//           rounding; B = K as it lies, keys x d, K-major, split by the
//           wrapper); the epilogue writes p = exp2(min(s, 80)), 0 for keys
//           at or past Sk (TMA's zero rows give s = 0), and the tile's row
//           sums of p, one f32 partial a 128-key tile (no atomics: a run
//           repeats bit for bit).
//   MODE 1: O = P V (A = P, K-major; B = V^T, d x keys, key-contiguous,
//           transposed and split by the wrapper: tf32 wgmma has no
//           transpose); the epilogue sums the row's partials in a fixed
//           order and stores acc / max(l, 1e-30).
// A block is 128 rows x 128 columns over k steps of 32 f32 (one 128-byte
// swizzle row): a 4-stage TMA ring of 48 KB stages (A, B big, B small), one
// producer warp, two consumer warpgroups of 64 rows; one block an SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "tf32_gemm.cuh"
#include "wgmma.cuh"

using namespace nvcuda;

namespace {

struct Operand {
  const void* ptr;
  long long batch_stride;  // elements
  long long row_stride;    // elements
  long long col_offset;    // elements
};

// ---------------------------------------------------------------------------
// bf16 WMMA kernel (K5): 4 warps, BQ=64 query rows (16 per warp). A warp owns
// its 16 rows through the whole kernel: scores, softmax, PV and the output.
// The PV accumulator fragments stay in registers (D/16 fragments: 10 at
// D=160, 80 registers a thread). The head dim is staged padded to DP =
// round_up(D, 16).
// ---------------------------------------------------------------------------
constexpr int WBQ = 64;
constexpr int WTHREADS = 128;
constexpr int TINY_BK = 128;   // the tiny-KV kernel's whole key buffer (K5)

using AccFrag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int D>
struct Head {
  static constexpr int DP = (D + 15) / 16 * 16;  // padded head dim
  static constexpr int LDH = DP + 8;              // bf16 operand row pitch
  static constexpr int NF = DP / 16;              // 16-wide fragments across D
};

// shared memory: Q [WBQ][LDH], K and V [BK][LDH], P bf16 [WBQ][BK+8],
// S f32 [WBQ][BK+4] (pitches multiples of 8 bf16 / 4 f32, as WMMA needs)
template <int D, int BK>
constexpr size_t wmma_smem_bytes() {
  return sizeof(__nv_bfloat16) * ((WBQ + 2 * BK) * Head<D>::LDH + WBQ * (BK + 8))
       + sizeof(float) * WBQ * (BK + 4);
}

// Rows [row0, row0 + nrows) of one head's D columns -> dst[r][0, DP), 16-byte
// loads; rows at or past `limit` and the pad columns [D, DP) are zero. With
// SCALE each value is multiplied by qscale and rounded to bf16.
template <int D, bool SCALE>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long row_stride, int row0, int nrows,
                                          int limit, float qscale, int tid) {
  constexpr int CH = Head<D>::DP / 8;
  for (int idx = tid; idx < nrows * CH; idx += WTHREADS) {
    int r = idx / CH, c = (idx % CH) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (c < D && row0 + r < limit) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * row_stride + c);
      if (SCALE) {
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float2 f = __bfloat1622float2(h2[i]);
          h2[i] = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * Head<D>::LDH + c) = val;
  }
}

// dst (16 rows x 16 keys, f32, row-major, pitch lds) = Qw (16 x DP) . Kn^T,
// Kn the 16 key rows of this fragment
template <int D>
__device__ __forceinline__ void score_fragment(float* dst, int lds, const __nv_bfloat16* Qw,
                                               const __nv_bfloat16* Kn) {
  constexpr int LDH = Head<D>::LDH;
  AccFrag sacc;
  wmma::fill_fragment(sacc, 0.f);
#pragma unroll
  for (int kk = 0; kk < Head<D>::NF; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bk;
    wmma::load_matrix_sync(a, Qw + kk * 16, LDH);
    wmma::load_matrix_sync(bk, Kn + kk * 16, LDH);
    wmma::mma_sync(sacc, a, bk, sacc);
  }
  wmma::store_matrix_sync(dst, sacc, lds, wmma::mem_row_major);
}

// p = exp2(min(s, 80)) over columns [col0, col0 + ncols) of one row; columns at
// or past `valid` are padded keys (p = 0). Writes bf16(p); returns the f32 sum.
__device__ __forceinline__ float softmax_cols(const float* Srow, __nv_bfloat16* Prow,
                                              int col0, int ncols, int valid) {
  float l = 0.f;
#pragma unroll 8
  for (int c = col0; c < col0 + ncols; ++c) {
    float p = c < valid ? exp2f(fminf(Srow[c], kClip)) : 0.f;
    l += p;
    Prow[c] = __float2bfloat16(p);
  }
  return l;
}

// oacc += Pw (16 x 16*nkf) . V (16*nkf x DP)
template <int D>
__device__ __forceinline__ void pv_accumulate(AccFrag (&oacc)[Head<D>::NF],
                                              const __nv_bfloat16* Pw, int ldp,
                                              const __nv_bfloat16* Vs, int nkf) {
  constexpr int LDH = Head<D>::LDH;
  for (int kk = 0; kk < nkf; ++kk) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
    wmma::load_matrix_sync(a, Pw + kk * 16, ldp);
#pragma unroll
    for (int n = 0; n < Head<D>::NF; ++n) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bv;
      wmma::load_matrix_sync(bv, Vs + kk * 16 * LDH + n * 16, LDH);
      wmma::mma_sync(oacc[n], a, bv, oacc[n]);
    }
  }
}

// The warp's 16 output rows: acc / max(l, 1e-30), one bf16 rounding. Each
// fragment passes through the warp's 16x16 f32 scratch Sw; lane (r, half)
// stores 8 columns of row r = lane/2 as one 16-byte store. Columns at or past
// D (the zero pad) are not stored; orow is null for a row past Sq.
template <int D>
__device__ __forceinline__ void store_output(AccFrag (&oacc)[Head<D>::NF], float* Sw, int lds,
                                             float l, __nv_bfloat16* orow, int lane) {
  const float lc = fmaxf(l, 1e-30f);
  const int half = (lane % 2) * 8;
  const float* src = Sw + (lane / 2) * lds + half;
#pragma unroll
  for (int n = 0; n < Head<D>::NF; ++n) {
    __syncwarp();
    wmma::store_matrix_sync(Sw, oacc[n], lds, wmma::mem_row_major);
    __syncwarp();
    const int col = n * 16 + half;
    if (orow != nullptr && col < D) {
      uint4 val;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        h2[i] = __floats2bfloat162_rn(src[2 * i] / lc, src[2 * i + 1] / lc);
      *reinterpret_cast<uint4*>(orow + col) = val;
    }
  }
}

// per-block operand pointers of head blockIdx.y, batch blockIdx.z
__device__ __forceinline__ const __nv_bfloat16* head_ptr(const Operand& o, int D) {
  return static_cast<const __nv_bfloat16*>(o.ptr) + blockIdx.z * o.batch_stride + o.col_offset
       + blockIdx.y * D;
}

__device__ __forceinline__ __nv_bfloat16* out_row(__nv_bfloat16* out, int Sq, int H, int D,
                                                  int qi) {
  return qi < Sq ? out + ((long long)blockIdx.z * Sq + qi) * (H * D) + blockIdx.y * D
                 : nullptr;
}

// ---------------------------------------------------------------------------
// attn_wgmma_bf16<D> (K1-K4): see the note at the top
// ---------------------------------------------------------------------------
constexpr int GBQ = 128;  // query rows a block: two consumer warpgroups of 64
constexpr int GBK = 64;   // keys a KV tile

template <int D>
struct Tiles {
  static constexpr int NB = (D + 63) / 64;   // 64-column boxes across the head
  static constexpr int KS = (D + 15) / 16;   // k16 steps of S = Q K^T
  static constexpr int STAGES = NB == 1 ? 4 : NB == 2 ? 3 : 2;
  static constexpr int Q_BOX = GBQ * 128;    // bytes of a box of the Q tile
  static constexpr int KV_BOX = GBK * 128;   // bytes of a box of a K or V tile
  static constexpr int Q_BYTES = NB * Q_BOX;
  static constexpr int STAGE = 2 * NB * KV_BOX;  // the K boxes, then the V boxes
  // [pad to 1024][Q][STAGES x (K, V)][q_full, full[STAGES], empty[STAGES]]
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE + 8 * (1 + 2 * STAGES);
};

struct WgmmaArgs {
  __nv_bfloat16* out;           // (B, Sq, H * D)
  int Sq, Sk, H;
  int q_col, k_col, v_col;      // the operands' first columns in their buffers
  float qscale;
};

template <int D>
__global__ void __launch_bounds__(wg::THREADS, 1)
    attn_wgmma_bf16(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv, WgmmaArgs a) {
  using T = Tiles<D>;
  extern __shared__ __align__(16) uint8_t gsmem[];
  const uint32_t base = wg::smem_u32(gsmem);
  const uint32_t qt = (base + 1023u) & ~1023u;
  const uint32_t ring = qt + T::Q_BYTES;
  const uint32_t q_full = ring + T::STAGES * T::STAGE;
  auto full = [&](int s) { return q_full + 8 * (1 + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + T::STAGES + s); };
  if (threadIdx.x == 0) {
    wg::bar_init(q_full, 1);
    for (int s = 0; s < T::STAGES; ++s) {
      wg::bar_init(full(s), 1);
      wg::bar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int q0 = blockIdx.x * GBQ, h = blockIdx.y, b = blockIdx.z;
  const int nt = (a.Sk + GBK - 1) / GBK;
  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    if (threadIdx.x == 256) {
      wg::bar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int j = 0; j < T::NB; ++j)
        wg::tma_load_3d(qt + j * T::Q_BOX, &tq, q_full, a.q_col + h * D + 64 * j, q0, b);
      for (int it = 0; it < nt; ++it) {
        const int s = it % T::STAGES;
        const uint32_t kt = ring + s * T::STAGE;
        wg::bar_wait(empty(s), ((it / T::STAGES) & 1) ^ 1);
        wg::bar_expect_tx(full(s), T::STAGE);
#pragma unroll
        for (int j = 0; j < T::NB; ++j) {
          wg::tma_load_3d(kt + j * T::KV_BOX, &tk, full(s), a.k_col + h * D + 64 * j, it * GBK, b);
          wg::tma_load_3d(kt + (T::NB + j) * T::KV_BOX, &tv, full(s), a.v_col + h * D + 64 * j,
                          it * GBK, b);
        }
      }
    }
    return;
  }

  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  // Q: this warpgroup's 64 rows times qscale, rounded to bf16, in place;
  // columns at or past D zeroed. Piece i is 16 bytes: box i / 512, row
  // (i / 8) % 64 of the warpgroup, physical chunk i % 8 (the 128-byte
  // swizzle puts logical chunk c of row r at c ^ (r % 8)).
  wg::bar_wait(q_full, 0);
  for (int i = t; i < T::NB * 64 * 8; i += 128) {
    const int j = i / 512, row = wgi * 64 + (i / 8) % 64, pc = i % 8;
    const int col = 64 * j + 8 * (pc ^ (row & 7));
    uint4* piece =
        reinterpret_cast<uint4*>(gsmem + (qt - base) + j * T::Q_BOX + row * 128 + pc * 16);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (col < D) {
      v = *piece;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        h2[e] = __floats2bfloat162_rn(f.x * a.qscale, f.y * a.qscale);
      }
    }
    *piece = v;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wgi) : "memory");

  // accumulator i of an m64nN tile lies at row 16 warp + g + 8 ((i >> 1) & 1)
  // and column 8 (i >> 2) + 2 c + (i & 1), g = lane / 4, c = lane % 4
  float sacc[32], oacc[T::NB][32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
#pragma unroll
  for (int n = 0; n < T::NB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[n][i] = 0.f;
  float lsum[2] = {0.f, 0.f};  // rows g and g + 8: this thread's share
  const uint32_t qw = qt + wgi * 64 * 128;
  for (int it = 0; it < nt; ++it) {
    const int s = it % T::STAGES;
    const uint32_t kt = ring + s * T::STAGE, vt = kt + T::NB * T::KV_BOX;
    wg::bar_wait(full(s), (it / T::STAGES) & 1);
    wg::fence_acc(sacc);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < T::KS; ++kk)
      wg::wgmma_ss_n64(sacc,
                       wg::desc_sw128(qw + (kk / 4) * T::Q_BOX + (kk % 4) * 32, 16, wg::SW_ROWS8),
                       wg::desc_sw128(kt + (kk / 4) * T::KV_BOX + (kk % 4) * 32, 16, wg::SW_ROWS8),
                       kk);
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
    wg::fence_acc(sacc);

    // p = exp2(min(s, 80)), 0 for keys at or past Sk; P's register-A
    // fragments (k16 step kk: rows g / g + 8, keys 16 kk + 2c (+8)) are the
    // score accumulators 8 kk .. 8 kk + 7 in order, rounded to bf16 pairs
    const int key0 = it * GBK + 2 * (lane % 4);
    const bool ragged = (it + 1) * GBK > a.Sk;
    uint32_t pf[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r, key = key0 + 8 * (i >> 2);
        float p0 = exp2f(fminf(sacc[i], kClip)), p1 = exp2f(fminf(sacc[i + 1], kClip));
        if (ragged) {
          p0 = key < a.Sk ? p0 : 0.f;
          p1 = key + 1 < a.Sk ? p1 : 0.f;
        }
        lsum[r & 1] += p0 + p1;
        __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
        pf[kk][r] = *reinterpret_cast<uint32_t*>(&pb);
      }

    wg::fence_frag(pf);
#pragma unroll
    for (int n = 0; n < T::NB; ++n) wg::fence_acc(oacc[n]);
    wg::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int n = 0; n < T::NB; ++n)
        wg::wgmma_rs_n64(oacc[n], pf[kk],
                         wg::desc_sw128(vt + n * T::KV_BOX + kk * 16 * 128, T::KV_BOX,
                                        wg::SW_ROWS8));
    wg::wgmma_commit();
    wg::wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < T::NB; ++n) wg::fence_acc(oacc[n]);
    wg::fence_frag(pf);
    if (t == 0) wg::bar_arrive(empty(s));
  }

  // row sums over the quad; out = O / max(l, 1e-30), one rounding, 16-byte
  // stores of 8 columns after a transpose across the quad
  float lc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = lsum[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    lc[r] = fmaxf(l, 1e-30f);
  }
  const int C = a.H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wgi * 64 + warp * 16 + lane / 4 + 8 * r;
#pragma unroll
    for (int n = 0; n < T::NB; ++n)
#pragma unroll
      for (int g4 = 0; g4 < 2; ++g4) {
        float2 p[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int i = (4 * g4 + jj) * 4 + 2 * r;
          p[jj] = make_float2(oacc[n][i], oacc[n][i + 1]);
        }
        float o[8];
        wg::quad_transpose(p, o);
        const int col = 64 * n + 32 * g4 + 8 * (lane % 4);
        if (qi >= a.Sq || col >= D) continue;
        uint4 val;
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          h2[e] = __floats2bfloat162_rn(o[2 * e] / lc[r], o[2 * e + 1] / lc[r]);
        *reinterpret_cast<uint4*>(a.out + ((long long)b * a.Sq + qi) * C + h * D + col) = val;
      }
  }
}

// K5: Sk <= TINY_BK. The head's whole K and V are staged once, in 16-row
// fragments up to the last real key; one score pass over them, no KV loop.
template <int D>
__global__ void __launch_bounds__(WTHREADS)
attn_tiny_kv_bf16(Operand q, Operand k, Operand v, __nv_bfloat16* __restrict__ out,
                  int Sq, int Sk, int H, float qscale) {
  constexpr int BK = TINY_BK, LDH = Head<D>::LDH, LDP = BK + 8, LDS = BK + 4;
  extern __shared__ __align__(128) unsigned char wsmem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(wsmem);
  __nv_bfloat16* Ks = Qs + WBQ * LDH;
  __nv_bfloat16* Vs = Ks + BK * LDH;
  __nv_bfloat16* Ps = Vs + BK * LDH;
  float* Ss = reinterpret_cast<float*>(Ps + WBQ * LDP);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * WBQ;
  const int nkf = (Sk + 15) / 16;  // key fragments holding real keys
  load_rows<D, true>(Qs, head_ptr(q, D), q.row_stride, q0, WBQ, Sq, qscale, tid);
  load_rows<D, false>(Ks, head_ptr(k, D), k.row_stride, 0, nkf * 16, Sk, 0.f, tid);
  load_rows<D, false>(Vs, head_ptr(v, D), v.row_stride, 0, nkf * 16, Sk, 0.f, tid);
  __syncthreads();

  const __nv_bfloat16* Qw = Qs + warp * 16 * LDH;
  __nv_bfloat16* Pw = Ps + warp * 16 * LDP;
  float* Sw = Ss + warp * 16 * LDS;
  for (int n = 0; n < nkf; ++n) score_fragment<D>(Sw + n * 16, LDS, Qw, Ks + n * 16 * LDH);
  __syncwarp();
  // lane -> row lane/2, half of the nkf*16 staged key columns
  const int prow = lane / 2;
  float l = softmax_cols(Sw + prow * LDS, Pw + prow * LDP, (lane % 2) * nkf * 8, nkf * 8, Sk);
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  __syncwarp();

  AccFrag oacc[Head<D>::NF];
#pragma unroll
  for (int n = 0; n < Head<D>::NF; ++n) wmma::fill_fragment(oacc[n], 0.f);
  pv_accumulate<D>(oacc, Pw, LDP, Vs, nkf);
  store_output<D>(oacc, Sw, LDS, l, out_row(out, Sq, H, D, q0 + warp * 16 + prow), lane);
}

template <int D>
cudaError_t launch_tiny(Operand q, Operand k, Operand v, void* out, int B, int Sq, int Sk, int H,
                        float qscale, cudaStream_t stream) {
  const size_t smem = wmma_smem_bytes<D, TINY_BK>();
  cudaError_t err = cudaFuncSetAttribute(attn_tiny_kv_bf16<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + WBQ - 1) / WBQ, H, B);
  attn_tiny_kv_bf16<D><<<grid, WTHREADS, smem, stream>>>(
      q, k, v, static_cast<__nv_bfloat16*>(out), Sq, Sk, H, qscale);
  return cudaGetLastError();
}

// the tensor map of one operand: its buffer's rows (B, S, ..) up to the
// operand's last column, boxes of 64 columns x `rows` rows of one batch.
// Columns before the operand's first are never addressed.
bool operand_map(CUtensorMap* map, const Operand& o, int S, int B, int last_col, int rows) {
  const uint64_t dims[3] = {(uint64_t)last_col, (uint64_t)S, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)o.row_stride * 2, (uint64_t)o.batch_stride * 2};
  const uint32_t box[3] = {64, (uint32_t)rows, 1};
  return wg::make_map(map, o.ptr, 3, dims, strides, box);
}

template <int D>
cudaError_t launch_wgmma(Operand q, Operand k, Operand v, void* out, int B, int Sq, int Sk, int H,
                         float qscale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const int C = H * D;
  if (!operand_map(&tq, q, Sq, B, (int)q.col_offset + C, GBQ) ||
      !operand_map(&tk, k, Sk, B, (int)k.col_offset + C, GBK) ||
      !operand_map(&tv, v, Sk, B, (int)v.col_offset + C, GBK))
    return cudaErrorInvalidValue;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        attn_wgmma_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tiles<D>::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const WgmmaArgs a{static_cast<__nv_bfloat16*>(out), Sq, Sk, H, (int)q.col_offset,
                    (int)k.col_offset, (int)v.col_offset, qscale};
  dim3 grid((Sq + GBQ - 1) / GBQ, H, B);
  attn_wgmma_bf16<D><<<grid, wg::THREADS, Tiles<D>::SMEM, stream>>>(tq, tk, tv, a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(bool tiny_kv, Operand q, Operand k, Operand v, void* out, int B, int Sq,
                        int Sk, int H, float qscale, cudaStream_t stream) {
  return tiny_kv ? launch_tiny<D>(q, k, v, out, B, Sq, Sk, H, qscale, stream)
                 : launch_wgmma<D>(q, k, v, out, B, Sq, Sk, H, qscale, stream);
}

bool aligned16(const Operand& o) {
  // 16-byte vector loads of bf16 rows: base, strides and offset in 8-element units
  return (reinterpret_cast<uintptr_t>(o.ptr) % 16 == 0) && (o.row_stride % 8 == 0) &&
         (o.batch_stride % 8 == 0) && (o.col_offset % 8 == 0);
}

}  // namespace

// kernel: 1 = attn_wgmma_bf16, 2 = attn_tiny_kv_bf16 (bfloat16 operands).
// qscale = scale*log2(e), rounded to bfloat16. Returns a cudaError_t (0 on
// success), or -1 when the kernel has no instance for this head dim, key
// count or operand alignment (nothing is launched).
extern "C" int st_flash_attention(
    const void* q, long long q_sb, long long q_ss, long long q_off,
    const void* k, long long k_sb, long long k_ss, long long k_off,
    const void* v, long long v_sb, long long v_ss, long long v_off,
    void* out, int B, int Sq, int Sk, int H, int D, int kernel, float qscale,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Operand oq{q, q_sb, q_ss, q_off}, ok{k, k_sb, k_ss, k_off}, ov{v, v_sb, v_ss, v_off};
  if ((kernel != 1 && kernel != 2) || !(aligned16(oq) && aligned16(ok) && aligned16(ov)))
    return -1;
  const bool tiny_kv = kernel == 2;
  if (tiny_kv && Sk > TINY_BK) return -1;
  switch (D) {
    case 40: return (int)launch_bf16<40>(tiny_kv, oq, ok, ov, out, B, Sq, Sk, H, qscale, stream);
    case 64: return (int)launch_bf16<64>(tiny_kv, oq, ok, ov, out, B, Sq, Sk, H, qscale, stream);
    case 80: return (int)launch_bf16<80>(tiny_kv, oq, ok, ov, out, B, Sq, Sk, H, qscale, stream);
    case 160: return (int)launch_bf16<160>(tiny_kv, oq, ok, ov, out, B, Sq, Sk, H, qscale,
                                           stream);
    default: return -1;
  }
}

// f32 attention (K3) on gemm_wgmma_tf32x3: q read in place as (base, batch
// stride, row stride, column offset) in elements (base 16-byte aligned,
// strides multiples of 4); k_big / k_small the (B*H, Sk, D) parts of K and
// vt_big / vt_small the (B*H, D, keys) parts of V^T, keys = Sk rounded up
// to 128 with zero columns (kernels/flash_attention.py
// tf32_attention_operands); p (B*H, rows, keys) and l (B*H, rows, keys /
// 128) f32 workspaces; out (B, Sq, H*D) f32. Query rows go in chunks of
// `rows` (a multiple of 128), two launches each. qscale = f32(scale *
// log2(e)). Returns a cudaError_t (0 on success).
extern "C" int st_attention_tf32x3(const float* q, long long q_sb, long long q_ss, long long q_off,
                                   const float* k_big, const float* k_small, const float* vt_big,
                                   const float* vt_small, float* p, float* l, float* out, int B,
                                   int Sq, int Sk, int H, int D, int rows, float qscale,
                                   void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int keys = (Sk + 127) / 128 * 128, key_tiles = keys / 128, BH = B * H;
  const auto a16 = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || D <= 0 || D % 32 || rows <= 0 || rows % 128 ||
      BH > 65535 || q_off < 0 || q_ss % 4 || q_sb % 4 || !a16(q) || !a16(k_big) ||
      !a16(k_small) || !a16(vt_big) || !a16(vt_small) || !a16(p) ||
      reinterpret_cast<uintptr_t>(out) % 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tkb, tks, tp, tvb, tvs;
  if (!f32_map(&tq, q, q_off + (long long)H * D, Sq, B, q_ss, q_sb) ||
      !f32_map(&tkb, k_big, D, Sk, BH, D, (uint64_t)Sk * D) ||
      !f32_map(&tks, k_small, D, Sk, BH, D, (uint64_t)Sk * D) ||
      !f32_map(&tp, p, keys, rows, BH, keys, (uint64_t)rows * keys) ||
      !f32_map(&tvb, vt_big, keys, D, BH, keys, (uint64_t)D * keys) ||
      !f32_map(&tvs, vt_small, keys, D, BH, keys, (uint64_t)D * keys))
    return (int)cudaErrorInvalidValue;
  for (int r0 = 0; r0 < Sq; r0 += rows) {
    const int M = Sq - r0 < rows ? Sq - r0 : rows;
    Tf32GemmArgs s{};
    s.M = M, s.N = keys, s.K = D, s.n_tiles = key_tiles;
    s.a_row0 = r0, s.a_col0 = (int)q_off, s.a_heads = H, s.a_head_cols = D, s.a_scale = qscale;
    s.keys = Sk, s.p = p, s.p_ld = keys, s.p_z = (long long)rows * keys;
    s.l = l, s.l_ld = key_tiles, s.l_z = (long long)rows * key_tiles;
    int code = launch_tf32_gemm<0>(tq, tkb, tks, s, BH, stream);
    if (code != 0) return code;
    Tf32GemmArgs o{};
    o.M = M, o.N = D, o.K = keys, o.n_tiles = (D + TG_BN - 1) / TG_BN;
    o.a_row0 = 0, o.a_col0 = 0, o.a_heads = 1, o.a_head_cols = 0, o.a_scale = 1.f;
    o.l = l, o.l_ld = key_tiles, o.l_z = (long long)rows * key_tiles;
    o.out = out, o.out_b = (long long)Sq * H * D, o.out_ld = (long long)H * D;
    o.out_row0 = r0, o.heads = H, o.head_cols = D;
    code = launch_tf32_gemm<1>(tp, tvb, tvs, o, BH, stream);
    if (code != 0) return code;
  }
  return 0;
}
