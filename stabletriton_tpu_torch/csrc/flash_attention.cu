// Non-causal multi-head attention over channel-packed operands, for Hopper
// (sm_90a). Computes the function of five Pallas TPU kernels of
// stabletriton_tpu/kernels/flash_attention.py:
//   _packed_single_kv_kernel (K1, whole KV in one block, heads packed),
//   _packed_flash_kernel     (K2, KV blocked, heads packed),
//   _flash_kernel            (K3, head-major, KV blocked),
//   _single_kv_kernel_bh     (K4, head-major, whole KV in one block),
//   _single_kv_kernel        (K5, all heads, tiny KV of at most 128 keys).
// JAX splits K1-K5 by VMEM, lane packing and key count; on Hopper two
// templated kernels on one set of device steps (prescale_q, score_tile,
// softmax_pv, store_rows) compute all five in bf16. The routing rule that
// names each launch's class lives in kernels/flash_attention.py.
//
// Numerics follow the JAX kernels: q is multiplied by scale*log2(e) (the
// caller passes it already rounded to the operand dtype) and rounded to the
// operand dtype, as JAX's `q * asarray(scale * LOG2E, q.dtype)`; the
// shift-free base-2 softmax p = exp2(min(s, 80)) (no running max, so no
// rescale of the accumulator between KV tiles); padded keys give p = 0;
// f32 row sum l of the unrounded p, f32 accumulator of bf16(p) . v; output
// the correctly rounded f32 quotient acc / max(l, 1e-30), rounded once to
// the operand dtype, as JAX's o / l.clip(1e-30).
//
// Operands are addressed by (base, batch stride, row stride, column offset),
// so q, k and v may be column slices of one fused (B, S, 3C) QKV buffer or
// of a fused (B, Sk, 2C) KV buffer: no split copies are made.
//
// Three kernels:
//   attn_wgmma_bf16<D>   - bf16, D in {40, 64, 80, 160}: TMA + wgmma, a block
//                          a 128-row query tile, a loop over KV tiles of 64
//                          keys. K1-K4.
//   attn_tinykv_wgmma_bf16<D> - the same D, Sk <= 128: the head's whole K
//                          and V resident (one TMA load), a block walking
//                          several query tiles. K5.
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
// bound of kernel_table.py counts only the products, at the bf16 tensor-core
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
// tile goes through shared memory. The shift-free
// softmax needs no running max and no rescale, so O and the row sums
// accumulate across KV tiles; the row sums are reduced over the quad of
// lanes sharing a row once, at the end. At D <= 64 a block takes 96
// registers a thread and 80 KB, so two blocks fit an SM and four consumer
// warpgroups can interleave their exponentials and products. (A second
// score buffer, to compute the next tile's S under this tile's
// exponentials, took 156 registers, left one block an SM and measured
// slower.)
//
// attn_tinykv_wgmma_bf16<D> (every bf16 launch with Sk <= 128: K5, SD1.5's
// cross-attention against 77 keys and its mid-block self-attention over
// 64, and K1's, SDXL's cross-attention). At Sk = 77 the work of a 128-row
// tile is small (two 64-key score tiles, 5 k16 steps of P V, 80
// exponentials a row), so a block of attn_wgmma_bf16 spends most of its
// life on fixed work: barrier init, the K / V ring's loads and the wait for
// its one Q tile. Here a block takes `tiles` consecutive query tiles of one
// (batch, head) (the wrapper's tiny_kv_plan: enough blocks to fill the SMs,
// two an SM at D <= 64, and at most 64 KB of Q). It has no producer warp
// and no ring: thread 0 issues every load at the start, the head's whole K
// and V (both 64-key halves, or one at Sk <= 64, of NB boxes each) onto one
// barrier and each query tile onto its own, so the later tiles arrive under
// the first one's math. Each consumer warpgroup prescales its rows of a
// tile, runs score_tile and softmax_pv on each resident half (on the last
// half only the k16 steps holding a key below Sk: 1 of 4 at Sk = 77; at D
// <= 64 both halves' score tiles in one wgmma group, the first half's P V
// running under the last half's exponentials) and stores its rows; a
// warpgroup whose 64 rows lie past Sq (the mid block's Sq = 64) stops.
// Without the producer warp a block is 256 threads, so two blocks an SM
// get 128 registers a thread at D <= 64 (with the warp, 96 and spills).
// Shared memory: K and V 8 KB a box and half, Q 16 KB a box and tile: 97 KB
// at most at D <= 64, 129 KB at D = 80, 145 KB at D = 160 (one tile). With
// so little math a tile, the per-tile instructions decide its time: the
// prescale is one bf16x2 multiply a pair and the epilogue one reciprocal a
// row and a Markstein correction an element (div_rn; the f32 division
// itself an element cost the SD1.5 K5 launches 8-30%).
//
// Head dims. Q, K and V are read as boxes of 64 columns (one 128-byte
// swizzle row): NB = ceil(D / 64) boxes at the head's first column, so a box
// also holds the next head's columns (or, past the operand's last column,
// TMA's zeros). Q's columns at or past D are zeroed when Q is prescaled in
// shared memory, so S = Q K^T sums over ceil(D / 16) k16 steps and the
// extra K columns add exactly 0; O's columns at or past D are computed and
// never stored. Padding cost: S over 48 columns at D = 40 (20%), none at 64,
// 80 and 160; O over 64 NB columns, 60% at D = 40 and 80, 20% at 160.
// attn_wgmma_bf16's shared memory: Q 16 KB and a stage (K + V) 16 KB per
// box; 4 / 3 / 2 stages at NB = 1 / 2 / 3 (80 / 128 / 144 KB). Registers: O
// takes 32 NB f32 a thread (96 at D = 160) beside the 32 of S and 16 of P.
//
// q's prescale: Q arrives by TMA as it lies and each consumer warpgroup
// multiplies its 64 rows by qscale in place, rounding to bf16 (JAX's
// q * asarray(scale * LOG2E, q.dtype)), before its first wgmma.
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
#include <stdint.h>

#include "tf32_gemm.cuh"
#include "wgmma.cuh"

namespace {

struct Operand {
  const void* ptr;
  long long batch_stride;  // elements
  long long row_stride;    // elements
  long long col_offset;    // elements
};

// ---------------------------------------------------------------------------
// bf16 attention on TMA + wgmma (K1-K5): the tiles, then the steps a
// consumer warpgroup takes on one 128-row query tile, shared by
// attn_wgmma_bf16 and attn_tinykv_wgmma_bf16
// ---------------------------------------------------------------------------
constexpr int GBQ = 128;  // query rows a tile: two consumer warpgroups of 64
constexpr int GBK = 64;   // keys a KV tile
constexpr int TINY_SK = 2 * GBK;  // keys the tiny-KV kernel holds resident

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
  // the tiny-KV kernel: [pad to 1024][tiles x Q][halves x K][halves x V]
  // [kv_full, q_full[tiles]], a half being the NB boxes of 64 keys
  static constexpr int tiny_smem(int tiles, int halves) {
    return 1024 + tiles * Q_BYTES + 2 * halves * NB * KV_BOX + 8 * (1 + tiles);
  }
};

struct WgmmaArgs {
  __nv_bfloat16* out;           // (B, Sq, H * D)
  int Sq, Sk, H;
  int q_col, k_col, v_col;      // the operands' first columns in their buffers
  float qscale;
  int tiles;                    // 128-row query tiles a block stages (tiny-KV kernel)
};

// Q: this warpgroup's 64 rows of the tile at qt times qscale, rounded to
// bf16, in place; columns at or past D zeroed. Piece i is 16 bytes: box i /
// 512, row (i / 8) % 64 of the warpgroup, physical chunk i % 8 (the 128-byte
// swizzle puts logical chunk c of row r at c ^ (r % 8)). qscale is a bf16
// value, so a bf16x2 multiply (the exact product, rounded once) gives the
// bits of the f32 product rounded to bf16, in one instruction a pair. Ends
// with the warpgroup's 128 threads met (named barrier 2 + wgi), the writes
// visible to wgmma.
template <int D>
__device__ __forceinline__ void prescale_q(uint8_t* qt, int wgi, float qscale) {
  using T = Tiles<D>;
  const int t = threadIdx.x % 128;
  const __nv_bfloat162 s2 = __float2bfloat162_rn(qscale);
  for (int i = t; i < T::NB * 64 * 8; i += 128) {
    const int j = i / 512, row = wgi * 64 + (i / 8) % 64, pc = i % 8;
    const int col = 64 * j + 8 * (pc ^ (row & 7));
    uint4* piece = reinterpret_cast<uint4*>(qt + j * T::Q_BOX + row * 128 + pc * 16);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (col < D) {
      v = *piece;
      __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) h2[e] = __hmul2(h2[e], s2);
    }
    *piece = v;
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wgi) : "memory");
}

// sacc = S = Q K^T of this warpgroup's 64 rows (qw: their first row in the
// Q tile) against the 64 keys of the K boxes at kt (Q and K both K-major:
// a K row is head-dim contiguous); returns when the wgmmas are done.
// Accumulator i of an m64nN tile lies at row 16 warp + g + 8 ((i >> 1) & 1)
// and column 8 (i >> 2) + 2 c + (i & 1), g = lane / 4, c = lane % 4.
template <int D>
__device__ __forceinline__ void score_tile(float (&sacc)[32], uint32_t qw, uint32_t kt) {
  using T = Tiles<D>;
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
}

// p = exp2(min(s, 80)) on the score tile of keys key0 .. key0 + 63, 0 for
// keys at or past Sk (TMA's zero fill past Sk would give s = 0, p = 1);
// the unrounded p summed into lsum (rows g and g + 8: this thread's share)
// and rounded to bf16 pairs as P's register-A fragments: P's fragment of
// k16 step kk (rows g / g + 8, keys 16 kk + 2c (+8)) is the score
// accumulators 8 kk .. 8 kk + 7 in order. Only the first STEPS k16 steps
// are taken (the tiny-KV kernel's last half: those holding a key below
// Sk); a compile-time count, since a branch around the exponentials or the
// wgmmas costs attn_wgmma_bf16 a third of its time (ptxas fences the
// accumulators around a wgmma under a branch, C7519, and the exponentials
// of a k16 step no longer interleave with the next step's).
template <int STEPS>
__device__ __forceinline__ void softmax_frags(const float (&sacc)[32], uint32_t (&pf)[STEPS][4],
                                              float (&lsum)[2], int key0, int Sk) {
  const int lane = threadIdx.x % 32;
  const bool ragged = key0 + 16 * STEPS > Sk;
  const int kq = key0 + 2 * (lane % 4);
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 8 * kk + 2 * r, key = kq + 8 * (i >> 2);
      float p0 = exp2f(fminf(sacc[i], kClip)), p1 = exp2f(fminf(sacc[i + 1], kClip));
      if (ragged) {
        p0 = key < Sk ? p0 : 0.f;
        p1 = key + 1 < Sk ? p1 : 0.f;
      }
      lsum[r & 1] += p0 + p1;
      __nv_bfloat162 pb = __floats2bfloat162_rn(p0, p1);
      pf[kk][r] = *reinterpret_cast<uint32_t*>(&pb);
    }
}

// O += P V over STEPS k16 steps, P from registers, V (the NB boxes at vt)
// MN-major through the transpose flag: the wgmmas issued after a fence of
// the fragments, not committed
template <int D, int STEPS>
__device__ __forceinline__ void issue_pv(uint32_t (&pf)[STEPS][4],
                                         float (&oacc)[Tiles<D>::NB][32], uint32_t vt) {
  using T = Tiles<D>;
  wg::fence_frag(pf);
#pragma unroll
  for (int n = 0; n < T::NB; ++n) wg::fence_acc(oacc[n]);
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk)
#pragma unroll
    for (int n = 0; n < T::NB; ++n)
      wg::wgmma_rs_n64(oacc[n], pf[kk],
                       wg::desc_sw128(vt + n * T::KV_BOX + kk * 16 * 128, T::KV_BOX,
                                      wg::SW_ROWS8));
}

template <int D, int STEPS = 4>
__device__ __forceinline__ void softmax_pv(const float (&sacc)[32],
                                           float (&oacc)[Tiles<D>::NB][32], float (&lsum)[2],
                                           uint32_t vt, int key0, int Sk) {
  uint32_t pf[STEPS][4];
  softmax_frags<STEPS>(sacc, pf, lsum, key0, Sk);
  issue_pv<D, STEPS>(pf, oacc, vt);
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < Tiles<D>::NB; ++n) wg::fence_acc(oacc[n]);
  wg::fence_frag(pf);
}

// The tiny-KV kernel's tile at 64 < Sk <= 128: both halves' score tiles in
// one wgmma group, then the first half's P V in flight under the last
// half's exponentials (two waits a tile, not four). STEPS: the last half's
// k16 steps holding a key below Sk.
template <int D, int STEPS>
__device__ __forceinline__ void two_halves(float (&s0)[32], float (&s1)[32],
                                           float (&oacc)[Tiles<D>::NB][32], float (&lsum)[2],
                                           uint32_t qw, uint32_t kt, uint32_t vt, int Sk) {
  using T = Tiles<D>;
  constexpr int HALF = T::NB * T::KV_BOX;
  wg::fence_acc(s0);
  wg::fence_acc(s1);
  wg::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::KS; ++kk) {
    const uint64_t dq = wg::desc_sw128(qw + (kk / 4) * T::Q_BOX + (kk % 4) * 32, 16, wg::SW_ROWS8);
    const uint32_t ko = (kk / 4) * T::KV_BOX + (kk % 4) * 32;
    wg::wgmma_ss_n64(s0, dq, wg::desc_sw128(kt + ko, 16, wg::SW_ROWS8), kk);
    wg::wgmma_ss_n64(s1, dq, wg::desc_sw128(kt + HALF + ko, 16, wg::SW_ROWS8), kk);
  }
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
  wg::fence_acc(s0);
  wg::fence_acc(s1);
  uint32_t p0[4][4], p1[STEPS][4];
  softmax_frags<4>(s0, p0, lsum, 0, Sk);
  issue_pv<D, 4>(p0, oacc, vt);
  wg::wgmma_commit();
  softmax_frags<STEPS>(s1, p1, lsum, GBK, Sk);
  issue_pv<D, STEPS>(p1, oacc, vt + HALF);
  wg::wgmma_commit();
  wg::wgmma_wait<0>();
#pragma unroll
  for (int n = 0; n < T::NB; ++n) wg::fence_acc(oacc[n]);
  wg::fence_frag(p0);
  wg::fence_frag(p1);
}

// acc / l correctly rounded, as the f32 division of the JAX kernels and of
// attention_plain, from r = 1 / l correctly rounded (one a row): q = acc r
// is within an ulp of the quotient, and one Markstein step, q + (acc - q l)
// r with the remainder exact in an FMA, rounds it correctly (Markstein
// 1990; Muller et al., Handbook of Floating-Point Arithmetic, 4.6) while acc
// and q lie in [2^-100, 2^100], where the remainder neither underflows nor
// overflows. Two FMAs an element beside the reciprocal's product, no
// special-function op and no branch: a division an element, whose IEEE
// sequence branches to a slow path, cost the tiny-KV kernel a fifth.
__device__ __forceinline__ float div_rn(float acc, float l, float r) {
  const float q = __fmul_rn(acc, r);
  return fmaf(fmaf(-q, l, acc), r, q);
}

// a warp's rows stored, out = O / l (l = max(row sum, 1e-30), r = 1 / l):
// MARKSTEIN, div_rn on every output, returning whether each output lies in
// [max(2^-99, 2^-99 r), 2^99], where acc and q = acc / l lie in div_rn's
// range (zeros, NaN, infinite, subnormal and huge sums fall outside), from
// a row's least |out| and the sum of all (2 instructions an element, in
// trees of 8 so no long chain waits at the end); else the division itself.
// 16-byte stores of 8 columns after a transpose across the quad. Query
// rows from q0 + 64 wgi; rows at or past Sq and columns at or past D are
// neither stored nor checked.
template <int D, bool MARKSTEIN>
__device__ __forceinline__ bool store_tile(const float (&oacc)[Tiles<D>::NB][32],
                                           const float (&lc)[2], const float (&rc)[2],
                                           const WgmmaArgs& a, int b, int h, int q0, int wgi) {
  using T = Tiles<D>;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int C = a.H * D;
  bool in_range = true;
  float sum = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wgi * 64 + warp * 16 + lane / 4 + 8 * r;
    float least = 0x1p127f;
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
#pragma unroll
        for (int e = 0; e < 8; ++e)
          o[e] = MARKSTEIN ? div_rn(o[e], lc[r], rc[r]) : __fdiv_rn(o[e], lc[r]);
        if (MARKSTEIN) {
          float m[4], s[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            m[e] = fminf(fabsf(o[2 * e]), fabsf(o[2 * e + 1]));
            s[e] = fabsf(o[2 * e]) + fabsf(o[2 * e + 1]);
          }
          least = fminf(least, fminf(fminf(m[0], m[1]), fminf(m[2], m[3])));
          sum += (s[0] + s[1]) + (s[2] + s[3]);
        }
        uint4 val;
        __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int e = 0; e < 4; ++e) h2[e] = __floats2bfloat162_rn(o[2 * e], o[2 * e + 1]);
        *reinterpret_cast<uint4*>(a.out + ((long long)b * a.Sq + qi) * C + h * D + col) = val;
      }
    in_range &= least >= fmaxf(0x1p-99f, 0x1p-99f * rc[r]);
  }
  // a NaN or an |out| past 2^99 makes the sum NaN or past 2^99
  return in_range & (sum <= 0x1p99f);
}

// row sums over the quad, l = max(sum, 1e-30) and r = 1 / l; the rows
// stored with div_rn, checked on the way, and stored again with the
// division by every lane of a warp where one output fell outside div_rn's
// range (a thread's second store of an address lands after its first).
template <int D>
__device__ __forceinline__ void store_rows(const float (&oacc)[Tiles<D>::NB][32],
                                           const float (&lsum)[2], const WgmmaArgs& a, int b,
                                           int h, int q0, int wgi) {
  float lc[2], rc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = lsum[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    lc[r] = fmaxf(l, 1e-30f);
    rc[r] = __frcp_rn(lc[r]);
  }
  if (!__all_sync(0xffffffffu, store_tile<D, true>(oacc, lc, rc, a, b, h, q0, wgi)))
    store_tile<D, false>(oacc, lc, rc, a, b, h, q0, wgi);
}

template <int D>
__device__ __forceinline__ void zero_acc(float (&oacc)[Tiles<D>::NB][32], float (&lsum)[2]) {
#pragma unroll
  for (int n = 0; n < Tiles<D>::NB; ++n)
#pragma unroll
    for (int i = 0; i < 32; ++i) oacc[n][i] = 0.f;
  lsum[0] = lsum[1] = 0.f;
}

// ---------------------------------------------------------------------------
// attn_wgmma_bf16<D> (K1-K4): see the note at the top
// ---------------------------------------------------------------------------
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

  wg::bar_wait(q_full, 0);
  prescale_q<D>(gsmem + (qt - base), wgi, a.qscale);
  float sacc[32], oacc[T::NB][32], lsum[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.f;
  zero_acc<D>(oacc, lsum);
  const uint32_t qw = qt + wgi * 64 * 128;
  for (int it = 0; it < nt; ++it) {
    const int s = it % T::STAGES;
    const uint32_t kt = ring + s * T::STAGE;
    wg::bar_wait(full(s), (it / T::STAGES) & 1);
    score_tile<D>(sacc, qw, kt);
    softmax_pv<D>(sacc, oacc, lsum, kt + T::NB * T::KV_BOX, it * GBK, a.Sk);
    if (threadIdx.x % 128 == 0) wg::bar_arrive(empty(s));
  }
  store_rows<D>(oacc, lsum, a, b, h, q0, wgi);
}

// ---------------------------------------------------------------------------
// attn_tinykv_wgmma_bf16<D> (K5, Sk <= 128): see the note at the top
// ---------------------------------------------------------------------------
constexpr int TINY_THREADS = 256;  // two consumer warpgroups, no producer warp
constexpr int TINY_MAX_Q = 64 * 1024;  // bytes of Q tiles a block stages

template <int D>
__global__ void __launch_bounds__(TINY_THREADS, D <= 64 ? 2 : 1)
    attn_tinykv_wgmma_bf16(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, WgmmaArgs a) {
  using T = Tiles<D>;
  extern __shared__ __align__(16) uint8_t gsmem[];
  const uint32_t base = wg::smem_u32(gsmem);
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_tiles = (a.Sq + GBQ - 1) / GBQ, tile0 = blockIdx.x * a.tiles;
  const int ntiles = min(a.tiles, q_tiles - tile0), halves = a.Sk > GBK ? 2 : 1;
  const uint32_t qs = (base + 1023u) & ~1023u;          // the block's Q tiles
  const uint32_t kt = qs + a.tiles * T::Q_BYTES;         // the halves' K boxes
  const uint32_t vt = kt + halves * T::NB * T::KV_BOX;   // the halves' V boxes
  const uint32_t kv_full = vt + halves * T::NB * T::KV_BOX;
  auto q_full = [&](int i) { return kv_full + 8 * (1 + i); };
  if (threadIdx.x == 0) {
    wg::bar_init(kv_full, 1);
    for (int i = 0; i < ntiles; ++i) wg::bar_init(q_full(i), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // every load at once: the head's K and V (both halves), then the
    // block's query tiles in order, each on its own barrier
    wg::bar_expect_tx(kv_full, 2 * halves * T::NB * T::KV_BOX);
    for (int hf = 0; hf < halves; ++hf)
#pragma unroll
      for (int j = 0; j < T::NB; ++j) {
        const uint32_t o = (hf * T::NB + j) * T::KV_BOX;
        wg::tma_load_3d(kt + o, &tk, kv_full, a.k_col + h * D + 64 * j, hf * GBK, b);
        wg::tma_load_3d(vt + o, &tv, kv_full, a.v_col + h * D + 64 * j, hf * GBK, b);
      }
    for (int i = 0; i < ntiles; ++i) {
      wg::bar_expect_tx(q_full(i), T::Q_BYTES);
#pragma unroll
      for (int j = 0; j < T::NB; ++j)
        wg::tma_load_3d(qs + i * T::Q_BYTES + j * T::Q_BOX, &tq, q_full(i),
                        a.q_col + h * D + 64 * j, (tile0 + i) * GBQ, b);
    }
  }
  __syncthreads();

  const int wgi = threadIdx.x / 128;
  const int steps = (a.Sk - (halves - 1) * GBK + 15) / 16;  // the last half's live k16 steps
  float s0[32], s1[32], oacc[T::NB][32], lsum[2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s0[i] = s1[i] = 0.f;
  wg::bar_wait(kv_full, 0);
  for (int i = 0; i < ntiles; ++i) {
    const int q0 = (tile0 + i) * GBQ;
    if (q0 + wgi * 64 >= a.Sq) break;  // this warpgroup's rows all lie past Sq
    const uint32_t qt = qs + i * T::Q_BYTES, qw = qt + wgi * 64 * 128;
    wg::bar_wait(q_full(i), 0);
    prescale_q<D>(gsmem + (qt - base), wgi, a.qscale);
    zero_acc<D>(oacc, lsum);
    // each half in turn; at one box (D <= 64) two halves at once (with more
    // boxes the second score tile's registers cost more than the overlap)
    auto each_half = [&] {
      for (int hf = 0; hf < halves; ++hf) {
        const uint32_t v = vt + hf * T::NB * T::KV_BOX;
        const int key0 = hf * GBK;
        score_tile<D>(s0, qw, kt + hf * T::NB * T::KV_BOX);
        switch (hf + 1 < halves ? 4 : steps) {
          case 1: softmax_pv<D, 1>(s0, oacc, lsum, v, key0, a.Sk); break;
          case 2: softmax_pv<D, 2>(s0, oacc, lsum, v, key0, a.Sk); break;
          case 3: softmax_pv<D, 3>(s0, oacc, lsum, v, key0, a.Sk); break;
          default: softmax_pv<D>(s0, oacc, lsum, v, key0, a.Sk);
        }
      }
    };
    if constexpr (T::NB == 1) {
      if (halves == 2) {
        switch (steps) {
          case 1: two_halves<D, 1>(s0, s1, oacc, lsum, qw, kt, vt, a.Sk); break;
          case 2: two_halves<D, 2>(s0, s1, oacc, lsum, qw, kt, vt, a.Sk); break;
          case 3: two_halves<D, 3>(s0, s1, oacc, lsum, qw, kt, vt, a.Sk); break;
          default: two_halves<D, 4>(s0, s1, oacc, lsum, qw, kt, vt, a.Sk);
        }
      } else {
        each_half();
      }
    } else {
      each_half();
    }
    store_rows<D>(oacc, lsum, a, b, h, q0, wgi);
  }
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

// kernel 1: attn_wgmma_bf16, a block a 128-row query tile; kernel 2:
// attn_tinykv_wgmma_bf16, a block `tiles` query tiles of one (batch, head),
// at most TINY_MAX_Q bytes of them
template <int D>
cudaError_t launch_bf16(int kernel, Operand q, Operand k, Operand v, void* out, int B, int Sq,
                        int Sk, int H, float qscale, int tiles, cudaStream_t stream) {
  using T = Tiles<D>;
  CUtensorMap tq, tk, tv;
  const int C = H * D;
  if (!operand_map(&tq, q, Sq, B, (int)q.col_offset + C, GBQ) ||
      !operand_map(&tk, k, Sk, B, (int)k.col_offset + C, GBK) ||
      !operand_map(&tv, v, Sk, B, (int)v.col_offset + C, GBK))
    return cudaErrorInvalidValue;
  const WgmmaArgs a{static_cast<__nv_bfloat16*>(out), Sq, Sk, H, (int)q.col_offset,
                    (int)k.col_offset, (int)v.col_offset, qscale, tiles};
  const int q_tiles = (Sq + GBQ - 1) / GBQ;
  if (kernel == 1) {
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          attn_wgmma_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
      if (err != cudaSuccess) return err;
      attr_set = true;
    }
    attn_wgmma_bf16<D><<<dim3(q_tiles, H, B), wg::THREADS, T::SMEM, stream>>>(tq, tk, tv, a);
  } else {
    constexpr int max_tiles = TINY_MAX_Q / T::Q_BYTES;
    if (tiles > max_tiles) return cudaErrorInvalidValue;
    static bool attr_set = false;
    if (!attr_set) {
      const cudaError_t err = cudaFuncSetAttribute(attn_tinykv_wgmma_bf16<D>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   T::tiny_smem(max_tiles, 2));
      if (err != cudaSuccess) return err;
      attr_set = true;
    }
    const int smem = T::tiny_smem(tiles, Sk > GBK ? 2 : 1);
    attn_tinykv_wgmma_bf16<D><<<dim3((q_tiles + tiles - 1) / tiles, H, B), TINY_THREADS, smem,
                                stream>>>(tq, tk, tv, a);
  }
  return cudaGetLastError();
}

bool aligned16(const Operand& o) {
  // 16-byte TMA rows: base, strides and offset in 8-element units
  return (reinterpret_cast<uintptr_t>(o.ptr) % 16 == 0) && (o.row_stride % 8 == 0) &&
         (o.batch_stride % 8 == 0) && (o.col_offset % 8 == 0);
}

}  // namespace

// kernel: 1 = attn_wgmma_bf16, 2 = attn_tinykv_wgmma_bf16 (bfloat16
// operands; Sk <= 128, `tiles` query tiles of 128 rows a block, 1 to
// 64 KB / (16 KB x ceil(D / 64))). qscale =
// scale*log2(e), rounded to bfloat16. Returns a cudaError_t (0 on success),
// or -1 when the kernel has no instance for this head dim, key count or
// operand alignment (nothing is launched).
extern "C" int st_flash_attention(
    const void* q, long long q_sb, long long q_ss, long long q_off,
    const void* k, long long k_sb, long long k_ss, long long k_off,
    const void* v, long long v_sb, long long v_ss, long long v_off,
    void* out, int B, int Sq, int Sk, int H, int D, int kernel, float qscale, int tiles,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Operand oq{q, q_sb, q_ss, q_off}, ok{k, k_sb, k_ss, k_off}, ov{v, v_sb, v_ss, v_off};
  if ((kernel != 1 && kernel != 2) || !(aligned16(oq) && aligned16(ok) && aligned16(ov)) ||
      (kernel == 2 && (Sk > TINY_SK || tiles < 1)))
    return -1;
  switch (D) {
    case 40: return (int)launch_bf16<40>(kernel, oq, ok, ov, out, B, Sq, Sk, H, qscale, tiles,
                                         stream);
    case 64: return (int)launch_bf16<64>(kernel, oq, ok, ov, out, B, Sq, Sk, H, qscale, tiles,
                                         stream);
    case 80: return (int)launch_bf16<80>(kernel, oq, ok, ov, out, B, Sq, Sk, H, qscale, tiles,
                                         stream);
    case 160: return (int)launch_bf16<160>(kernel, oq, ok, ov, out, B, Sq, Sk, H, qscale, tiles,
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
