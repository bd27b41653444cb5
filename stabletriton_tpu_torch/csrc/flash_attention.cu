// Non-causal multi-head attention over channel-packed operands, for Hopper
// (sm_90a). Computes the function of five Pallas TPU kernels of
// stabletriton_tpu/kernels/flash_attention.py:
//   _packed_single_kv_kernel (K1, whole KV in one block, heads packed),
//   _packed_flash_kernel     (K2, KV blocked, heads packed),
//   _flash_kernel            (K3, head-major, KV blocked),
//   _single_kv_kernel_bh     (K4, head-major, whole KV in one block),
//   _single_kv_kernel        (K5, all heads, tiny KV of at most 128 keys).
// JAX splits K1-K4 by VMEM and lane packing; on Hopper one templated kernel
// (attn_wmma_bf16<D>) computes all four in bf16. The routing rule that names
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
//   attn_wmma_bf16<D>    - bf16, D in {40, 64, 80, 160}: tensor-core WMMA
//                          16x16x16 tiles, f32 accumulate, a loop over KV tiles
//                          of 64 keys. K1-K4.
//   attn_tiny_kv_bf16<D> - bf16, the same D, Sk <= 128: the head's whole K and
//                          V staged once, one score pass, no KV loop. K5.
//   attn_scalar_f32<D>   - f32, D in {64, 512}: FMA on f32 tiles in shared
//                          memory (the VAE's d=512 needs full f32 products;
//                          TF32 would lose digits). K3 in f32.
//
// What bounds them on the H100. The bf16 kernels do 4*D FLOPs per score
// element against a handful of softmax operations (compare, exp2, convert,
// shared-memory round trip of the f32 score tile), so at D <= 160 they are
// bound by that per-score work and by shared-memory traffic, not by the
// tensor cores; the score matrix never reaches device memory. D = 40 is
// staged padded to 48 with zero columns (WMMA tiles are 16 wide): zero q and
// k columns leave the scores unchanged, zero v columns give output columns
// that are never stored, and 20% of each product is padding. The tiny-KV
// kernel at Sk = 77 reads q once and writes the output once (5.2 MB each at
// B = 2, Sq = 4096, C = 320); its products are small and the bound is the
// per-block fixed work (staging a head's K and V, the softmax pass), which
// it keeps to one pass over the key fragments up to the last real key (5 of
// the 8 fragments of its 128-row K buffer at Sk = 77). At D = 160 its
// shared memory (159 KB) leaves one block per SM.
// The scalar f32 kernel is bound by f32 FMA throughput.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr float kClip = 80.0f;

struct Operand {
  const void* ptr;
  long long batch_stride;  // elements
  long long row_stride;    // elements
  long long col_offset;    // elements
};

// ---------------------------------------------------------------------------
// scalar f32 kernel: BQ=32 query rows x BK=32 keys per tile, 256 threads.
// Thread t owns rows 2*(t/16) + {0,1}; for S it owns key columns t%16 + {0,16},
// for the output it owns head-dim columns t%16 + 16*j.
// ---------------------------------------------------------------------------
constexpr int SBQ = 32;
constexpr int SBK = 32;
constexpr int STHREADS = 256;

template <int D>
constexpr size_t scalar_smem_bytes() {
  return sizeof(float) * (SBQ * (D + 1) + SBK * (D + 1) + SBK * D + SBQ * (SBK + 1));
}

template <int D>
__global__ void __launch_bounds__(STHREADS)
attn_scalar_f32(Operand q, Operand k, Operand v, float* __restrict__ out,
                int Sq, int Sk, int H, float qscale) {
  extern __shared__ float smem[];
  float* Qs = smem;                    // [SBQ][D+1]
  float* Ks = Qs + SBQ * (D + 1);      // [SBK][D+1]
  float* Vs = Ks + SBK * (D + 1);      // [SBK][D]
  float* Ps = Vs + SBK * D;            // [SBQ][SBK+1]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * SBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const float* qp = static_cast<const float*>(q.ptr) + b * q.batch_stride + q.col_offset + h * D;
  const float* kp = static_cast<const float*>(k.ptr) + b * k.batch_stride + k.col_offset + h * D;
  const float* vp = static_cast<const float*>(v.ptr) + b * v.batch_stride + v.col_offset + h * D;

  // q tile, pre-scaled by scale*log2(e); rows past Sq are zero
  for (int idx = tid; idx < SBQ * D; idx += STHREADS) {
    int r = idx / D, c = idx % D;
    int qi = q0 + r;
    Qs[r * (D + 1) + c] = qi < Sq ? qp[qi * q.row_stride + c] * qscale : 0.f;
  }

  const int r0 = 2 * (tid / 16);
  const int lane16 = tid % 16;
  constexpr int DJ = D / 16;
  float acc[2][DJ];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  float l[2] = {0.f, 0.f};

  for (int k0 = 0; k0 < Sk; k0 += SBK) {
    __syncthreads();
    for (int idx = tid; idx < SBK * D; idx += STHREADS) {
      int r = idx / D, c = idx % D;
      int ki = k0 + r;
      bool ok = ki < Sk;
      Ks[r * (D + 1) + c] = ok ? kp[ki * k.row_stride + c] : 0.f;
      Vs[r * D + c] = ok ? vp[ki * v.row_stride + c] : 0.f;
    }
    __syncthreads();

    float s[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    const float* qa = Qs + r0 * (D + 1);
    const float* qb = qa + (D + 1);
    const float* ka = Ks + lane16 * (D + 1);
    const float* kb = Ks + (lane16 + 16) * (D + 1);
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float x0 = qa[d], x1 = qb[d], y0 = ka[d], y1 = kb[d];
      s[0][0] = fmaf(x0, y0, s[0][0]);
      s[0][1] = fmaf(x0, y1, s[0][1]);
      s[1][0] = fmaf(x1, y0, s[1][0]);
      s[1][1] = fmaf(x1, y1, s[1][1]);
    }
    float psum[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float pa = (k0 + lane16 < Sk) ? exp2f(fminf(s[i][0], kClip)) : 0.f;
      float pb = (k0 + lane16 + 16 < Sk) ? exp2f(fminf(s[i][1], kClip)) : 0.f;
      Ps[(r0 + i) * (SBK + 1) + lane16] = pa;
      Ps[(r0 + i) * (SBK + 1) + lane16 + 16] = pb;
      psum[i] = pa + pb;
    }
    // row sums over the 16 threads of this half-warp
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      psum[0] += __shfl_xor_sync(0xffffffffu, psum[0], off);
      psum[1] += __shfl_xor_sync(0xffffffffu, psum[1], off);
    }
    l[0] += psum[0];
    l[1] += psum[1];
    __syncthreads();

    const float* pa = Ps + r0 * (SBK + 1);
    const float* pb = pa + (SBK + 1);
    for (int kk = 0; kk < SBK; ++kk) {
      float w0 = pa[kk], w1 = pb[kk];
      const float* vr = Vs + kk * D + lane16;
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        float vv = vr[16 * j];
        acc[0][j] = fmaf(w0, vv, acc[0][j]);
        acc[1][j] = fmaf(w1, vv, acc[1][j]);
      }
    }
  }

  const int C = H * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    int qi = q0 + r0 + i;
    if (qi >= Sq) continue;
    float lc = fmaxf(l[i], 1e-30f);
    float* orow = out + ((long long)b * Sq + qi) * C + h * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[lane16 + 16 * j] = acc[i][j] / lc;
  }
}

// ---------------------------------------------------------------------------
// bf16 WMMA kernels: 4 warps, BQ=64 query rows (16 per warp). A warp owns its
// 16 rows through the whole kernel: scores, softmax, PV and the output. The
// shift-free softmax needs no rescale, so the PV accumulator fragments stay in
// registers across every KV tile (D/16 fragments: 10 at D=160, 80 registers
// a thread). The head dim is staged padded to DP = round_up(D, 16).
// ---------------------------------------------------------------------------
constexpr int WBQ = 64;
constexpr int WTHREADS = 128;
constexpr int LOOP_BK = 64;    // keys per tile of the KV loop (K1-K4)
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

// K1-K4: KV loop over tiles of LOOP_BK keys.
template <int D>
__global__ void __launch_bounds__(WTHREADS)
attn_wmma_bf16(Operand q, Operand k, Operand v, __nv_bfloat16* __restrict__ out,
               int Sq, int Sk, int H, float qscale) {
  constexpr int BK = LOOP_BK, LDH = Head<D>::LDH, LDP = BK + 8, LDS = BK + 4;
  extern __shared__ __align__(128) unsigned char wsmem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(wsmem);
  __nv_bfloat16* Ks = Qs + WBQ * LDH;
  __nv_bfloat16* Vs = Ks + BK * LDH;
  __nv_bfloat16* Ps = Vs + BK * LDH;
  float* Ss = reinterpret_cast<float*>(Ps + WBQ * LDP);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * WBQ;
  const __nv_bfloat16* kp = head_ptr(k, D);
  const __nv_bfloat16* vp = head_ptr(v, D);
  load_rows<D, true>(Qs, head_ptr(q, D), q.row_stride, q0, WBQ, Sq, qscale, tid);

  const __nv_bfloat16* Qw = Qs + warp * 16 * LDH;
  __nv_bfloat16* Pw = Ps + warp * 16 * LDP;
  float* Sw = Ss + warp * 16 * LDS;
  AccFrag oacc[Head<D>::NF];
#pragma unroll
  for (int n = 0; n < Head<D>::NF; ++n) wmma::fill_fragment(oacc[n], 0.f);

  // softmax pass: lane -> row lane/2, half of the tile's key columns
  const int prow = lane / 2;
  const int pcol = (lane % 2) * (BK / 2);
  float lpart = 0.f;

  for (int k0 = 0; k0 < Sk; k0 += BK) {
    __syncthreads();
    load_rows<D, false>(Ks, kp, k.row_stride, k0, BK, Sk, 0.f, tid);
    load_rows<D, false>(Vs, vp, v.row_stride, k0, BK, Sk, 0.f, tid);
    __syncthreads();
#pragma unroll
    for (int n = 0; n < BK / 16; ++n) score_fragment<D>(Sw + n * 16, LDS, Qw, Ks + n * 16 * LDH);
    __syncwarp();
    lpart += softmax_cols(Sw + prow * LDS, Pw + prow * LDP, pcol, BK / 2, Sk - k0);
    __syncwarp();
    pv_accumulate<D>(oacc, Pw, LDP, Vs, BK / 16);
  }

  const float l = lpart + __shfl_xor_sync(0xffffffffu, lpart, 1);
  store_output<D>(oacc, Sw, LDS, l, out_row(out, Sq, H, D, q0 + warp * 16 + prow), lane);
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

using BF16Kernel = void (*)(Operand, Operand, Operand, __nv_bfloat16*, int, int, int, float);

template <int D>
cudaError_t launch_bf16(bool tiny_kv, Operand q, Operand k, Operand v, void* out, int B, int Sq,
                        int Sk, int H, float qscale, cudaStream_t stream) {
  BF16Kernel kernel = tiny_kv ? &attn_tiny_kv_bf16<D> : &attn_wmma_bf16<D>;
  const size_t smem = tiny_kv ? wmma_smem_bytes<D, TINY_BK>() : wmma_smem_bytes<D, LOOP_BK>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + WBQ - 1) / WBQ, H, B);
  kernel<<<grid, WTHREADS, smem, stream>>>(q, k, v, static_cast<__nv_bfloat16*>(out), Sq, Sk,
                                           H, qscale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_scalar(Operand q, Operand k, Operand v, void* out, int B, int Sq, int Sk,
                          int H, float qscale, cudaStream_t stream) {
  constexpr size_t smem = scalar_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(attn_scalar_f32<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + SBQ - 1) / SBQ, H, B);
  attn_scalar_f32<D><<<grid, STHREADS, smem, stream>>>(q, k, v, static_cast<float*>(out), Sq,
                                                       Sk, H, qscale);
  return cudaGetLastError();
}

bool aligned16(const Operand& o) {
  // 16-byte vector loads of bf16 rows: base, strides and offset in 8-element units
  return (reinterpret_cast<uintptr_t>(o.ptr) % 16 == 0) && (o.row_stride % 8 == 0) &&
         (o.batch_stride % 8 == 0) && (o.col_offset % 8 == 0);
}

}  // namespace

// kernel: 0 = attn_scalar_f32 (float32), 1 = attn_wmma_bf16, 2 = attn_tiny_kv_bf16
// (both bfloat16). qscale = scale*log2(e), rounded to the operand dtype.
// Returns a cudaError_t (0 on success), or -1 when the kernel has no instance
// for this head dim, key count or operand alignment (nothing is launched).
extern "C" int st_flash_attention(
    const void* q, long long q_sb, long long q_ss, long long q_off,
    const void* k, long long k_sb, long long k_ss, long long k_off,
    const void* v, long long v_sb, long long v_ss, long long v_off,
    void* out, int B, int Sq, int Sk, int H, int D, int kernel, float qscale,
    void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Operand oq{q, q_sb, q_ss, q_off}, ok{k, k_sb, k_ss, k_off}, ov{v, v_sb, v_ss, v_off};
  if (kernel == 0) {
    if (D == 64) return (int)launch_scalar<64>(oq, ok, ov, out, B, Sq, Sk, H, qscale, stream);
    if (D == 512) return (int)launch_scalar<512>(oq, ok, ov, out, B, Sq, Sk, H, qscale, stream);
    return -1;
  }
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
