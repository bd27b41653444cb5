// gemm_wgmma_tf32x3<MODE>: one f32 GEMM on the tensor cores at f32
// accuracy (3xTF32), shared by the f32 attention (flash_attention.cu, K3 in
// f32: MODE 0 and 1) and the f32 linear (linear.cu, K13 in f32: MODE 2).
//
// 3xTF32, the scheme of the f32 conv (conv3x3.cu conv_wgmma_tf32x3): A split
// into big / small in registers, B's big and small parts from shared memory
// (split before the launch: by the attention's wrapper, kernels/wgmma_plan.py
// tf32_parts, and by linear.cu's tf32_split_t for the linear), a_small b_big +
// a_big b_small + a_big b_big on the tensor cores, each stage's sum carried
// into the running sum in f32 adds (wgmma.cuh tf32x3_stage). One tf32
// product alone is ~1e-3 off; the three keep ~f32 accuracy.
//
// A block is 128 rows x 128 columns over k steps of 32 f32 (one 128-byte
// swizzle row): a 4-stage TMA ring of 48 KB stages (A, B big, B small), one
// producer warp, two consumer warpgroups of 64 rows; one block an SM. Both
// operands are K-major (tf32 wgmma has no transpose); TMA fills rows and
// columns past the tensors with zeros, which add nothing.
//
// The epilogues:
//   MODE 0: S = (Q qscale) K^T, a 128 x 128 tile a block (A = Q read in
//           place, scaled in registers as JAX's q * f32(scale log2e), one
//           rounding; B = K as it lies, keys x d); writes p = exp2(min(s,
//           80)), 0 for keys at or past Sk (TMA's zero rows give s = 0), and
//           the tile's row sums of p, one f32 partial a 128-key tile (no
//           atomics: a run repeats bit for bit).
//   MODE 1: O = P V (A = P; B = V^T, d x keys); sums the row's partials in
//           a fixed order and stores acc / max(l, 1e-30).
//   MODE 2: out = act(x w + bias) (A = x (M, K) as it lies; B = w^T (N, K));
//           the bias in its own dtype (f32 or bf16) and the activation
//           (stv::act, the bf16 linear kernels' SiLU and erf GELU) on the f32
//           sum; rows >= M and columns >= N are not stored, and an odd N
//           stores element by element.
//
// Included by two translation units: everything here has internal linkage,
// so each keeps its own instances (and its own shared-memory attribute flag
// in launch_tf32_gemm, one for each MODE).
#pragma once

#include "vec.cuh"
#include "wgmma.cuh"

namespace {

constexpr float kClip = 80.0f;                           // MODE 0's exp2 argument clip
constexpr int TG_BN = 128;                               // block tile columns
constexpr int TG_STAGES = 4;
constexpr int TG_A_BYTES = wg::BM * 128;                 // 128 rows x 32 f32
constexpr int TG_STAGE = TG_A_BYTES + 2 * TG_BN * 128;   // A, B big, B small
constexpr int TG_SMEM = 1024 + TG_STAGES * TG_STAGE + 16 * TG_STAGES;

struct Tf32GemmArgs {
  int M, N, K;           // this launch's rows, columns and depth
  int n_tiles;           // column tiles (blockIdx.x = row tile * n_tiles + column tile)
  // A (3-D map: column, row, z'): row a_row0 + r, column a_col0 +
  // (z % a_heads) * a_head_cols + k, z' = z / a_heads (Q: z = b * H + h)
  int a_row0, a_col0, a_heads, a_head_cols;
  float a_scale;         // A's values times this before the split
  int keys;              // MODE 0: columns at or past it give p = 0
  float* p;              // MODE 0: P, (z, rows, p_ld)
  int p_ld;
  long long p_z;
  float* l;              // row sums of p a column tile, (z, rows, l_ld): MODE 0
  int l_ld;              // writes them, MODE 1 reads them
  long long l_z;
  float* out;            // MODE 1: out[z / heads][out_row0 + r][(z % heads) * head_cols + n];
  long long out_b, out_ld;  // MODE 2: out[r][n], out_ld = N
  int out_row0, heads, head_cols;
  const void* bias;      // MODE 2: (N,) of bias_dtype (0 f32, 1 bf16), or null
  int bias_dtype, act;   // MODE 2: act 0 none, 1 SiLU, 2 GELU (erf)
};

template <int MODE>
__global__ void __launch_bounds__(wg::THREADS, 1)
    gemm_wgmma_tf32x3(const __grid_constant__ CUtensorMap tmap_a,
                      const __grid_constant__ CUtensorMap tmap_big,
                      const __grid_constant__ CUtensorMap tmap_small, Tf32GemmArgs a) {
  extern __shared__ __align__(16) uint8_t tsmem[];
  const uint32_t ring = (wg::smem_u32(tsmem) + 1023u) & ~1023u;
  auto full = [&](int s) { return ring + TG_STAGES * TG_STAGE + 8 * s; };
  auto empty = [&](int s) { return full(TG_STAGES + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < TG_STAGES; ++s) {
      wg::bar_init(full(s), 1);
      wg::bar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int mt, nt;
  wg::block_tile(a.n_tiles, mt, nt);
  const int m0 = mt * wg::BM, n0 = nt * TG_BN, z = blockIdx.z;
  const int nk = (a.K + 31) / 32;
  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    if (threadIdx.x == 256) {
      const int a_col = a.a_col0 + (z % a.a_heads) * a.a_head_cols, a_z = z / a.a_heads;
      for (int it = 0; it < nk; ++it) {
        const int s = it % TG_STAGES;
        const uint32_t st = ring + s * TG_STAGE;
        wg::bar_wait(empty(s), ((it / TG_STAGES) & 1) ^ 1);
        wg::bar_expect_tx(full(s), TG_STAGE);
        wg::tma_load_3d(st, &tmap_a, full(s), a_col + 32 * it, a.a_row0 + m0, a_z);
        wg::tma_load_3d(st + TG_A_BYTES, &tmap_big, full(s), 32 * it, n0, z);
        wg::tma_load_3d(st + TG_A_BYTES + TG_BN * 128, &tmap_small, full(s), 32 * it, n0, z);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int lrow = wgi * 64 + warp * 16 + lane % 16;
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int s = it % TG_STAGES;
    const uint32_t st = ring + s * TG_STAGE, wb = st + TG_A_BYTES;
    wg::bar_wait(full(s), (it / TG_STAGES) & 1);
    wg::tf32x3_stage(st, wb, wb + TG_BN * 128, lrow, a.a_scale, part);
    if (threadIdx.x % 128 == 0) wg::bar_arrive(empty(s));
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] += part[i];
  }

  // accumulator i lies at tile row 16 warp + lane / 4 + 8 ((i >> 1) & 1) and
  // column 8 (i >> 2) + 2 (lane % 4) + (i & 1). A quad of lanes holds one
  // row: its sums meet in two xor exchanges, which give every lane of the
  // quad the same bits.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = m0 + wgi * 64 + warp * 16 + lane / 4 + 8 * r;
    if constexpr (MODE == 0) {
      float* prow = a.p + z * a.p_z + (long long)row * a.p_ld;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TG_BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane % 4);
        const float p0 = n < a.keys ? exp2f(fminf(acc[4 * j + 2 * r], kClip)) : 0.f;
        const float p1 = n + 1 < a.keys ? exp2f(fminf(acc[4 * j + 2 * r + 1], kClip)) : 0.f;
        sum += p0 + p1;
        if (row < a.M) *reinterpret_cast<float2*>(prow + n) = make_float2(p0, p1);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (row < a.M && lane % 4 == 0) a.l[z * a.l_z + (long long)row * a.l_ld + nt] = sum;
    } else if constexpr (MODE == 1) {
      // l: lane q of the quad sums the row's partials q, q + 4, ... in order
      float l = 0.f;
      if (row < a.M)
        for (int t = lane % 4; t < a.l_ld; t += 4) l += a.l[z * a.l_z + (long long)row * a.l_ld + t];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      if (row >= a.M) continue;
      const float lc = fmaxf(l, 1e-30f);
      float* orow = a.out + (z / a.heads) * a.out_b + (long long)(a.out_row0 + row) * a.out_ld +
                    (z % a.heads) * a.head_cols;
#pragma unroll
      for (int j = 0; j < TG_BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane % 4);
        if (n < a.N)
          *reinterpret_cast<float2*>(orow + n) =
              make_float2(acc[4 * j + 2 * r] / lc, acc[4 * j + 2 * r + 1] / lc);
      }
    } else {
      if (row >= a.M) continue;
      float* orow = a.out + (long long)row * a.out_ld;
      const bool pairs = (a.N & 1) == 0;  // n is even: n < N then holds n + 1 < N
#pragma unroll
      for (int j = 0; j < TG_BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * (lane % 4);
        float v0 = acc[4 * j + 2 * r], v1 = acc[4 * j + 2 * r + 1];
        if (a.bias) {
          if (n < a.N) v0 += stv::load_param(a.bias, a.bias_dtype, n);
          if (n + 1 < a.N) v1 += stv::load_param(a.bias, a.bias_dtype, n + 1);
        }
        v0 = stv::act(v0, a.act);
        v1 = stv::act(v1, a.act);
        if (pairs) {
          if (n < a.N) *reinterpret_cast<float2*>(orow + n) = make_float2(v0, v1);
        } else {
          if (n < a.N) orow[n] = v0;
          if (n + 1 < a.N) orow[n + 1] = v1;
        }
      }
    }
  }
}

// an f32 3-D tensor map (dims innermost first, strides of dims 1 and 2 in
// elements), boxes of 32 columns x 128 rows x 1
bool f32_map(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
             uint64_t s1, uint64_t s2) {
  const uint64_t dims[3] = {d0, d1, d2};
  const uint64_t strides[2] = {s1 * 4, s2 * 4};
  const uint32_t box[3] = {32, 128, 1};
  return wg::make_map(map, base, 3, dims, strides, box, CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
}

template <int MODE>
int launch_tf32_gemm(const CUtensorMap& ta, const CUtensorMap& tb, const CUtensorMap& ts,
                     const Tf32GemmArgs& a, int zs, cudaStream_t stream) {
  static bool set = false;
  if (!set) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_wgmma_tf32x3<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, TG_SMEM);
    if (err != cudaSuccess) return (int)err;
    set = true;
  }
  const dim3 grid((unsigned)((a.M + wg::BM - 1) / wg::BM * a.n_tiles), 1, zs);
  gemm_wgmma_tf32x3<MODE><<<grid, wg::THREADS, TG_SMEM, stream>>>(ta, tb, ts, a);
  return (int)cudaGetLastError();
}

}  // namespace
