// 3x3, stride 1, SAME-padded convolution with a fused epilogue, for Hopper
// (sm_90a). Computes the function of the Pallas TPU kernels
// stabletriton_tpu/kernels/conv_direct.py:_conv3x3_kernel_elem (and the
// three-view _conv3x3_kernel), as an implicit GEMM:
//
//   M = B*H*W output pixels, N = Cout, K = 9*Cin,
//   A[m][k] = x[b, y+ky-1, x+kx-1, ci]   (zero outside the image),
//   B[k][n] = w[ky, kx, ci, n]           (the HWIO weight IS the row-major
//                                         (9*Cin, Cout) B operand),
//   with k = (ky*3 + kx)*Cin + ci.
//
// The SAME padding is computed by index: no padded copy of x is made. Ragged
// M, N and K edges are masked (Cin=4, Cout=3 and Cout=4 all occur).
// Accumulation is f32; the epilogue adds the (Cout,) or per-batch (B, Cout)
// f32 bias, the optional residual (B, H, W, Cout), applies the optional SiLU
// and writes the input dtype.
//
// Optional GroupNorm prologue (the fused-GN conv of gn_conv2d_fused, whose
// Pallas form is _conv3x3_kernel_elem with gs_ref / gsh_ref): each input
// element inside the image becomes x * scale[b, ci] + shift[b, ci] in f32,
// then SiLU when gn_act is set, then is rounded to the input dtype before the
// product, as the JAX kernel casts before its MXU dots. Taps outside the
// image skip the prologue and stay exactly 0: the conv pads the NORMALIZED
// input with zeros, and normalize(0) != 0.
//
// Two kernels:
//   conv_wmma_bf16   - bf16 operands on tensor cores (WMMA 16x16x16, f32 acc);
//                      128x128 block tile, 8 warps of 32x64.
//   conv_scalar<T>   - f32 FMA, 64x64 block tile, 4x4 outputs per thread.
//                      The VAE decoder's f32 convs (no TF32 rounding).

#include <mma.h>

#include "vec.cuh"

using namespace nvcuda;

namespace {

using stv::from_f32;
using stv::silu;
using stv::to_f32;

struct ConvArgs {
  const void* x;         // (B, H, W, Cin)
  const void* w;         // (3, 3, Cin, Cout)
  const float* bias;     // (Cout,) or (B, Cout), or null
  long long bias_bstride;  // 0 for a shared bias, Cout for per-batch
  const void* residual;  // (B, H, W, Cout) or null
  void* out;             // (B, H, W, Cout)
  int B, H, W, Cin, Cout, act;
  const float* gn_scale;  // (B, Cin) GroupNorm prologue, or null
  const float* gn_shift;  // (B, Cin)
  int gn_act;             // 1: SiLU after the GroupNorm apply
};

// the prologue's SiLU, recomputed for every tap: fast division (2 ulp) is
// far below the bf16 rounding that follows
__device__ __forceinline__ float silu_fast(float x) { return __fdividef(x, 1.f + __expf(-x)); }

// GroupNorm apply (+ SiLU) of one in-image input element, rounded to T
template <typename T>
__device__ __forceinline__ float gn_prologue(const ConvArgs& a, int b, int ci, float v) {
  const long long o = (long long)b * a.Cin + ci;
  v = fmaf(v, __ldg(a.gn_scale + o), __ldg(a.gn_shift + o));
  if (a.gn_act) v = silu_fast(v);
  return to_f32(from_f32<T>(v));
}

// the prologue on 8 bf16 channels ci..ci+7 of batch b, packed in one uint4;
// scale / shift come in as two 16-byte loads each (Cin % 8 == 0)
__device__ __forceinline__ uint4 gn_prologue8(const ConvArgs& a, int b, int ci, uint4 raw) {
  const long long o = (long long)b * a.Cin + ci;
  const float4* sc = reinterpret_cast<const float4*>(a.gn_scale + o);
  const float4* sh = reinterpret_cast<const float4*>(a.gn_shift + o);
  const float4 s0 = __ldg(sc), s1 = __ldg(sc + 1), h0 = __ldg(sh), h1 = __ldg(sh + 1);
  const float scale[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
  const float shift[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float v = fmaf(__bfloat162float(e[i]), scale[i], shift[i]);
    if (a.gn_act) v = silu_fast(v);
    e[i] = __float2bfloat16(v);
  }
  return raw;
}

// A[m][k] of the implicit GEMM, zero outside the image or past M / K.
template <typename T>
__device__ __forceinline__ float load_a(const ConvArgs& a, int m, int k) {
  const int M = a.B * a.H * a.W;
  const int K = 9 * a.Cin;
  if (m >= M || k >= K) return 0.f;
  int tap = k / a.Cin, ci = k - tap * a.Cin;
  int ky = tap / 3, kx = tap - ky * 3;
  int hw = a.H * a.W;
  int b = m / hw, r = m - b * hw;
  int y = r / a.W + ky - 1, xx = r % a.W + kx - 1;
  if (y < 0 || y >= a.H || xx < 0 || xx >= a.W) return 0.f;
  const T* x = static_cast<const T*>(a.x);
  const float v = to_f32(x[(((long long)b * a.H + y) * a.W + xx) * a.Cin + ci]);
  return a.gn_scale ? gn_prologue<T>(a, b, ci, v) : v;
}

template <typename T>
__device__ __forceinline__ void store_out(const ConvArgs& a, int m, int n, float acc) {
  const int M = a.B * a.H * a.W;
  if (m >= M || n >= a.Cout) return;
  long long o = (long long)m * a.Cout + n;
  if (a.bias) acc += a.bias[(long long)(m / (a.H * a.W)) * a.bias_bstride + n];
  if (a.residual) acc += to_f32(static_cast<const T*>(a.residual)[o]);
  if (a.act == 1) acc = silu(acc);
  static_cast<T*>(a.out)[o] = from_f32<T>(acc);
}

// ---------------------------------------------------------------------------
// scalar kernel: BM=64 x BN=64 tile, BK=16, 256 threads, 4x4 outputs each at
// rows tm + 16*i and columns tn + 16*j (conflict-free shared reads).
// ---------------------------------------------------------------------------
constexpr int CBM = 64, CBN = 64, CBK = 16, CTHREADS = 256;

template <typename T>
__global__ void __launch_bounds__(CTHREADS) conv_scalar(ConvArgs a) {
  __shared__ float As[CBK][CBM + 4];
  __shared__ float Bs[CBK][CBN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * CBM;
  const int n0 = blockIdx.y * CBN;
  const int K = 9 * a.Cin;
  const int tm = tid / 16, tn = tid % 16;
  const T* w = static_cast<const T*>(a.w);
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += CBK) {
    // A: consecutive threads take consecutive k (contiguous channels)
    for (int idx = tid; idx < CBM * CBK; idx += CTHREADS) {
      int kk = idx % CBK, mm = idx / CBK;
      As[kk][mm] = load_a<T>(a, m0 + mm, k0 + kk);
    }
    for (int idx = tid; idx < CBK * CBN; idx += CTHREADS) {
      int kk = idx / CBN, nn = idx % CBN;
      int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < K && n < a.Cout) ? to_f32(w[(long long)k * a.Cout + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < CBK; ++kk) {
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
    for (int j = 0; j < 4; ++j) store_out<T>(a, m0 + tm + 16 * i, n0 + tn + 16 * j, acc[i][j]);
}

// ---------------------------------------------------------------------------
// bf16 WMMA kernel: BM=128 x BN=128 tile, BK=32, 8 warps as 4 (M) x 2 (N),
// each warp 32x64 = 2x4 fragments. 16-byte vector loads where Cin (for A)
// and Cout (for B) are multiples of 8 and the base is 16-byte aligned;
// element loads otherwise.
// ---------------------------------------------------------------------------
constexpr int WBM = 128, WBN = 128, WBK = 32, WTHREADS = 256;
constexpr int LDA = WBK + 8;   // bf16 pitch, multiple of 8
constexpr int LDB = WBN + 8;

__global__ void __launch_bounds__(WTHREADS) conv_wmma_bf16(ConvArgs a, int vec_a, int vec_b) {
  __shared__ __align__(128) __nv_bfloat16 As[WBM * LDA];
  __shared__ __align__(128) __nv_bfloat16 Bs[WBK * LDB];
  __shared__ __align__(128) float stage[8][16 * 16];

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.x * WBM;
  const int n0 = blockIdx.y * WBN;
  const int M = a.B * a.H * a.W;
  const int K = 9 * a.Cin;
  const int hw = a.H * a.W;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(a.w);

  // vector A path: this thread's two (row, 8-channel chunk) slots per k-tile
  int arow[2], ab[2], ay[2], ax[2];
  bool avalid[2];
  const int achunk = tid % 4;
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    arow[s] = tid / 4 + 64 * s;
    int m = m0 + arow[s];
    avalid[s] = m < M;
    int mm = avalid[s] ? m : 0;
    ab[s] = mm / hw;
    int r = mm - ab[s] * hw;
    ay[s] = r / a.W;
    ax[s] = r % a.W;
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < K; k0 += WBK) {
    if (vec_a) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        int k = k0 + achunk * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (avalid[s] && k < K) {
          int tap = k / a.Cin, ci = k - tap * a.Cin;
          int ky = tap / 3, kx = tap - ky * 3;
          int y = ay[s] + ky - 1, xx = ax[s] + kx - 1;
          if (y >= 0 && y < a.H && xx >= 0 && xx < a.W) {
            val = *reinterpret_cast<const uint4*>(
                x + (((long long)ab[s] * a.H + y) * a.W + xx) * a.Cin + ci);
            if (a.gn_scale) val = gn_prologue8(a, ab[s], ci, val);
          }
        }
        *reinterpret_cast<uint4*>(As + arow[s] * LDA + achunk * 8) = val;
      }
    } else {
      for (int idx = tid; idx < WBM * WBK; idx += WTHREADS) {
        int mm = idx / WBK, kk = idx % WBK;
        As[mm * LDA + kk] = __float2bfloat16(load_a<__nv_bfloat16>(a, m0 + mm, k0 + kk));
      }
    }
    if (vec_b) {
      for (int idx = tid; idx < WBK * (WBN / 8); idx += WTHREADS) {
        int kk = idx / (WBN / 8), c = (idx % (WBN / 8)) * 8;
        int k = k0 + kk, n = n0 + c;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (k < K && n < a.Cout)
          val = *reinterpret_cast<const uint4*>(w + (long long)k * a.Cout + n);
        *reinterpret_cast<uint4*>(Bs + kk * LDB + c) = val;
      }
    } else {
      for (int idx = tid; idx < WBK * WBN; idx += WTHREADS) {
        int kk = idx / WBN, nn = idx % WBN;
        int k = k0 + kk, n = n0 + nn;
        Bs[kk * LDB + nn] = (k < K && n < a.Cout) ? w[(long long)k * a.Cout + n]
                                                  : __float2bfloat16(0.f);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < WBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn * 64 + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: stage each 16x16 fragment through shared memory, then each
  // lane finishes 8 of its elements
  float* st = stage[warp];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(st, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      int mb = m0 + wm * 32 + i * 16;
      int nb = n0 + wn * 64 + j * 16;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        int idx = lane + 32 * e;
        store_out<__nv_bfloat16>(a, mb + idx / 16, nb + idx % 16, st[idx]);
      }
      __syncwarp();
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. act: 0 = none, 1 = SiLU.
// bias (f32) and residual may be null. gn_scale / gn_shift: (B, Cin) f32
// GroupNorm prologue, or null; gn_act: 1 = SiLU after it. Returns a
// cudaError_t (0 on success). *variant receives 1 for the WMMA kernel, 0 for
// the scalar kernel.
extern "C" int st_conv3x3(const void* x, const void* w, const float* bias,
                          long long bias_bstride, const void* residual, void* out,
                          int B, int H, int W, int Cin, int Cout, int act, int dtype,
                          const float* gn_scale, const float* gn_shift, int gn_act,
                          int* variant, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  ConvArgs a{x, w, bias, bias_bstride, residual, out, B, H, W, Cin, Cout, act,
             gn_scale, gn_shift, gn_act};
  const long long M = (long long)B * H * W;
  if (dtype == 1) {
    *variant = 1;
    int vec_a = (Cin % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                (reinterpret_cast<uintptr_t>(gn_scale) % 16 == 0) &&
                (reinterpret_cast<uintptr_t>(gn_shift) % 16 == 0);
    int vec_b = (Cout % 8 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
    dim3 grid((unsigned)((M + WBM - 1) / WBM), (Cout + WBN - 1) / WBN);
    conv_wmma_bf16<<<grid, WTHREADS, 0, stream>>>(a, vec_a, vec_b);
    return (int)cudaGetLastError();
  }
  if (dtype == 0) {
    *variant = 0;
    dim3 grid((unsigned)((M + CBM - 1) / CBM), (Cout + CBN - 1) / CBN);
    conv_scalar<float><<<grid, CTHREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}
