// Row LayerNorm / RMSNorm for Hopper (sm_90a). Computes the function of the
// Pallas TPU kernel stabletriton_tpu/kernels/layer_norm.py:_layer_norm_kernel:
// f32 two-pass mean and variance of each row (RMSNorm: mean of squares, no
// mean subtraction), x_hat = (x - mean) * rsqrt(var + eps), optional gamma
// and beta in f32, one rounding to the input dtype.
//
// What bounds it on the H100: one read and one write of x (a few FLOPs a
// byte), so the design keeps x's bytes in flight and touches them once.
//
// One warp per row, the row held in registers: each lane loads NV 16-byte
// vectors (V = 8 bf16 or 4 f32 values) at columns (lane + 32 j) * V; lanes
// past the row's last vector (640 bf16 = 80 vectors over 32 lanes) hold
// zeros and are masked out of the variance. The warp reductions are xor
// butterflies, so every run gives the same bits. gamma and beta are read as
// vectors of the lane's own V columns (8, 16 or 32 bytes: their dtype may
// differ from x's), element by element only where a base is not 16-byte
// aligned, and only in the apply loop, so they take registers only there
// and the stats keep the occupancy. Blocks of 8 warps, or 4 where that
// leaves fewer than two blocks an SM (the 2048-row LayerNorms), so that
// rows spread over all 132 SMs.

#include <type_traits>

#include "vec.cuh"

namespace {

using stv::load_vec;
using stv::store_vec;
using stv::to_f32;

constexpr int MAX_WARPS = 8, SMS = 132;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// V parameter values of PT at p (aligned to V * sizeof(PT), which is 8, 16
// or 32 bytes) as one or two vector loads, or element by element
template <typename PT, int V>
__device__ __forceinline__ void load_params(const PT* p, bool vec, float (&v)[V]) {
  constexpr int BYTES = V * sizeof(PT);
  using Word = std::conditional_t<BYTES % 16 == 0, uint4, uint2>;
  if (vec) {
    Word raw[BYTES / sizeof(Word)];
#pragma unroll
    for (int q = 0; q < BYTES / (int)sizeof(Word); ++q)
      raw[q] = reinterpret_cast<const Word*>(p)[q];
    const PT* e = reinterpret_cast<const PT*>(raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(p[i]);
  }
}

template <typename T, typename PT, int V, int NV>
__global__ void __launch_bounds__(32 * MAX_WARPS) ln_rows(
    const T* __restrict__ x, const PT* __restrict__ gamma, const PT* __restrict__ beta,
    bool pvec, T* __restrict__ out, int rows, int C, float eps, int rms) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= rows) return;  // whole warps leave together
  const int CV = C / V;
  const T* xr = x + (long long)row * C;
  float v[NV][V];
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int cv = lane + 32 * j;
    if (cv < CV) {
      load_vec<T, V>(xr + cv * V, v[j]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[j][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < V; ++i) s += v[j][i];
  }
  const float mean = rms ? 0.f : warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (lane + 32 * j < CV) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float d = v[j][i] - mean;
        q = fmaf(d, d, q);
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / C + eps);
  T* orow = out + (long long)row * C;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    const int cv = lane + 32 * j;
    if (cv >= CV) continue;
    float g[V], b[V];
    if (gamma) load_params<PT, V>(gamma + cv * V, pvec, g);
    if (beta) load_params<PT, V>(beta + cv * V, pvec, b);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float y = (v[j][i] - mean) * rstd;
      if (gamma) y *= g[i];
      if (beta) y += b[i];
      v[j][i] = y;
    }
    store_vec<T, V>(orow + cv * V, v[j]);
  }
}

template <typename T, typename PT, int V>
int launch(const void* x, const void* gamma, const void* beta, void* out, int rows, int C,
           float eps, int rms, cudaStream_t stream) {
  const int nv = (C / V + 31) / 32;
  const int warps = (rows + MAX_WARPS - 1) / MAX_WARPS >= 2 * SMS ? MAX_WARPS : MAX_WARPS / 2;
  const dim3 grid((rows + warps - 1) / warps);
  const dim3 block(32 * warps);
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool pvec = a16(gamma) && a16(beta);
  const T* xt = static_cast<const T*>(x);
  const PT* gt = static_cast<const PT*>(gamma);
  const PT* bt = static_cast<const PT*>(beta);
  T* ot = static_cast<T*>(out);
#define ST_LN_CASE(N)                                                                        \
  case N:                                                                                    \
    ln_rows<T, PT, V, N><<<grid, block, 0, stream>>>(xt, gt, bt, pvec, ot, rows, C, eps, rms); \
    break;
  switch (nv) {
    ST_LN_CASE(1) ST_LN_CASE(2) ST_LN_CASE(3) ST_LN_CASE(4)
    ST_LN_CASE(5) ST_LN_CASE(6) ST_LN_CASE(7) ST_LN_CASE(8)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef ST_LN_CASE
  return (int)cudaGetLastError();
}

template <typename T, int V>
int launch_p(const void* x, const void* gamma, const void* beta, int pdtype, void* out,
             int rows, int C, float eps, int rms, cudaStream_t stream) {
  return pdtype == 1
             ? launch<T, __nv_bfloat16, V>(x, gamma, beta, out, rows, C, eps, rms, stream)
             : launch<T, float, V>(x, gamma, beta, out, rows, C, eps, rms, stream);
}

}  // namespace

// The launch's other arguments, one struct: a call's signature fixes them,
// so the wrapper keeps one per signature and the call passes six pointers
// (ctypes converts each argument on every call). dtype 0 = f32, 1 = bf16;
// pdtype gamma's and beta's (0 where there are none); rms = 1 for RMSNorm.
struct LnDims {
  int dtype, pdtype, rows, C, rms;
  float eps;
};

// x, out (rows, C) contiguous and 16-byte aligned, C a multiple of 8 (bf16)
// or 4 (f32) and at most 256 vectors. gamma / beta (C,) or null; any
// alignment (vector loads where both bases are 16-byte aligned). Returns a
// cudaError_t (0 on success).
extern "C" int st_layer_norm(const void* x, const void* gamma, const void* beta, void* out,
                             void* stream_ptr, const LnDims* d) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!d) return (int)cudaErrorInvalidValue;
  const int dtype = d->dtype, pdtype = d->pdtype, rows = d->rows, C = d->C, rms = d->rms;
  const float eps = d->eps;
  if (rows <= 0 || pdtype < 0 || pdtype > 1) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && C % 8 == 0)
    return launch_p<__nv_bfloat16, 8>(x, gamma, beta, pdtype, out, rows, C, eps, rms, stream);
  if (dtype == 0 && C % 4 == 0)
    return launch_p<float, 4>(x, gamma, beta, pdtype, out, rows, C, eps, rms, stream);
  return (int)cudaErrorInvalidValue;
}
