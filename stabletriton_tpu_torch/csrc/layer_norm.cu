// Row LayerNorm / RMSNorm for Hopper (sm_90a). Computes the function of the
// Pallas TPU kernel stabletriton_tpu/kernels/layer_norm.py:_layer_norm_kernel:
// f32 two-pass mean and variance of each row (RMSNorm: mean of squares, no
// mean subtraction), x_hat = (x - mean) * rsqrt(var + eps), optional gamma
// and beta in f32, one rounding to the input dtype.
//
// One warp per row, the row held in registers: each lane loads NV 16-byte
// vectors (V = 8 bf16 or 4 f32 values) at columns (lane + 32 j) * V; lanes
// past the row's last vector (640 bf16 = 80 vectors over 32 lanes) hold
// zeros and are masked out of the variance. The warp reductions are xor
// butterflies, so every run gives the same bits. 8 rows per 256-thread block.

#include "vec.cuh"

namespace {

using stv::load_param;
using stv::load_vec;
using stv::store_vec;

constexpr int ROWS_PER_BLOCK = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int V, int NV>
__global__ void __launch_bounds__(32 * ROWS_PER_BLOCK) ln_rows(
    const T* __restrict__ x, const void* gamma, const void* beta, int pdtype,
    T* __restrict__ out, int rows, int C, float eps, int rms) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / 32;
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
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = cv * V + i;
      float y = (v[j][i] - mean) * rstd;
      if (gamma) y *= load_param(gamma, pdtype, c);
      if (beta) y += load_param(beta, pdtype, c);
      v[j][i] = y;
    }
    store_vec<T, V>(orow + cv * V, v[j]);
  }
}

template <typename T, int V>
int launch(const void* x, const void* gamma, const void* beta, int pdtype, void* out,
           int rows, int C, float eps, int rms, cudaStream_t stream) {
  const int nv = (C / V + 31) / 32;
  const dim3 grid((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  const dim3 block(32 * ROWS_PER_BLOCK);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
#define ST_LN_CASE(N)                                                                   \
  case N:                                                                               \
    ln_rows<T, V, N><<<grid, block, 0, stream>>>(xt, gamma, beta, pdtype, ot, rows, C, \
                                                 eps, rms);                            \
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

}  // namespace

// x, out (rows, C) contiguous and 16-byte aligned, C a multiple of 8 (bf16)
// or 4 (f32) and at most 256 vectors; dtype 0 = f32, 1 = bf16. gamma / beta
// (C,) of dtype pdtype (0 f32, 1 bf16), or null. rms = 1 for RMSNorm.
// Returns a cudaError_t (0 on success).
extern "C" int st_layer_norm(const void* x, const void* gamma, const void* beta, int pdtype,
                             void* out, int rows, int C, float eps, int rms, int dtype,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (dtype == 1 && C % 8 == 0)
    return launch<__nv_bfloat16, 8>(x, gamma, beta, pdtype, out, rows, C, eps, rms, stream);
  if (dtype == 0 && C % 4 == 0)
    return launch<float, 4>(x, gamma, beta, pdtype, out, rows, C, eps, rms, stream);
  return (int)cudaErrorInvalidValue;
}
