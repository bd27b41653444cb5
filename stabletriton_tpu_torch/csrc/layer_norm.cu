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
//
// The STEPWISE form is the default binding's LayerNorm (ops/reference.py
// layer_norm_bf16apply) on the same design: the moments as torch.mean and
// torch.rsqrt take them on the card (sum times f32 1 / C, each square its own
// rounding), then x - mean, * rstd, * gamma and + beta with each operand and
// result rounded to x's dtype, as that chain of PyTorch ops rounds them.

#include <type_traits>

#include "vec.cuh"

namespace {

using stv::load_vec;
using stv::store_vec;
using stv::to_f32;

constexpr int MAX_WARPS = 8, SMS = 132;
// the register budget: a lane holds at most 64 values of its row, so C <= 2048
// in either dtype (NV <= 8 bf16 vectors, 16 f32)
constexpr int MAX_VALUES = 64;

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

template <typename T, typename PT, int V, int NV, bool STEPWISE>
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
  // STEPWISE (LayerNorm only): torch.mean on the card takes the sum times
  // the f32 1 / C, and squares each difference in its own rounded op
  float mean;
  if constexpr (STEPWISE) mean = __fmul_rn(warp_sum(s), __fdiv_rn(1.f, (float)C));
  else mean = rms ? 0.f : warp_sum(s) / C;
  float q = 0.f;
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    if (lane + 32 * j < CV) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if constexpr (STEPWISE) {
          const float d = __fsub_rn(v[j][i], mean);
          q = __fadd_rn(q, __fmul_rn(d, d));
        } else {
          const float d = v[j][i] - mean;
          q = fmaf(d, d, q);
        }
      }
    }
  }
  float rstd;
  if constexpr (STEPWISE)
    rstd = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(q), __fdiv_rn(1.f, (float)C)), eps));
  else rstd = rsqrtf(warp_sum(q) / C + eps);
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
      if constexpr (STEPWISE) {
        // the plain form's roundings: x - bf16(mean), * bf16(rstd), * gamma,
        // + beta, each rounded to T (the last at the store)
        float y = stv::round_to<T>(__fsub_rn(v[j][i], stv::round_to<T>(mean)));
        y = stv::round_to<T>(__fmul_rn(y, stv::round_to<T>(rstd)));
        if (gamma) y = stv::round_to<T>(__fmul_rn(y, stv::round_to<T>(g[i])));
        if (beta) y = __fadd_rn(y, stv::round_to<T>(b[i]));
        v[j][i] = y;
      } else {
        float y = (v[j][i] - mean) * rstd;
        if (gamma) y *= g[i];
        if (beta) y += b[i];
        v[j][i] = y;
      }
    }
    store_vec<T, V>(orow + cv * V, v[j]);
  }
}

// ln_rows with NV = nv vectors a lane: the instantiations NV = N ..
// MAX_VALUES / V, the first that fits
template <typename T, typename PT, int V, bool STEPWISE, int N = 1>
int launch_nv(int nv, dim3 grid, dim3 block, const T* x, const PT* gamma, const PT* beta,
              bool pvec, T* out, int rows, int C, float eps, int rms, cudaStream_t stream) {
  if (nv == N) {
    ln_rows<T, PT, V, N, STEPWISE><<<grid, block, 0, stream>>>(x, gamma, beta, pvec, out, rows,
                                                               C, eps, rms);
    return (int)cudaGetLastError();
  }
  if constexpr (N * V < MAX_VALUES)
    return launch_nv<T, PT, V, STEPWISE, N + 1>(nv, grid, block, x, gamma, beta, pvec, out,
                                                rows, C, eps, rms, stream);
  else
    return (int)cudaErrorInvalidValue;
}

template <typename T, typename PT, int V, bool STEPWISE>
int launch(const void* x, const void* gamma, const void* beta, void* out, int rows, int C,
           float eps, int rms, cudaStream_t stream) {
  const int nv = (C / V + 31) / 32;
  const int warps = (rows + MAX_WARPS - 1) / MAX_WARPS >= 2 * SMS ? MAX_WARPS : MAX_WARPS / 2;
  const dim3 grid((rows + warps - 1) / warps);
  const dim3 block(32 * warps);
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool pvec = a16(gamma) && a16(beta);
  return launch_nv<T, PT, V, STEPWISE>(nv, grid, block, static_cast<const T*>(x),
                                       static_cast<const PT*>(gamma),
                                       static_cast<const PT*>(beta), pvec, static_cast<T*>(out),
                                       rows, C, eps, rms, stream);
}

template <typename T, int V, bool STEPWISE>
int launch_p(const void* x, const void* gamma, const void* beta, int pdtype, void* out,
             int rows, int C, float eps, int rms, cudaStream_t stream) {
  return pdtype == 1
             ? launch<T, __nv_bfloat16, V, STEPWISE>(x, gamma, beta, out, rows, C, eps, rms,
                                                     stream)
             : launch<T, float, V, STEPWISE>(x, gamma, beta, out, rows, C, eps, rms, stream);
}

template <typename T, int V>
int launch_s(const void* x, const void* gamma, const void* beta, int pdtype, void* out,
             int rows, int C, float eps, int rms, int stepwise, cudaStream_t stream) {
  return stepwise
             ? launch_p<T, V, true>(x, gamma, beta, pdtype, out, rows, C, eps, rms, stream)
             : launch_p<T, V, false>(x, gamma, beta, pdtype, out, rows, C, eps, rms, stream);
}

}  // namespace

// The launch's other arguments, one struct: a call's signature fixes them,
// so the wrapper keeps one per signature and the call passes six pointers
// (ctypes converts each argument on every call). dtype 0 = f32, 1 = bf16;
// pdtype gamma's and beta's (0 where there are none); rms = 1 for RMSNorm;
// stepwise = 1 for the default binding's LayerNorm (ops/reference.py
// layer_norm_bf16apply: each op of the apply rounded to x's dtype).
struct LnDims {
  int dtype, pdtype, rows, C, rms;
  float eps;
  int stepwise;
};

// x, out (rows, C) contiguous and 16-byte aligned, C a multiple of 8 (bf16)
// or 4 (f32) and at most 2048. gamma / beta (C,) or null; any
// alignment (vector loads where both bases are 16-byte aligned). Returns a
// cudaError_t (0 on success).
extern "C" int st_layer_norm(const void* x, const void* gamma, const void* beta, void* out,
                             void* stream_ptr, const LnDims* d) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!d) return (int)cudaErrorInvalidValue;
  const int dtype = d->dtype, pdtype = d->pdtype, rows = d->rows, C = d->C, rms = d->rms;
  const int stepwise = d->stepwise;
  const float eps = d->eps;
  if (rows <= 0 || pdtype < 0 || pdtype > 1 || (stepwise && rms))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && C % 8 == 0)
    return launch_s<__nv_bfloat16, 8>(x, gamma, beta, pdtype, out, rows, C, eps, rms, stepwise,
                                      stream);
  if (dtype == 0 && C % 4 == 0)
    return launch_s<float, 4>(x, gamma, beta, pdtype, out, rows, C, eps, rms, stepwise, stream);
  return (int)cudaErrorInvalidValue;
}
