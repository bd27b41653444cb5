// GEGLU for Hopper (sm_90a): out = state * gelu(gate), with the exact (erf)
// gelu 0.5 g (1 + erf(g / sqrt 2)), all in f32, one rounding. Computes the
// function of the Pallas TPU kernel stabletriton_tpu/kernels/geglu.py:
// _geglu_kernel, which carries its own erf polynomial only because Mosaic has
// none; here erff.
//
// state and gate are the two halves of the UNet's (rows, 2N) feed-forward
// projection, read in place: both share one row stride rs (2N for the halves
// of one buffer) and a contiguous last dim, so no split copy is made. The
// output is a contiguous (rows, N). Each thread takes one 16-byte vector
// (8 bf16 / 4 f32 values) of a row.
//
// The STEPWISE form is the default binding's GEGLU (ops/reference.py geglu,
// state * F.gelu(gate).to(state.dtype)): the gelu as PyTorch's kernel takes
// it, rounded to T, then the product rounded to T.

#include "vec.cuh"

namespace {

using stv::load_vec;
using stv::store_vec;

template <typename T, int V, bool STEPWISE>
__global__ void __launch_bounds__(256) geglu_kernel(
    const T* __restrict__ state, const T* __restrict__ gate, long long rs,
    T* __restrict__ out, int rows, int N) {
  const int nv = N / V;
  const int total = rows * nv;  // < 2^31, checked by the caller
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total; i += gridDim.x * blockDim.x) {
    const int r = i / nv;
    const int c = (i - r * nv) * V;
    float s[V], g[V];
    load_vec<T, V>(state + r * rs + c, s);
    load_vec<T, V>(gate + r * rs + c, g);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      if constexpr (STEPWISE)
        s[k] = __fmul_rn(s[k], stv::round_to<T>(stv::gelu_rn(g[k])));
      else
        s[k] *= 0.5f * g[k] * (1.f + erff(g[k] * 0.70710678118654752f));
    }
    store_vec<T, V>(out + (long long)r * N + c, s);
  }
}

template <typename T, int V, bool STEPWISE>
void launch(const void* state, const void* gate, long long rs, void* out, int rows, int N,
            cudaStream_t stream) {
  const int total = rows * (N / V);
  const int blocks = (total + 255) / 256 < 8192 ? (total + 255) / 256 : 8192;
  geglu_kernel<T, V, STEPWISE><<<blocks, 256, 0, stream>>>(static_cast<const T*>(state),
                                                           static_cast<const T*>(gate), rs,
                                                           static_cast<T*>(out), rows, N);
}

template <bool STEPWISE>
int launch_any(const void* state, const void* gate, long long rs, void* out, int rows, int N,
               int dtype, int vec, cudaStream_t stream) {
  if (dtype == 1 && vec == 8)
    launch<__nv_bfloat16, 8, STEPWISE>(state, gate, rs, out, rows, N, stream);
  else if (dtype == 1 && vec == 1)
    launch<__nv_bfloat16, 1, STEPWISE>(state, gate, rs, out, rows, N, stream);
  else if (dtype == 0 && vec == 4)
    launch<float, 4, STEPWISE>(state, gate, rs, out, rows, N, stream);
  else if (dtype == 0 && vec == 1)
    launch<float, 1, STEPWISE>(state, gate, rs, out, rows, N, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// state, gate: (rows, N) with row stride rs elements and a contiguous last
// dim; out (rows, N) contiguous. dtype 0 = f32, 1 = bf16; vec = values per
// load (8 bf16 / 4 f32 when N and rs are multiples and the pointers 16-byte
// aligned, else 1); stepwise = 1 for the default binding's form. Returns a
// cudaError_t (0 on success).
extern "C" int st_geglu(const void* state, const void* gate, long long rs, void* out,
                        int rows, int N, int dtype, int vec, int stepwise, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (N % vec || rs % vec) return (int)cudaErrorInvalidValue;
  return stepwise ? launch_any<true>(state, gate, rs, out, rows, N, dtype, vec, stream)
                  : launch_any<false>(state, gate, rs, out, rows, N, dtype, vec, stream);
}
