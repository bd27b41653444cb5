// Sinusoidal timestep embedding for Hopper (sm_90a): (B,) f32 timesteps ->
// (B, 2*half) f32, cos in the first half and sin in the second when flip,
// else the reverse. Computes the function of the Pallas TPU kernel
// stabletriton_tpu/kernels/time_embed.py:_time_embed_kernel, in its order:
//
//   freq = exp(col * c),  c = float32(-ln(max_period) / (half - shift))
//   arg  = t * freq
//
// with c folded on the host in double and rounded once, as JAX folds the
// Python constant. The arguments reach ~1000 rad (t up to 999 and, for
// SDXL's time_ids, 1024), so the precise sinf / cosf do the range reduction:
// the fast __sinf / __cosf lose about 1e-3 there, and this file must not be
// built with --use_fast_math.
//
// What bounds it: nothing on the card; it writes (2, 320) or (12, 256)
// floats, so one thread per output and one launch is all it needs.

#include <cuda_runtime.h>

namespace {

__global__ void time_embed_kernel(const float* __restrict__ t, float* __restrict__ out,
                                  int total, int half, float c, int flip) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int b = i / (2 * half), j = i - b * 2 * half;
  const bool first = j < half;
  const float freq = expf(static_cast<float>(first ? j : j - half) * c);
  const float arg = t[b] * freq;
  out[i] = first == (flip != 0) ? cosf(arg) : sinf(arg);
}

}  // namespace

// t (B,) f32, out (B, 2*half) f32 contiguous. Returns a cudaError_t (0 on
// success).
extern "C" int st_time_embed(const float* t, float* out, int B, int half, float c, int flip,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B <= 0 || half <= 0) return (int)cudaErrorInvalidValue;
  const int total = B * 2 * half;
  time_embed_kernel<<<(total + 255) / 256, 256, 0, stream>>>(t, out, total, half, c, flip);
  return (int)cudaGetLastError();
}
