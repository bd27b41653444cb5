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
// What bounds it: nothing on the card. It writes (2, 320) or (12, 256)
// floats, well under a nanosecond of memory time; its device time is an
// empty launch's (st_launch_floor below, the yardstick) plus one output's
// latency, since each thread computes one output, so the 3072 outputs of
// the time_ids run side by side on 12 blocks (one block of 1024 threads
// taking three each read 0.0023 ms on an H100 against 0.0013). What it
// costs is the
// host's launch path, so the wrapper (kernels/time_embed.py) works out
// everything but the pointers once per signature, grid included, and
// passes it as one TeDims.

#include <cuda_runtime.h>

namespace {

__global__ void time_embed_kernel(const float* __restrict__ t, float* __restrict__ out,
                                  int total, int half, float c, int flip) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int b = i / (2 * half), j = i - b * 2 * half;
  const bool first = j < half;
  // __fmul_rn: each product rounded on its own, never fused into the range
  // reduction that follows, as the plain version's separate ops
  const float freq = expf(__fmul_rn(static_cast<float>(first ? j : j - half), c));
  const float arg = __fmul_rn(t[b], freq);
  out[i] = first == (flip != 0) ? cosf(arg) : sinf(arg);
}

__global__ void empty_kernel() {}

}  // namespace

// st_time_embed's integer and float arguments, made once per signature by
// the wrapper (kernels/time_embed.py TeDims)
struct TeDims {
  int b, half;
  float c;  // -ln(max_period) / (half - shift), rounded once to f32
  int flip, blocks, threads;
};

// t (B,) f32, out (B, 2*half) f32 contiguous. Returns a cudaError_t (0 on
// success).
extern "C" int st_time_embed(const float* t, float* out, void* stream_ptr, const TeDims* d) {
  if (d->b <= 0 || d->half <= 0 || d->blocks <= 0 || d->threads <= 0 || d->threads > 1024 ||
      (long long)d->blocks * d->threads < 2LL * d->b * d->half)
    return (int)cudaErrorInvalidValue;
  time_embed_kernel<<<d->blocks, d->threads, 0, static_cast<cudaStream_t>(stream_ptr)>>>(
      t, out, d->b * 2 * d->half, d->half, d->c, d->flip);
  return (int)cudaGetLastError();
}

// An empty kernel of one block of 32 threads: the device time of a launch
// that does nothing, the floor K12's device time is held against.
extern "C" int st_launch_floor(void* stream_ptr) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream_ptr)>>>();
  return (int)cudaGetLastError();
}
