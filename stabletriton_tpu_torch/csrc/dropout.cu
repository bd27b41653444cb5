// Seeded dropout for Hopper (sm_90a): out = where(u >= rate, x * scale, 0),
// scale = 1 / (1 - rate), u = (bits >> 8) * 2^-24 uniform in [0, 1).
// Computes the function of the Pallas TPU kernel
// stabletriton_tpu/kernels/dropout.py:_dropout_kernel, which seeds the TPU's
// own generator from (seed, program id). A GPU has no such generator, so the
// bits come from Philox4x32-10 (Salmon et al., SC'11), the counter-based
// generator curand and Triton's tl.rand use: key = the 64-bit seed, counter =
// (g, 0, 0) for the group g of 4 consecutive elements, one 32-bit output word
// per element. Every element's bits are a function of (seed, index) alone:
// the same inputs give the same mask whatever the launch shape, and the plain
// version (kernels/dropout.py) computes the same words with integer tensors.
//
// u >= rate is tested in integers, (bits >> 8) >= thr with thr =
// ceil(rate * 2^24) from the host, so no float rounding of rate enters.
//
// What bounds it: device memory (one read, one write); ten Philox rounds per
// four elements are cheap beside that.

#include "vec.cuh"

namespace {

using stv::from_f32;
using stv::to_f32;

__device__ __forceinline__ uint4 philox4x32_10(uint4 ctr, uint2 key) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const unsigned lo0 = 0xD2511F53u * ctr.x, hi0 = __umulhi(0xD2511F53u, ctr.x);
    const unsigned lo1 = 0xCD9E8D57u * ctr.z, hi1 = __umulhi(0xCD9E8D57u, ctr.z);
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += 0x9E3779B9u;
    key.y += 0xBB67AE85u;
  }
  return ctr;
}

template <typename T>
__global__ void __launch_bounds__(256) dropout_kernel(const T* __restrict__ x,
                                                      T* __restrict__ out, long long n,
                                                      uint2 key, unsigned thr, float scale) {
  const long long groups = (n + 3) / 4;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < groups;
       g += (long long)gridDim.x * blockDim.x) {
    const uint4 r = philox4x32_10(
        make_uint4(static_cast<unsigned>(g), static_cast<unsigned>(g >> 32), 0u, 0u), key);
    const unsigned bits[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long i = g * 4 + e;
      if (i < n) out[i] = from_f32<T>((bits[e] >> 8) >= thr ? to_f32(x[i]) * scale : 0.f);
    }
  }
}

}  // namespace

// x, out: n contiguous elements of dtype 0 = f32 or 1 = bf16; the seed's low
// and high 32 bits are the Philox key; thr = ceil(rate * 2^24); scale =
// float32(1 / (1 - rate)). Returns a cudaError_t (0 on success).
extern "C" int st_dropout(const void* x, void* out, long long n, unsigned key_lo,
                          unsigned key_hi, unsigned thr, float scale, int dtype,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long groups = (n + 3) / 4;
  const int blocks = (int)((groups + 255) / 256 < 16384 ? (groups + 255) / 256 : 16384);
  const uint2 key = make_uint2(key_lo, key_hi);
  if (dtype == 1)
    dropout_kernel<__nv_bfloat16><<<blocks, 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(out), n, key, thr,
        scale);
  else if (dtype == 0)
    dropout_kernel<float><<<blocks, 256, 0, stream>>>(static_cast<const float*>(x),
                                                      static_cast<float*>(out), n, key, thr,
                                                      scale);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
