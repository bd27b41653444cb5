// Seeded dropout for Hopper (sm_90a): out = where(u >= rate, x * scale, 0),
// scale = 1 / (1 - rate), u = (bits >> 8) * 2^-24 uniform in [0, 1).
// Computes the function of the Pallas TPU kernel
// stabletriton_tpu/kernels/dropout.py:_dropout_kernel, which seeds the TPU's
// own generator from (seed, program id). A GPU has no such generator, so the
// bits come from Philox4x32-10 (Salmon et al., SC'11), the counter-based
// generator curand and Triton's tl.rand use: key = the 64-bit seed, counter =
// (g, g >> 32, 0, 0) for the group g of 4 consecutive elements, one 32-bit
// output word per element. Every element's bits are a function of (seed,
// index) alone: the same inputs give the same mask whatever the launch shape,
// and the plain version (kernels/dropout.py) computes the same words with
// integer tensors.
//
// u >= rate is tested in integers, (bits >> 8) >= thr with thr =
// ceil(rate * 2^24) from the host, so no float rounding of rate enters.
//
// What bounds it: device memory, one read and one write of x (6.26 us at
// (2, 4096, 640) bf16 at 3.35 TB/s). Ten Philox rounds are 40 integer
// multiplies (IMAD / IMAD.HI) a group of four elements: 52 M of them at that
// shape, ~3 us at 64 a clock on each of the 132 SMs, under the bytes bound
// and spread over the same warps that wait on memory. ptxas (-Xptxas -v):
// 36-48 registers a thread, no spills, so four blocks of 256 fit an SM.
// Measured on an H100 80GB HBM3 at 700 W (PERF.md's table): 0.0075-0.0084
// ms at (2, 4096, 640) bf16, 75-83% of the bound, where the kernel it
// replaced (one thread a group of four, 2-byte accesses) read 0.0156; with
// the L2 overwritten before each launch 0.0096-0.0104 ms (60-65%). In f32,
// a Philox group a piece, 0.012-0.013 ms, at the bound with x in L2, and
// 0.017 ms (74%) from device memory: the bf16 shape, two groups a piece,
// pays for its Philox rounds.
//
// What the design does about it: a thread owns 16-byte pieces of x, 8 bf16
// (two Philox groups) or 4 f32 (one), loaded with 128-bit streaming loads
// (ld.global.cs: read once, evict first) and stored with 128-bit streaming
// stores, so a warp moves 512 bytes an access instruction; the grid is
// BLOCKS_PER_SM blocks on each SM (the SM count is queried once a device)
// and walks the pieces grid-stride, UNROLL pieces a thread a trip, all of
// whose loads are issued before the first Philox round. A base address that
// is not 16-byte aligned (an offset view) leaves `head` elements before the
// first 16-byte boundary; they and the `tail` past the last whole piece are
// done element by element by the first threads of block 0 in the same
// launch. The wrapper gives out the same address modulo 16 as x, so one
// boundary serves both. A piece then starts `head % 4` elements into its
// first group (PHASE, a template parameter): it takes the words of the
// groups it spans, one more than the aligned piece's.

#include "vec.cuh"

namespace {

using stv::from_f32;
using stv::to_f32;

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 4;  // 1024 threads an SM, up to 64 registers each
constexpr int UNROLL = 2;         // pieces a thread loads before its Philox rounds

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

__device__ __forceinline__ uint4 group_words(unsigned long long g, uint2 key) {
  return philox4x32_10(make_uint4(static_cast<unsigned>(g), static_cast<unsigned>(g >> 32), 0u,
                                  0u),
                       key);
}

template <typename T>
__device__ __forceinline__ T keep_or_zero(T x, unsigned bits, unsigned thr, float scale) {
  return from_f32<T>((bits >> 8) >= thr ? to_f32(x) * scale : 0.f);
}

// one 16-byte piece of V = 16 / sizeof(T) elements starting at element e0,
// e0 % 4 == PHASE: the words of the NG groups it spans, element k taking
// word PHASE + k
template <typename T, int PHASE>
__device__ __forceinline__ uint4 drop_piece(uint4 raw, unsigned long long e0, uint2 key,
                                            unsigned thr, float scale) {
  constexpr int V = 16 / sizeof(T);
  constexpr int NG = (PHASE + V + 3) / 4;
  unsigned w[4 * NG];
#pragma unroll
  for (int j = 0; j < NG; ++j) {
    const uint4 r = group_words((e0 >> 2) + j, key);
    w[4 * j] = r.x;
    w[4 * j + 1] = r.y;
    w[4 * j + 2] = r.z;
    w[4 * j + 3] = r.w;
  }
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int k = 0; k < V; ++k) e[k] = keep_or_zero(e[k], w[PHASE + k], thr, scale);
  return raw;
}

template <typename T, int PHASE>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ out, long long n, int head,
                   uint2 key, unsigned thr, float scale) {
  constexpr int V = 16 / sizeof(T);
  const long long pieces = (n - head) / V;
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4* ov = reinterpret_cast<uint4*>(out + head);
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long p = blockIdx.x * (long long)THREADS + threadIdx.x; p < pieces;
       p += UNROLL * stride) {
    uint4 raw[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (p + u * stride < pieces) raw[u] = __ldcs(xv + p + u * stride);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long q = p + u * stride;
      if (q < pieces)
        __stcs(ov + q, drop_piece<T, PHASE>(raw[u], head + (unsigned long long)q * V, key, thr,
                                            scale));
    }
  }
  // the head before the first 16-byte boundary and the tail past the last
  // whole piece, an element a thread
  const long long rest = n - head - pieces * V;
  if (blockIdx.x == 0 && threadIdx.x < head + rest) {
    const long long i = threadIdx.x < head ? threadIdx.x : threadIdx.x + pieces * V;
    const uint4 r = group_words(static_cast<unsigned long long>(i) >> 2, key);
    const int k = static_cast<int>(i & 3);
    const unsigned bits = k == 0 ? r.x : k == 1 ? r.y : k == 2 ? r.z : r.w;
    out[i] = keep_or_zero(x[i], bits, thr, scale);
  }
}

template <typename T>
void launch(const void* x, void* out, long long n, int head, int blocks, uint2 key,
            unsigned thr, float scale, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  auto kernel = dropout_kernel<T, 0>;
  if ((head & 3) == 1) kernel = dropout_kernel<T, 1>;
  if ((head & 3) == 2) kernel = dropout_kernel<T, 2>;
  if ((head & 3) == 3) kernel = dropout_kernel<T, 3>;
  kernel<<<blocks, THREADS, 0, stream>>>(xt, ot, n, head, key, thr, scale);
}

// the current device's SM count, queried once a device
cudaError_t sm_count(int* sms) {
  static int counts[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (counts[dev] == 0)
    err = cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev);
  *sms = counts[dev];
  return err;
}

}  // namespace

// x, out: n contiguous elements of dtype 0 = f32 or 1 = bf16, their addresses
// equal modulo 16; the seed's low and high 32 bits are the Philox key; thr =
// ceil(rate * 2^24); scale = float32(1 / (1 - rate)). Returns a cudaError_t
// (0 on success).
extern "C" int st_dropout(const void* x, void* out, long long n, unsigned key_lo,
                          unsigned key_hi, unsigned thr, float scale, int dtype,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const int esize = dtype == 1 ? 2 : 4;
  const uintptr_t mis = reinterpret_cast<uintptr_t>(x) % 16;
  if (mis != reinterpret_cast<uintptr_t>(out) % 16 || mis % esize)
    return (int)cudaErrorMisalignedAddress;
  // elements before x's first 16-byte boundary
  const long long lead = mis ? (16 - (long long)mis) / esize : 0;
  const long long head = lead < n ? lead : n;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  // pieces a block takes in one trip; at least one block, for the head and tail
  const long long per_block = (long long)THREADS * UNROLL;
  const long long want = ((n - head) / (16 / esize) + per_block - 1) / per_block;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  const int blocks = static_cast<int>(want < 1 ? 1 : want < cap ? want : cap);
  const uint2 key = make_uint2(key_lo, key_hi);
  if (dtype == 1)
    launch<__nv_bfloat16>(x, out, n, (int)head, blocks, key, thr, scale, stream);
  else
    launch<float>(x, out, n, (int)head, blocks, key, thr, scale, stream);
  return (int)cudaGetLastError();
}
