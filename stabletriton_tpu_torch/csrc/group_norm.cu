// GroupNorm over NHWC input for Hopper (sm_90a). Computes the function of the
// Pallas TPU kernels stabletriton_tpu/kernels/group_norm.py:_stats_kernel
// (per-(B, C) f32 sum and sum of squares over H*W) and :_apply_kernel
// (x * scale + shift, optional SiLU). The fold of the (B, C) moments into
// per-channel scale / shift runs between the two, in PyTorch, on (B, C)
// tensors, as the JAX package leaves it to XLA.
//
// Stats, in two passes with no float atomics, so the same input gives the
// same bits in every run:
//   gn_stats_partial - grid (channel slab, row chunk, batch). A block is 32
//                      channel lanes (one 16-byte vector each) by 8 row
//                      lanes; a thread sums runs of RUN rows in f32 and folds
//                      each run into a double; the 8 row lanes meet in a
//                      fixed-order tree; one (B, chunk, C) double partial.
//   gn_stats_reduce  - sums the chunk partials of each (b, c) in a fixed
//                      order (8 chunk lanes, then a tree) and writes f32.
// The chunking depends on (H*W, C) only, never on B, so an image gets the
// same moments at every batch size.
//
// Apply: 16-byte vector loads, f32 math, one rounding to the input dtype.

#include "vec.cuh"

namespace {

using stv::load_vec;
using stv::store_vec;

constexpr int LANES = 32;     // channel vectors per block
constexpr int ROW_LANES = 8;  // row lanes per block
constexpr int THREADS = LANES * ROW_LANES;
constexpr int RUN = 16;       // rows one thread sums in f32 before its double

template <typename T, int V>
__global__ void __launch_bounds__(THREADS) gn_stats_partial(
    const T* __restrict__ x, double* __restrict__ psum, double* __restrict__ psq,
    int HW, int C, int chunk_rows) {
  __shared__ double ssum[ROW_LANES][LANES * V];
  __shared__ double ssq[ROW_LANES][LANES * V];
  const int lane = threadIdx.x % LANES, rl = threadIdx.x / LANES;
  const int cv = blockIdx.x * LANES + lane;  // this thread's channel vector
  const int chunk = blockIdx.y, b = blockIdx.z, nchunks = gridDim.y;
  const int r0 = chunk * chunk_rows;
  const int r1 = min(HW, r0 + chunk_rows);
  double ds[V], dq[V];
#pragma unroll
  for (int i = 0; i < V; ++i) ds[i] = dq[i] = 0.0;
  if (cv * V < C) {
    const T* base = x + (long long)b * HW * C + (long long)cv * V;
    for (int rs = r0 + rl; rs < r1; rs += ROW_LANES * RUN) {
      const int re = min(r1, rs + ROW_LANES * RUN);
      float s[V], q[V];
#pragma unroll
      for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
      for (int r = rs; r < re; r += ROW_LANES) {
        float v[V];
        load_vec<T, V>(base + (long long)r * C, v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] += v[i];
          q[i] = fmaf(v[i], v[i], q[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        ds[i] += s[i];
        dq[i] += q[i];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) {
    ssum[rl][lane * V + i] = ds[i];
    ssq[rl][lane * V + i] = dq[i];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < LANES * V; e += THREADS) {
    const int c = blockIdx.x * LANES * V + e;
    if (c >= C) continue;
    double s = ((ssum[0][e] + ssum[1][e]) + (ssum[2][e] + ssum[3][e])) +
               ((ssum[4][e] + ssum[5][e]) + (ssum[6][e] + ssum[7][e]));
    double q = ((ssq[0][e] + ssq[1][e]) + (ssq[2][e] + ssq[3][e])) +
               ((ssq[4][e] + ssq[5][e]) + (ssq[6][e] + ssq[7][e]));
    const long long o = ((long long)b * nchunks + chunk) * C + c;
    psum[o] = s;
    psq[o] = q;
  }
}

// grid (ceil(C / 32), B); block 32 channel lanes x 8 chunk lanes
__global__ void __launch_bounds__(THREADS) gn_stats_reduce(
    const double* __restrict__ psum, const double* __restrict__ psq,
    float* __restrict__ sum, float* __restrict__ sq, int C, int nchunks) {
  __shared__ double ssum[ROW_LANES][LANES];
  __shared__ double ssq[ROW_LANES][LANES];
  const int lane = threadIdx.x % LANES, kl = threadIdx.x / LANES;
  const int c = blockIdx.x * LANES + lane, b = blockIdx.y;
  double s = 0.0, q = 0.0;
  if (c < C) {
    for (int k = kl; k < nchunks; k += ROW_LANES) {
      const long long o = ((long long)b * nchunks + k) * C + c;
      s += psum[o];
      q += psq[o];
    }
  }
  ssum[kl][lane] = s;
  ssq[kl][lane] = q;
  __syncthreads();
  if (kl == 0 && c < C) {
    s = ((ssum[0][lane] + ssum[1][lane]) + (ssum[2][lane] + ssum[3][lane])) +
        ((ssum[4][lane] + ssum[5][lane]) + (ssum[6][lane] + ssum[7][lane]));
    q = ((ssq[0][lane] + ssq[1][lane]) + (ssq[2][lane] + ssq[3][lane])) +
        ((ssq[4][lane] + ssq[5][lane]) + (ssq[6][lane] + ssq[7][lane]));
    sum[(long long)b * C + c] = (float)s;
    sq[(long long)b * C + c] = (float)q;
  }
}

// grid (x blocks, B); each thread walks 16-byte vectors of one image
// (H*W*C < 2^31 per image, checked by the caller)
template <typename T, int V>
__global__ void __launch_bounds__(256) gn_apply(
    const T* __restrict__ x, const float* __restrict__ scale,
    const float* __restrict__ shift, T* __restrict__ out, int HW, int C, int act) {
  const int b = blockIdx.y;
  const int nvec = HW * C / V;
  const long long off = (long long)b * HW * C;
  const float* sc = scale + (long long)b * C;
  const float* sh = shift + (long long)b * C;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nvec; i += gridDim.x * blockDim.x) {
    const int c = (i * V) % C;
    float v[V];
    load_vec<T, V>(x + off + (long long)i * V, v);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float y = fmaf(v[k], __ldg(sc + c + k), __ldg(sh + c + k));
      v[k] = act ? stv::silu(y) : y;
    }
    store_vec<T, V>(out + off + (long long)i * V, v);
  }
}

template <typename T, int V>
void launch_stats(const void* x, double* psum, double* psq, float* sum, float* sq, int B,
                  int HW, int C, int nchunks, cudaStream_t stream) {
  const int slabs = (C / V + LANES - 1) / LANES;
  const int chunk_rows = (HW + nchunks - 1) / nchunks;
  gn_stats_partial<T, V><<<dim3(slabs, nchunks, B), THREADS, 0, stream>>>(
      static_cast<const T*>(x), psum, psq, HW, C, chunk_rows);
  gn_stats_reduce<<<dim3((C + LANES - 1) / LANES, B), THREADS, 0, stream>>>(
      psum, psq, sum, sq, C, nchunks);
}

template <typename T, int V>
void launch_apply(const void* x, const float* scale, const float* shift, void* out, int B,
                  int HW, int C, int act, cudaStream_t stream) {
  const int nvec = HW * C / V;
  const int blocks = (nvec + 255) / 256 < 4096 ? (nvec + 255) / 256 : 4096;
  gn_apply<T, V><<<dim3(blocks, B), 256, 0, stream>>>(
      static_cast<const T*>(x), scale, shift, static_cast<T*>(out), HW, C, act);
}

}  // namespace

// x (B, HW, C) contiguous, dtype 0 = f32, 1 = bf16; vec = values per load
// (8 for bf16 / 4 for f32 when C is a multiple and x is 16-byte aligned,
// else 1). psum / psq: (B, nchunks, C) double scratch; sum / sq: (B, C) f32
// out. Returns a cudaError_t (0 on success).
extern "C" int st_group_norm_stats(const void* x, double* psum, double* psq, float* sum,
                                   float* sq, int B, int HW, int C, int nchunks, int dtype,
                                   int vec, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (nchunks < 1 || nchunks > 65535 || C % vec) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && vec == 8)
    launch_stats<__nv_bfloat16, 8>(x, psum, psq, sum, sq, B, HW, C, nchunks, stream);
  else if (dtype == 1 && vec == 1)
    launch_stats<__nv_bfloat16, 1>(x, psum, psq, sum, sq, B, HW, C, nchunks, stream);
  else if (dtype == 0 && vec == 4)
    launch_stats<float, 4>(x, psum, psq, sum, sq, B, HW, C, nchunks, stream);
  else if (dtype == 0 && vec == 1)
    launch_stats<float, 1>(x, psum, psq, sum, sq, B, HW, C, nchunks, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// out = x * scale[b, c] + shift[b, c], then SiLU when act == 1; scale and
// shift (B, C) f32. Same dtype / vec codes as st_group_norm_stats.
extern "C" int st_group_norm_apply(const void* x, const float* scale, const float* shift,
                                   void* out, int B, int HW, int C, int act, int dtype,
                                   int vec, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (C % vec) return (int)cudaErrorInvalidValue;
  if (dtype == 1 && vec == 8)
    launch_apply<__nv_bfloat16, 8>(x, scale, shift, out, B, HW, C, act, stream);
  else if (dtype == 1 && vec == 1)
    launch_apply<__nv_bfloat16, 1>(x, scale, shift, out, B, HW, C, act, stream);
  else if (dtype == 0 && vec == 4)
    launch_apply<float, 4>(x, scale, shift, out, B, HW, C, act, stream);
  else if (dtype == 0 && vec == 1)
    launch_apply<float, 1>(x, scale, shift, out, B, HW, C, act, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
