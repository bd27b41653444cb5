// GroupNorm over NHWC input for Hopper (sm_90a). Computes the function of the
// Pallas TPU kernels stabletriton_tpu/kernels/group_norm.py:_stats_kernel
// (per-(B, C) f32 sum and sum of squares over H*W) and :_apply_kernel
// (x * scale + shift, optional SiLU), and of the fold between them that the
// JAX package leaves to XLA (the (B, C) moments to per-channel scale / shift),
// in three kernels on the caller's stream behind one C entry:
//
//   gn_stats_partial - grid (channel slab, row chunk, batch). A block is 32
//                      channel lanes (one 16-byte vector each) by 8 row
//                      lanes; a thread sums runs of RUN rows in f32 and folds
//                      each run into a double; the 8 row lanes meet in a
//                      fixed-order tree; one (B, chunk, C) double partial.
//   gn_fold          - grid (group, batch): a block holds one whole group
//                      (C / G channels: 10 at SDXL's 320, 80 at 2560, which
//                      straddle any fixed slab of channels). It sums each
//                      channel's chunk partials in a fixed order (8 chunk
//                      lanes, then a tree), rounds the sums to f32, sums the
//                      group's channels in channel order in f32, and writes
//                      scale = rsqrt(max(E[x^2] - mean^2, 0) + eps) gamma and
//                      shift = beta - mean scale, (B, C) f32; gamma and beta
//                      are read in their own dtype. The clamp keeps a
//                      near-constant group finite where E[x^2] - mean^2
//                      rounds below 0 (the JAX K9 fold has no clamp and gives
//                      NaN there; the JAX package's _gn_fold clamps).
//   gn_apply         - 16-byte vector loads, f32 math, one rounding to the
//                      input dtype.
//
// No float atomics: the chunking depends on (H*W, C) only, never on B, so
// the same input gives the same bits in every run and an image gets the
// same scale / shift alone and in a batch. The fold's products and
// differences are rounded one by one (no fused multiply-add), as the plain
// version in kernels/group_norm.py computes them.
//
// What bounds it on the H100: device memory, two reads and one write of x at
// about one FLOP a byte. The fold's kernel reads B * chunks * C doubles
// twice (at most ~0.7 MB at the UNet's shapes); before it ran on the device,
// its ~16 small PyTorch launches cost more host time than the two passes
// over x cost device time.

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

// grid (G, B); block 32 channel lanes x 8 chunk lanes, looping over the
// group's channels 32 at a time; thread 0 carries the group's f32 sums
// across the loop in channel order
__global__ void __launch_bounds__(THREADS) gn_fold(
    const double* __restrict__ psum, const double* __restrict__ psq, const void* gamma,
    int gamma_dtype, const void* beta, int beta_dtype, float* __restrict__ scale,
    float* __restrict__ shift, int HW, int C, int G, int nchunks, float eps) {
  __shared__ double ssum[ROW_LANES][LANES];
  __shared__ double ssq[ROW_LANES][LANES];
  __shared__ float csum[LANES], csq[LANES];
  __shared__ float gmean, grstd;
  const int lane = threadIdx.x % LANES, kl = threadIdx.x / LANES;
  const int g = blockIdx.x, b = blockIdx.y, per = C / G, c0 = g * per;
  float gs = 0.f, gq = 0.f;  // thread 0's group sums
  for (int cs = 0; cs < per; cs += LANES) {
    const int c = c0 + cs + lane;
    const bool valid = cs + lane < per;
    double s = 0.0, q = 0.0;
    if (valid) {
      for (int k = kl; k < nchunks; k += ROW_LANES) {
        const long long o = ((long long)b * nchunks + k) * C + c;
        s += psum[o];
        q += psq[o];
      }
    }
    ssum[kl][lane] = s;
    ssq[kl][lane] = q;
    __syncthreads();
    if (kl == 0 && valid) {
      s = ((ssum[0][lane] + ssum[1][lane]) + (ssum[2][lane] + ssum[3][lane])) +
          ((ssum[4][lane] + ssum[5][lane]) + (ssum[6][lane] + ssum[7][lane]));
      q = ((ssq[0][lane] + ssq[1][lane]) + (ssq[2][lane] + ssq[3][lane])) +
          ((ssq[4][lane] + ssq[5][lane]) + (ssq[6][lane] + ssq[7][lane]));
      csum[lane] = (float)s;
      csq[lane] = (float)q;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int n = min(LANES, per - cs);
      for (int i = 0; i < n; ++i) {
        gs = __fadd_rn(gs, csum[i]);
        gq = __fadd_rn(gq, csq[i]);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const float cnt = (float)((long long)HW * per);
    const float mean = __fdiv_rn(gs, cnt), ex2 = __fdiv_rn(gq, cnt);
    const float var = fmaxf(__fsub_rn(ex2, __fmul_rn(mean, mean)), 0.f);
    gmean = mean;
    grstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));  // torch's rsqrt: 1 / sqrt
  }
  __syncthreads();
  for (int i = threadIdx.x; i < per; i += THREADS) {
    const int c = c0 + i;
    const float sc = __fmul_rn(grstd, stv::load_param(gamma, gamma_dtype, c));
    scale[(long long)b * C + c] = sc;
    shift[(long long)b * C + c] = __fsub_rn(stv::load_param(beta, beta_dtype, c),
                                            __fmul_rn(gmean, sc));
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
void launch_partial(const void* x, double* psum, double* psq, int B, int HW, int C, int nchunks,
                    cudaStream_t stream) {
  const int slabs = (C / V + LANES - 1) / LANES;
  const int chunk_rows = (HW + nchunks - 1) / nchunks;
  gn_stats_partial<T, V><<<dim3(slabs, nchunks, B), THREADS, 0, stream>>>(
      static_cast<const T*>(x), psum, psq, HW, C, chunk_rows);
}

template <typename T, int V>
void launch_apply(const void* x, const float* scale, const float* shift, void* out, int B,
                  int HW, int C, int act, cudaStream_t stream) {
  const int nvec = HW * C / V;
  const int blocks = (nvec + 255) / 256 < 4096 ? (nvec + 255) / 256 : 4096;
  gn_apply<T, V><<<dim3(blocks, B), 256, 0, stream>>>(
      static_cast<const T*>(x), scale, shift, static_cast<T*>(out), HW, C, act);
}

// the workspace of st_group_norm / st_group_norm_fold: scale (B, C) f32,
// shift (B, C) f32, then the partial sums and squares, (B, nchunks, C)
// double each
struct Workspace {
  float *scale, *shift;
  double *psum, *psq;
  Workspace(void* ws, int B, int C, int nchunks) {
    const long long bc = (long long)B * C;
    scale = static_cast<float*>(ws);
    shift = scale + bc;
    psum = reinterpret_cast<double*>(shift + bc);
    psq = psum + bc * nchunks;
  }
};

bool valid_args(const void* ws, int B, int HW, int C, int G, int nchunks, int vec,
                int gamma_dtype, int beta_dtype) {
  return B > 0 && B <= 65535 && HW > 0 && C > 0 && G > 0 && C % G == 0 &&
         nchunks >= 1 && nchunks <= 65535 && vec > 0 && C % vec == 0 &&
         reinterpret_cast<uintptr_t>(ws) % 8 == 0 && gamma_dtype >= 0 && gamma_dtype <= 1 &&
         beta_dtype >= 0 && beta_dtype <= 1;
}

// kernels 1 and 2: the partials, then scale / shift into the workspace
int stats_and_fold(const void* x, const void* gamma, int gamma_dtype, const void* beta,
                   int beta_dtype, const Workspace& w, int B, int HW, int C, int G, float eps,
                   int nchunks, int dtype, int vec, cudaStream_t stream) {
  if (dtype == 1 && vec == 8)
    launch_partial<__nv_bfloat16, 8>(x, w.psum, w.psq, B, HW, C, nchunks, stream);
  else if (dtype == 1 && vec == 1)
    launch_partial<__nv_bfloat16, 1>(x, w.psum, w.psq, B, HW, C, nchunks, stream);
  else if (dtype == 0 && vec == 4)
    launch_partial<float, 4>(x, w.psum, w.psq, B, HW, C, nchunks, stream);
  else if (dtype == 0 && vec == 1)
    launch_partial<float, 1>(x, w.psum, w.psq, B, HW, C, nchunks, stream);
  else
    return (int)cudaErrorInvalidValue;
  gn_fold<<<dim3(G, B), THREADS, 0, stream>>>(w.psum, w.psq, gamma, gamma_dtype, beta,
                                              beta_dtype, w.scale, w.shift, HW, C, G, nchunks,
                                              eps);
  return (int)cudaGetLastError();
}

int apply_any(const void* x, const float* scale, const float* shift, void* out, int B, int HW,
              int C, int act, int dtype, int vec, cudaStream_t stream) {
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

}  // namespace

// GroupNorm of x (B, HW, C) contiguous, dtype 0 = f32, 1 = bf16, into out
// (same shape and dtype), in three kernels: the partial moments, the fold
// (G groups, eps; gamma and beta (C,) of gamma_dtype / beta_dtype, 0 = f32,
// 1 = bf16), the apply (+SiLU when act == 1). vec: values per load (8 for
// bf16 / 4 for f32 when C is a multiple and x and out are 16-byte aligned,
// else 1). ws: 8-byte aligned scratch of 8 B C (1 + 2 nchunks) bytes, whose
// first 8 B C bytes hold scale and shift afterwards. Returns a cudaError_t
// (0 on success).
extern "C" int st_group_norm(const void* x, const void* gamma, int gamma_dtype, const void* beta,
                             int beta_dtype, void* out, void* ws, int B, int HW, int C, int G,
                             float eps, int act, int nchunks, int dtype, int vec,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!valid_args(ws, B, HW, C, G, nchunks, vec, gamma_dtype, beta_dtype))
    return (int)cudaErrorInvalidValue;
  const Workspace w(ws, B, C, nchunks);
  const int code = stats_and_fold(x, gamma, gamma_dtype, beta, beta_dtype, w, B, HW, C, G, eps,
                                  nchunks, dtype, vec, stream);
  if (code != 0) return code;
  return apply_any(x, w.scale, w.shift, out, B, HW, C, act, dtype, vec, stream);
}

// Kernels 1 and 2 of st_group_norm alone: scale / shift (B, C) f32 in the
// first 8 B C bytes of ws (the fused GroupNorm conv's prologue reads them).
// Same arguments and codes as st_group_norm.
extern "C" int st_group_norm_fold(const void* x, const void* gamma, int gamma_dtype,
                                  const void* beta, int beta_dtype, void* ws, int B, int HW,
                                  int C, int G, float eps, int nchunks, int dtype, int vec,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!valid_args(ws, B, HW, C, G, nchunks, vec, gamma_dtype, beta_dtype))
    return (int)cudaErrorInvalidValue;
  return stats_and_fold(x, gamma, gamma_dtype, beta, beta_dtype, Workspace(ws, B, C, nchunks), B,
                        HW, C, G, eps, nchunks, dtype, vec, stream);
}

// out = x * scale[b, c] + shift[b, c], then SiLU when act == 1; scale and
// shift (B, C) f32. Same dtype / vec codes as st_group_norm.
extern "C" int st_group_norm_apply(const void* x, const float* scale, const float* shift,
                                   void* out, int B, int HW, int C, int act, int dtype,
                                   int vec, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (B <= 0 || B > 65535 || vec <= 0 || C % vec) return (int)cudaErrorInvalidValue;
  return apply_any(x, scale, shift, out, B, HW, C, act, dtype, vec, stream);
}
