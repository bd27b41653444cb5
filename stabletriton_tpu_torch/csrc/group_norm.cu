// GroupNorm over NHWC input for Hopper (sm_90a). Computes the function of the
// Pallas TPU kernels stabletriton_tpu/kernels/group_norm.py:_stats_kernel
// (per-(B, C) f32 sum and sum of squares over H*W) and :_apply_kernel
// (x * scale + shift, optional SiLU), and of the fold between them that the
// JAX package leaves to XLA (the (B, C) moments to per-channel scale / shift),
// in two kernels on the caller's stream:
//
//   gn_stats_fold - the moments and the fold in one launch. The plan
//                   (kernels/group_norm.py:plan, a function of H*W, C, G and
//                   the vector width only) cuts an image into units: a slab
//                   of sv channel vectors (16 bytes each) that holds whole
//                   groups, by a chunk of rows. A block is MAX_THREADS / sv
//                   row lanes by sv vector lanes, every lane on a vector at
//                   every C; each thread keeps LOADS independent 16-byte
//                   loads in flight, sums runs of RUN rows in f32 and adds
//                   each run into a double, and the row lanes meet in a fixed
//                   order: one (B, chunk, C) double partial a unit. The last
//                   block of an (image, slab) to take its ticket sums the
//                   slab's chunk partials in chunk order (double, BATCH loads
//                   in flight a thread, rounded to f32 once) and folds the
//                   slab's groups: each group's channels in channel order in
//                   f32, each operation rounded on its own, scale =
//                   rsqrt(max(E[x^2] - mean^2, 0) + eps) gamma, shift = beta -
//                   mean scale, (B, C) f32. A slab of one chunk folds at once.
//                   The clamp keeps a near-constant group finite where E[x^2]
//                   - mean^2 rounds below 0 (the JAX K9 fold has no clamp and
//                   gives NaN there; the JAX package's _gn_fold clamps).
//   gn_apply      - x * scale + shift (+SiLU) over units of its own plan
//                   (kernels/group_norm.py:apply_plan: slabs of gcd(C / vec,
//                   8) vectors) walked backwards (the rows the stats pass read
//                   last are the likeliest still in L2), LOADS 16-byte loads in
//                   flight a thread, scale / shift of its fixed channels in
//                   registers (no per-vector modulo), f32 math, one rounding to
//                   x's dtype, streaming loads and stores.
//
// The STEPWISE instantiations of both are the default binding's GroupNorm,
// rounded as the plain PyTorch chain they replace (ops/reference.py
// group_norm_bf16apply) rounds on the card: the fold takes each group sum
// times the f32 1 / count and rstd by rsqrtf (torch.rsqrt), the apply rounds
// scale and shift to x's dtype, then x * s, + t and the SiLU (precise expf and
// division) each to x's dtype. Only the moments' summation order differs.
//
// The tickets are unsigned counters in a buffer the wrapper keeps per device
// and stream, zeroed once; the block that takes a ticket last sets it back to
// 0, so every eager call and every graph replay starts from zero. No float
// atomics: the plan never depends on B, and every sum is taken in a fixed
// order, so the same input gives the same bits in every run and an image
// gets the same scale / shift alone and in a batch.
//
// What bounds it on the H100: device memory, one read of x for the moments
// and one read and one write for the apply, at about one FLOP a byte. What
// the design does about it: up to 256 threads x 4 loads x 16 bytes = 16 KB
// in flight a block and up to four blocks an SM (enough to keep 3.35 TB/s
// busy at the memory's latency); the fold inside the stats launch, one
// ticket deep because a slab holds whole groups (two launches a GroupNorm,
// one for the fused GN conv's prologue); the stats pass loads x with an L2
// evict_last policy, so where x fits the 50 MB L2 the apply's re-read (and
// the fused conv's gather after st_group_norm_fold) is served from L2. A
// one-pass variant (a thread block cluster holding an image's slab in shared
// memory, x read once) gave the same bits and was measured slower at every
// shape it took (PERF.md, Findings), so it is not here.

#include <cuda/atomic>
#include <type_traits>

#include "vec.cuh"

namespace {

constexpr int MAX_THREADS = 256;  // a block: MAX_THREADS / sv row lanes by sv vector lanes
constexpr int LOADS = 4;           // independent loads a thread keeps in flight
constexpr int RUN = 16;            // rows a thread sums in f32 before adding into its double
constexpr int BATCH = 8;           // partial loads in flight a thread in the fold
constexpr int MAX_SMEM = 48 * 1024;

// the raw form of V values of T: one 16-byte vector, or one element
template <typename T, int V>
using Raw = std::conditional_t<V * sizeof(T) == 16, uint4,
                               std::conditional_t<sizeof(T) == 2, unsigned short, float>>;

template <typename T, int V>
__device__ __forceinline__ void unpack(const Raw<T, V>& r, float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = stv::to_f32(e[i]);
  } else if constexpr (sizeof(T) == 2) {
    v[0] = __bfloat162float(__ushort_as_bfloat16(r));
  } else {
    v[0] = r;
  }
}

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> pack(const float (&v)[V]) {
  Raw<T, V> r;
  if constexpr (V * sizeof(T) == 16) {
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = stv::from_f32<T>(v[i]);
  } else if constexpr (sizeof(T) == 2) {
    r = __bfloat16_as_ushort(__float2bfloat16(v[0]));
  } else {
    r = v[0];
  }
  return r;
}

__device__ __forceinline__ uint64_t l2_evict_last() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(policy));
  return policy;
}

// the stats pass's read of x, kept in L2 for the re-read that follows it
template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_keep(const T* p, uint64_t policy) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 r;
    asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
                 : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
                 : "l"(p), "l"(policy));
    return r;
  } else {
    return __ldg(reinterpret_cast<const Raw<T, V>*>(p));
  }
}

// kernels/group_norm.py:plan, checked by valid_plan: threads = sv *
// (MAX_THREADS / sv), a slab of sv vectors holds whole groups
struct Plan {
  int HW, C, G, sv, nslabs, chunk_rows, nchunks;
};

// The moments of one unit (slab, chunk) of x: each thread (row lane rl,
// vector lane) sums runs of RUN of its rows (rows rl, rl + k, ... of the
// chunk) in f32 and adds each run into its doubles (acc, [V][nt]); then the
// row lanes meet in a fixed order (part j sums lanes j, j + parts, ..., then
// the parts in order) into `sum` (channel ch of the slab: value ch % V of
// vector lane ch / V), nch double2 in shared memory. `base` points at the
// thread's vector of row 0, rows C values apart; a masked row adds +0, which
// leaves every sum's bits as they are. Leaves the block synchronised.
template <typename T, int V>
__device__ __forceinline__ void unit_moments(const T* base, int C, int r0, int r1,
                                             double2* acc, double2* red, double2* sum, int sv) {
  const int nt = blockDim.x, t = threadIdx.x, k = nt / sv, nch = sv * V;
  const int parts = max(1, nt / nch), rl = t / sv;
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i * nt + t] = make_double2(0.0, 0.0);
  const uint64_t keep = l2_evict_last();
  for (int rs = r0 + rl; rs < r1; rs += RUN * k) {
    const int re = min(r1, rs + RUN * k);
    float s[V], q[V];
#pragma unroll
    for (int i = 0; i < V; ++i) s[i] = q[i] = 0.f;
    for (int r = rs; r < re; r += LOADS * k) {
      Raw<T, V> raw[LOADS];
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        const int rr = r + u * k;
        raw[u] = rr < re ? load_keep<T, V>(base + (long long)rr * C, keep) : Raw<T, V>{};
      }
#pragma unroll
      for (int u = 0; u < LOADS; ++u) {
        float v[V];
        unpack<T, V>(raw[u], v);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          s[i] += v[i];
          q[i] = fmaf(v[i], v[i], q[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) {
      double2 a = acc[i * nt + t];
      a.x += s[i];
      a.y += q[i];
      acc[i * nt + t] = a;
    }
  }
  __syncthreads();
  for (int w = t; w < nch * parts; w += nt) {
    const int ch = w % nch, part = w / nch, i = ch % V, cl = ch / V;
    double2 sm = make_double2(0.0, 0.0);
    for (int r = part; r < k; r += parts) {
      const double2 a = acc[i * nt + r * sv + cl];
      sm.x += a.x;
      sm.y += a.y;
    }
    red[w] = sm;
  }
  __syncthreads();
  for (int ch = t; ch < nch; ch += nt) {
    double2 sm = red[ch];
    for (int j = 1; j < parts; ++j) {
      sm.x += red[j * nch + ch].x;
      sm.y += red[j * nch + ch].y;
    }
    sum[ch] = sm;
  }
  __syncthreads();
}

// The slab's totals from its nchunks unit partials (chunk j's channel ch at
// src[j * C + ch]), in chunk order (part j sums chunks j, j + parts, ...,
// BATCH loads in flight a thread, then the parts in order), each rounded to
// f32 once: cs / cq, nch floats each. Leaves the block synchronised.
__device__ __forceinline__ void slab_totals(const double2* src, int C, int nchunks, int nch,
                                            double2* red, float* cs, float* cq) {
  const int nt = blockDim.x, t = threadIdx.x, parts = max(1, nt / nch);
  for (int w = t; w < nch * parts; w += nt) {
    const int ch = w % nch, part = w / nch;
    double2 sm = make_double2(0.0, 0.0);
    for (int j0 = part; j0 < nchunks; j0 += BATCH * parts) {
      double2 a[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int j = j0 + u * parts;
        a[u] = j < nchunks ? __ldcg(src + (long long)j * C + ch) : make_double2(0.0, 0.0);
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        sm.x += a[u].x;
        sm.y += a[u].y;
      }
    }
    red[w] = sm;
  }
  __syncthreads();
  for (int ch = t; ch < nch; ch += nt) {
    double2 sm = red[ch];
    for (int j = 1; j < parts; ++j) {
      sm.x += red[j * nch + ch].x;
      sm.y += red[j * nch + ch].y;
    }
    cs[ch] = (float)sm.x;
    cq[ch] = (float)sm.y;
  }
  __syncthreads();
}

// The fold of a slab's groups from its f32 channel totals cs / cq (each
// group's channels in channel order in f32, every operation rounded on its
// own, var clamped at 0): each group's mean into cs and rstd into cq at its
// first channel. STEPWISE takes the moments as the plain PyTorch chain does
// on the card: each sum times the f32 1 / count (torch's division by a
// number), rstd by rsqrtf (torch.rsqrt). Leaves the block synchronised.
template <bool STEPWISE>
__device__ __forceinline__ void fold_groups(float* cs, float* cq, int nch, int per, int HW,
                                            float eps) {
  for (int g = threadIdx.x; g < nch / per; g += blockDim.x) {
    float gs = 0.f, gq = 0.f;
#pragma unroll 8
    for (int i = 0; i < per; ++i) {
      gs = __fadd_rn(gs, cs[g * per + i]);
      gq = __fadd_rn(gq, cq[g * per + i]);
    }
    const float cnt = (float)((long long)HW * per);
    if constexpr (STEPWISE) {
      const float inv = __fdiv_rn(1.f, cnt);
      const float mean = __fmul_rn(gs, inv), ex2 = __fmul_rn(gq, inv);
      const float var = fmaxf(__fsub_rn(ex2, __fmul_rn(mean, mean)), 0.f);
      cs[g * per] = mean;
      cq[g * per] = rsqrtf(__fadd_rn(var, eps));
    } else {
      const float mean = __fdiv_rn(gs, cnt), ex2 = __fdiv_rn(gq, cnt);
      const float var = fmaxf(__fsub_rn(ex2, __fmul_rn(mean, mean)), 0.f);
      cs[g * per] = mean;
      cq[g * per] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));  // correctly rounded
    }
  }
  __syncthreads();
}

template <typename T, int V, bool STEPWISE>
__global__ void __launch_bounds__(MAX_THREADS, 4) gn_stats_fold(
    const T* __restrict__ x, const void* gamma, int gamma_dtype, const void* beta,
    int beta_dtype, float* __restrict__ scale, float* __restrict__ shift,
    double2* __restrict__ partial, unsigned* __restrict__ tickets, Plan p, float eps) {
  extern __shared__ double2 smem[];
  const int nt = blockDim.x, t = threadIdx.x, sv = p.sv, nch = sv * V;
  double2* acc = smem;                        // [V][nt]: the threads' doubles, then
  double2* sum = acc;                         // [nch]: the unit's moments
  double2* red = acc + V * nt;                // [max(nt, nch)]: part sums
  float* cs = reinterpret_cast<float*>(acc);  // the slab's f32 channel sums, then
  float* cq = cs + nch;                       // each group's mean / rstd at its first
  __shared__ bool last;
  const int slab = blockIdx.x % p.nslabs, chunk = blockIdx.x / p.nslabs, b = blockIdx.y;
  const T* base = x + (long long)b * p.HW * p.C + (long long)(slab * sv + t % sv) * V;
  const int r0 = chunk * p.chunk_rows;
  unit_moments<T, V>(base, p.C, r0, min(p.HW, r0 + p.chunk_rows), acc, red, sum, sv);
  if (p.nchunks == 1) {
    // the block holds the whole slab: its moments are the totals (one
    // chunk's partial in slab_totals' sum gives the same bits); cs / cq
    // overlay the moments, so they go through red
    for (int ch = t; ch < nch; ch += nt) red[ch] = sum[ch];
    __syncthreads();
    for (int ch = t; ch < nch; ch += nt) {
      cs[ch] = (float)red[ch].x;
      cq[ch] = (float)red[ch].y;
    }
    __syncthreads();
  } else {
    double2* slab_partials = partial + (long long)b * p.nchunks * p.C + slab * nch;
    for (int ch = t; ch < nch; ch += nt) slab_partials[(long long)chunk * p.C + ch] = sum[ch];
    // the ticket: thread 0's acquire-release add publishes the block's
    // partial (ordered before it by the barrier) and, for the last block,
    // makes every other block's visible to the whole block (the barrier after)
    __syncthreads();
    unsigned* tk = tickets + (long long)b * p.nslabs + slab;
    if (t == 0) {
      cuda::atomic_ref<unsigned, cuda::thread_scope_device> ticket(*tk);
      last = ticket.fetch_add(1u, cuda::std::memory_order_acq_rel) == (unsigned)(p.nchunks - 1);
      if (last) ticket.store(0u, cuda::std::memory_order_relaxed);  // all chunks are in
    }
    __syncthreads();
    if (!last) return;
    slab_totals(slab_partials, p.C, p.nchunks, nch, red, cs, cq);
  }
  const int per = p.C / p.G;
  fold_groups<STEPWISE>(cs, cq, nch, per, p.HW, eps);
  for (int ch = t; ch < nch; ch += nt) {
    const int c = slab * nch + ch, g0 = ch / per * per;
    const float sc = __fmul_rn(cq[g0], stv::load_param(gamma, gamma_dtype, c));
    scale[(long long)b * p.C + c] = sc;
    shift[(long long)b * p.C + c] =
        __fsub_rn(stv::load_param(beta, beta_dtype, c), __fmul_rn(cs[g0], sc));
  }
}

template <typename T, int V, bool STEPWISE>
__global__ void __launch_bounds__(MAX_THREADS) gn_apply(
    const T* __restrict__ x, const float* __restrict__ scale, const float* __restrict__ shift,
    T* __restrict__ out, Plan p, int act) {
  const int unit = gridDim.x - 1 - blockIdx.x, b = gridDim.y - 1 - blockIdx.y;
  const int sv = p.sv, k = MAX_THREADS / sv;
  const int slab = unit % p.nslabs, chunk = unit / p.nslabs;
  const int lane = threadIdx.x % sv, rl = threadIdx.x / sv;
  const int c0 = (slab * sv + lane) * V;
  const long long off = (long long)b * p.HW * p.C + c0;
  float sc[V], sh[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sc[i] = __ldg(scale + (long long)b * p.C + c0 + i);
    sh[i] = __ldg(shift + (long long)b * p.C + c0 + i);
    if constexpr (STEPWISE) {  // the plain form applies bf16(scale), bf16(shift)
      sc[i] = stv::round_to<T>(sc[i]);
      sh[i] = stv::round_to<T>(sh[i]);
    }
  }
  const int r1 = min(p.HW, (chunk + 1) * p.chunk_rows);
  for (int r = chunk * p.chunk_rows + rl; r < r1; r += LOADS * k) {
    Raw<T, V> raw[LOADS] = {};
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int row = r + u * k;
      if (row < r1)
        raw[u] = __ldcs(reinterpret_cast<const Raw<T, V>*>(x + off + (long long)row * p.C));
    }
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int row = r + u * k;
      if (row >= r1) continue;
      float v[V];
      unpack<T, V>(raw[u], v);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if constexpr (STEPWISE) {
          // x * s, + t and SiLU each rounded to T, as PyTorch's kernels
          // round them (the SiLU at the store)
          const float y = stv::round_to<T>(
              __fadd_rn(stv::round_to<T>(__fmul_rn(v[i], sc[i])), sh[i]));
          v[i] = act ? stv::silu_rn(y) : y;
        } else {
          const float y = fmaf(v[i], sc[i], sh[i]);
          v[i] = act ? stv::silu(y) : y;
        }
      }
      __stcs(reinterpret_cast<Raw<T, V>*>(out + off + (long long)row * p.C), pack<T, V>(v));
    }
  }
}

// a block's threads under a slab of sv vectors: whole row lanes
int threads_of(int sv) { return MAX_THREADS / sv * sv; }

// the stats kernel's shared memory: the threads' doubles (then the unit's
// moments and the fold's f32 channel sums), the reduction's part sums
int stats_smem(int vec, int sv) {
  const int nt = threads_of(sv), nch = sv * vec;
  return (vec * nt + (nt > nch ? nt : nch)) * (int)sizeof(double2);
}


// a plan of the wrapper's, checked: sv divides C / vec (and, for the stats
// kernel, its vectors hold whole groups), whole row lanes a chunk, chunks
// covering H*W. G = 0 checks an apply plan: sv a power of two up to 8.
bool valid_plan(int B, int HW, int C, int G, int vec, int sv, int chunk_rows, Plan* p) {
  if (B <= 0 || B > 65535 || HW <= 0 || C <= 0 || vec <= 0 || C % vec || sv <= 0 ||
      sv > MAX_THREADS || (C / vec) % sv || chunk_rows <= 0 || chunk_rows % (MAX_THREADS / sv))
    return false;
  if (G == 0 ? (sv & (sv - 1)) != 0 || sv > 8
             : G < 0 || C % G || (sv * vec) % (C / G) || stats_smem(vec, sv) > MAX_SMEM)
    return false;
  const long long nchunks = ((long long)HW + chunk_rows - 1) / chunk_rows;
  if (nchunks * (C / vec / sv) > 0x7fffffff) return false;
  *p = Plan{HW, C, G, sv, C / vec / sv, chunk_rows, (int)nchunks};
  return true;
}

// the workspace: scale (B, C) f32, shift (B, C) f32, then the unit partials
// (B, nchunks, C) double2
struct Workspace {
  float *scale, *shift;
  double2* partial;
  Workspace(void* ws, int B, int C) {
    const long long bc = (long long)B * C;
    scale = static_cast<float*>(ws);
    shift = scale + bc;
    partial = reinterpret_cast<double2*>(shift + bc);
  }
};

template <typename T, int V, bool STEPWISE>
void launch_stats(const void* x, const void* gamma, int gamma_dtype, const void* beta,
                  int beta_dtype, const Workspace& w, unsigned* tickets, const Plan& p, int B,
                  float eps, cudaStream_t stream) {
  gn_stats_fold<T, V, STEPWISE><<<dim3(p.nslabs * p.nchunks, B), threads_of(p.sv), stats_smem(V, p.sv),
                        stream>>>(static_cast<const T*>(x), gamma, gamma_dtype, beta,
                                  beta_dtype, w.scale, w.shift, w.partial, tickets, p, eps);
}

template <typename T, int V, bool STEPWISE>
void launch_apply(const void* x, const float* scale, const float* shift, void* out,
                  const Plan& p, int B, int act, cudaStream_t stream) {
  gn_apply<T, V, STEPWISE><<<dim3(p.nslabs * p.nchunks, B), MAX_THREADS, 0, stream>>>(
      static_cast<const T*>(x), scale, shift, static_cast<T*>(out), p, act);
}

bool valid_params(const void* ws, const void* tickets, int gamma_dtype, int beta_dtype) {
  return reinterpret_cast<uintptr_t>(ws) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(tickets) % 4 == 0 && gamma_dtype >= 0 &&
         gamma_dtype <= 1 && beta_dtype >= 0 && beta_dtype <= 1;
}

template <bool STEPWISE>
int stats_as(const void* x, const void* gamma, int gamma_dtype, const void* beta,
             int beta_dtype, const Workspace& w, unsigned* tickets, const Plan& p, int B,
             float eps, int dtype, int vec, cudaStream_t stream) {
  if (dtype == 1 && vec == 8)
    launch_stats<__nv_bfloat16, 8, STEPWISE>(x, gamma, gamma_dtype, beta, beta_dtype, w,
                                             tickets, p, B, eps, stream);
  else if (dtype == 1 && vec == 1)
    launch_stats<__nv_bfloat16, 1, STEPWISE>(x, gamma, gamma_dtype, beta, beta_dtype, w,
                                             tickets, p, B, eps, stream);
  else if (dtype == 0 && vec == 4)
    launch_stats<float, 4, STEPWISE>(x, gamma, gamma_dtype, beta, beta_dtype, w, tickets, p,
                                     B, eps, stream);
  else if (dtype == 0 && vec == 1)
    launch_stats<float, 1, STEPWISE>(x, gamma, gamma_dtype, beta, beta_dtype, w, tickets, p,
                                     B, eps, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int stats_any(const void* x, const void* gamma, int gamma_dtype, const void* beta,
              int beta_dtype, const Workspace& w, unsigned* tickets, const Plan& p, int B,
              float eps, int stepwise, int dtype, int vec, cudaStream_t stream) {
  return stepwise ? stats_as<true>(x, gamma, gamma_dtype, beta, beta_dtype, w, tickets, p, B,
                                   eps, dtype, vec, stream)
                  : stats_as<false>(x, gamma, gamma_dtype, beta, beta_dtype, w, tickets, p, B,
                                    eps, dtype, vec, stream);
}

template <bool STEPWISE>
int apply_as(const void* x, const float* scale, const float* shift, void* out, const Plan& p,
             int B, int act, int dtype, int vec, cudaStream_t stream) {
  if (dtype == 1 && vec == 8)
    launch_apply<__nv_bfloat16, 8, STEPWISE>(x, scale, shift, out, p, B, act, stream);
  else if (dtype == 1 && vec == 1)
    launch_apply<__nv_bfloat16, 1, STEPWISE>(x, scale, shift, out, p, B, act, stream);
  else if (dtype == 0 && vec == 4)
    launch_apply<float, 4, STEPWISE>(x, scale, shift, out, p, B, act, stream);
  else if (dtype == 0 && vec == 1)
    launch_apply<float, 1, STEPWISE>(x, scale, shift, out, p, B, act, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int apply_any(const void* x, const float* scale, const float* shift, void* out, const Plan& p,
              int B, int act, int stepwise, int dtype, int vec, cudaStream_t stream) {
  return stepwise ? apply_as<true>(x, scale, shift, out, p, B, act, dtype, vec, stream)
                  : apply_as<false>(x, scale, shift, out, p, B, act, dtype, vec, stream);
}

}  // namespace

// GroupNorm of x (B, HW, C) contiguous, dtype 0 = f32, 1 = bf16, into out
// (same shape and dtype), in two kernels: the moments and the fold (G
// groups, eps; gamma and beta (C,) of gamma_dtype / beta_dtype, 0 = f32,
// 1 = bf16), then the apply (+SiLU when act == 1): in f32 with one rounding,
// or with stepwise = 1 the default binding's form (ops/reference.py
// group_norm_bf16apply: the moments as torch takes them on the card, then x *
// bf16(scale), + bf16(shift) and the SiLU each rounded to x's dtype, the
// SiLU precise). vec: values per load (8
// for bf16 / 4 for f32 when C is a multiple and x and out are 16-byte
// aligned, else 1); (sv, chunk_rows) and (apply_sv, apply_rows): the stats
// and apply plans (kernels/group_norm.py:plan, apply_plan). ws: 16-byte
// aligned scratch of 8 B C (1 + 2 nchunks) bytes, whose first 8 B C bytes
// hold scale and shift afterwards; tickets: B C / (vec sv) unsigned
// counters, all 0, which the launch leaves 0. Returns a cudaError_t (0 on
// success).
extern "C" int st_group_norm(const void* x, const void* gamma, int gamma_dtype, const void* beta,
                             int beta_dtype, void* out, void* ws, void* tickets, int B, int HW,
                             int C, int G, float eps, int act, int stepwise, int sv,
                             int chunk_rows, int apply_sv, int apply_rows, int dtype, int vec,
                             void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Plan p, pa;
  if (G <= 0 || !valid_plan(B, HW, C, G, vec, sv, chunk_rows, &p) ||
      !valid_plan(B, HW, C, 0, vec, apply_sv, apply_rows, &pa) ||
      !valid_params(ws, tickets, gamma_dtype, beta_dtype))
    return (int)cudaErrorInvalidValue;
  const Workspace w(ws, B, C);
  const int code = stats_any(x, gamma, gamma_dtype, beta, beta_dtype, w,
                             static_cast<unsigned*>(tickets), p, B, eps, stepwise, dtype, vec,
                             stream);
  if (code != 0) return code;
  return apply_any(x, w.scale, w.shift, out, pa, B, act, stepwise, dtype, vec, stream);
}

// The first kernel of st_group_norm alone: scale / shift (B, C) f32 in the
// first 8 B C bytes of ws (the fused GroupNorm conv's prologue reads them).
// Same arguments and codes as st_group_norm.
extern "C" int st_group_norm_fold(const void* x, const void* gamma, int gamma_dtype,
                                  const void* beta, int beta_dtype, void* ws, void* tickets,
                                  int B, int HW, int C, int G, float eps, int sv, int chunk_rows,
                                  int dtype, int vec, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Plan p;
  if (G <= 0 || !valid_plan(B, HW, C, G, vec, sv, chunk_rows, &p) ||
      !valid_params(ws, tickets, gamma_dtype, beta_dtype))
    return (int)cudaErrorInvalidValue;
  return stats_any(x, gamma, gamma_dtype, beta, beta_dtype, Workspace(ws, B, C),
                   static_cast<unsigned*>(tickets), p, B, eps, 0, dtype, vec, stream);
}

// out = x * scale[b, c] + shift[b, c], then SiLU when act == 1; scale and
// shift (B, C) f32; (sv, chunk_rows) the apply plan. Same dtype / vec codes
// as st_group_norm.
extern "C" int st_group_norm_apply(const void* x, const float* scale, const float* shift,
                                   void* out, int B, int HW, int C, int act, int sv,
                                   int chunk_rows, int dtype, int vec, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Plan p;
  if (!valid_plan(B, HW, C, 0, vec, sv, chunk_rows, &p)) return (int)cudaErrorInvalidValue;
  return apply_any(x, scale, shift, out, p, B, act, 0, dtype, vec, stream);
}
