// 3x3, stride 1, SAME-padded convolution with a fused epilogue, for Hopper
// (sm_90a). Computes the function of the Pallas TPU kernels
// stabletriton_tpu/kernels/conv_direct.py:_conv3x3_kernel_elem (and the
// three-view _conv3x3_kernel), as an implicit GEMM:
//
//   M = B*H*W output pixels, N = Cout, K = 9*Cin,
//   A[m][k] = x[b, y+ky-1, x+kx-1, ci]   (zero outside the image),
//   B[k][n] = w[ky, kx, ci, n]           (the HWIO weight IS the row-major
//                                         (9*Cin, Cout) B operand),
//   with k = (ky*3 + kx)*Cin + ci.
//
// No padded copy of x and no im2col matrix is made. Accumulation is f32; the
// epilogue adds the (Cout,) bias (in its own dtype) or the per-batch (B, Cout)
// f32 bias, the optional residual (B, H, W, Cout), applies the optional SiLU
// and writes the input dtype.
//
// Optional GroupNorm prologue (the fused-GN conv of gn_conv2d_fused, whose
// Pallas form is _conv3x3_kernel_elem with gs_ref / gsh_ref): each input
// element inside the image becomes x * scale[b, ci] + shift[b, ci] in f32,
// then SiLU when gn_act is set, then is rounded to the input dtype before the
// product, as the JAX kernel casts before its MXU dots. Taps outside the
// image stay exactly 0: the conv pads the NORMALIZED input with zeros, and
// normalize(0) != 0.
//
// The kernels:
//   conv_wgmma_bf16  - bf16 with Cin % 8 == 0, Cout % 8 == 0 or Cout <= 8,
//                      and 16-byte aligned x and w: the Hopper mainloop of
//                      wgmma.cuh. The A operand is one TMA box per (tap,
//                      64-channel chunk): a 4-D box of 64 channels x tw x th
//                      pixels x tb images (128 pixels) at (c0, x0+kx-1,
//                      y0+ky-1, b0), whose out-of-range pixels and channels
//                      TMA fills with zeros, so the SAME border costs
//                      nothing. B is the weight as the (9*Cin, Cout) matrix,
//                      as in linear_wgmma_bf16. Small levels (SD1.5's 8^2
//                      and 16^2, SDXL's 32^2) split the K steps over blocks;
//                      the splits meet in splitk_reduce. Cout <= 8 (the
//                      UNet's conv_out, Cout 4) runs an 8-column block tile
//                      (BN = 8, m64n8k16) on the weight as a K-major (8,
//                      9*Cin) matrix with rows past Cout zero, which the
//                      wrapper makes, and stores the real columns with
//                      element stores; a 128-wide tile would compute 124
//                      columns of padding. Cin % 8 != 0 (conv_in, Cin 4)
//                      comes padded by the wrapper to 8 zero-filled channels
//                      (0.5 MB at 128^2): TMA reads rows of 16 bytes, and the
//                      64-channel box over 8 channels reads zeros past them.
//   conv_gn_wgmma_bf16 - the same with the GroupNorm prologue (K8), at Cout
//                      > 8: warp-specialised on a persistent tile loop (see
//                      its section below). Three warps of their own turn
//                      each 64-channel chunk of the tile's halo, loaded by
//                      TMA as 8-channel planes, into the bf16 operand in place
//                      (scale / shift read from L2, SiLU, bf16; zero outside
//                      the image, since TMA's zero is a raw zero) while the
//                      consumer warpgroups run the previous chunk's 9 taps
//                      as shared-memory wgmmas straight from the normalised
//                      halo, one descriptor a tap. conv_gn_wgmma_bf16_n8,
//                      its 8-column form (Cout <= 8: the UNet's norm_out +
//                      SiLU + conv_out), normalises in the consumers and
//                      feeds register-A wgmmas.
//   conv_wgmma_tf32x3 - f32 with Cin % 8 == 0 (every 3x3 conv of the VAE
//                      decoder but conv_in): the same TMA + wgmma shape in
//                      3xTF32. The weight comes prepared by the wrapper as
//                      two K-major (Cout_pad, 9*Cin) f32 matrices, big (low
//                      13 mantissa bits cleared) and small (w - big), Cout
//                      padded to a multiple of 8 with zero rows (tf32 wgmma
//                      has no transpose, so the HWIO weight, N-contiguous,
//                      cannot be B as it lies). A's split is made in
//                      registers from the f32 tile. The three products
//                      a_big w_big + a_big w_small + a_small w_big keep f32
//                      accuracy (the dropped a_small w_small is ~2^-22 of a
//                      product). Cout <= 8 (the decoder's conv_out, Cout 3)
//                      runs an 8-wide block tile, so its 3 channels cost 8
//                      columns, not 64.
//   conv_direct_f32<CIN> - f32 with Cin <= 4 and no GroupNorm prologue (the
//                      VAE decoders' conv_in, Cin 4 -> 512): a direct
//                      convolution, weight-stationary. K = 9 Cin is 36, so
//                      an implicit GEMM's operand staging outweighs its 36
//                      FMAs an output; here a thread owns 2 consecutive
//                      output channels, whose 9 Cin x 2 weights (72
//                      registers at Cin 4) it loads once, and a block of
//                      256 threads spans 512 channels. A tile is a segment
//                      of 32 pixels of one image row; its 3 x 34-pixel halo
//                      (Cin padded to 4, one float4 a pixel, 0 outside the
//                      image) is staged in shared memory, where all lanes of
//                      a warp read one address (a broadcast). A thread sums
//                      4 pixels at once (8 independent FMA chains) in f32
//                      FMAs, tap-major and channel inner (conv3x3_plain's
//                      order of K; no TF32), then adds bias, residual and
//                      SiLU as store_out does; a warp's store is 64
//                      consecutive channels of one pixel, 256 bytes. Up to
//                      two blocks an SM walk the tiles, the next tile's halo
//                      fetched into registers under this tile's sums.
//   conv_scalar      - f32 FMA, 64x64 block tile, 4x4 outputs per thread.
//                      What neither f32 kernel above takes: f32 with the
//                      GroupNorm prologue, f32 Cin > 4 that is no multiple
//                      of 8, and f32 x whose base is not 16-byte aligned at
//                      Cin % 8 == 0. No path of chip_smoke.py launches it
//                      (the VAE decoder's GroupNorms are not fused into its
//                      convs, and its Cin are 4 or multiples of 8);
//                      chip_smoke.py times it beside the direct kernel and a
//                      card test holds it against the plain conv.
//
// What bounds it on the H100: at the UNet's shapes (K = 9*Cin = 2880 to
// 23040) the implicit GEMM is compute-bound, so the wgmma kernel keeps the
// tensor cores fed from a TMA ring; at SD1.5's 8^2 level (128 output pixels
// a batch) reading the weight once bounds it, and the K split spreads that
// read over the SMs. The f32 VAE convs (K = 1152 to 4608) are bound by
// operations: at the f32 FMA peak (67 TFLOP/s) a 1024^2 128->128 conv takes
// 4.6 ms, and in 3xTF32 on the tensor cores (three tf32 products at 495
// TFLOP/s) 1.9 ms; conv_out (128->3) is bound by reading x once (0.16 ms).
// The tf32 kernel's stage reloads the block's weight share (big and small,
// 32 KB at BN = 128) beside 16 KB of A, so L2 traffic is its second limit.
// The UNet's conv_out (320->4) is bound by reading x once (0.0063 ms), and
// at BN = 8 each pixel's 320 channels are read 9 times from L2 (190 MB at
// 128^2), which bounds its 8-column kernel. The decoder's conv_in (128^2,
// 4 -> 512) writes 33.5 MB of f32 (10.0 us at 3.35 TB/s) and does 0.30 G
// FMAs (9.0 us at the f32 FMA peak): the direct kernel issues little beyond
// its FMAs and stores, so both limits overlap.

#include "vec.cuh"
#include "wgmma.cuh"

namespace {

using stv::silu;

// the f32 scalar kernel's arguments
struct ConvArgs {
  const float* x;        // (B, H, W, Cin)
  const float* w;        // (3, 3, Cin, Cout)
  const void* bias;      // (Cout,) or (B, Cout) of bias_dtype, or null
  long long bias_bstride;  // 0 for a shared bias, Cout for per-batch
  int bias_dtype;        // 0 f32, 1 bf16
  const float* residual;  // (B, H, W, Cout) or null
  float* out;            // (B, H, W, Cout)
  int B, H, W, Cin, Cout, act;
  const float* gn_scale;  // (B, Cin) GroupNorm prologue, or null
  const float* gn_shift;  // (B, Cin)
  int gn_act;             // 1: SiLU after the GroupNorm apply
};

// GroupNorm apply (+ SiLU) of one in-image input element
__device__ __forceinline__ float gn_prologue(const ConvArgs& a, int b, int ci, float v) {
  const long long o = (long long)b * a.Cin + ci;
  v = fmaf(v, __ldg(a.gn_scale + o), __ldg(a.gn_shift + o));
  return a.gn_act ? silu(v) : v;
}

// A[m][k] of the implicit GEMM, zero outside the image or past M / K.
__device__ __forceinline__ float load_a(const ConvArgs& a, int m, int k) {
  const int M = a.B * a.H * a.W;
  const int K = 9 * a.Cin;
  if (m >= M || k >= K) return 0.f;
  int tap = k / a.Cin, ci = k - tap * a.Cin;
  int ky = tap / 3, kx = tap - ky * 3;
  int hw = a.H * a.W;
  int b = m / hw, r = m - b * hw;
  int y = r / a.W + ky - 1, xx = r % a.W + kx - 1;
  if (y < 0 || y >= a.H || xx < 0 || xx >= a.W) return 0.f;
  const float v = a.x[(((long long)b * a.H + y) * a.W + xx) * a.Cin + ci];
  return a.gn_scale ? gn_prologue(a, b, ci, v) : v;
}

__device__ __forceinline__ void store_out(const ConvArgs& a, int m, int n, float acc) {
  const int M = a.B * a.H * a.W;
  if (m >= M || n >= a.Cout) return;
  long long o = (long long)m * a.Cout + n;
  if (a.bias) {
    const long long bo = (long long)(m / (a.H * a.W)) * a.bias_bstride + n;
    acc += a.bias_dtype == 1 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[bo])
                             : static_cast<const float*>(a.bias)[bo];
  }
  if (a.residual) acc += a.residual[o];
  if (a.act == 1) acc = silu(acc);
  a.out[o] = acc;
}

// ---------------------------------------------------------------------------
// scalar kernel: BM=64 x BN=64 tile, BK=16, 256 threads, 4x4 outputs each at
// rows tm + 16*i and columns tn + 16*j (conflict-free shared reads).
// ---------------------------------------------------------------------------
constexpr int CBM = 64, CBN = 64, CBK = 16, CTHREADS = 256;

__global__ void __launch_bounds__(CTHREADS) conv_scalar(ConvArgs a) {
  __shared__ float As[CBK][CBM + 4];
  __shared__ float Bs[CBK][CBN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * CBM;
  const int n0 = blockIdx.y * CBN;
  const int K = 9 * a.Cin;
  const int tm = tid / 16, tn = tid % 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < K; k0 += CBK) {
    // A: consecutive threads take consecutive k (contiguous channels)
    for (int idx = tid; idx < CBM * CBK; idx += CTHREADS) {
      int kk = idx % CBK, mm = idx / CBK;
      As[kk][mm] = load_a(a, m0 + mm, k0 + kk);
    }
    for (int idx = tid; idx < CBK * CBN; idx += CTHREADS) {
      int kk = idx / CBN, nn = idx % CBN;
      int k = k0 + kk, n = n0 + nn;
      Bs[kk][nn] = (k < K && n < a.Cout) ? a.w[(long long)k * a.Cout + n] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < CBK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][tm + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][tn + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) store_out(a, m0 + tm + 16 * i, n0 + tn + 16 * j, acc[i][j]);
}

// ---------------------------------------------------------------------------
// f32 direct kernel for Cin <= 4 (the VAE decoders' conv_in): the weight in
// registers, the input tile's halo in shared memory; see the note at the top
// ---------------------------------------------------------------------------
constexpr int DTHREADS = 256;                // a block
constexpr int DCPT = 2;                      // consecutive output channels a thread owns
constexpr int DCOLS = DTHREADS * DCPT;       // output channels a block (512)
constexpr int DTW = 32;                      // pixels of a tile: a row segment
constexpr int DPG = 4;                       // pixels a thread sums at once
constexpr int DHALO = 3 * (DTW + 2);         // halo pixels of a tile (3 rows x 34)
constexpr int DIRECT_MAX_CIN = 4;

struct DirectArgs {
  const float* x;          // (B, H, W, CIN)
  const float* w;          // (3, 3, CIN, Cout)
  const void* bias;        // (Cout,) or (B, Cout) of bias_dtype, or null
  long long bias_bstride;  // 0 for a shared bias, Cout for per-batch
  const float* residual;   // (B, H, W, Cout) or null
  float* out;              // (B, H, W, Cout)
  int B, H, W, Cout, bias_dtype, act;
  int segs;                // DTW-pixel segments a row
  int n_tiles;             // B * H * segs
  int vec2;                // 1: float2 stores and residual loads (Cout even, 8-byte bases)
};

__device__ __forceinline__ float bias_at(const DirectArgs& a, long long o) {
  return a.bias_dtype == 1 ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[o])
                           : static_cast<const float*>(a.bias)[o];
}

// this thread's halo pixel of tile `tile` (threads below DHALO; zero outside
// the image and past the last tile): its CIN channels, padded to 4
template <int CIN>
__device__ __forceinline__ float4 direct_fetch(const DirectArgs& a, int tile) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  if (threadIdx.x < DHALO && tile < a.n_tiles) {
    const int row = tile / a.segs, b = row / a.H, y = row - b * a.H;
    const int yy = y + static_cast<int>(threadIdx.x) / (DTW + 2) - 1;
    const int xx = (tile - row * a.segs) * DTW + static_cast<int>(threadIdx.x) % (DTW + 2) - 1;
    if (yy >= 0 && yy < a.H && xx >= 0 && xx < a.W) {
      const float* src = a.x + (((long long)b * a.H + yy) * a.W + xx) * CIN;
#pragma unroll
      for (int ci = 0; ci < CIN; ++ci) c[ci] = __ldg(src + ci);
    }
  }
  return make_float4(c[0], c[1], c[2], c[3]);
}

template <int CIN>
__global__ void __launch_bounds__(DTHREADS, 2) conv_direct_f32(DirectArgs a) {
  __shared__ float4 halo[2][DHALO];
  const int n = blockIdx.y * DCOLS + DCPT * threadIdx.x;
  const bool live = n < a.Cout, pair = n + 1 < a.Cout;
  // the thread's weight: w[ky, kx, ci, n .. n + 1], 0 past Cout
  float w[9][CIN][DCPT];
#pragma unroll
  for (int tap = 0; tap < 9; ++tap)
#pragma unroll
    for (int ci = 0; ci < CIN; ++ci) {
      const float* src = a.w + (long long)(tap * CIN + ci) * a.Cout + n;
      w[tap][ci][0] = live ? __ldg(src) : 0.f;
      w[tap][ci][1] = pair ? __ldg(src + 1) : 0.f;
    }
  float bias[DCPT] = {0.f, 0.f};
  if (a.bias && !a.bias_bstride) {
    bias[0] = live ? bias_at(a, n) : 0.f;
    bias[1] = pair ? bias_at(a, n + 1) : 0.f;
  }

  // tiles blockIdx.x, + gridDim.x, ...: the next tile's halo is fetched into
  // registers before this tile's sums and stored to the other buffer after
  int tile = blockIdx.x, cur = 0;
  float4 next = direct_fetch<CIN>(a, tile);
  if (threadIdx.x < DHALO) halo[0][threadIdx.x] = next;
  __syncthreads();
  for (; tile < a.n_tiles; tile += gridDim.x, cur ^= 1) {
    next = direct_fetch<CIN>(a, tile + gridDim.x);
    const int row = tile / a.segs, b = row / a.H;
    const int x0 = (tile - row * a.segs) * DTW;
    if (a.bias && a.bias_bstride) {
      bias[0] = live ? bias_at(a, b * a.bias_bstride + n) : 0.f;
      bias[1] = pair ? bias_at(a, b * a.bias_bstride + n + 1) : 0.f;
    }
#pragma unroll 1
    for (int g = 0; g < DTW / DPG; ++g) {
      // acc[p][c]: pixel x0 + DPG g + p, channel n + c, summed tap-major
      // (ky, kx), channel inner: conv3x3_plain's order of K
      float acc[DPG][DCPT] = {};
#pragma unroll
      for (int ky = 0; ky < 3; ++ky) {
        float4 win[DPG + 2];  // halo row ky, the DPG + 2 columns the group reads
#pragma unroll
        for (int j = 0; j < DPG + 2; ++j) win[j] = halo[cur][ky * (DTW + 2) + DPG * g + j];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int ci = 0; ci < CIN; ++ci)
#pragma unroll
            for (int p = 0; p < DPG; ++p) {
              const float xv = reinterpret_cast<const float*>(&win[p + kx])[ci];
#pragma unroll
              for (int c = 0; c < DCPT; ++c)
                acc[p][c] = fmaf(xv, w[3 * ky + kx][ci][c], acc[p][c]);
            }
      }
      // bias, residual, SiLU in f32 (store_out's order); a warp's 32 lanes
      // write 64 consecutive channels of one pixel
#pragma unroll
      for (int p = 0; p < DPG; ++p) {
        const int x = x0 + DPG * g + p;
        if (!live || x >= a.W) continue;
        const long long o = ((long long)row * a.W + x) * a.Cout + n;
        float v[DCPT];
#pragma unroll
        for (int c = 0; c < DCPT; ++c) v[c] = acc[p][c] + bias[c];
        if (a.residual) {
          if (a.vec2) {
            const float2 r = *reinterpret_cast<const float2*>(a.residual + o);
            v[0] += r.x;
            v[1] += r.y;
          } else {
            v[0] += a.residual[o];
            if (pair) v[1] += a.residual[o + 1];
          }
        }
        if (a.act == 1) {
          v[0] = silu(v[0]);
          v[1] = silu(v[1]);
        }
        if (a.vec2) {
          *reinterpret_cast<float2*>(a.out + o) = make_float2(v[0], v[1]);
        } else {
          a.out[o] = v[0];
          if (pair) a.out[o + 1] = v[1];
        }
      }
    }
    if (threadIdx.x < DHALO) halo[cur ^ 1][threadIdx.x] = next;
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// bf16 wgmma kernel (the mainloop of wgmma.cuh): a block tile is 128 output
// pixels (tb images x th rows x tw columns) by BN output channels; K steps
// run over the 9 taps x ceil(Cin / 64) channel chunks, blockIdx.z taking a
// contiguous share of them. At BN = 8 the weight is K-major (8 rows) and the
// K steps are not split.
// ---------------------------------------------------------------------------
struct ConvWgmmaArgs {
  wg::Epilogue e;
  float* ws;                 // (splits, B*H*W, Cout) f32 partials when splits > 1
  const float* gn_scale;     // (B, Cin) GroupNorm prologue, or null
  const float* gn_shift;     // (B, Cin)
  int B, H, W, Cin;
  int tw, th, tb, ntx, nty;  // the pixel tile and the tiles across W and H
  int splits, gn_act;
  int bstages;                // K8 at Cout > 8: its weight ring's stages

  // the output pixel of tile row `row` in pixel tile (x0, y0, b0), or -1
  __device__ long long pixel(int x0, int y0, int b0, int row) const {
    const int per_img = th * tw;
    const int b = b0 + row / per_img;
    const int y = y0 + row % per_img / tw, x = x0 + row % tw;
    return (b < B && y < H && x < W) ? ((long long)b * H + y) * W + x : -1;
  }
};

template <int BN, int STAGES, int CTAS>
__global__ void __launch_bounds__(wg::THREADS, CTAS)
    conv_wgmma_bf16(const __grid_constant__ CUtensorMap tmap_x,
                    const __grid_constant__ CUtensorMap tmap_w, ConvWgmmaArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  wg::Ring<BN, STAGES> r;
  wg::ring_init(smem, r);
  int mt, nt;
  wg::block_tile((a.e.N + BN - 1) / BN, mt, nt);
  const int n0 = nt * BN;
  const int x0 = (mt % a.ntx) * a.tw;
  const int y0 = (mt / a.ntx % a.nty) * a.th;
  const int b0 = mt / (a.ntx * a.nty) * a.tb;
  const int ncc = (a.Cin + 63) / 64;
  int k0, k1;
  wg::split_range(9 * ncc, a.splits, blockIdx.z, k0, k1);
  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    if (threadIdx.x == 256) {
      const CUtensorMap* mx = &tmap_x;
      const CUtensorMap* mw = &tmap_w;
      wg::produce(r, k1 - k0, [&](int s, int it) {
        const int kb = k0 + it, tap = kb / ncc, c0 = (kb - tap * ncc) * 64;
        const int ky = tap / 3, kx = tap - 3 * ky;
        wg::tma_load_4d(r.a(s), mx, r.full(s), c0, x0 + kx - 1, y0 + ky - 1, b0);
        if constexpr (BN == 8) wg::tma_load_2d(r.b(s), mw, r.full(s), tap * a.Cin + c0, 0);
        else wg::load_b(r, s, mw, n0, tap * a.Cin + c0);
      });
    }
    return;
  }
  auto row_m = [&](int row) { return a.pixel(x0, y0, b0, row); };
  if constexpr (BN == 8) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    wg::consume_ss_n8(r, k1 - k0, wgi, acc);
    wg::store_n8(acc, wgi, row_m, a.e);
  } else {
    float acc[BN / 128][64];
#pragma unroll
    for (int j = 0; j < BN / 128; ++j)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[j][i] = 0.f;
    wg::consume_ss(r, k1 - k0, wgi, acc);
    wg::store_tile<BN>(acc, wgi, n0, row_m, a.e,
                       a.splits > 1 ? a.ws + blockIdx.z * a.e.M * a.e.N : nullptr);
  }
}

// ---------------------------------------------------------------------------
// K8, the bf16 wgmma conv with the GroupNorm prologue, at Cout > 8: a
// warp-specialised kernel on a persistent tile loop.
//
//   block tile  128 output pixels (8 wide x th rows x tb images, th * tb =
//               16) x BN = 128, 192 or 256 output channels; K steps run
//               channel chunk by channel chunk (step kb: chunk kb / 9, tap
//               kb % 9), a split taking a contiguous share of them;
//   warps       warpgroups 0 and 1 consume (64 output rows each: 8 rows of
//               8 pixels; one m64nBNk16 wgmma a 16-channel slice); warps
//               8-10 normalise; one thread of warp 11 loads the weight rows
//               of every step and every chunk's halo one chunk ahead of them
//               (384 threads, 168 registers: the m64n256 accumulators take
//               128);
//   halo ring   GN_HSTAGES stages, each one chunk's halo ((8 + 2) x (th +
//               2) x tb pixels x 64 channels) as 8 planes of 8 channels,
//               16 bytes a pixel (8 TMA boxes, no swizzle); a stage goes
//               TMA full -> normalised -> released: the normaliser turns it
//               into the bf16 operand in place (x * scale + shift, SiLU,
//               one bf16 rounding: gn_apply8, the arithmetic of K9's apply;
//               zero outside the image and past Cin, since GroupNorm(0) !=
//               0), four pixels a thread at a time so that their
//               special-function chains overlap, with each image's (scale,
//               shift) read from L2 once a chunk, while the consumers run
//               the previous chunk's taps;
//   A operand   straight from the normalised halo: with 8-pixel rows, the
//               64 x 16 A tile of tap (ky, kx) is 8 core matrices (an output
//               row's 8 pixels, 16 bytes each) 10 pixels apart along M and a
//               plane apart along K, so every tap is one no-swizzle
//               descriptor into the same halo, no copy;
//   B ring      a.bstages stages (as many as the shared memory holds) of the
//               (9 Cin, Cout) weight's 64 x BN rows, MN-major, 128-byte
//               swizzle, as in wgmma.cuh; one wgmma group kept in flight
//               across K steps (a stage is released one step late);
//   tiles       the grid (at most one block an SM) walks the (split, row
//               tile, column tile) items blockIdx.x, + gridDim.x, ...: the
//               producer and the normaliser run ahead into the next item
//               while the consumers store this one's tile (gn_store: the
//               tile's images known, no division a row) or its f32
//               partial (splitk_reduce sums the splits).
// ---------------------------------------------------------------------------
constexpr int GN_NORM_THREADS = 96, GN_PLANE_THREADS = GN_NORM_THREADS / 8;
constexpr int GN_THREADS = 256 + GN_NORM_THREADS + 32;
constexpr int GN_TW = 8, GN_BM = 128;
constexpr int GN_HSTAGES = 4, GN_MAX_BSTAGES = 8, GN_UNROLL = 4;

// the halo's pixels, and a plane of 8 channels of them padded to TMA's
// 128-byte destination alignment
__host__ __device__ __forceinline__ int gn_halo_pixels(int th, int tb) {
  return (GN_TW + 2) * (th + 2) * tb;
}
__host__ __device__ __forceinline__ int gn_plane(int th, int tb) {
  return (gn_halo_pixels(th, tb) * 16 + 127) / 128 * 128;
}
// [pad to 1024][B ring][halo ring][full_b, empty_b][full_h, ready_h, empty_h]
__host__ __device__ __forceinline__ int gn_smem_bytes(int bn, int th, int tb, int bstages) {
  return 1024 + bstages * wg::BK * bn * 2 + GN_HSTAGES * 8 * gn_plane(th, tb) +
         8 * (2 * bstages + 3 * GN_HSTAGES);
}
// the deepest weight ring that fits beside the halo ring
__host__ __forceinline__ int gn_bstages(int bn, int th, int tb) {
  int s = GN_MAX_BSTAGES;
  while (s > 2 && gn_smem_bytes(bn, th, tb, s) > 232448) --s;
  return s;
}

// the GroupNorm prologue on 8 bf16 channels c .. c + 7 of one pixel, with
// their (scale, shift) pairs: the arithmetic of the GroupNorm apply kernel
// (group_norm.cu gn_apply), so the normalised operand is the unfused pair's
// bit for bit
__device__ __forceinline__ uint4 gn_apply8(uint4 raw, const float2 (&ss)[8], int gn_act) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    f.x = fmaf(f.x, ss[2 * i].x, ss[2 * i].y);
    f.y = fmaf(f.y, ss[2 * i + 1].x, ss[2 * i + 1].y);
    if (gn_act) {
      f.x = silu(f.x);
      f.y = silu(f.y);
    }
    h[i] = __floats2bfloat162_rn(f.x, f.y);
  }
  return raw;
}

// (scale, shift) of image b's channels c .. c + 7 as pairs, from L2
__device__ __forceinline__ void gn_pairs(const ConvWgmmaArgs& a, int b, int c, float2 (&ss)[8]) {
  const long long o = (long long)b * a.Cin + c;
  const float4* sc = reinterpret_cast<const float4*>(a.gn_scale + o);
  const float4* sh = reinterpret_cast<const float4*>(a.gn_shift + o);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float4 m = __ldg(sc + q), d = __ldg(sh + q);
    ss[4 * q] = make_float2(m.x, d.x);
    ss[4 * q + 1] = make_float2(m.y, d.y);
    ss[4 * q + 2] = make_float2(m.z, d.z);
    ss[4 * q + 3] = make_float2(m.w, d.w);
  }
}

// one item of the persistent walk: its pixel tile, columns and K steps
struct GnItem {
  int x0, y0, b0, n0, k0, k1, z;
};

template <int BN>
__device__ __forceinline__ GnItem gn_item(const ConvWgmmaArgs& a, int item, int tiles,
                                          int n_tiles, int nk) {
  GnItem t;
  t.z = item / tiles;
  const int r = item - t.z * tiles, mt = r / n_tiles;
  t.n0 = (r - mt * n_tiles) * BN;
  t.x0 = (mt % a.ntx) * GN_TW;
  t.y0 = (mt / a.ntx % a.nty) * a.th;
  t.b0 = mt / (a.ntx * a.nty) * a.tb;
  wg::split_range(nk, a.splits, t.z, t.k0, t.k1);
  return t;
}

// v[i] += the 8 bf16 at p (16-byte aligned), read through the read-only
// path: the epilogue's inputs are never its outputs, so its loads need not
// wait for its stores
__device__ __forceinline__ void gn_add_bf16x8(float (&v)[8], const __nv_bfloat16* p) {
  uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] += f.x;
    v[2 * i + 1] += f.y;
  }
}

// a consumer warpgroup's m64nBN accumulators (tile rows row0 .. row0 + 63;
// accumulator i at row row0 + 16 warp + lane / 4 + 8 ((i >> 1) & 1), column
// 8 (i >> 2) + 2 (lane % 4) + (i & 1), as wg::store_tile has them) to the
// output with bias, residual and activation (epilogue8's arithmetic), or to
// the split's f32 partial tile. The tile's rows lie in known images, so a
// row's image, and with it the per-batch bias row, comes from its tile row;
// the bias and residual are read 8 columns at a time (16-byte aligned). The
// activation is a template argument: a runtime switch inlines every
// activation's code once an element, and at 128 elements a thread that
// code thrashed the instruction cache.
template <int BN, int ACT>
__device__ __forceinline__ void gn_store(const float (&acc)[BN / 2], int row0, const GnItem& t,
                                         const ConvWgmmaArgs& a, float* partial) {
  const wg::Epilogue& e = a.e;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int per_img = a.th * GN_TW;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + warp * 16 + lane / 4 + 8 * h;
    const int bi = row / per_img, r = row - bi * per_img;
    const int b = t.b0 + bi, y = t.y0 + r / GN_TW, x = t.x0 + r % GN_TW;
    const bool valid = b < a.B && y < a.H && x < a.W;
    const long long m = ((long long)b * a.H + y) * a.W + x;
    const long long brow = e.bias_bstride ? (long long)b * e.bias_bstride : 0;
#pragma unroll
    for (int g = 0; g < BN / 32; ++g) {
      float2 p[4];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int i = (4 * g + jj) * 4 + 2 * h;
        p[jj] = make_float2(acc[i], acc[i + 1]);
      }
      float v[8];
      wg::quad_transpose(p, v);
      const int n = t.n0 + 8 * (4 * g + (lane & 3));
      if (!valid || n >= e.N) continue;
      if (partial) {
        float4* dst = reinterpret_cast<float4*>(partial + m * e.N + n);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
        continue;
      }
      if (e.bias) {
        if (e.bias_dtype == 1) {
          gn_add_bf16x8(v, static_cast<const __nv_bfloat16*>(e.bias) + brow + n);
        } else {
          const float4* bf = reinterpret_cast<const float4*>(static_cast<const float*>(e.bias) +
                                                             brow + n);
          const float4 lo = __ldg(bf), hi = __ldg(bf + 1);
          v[0] += lo.x; v[1] += lo.y; v[2] += lo.z; v[3] += lo.w;
          v[4] += hi.x; v[5] += hi.y; v[6] += hi.z; v[7] += hi.w;
        }
      }
      if (e.residual) gn_add_bf16x8(v, e.residual + m * e.N + n);
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] = stv::act(v[q], ACT);
      stv::store_vec<__nv_bfloat16, 8>(e.out + m * e.N + n, v);
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(GN_THREADS, 1)
    conv_gn_wgmma_bf16(const __grid_constant__ CUtensorMap tmap_halo,
                       const __grid_constant__ CUtensorMap tmap_w, ConvWgmmaArgs a) {
  constexpr int B_BYTES = wg::BK * BN * 2;
  extern __shared__ __align__(16) uint8_t smem[];
  const int bstages = a.bstages;
  const uint32_t base = wg::smem_u32(smem);
  const uint32_t b_ring = (base + 1023u) & ~1023u;
  const int plane = gn_plane(a.th, a.tb), hstage = 8 * plane;
  const uint32_t h_ring = b_ring + bstages * B_BYTES;
  const uint32_t bars = h_ring + GN_HSTAGES * hstage;
  auto full_b = [&](int s) { return bars + 8 * s; };
  auto empty_b = [&](int s) { return bars + 8 * (bstages + s); };
  auto full_h = [&](int h) { return bars + 8 * (2 * bstages + h); };
  auto ready_h = [&](int h) { return full_h(GN_HSTAGES + h); };
  auto empty_h = [&](int h) { return full_h(2 * GN_HSTAGES + h); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < bstages; ++s) {
      wg::bar_init(full_b(s), 1);
      wg::bar_init(empty_b(s), 2);
    }
    for (int h = 0; h < GN_HSTAGES; ++h) {
      wg::bar_init(full_h(h), 1);
      wg::bar_init(ready_h(h), GN_NORM_THREADS);
      wg::bar_init(empty_h(h), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int nk = 9 * ((a.Cin + 63) / 64);
  const int n_tiles = (a.e.N + BN - 1) / BN;
  const int tiles = a.ntx * a.nty * ((a.B + a.tb - 1) / a.tb) * n_tiles;
  const int items = tiles * a.splits;
  const int hw = GN_TW + 2, hh = a.th + 2;
  const int wgi = threadIdx.x / 128;
  if (threadIdx.x >= 256 + GN_NORM_THREADS) {
    // the producer (one thread): the weight rows of every step, and every
    // chunk's halo one chunk ahead of them, so a halo stage is loaded and
    // normalised while the consumers run the chunk before
    if (threadIdx.x == 256 + GN_NORM_THREADS) {
      int step = 0, loads = 0, hi = blockIdx.x;
      GnItem hu = gn_item<BN>(a, hi, tiles, n_tiles, nk);
      int hcc = hu.k0 / 9;
      auto halo_next = [&] {  // the next chunk's halo in the walk's order
        if (hi >= items) return;
        const int h = loads++ % GN_HSTAGES;
        wg::bar_wait(empty_h(h), (((loads - 1) / GN_HSTAGES) & 1) ^ 1);
        wg::bar_expect_tx(full_h(h), 16 * gn_halo_pixels(a.th, a.tb) * 8);
#pragma unroll 1
        for (int j = 0; j < 8; ++j)
          wg::tma_load_4d(h_ring + h * hstage + j * plane, &tmap_halo, full_h(h),
                          hcc * 64 + 8 * j, hu.x0 - 1, hu.y0 - 1, hu.b0);
        if (++hcc > (hu.k1 - 1) / 9 && (hi += gridDim.x) < items) {
          hu = gn_item<BN>(a, hi, tiles, n_tiles, nk);
          hcc = hu.k0 / 9;
        }
      };
      halo_next();
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const GnItem t = gn_item<BN>(a, i, tiles, n_tiles, nk);
        for (int kb = t.k0; kb < t.k1; ++kb, ++step) {
          const int cc = kb / 9, tap = kb - 9 * cc, s = step % bstages;
          if (kb == t.k0 || tap == 0) halo_next();
          wg::bar_wait(empty_b(s), ((step / bstages) & 1) ^ 1);
          wg::bar_expect_tx(full_b(s), B_BYTES);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            wg::tma_load_2d(b_ring + s * B_BYTES + j * wg::BOX_BYTES, &tmap_w, full_b(s),
                            t.n0 + 64 * j, tap * a.Cin + cc * 64);
        }
      }
    }
  } else if (wgi == 2) {
    // the normaliser: thread t takes channel plane t / 12 and every 12th
    // halo pixel from t % 12, GN_UNROLL pixels at a time; its 8 channels'
    // (scale, shift) for the tile's (at most two) images stay in registers
    // for the chunk
    const int tn = threadIdx.x - 256, t12 = tn % GN_PLANE_THREADS, j = tn / GN_PLANE_THREADS;
    const int np = gn_halo_pixels(a.th, a.tb);
    int loads = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const GnItem t = gn_item<BN>(a, i, tiles, n_tiles, nk);
      for (int cc = t.k0 / 9; cc <= (t.k1 - 1) / 9; ++cc, ++loads) {
        const int h = loads % GN_HSTAGES;
        const int c = cc * 64 + 8 * j;
        float2 s0[8], s1[8];
        const bool live = c < a.Cin;
        if (live && t.b0 < a.B) gn_pairs(a, t.b0, c, s0);
        if (live && a.tb > 1 && t.b0 + 1 < a.B) gn_pairs(a, t.b0 + 1, c, s1);
        wg::bar_wait(full_h(h), (loads / GN_HSTAGES) & 1);
        uint8_t* pl = smem + (h_ring - base) + h * hstage + j * plane;
        int hb = 0, hy = t12 / hw, hx = t12 % hw;
        for (int p = t12; p < np; p += GN_UNROLL * GN_PLANE_THREADS) {
          uint4 v[GN_UNROLL];
          bool in[GN_UNROLL], second[GN_UNROLL];
#pragma unroll
          for (int u = 0; u < GN_UNROLL; ++u) {
            const int q = p + u * GN_PLANE_THREADS;
            const int b = t.b0 + hb, y = t.y0 - 1 + hy, x = t.x0 - 1 + hx;
            in[u] = q < np && live && b < a.B && y >= 0 && y < a.H && x >= 0 && x < a.W;
            second[u] = hb > 0;
            v[u] = q < np ? *reinterpret_cast<const uint4*>(pl + q * 16) : make_uint4(0, 0, 0, 0);
            for (hx += GN_PLANE_THREADS; hx >= hw;) {
              hx -= hw;
              if (++hy == hh) hy = 0, ++hb;
            }
          }
#pragma unroll
          for (int u = 0; u < GN_UNROLL; ++u) {
            float2 ss[8];
#pragma unroll
            for (int q = 0; q < 8; ++q) ss[q] = second[u] ? s1[q] : s0[q];
            const uint4 n = gn_apply8(v[u], ss, a.gn_act);
            v[u] = in[u] ? n : make_uint4(0u, 0u, 0u, 0u);
          }
#pragma unroll
          for (int u = 0; u < GN_UNROLL; ++u) {
            const int q = p + u * GN_PLANE_THREADS;
            if (q < np) *reinterpret_cast<uint4*>(pl + q * 16) = v[u];
          }
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wg::bar_arrive(ready_h(h));
      }
    }
  } else {
    // the consumers: warpgroup wgi computes tile rows 64 wgi .. 64 wgi + 63;
    // the halo pixel of its first output row at tap (0, 0)
    const int per_img = a.th * GN_TW, r0 = wgi * 64;
    const int hp0 = r0 / per_img * hw * hh + r0 % per_img / GN_TW * hw;
    const bool leader = threadIdx.x % 128 == 0;
    int step = 0, loads = 0;
    float acc[BN / 2];
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const GnItem t = gn_item<BN>(a, i, tiles, n_tiles, nk);
#pragma unroll
      for (int q = 0; q < BN / 2; ++q) acc[q] = 0.f;
      int h = 0;
      for (int kb = t.k0; kb < t.k1; ++kb, ++step) {
        const int cc = kb / 9, tap = kb - 9 * cc;
        const int prev_h = h;
        if (kb == t.k0 || tap == 0) {  // a new chunk: wait for its normalised halo
          h = loads % GN_HSTAGES;
          wg::bar_wait(ready_h(h), (loads / GN_HSTAGES) & 1);
          ++loads;
        }
        const int s = step % bstages;
        wg::bar_wait(full_b(s), (step / bstages) & 1);
        const uint32_t a_tap =
            h_ring + h * hstage + (hp0 + (tap / 3) * hw + tap % 3) * 16;
        const uint32_t b_tile = b_ring + s * B_BYTES;
        wg::fence_acc(acc);
        wg::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < wg::BK / 16; ++kk)
          wg::wgmma_ss_wide<BN>(acc, wg::desc_plain(a_tap + 2 * kk * plane, plane, hw * 16),
                                wg::desc_b(b_tile, 0, kk));
        wg::wgmma_commit();
        wg::fence_acc(acc);
        if (kb > t.k0) {
          // the previous step's wgmmas are done: release its weight stage,
          // and its halo where it was its chunk's last
          wg::wgmma_wait<1>();
          if (leader) {
            wg::bar_arrive(empty_b((step - 1) % bstages));
            if (tap == 0) wg::bar_arrive(empty_h(prev_h));
          }
        }
      }
      wg::wgmma_wait<0>();
      wg::fence_acc(acc);
      if (leader) {
        wg::bar_arrive(empty_b((step - 1) % bstages));
        wg::bar_arrive(empty_h(h));
      }
      // the activation a template argument: its code once, not once an element
      float* partial = a.splits > 1 ? a.ws + t.z * a.e.M * a.e.N : nullptr;
      if (a.e.act == 1)
        gn_store<BN, 1>(acc, r0, t, a, partial);
      else
        gn_store<BN, 0>(acc, r0, t, a, partial);
    }
  }
}

// ---------------------------------------------------------------------------
// K8's 8-column form (Cout <= 8: the UNet's norm_out + SiLU + conv_out): the
// block tile is 128 pixels x 8 columns, the weight K-major with rows past
// Cout zero (as conv_wgmma_bf16<8>). The producer loads the tile's halo once
// per 64-channel chunk (128-byte swizzle) and the weight rows of each step;
// the consumers normalise the halo in place (scale / shift staged once per
// block) and each of the 9 taps reads its A fragments from the halo at the
// tap's offset (ldmatrix) for a register-A wgmma.
// ---------------------------------------------------------------------------
constexpr int N8_B_STAGES = 4, N8_HALO_STAGES = 2;
constexpr int N8_B_BYTES = wg::BK * 8 * 2;

// the halo ring stage of the tile, rounded to the 1024-byte swizzle atom
__host__ __device__ __forceinline__ int n8_halo_bytes(int tw, int th, int tb) {
  return (tw + 2) * (th + 2) * tb * 128;
}
__host__ __device__ __forceinline__ int n8_halo_stride(int tw, int th, int tb) {
  return (n8_halo_bytes(tw, th, tb) + 1023) / 1024 * 1024;
}
// [pad to 1024][B ring][halo ring][fullB, emptyB, fullH, emptyH][(scale, shift)]
__host__ __device__ __forceinline__ int n8_smem_bytes(int tw, int th, int tb, int cin) {
  return 1024 + N8_B_STAGES * N8_B_BYTES + N8_HALO_STAGES * n8_halo_stride(tw, th, tb) +
         16 * (N8_B_STAGES + N8_HALO_STAGES) + tb * cin * 8;
}

__global__ void __launch_bounds__(wg::THREADS, 1)
    conv_gn_wgmma_bf16_n8(const __grid_constant__ CUtensorMap tmap_halo,
                          const __grid_constant__ CUtensorMap tmap_w, ConvWgmmaArgs a) {
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = wg::smem_u32(smem);
  const uint32_t b_ring = (base + 1023u) & ~1023u;
  const int halo_stride = n8_halo_stride(a.tw, a.th, a.tb);
  const uint32_t h_ring = b_ring + N8_B_STAGES * N8_B_BYTES;
  const uint32_t bars = h_ring + N8_HALO_STAGES * halo_stride;
  auto full_b = [&](int s) { return bars + 8 * s; };
  auto empty_b = [&](int s) { return bars + 8 * (N8_B_STAGES + s); };
  auto full_h = [&](int h) { return bars + 8 * (2 * N8_B_STAGES + h); };
  auto empty_h = [&](int h) { return bars + 8 * (2 * N8_B_STAGES + N8_HALO_STAGES + h); };
  uint8_t* halo_ptr = smem + (h_ring - base);
  float2* gss = reinterpret_cast<float2*>(smem + (bars + 16 * (N8_B_STAGES + N8_HALO_STAGES) -
                                                   base));
  if (threadIdx.x == 0) {
    for (int s = 0; s < N8_B_STAGES; ++s) {
      wg::bar_init(full_b(s), 1);
      wg::bar_init(empty_b(s), 2);
    }
    for (int h = 0; h < N8_HALO_STAGES; ++h) {
      wg::bar_init(full_h(h), 1);
      wg::bar_init(empty_h(h), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int mt = static_cast<int>(blockIdx.x);
  const int x0 = (mt % a.ntx) * a.tw;
  const int y0 = (mt / a.ntx % a.nty) * a.th;
  const int b0 = mt / (a.ntx * a.nty) * a.tb;
  const int nk = 9 * ((a.Cin + 63) / 64);
  const int wgi = threadIdx.x / 128;
  const int per_img = a.th * a.tw;
  const int hw = a.tw + 2, hh = a.th + 2;
  if (wgi == 2) {
    if (threadIdx.x == 256) {
      const CUtensorMap* mh = &tmap_halo;
      const CUtensorMap* mw = &tmap_w;
      const uint32_t halo_tx = n8_halo_bytes(a.tw, a.th, a.tb);
      for (int it = 0, loads = 0; it < nk; ++it) {
        const int cc = it / 9, tap = it - 9 * cc;
        if (tap == 0) {  // a new channel chunk: its halo
          const int h = loads % N8_HALO_STAGES;
          wg::bar_wait(empty_h(h), ((loads / N8_HALO_STAGES) & 1) ^ 1);
          wg::bar_expect_tx(full_h(h), halo_tx);
          wg::tma_load_4d(h_ring + h * halo_stride, mh, full_h(h), cc * 64, x0 - 1, y0 - 1, b0);
          ++loads;
        }
        const int s = it % N8_B_STAGES;
        wg::bar_wait(empty_b(s), ((it / N8_B_STAGES) & 1) ^ 1);
        wg::bar_expect_tx(full_b(s), N8_B_BYTES);
        wg::tma_load_2d(b_ring + s * N8_B_BYTES, mw, full_b(s), tap * a.Cin + cc * 64, 0);
      }
    }
  } else {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    // scale / shift of the tile's images as (scale, shift) pairs
    for (int i = threadIdx.x; i < a.tb * a.Cin; i += 256) {
      const int bi = i / a.Cin, c = i - bi * a.Cin;
      const long long o = (long long)(b0 + bi) * a.Cin + c;
      gss[i] = b0 + bi < a.B ? make_float2(a.gn_scale[o], a.gn_shift[o]) : make_float2(0.f, 0.f);
    }
    wg::consumers_sync();
    const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
    // the output pixel (tile row) this lane addresses for ldmatrix, as a
    // halo pixel index at tap (0, 0)
    const int lrow = wgi * 64 + warp * 16 + lane % 16;
    const int lhp = (lrow / per_img * hh + lrow % per_img / a.tw) * hw + lrow % a.tw;
    // normalise halo stage h (channel chunk cc) in place. Consumer thread t
    // takes the 8-channel piece t % 8 of every 32nd halo pixel from t / 8:
    // its channels stay fixed, so their (scale, shift) pairs sit in
    // registers while the image does not change, and its pixel's (image,
    // row, column) in the halo advances without a division.
    const int c8 = threadIdx.x & 7;
    auto normalise = [&](int h, int cc) {
      uint8_t* halo = halo_ptr + h * halo_stride;
      const int c = cc * 64 + c8 * 8;
      float2 ss[8];
      int hb = 0, ry = 0, rx = threadIdx.x >> 3, loaded = -1;
      auto wrap = [&] {
        while (rx >= hw) {
          rx -= hw;
          if (++ry == hh) ry = 0, ++hb;
        }
      };
      wrap();
      for (int hp = threadIdx.x >> 3; hb < a.tb; hp += 32) {
        const int y = y0 - 1 + ry, x = x0 - 1 + rx;
        uint4* piece = reinterpret_cast<uint4*>(halo + hp * 128 + ((c8 ^ (hp & 7)) << 4));
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (b0 + hb < a.B && y >= 0 && y < a.H && x >= 0 && x < a.W && c < a.Cin) {
          if (loaded != hb) {
            const float4* src = reinterpret_cast<const float4*>(gss + hb * a.Cin + c);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float4 t = src[i];
              ss[2 * i] = make_float2(t.x, t.y);
              ss[2 * i + 1] = make_float2(t.z, t.w);
            }
            loaded = hb;
          }
          v = gn_apply8(*piece, ss, a.gn_act);
        }
        *piece = v;
        rx += 32;
        wrap();
      }
    };
    int loads = 0, h = 0;
    // step it's A fragments from the normalised halo, at the tap's offset;
    // a new chunk's halo is waited for and normalised first, and a chunk's
    // halo is released after its last tap's loads
    auto fragments = [&](int it, uint32_t(&f)[4][4]) {
      const int cc = it / 9, tap = it - 9 * cc;
      if (tap == 0) {
        h = loads % N8_HALO_STAGES;
        wg::bar_wait(full_h(h), (loads / N8_HALO_STAGES) & 1);
        normalise(h, cc);
        wg::consumers_sync();
        ++loads;
      }
      const int ky = tap / 3, kx = tap - 3 * ky;
      const int hp = lhp + ky * hw + kx;
      const uint32_t row = h_ring + h * halo_stride + hp * 128;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::ldmatrix_x4(row + (((2 * kk + lane / 16) ^ (hp & 7)) << 4), f[kk]);
      if (tap == 8) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        wg::bar_arrive(empty_h(h));
      }
    };
    auto issue = [&](int it, uint32_t(&f)[4][4]) {
      const int s = it % N8_B_STAGES;
      wg::bar_wait(full_b(s), (it / N8_B_STAGES) & 1);
      wg::fence_acc(acc);
      wg::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wg::wgmma_rs_n8(acc, f[kk],
                        wg::desc_sw128(b_ring + s * N8_B_BYTES + kk * 32, 16, wg::SW_ROWS8));
      wg::wgmma_commit();
      wg::fence_acc(acc);
    };
    auto retire = [&](int it, uint32_t(&f)[4][4]) {
      wg::wgmma_wait<0>();
      wg::fence_acc(acc);
      wg::fence_frag(f);
      if (threadIdx.x % 128 == 0 && it + N8_B_STAGES < nk)
        wg::bar_arrive(empty_b(it % N8_B_STAGES));
    };
    // the next step's fragments load while this step's wgmmas run
    uint32_t fa[4][4], fb[4][4];
    fragments(0, fa);
    for (int it = 0; it < nk; it += 2) {
      issue(it, fa);
      if (it + 1 < nk) fragments(it + 1, fb);
      retire(it, fa);
      if (it + 1 >= nk) break;
      issue(it + 1, fb);
      if (it + 2 < nk) fragments(it + 2, fa);
      retire(it + 1, fb);
    }
    auto row_m = [&](int row) { return a.pixel(x0, y0, b0, row); };
    wg::store_n8(acc, wgi, row_m, a.e);
  }
}

// ---------------------------------------------------------------------------
// f32 wgmma kernel, 3xTF32: the block tile is 128 output pixels (the bf16
// kernel's pixel tile) by BN output channels (8 for Cout <= 8, else 128);
// K steps run over the 9 taps x ceil(Cin / 32) channel chunks (32 f32 = one
// 128-byte swizzle row). A stage is the 4-D box of x at the tap's offset
// (16 KB) and the two (BN x 32) boxes of the weight's big and small parts.
// Each consumer warpgroup loads its 64 rows' A fragments from the stage
// (ldmatrix: a 32-bit word is a pair of b16), splits each value a into
// big = a with its low 13 mantissa bits cleared (exact in tf32) and small =
// a - big (exact in f32), and runs a_big w_big + a_big w_small +
// a_small w_big as register-A tf32 wgmmas (k = 8) into a stage's f32 sum,
// which f32 adds then carry into the running sum.
// ---------------------------------------------------------------------------
constexpr int TF_STAGES = 4;
constexpr int TF_A_BYTES = wg::BM * 128;  // 128 pixels x 32 channels

template <int BN>
__host__ __device__ constexpr int tf_stage_bytes() { return TF_A_BYTES + 2 * BN * 128; }
template <int BN>
__host__ __device__ constexpr int tf_smem_bytes() { return 1024 + TF_STAGES * tf_stage_bytes<BN>() + 16 * TF_STAGES; }

struct ConvTf32Args {
  const void* bias;          // (Cout,) or (B, Cout) of bias_dtype, or null
  long long bias_bstride;    // 0: one bias; Cout: per batch
  const float* residual;     // (B, H, W, Cout) or null
  float* out;                // (B, H, W, Cout)
  int B, H, W, Cin, Cout, bias_dtype, act;
  int tw, th, tb, ntx, nty, n_tiles;
};

template <int BN>
__global__ void __launch_bounds__(wg::THREADS, 1)
    conv_wgmma_tf32x3(const __grid_constant__ CUtensorMap tmap_x,
                      const __grid_constant__ CUtensorMap tmap_big,
                      const __grid_constant__ CUtensorMap tmap_small, ConvTf32Args a) {
  constexpr int STAGE = tf_stage_bytes<BN>();
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t ring = (wg::smem_u32(smem) + 1023u) & ~1023u;
  auto full = [&](int s) { return ring + TF_STAGES * STAGE + 8 * s; };
  auto empty = [&](int s) { return full(TF_STAGES + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < TF_STAGES; ++s) {
      wg::bar_init(full(s), 1);
      wg::bar_init(empty(s), 2);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  int mt, nt;
  wg::block_tile(a.n_tiles, mt, nt);
  const int n0 = nt * BN;
  const int x0 = (mt % a.ntx) * a.tw;
  const int y0 = (mt / a.ntx % a.nty) * a.th;
  const int b0 = mt / (a.ntx * a.nty) * a.tb;
  const int ncc = (a.Cin + 31) / 32;
  const int nk = 9 * ncc;
  const int wgi = threadIdx.x / 128;
  if (wgi == 2) {
    if (threadIdx.x == 256) {
      for (int it = 0; it < nk; ++it) {
        const int s = it % TF_STAGES, tap = it / ncc, c0 = (it - tap * ncc) * 32;
        const int ky = tap / 3, kx = tap - 3 * ky;
        const uint32_t st = ring + s * STAGE;
        wg::bar_wait(empty(s), ((it / TF_STAGES) & 1) ^ 1);
        wg::bar_expect_tx(full(s), STAGE);
        wg::tma_load_4d(st, &tmap_x, full(s), c0, x0 + kx - 1, y0 + ky - 1, b0);
        wg::tma_load_2d(st + TF_A_BYTES, &tmap_big, full(s), tap * a.Cin + c0, n0);
        wg::tma_load_2d(st + TF_A_BYTES + BN * 128, &tmap_small, full(s), tap * a.Cin + c0, n0);
      }
    }
    return;
  }

  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  // the tile row whose 16-byte pieces this lane addresses for ldmatrix
  const int lrow = wgi * 64 + warp * 16 + lane % 16;
  // part: one stage's sum on the tensor cores; acc: the sum over stages in
  // f32 adds, rounded to nearest (over K = 1152 .. 4608 the tensor cores'
  // own accumulation costs digits)
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
  for (int it = 0; it < nk; ++it) {
    const int s = it % TF_STAGES;
    const uint32_t st = ring + s * STAGE, wb = st + TF_A_BYTES;
    wg::bar_wait(full(s), (it / TF_STAGES) & 1);
    wg::tf32x3_stage(st, wb, wb + BN * 128, lrow, 1.f, part);
    if (threadIdx.x % 128 == 0) wg::bar_arrive(empty(s));
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  }

  // epilogue: accumulator i lies at tile row 16 warp + lane / 4 + 8 ((i >> 1)
  // & 1) and column 8 (i >> 2) + 2 (lane % 4) + (i & 1); bias, residual,
  // SiLU in f32; columns at or past Cout (the zero rows of the padded
  // weight) are not stored
  const int per_img = a.th * a.tw;
  const bool pairs = a.Cout % 2 == 0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wgi * 64 + warp * 16 + lane / 4 + 8 * r;
    const int b = b0 + row / per_img;
    const int y = y0 + row % per_img / a.tw, x = x0 + row % a.tw;
    if (b >= a.B || y >= a.H || x >= a.W) continue;
    const long long m = ((long long)b * a.H + y) * a.W + x;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int n = n0 + 8 * j + 2 * (lane % 4);
      if (n >= a.Cout) continue;
      float v[2] = {acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]};
      const int cnt = n + 1 < a.Cout ? 2 : 1;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if (e == cnt) break;
        if (a.bias) {
          const long long o = (long long)b * a.bias_bstride + n + e;
          v[e] += a.bias_dtype == 1
                      ? __bfloat162float(static_cast<const __nv_bfloat16*>(a.bias)[o])
                      : static_cast<const float*>(a.bias)[o];
        }
        if (a.residual) v[e] += a.residual[m * a.Cout + n + e];
        if (a.act == 1) v[e] = silu(v[e]);
      }
      float* dst = a.out + m * a.Cout + n;
      if (pairs) {
        *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
      } else {
        dst[0] = v[0];
        if (cnt == 2) dst[1] = v[1];
      }
    }
  }
}

template <class Kernel>
int launch_conv(Kernel kernel, const CUtensorMap& tx, const CUtensorMap& tw,
                const ConvWgmmaArgs& a, dim3 grid, int threads, int smem, bool& attr_set,
                cudaStream_t stream) {
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (!attr_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, 232448);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  kernel<<<grid, threads, smem, stream>>>(tx, tw, a);
  return (int)cudaGetLastError();
}

}  // namespace

// The f32 scalar conv (the convs the tf32 kernel does not take): x (B, H,
// W, Cin), w (3, 3, Cin, Cout), residual and out (B, H, W, Cout), f32.
// act: 0 = none, 1 = SiLU. bias (of bias_dtype: 0 f32, 1 bf16; (Cout,) with
// bias_bstride 0, or (B, Cout) with bias_bstride Cout) and residual may be
// null. gn_scale / gn_shift: (B, Cin) f32 GroupNorm prologue, or null;
// gn_act: 1 = SiLU after it. Returns a cudaError_t (0 on success).
extern "C" int st_conv3x3(const float* x, const float* w, const void* bias, int bias_dtype,
                          long long bias_bstride, const float* residual, float* out,
                          int B, int H, int W, int Cin, int Cout, int act,
                          const float* gn_scale, const float* gn_shift, int gn_act,
                          void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const ConvArgs a{x, w, bias, bias_bstride, bias_dtype, residual, out, B, H, W, Cin, Cout, act,
                   gn_scale, gn_shift, gn_act};
  const long long M = (long long)B * H * W;
  const dim3 grid((unsigned)((M + CBM - 1) / CBM), (Cout + CBN - 1) / CBN);
  conv_scalar<<<grid, CTHREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The f32 direct conv for Cin <= 4: x (B, H, W, Cin), w (3, 3, Cin, Cout),
// residual and out (B, H, W, Cout), f32, any alignment; bias and act as
// st_conv3x3. The grid: up to two blocks an SM walking the row segments,
// one column of blocks per 512 output channels. Returns a cudaError_t.
extern "C" int st_conv3x3_direct(const float* x, const float* w, const void* bias, int bias_dtype,
                                 long long bias_bstride, const float* residual, float* out,
                                 int B, int H, int W, int Cin, int Cout, int act,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long segs = (W + DTW - 1) / DTW, tiles = (long long)B * H * segs;
  if (B <= 0 || H <= 0 || W <= 0 || Cin < 1 || Cin > DIRECT_MAX_CIN || Cout <= 0 || act < 0 ||
      act > 1 || bias_dtype < 0 || bias_dtype > 1 || tiles > 0x7FFFFFFFLL ||
      (Cout + DCOLS - 1) / DCOLS > 65535)
    return (int)cudaErrorInvalidValue;
  static int sms = 0;
  if (!sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const auto a8 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 8 == 0; };
  const DirectArgs a{x, w, bias, bias_bstride, residual, out, B, H, W, Cout, bias_dtype, act,
                     (int)segs, (int)tiles, Cout % 2 == 0 && a8(out) && a8(residual)};
  const dim3 grid((unsigned)(tiles < 2LL * sms ? tiles : 2LL * sms), (Cout + DCOLS - 1) / DCOLS);
  switch (Cin) {
    case 1: conv_direct_f32<1><<<grid, DTHREADS, 0, stream>>>(a); break;
    case 2: conv_direct_f32<2><<<grid, DTHREADS, 0, stream>>>(a); break;
    case 3: conv_direct_f32<3><<<grid, DTHREADS, 0, stream>>>(a); break;
    default: conv_direct_f32<4><<<grid, DTHREADS, 0, stream>>>(a); break;
  }
  return (int)cudaGetLastError();
}

// The bf16 wgmma conv: x (B, H, W, Cin), residual and out (B, H, W, Cout),
// contiguous bf16 with Cin % 8 == 0 and x, w 16-byte aligned; w the (3, 3,
// Cin, Cout) weight, or at bn = 8 (Cout <= 8) the K-major (8, 9 * Cin)
// weight with rows past Cout zero; bias of bias_dtype with bias_bstride as
// st_conv3x3; gn_scale / gn_shift (B, Cin) f32 for the GroupNorm prologue
// (they and the bias 16-byte aligned at bn > 8) or null. The plan: the
// pixel tile tw x th x tb (= 128; with the prologue at bn > 8, 8 wide and
// th a multiple of 8), the block tile's width bn (Cout % 8 == 0 and
// 16-byte aligned residual and out: 128 or 256, with the prologue 128, 192
// or 256; 8 for Cout <= 8), the K split (1 <= splits <= 9 * ceil(Cin / 64); 1 at bn = 8), with ws a
// (splits, B*H*W, Cout) f32 workspace when splits > 1, and with the
// prologue at bn > 8 the persistent grid (blocks, each walking the items
// blockIdx.x, + grid, ...). Returns a cudaError_t.
extern "C" int st_conv3x3_wgmma(const void* x, const void* w, const void* bias, int bias_dtype,
                                long long bias_bstride, const void* residual, void* out,
                                float* ws, int B, int H, int W, int Cin, int Cout, int act,
                                const float* gn_scale, const float* gn_shift, int gn_act, int tw,
                                int th, int tb, int bn, int splits, int grid,
                                void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool gn = gn_scale != nullptr, ws_gn = gn && bn != 8;
  const int nk = 9 * ((Cin + 63) / 64);
  // the epilogue's 16-byte vectors at bn >= 128; element stores at bn 8
  const uintptr_t out_align = bn == 8 ? 2 : 16;
  const auto a16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const bool aligned = a16(x) && a16(w) && reinterpret_cast<uintptr_t>(residual) % out_align == 0 &&
                       reinterpret_cast<uintptr_t>(out) % out_align == 0 &&
                       (!ws_gn || (a16(gn_scale) && a16(gn_shift) && a16(bias)));
  const bool width_ok = bn == 8    ? Cout <= 8 && splits == 1
                        : ws_gn    ? Cout % 8 == 0 && (bn == 128 || bn == 192 || bn == 256)
                                   : Cout % 8 == 0 && !gn && (bn == 128 || bn == 256);
  const bool tile_ok = ws_gn ? tw == GN_TW && th * tb == GN_BM / GN_TW && th % 8 == 0
                             : tw * th * tb == wg::BM && (!gn || (tw * th) % 16 == 0);
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || Cin % 8 || !width_ok || !aligned ||
      act < 0 || act > 1 || gn_act < 0 || gn_act > 1 || bias_dtype < 0 || bias_dtype > 1 ||
      (gn && !gn_shift) || tw < 1 || th < 1 || tb < 1 || tw > 256 || th > 256 || tb > 256 ||
      !tile_ok || splits < 1 || splits > nk || (splits > 1 && !ws) || (ws_gn && grid < 1))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tx, twm;
  const uint64_t xdims[4] = {(uint64_t)Cin, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t xstrides[3] = {(uint64_t)Cin * 2, (uint64_t)W * Cin * 2,
                                (uint64_t)H * W * Cin * 2};
  // the A box: the pixel tile, or with the prologue its halo; at bn > 8 the
  // halo's 8-channel planes, unswizzled
  const uint32_t xbox[4] = {ws_gn ? 8u : 64u, (uint32_t)(tw + (gn ? 2 : 0)),
                            (uint32_t)(th + (gn ? 2 : 0)), (uint32_t)tb};
  // B: the (9 * Cin, Cout) weight in 64-column boxes, or at bn = 8 the
  // K-major (8, 9 * Cin) one in boxes of 64 k x 8 rows
  const uint64_t w8_dims[2] = {9ull * Cin, 8}, w8_strides[1] = {9ull * Cin * 2};
  const uint32_t w8_box[2] = {64, 8};
  if (!wg::make_map(&tx, x, 4, xdims, xstrides, xbox, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    ws_gn ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B) ||
      !(bn == 8 ? wg::make_map(&twm, w, 2, w8_dims, w8_strides, w8_box)
                : wg::make_b_map(&twm, w, 9LL * Cin, Cout)))
    return (int)cudaErrorInvalidValue;
  const long long M = (long long)B * H * W;
  const wg::Epilogue e{bias, bias_bstride, (long long)H * W,
                       static_cast<const __nv_bfloat16*>(residual),
                       static_cast<__nv_bfloat16*>(out), M, Cout, bias_dtype, act};
  const int ntx = (W + tw - 1) / tw, nty = (H + th - 1) / th;
  const long long mt = (long long)ntx * nty * ((B + tb - 1) / tb);
  const long long tiles = mt * ((Cout + bn - 1) / bn);
  if (tiles * splits > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const int bstages = ws_gn ? gn_bstages(bn, th, tb) : 0;
  const ConvWgmmaArgs a{e, ws, gn_scale, gn_shift, B, H, W, Cin, tw, th, tb, ntx, nty,
                        splits, gn_act, bstages};
  const dim3 tile_grid((unsigned)tiles, 1, splits);
  const dim3 walk((unsigned)(grid < tiles * splits ? grid : tiles * splits));
  int code;
  if (ws_gn) {
    const int smem = gn_smem_bytes(bn, th, tb, bstages);
    if (bn == 128) {
      static bool set = false;
      code = launch_conv(conv_gn_wgmma_bf16<128>, tx, twm, a, walk, GN_THREADS, smem, set, stream);
    } else if (bn == 192) {
      static bool set = false;
      code = launch_conv(conv_gn_wgmma_bf16<192>, tx, twm, a, walk, GN_THREADS, smem, set, stream);
    } else {
      static bool set = false;
      code = launch_conv(conv_gn_wgmma_bf16<256>, tx, twm, a, walk, GN_THREADS, smem, set, stream);
    }
  } else if (gn) {
    static bool set = false;
    code = launch_conv(conv_gn_wgmma_bf16_n8, tx, twm, a, tile_grid, wg::THREADS,
                       n8_smem_bytes(tw, th, tb, Cin), set, stream);
  } else if (bn == 8) {
    static bool set = false;
    code = launch_conv(conv_wgmma_bf16<8, 6, 2>, tx, twm, a, tile_grid, wg::THREADS,
                       wg::Ring<8, 6>::bytes(), set, stream);
  } else if (bn == 256) {
    static bool set = false;
    code = launch_conv(conv_wgmma_bf16<256, 4, 1>, tx, twm, a, tile_grid, wg::THREADS,
                       wg::Ring<256, 4>::bytes(), set, stream);
  } else {
    static bool set = false;
    code = launch_conv(conv_wgmma_bf16<128, 3, 2>, tx, twm, a, tile_grid, wg::THREADS,
                       wg::Ring<128, 3>::bytes(), set, stream);
  }
  if (code != 0 || splits == 1) return code;
  return wg::launch_reduce(ws, splits, e, stream);
}

// The f32 3xTF32 wgmma conv: x (B, H, W, Cin) f32 with Cin % 8 == 0;
// w_big / w_small the (cout_pad, 9 * Cin) K-major f32 parts of the weight
// (kernels/conv_direct.py tf32_split: big + small == w, big exact in tf32,
// rows past Cout zero; cout_pad % 8 == 0); bias of bias_dtype with
// bias_bstride as st_conv3x3; residual and out (B, H, W, Cout) f32. Bases
// of x and the weight parts 16-byte aligned, residual and out 8-byte. The
// pixel tile tw x th x tb (= 128). Returns a cudaError_t.
extern "C" int st_conv3x3_tf32x3(const float* x, const float* w_big, const float* w_small,
                                 const void* bias, int bias_dtype, long long bias_bstride,
                                 const float* residual, float* out, int B, int H, int W, int Cin,
                                 int Cout, int cout_pad, int act, int tw, int th, int tb,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w_big) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(w_small) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(residual) % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(out) % 8 == 0;
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % 8 || Cout <= 0 || cout_pad < Cout ||
      cout_pad % 8 || !aligned || act < 0 || act > 1 || bias_dtype < 0 || bias_dtype > 1 ||
      tw < 1 || th < 1 || tb < 1 || tw > 256 || th > 256 || tb > 256 || tw * th * tb != wg::BM)
    return (int)cudaErrorInvalidValue;
  const int bn = cout_pad <= 8 ? 8 : 128;
  CUtensorMap tx, tbig, tsmall;
  const uint64_t xdims[4] = {(uint64_t)Cin, (uint64_t)W, (uint64_t)H, (uint64_t)B};
  const uint64_t xstrides[3] = {(uint64_t)Cin * 4, (uint64_t)W * Cin * 4,
                                (uint64_t)H * W * Cin * 4};
  const uint32_t xbox[4] = {32, (uint32_t)tw, (uint32_t)th, (uint32_t)tb};
  const uint64_t wdims[2] = {9ull * Cin, (uint64_t)cout_pad};
  const uint64_t wstrides[1] = {9ull * Cin * 4};
  const uint32_t wbox[2] = {32, (uint32_t)bn};
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (!wg::make_map(&tx, x, 4, xdims, xstrides, xbox, f32) ||
      !wg::make_map(&tbig, w_big, 2, wdims, wstrides, wbox, f32) ||
      !wg::make_map(&tsmall, w_small, 2, wdims, wstrides, wbox, f32))
    return (int)cudaErrorInvalidValue;
  const int ntx = (W + tw - 1) / tw, nty = (H + th - 1) / th;
  const long long m_tiles = (long long)ntx * nty * ((B + tb - 1) / tb);
  const int n_tiles = (cout_pad + bn - 1) / bn;
  if (m_tiles * n_tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const ConvTf32Args a{bias, bias_bstride, residual, out, B, H, W, Cin, Cout, bias_dtype, act,
                       tw, th, tb, ntx, nty, n_tiles};
  const dim3 grid((unsigned)(m_tiles * n_tiles));
  if (bn == 8) {
    static bool set = false;
    if (!set) {
      const cudaError_t err = cudaFuncSetAttribute(
          conv_wgmma_tf32x3<8>, cudaFuncAttributeMaxDynamicSharedMemorySize, tf_smem_bytes<8>());
      if (err != cudaSuccess) return (int)err;
      set = true;
    }
    conv_wgmma_tf32x3<8><<<grid, wg::THREADS, tf_smem_bytes<8>(), stream>>>(tx, tbig, tsmall, a);
  } else {
    static bool set = false;
    if (!set) {
      const cudaError_t err = cudaFuncSetAttribute(conv_wgmma_tf32x3<128>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   tf_smem_bytes<128>());
      if (err != cudaSuccess) return (int)err;
      set = true;
    }
    conv_wgmma_tf32x3<128><<<grid, wg::THREADS, tf_smem_bytes<128>(), stream>>>(tx, tbig,
                                                                                tsmall, a);
  }
  return (int)cudaGetLastError();
}
