// Conversions, activations and 16-byte vector loads and stores shared by the
// kernels (conv3x3.cu, group_norm.cu, layer_norm.cu, geglu.cu, linear.cu and
// the epilogues of wgmma.cuh and tf32_gemm.cuh). V values of T go through one
// uint4 when V * sizeof(T) == 16 (8 bf16 or 4 f32), element by element
// otherwise (V == 1). The caller guarantees 16-byte alignment for the vector
// form.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stv {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T (nearest even) and back: a PyTorch op's result in T, as
// the next op reads it; the identity for f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = to_f32(p[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  if constexpr (V * sizeof(T) == 16) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_f32<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) p[i] = from_f32<T>(v[i]);
  }
}

// one parameter value (gamma / beta) of dtype code pdtype: 0 f32, 1 bf16
__device__ __forceinline__ float load_param(const void* p, int pdtype, int i) {
  return pdtype == 1 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
                     : static_cast<const float*>(p)[i];
}

// x * sigmoid(x) to a few f32 ulps (fast exp and division: two special-
// function ops), far below the bf16 rounding that follows it in every use
// but the f32 VAE's; the GroupNorm apply kernel and the conv's GroupNorm
// prologue share it, so the fused and the unfused pair normalise alike
__device__ __forceinline__ float silu(float x) { return __fdividef(x, 1.f + __expf(-x)); }

// x * sigmoid(x) as PyTorch's CUDA silu computes it in f32, x / (1 + expf(-x))
// with the precise expf and a rounded division, for the kernels' forms that
// reproduce a plain PyTorch chain's roundings
__device__ __forceinline__ float silu_rn(float x) {
  return __fdiv_rn(x, __fadd_rn(1.f, expf(-x)));
}

// PyTorch's CUDA exact gelu in f32, x * 0.5 * (1 + erf(x * sqrt(1/2))),
// each operation rounded on its own as in its kernel
__device__ __forceinline__ float gelu_rn(float x) {
  return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(1.f, erff(__fmul_rn(x, 0.70710678118654752f))));
}

// the linear kernels' epilogue activation on an f32 sum: act 0 none, 1 SiLU
// (precise expf and division), 2 GELU with erff (the Pallas kernel's erf
// polynomial exists only because Mosaic has no erf)
__device__ __forceinline__ float act(float x, int code) {
  if (code == 1) return x / (1.f + expf(-x));
  if (code == 2) return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
  return x;
}

}  // namespace stv
