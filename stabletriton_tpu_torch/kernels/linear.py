"""Linear (GEMM + bias + activation) through the hand-written Hopper kernel
``csrc/linear.cu``.

Replaces the Pallas TPU kernel ``_linear_kernel`` of
``stabletriton_tpu/kernels/linear.py`` (K13): x (..., K) @ w (K, N) + b with
an optional SiLU or exact (erf) GELU, f32 accumulation, bias and activation
on the f32 sum, one rounding to x's dtype. On the UNet step it takes every
projection: M = 8192 and 2048 rows for the transformer GEMMs at 1024^2, 154
for the cross K/V precompute, 2 for the time MLPs and the resnets' time
projections; the VAE decoder's f32 mid-attention adds (16384, 512) @ (512,
512) per 1024^2 image.

What bounds it on the H100: the transformer GEMMs are compute-bound; the
M = 2 ones read their weight once and do two FMAs a weight.

What the design does about it: three kernels in one source, picked here by
M and dtype. bf16 with M > 16 goes to a WMMA tensor-core kernel (128x128
tiles, K staged through two shared-memory buffers by cp.async); M <= 16 to
a skinny kernel whose blocks each read a 32-column slice of w once, with
the K reduction split over 16 warps; f32 with M > 16 to an FMA-tiled kernel
with no TF32 rounding. It is a first, correct GEMM: no wgmma, no TMA, so
it runs behind cuBLAS (PERF.md); making it fast is later work.

CUDA C++ rather than Triton: the repo has one build route (``build.py``),
one launch check and one library.

The plain version (:func:`linear_plain`) computes the kernel's function in
PyTorch; the wrapper uses it only for tensors on the CPU. A CUDA tensor goes
to the kernel or the wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch

from stabletriton_tpu_torch.kernels.build import (
    ACT_CODES, DTYPE_CODES, LaunchCounter, check, function)
from stabletriton_tpu_torch.ops.reference import apply_activation
from stabletriton_tpu_torch.ops.registry import register

LAUNCHES = LaunchCounter()

SKINNY_MAX_M = 16  # rows the skinny kernel takes (csrc/linear.cu SKINNY_MAX_M)
# the kernel's variant codes in st_linear
_VARIANTS = {"scalar_f32": 0, "wmma_bf16": 1, "skinny_f32": 2, "skinny_bf16": 2}

_LINEAR_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])


def linear_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                 act: str | None = None) -> torch.Tensor:
    """The kernel's function in plain PyTorch: w cast to x's dtype, the
    product, bias and activation in f32, one rounding to x's dtype. On a GPU
    the f32 product is full precision only with
    ``torch.backends.cuda.matmul.allow_tf32`` off (PyTorch's default)."""
    n = w.shape[1]
    out = x.reshape(-1, x.shape[-1]).float() @ w.to(x.dtype).float()
    if b is not None:
        out = out + b.float()
    return apply_activation(out, act).to(x.dtype).reshape(*x.shape[:-1], n)


def variant(m: int, dtype: torch.dtype) -> str:
    """The kernel that takes an (m, K) @ (K, N) GEMM of ``dtype``."""
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    if m <= SKINNY_MAX_M:
        return f"skinny_{name}"
    return "wmma_bf16" if dtype == torch.bfloat16 else "scalar_f32"


@register("linear", "cuda")
def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           act: str | None = None) -> torch.Tensor:
    """x (..., K) @ w (K, N) + b (N,), then ``act`` (None, "silu" or "gelu").
    x is flattened to (M, K) and copied only if it is not contiguous."""
    if act not in ACT_CODES:
        raise ValueError(f"linear kernel takes act in {list(ACT_CODES)}, got {act!r}")
    k = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"weight {tuple(w.shape)} is not ({k}, N)")
    n = w.shape[1]
    if b is not None and tuple(b.shape) != (n,):
        raise ValueError(f"bias {tuple(b.shape)} is not ({n},)")
    if x.device.type == "cpu":
        return linear_plain(x, w, b, act=act)
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"linear kernel takes float32 or bfloat16, got {x.dtype}")
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError("linear operands lie on different devices")
    x2 = x.reshape(-1, k)
    if not x2.is_contiguous():
        x2 = x2.contiguous()
    w = w.to(x.dtype)
    if not w.is_contiguous():
        w = w.contiguous()
    bias = None if b is None else b.to(torch.float32).contiguous()
    m = x2.shape[0]
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0 or n == 0:
        return out.reshape(*x.shape[:-1], n)
    if max(m, n, k) >= 2**31:
        raise ValueError(f"linear kernel takes dims below 2^31, got ({m}, {k}) @ ({k}, {n})")
    name = variant(m, x.dtype)
    vec = int(name == "wmma_bf16" and k % 8 == 0 and n % 8 == 0
              and x2.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0)
    fn = function("st_linear", _LINEAR_ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x2.data_ptr(), w.data_ptr(), None if bias is None else bias.data_ptr(),
                  out.data_ptr(), m, n, k, ACT_CODES[act], DTYPE_CODES[x.dtype],
                  _VARIANTS[name], vec, stream)
    check(code, "st_linear")
    LAUNCHES.add(f"{name} m={m} k={k} n={n} bias={int(b is not None)} act={act} vec={vec}")
    return out.reshape(*x.shape[:-1], n)
