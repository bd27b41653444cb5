"""Linear (GEMM + bias + activation) through the hand-written Hopper kernels
of ``csrc/linear.cu``.

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

What the design does about it: four kernels in one source, picked here by
:func:`variant`, a pure function of the shape, dtype and alignment that the
launch key names. bf16 with M > 16 goes to the wgmma kernel (the TMA +
wgmma mainloop of ``csrc/wgmma.cuh``, block tile 128 x 128 or 256 and a K
split from the planner of ``wgmma_plan.py``) when TMA takes the operands (K
and N multiples of 8, 16-byte aligned bases), else to the WMMA kernel;
M <= 16 to a skinny kernel whose blocks each read a 32-column slice of w
once, with the K reduction split over 16 warps; f32 with M > 16 to the
3xTF32 wgmma GEMM (``csrc/tf32_gemm.cuh``, shared with the f32 attention),
which keeps f32 accuracy on the tensor cores: A is x as it lies, B is w^T
(N, K) split into a big part exact in tf32 and the small rest by a
transpose kernel that the same C entry launches first (its plain version
is :func:`tf32_weight`; one ctypes call, one scratch allocation), and the
GEMM splits x the same way in registers and sums three tf32 products. TMA
takes rows of 16 bytes from 16-byte aligned bases, so where K % 4 != 0 x
gets zero columns (w^T's come from the split kernel), and a misaligned x
is copied to an aligned base (:func:`_tf32_rows`). The bias is read in its
own dtype.

CUDA C++ rather than Triton: the repo has one build route (``build.py``),
one launch check and one library.

The plain version (:func:`linear_plain`) computes the kernel's function in
PyTorch; the wrapper uses it only for tensors on the CPU. A CUDA tensor goes
to the kernel or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from stabletriton_tpu_torch.kernels import wgmma_plan
from stabletriton_tpu_torch.kernels.build import (
    ACT_CODES, DTYPE_CODES, LaunchCounter, check, function, on_device)
from stabletriton_tpu_torch.ops.reference import apply_activation
from stabletriton_tpu_torch.ops.registry import register

LAUNCHES = LaunchCounter()

SKINNY_MAX_M = 16  # rows the skinny kernel takes (csrc/linear.cu SKINNY_MAX_M)
# the kernel's variant codes in st_linear
_VARIANTS = {"wmma_bf16": 1, "skinny_f32": 2, "skinny_bf16": 2}

_P, _I = ctypes.c_void_p, ctypes.c_int
# st_linear(x, w, bias, bias_dtype, out, M, N, K, act, dtype, variant, stream)
_LINEAR_ARGTYPES = [_P, _P, _P, _I, _P] + [_I] * 6 + [_P]
# st_linear_wgmma(x, w, bias, bias_dtype, out, ws, M, N, K, act, bn, splits, stream)
_WGMMA_ARGTYPES = [_P, _P, _P, _I, _P, _P] + [_I] * 6 + [_P]
# st_linear_tf32x3(x, w, ws, bias, bias_dtype, out, M, N, K, Kw, act, stream)
_TF32_ARGTYPES = [_P, _P, _P, _P, _I, _P] + [_I] * 5 + [_P]


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


def variant(m: int, k: int, n: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """The kernel that takes an (m, k) @ (k, n) GEMM of ``dtype``; ``aligned``:
    x's and w's bases are 16-byte aligned."""
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    if m <= SKINNY_MAX_M:
        return f"skinny_{name}"
    if dtype != torch.bfloat16:
        return "wgmma_tf32x3"  # the wrapper pads or copies what TMA cannot take
    return "wgmma_bf16" if wgmma_plan.gemm_fits(m, k, n, aligned) else "wmma_bf16"


def _tf32_k(k: int) -> int:
    """The depth the 3xTF32 GEMM reads: K rounded up to a multiple of 4
    (TMA's 16-byte rows of f32), at least 4."""
    return max(4, -(-k // 4) * 4)


def tf32_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The B operand of the 3xTF32 GEMM: w (K, N) transposed to K-major
    (N, K'), zero columns up to K' = :func:`_tf32_k`, split into big + small
    (``wgmma_plan.tf32_parts``). The plain version of the C entry's split
    kernel (``tf32_split_t``), bit for bit."""
    wt = w.t()
    pad = _tf32_k(w.shape[0]) - w.shape[0]
    return wgmma_plan.tf32_parts(F.pad(wt, (0, pad)) if pad else wt)


def _tf32_rows(x2: torch.Tensor) -> torch.Tensor:
    """x (M, K) f32 as TMA takes it: zero columns up to :func:`_tf32_k`, or
    a copy at an aligned base where the view's base is off 16 bytes."""
    pad = _tf32_k(x2.shape[1]) - x2.shape[1]
    if pad:
        return F.pad(x2, (0, pad))
    return x2.clone() if x2.data_ptr() % 16 else x2


@functools.lru_cache(maxsize=None)
def _route(name: str, m: int, k: int, n: int, bias: bool,
           act: str | None) -> tuple[wgmma_plan.Plan | None, str]:
    """The launch of kernel ``name`` at one shape: the wgmma kernel's plan
    and the launch key; cached, since the eager step launches hundreds of
    GEMMs."""
    head = f"{name} m={m} k={k} n={n} bias={int(bias)} act={act}"
    if name == "wgmma_bf16":
        plan = wgmma_plan.gemm_plan(m, k, n)
        return plan, f"{head} bn={plan.bn} split={plan.splits}"
    return None, head


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, act: str | None,
            name: str) -> tuple[torch.Tensor, str]:
    """Launch kernel ``name`` on contiguous CUDA operands x (..., K), w (K, N)
    of one dtype and b (N,) or None; x is read as its (M, K) rows and the
    output (..., N) is made in its final shape, so no reshape costs host
    time. Returns the output and the launch key."""
    k, n = w.shape
    lead = x.shape[:-1]
    m = math.prod(lead)
    plan, key = _route(name, m, k, n, b is not None, act)
    out = torch.empty((*lead, n), dtype=x.dtype, device=x.device)
    bias_args = (None, 0) if b is None else (b.data_ptr(), DTYPE_CODES[b.dtype])
    with on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if name == "wgmma_tf32x3":
            x2 = _tf32_rows(x.reshape(m, k))
            ws = torch.empty(2 * n * x2.shape[1], dtype=torch.float32, device=x.device)
            code = function("st_linear_tf32x3", _TF32_ARGTYPES)(
                x2.data_ptr(), w.data_ptr(), ws.data_ptr(), *bias_args, out.data_ptr(), m, n,
                x2.shape[1], k, ACT_CODES[act], stream)
        elif plan is not None:
            ws = (torch.empty((plan.splits, m, n), dtype=torch.float32, device=x.device)
                  if plan.splits > 1 else None)
            code = function("st_linear_wgmma", _WGMMA_ARGTYPES)(
                x.data_ptr(), w.data_ptr(), *bias_args, out.data_ptr(),
                None if ws is None else ws.data_ptr(), m, n, k, ACT_CODES[act], plan.bn,
                plan.splits, stream)
        else:
            code = function("st_linear", _LINEAR_ARGTYPES)(
                x.data_ptr(), w.data_ptr(), *bias_args, out.data_ptr(), m, n, k,
                ACT_CODES[act], DTYPE_CODES[x.dtype], _VARIANTS[name], stream)
    check(code, f"linear kernel {name}")
    return out, key


@register("linear", "cuda")
def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           act: str | None = None) -> torch.Tensor:
    """x (..., K) @ w (K, N) + b (N,), then ``act`` (None, "silu" or "gelu").
    x is read as its (M, K) rows and copied only if it is not contiguous;
    the bias is read in its own dtype (float32 or bfloat16)."""
    if act not in ACT_CODES:
        raise ValueError(f"linear kernel takes act in {list(ACT_CODES)}, got {act!r}")
    k = x.shape[-1]
    if w.dim() != 2 or w.shape[0] != k:
        raise ValueError(f"weight {tuple(w.shape)} is not ({k}, N)")
    n = w.shape[1]
    if b is not None and tuple(b.shape) != (n,):
        raise ValueError(f"bias {tuple(b.shape)} is not ({n},)")
    if x.is_cpu:
        return linear_plain(x, w, b, act=act)
    if x.dtype not in DTYPE_CODES or (b is not None and b.dtype not in DTYPE_CODES):
        raise ValueError(f"linear kernel takes float32 or bfloat16, got {x.dtype}"
                         + ("" if b is None else f" with a {b.dtype} bias"))
    if w.device != x.device or (b is not None and b.device != x.device):
        raise ValueError("linear operands lie on different devices")
    if not x.is_contiguous():
        x = x.contiguous()
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    if not w.is_contiguous():
        w = w.contiguous()
    if b is not None and not b.is_contiguous():
        b = b.contiguous()
    m = math.prod(x.shape[:-1])
    if m == 0 or n == 0:
        return torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    if max(m, n, k) >= 2**31:
        raise ValueError(f"linear kernel takes dims below 2^31, got ({m}, {k}) @ ({k}, {n})")
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    out, key = _launch(x, w, b, act, variant(m, k, n, x.dtype, aligned))
    LAUNCHES.add(key)
    return out
