"""LayerNorm and RMSNorm through the hand-written Hopper kernel ``csrc/layer_norm.cu``.

Replaces the Pallas TPU kernel ``_layer_norm_kernel`` of
``stabletriton_tpu/kernels/layer_norm.py`` (K10), which serves ``layer_norm``
and, with its ``rmsnorm`` switch, ``rms_norm``: the UNet's transformer
LayerNorms, (8192, 640) and (2048, 1280) bf16 rows at 1024², three per
transformer block.

What bounds it on the H100: device memory, one read and one write of x at a
few FLOPs per byte.

What the design does about it: one warp per row with the row held in
registers (C = 640 or 1280 bf16 is 20-40 values a lane), loaded and stored
as 16-byte vectors, so x is read once; f32 two-pass mean and variance from
the registers; xor-butterfly warp sums, so every run gives the same bits;
the affine in f32 and one rounding. This is not the default binding's
``bf16apply`` form, which rounds after each op.

CUDA C++ rather than Triton: the repo has one build route (``build.py``),
one launch check and one library.

The plain version (:func:`layer_norm_plain`) computes the kernel's function
in PyTorch; the wrappers use it only for tensors on the CPU. A CUDA tensor
goes to the kernel or the wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch

from stabletriton_tpu_torch.kernels.build import (
    DTYPE_CODES, LaunchCounter, check, function, on_device)
from stabletriton_tpu_torch.ops.registry import register

MAX_VECTORS_PER_LANE = 8  # the kernel's register budget: C <= 2048 bf16 / 1024 f32

LAUNCHES = LaunchCounter()


def layer_norm_plain(x: torch.Tensor, gamma: torch.Tensor | None,
                     beta: torch.Tensor | None, *, eps: float = 1e-5,
                     rmsnorm: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 two-pass moments over the
    last axis (RMSNorm: no mean subtraction), f32 affine, one rounding."""
    xf = x.float()
    if rmsnorm:
        xc = xf
    else:
        xc = xf - xf.mean(dim=-1, keepdim=True)
    out = xc * torch.rsqrt(xc.square().mean(dim=-1, keepdim=True) + eps)
    if gamma is not None:
        out = out * gamma.float()
    if beta is not None:
        out = out + beta.float()
    return out.to(x.dtype)


_LN_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
                + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 2
                + [ctypes.c_void_p])


def _row_norm(x, gamma, beta, eps, rmsnorm):
    c = x.shape[-1]
    for p in (gamma, beta):
        if p is not None and p.shape != (c,):
            raise ValueError(f"norm parameter {tuple(p.shape)} is not ({c},)")
    if x.device.type == "cpu":
        return layer_norm_plain(x, gamma, beta, eps=eps, rmsnorm=rmsnorm)
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"layer norm kernel takes float32 or bfloat16, got {x.dtype}")
    vec = 16 // x.element_size()
    if c % vec or c > 32 * vec * MAX_VECTORS_PER_LANE:
        raise ValueError(f"layer norm kernel takes C a multiple of {vec} up to "
                         f"{32 * vec * MAX_VECTORS_PER_LANE}, got {c}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("layer norm kernel takes a contiguous, 16-byte aligned x")
    params = [p for p in (gamma, beta) if p is not None]
    pdtypes = {p.dtype for p in params}
    if len(pdtypes) > 1 or not pdtypes <= set(DTYPE_CODES):
        raise ValueError(f"gamma and beta must share one of {list(DTYPE_CODES)}, got {pdtypes}")
    if any(p.device != x.device or not p.is_contiguous() for p in params):
        raise ValueError("gamma and beta must be contiguous on x's device")
    pdtype = DTYPE_CODES[pdtypes.pop()] if params else 0
    rows = x.numel() // c
    out = torch.empty_like(x)
    fn = function("st_layer_norm", _LN_ARGTYPES)
    with on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), None if gamma is None else gamma.data_ptr(),
                  None if beta is None else beta.data_ptr(), pdtype, out.data_ptr(),
                  rows, c, float(eps), int(rmsnorm), DTYPE_CODES[x.dtype], stream)
    check(code, "st_layer_norm")
    LAUNCHES.add(f"{'rms' if rmsnorm else 'ln'} "
                 f"{'bf16' if x.dtype == torch.bfloat16 else 'f32'} rows={rows} c={c}")
    return out


@register("layer_norm", "cuda")
def layer_norm(x: torch.Tensor, gamma: torch.Tensor | None, beta: torch.Tensor | None, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of x (..., C); gamma / beta may be None."""
    return _row_norm(x, gamma, beta, eps, rmsnorm=False)


@register("rms_norm", "cuda")
def rms_norm(x: torch.Tensor, gamma: torch.Tensor | None,
             beta: torch.Tensor | None = None, *, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis of x (..., C); gamma / beta may be None."""
    return _row_norm(x, gamma, beta, eps, rmsnorm=True)
