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
gamma and beta read as vectors of each lane's columns; the affine in f32
and one rounding.

The default binding's LayerNorm (:func:`layer_norm_bf16apply`, backend
"cuda_bf16apply") is the same kernel in its stepwise form: the moments as
``torch.mean`` / ``torch.rsqrt`` take them on the card, then x - mean, *
rstd, * gamma and + beta with each operand and result rounded to x's dtype,
as the plain ``ops.reference.layer_norm_bf16apply`` rounds them (13
launches a LayerNorm there). Only the moments' summation order differs.

The launch path is short, since the UNet step launches 210 of these: what
depends only on the signature (shapes and dtypes: the checks, the launch
key and the C entry's integer arguments) is worked out once by the cached
:func:`_route`; a call checks x's layout and the parameters' devices, makes
the output and makes one ctypes call.

CUDA C++ rather than Triton: the repo has one build route (``build.py``),
one launch check and one library.

The plain version (:func:`layer_norm_plain`) computes the kernel's function
in PyTorch; the wrappers use it only for tensors on the CPU. A CUDA tensor
goes to the kernel or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from stabletriton_tpu_torch.kernels.build import (
    DTYPE_CODES, LaunchCounter, check, current_stream, function, on_device)
from stabletriton_tpu_torch.ops import reference
from stabletriton_tpu_torch.ops.registry import register

MAX_VALUES_PER_LANE = 64  # the kernel's register budget: C <= 2048 in either dtype

LAUNCHES = LaunchCounter()
# launches of the default binding's form (layer_norm_bf16apply)
BF16APPLY_LAUNCHES = LaunchCounter()


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


# st_layer_norm(x, gamma, beta, out, stream, dims): dims points at an LnDims
_LN_ARGTYPES = [ctypes.c_void_p] * 6


class LnDims(ctypes.Structure):
    """st_layer_norm's other arguments (csrc/layer_norm.cu LnDims), made once
    per signature: ctypes converts every argument of every call."""
    _fields_ = [("dtype", ctypes.c_int), ("pdtype", ctypes.c_int), ("rows", ctypes.c_int),
                ("c", ctypes.c_int), ("rms", ctypes.c_int), ("eps", ctypes.c_float),
                ("stepwise", ctypes.c_int)]


class Route(NamedTuple):
    """What a signature decides about one launch of the kernel."""
    key: str
    fields: tuple  # LnDims's: dtype, pdtype (0 where there are none), rows, c, rms, eps,
    #                stepwise
    dims: LnDims   # made of them
    address: int   # of dims, which the route keeps alive


def _check_params(c: int, *shapes) -> None:
    for shape in shapes:
        if shape is not None and tuple(shape) != (c,):
            raise ValueError(f"norm parameter {tuple(shape)} is not ({c},)")


@functools.lru_cache(maxsize=None)
def _route(shape: tuple, dtype: torch.dtype, gamma_shape: tuple | None,
           gamma_dtype: torch.dtype | None, beta_shape: tuple | None,
           beta_dtype: torch.dtype | None, rmsnorm: bool, eps: float,
           stepwise: bool = False) -> Route:
    """A launch's signature, checked (the ValueError of a bad operand; the
    cache keeps no exception, so a bad call raises anew every time) and
    routed: the launch key and the C entry's other arguments. Pure and
    cached."""
    c = shape[-1]
    _check_params(c, gamma_shape, beta_shape)
    if dtype not in DTYPE_CODES:
        raise ValueError(f"layer norm kernel takes float32 or bfloat16, got {dtype}")
    vec = 16 // dtype.itemsize
    if c % vec or c > 32 * MAX_VALUES_PER_LANE:
        raise ValueError(f"layer norm kernel takes C a multiple of {vec} up to "
                         f"{32 * MAX_VALUES_PER_LANE}, got {c}")
    pdtypes = {d for d in (gamma_dtype, beta_dtype) if d is not None}
    if len(pdtypes) > 1 or not pdtypes <= set(DTYPE_CODES):
        raise ValueError(f"gamma and beta must share one of {list(DTYPE_CODES)}, got {pdtypes}")
    rows = math.prod(shape[:-1])
    if stepwise and rmsnorm:
        raise ValueError("the stepwise form is LayerNorm's alone")
    kind = "ln_bf16apply" if stepwise else "rms" if rmsnorm else "ln"
    key = f"{kind} {'bf16' if dtype == torch.bfloat16 else 'f32'} rows={rows} c={c}"
    fields = (DTYPE_CODES[dtype], DTYPE_CODES[pdtypes.pop()] if pdtypes else 0, rows, c,
              int(rmsnorm), eps, int(stepwise))
    dims = LnDims(*fields)
    return Route(key, fields, dims, ctypes.addressof(dims))


def check_call(contiguous: bool, x_ptr: int, x_device, gamma_device, beta_device,
               params_contiguous: bool) -> None:
    """The checks of one call that its signature does not decide: x's layout
    and the parameters' device and layout (a None device: no parameter)."""
    if not contiguous or x_ptr % 16:
        raise ValueError("layer norm kernel takes a contiguous, 16-byte aligned x")
    if (not params_contiguous or (gamma_device is not None and gamma_device != x_device)
            or (beta_device is not None and beta_device != x_device)):
        raise ValueError("gamma and beta must be contiguous on x's device")


def _row_norm(x, gamma, beta, eps, rmsnorm, stepwise=False):
    if x.is_cpu:
        _check_params(x.shape[-1], None if gamma is None else gamma.shape,
                      None if beta is None else beta.shape)
        if stepwise:
            return reference.layer_norm_bf16apply(x, gamma, beta, eps=eps)
        return layer_norm_plain(x, gamma, beta, eps=eps, rmsnorm=rmsnorm)
    route = _route(x.shape, x.dtype, None if gamma is None else gamma.shape,
                   None if gamma is None else gamma.dtype, None if beta is None else beta.shape,
                   None if beta is None else beta.dtype, rmsnorm, eps, stepwise)
    x_ptr = x.data_ptr()
    check_call(x.is_contiguous(), x_ptr, x.get_device(),
               None if gamma is None else gamma.get_device(),
               None if beta is None else beta.get_device(),
               (gamma is None or gamma.is_contiguous()) and (beta is None or beta.is_contiguous()))
    out = torch.empty_like(x)
    with on_device(x.device):
        code = function("st_layer_norm", _LN_ARGTYPES)(
            x_ptr, None if gamma is None else gamma.data_ptr(),
            None if beta is None else beta.data_ptr(), out.data_ptr(), current_stream(x.device),
            route.address)
    check(code, "st_layer_norm")
    (BF16APPLY_LAUNCHES if stepwise else LAUNCHES).add(route.key)
    return out


@register("layer_norm", "cuda")
def layer_norm(x: torch.Tensor, gamma: torch.Tensor | None, beta: torch.Tensor | None, *,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis of x (..., C); gamma / beta may be None."""
    return _row_norm(x, gamma, beta, eps, rmsnorm=False)


@register("layer_norm", "cuda_bf16apply")
def layer_norm_bf16apply(x: torch.Tensor, gamma: torch.Tensor | None,
                         beta: torch.Tensor | None, *, eps: float = 1e-5) -> torch.Tensor:
    """The default binding's LayerNorm over the last axis of x (..., C): the
    kernel's stepwise form, which rounds as ``ops.reference.
    layer_norm_bf16apply`` does (that plain form for a CPU tensor)."""
    return _row_norm(x, gamma, beta, eps, rmsnorm=False, stepwise=True)


@register("rms_norm", "cuda")
def rms_norm(x: torch.Tensor, gamma: torch.Tensor | None,
             beta: torch.Tensor | None = None, *, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis of x (..., C); gamma / beta may be None."""
    return _row_norm(x, gamma, beta, eps, rmsnorm=True)
