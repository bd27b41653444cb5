"""Sinusoidal timestep embedding through the hand-written Hopper kernel
``csrc/time_embed.cu``.

Replaces the Pallas TPU kernel ``_time_embed_kernel`` of
``stabletriton_tpu/kernels/time_embed.py`` (K12): (B,) timesteps -> (B, dim)
f32, cos then sin when ``flip_sin_to_cos``, sin then cos otherwise. On the
SDXL step it runs twice: (2,) -> (2, 320) for the timesteps and (12,) ->
(12, 256) for the six micro-conditioning ids of each CFG row; SD1.5 runs the
first only.

What bounds it on the H100: nothing but the launch; it writes a few KB,
and its device time is that of one empty launch (``csrc/time_embed.cu``
``st_launch_floor``).

What the design does about it: one thread an output, 256 a block (the
time_ids' 3072 outputs on 12 SMs side by side), in the Pallas body's order (``exp(col * c)`` with c
folded on the host, then ``t * freq``), with the precise ``sinf`` / ``cosf``
for arguments up to ~1000 rad. The cost is on the host, so the launch path
is short: what depends only on the signature (device, t's shape and dtype,
dim, max_period, flip, shift: the checks, the f32 coefficient, the grid, the
launch key, the C entry and its struct argument) is worked out once by the
cached :func:`_route`; a call makes the output, converts t only where it is
not a contiguous f32 vector, and makes one ctypes call of four arguments.

The plain version (:func:`time_embed_plain`) computes the kernel's order in
PyTorch; the wrapper uses it only for tensors on the CPU. A CUDA tensor goes
to the kernel or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from stabletriton_tpu_torch.kernels.build import (
    LaunchCounter, check, current_stream, function, on_device)
from stabletriton_tpu_torch.ops.registry import register

LAUNCHES = LaunchCounter()

THREADS = 256  # a block's, one output each

# st_time_embed(t, out, stream, dims): dims points at a TeDims
_TIME_EMBED_ARGTYPES = [ctypes.c_void_p] * 4


class TeDims(ctypes.Structure):
    """st_time_embed's other arguments (csrc/time_embed.cu TeDims), made once
    per signature: ctypes converts every argument of every call."""
    _fields_ = [("b", ctypes.c_int), ("half", ctypes.c_int), ("c", ctypes.c_float),
                ("flip", ctypes.c_int), ("blocks", ctypes.c_int), ("threads", ctypes.c_int)]


def _half_and_coef(shape: tuple, dim: int, max_period: float, shift: float):
    """half = dim / 2 and the frequency exponent's coefficient
    -ln(max_period) / (half - shift), in double (rounded to f32 by the
    caller, as JAX folds the constant)."""
    if len(shape) != 1:
        raise ValueError(f"time_embed takes (B,) timesteps, got {tuple(shape)}")
    if dim % 2:
        raise ValueError(f"time_embed dim must be even, got {dim}")
    half = dim // 2
    return half, -math.log(max_period) / (half - shift)


def grid(total: int) -> tuple[int, int]:
    """(blocks, threads) for ``total`` outputs, one a thread."""
    return -(-total // THREADS), THREADS


class Route(NamedTuple):
    """What a signature decides about one launch of the kernel."""
    key: str
    b: int
    convert: bool  # t is not f32: the call converts it
    dims: TeDims   # b, half, the f32 coefficient, flip, blocks, threads
    address: int   # of dims, which the route keeps alive
    fn: object     # the C entry


@functools.lru_cache(maxsize=None)
def _route(device: torch.device, shape: tuple, dtype: torch.dtype, dim: int,
           max_period: float, flip: bool, shift: float) -> Route:
    """A launch's signature, checked (the ValueError of a bad one; the
    cache keeps no exception, so a bad call raises anew every time) and
    routed. Cached: each of a step's launches costs a dictionary lookup."""
    half, coef = _half_and_coef(shape, dim, max_period, shift)
    b = shape[0]
    c = float(torch.tensor(coef, dtype=torch.float32))
    dims = TeDims(b, half, c, int(flip), *grid(b * dim))
    return Route(f"b={b} dim={dim} flip={int(flip)} shift={shift:g}", b,
                 dtype != torch.float32, dims, ctypes.addressof(dims),
                 function("st_time_embed", _TIME_EMBED_ARGTYPES) if b else None)


def time_embed_plain(t: torch.Tensor, *, dim: int, max_period: float = 10000.0,
                     flip_sin_to_cos: bool = True,
                     downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in its order: freq =
    exp(col * float32(c)), arg = t * freq, then sin / cos."""
    half, coef = _half_and_coef(t.shape, dim, max_period, downscale_freq_shift)
    c = torch.tensor(coef, dtype=torch.float32, device=t.device)
    col = torch.arange(half, dtype=torch.float32, device=t.device)
    arg = t.float()[:, None] * torch.exp(col * c)[None, :]
    first, second = (torch.cos, torch.sin) if flip_sin_to_cos else (torch.sin, torch.cos)
    return torch.cat([first(arg), second(arg)], dim=-1)


@register("time_embed", "cuda")
def time_embed(t: torch.Tensor, *, dim: int, max_period: float = 10000.0,
               flip_sin_to_cos: bool = True,
               downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """(B,) timesteps -> (B, dim) f32 sinusoidal embedding."""
    if t.is_cpu:
        return time_embed_plain(t, dim=dim, max_period=max_period,
                                flip_sin_to_cos=flip_sin_to_cos,
                                downscale_freq_shift=downscale_freq_shift)
    device = t.device
    route = _route(device, t.shape, t.dtype, dim, max_period, flip_sin_to_cos,
                   downscale_freq_shift)
    out = torch.empty((route.b, dim), dtype=torch.float32, device=device)
    if route.fn is None:
        return out
    if route.convert or not t.is_contiguous():
        t = t.to(torch.float32).contiguous()
    with on_device(device):
        code = route.fn(t.data_ptr(), out.data_ptr(), current_stream(device), route.address)
    check(code, "st_time_embed")
    LAUNCHES.add(route.key)
    return out
