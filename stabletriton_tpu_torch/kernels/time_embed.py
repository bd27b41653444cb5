"""Sinusoidal timestep embedding through the hand-written Hopper kernel
``csrc/time_embed.cu``.

Replaces the Pallas TPU kernel ``_time_embed_kernel`` of
``stabletriton_tpu/kernels/time_embed.py`` (K12): (B,) timesteps -> (B, dim)
f32, cos then sin when ``flip_sin_to_cos``, sin then cos otherwise. On the
SDXL step it runs twice: (2,) -> (2, 320) for the timesteps and (12,) ->
(12, 256) for the six micro-conditioning ids of each CFG row; SD1.5 runs the
first only.

What bounds it on the H100: nothing but the launch; it writes a few KB.

What the design does about it: one thread per output, the Pallas body's
order (``exp(col * c)`` with c folded on the host, then ``t * freq``), the
precise ``sinf`` / ``cosf`` for arguments up to ~1000 rad.

The plain version (:func:`time_embed_plain`) computes the kernel's order in
PyTorch; the wrapper uses it only for tensors on the CPU. A CUDA tensor goes
to the kernel or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from stabletriton_tpu_torch.kernels.build import (
    LaunchCounter, check, current_stream, function, on_device)
from stabletriton_tpu_torch.ops.registry import register

LAUNCHES = LaunchCounter()

_TIME_EMBED_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def _half_and_coef(t: torch.Tensor, dim: int, max_period: float, shift: float):
    """half = dim / 2 and the frequency exponent's coefficient
    -ln(max_period) / (half - shift), in double (rounded to f32 by the
    caller, as JAX folds the constant)."""
    if t.dim() != 1:
        raise ValueError(f"time_embed takes (B,) timesteps, got {tuple(t.shape)}")
    if dim % 2:
        raise ValueError(f"time_embed dim must be even, got {dim}")
    half = dim // 2
    return half, -math.log(max_period) / (half - shift)


def time_embed_plain(t: torch.Tensor, *, dim: int, max_period: float = 10000.0,
                     flip_sin_to_cos: bool = True,
                     downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """The kernel's function in plain PyTorch, in its order: freq =
    exp(col * float32(c)), arg = t * freq, then sin / cos."""
    half, coef = _half_and_coef(t, dim, max_period, downscale_freq_shift)
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
    half, coef = _half_and_coef(t, dim, max_period, downscale_freq_shift)
    if t.device.type == "cpu":
        return time_embed_plain(t, dim=dim, max_period=max_period,
                                flip_sin_to_cos=flip_sin_to_cos,
                                downscale_freq_shift=downscale_freq_shift)
    b = t.shape[0]
    out = torch.empty((b, dim), dtype=torch.float32, device=t.device)
    if b == 0:
        return out
    tf = t.to(torch.float32).contiguous()
    fn = function("st_time_embed", _TIME_EMBED_ARGTYPES)
    with on_device(t.device):
        stream = current_stream(t.device)
        code = fn(tf.data_ptr(), out.data_ptr(), b, half, coef, int(flip_sin_to_cos), stream)
    check(code, "st_time_embed")
    LAUNCHES.add(f"b={b} dim={dim} flip={int(flip_sin_to_cos)} shift={downscale_freq_shift:g}")
    return out
