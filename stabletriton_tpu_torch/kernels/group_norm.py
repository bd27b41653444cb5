"""GroupNorm through the hand-written Hopper kernels ``csrc/group_norm.cu``.

Replaces the Pallas TPU kernels ``_stats_kernel`` and ``_apply_kernel`` of
``stabletriton_tpu/kernels/group_norm.py`` (K9): NHWC GroupNorm with f32
moments and an optional fused SiLU, for the UNet's transformer GroupNorms
(bf16, no activation) and every GroupNorm of the VAE decoder (f32, SiLU, up
to (1, 1024, 1024, 128)). Its stats pass also feeds the fused GN conv
(:func:`conv_direct.gn_conv2d_fused`).

What bounds it on the H100: device memory. Two reads and one write of x at
about one FLOP per byte, far under the card's ~295 FLOP/B balance point.

What the design does about it: 16-byte vector loads and stores in both
passes; the moments are per (B, C) sums taken in one read; the fold to
per-channel scale / shift happens in PyTorch on (B, C) tensors, as the JAX
package leaves it to XLA; the apply pass is one read and one write. The TPU
carries its sums along a sequential grid axis; Hopper blocks run in no
order, so the stats are two passes: blocks over (channel slab, row chunk,
batch) write per-chunk partials (f32 over runs of 16 rows, then double), and
a second small pass sums them in a fixed order. No float atomics: the same
input gives the same bits in every run, and the chunking depends on (H*W, C)
only, so an image gets the same moments at every batch bucket.

CUDA C++ rather than Triton: the repo has one build route (``build.py``),
one launch check and one library, and these two passes need nothing Triton
would add.

The plain version (:func:`group_norm_plain`) computes the kernels' function
in PyTorch in f32 with one rounding; the wrapper uses it only for tensors on
the CPU. A CUDA tensor goes to the kernels or the wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from stabletriton_tpu_torch.kernels.build import (
    ACT_CODES, DTYPE_CODES, SILU_ACTS, LaunchCounter, check, function, on_device)
from stabletriton_tpu_torch.ops.registry import register

STATS_BLOCKS_PER_IMAGE = 132  # one stats block per SM for a single image
MIN_CHUNK_ROWS = 64           # 8 rows per thread at least

# one count per GroupNorm (stats + apply); the stats launched for the fused
# GN conv count with that conv (conv_direct.GN_LAUNCHES)
LAUNCHES = LaunchCounter()


def moments_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, C) f32 sum and sum of squares of NHWC x over H and W."""
    xf = x.float()
    return xf.sum(dim=(1, 2)), xf.square().sum(dim=(1, 2))


def fold(s1: torch.Tensor, s2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
         hw: int, num_groups: int, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C) moments -> per-(B, C) f32 scale and shift such that
    ``normalize(x) = x * scale + shift``; var = E[x^2] - mean^2 clamped at 0,
    as the JAX package's ``_gn_fold``."""
    n, c = s1.shape
    per = c // num_groups
    cnt = hw * per
    mean = s1.reshape(n, num_groups, per).sum(-1) / cnt
    ex2 = s2.reshape(n, num_groups, per).sum(-1) / cnt
    rstd = torch.rsqrt(torch.clamp(ex2 - mean.square(), min=0.0) + eps)
    scale = rstd[:, :, None].expand(n, num_groups, per).reshape(n, c) * gamma.float()
    shift = beta.float() - mean[:, :, None].expand(n, num_groups, per).reshape(n, c) * scale
    return scale, shift


def apply_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                act: str | None) -> torch.Tensor:
    out = x.float() * scale[:, None, None, :] + shift[:, None, None, :]
    if act == "silu":
        out = F.silu(out)
    return out.to(x.dtype)


def group_norm_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                     num_groups: int = 32, eps: float = 1e-5,
                     act: str | None = None) -> torch.Tensor:
    """The kernels' function in plain PyTorch, f32 throughout, one rounding."""
    s1, s2 = moments_plain(x)
    scale, shift = fold(s1, s2, gamma, beta, hw=x.shape[1] * x.shape[2],
                        num_groups=num_groups, eps=eps)
    return apply_plain(x, scale, shift, act)


def _vec(x: torch.Tensor) -> int:
    """Values per 16-byte load, or 1 where C or the base does not allow it."""
    v = 16 // x.element_size()
    return v if x.shape[-1] % v == 0 and x.data_ptr() % 16 == 0 else 1


def stats_chunks(hw: int, c: int, vec: int) -> int:
    """Row chunks of the stats pass: about one block per SM for one image,
    at least MIN_CHUNK_ROWS rows each. A function of (H*W, C) only."""
    slabs = -(-(c // vec) // 32)
    return max(1, min(-(-hw // MIN_CHUNK_ROWS), -(-STATS_BLOCKS_PER_IMAGE // slabs)))


def _check_cuda(x: torch.Tensor) -> None:
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"group norm kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("group norm kernel takes a contiguous NHWC tensor")
    if x.shape[1] * x.shape[2] * x.shape[3] >= 2**31:
        raise ValueError(f"group norm kernel takes H*W*C < 2^31, got {tuple(x.shape)}")


_STATS_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_APPLY_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def moments(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C) f32 sum and sum of squares of NHWC x over H and W, by the stats
    kernels (the plain version for CPU tensors). Counts nothing: its callers
    count their op."""
    if x.device.type == "cpu":
        return moments_plain(x)
    _check_cuda(x)
    n, h, w, c = x.shape
    vec = _vec(x)
    nchunks = stats_chunks(h * w, c, vec)
    dev = x.device
    partial = torch.empty((2, n, nchunks, c), dtype=torch.float64, device=dev)
    sums = torch.empty((2, n, c), dtype=torch.float32, device=dev)
    fn = function("st_group_norm_stats", _STATS_ARGTYPES)
    with on_device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(x.data_ptr(), partial[0].data_ptr(), partial[1].data_ptr(),
                  sums[0].data_ptr(), sums[1].data_ptr(), n, h * w, c, nchunks,
                  DTYPE_CODES[x.dtype], vec, stream)
    check(code, "st_group_norm_stats")
    return sums[0], sums[1]


def apply(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
          act: str | None) -> torch.Tensor:
    """x * scale + shift (+SiLU) per (batch, channel), by the apply kernel
    (the plain version for CPU tensors). Counts nothing."""
    if act not in SILU_ACTS:
        raise ValueError(f"group norm kernel takes act in {list(SILU_ACTS)}, got {act!r}")
    if x.device.type == "cpu":
        return apply_plain(x, scale, shift, act)
    _check_cuda(x)
    n, h, w, c = x.shape
    if scale.shape != (n, c) or shift.shape != (n, c):
        raise ValueError(f"scale / shift must be {(n, c)}")
    if any(t.dtype != torch.float32 or not t.is_contiguous() or t.device != x.device
           for t in (scale, shift)):
        raise ValueError("scale / shift must be contiguous float32 on x's device")
    out = torch.empty_like(x)
    fn = function("st_group_norm_apply", _APPLY_ARGTYPES)
    with on_device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(), n,
                  h * w, c, ACT_CODES[act], DTYPE_CODES[x.dtype], _vec(x), stream)
    check(code, "st_group_norm_apply")
    return out


@register("group_norm", "cuda")
def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
               num_groups: int = 32, eps: float = 1e-5,
               act: str | None = None) -> torch.Tensor:
    """GroupNorm over NHWC x (+SiLU): stats kernels, fold, apply kernel."""
    n, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if act not in SILU_ACTS:
        raise ValueError(f"group norm kernel takes act in {list(SILU_ACTS)}, got {act!r}")
    if x.device.type == "cpu":
        return group_norm_plain(x, gamma, beta, num_groups=num_groups, eps=eps, act=act)
    s1, s2 = moments(x)
    scale, shift = fold(s1, s2, gamma, beta, hw=h * w, num_groups=num_groups, eps=eps)
    out = apply(x, scale, shift, act)
    LAUNCHES.add(f"{'bf16' if x.dtype == torch.bfloat16 else 'f32'} b={n} {h}x{w} "
                 f"c={c} g={num_groups} act={act}")
    return out
