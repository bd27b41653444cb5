"""GroupNorm through the hand-written Hopper kernels ``csrc/group_norm.cu``.

Replaces the Pallas TPU kernels ``_stats_kernel`` and ``_apply_kernel`` of
``stabletriton_tpu/kernels/group_norm.py`` (K9), and the fold between them
that the JAX package leaves to XLA: NHWC GroupNorm with f32 moments and an
optional fused SiLU, for the UNet's transformer GroupNorms (bf16, no
activation) and every GroupNorm of the VAE decoder (f32, SiLU, up to (1,
1024, 1024, 128)). Its stats and fold also feed the fused GN conv
(:func:`conv_direct.gn_conv2d_fused`, through :func:`scale_shift`).

What bounds it on the H100: device memory on the device, two reads and one
write of x at about one FLOP per byte, far under the card's ~295 FLOP/B
balance point; on the host, the launches. A UNet step runs it eagerly
dozens of times, so a wrapper that launched ~16 small PyTorch ops for the
fold of the (B, C) moments cost more than the kernels.

What the design does about it: one C entry, ``st_group_norm``, launches
three kernels on the caller's stream: the stats pass (blocks over (channel
slab, row chunk, batch) write per-chunk partials, f32 over runs of 16 rows,
then double), the fold (one block a (group, image): the chunk partials
summed in a fixed order, the group's channels in channel order, then scale
and shift (B, C) f32 with E[x^2] - mean^2 clamped at 0) and the apply pass
(16-byte vector loads and stores, one read and one write). The wrapper makes
one workspace allocation (the partials and scale / shift), the output, and
that one ctypes call: no PyTorch arithmetic. No float atomics: the same
input gives the same bits in every run, and the chunking depends on (H*W, C)
only, so an image gets the same scale / shift at every batch bucket.
``st_group_norm_fold`` runs the first two kernels alone for the fused GN
conv.

The clamp (C3 in ROADMAP.md): the JAX K9 fold takes rsqrt(E[x^2] - mean^2 +
eps) with no clamp and gives NaN where a near-constant group's difference
rounds below 0; the JAX package's own ``_gn_fold`` (K8) and its reference
ops clamp, and so does the port, in the kernel and in :func:`fold`.

CUDA C++ rather than Triton: the repo has one build route (``build.py``),
one launch check and one library, and these passes need nothing Triton
would add.

The plain version (:func:`group_norm_plain`: :func:`moments_plain`, then
:func:`fold`, then :func:`apply_plain`) computes the kernels' function in
PyTorch in f32 with one rounding; the wrapper uses it only for tensors on
the CPU. A CUDA tensor goes to the kernels or the wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from stabletriton_tpu_torch.kernels.build import (
    ACT_CODES, DTYPE_CODES, SILU_ACTS, LaunchCounter, check, current_stream, function,
    on_device)
from stabletriton_tpu_torch.ops.registry import register

STATS_BLOCKS_PER_IMAGE = 132  # one stats block per SM for a single image
MIN_CHUNK_ROWS = 64           # 8 rows per thread at least

# one count per GroupNorm (one st_group_norm call: stats, fold, apply); the
# stats and fold launched for the fused GN conv count with that conv
# (conv_direct.GN_LAUNCHES)
LAUNCHES = LaunchCounter()


def moments_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, C) f32 sum and sum of squares of NHWC x over H and W."""
    xf = x.float()
    return xf.sum(dim=(1, 2)), xf.square().sum(dim=(1, 2))


def fold(s1: torch.Tensor, s2: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
         hw: int, num_groups: int, eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, C) moments -> per-(B, C) f32 scale and shift such that
    ``normalize(x) = x * scale + shift``; var = E[x^2] - mean^2 clamped at 0,
    as the JAX package's ``_gn_fold``. The group's channels are added in
    channel order in f32, and each product and difference rounded on its
    own, as the fold kernel (``gn_fold``) computes them."""
    n, c = s1.shape
    per = c // num_groups
    cnt = hw * per
    g1, g2 = s1.reshape(n, num_groups, per), s2.reshape(n, num_groups, per)
    gs, gq = g1[..., 0], g2[..., 0]
    for i in range(1, per):
        gs, gq = gs + g1[..., i], gq + g2[..., i]
    mean, ex2 = gs / cnt, gq / cnt
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


def _params(x: torch.Tensor, gamma: torch.Tensor,
            beta: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """gamma and beta as the fold kernel reads them: contiguous (C,) on x's
    device, each in its own dtype (float32 or bfloat16)."""
    c = x.shape[3]
    for t in (gamma, beta):
        if tuple(t.shape) != (c,) or t.dtype not in DTYPE_CODES or t.device != x.device:
            raise ValueError(f"gamma / beta must be ({c},) float32 or bfloat16 on x's device")
    return gamma.contiguous(), beta.contiguous()


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# st_group_norm(x, gamma, gamma_dtype, beta, beta_dtype, out, ws, B, HW, C, G,
#               eps, act, nchunks, dtype, vec, stream)
_GN_ARGTYPES = [_P, _P, _I, _P, _I, _P, _P] + [_I] * 4 + [_F] + [_I] * 4 + [_P]
# st_group_norm_fold: the same without out and act
_FOLD_ARGTYPES = [_P, _P, _I, _P, _I, _P] + [_I] * 4 + [_F] + [_I] * 3 + [_P]
_APPLY_ARGTYPES = [_P] * 4 + [_I] * 6 + [_P]


def _workspace(x: torch.Tensor, vec: int) -> tuple[torch.Tensor, int]:
    """One allocation for the kernels' scratch: scale and shift ((B, C) f32
    each, first), then the (B, chunks, C) double partial sums and squares."""
    n, h, w, c = x.shape
    nchunks = stats_chunks(h * w, c, vec)
    return torch.empty(n * c * (1 + 2 * nchunks), dtype=torch.float64,
                       device=x.device), nchunks


def scale_shift(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                num_groups: int = 32, eps: float = 1e-5) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(B, C) f32 scale and shift of NHWC x such that
    ``normalize(x) = x * scale + shift``: the stats and fold kernels
    (``st_group_norm_fold``), or for CPU tensors :func:`moments_plain` then
    :func:`fold`. Counts nothing: its caller (the fused GN conv) counts its
    op."""
    if x.device.type == "cpu":
        s1, s2 = moments_plain(x)
        return fold(s1, s2, gamma, beta, hw=x.shape[1] * x.shape[2], num_groups=num_groups,
                    eps=eps)
    _check_cuda(x)
    gamma, beta = _params(x, gamma, beta)
    n, h, w, c = x.shape
    vec = _vec(x)
    ws, nchunks = _workspace(x, vec)
    fn = function("st_group_norm_fold", _FOLD_ARGTYPES)
    with on_device(x.device):
        stream = current_stream(x.device)
        code = fn(x.data_ptr(), gamma.data_ptr(), DTYPE_CODES[gamma.dtype], beta.data_ptr(),
                  DTYPE_CODES[beta.dtype], ws.data_ptr(), n, h * w, c, num_groups, eps, nchunks,
                  DTYPE_CODES[x.dtype], vec, stream)
    check(code, "st_group_norm_fold")
    both = ws[:n * c].view(torch.float32).view(2, n, c)
    return both[0], both[1]


def apply(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
          act: str | None) -> torch.Tensor:
    """x * scale + shift (+SiLU) per (batch, channel), by the apply kernel
    alone (the plain version for CPU tensors). Counts nothing."""
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
        stream = current_stream(x.device)
        code = fn(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(), n,
                  h * w, c, ACT_CODES[act], DTYPE_CODES[x.dtype], _vec(x), stream)
    check(code, "st_group_norm_apply")
    return out


@register("group_norm", "cuda")
def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
               num_groups: int = 32, eps: float = 1e-5,
               act: str | None = None) -> torch.Tensor:
    """GroupNorm over NHWC x (+SiLU): stats, fold and apply kernels behind
    one C entry (``st_group_norm``)."""
    n, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if act not in SILU_ACTS:
        raise ValueError(f"group norm kernel takes act in {list(SILU_ACTS)}, got {act!r}")
    if x.device.type == "cpu":
        return group_norm_plain(x, gamma, beta, num_groups=num_groups, eps=eps, act=act)
    _check_cuda(x)
    gamma, beta = _params(x, gamma, beta)
    vec = _vec(x)
    ws, nchunks = _workspace(x, vec)
    out = torch.empty_like(x)
    fn = function("st_group_norm", _GN_ARGTYPES)
    with on_device(x.device):
        stream = current_stream(x.device)
        code = fn(x.data_ptr(), gamma.data_ptr(), DTYPE_CODES[gamma.dtype], beta.data_ptr(),
                  DTYPE_CODES[beta.dtype], out.data_ptr(), ws.data_ptr(), n, h * w, c,
                  num_groups, eps, ACT_CODES[act], nchunks, DTYPE_CODES[x.dtype], vec, stream)
    check(code, "st_group_norm")
    LAUNCHES.add(f"{'bf16' if x.dtype == torch.bfloat16 else 'f32'} b={n} {h}x{w} "
                 f"c={c} g={num_groups} act={act}")
    return out
