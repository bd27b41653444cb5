"""GroupNorm through the hand-written Hopper kernels ``csrc/group_norm.cu``.

Replaces the Pallas TPU kernels ``_stats_kernel`` and ``_apply_kernel`` of
``stabletriton_tpu/kernels/group_norm.py`` (K9), and the fold between them
that the JAX package leaves to XLA: NHWC GroupNorm with f32 moments and an
optional fused SiLU, for the UNet's transformer GroupNorms (bf16, no
activation) and every GroupNorm of the VAE decoder (f32, SiLU, up to (1,
1024, 1024, 128)). Its stats and fold also feed the fused GN conv
(:func:`conv_direct.gn_conv2d_fused`, through :func:`scale_shift`).

What bounds it on the H100: device memory, one read of x for the moments
and one read and one write for the apply, at about one FLOP per byte, far
under the card's ~295 FLOP/B balance point; on the host, the launches.

What the design does about it: ``st_group_norm`` launches two kernels on
the caller's stream. The first takes the moments and folds them in one
launch: :func:`plan` cuts each image into units (a slab of ``sv`` 16-byte
channel vectors that holds whole groups, by a chunk of rows; every lane has
a vector), each thread keeps four 16-byte loads in flight and sums runs of
16 rows in f32 into a double, and the last block of each (image, slab) to
take its ticket sums the slab's chunk partials in chunk order and folds the
slab's groups (channel order, f32, E[x^2] - mean^2 clamped at 0) into scale
and shift (B, C) f32. Its loads carry an L2 evict_last policy, so where x
fits the L2 the second kernel, the apply (:func:`apply_plan`'s units walked
backwards, streaming loads and stores), and the fused GN conv's gather after
``st_group_norm_fold`` (the first kernel alone) read x from L2. The
wrapper makes one workspace allocation (the partials and scale / shift),
the output, and one ctypes call: no PyTorch arithmetic.

The default binding's GroupNorm (:func:`group_norm_bf16apply`, backend
"cuda_bf16apply") runs the same two kernels in their stepwise forms, which
round as the plain ``ops.reference.group_norm_bf16apply`` rounds on the
card: the fold takes each group sum times the f32 1 / count and rstd by
``torch.rsqrt``'s rsqrtf (K9 divides and takes a correctly rounded 1 /
sqrt), and the apply rounds scale and shift to x's dtype, then x * s, + t
and the SiLU each to x's dtype. So that binding keeps its numbers and sheds
the plain chain's 22-27 launches (f32 copies, reductions, repeats) a
GroupNorm. Only the moments' summation order differs from the plain chain's.

Determinism: no float atomics, every sum in a fixed order, and the plans a
function of (H*W, C, vec, groups) alone, so the same input gives the same bits in
every run and an image gets the same scale / shift at every batch bucket.
The tickets are counters in a buffer kept per (device, stream) and zeroed
once (:func:`_tickets`); the block that takes a ticket last sets it back to
0, so every eager call and every graph replay starts from zero. Launches on
one stream run one after another; a graph replays the buffer of the stream
it was captured on, whose eager calls it is ordered with (``runtime/graphs.py``
warms up and captures on one side stream).

The clamp (C3 in ROADMAP.md): the JAX K9 fold takes rsqrt(E[x^2] - mean^2 +
eps) with no clamp and gives NaN where a near-constant group's difference
rounds below 0; the JAX package's own ``_gn_fold`` (K8) and its reference
ops clamp, and so does the port, in the kernel and in :func:`fold`.

CUDA C++ rather than Triton: the repo has one build route (``build.py``),
one launch check and one library, and the L2 cache policies and the ticket
fold are plain PTX / CUDA.

The plain version (:func:`group_norm_plain`: :func:`moments_plain`, then
:func:`fold`, then :func:`apply_plain`) computes the kernels' function in
PyTorch in f32 with one rounding; the wrapper uses it only for tensors on
the CPU. A CUDA tensor goes to the kernels or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from stabletriton_tpu_torch.kernels.build import (
    ACT_CODES, DTYPE_CODES, SILU_ACTS, LaunchCounter, check, current_stream, function,
    on_device)
from stabletriton_tpu_torch.ops import reference
from stabletriton_tpu_torch.ops.registry import register

THREADS = 256          # csrc/group_norm.cu MAX_THREADS: a block's threads at most
LOADS = 4              # 16-byte loads a thread keeps in flight: a chunk's least rows a lane
MIN_SLAB = 4           # vectors a stats slab spans at least (64-byte rows)
STATS_SMEM = 48 * 1024  # csrc/group_norm.cu MAX_SMEM: the stats kernel's shared memory
UNITS_PER_IMAGE = 264  # blocks an image at most: two of the four an SM holds
TICKETS = 1 << 16      # counters of a (device, stream) buffer: B x slabs a launch

# one count per GroupNorm (one st_group_norm call: two kernels);
# the stats and fold launched for the fused GN conv count with that conv
# (conv_direct.GN_LAUNCHES)
LAUNCHES = LaunchCounter()
# one count per GroupNorm of the default binding's form (group_norm_bf16apply)
BF16APPLY_LAUNCHES = LaunchCounter()


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
    own, as the stats kernel's fold (``gn_stats_fold``) computes them."""
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


def _chunks(hw: int, slabs: int, lanes: int) -> tuple[int, int]:
    """(chunk_rows, chunks): at most UNITS_PER_IMAGE units an image where
    the slabs allow (so a CFG batch of two is one wave of four blocks an
    SM), whole row lanes a chunk and at least LOADS rows a lane."""
    rows = -(-hw // max(1, UNITS_PER_IMAGE // slabs))
    rows = max(LOADS * lanes, -(-rows // lanes) * lanes)
    return rows, -(-hw // rows)


@functools.lru_cache(maxsize=None)
def plan(hw: int, c: int, vec: int, groups: int) -> tuple[int, int, int, int]:
    """The stats kernel's units, a function of (H*W, C, vec, groups) only,
    never of B: ``(sv, slabs, chunk_rows, chunks)``. A slab is ``sv``
    channel vectors holding whole groups, the least such multiple of the
    groups' vectors that is at least MIN_SLAB and divides C / vec (all of
    C / vec where none is); a block is THREADS // sv row lanes by sv vector
    lanes, so every lane has a vector at every C, and the last block of a
    slab folds its own groups."""
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    nv, per = c // vec, c // groups
    base = math.lcm(per, vec) // vec
    sv = next((m for m in range(base, nv + 1, base) if m >= MIN_SLAB and nv % m == 0), nv)
    nt = THREADS // sv * sv
    if sv > THREADS or (vec * nt + max(nt, sv * vec)) * 16 > STATS_SMEM:
        raise ValueError(f"group norm kernel takes whole groups in at most {THREADS} vectors "
                         f"and {STATS_SMEM} bytes of shared memory, got C={c}, groups={groups}")
    return (sv, nv // sv, *_chunks(hw, nv // sv, THREADS // sv))


@functools.lru_cache(maxsize=None)
def apply_plan(hw: int, c: int, vec: int) -> tuple[int, int, int, int]:
    """The apply kernel's units, ``(sv, slabs, chunk_rows, chunks)``: slabs
    of gcd(C / vec, 8) vectors (128-byte rows where C / vec is a multiple
    of 8), THREADS // sv row lanes by sv vector lanes."""
    nv = c // vec
    sv = math.gcd(nv, 8)
    return (sv, nv // sv, *_chunks(hw, nv // sv, THREADS // sv))


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
# st_group_norm(x, gamma, gamma_dtype, beta, beta_dtype, out, ws, tickets, B, HW, C,
#               G, eps, act, stepwise, sv, chunk_rows, apply_sv, apply_rows, dtype, vec,
#               stream)
_GN_ARGTYPES = [_P, _P, _I, _P, _I, _P, _P, _P] + [_I] * 4 + [_F] + [_I] * 8 + [_P]
# st_group_norm_fold: the same without out, act and the apply plan
_FOLD_ARGTYPES = [_P, _P, _I, _P, _I, _P, _P] + [_I] * 4 + [_F] + [_I] * 4 + [_P]
# st_group_norm_apply(x, scale, shift, out, B, HW, C, act, sv, chunk_rows, dtype, vec, stream)
_APPLY_ARGTYPES = [_P] * 4 + [_I] * 8 + [_P]

# the ticket buffers, by (device index, raw stream)
_TICKET_BUFFERS: dict[tuple[int, int], torch.Tensor] = {}


def _tickets(x: torch.Tensor, stream: int, need: int) -> torch.Tensor:
    """The (device, stream)'s ticket counters, zeroed once; each launch
    leaves its counters 0 (module docstring). A buffer first needed while the
    stream captures a graph is allocated (and zeroed) inside that capture
    and kept by no other call."""
    if need > TICKETS:
        raise ValueError(f"group norm kernel takes B * slabs <= {TICKETS}, got {need}")
    key = (x.device.index, stream)
    buf = _TICKET_BUFFERS.get(key)
    if buf is None:
        buf = torch.zeros(TICKETS, dtype=torch.int32, device=x.device)
        if not torch.cuda.is_current_stream_capturing():
            buf = _TICKET_BUFFERS.setdefault(key, buf)  # one buffer if two threads race
    return buf


def _workspace(x: torch.Tensor, chunks: int) -> torch.Tensor:
    """One allocation for the kernels' scratch: scale and shift ((B, C) f32
    each, first), then the (B, chunks, C) double2 unit partials."""
    n, _, _, c = x.shape
    return torch.empty(n * c * (1 + 2 * chunks), dtype=torch.float64, device=x.device)


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
    sv, slabs, rows, chunks = plan(h * w, c, vec, num_groups)
    ws = _workspace(x, chunks)
    fn = function("st_group_norm_fold", _FOLD_ARGTYPES)
    with on_device(x.device):
        stream = current_stream(x.device)
        tickets = _tickets(x, stream, n * slabs)
        code = fn(x.data_ptr(), gamma.data_ptr(), DTYPE_CODES[gamma.dtype], beta.data_ptr(),
                  DTYPE_CODES[beta.dtype], ws.data_ptr(), tickets.data_ptr(), n, h * w, c,
                  num_groups, eps, sv, rows, DTYPE_CODES[x.dtype], vec, stream)
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
    vec = _vec(x)
    sv, _, rows, _ = apply_plan(h * w, c, vec)
    fn = function("st_group_norm_apply", _APPLY_ARGTYPES)
    with on_device(x.device):
        stream = current_stream(x.device)
        code = fn(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), out.data_ptr(), n,
                  h * w, c, ACT_CODES[act], sv, rows, DTYPE_CODES[x.dtype], vec, stream)
    check(code, "st_group_norm_apply")
    return out


def _check_args(c: int, num_groups: int, act: str | None) -> None:
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    if act not in SILU_ACTS:
        raise ValueError(f"group norm kernel takes act in {list(SILU_ACTS)}, got {act!r}")


def _group_norm(x, gamma, beta, num_groups, eps, act, stepwise, counter):
    """One st_group_norm call on a CUDA tensor, counted on ``counter``."""
    n, h, w, c = x.shape
    _check_args(c, num_groups, act)
    _check_cuda(x)
    gamma, beta = _params(x, gamma, beta)
    vec = _vec(x)
    sv, slabs, rows, chunks = plan(h * w, c, vec, num_groups)
    apply_sv, _, apply_rows, _ = apply_plan(h * w, c, vec)
    ws = _workspace(x, chunks)
    out = torch.empty_like(x)
    fn = function("st_group_norm", _GN_ARGTYPES)
    with on_device(x.device):
        stream = current_stream(x.device)
        tickets = _tickets(x, stream, n * slabs)
        code = fn(x.data_ptr(), gamma.data_ptr(), DTYPE_CODES[gamma.dtype], beta.data_ptr(),
                  DTYPE_CODES[beta.dtype], out.data_ptr(), ws.data_ptr(), tickets.data_ptr(), n,
                  h * w, c, num_groups, eps, ACT_CODES[act], int(stepwise), sv, rows, apply_sv,
                  apply_rows, DTYPE_CODES[x.dtype], vec, stream)
    check(code, "st_group_norm")
    counter.add(f"{'bf16' if x.dtype == torch.bfloat16 else 'f32'} b={n} {h}x{w} "
                f"c={c} g={num_groups} act={act}")
    return out


@register("group_norm", "cuda")
def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
               num_groups: int = 32, eps: float = 1e-5,
               act: str | None = None) -> torch.Tensor:
    """GroupNorm over NHWC x (+SiLU): the stats-and-fold kernel and the
    apply kernel behind one C entry (``st_group_norm``)."""
    if x.device.type == "cpu":
        _check_args(x.shape[3], num_groups, act)
        return group_norm_plain(x, gamma, beta, num_groups=num_groups, eps=eps, act=act)
    return _group_norm(x, gamma, beta, num_groups, eps, act, False, LAUNCHES)


@register("group_norm", "cuda_bf16apply")
def group_norm_bf16apply(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
                         num_groups: int = 32, eps: float = 1e-5,
                         act: str | None = None) -> torch.Tensor:
    """The default binding's GroupNorm (+SiLU) on the kernels' stepwise
    forms, which round as ``ops.reference.group_norm_bf16apply`` does (module
    docstring), counted on BF16APPLY_LAUNCHES. A CPU tensor takes that plain
    form."""
    if x.device.type == "cpu":
        return reference.group_norm_bf16apply(x, gamma, beta, num_groups=num_groups, eps=eps,
                                              act=act)
    return _group_norm(x, gamma, beta, num_groups, eps, act, True, BF16APPLY_LAUNCHES)
