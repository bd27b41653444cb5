"""Attention through the hand-written Hopper kernels ``csrc/flash_attention.cu``.

Replaces five Pallas TPU kernels of ``stabletriton_tpu/kernels/flash_attention.py``,
which the JAX package routes by head packing and key count:
``_packed_single_kv_kernel`` (K1) and ``_packed_flash_kernel`` (K2), the
SDXL UNet's d=64 attention with heads packed into 128 lanes;
``_flash_kernel`` (K3) and ``_single_kv_kernel_bh`` (K4), head-major
attention over a KV loop or one KV block (SD1.5's d = 40, 80, 160, which do
not pack; the VAE mid-block, h=1, d=512, f32); and ``_single_kv_kernel``
(K5), all heads against a tiny KV of at most 128 keys (SD1.5's cross
attention against 77 keys). :func:`attention_class` is that rule; each
launch is counted under its class.

On the card, bf16 runs ``attn_wgmma_bf16<D>`` (K1-K4 above 128 keys: TMA
loads of K and V tiles and wgmma products with the scores and P kept in
registers) or ``attn_tinykv_wgmma_bf16<D>`` (at most 128 keys: K5 and K1's
cross-attention; the same device steps with the head's whole K and V
resident, a block taking the query tiles of :func:`tiny_kv_plan`) for D in
{40, 64, 80, 160}; each launch is still counted under its class. What
bounds them and what their design does about it is in the source's note:
the shift-free softmax ``exp2(min(s, 80))`` of the JAX kernels needs no
running max, so the accumulator is never rescaled and stays in registers
across KV tiles; q, k and v are read straight out of the fused projection
buffers by (row stride, column offset), so no split copies are made.

f32 (D in {64, 512}: the VAE's mid-block attention, h=1, d=512) runs as two
launches of one 3xTF32 GEMM, ``gemm_wgmma_tf32x3``, a chunk of query rows
at a time (:func:`attention_chunk_rows`): S = Q K^T with p = exp2(min(s,
80)) and its row sums in the epilogue, written to a workspace in f32, then
O = P V divided by the row sums. tf32 wgmma has no transpose, so K (as it
lies: keys x d) and V^T (d x keys) come split into big / small parts by
:func:`tf32_attention_operands` (plain torch, inside the kernel's time); q
is read in place and scaled in the kernel's registers.

The plain version (:func:`attention_plain`) computes the same function in
PyTorch; the wrappers use it only for tensors that lie on the CPU. A CUDA
tensor goes to a kernel or the wrapper raises. What a launch's signature
decides (checks, class, kernel, the rounded q scale, the tile plan, the
launch key) is computed once per signature (:func:`_route`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from stabletriton_tpu_torch.kernels import autotune, wgmma_plan
from stabletriton_tpu_torch.kernels.build import (
    LaunchCounter, check, current_stream, function, on_device)
from stabletriton_tpu_torch.ops.registry import register

LOG2E = 1.4426950408889634
SOFTMAX_CLIP = 80.0
LANES = 128  # the TPU lane width behind the JAX package's routing rule
# head dims each dtype's kernels take
HEAD_DIMS = {torch.bfloat16: (40, 64, 80, 160), torch.float32: (64, 512)}

LAUNCHES = LaunchCounter()


def pack_factor(h: int, d: int) -> int:
    """Whole heads per 128-lane block in the JAX package's head-packed
    kernels; 1 when d does not divide 128 or h is not a multiple of it."""
    pack = LANES // d if (d <= LANES and LANES % d == 0) else 1
    return pack if pack > 1 and h % pack == 0 else 1


def attention_class(h: int, d: int, sk: int) -> str:
    """The JAX package's Pallas kernel that a launch stands in for, by its
    routing (``pack_factor``, ``_can_pack``, ``_attn_layout``,
    ``_pick_blocks``): packed heads K1 (whole KV in one 1024 block) or K2;
    unpacked heads K5 (Sk <= 128), K4 (Sk <= 1024) or K3; h=1 is K3."""
    if h == 1:
        return "K3"
    if pack_factor(h, d) > 1:
        return "K1" if sk <= 1024 else "K2"
    if sk <= LANES:
        return "K5"
    return "K4" if sk <= 1024 else "K3"


def kernel_name(dtype: torch.dtype, sk: int) -> str:
    """The CUDA kernel that runs a launch, whatever its class: in bf16 the
    tiny-KV wgmma kernel for at most TINY_KV_KEYS keys (K5, and K1's
    cross-attention against 77 keys, where it measured faster than the KV
    loop at both SDXL shapes, PERF.md) and the wgmma kernel above; in f32
    the 3xTF32 GEMM."""
    if dtype != torch.bfloat16:
        return "wgmma_tf32x3"
    return "tinykv_wgmma_bf16" if sk <= TINY_KV_KEYS else "wgmma_bf16"


QUERY_TILE = 128  # query rows of a tile of the bf16 kernels
TINY_KV_KEYS = 128  # keys the tiny-KV kernel holds resident
TINY_KV_Q_BOXES = 4  # 16 KB boxes of query tiles a tiny-KV block stages (64 KB)


def tiny_kv_tiles_cap(d: int) -> int:
    """The most query tiles a tiny-KV block takes: those whose Q fits its
    TINY_KV_Q_BOXES boxes of 64 columns."""
    return TINY_KV_Q_BOXES // -(-d // 64)


class TinyKvPlan(NamedTuple):
    tiles: int   # consecutive 128-row query tiles of one (batch, head) a block takes
    blocks: int  # the grid: b * h * ceil(query tiles / tiles)


def tiny_kv_plan(b: int, h: int, sq: int, d: int) -> TinyKvPlan:
    """The tiny-KV kernel's grid: the fewest query tiles a block that still
    fit the card's resident blocks in one wave (two an SM at d <= 64, where
    a block takes 128 registers a thread; one above), so a block pays its
    barrier init and K / V load once for several tiles; at most the tiles
    whose Q fits TINY_KV_Q_BOXES boxes of 64 columns."""
    q_tiles = -(-sq // QUERY_TILE)
    slots = wgmma_plan.SMS * (2 if d <= 64 else 1)
    tiles = min(tiny_kv_tiles_cap(d), max(1, -(-(b * h * q_tiles) // slots)))
    return TinyKvPlan(tiles, b * h * -(-q_tiles // tiles))


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_heads: int = 1, scale: float | None = None) -> torch.Tensor:
    """The kernels' function in plain PyTorch: q (B, Sq, H*D), k/v (B, Sk, H*D)
    -> (B, Sq, H*D). q times scale*log2(e), both rounded to q's dtype as in
    JAX; base-2 shift-free softmax with f32 sums; one rounding at the end."""
    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)

    def split(x, s):
        return x.reshape(b, s, num_heads, d).transpose(1, 2).float()

    qs = q * torch.tensor(scale * LOG2E, dtype=q.dtype)
    s = torch.matmul(split(qs, sq), split(k, sk).transpose(-1, -2))
    p = torch.exp2(torch.clamp(s, max=SOFTMAX_CLIP))
    l = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), split(v, sk)) / l.clamp(min=1e-30)
    return out.to(q.dtype).transpose(1, 2).reshape(b, sq, c)


def division_targets(live: int, bound: int = 20000) -> torch.Tensor:
    """The integers x in [-bound, bound] whose f32 quotient x / live rounds
    to another bf16 than x * float32(1 / live): the outputs on which an
    epilogue that multiplies by the row's reciprocal differs from one that
    divides, as the JAX kernels do."""
    x = torch.arange(-bound, bound + 1, dtype=torch.float32)
    quotient = (x / live).to(torch.bfloat16)
    product = (x * torch.tensor(1.0 / live, dtype=torch.float32)).to(torch.bfloat16)
    return x[quotient != product]


def division_probe(b: int, sq: int, sk: int, h: int, d: int, live: int, *, seed: int = 0):
    """Attention operands on which every kernel's output is an exact f32
    quotient: q, k, v (B, Sq or Sk, H*D) float32 holding bf16 values, and
    x (B, H*D), each output column's key sum. The first ``live`` keys score
    0 (p = 1, so l = live) and the rest score about -2000 (p = 0): q is 0
    but for a 1 in each head's first column when some keys are dead, and
    those keys' k is -20480 there, the live keys' 0 (k is random elsewhere).
    Each v column holds the bf16 parts of one of :func:`division_targets`
    on keys 0 and live - 1 and a cancelling pair +-m on two other live keys
    (dead keys: random values), so its f32 sum x is exact in any order and
    every row's output is bf16(x / live)."""
    if not 4 <= live <= sk:
        raise ValueError(f"division_probe needs 4 <= live <= sk, got live={live} sk={sk}")
    gen = torch.Generator().manual_seed(seed)
    c = h * d
    targets = division_targets(live)
    x = targets[torch.randint(len(targets), (b, c), generator=gen)]
    hi = x.to(torch.bfloat16).float()
    m = (2.0 ** torch.randint(8, 15, (b, c), generator=gen)).float()
    v = torch.randn((b, sk, c), generator=gen).to(torch.bfloat16).float()
    v[:, :live] = 0.0
    v[:, 0], v[:, live - 1] = hi, x - hi
    v[:, live // 2], v[:, live // 3] = m, -m
    k = torch.randn((b, sk, c), generator=gen).to(torch.bfloat16).float()
    q = torch.zeros((b, sq, c))
    heads = torch.arange(h) * d
    k[:, :live, heads] = 0.0
    if live < sk:
        k[:, live:, heads] = -20480.0
        q[:, :, heads] = 1.0
    return q, k, v, x


# range_probe's planted key sums, in each head's first columns: 0, targets
# times 2^-110 (quotients under 2^-99) and times +-2^100 (over 2^99) in
# batch 0; +inf, -inf and NaN in batch 1
RANGE_SCALES = (0.0, 2.0 ** -110, 2.0 ** 100, -(2.0 ** 100))
RANGE_NONFINITE = (math.inf, -math.inf, math.nan)
RANGE_ROW = 5  # batch 0's query rows i with i % 32 == RANGE_ROW read half B


def range_probe(b: int, sq: int, sk: int, h: int, d: int, live: int, *, seed: int = 0):
    """Operands whose outputs fall outside the bf16 epilogue's Markstein range
    (csrc/flash_attention.cu ``store_tile``) beside outputs inside it, in the
    rows of one warp: q, k, v (B, Sq or Sk, H*D) float32 holding bf16 values,
    and x (B, Sq, H*D), l (B, Sq), each output being x / l exactly before its
    one rounding. Keys [0, live) form half A, [live, 2 live) half B, the rest
    are dead; a query row scores 0 on one half (p = 1, l = live) and -20480
    on every other key (p = 0). Batch 0's rows i with i % 32 == RANGE_ROW
    (one row of warps 0 and 2 of a 64-row tile) read B, whose v columns sum
    to division targets, scaled in each head's first columns by
    RANGE_SCALES; every other row reads A, whose sums are division targets,
    in range. In batch 1, A's sums are RANGE_NONFINITE in each head's first
    columns (one key each)."""
    if b < 2 or not 4 <= live <= sk // 2 or d < len(RANGE_SCALES):
        raise ValueError(f"range_probe needs b >= 2, 4 <= live <= sk / 2 and d >= 4, got "
                         f"b={b} live={live} sk={sk} d={d}")
    _, _, va, xa = division_probe(b, 1, live, h, d, live, seed=seed)
    _, _, vb, xb = division_probe(b, 1, live, h, d, live, seed=seed + 1)
    c = h * d
    heads = torch.arange(h) * d
    scale = torch.ones(c)
    for j, s in enumerate(RANGE_SCALES):
        scale[heads + j] = s
    vb[0] = vb[0] * scale + 0.0  # + 0: a zero is +0, as the kernels' sums give it
    xb[0] = xb[0] * scale + 0.0
    for j, bad in enumerate(RANGE_NONFINITE):
        va[1, 0, heads + j] = bad
        xa[1, heads + j] = bad
    v = torch.cat([va, vb, torch.zeros((b, sk - 2 * live, c))], 1)
    k = torch.zeros((b, sk, c))
    k[:, :, heads] = k[:, :, heads + 1] = -20480.0
    k[:, :live, heads] = 0.0
    k[:, live:2 * live, heads + 1] = 0.0
    reads_b = torch.zeros((b, sq), dtype=torch.bool)
    reads_b[0, RANGE_ROW::32] = True
    q = torch.zeros((b, sq, c))
    q[:, :, heads] = (~reads_b).float()[..., None]
    q[:, :, heads + 1] = reads_b.float()[..., None]
    x = torch.where(reads_b[..., None], xb[:, None, :], xa[:, None, :])
    return q, k, v, x, torch.full((b, sq), float(live))


# st_flash_attention(3 x (ptr, batch stride, row stride, column offset), out,
#                    B, Sq, Sk, H, D, kernel, qscale, tiles, stream)
_ATTN_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong] * 3
    + [ctypes.c_void_p] + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
)
# st_attention_tf32x3(q, q_sb, q_ss, q_off, k_big, k_small, vt_big, vt_small,
#                     p, l, out, B, Sq, Sk, H, D, rows, qscale, stream)
_TF32_ARGTYPES = ([ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [ctypes.c_void_p] * 7
                  + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
# the bf16 C entry point's kernel codes
_KERNEL_CODES = {"wgmma_bf16": 1, "tinykv_wgmma_bf16": 2}
# the f32 kernel's tiles: 128 query rows x 128 keys; the score workspace of
# one chunk of query rows (f32 P) is held to this many bytes
TF32_TILE = 128
P_WORKSPACE_BYTES = 256 << 20


def attention_chunk_rows(bh: int, sq: int, sk: int) -> int:
    """Query rows of one chunk of the f32 kernel: as many 128-row tiles as
    keep P, (bh, rows, keys rounded up to 128) in f32, within
    P_WORKSPACE_BYTES, at least one tile and at most Sq rounded up. A row's
    arithmetic is the same in any chunk, so the chunking changes no bit of
    the output."""
    keys = -(-sk // TF32_TILE) * TF32_TILE
    rows = P_WORKSPACE_BYTES // (4 * keys * bh) // TF32_TILE * TF32_TILE
    return max(TF32_TILE, min(rows, -(-sq // TF32_TILE) * TF32_TILE))


def tf32_attention_operands(k: torch.Tensor, v: torch.Tensor, num_heads: int):
    """The f32 kernel's B operands from k, v (B, Sk, H*D): K as it lies per
    head, (B*H, Sk, D), and V^T, (B*H, D, keys) with keys = Sk rounded up to
    128 by zero columns (a TMA row is 16-byte aligned and the P V product
    runs over whole 128-key tiles), each as its tf32 big and small parts."""
    b, sk, c = k.shape
    d = c // num_heads
    kh = k.reshape(b, sk, num_heads, d).transpose(1, 2).reshape(b * num_heads, sk, d)
    vt = v.reshape(b, sk, num_heads, d).permute(0, 2, 3, 1).reshape(b * num_heads, d, sk)
    vt = torch.nn.functional.pad(vt, (0, -sk % TF32_TILE))
    return (*wgmma_plan.tf32_parts(kh), *wgmma_plan.tf32_parts(vt))


class Route(NamedTuple):
    """What a launch's signature decides."""
    cls: str       # the JAX package's Pallas kernel it stands in for (K1-K5)
    kernel: str
    qscale: float  # scale * log2(e) rounded to the operand dtype
    tiles: int     # query tiles a block walks (the tiny-KV kernel's plan; else 1)
    key: str       # the launch key


def tuned_plan(dtype: torch.dtype, b: int, sq: int, sk: int, num_heads: int, d: int,
               entry: str) -> tuple[str, int] | None:
    """The autotune table's (kernel, tiles) for one launch of ``entry``
    ("attention", "qkv" or "kv"), checked against what the kernel takes, or
    None where the table names no plan. An entry a kernel cannot take
    raises, naming its key."""
    key = (autotune.attention_key(b, sq, sk, num_heads, d, dtype) if entry == "attention"
           else autotune.fused_attention_key(entry, b, sq, sk, num_heads, d, dtype))
    got = autotune.plan_entry(key)
    if got is None:
        return None
    autotune.check_entry(key, got, ("kernel", "tiles"))
    kernel, tiles = got["kernel"], got["tiles"]
    ok = (dtype == torch.bfloat16 and d in HEAD_DIMS[dtype]
          and ((kernel == "wgmma_bf16" and tiles == 1)
               or (kernel == "tinykv_wgmma_bf16" and sk <= TINY_KV_KEYS
                   and isinstance(tiles, int) and 1 <= tiles <= tiny_kv_tiles_cap(d))))
    if not ok:
        raise ValueError(f"autotune entry {key} = {got}: the bf16 kernels take wgmma_bf16 at "
                         f"tiles 1, or tinykv_wgmma_bf16 at Sk <= {TINY_KV_KEYS} and 1 <= tiles "
                         f"<= {tiny_kv_tiles_cap(d)}")
    return kernel, tiles


@functools.lru_cache(maxsize=None)
def _route(dtype: torch.dtype, b: int, sq: int, sk: int, num_heads: int, d: int,
           scale: float | None, kernel: str | None, offsets: tuple,
           entry: str = "attention", tiles: int | None = None) -> Route:
    """A launch's signature, checked (the ValueError of a bad one; the
    cache keeps no exception, so a bad call raises anew every time) and
    routed. ``kernel`` (and ``tiles``) name the kernel and its plan; else
    the autotune table's entry for ``entry``'s key gives them, else
    :func:`kernel_name` picks the kernel by dtype and key count and
    :func:`tiny_kv_plan` the tiles. Pure and cached: the host item of the
    rounded q scale and the key's string are made once, not on each of a
    step's launches; :func:`autotune.record` clears the cache."""
    if dtype not in HEAD_DIMS:
        raise ValueError(f"attention kernel takes float32 or bfloat16 operands, got {dtype}")
    if d not in HEAD_DIMS[dtype]:
        raise ValueError(f"attention kernel takes head dims {HEAD_DIMS[dtype]} "
                         f"in {dtype}, got {d}")
    if sk < 1:
        raise ValueError("attention needs at least one key")
    if dtype == torch.bfloat16 and any(off % 8 for off in offsets):
        raise ValueError("bf16 attention operands must be 16-byte aligned "
                         "(base, row and batch strides, column offsets)")
    cls = attention_class(num_heads, d, sk)
    if kernel is None:
        kernel, tiles = tuned_plan(dtype, b, sq, sk, num_heads, d, entry) or (None, None)
    kernel = kernel or kernel_name(dtype, sk)
    if kernel not in (_KERNEL_CODES if dtype == torch.bfloat16 else ("wgmma_tf32x3",)):
        raise ValueError(f"attention kernel {kernel} does not take {dtype} operands")
    if kernel == "tinykv_wgmma_bf16" and sk > TINY_KV_KEYS:
        raise ValueError(f"attention kernel {kernel} takes at most {TINY_KV_KEYS} keys, "
                         f"got {sk}")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    # scale*log2(e) rounded to the operand dtype, as JAX's asarray(.., q.dtype)
    qscale = torch.tensor(scale * LOG2E, dtype=dtype).item()
    if kernel != "tinykv_wgmma_bf16":
        tiles = 1
    elif tiles is None:
        tiles = tiny_kv_plan(b, num_heads, sq, d).tiles
    return Route(cls, kernel, qscale, tiles,
                 f"{cls} {kernel} b={b} h={num_heads} d={d} sq={sq} sk={sk}")


def _check_buffers(bufs, dtype) -> None:
    """The checks of one launch that its signature does not decide: the
    buffers' device, dtype and layout."""
    dev = bufs[0].device
    for t in bufs:
        if t.device != dev:
            raise ValueError("attention operands lie on different devices")
        if t.dtype != dtype:
            raise ValueError(f"attention kernel takes float32 or bfloat16 operands "
                             f"of one dtype, got {[t.dtype for t in bufs]}")
        if t.dim() != 3 or t.stride(2) != 1:
            raise ValueError("attention operands must be (B, S, X) with a contiguous last dim")
        # 16-byte TMA rows: base, strides in 8-element units
        if dtype == torch.bfloat16 and (t.data_ptr() % 16 or t.stride(0) % 8 or t.stride(1) % 8):
            raise ValueError("bf16 attention operands must be 16-byte aligned "
                             "(base, row and batch strides, column offsets)")


def _launch(q_buf, q_off, k_buf, k_off, v_buf, v_off, *, sq, sk, num_heads, d,
            scale, kernel=None, tiles=None, entry="attention") -> torch.Tensor:
    """Launch a kernel on (buffer, column offset) operands: each buffer is a
    (B, S, X) tensor whose last dim is contiguous; the head-h columns of the
    operand start at ``offset + h*d``. ``kernel`` (and ``tiles``) name the
    kernel and plan, else :func:`_route` takes them from the autotune table
    under ``entry``'s key or from the rules."""
    dtype = q_buf.dtype
    route = _route(dtype, q_buf.shape[0], sq, sk, num_heads, d, scale, kernel,
                   (q_off, k_off, v_off), entry, tiles)
    _check_buffers((q_buf, k_buf, v_buf), dtype)
    dev = q_buf.device
    b, c = q_buf.shape[0], num_heads * d
    out = torch.empty((b, sq, c), dtype=dtype, device=dev)
    with on_device(dev):
        stream = current_stream(dev)
        if route.kernel == "wgmma_tf32x3":
            _launch_tf32(q_buf, q_off, k_buf[..., k_off:k_off + c], v_buf[..., v_off:v_off + c],
                         out, sq=sq, sk=sk, num_heads=num_heads, qscale=route.qscale,
                         stream=stream)
        else:
            code = function("st_flash_attention", _ATTN_ARGTYPES)(
                q_buf.data_ptr(), q_buf.stride(0), q_buf.stride(1), q_off,
                k_buf.data_ptr(), k_buf.stride(0), k_buf.stride(1), k_off,
                v_buf.data_ptr(), v_buf.stride(0), v_buf.stride(1), v_off,
                out.data_ptr(), b, sq, sk, num_heads, d, _KERNEL_CODES[route.kernel],
                route.qscale, route.tiles, stream,
            )
            if code == -1:
                raise ValueError(f"attention kernel {route.kernel} has no instance for "
                                 f"d={d} sk={sk}")
            check(code, "st_flash_attention")
    LAUNCHES.add(route.key)
    return out


def _launch_tf32(q_buf, q_off, k, v, out, *, sq, sk, num_heads, qscale, stream):
    """The f32 kernel: k, v (B, Sk, C) split into its B operands, q read in
    place where TMA takes it (16-byte base, strides and column offset in
    4-float units; else a contiguous copy of its columns), the P and row-sum
    workspaces of one chunk of query rows."""
    b, c = out.shape[0], out.shape[2]
    d = c // num_heads
    if q_buf.data_ptr() % 16 or q_buf.stride(0) % 4 or q_buf.stride(1) % 4 or q_off % 4:
        q_buf, q_off = q_buf[..., q_off:q_off + c].contiguous(), 0
    parts = tf32_attention_operands(k, v, num_heads)
    rows = attention_chunk_rows(b * num_heads, sq, sk)
    keys = parts[2].shape[2]
    p = torch.empty((b * num_heads, rows, keys), dtype=torch.float32, device=out.device)
    l = torch.empty((b * num_heads, rows, keys // TF32_TILE), dtype=torch.float32,
                    device=out.device)
    code = function("st_attention_tf32x3", _TF32_ARGTYPES)(
        q_buf.data_ptr(), q_buf.stride(0), q_buf.stride(1), q_off,
        *(t.data_ptr() for t in parts), p.data_ptr(), l.data_ptr(), out.data_ptr(),
        b, sq, sk, num_heads, d, rows, qscale, stream)
    check(code, "st_attention_tf32x3")


def _check_shapes(q, k, v, num_heads):
    b, sq, c = q.shape
    if c % num_heads:
        raise ValueError(f"channels {c} not divisible by {num_heads} heads")
    if k.shape[0] != b or v.shape[0] != b or k.shape[2] != c or v.shape != k.shape:
        raise ValueError(f"attention shapes disagree: {q.shape} {k.shape} {v.shape}")


@register("attention", "cuda")
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    num_heads: int = 1, scale: float | None = None) -> torch.Tensor:
    """q: (B, Sq, H*D); k, v: (B, Sk, H*D) -> (B, Sq, H*D)."""
    _check_shapes(q, k, v, num_heads)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, num_heads=num_heads, scale=scale)
    d = q.shape[2] // num_heads
    return _launch(q, 0, k, 0, v, 0, sq=q.shape[1], sk=k.shape[1],
                   num_heads=num_heads, d=d, scale=scale)


@register("attention_qkv", "cuda")
def flash_attention_qkv(qkv: torch.Tensor, *, num_heads: int = 1,
                        scale: float | None = None) -> torch.Tensor:
    """Self-attention read straight out of the fused (B, S, 3C) QKV buffer."""
    b, s, c3 = qkv.shape
    if c3 % 3:
        raise ValueError(f"fused qkv width {c3} is not 3*C")
    c = c3 // 3
    if qkv.device.type == "cpu":
        q, k, v = qkv.chunk(3, dim=-1)
        return attention_plain(q, k, v, num_heads=num_heads, scale=scale)
    if c % num_heads:
        raise ValueError(f"channels {c} not divisible by {num_heads} heads")
    return _launch(qkv, 0, qkv, c, qkv, 2 * c, sq=s, sk=s, num_heads=num_heads,
                   d=c // num_heads, scale=scale, entry="qkv")


@register("attention_kv", "cuda")
def flash_attention_kv(q: torch.Tensor, kv: torch.Tensor, *, num_heads: int = 1,
                       scale: float | None = None) -> torch.Tensor:
    """Cross-attention of q (B, Sq, C) against the fused (B, Sk, 2C) KV buffer."""
    b, sq, c = q.shape
    if kv.shape[0] != b or kv.shape[2] != 2 * c:
        raise ValueError(f"fused kv {tuple(kv.shape)} does not match q {tuple(q.shape)}")
    if q.device.type == "cpu":
        k, v = kv.chunk(2, dim=-1)
        return attention_plain(q, k, v, num_heads=num_heads, scale=scale)
    if c % num_heads:
        raise ValueError(f"channels {c} not divisible by {num_heads} heads")
    return _launch(q, 0, kv, 0, kv, c, sq=sq, sk=kv.shape[1], num_heads=num_heads,
                   d=c // num_heads, scale=scale, entry="kv")
