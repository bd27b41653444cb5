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
M <= 16 to a skinny kernel that reads w once as 16-byte vectors, whole
128-byte lines of a row where N allows, from enough blocks to fill the card
(a column slice each, K split over a thread block cluster whose blocks add
their partials in rank order; :func:`skinny_plan`), with x staged once in
shared memory; f32 with M > 16 to the
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

The launch path serves every K13 launch (532 an all-kernel SDXL step), so
what depends only on the signature (shapes, dtypes, bias, act and whether
the bases are 16-byte aligned: the checks, the kernel, its plan, the launch
key and the C entry's integer arguments) is worked out once by the cached
:func:`_route`; a call checks its devices, makes the output and makes one
ctypes call.

The plain version (:func:`linear_plain`) computes the kernel's function in
PyTorch; the wrapper uses it only for tensors on the CPU. A CUDA tensor goes
to the kernel or the wrapper raises.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from stabletriton_tpu_torch.kernels import autotune, wgmma_plan
from stabletriton_tpu_torch.kernels.build import (
    ACT_CODES, DTYPE_CODES, LaunchCounter, check, current_stream, function, on_device)
from stabletriton_tpu_torch.ops.reference import apply_activation
from stabletriton_tpu_torch.ops.registry import register

LAUNCHES = LaunchCounter()

SKINNY_MAX_M = 16  # rows the skinny kernel takes (csrc/linear.cu SKINNY_MAX_M)
SKINNY_THREADS = 256  # a block of the skinny kernel
SKINNY_WIDTHS = (8, 4, 2)  # 16-byte vectors of a w row a skinny block may take
SKINNY_MAX_SPLITS = 8  # blocks of one cluster (the portable cluster size)

_P, _I = ctypes.c_void_p, ctypes.c_int
# st_linear(x, w, bias, bias_dtype, out, M, N, K, act, dtype, variant, stream)
_LINEAR_ARGTYPES = [_P, _P, _P, _I, _P] + [_I] * 6 + [_P]
# st_linear_skinny(x, w, bias, out, stream, dims): dims points at a SkinnyDims
_SKINNY_ARGTYPES = [_P] * 6
# st_linear_wgmma(x, w, bias, bias_dtype, out, ws, M, N, K, act, bn, splits, stream)
_WGMMA_ARGTYPES = [_P, _P, _P, _I, _P, _P] + [_I] * 6 + [_P]
# st_linear_tf32x3(x, w, ws, bias, bias_dtype, out, M, N, K, Kw, act, stream)
_TF32_ARGTYPES = [_P, _P, _P, _P, _I, _P] + [_I] * 5 + [_P]


class SkinnyPlan(NamedTuple):
    cols: int    # output columns a block takes: 8, 4 or 2 vectors of 16 bytes
    splits: int  # blocks over K (one thread block cluster), at most SKINNY_MAX_SPLITS
    rows: int    # rows of K each of them takes; the last may take fewer


def skinny_plan(m: int, k: int, n: int, itemsize: int) -> SkinnyPlan:
    """The skinny kernel's launch at (m, k) @ (k, n): blocks of 256 threads,
    each taking ``cols`` columns over ``rows`` rows of K, ``splits`` of them
    covering K; ceil(n / cols) x splits blocks in all. The widest slice
    whose blocks reach half the card's 132 SMs at a K split of at most 8
    (each split at least one pass of the block's rows, 256 / vectors a row),
    else the narrowest; then the least split that fills the SMs, at most 8.
    Whole 128-byte lines of a w row (8 vectors) weigh more than a block on
    every SM: on an H100 80GB HBM3 at 700 W (``chip_smoke.py --plans``)
    (2,1280)@(1280,320) took 4.4 us in 80 blocks of 32 columns and 5.0 us
    in 140 of 16. Pure, so the CPU tests cover it."""
    vec = 16 // itemsize
    for width in SKINNY_WIDTHS:
        cols = width * vec
        slices = -(-n // cols)
        passes = max(1, -(-k // (SKINNY_THREADS // width)))
        if slices * min(SKINNY_MAX_SPLITS, passes) >= wgmma_plan.SMS // 2:
            break
    splits = min(SKINNY_MAX_SPLITS, passes, -(-wgmma_plan.SMS // slices))
    rows = max(1, -(-k // splits))
    return SkinnyPlan(cols, max(1, -(-k // rows)), rows)


class SkinnyDims(ctypes.Structure):
    """st_linear_skinny's integer arguments (csrc/linear.cu SkinnyDims), made
    once per signature: ctypes converts every argument of every call."""
    _fields_ = [(f, ctypes.c_int) for f in ("m", "n", "k", "act", "dtype", "bias_dtype", "cols",
                                            "splits", "rows")]


class Route(NamedTuple):
    """What a signature decides about one launch of the linear kernels."""
    name: str | None        # the kernel (variant()); None: an empty output, no launch
    key: str                # the launch key
    out_shape: tuple        # (..., N)
    m: int
    n: int
    k: int
    plan: wgmma_plan.Plan | SkinnyPlan | None
    ints: tuple             # the C entry's integer arguments (skinny, WMMA)
    dims: SkinnyDims | None = None  # the skinny kernel's, made of ints
    address: int = 0        # of dims, which the route keeps alive


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


def _check_operands(k: int, w_shape: tuple, b_shape: tuple | None, act: str | None) -> None:
    """The checks of a call's act and operand shapes, on every device."""
    if act not in ACT_CODES:
        raise ValueError(f"linear kernel takes act in {list(ACT_CODES)}, got {act!r}")
    if len(w_shape) != 2 or w_shape[0] != k:
        raise ValueError(f"weight {tuple(w_shape)} is not ({k}, N)")
    if b_shape is not None and tuple(b_shape) != (w_shape[1],):
        raise ValueError(f"bias {tuple(b_shape)} is not ({w_shape[1]},)")


def check_devices(x_device, w_device, b_device) -> None:
    """The operands lie on one device (b_device None: no bias)."""
    if w_device != x_device or (b_device is not None and b_device != x_device):
        raise ValueError("linear operands lie on different devices")


def tuned_plan(m: int, k: int, n: int, dtype: torch.dtype,
               name: str) -> wgmma_plan.Plan | SkinnyPlan | None:
    """The autotune table's plan for the GEMM, checked against what kernel
    ``name`` (:func:`variant`'s pick) takes, or None where the table names no
    plan. An entry the kernel cannot take raises, naming its key."""
    key = autotune.linear_key(m, k, n, dtype)
    entry = autotune.plan_entry(key)
    if entry is None:
        return None
    if name == "wgmma_bf16":
        autotune.check_entry(key, entry, ("bn", "splits"))
        plan = wgmma_plan.Plan(entry["bn"], entry["splits"])
        if (plan.bn not in wgmma_plan.WIDTHS
                or not 1 <= plan.splits <= min(-(-k // wgmma_plan.BK), wgmma_plan.MAX_SPLITS)):
            raise ValueError(f"autotune entry {key} = {entry}: the wgmma GEMM takes bn in "
                             f"{wgmma_plan.WIDTHS} and 1 <= splits <= K steps, at most "
                             f"{wgmma_plan.MAX_SPLITS}")
        return plan
    if name.startswith("skinny"):
        autotune.check_entry(key, entry, ("cols", "splits"))
        cols, splits = entry["cols"], entry["splits"]
        vec = 16 // dtype.itemsize
        rows = -(-k // splits) if 1 <= splits <= SKINNY_MAX_SPLITS else 0
        if (cols not in [w * vec for w in SKINNY_WIDTHS] or rows < 1
                or -(-k // rows) != splits):
            raise ValueError(f"autotune entry {key} = {entry}: the skinny kernel takes cols "
                             f"in {[w * vec for w in SKINNY_WIDTHS]} and a K split of at most "
                             f"{SKINNY_MAX_SPLITS} blocks that each take rows of K")
        return SkinnyPlan(cols, splits, rows)
    raise ValueError(f"autotune entry {key} = {entry}: the {name} kernel takes no plan")


@functools.lru_cache(maxsize=None)
def _route(x_shape: tuple, w_shape: tuple, b_shape: tuple | None, dtype: torch.dtype,
           b_dtype: torch.dtype | None, act: str | None, aligned: bool = True,
           name: str | None = None, plan=None) -> Route:
    """A launch's signature, checked (the ValueError of a bad operand; the
    cache keeps no exception, so a bad call raises anew every time) and
    routed: the kernel (``name``, or :func:`variant`'s; ``aligned``: x's and
    w's bases are 16-byte aligned), its plan (``plan``, else the autotune
    table's, else the fitted rule's: ``wgmma_plan.gemm_plan`` or
    :func:`skinny_plan`), the launch key and the C entry's integer
    arguments. Pure and cached: the eager step launches hundreds of GEMMs
    of a few dozen signatures; :func:`autotune.record` clears the cache."""
    k = x_shape[-1]
    _check_operands(k, w_shape, b_shape, act)
    if dtype not in DTYPE_CODES or (b_dtype is not None and b_dtype not in DTYPE_CODES):
        raise ValueError(f"linear kernel takes float32 or bfloat16, got {dtype}"
                         + ("" if b_dtype is None else f" with a {b_dtype} bias"))
    n = w_shape[1]
    m = math.prod(x_shape[:-1])
    out_shape = (*x_shape[:-1], n)
    if m == 0 or n == 0:
        return Route(None, "", out_shape, m, n, k, None, ())
    if max(m, n, k) >= 2**31:
        raise ValueError(f"linear kernel takes dims below 2^31, got ({m}, {k}) @ ({k}, {n})")
    rule_name = variant(m, k, n, dtype, aligned)
    tuned = tuned_plan(m, k, n, dtype, rule_name)
    if name is None or name == rule_name:
        name, plan = rule_name, plan or tuned
    bias = int(b_dtype is not None)
    codes = (m, n, k, ACT_CODES[act], DTYPE_CODES[dtype])
    bias_code = DTYPE_CODES[b_dtype] if bias else 0
    head = f"{name} m={m} k={k} n={n} bias={bias} act={act}"
    if name == "wgmma_bf16":
        plan = plan or wgmma_plan.gemm_plan(m, k, n)
        return Route(name, f"{head} bn={plan.bn} split={plan.splits}", out_shape, m, n, k,
                     plan, ())
    if name.startswith("skinny"):
        plan = plan or skinny_plan(m, k, n, dtype.itemsize)
        ints = (*codes, bias_code, *plan)
        dims = SkinnyDims(*ints)
        return Route(name, f"{head} cols={plan.cols} split={plan.splits}", out_shape, m, n, k,
                     plan, ints, dims, ctypes.addressof(dims))
    return Route(name, head, out_shape, m, n, k, None, (*codes, 1))


def _run(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, act: str | None,
         route: Route) -> torch.Tensor:
    """Launch ``route`` on contiguous CUDA operands x (..., K), w (K, N) of
    one dtype and b (N,) or None; x is read as its (M, K) rows and the
    output (..., N) is made in its final shape, so no reshape costs host
    time."""
    out = x.new_empty(route.out_shape)
    bias_ptr = None if b is None else b.data_ptr()
    name = route.name
    with on_device(x.device):
        stream = current_stream(x.device)
        if name.startswith("skinny"):
            code = function("st_linear_skinny", _SKINNY_ARGTYPES)(
                x.data_ptr(), w.data_ptr(), bias_ptr, out.data_ptr(), stream, route.address)
            check(code, f"linear kernel {name}")
            return out
        bias_code = 0 if b is None else DTYPE_CODES[b.dtype]
        m, n, k, plan = route.m, route.n, route.k, route.plan
        if name == "wgmma_tf32x3":
            x2 = _tf32_rows(x.reshape(m, k))
            ws = torch.empty(2 * n * x2.shape[1], dtype=torch.float32, device=x.device)
            code = function("st_linear_tf32x3", _TF32_ARGTYPES)(
                x2.data_ptr(), w.data_ptr(), ws.data_ptr(), bias_ptr, bias_code, out.data_ptr(),
                m, n, x2.shape[1], k, ACT_CODES[act], stream)
        elif name == "wgmma_bf16":
            ws = (torch.empty((plan.splits, m, n), dtype=torch.float32, device=x.device)
                  if plan.splits > 1 else None)
            code = function("st_linear_wgmma", _WGMMA_ARGTYPES)(
                x.data_ptr(), w.data_ptr(), bias_ptr, bias_code, out.data_ptr(),
                None if ws is None else ws.data_ptr(), m, n, k, ACT_CODES[act], plan.bn,
                plan.splits, stream)
        else:
            code = function("st_linear", _LINEAR_ARGTYPES)(
                x.data_ptr(), w.data_ptr(), bias_ptr, bias_code, out.data_ptr(), *route.ints,
                stream)
    check(code, f"linear kernel {name}")
    return out


def _launch(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, act: str | None,
            name: str, plan=None) -> tuple[torch.Tensor, str]:
    """Launch kernel ``name`` (at ``plan``, else its route's) on contiguous
    CUDA operands as :func:`_run` does (the route of another kernel than the
    wrapper's, for timing it beside; a candidate plan, for the tuner);
    returns the output and the launch key."""
    route = _route(x.shape, w.shape, None if b is None else b.shape, x.dtype,
                   None if b is None else b.dtype, act, name=name, plan=plan)
    return _run(x, w, b, act, route), route.key


@register("linear", "cuda")
def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           act: str | None = None) -> torch.Tensor:
    """x (..., K) @ w (K, N) + b (N,), then ``act`` (None, "silu" or "gelu").
    x is read as its (M, K) rows and copied only if it is not contiguous;
    the bias is read in its own dtype (float32 or bfloat16). A quantized
    (int8, scale) pair raises: bind linear to "int8" for those."""
    if isinstance(w, tuple):
        raise ValueError("the linear kernel takes a float weight, not a quantized (int8, "
                         "scale) pair; bind linear to \"int8\" (CompileConfig.quantize)")
    if x.is_cpu:
        _check_operands(x.shape[-1], w.shape, None if b is None else b.shape, act)
        return linear_plain(x, w, b, act=act)
    if not x.is_contiguous():
        x = x.contiguous()
    if w.dtype != x.dtype:
        w = w.to(x.dtype)
    if not w.is_contiguous():
        w = w.contiguous()
    if b is not None and not b.is_contiguous():
        b = b.contiguous()
    route = _route(x.shape, w.shape, None if b is None else b.shape, x.dtype,
                   None if b is None else b.dtype, act,
                   not (x.data_ptr() % 16 or w.data_ptr() % 16))
    check_devices(x.get_device(), w.get_device(), None if b is None else b.get_device())
    if route.name is None:
        return x.new_empty(route.out_shape)
    out = _run(x, w, b, act, route)
    LAUNCHES.add(route.key)
    return out
