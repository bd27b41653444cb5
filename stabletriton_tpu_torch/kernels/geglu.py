"""GEGLU through the hand-written Hopper kernel ``csrc/geglu.cu``.

Replaces the Pallas TPU kernel ``_geglu_kernel`` of
``stabletriton_tpu/kernels/geglu.py`` (K11): state * gelu(gate) with the
exact (erf) gelu, in f32 with one rounding, on the halves of the UNet's
feed-forward projection, (2, 4096, 2560) and (2, 1024, 5120) bf16 at 1024².

What bounds it on the H100: device memory, two reads and one write at a few
FLOPs per byte.

What the design does about it: ``state`` and ``gate`` are the two ``chunk``
views of the (B, S, 2N) projection output; the kernel reads both from that
one buffer by their shared row stride, with 16-byte loads, so no
``.contiguous()`` copy (which would cost more traffic than the kernel
saves) is made; the output is written once. ``erff`` takes the place of the
Pallas kernel's Abramowitz-Stegun polynomial, which exists only because
Mosaic has no erf.

The default binding's GEGLU (:func:`geglu_bf16apply`, backend
"cuda_bf16apply") is the same kernel in its stepwise form: the gelu as
PyTorch's kernel takes it, rounded to the operands' dtype, then the product
rounded, as the plain ``ops.reference.geglu`` (``state * F.gelu(gate)``)
rounds them in its launches.

CUDA C++ rather than Triton: the repo has one build route (``build.py``),
one launch check and one library.

The plain version (:func:`geglu_plain`) computes the kernel's function in
PyTorch; the wrapper uses it only for tensors on the CPU. A CUDA tensor goes
to the kernel or the wrapper raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from stabletriton_tpu_torch.kernels.build import (
    DTYPE_CODES, LaunchCounter, check, current_stream, function, on_device)
from stabletriton_tpu_torch.ops import reference
from stabletriton_tpu_torch.ops.registry import register


LAUNCHES = LaunchCounter()
# launches of the default binding's form (geglu_bf16apply)
BF16APPLY_LAUNCHES = LaunchCounter()


def geglu_plain(state: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: f32 state * gelu(gate), exact
    gelu, one rounding; the output is contiguous."""
    return (state.float() * F.gelu(gate.float(), approximate="none")).to(state.dtype)


# st_geglu(state, gate, rs, out, rows, n, dtype, vec, stepwise, stream)
_GEGLU_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _row_stride(t: torch.Tensor) -> int:
    """The stride between rows of t viewed as (rows, N), or raise if its
    leading dims do not flatten into rows of one stride."""
    if t.stride(-1) != 1:
        raise ValueError("geglu kernel takes operands with a contiguous last dim")
    for i in range(t.dim() - 2):
        if t.stride(i) != t.stride(i + 1) * t.shape[i + 1]:
            raise ValueError(f"geglu operand strides {t.stride()} do not flatten into rows")
    return t.stride(-2) if t.dim() > 1 else t.shape[-1]


def _geglu(state, gate, stepwise, counter):
    """One st_geglu launch on CUDA tensors, counted on ``counter``."""
    if state.dtype not in DTYPE_CODES or gate.dtype != state.dtype:
        raise ValueError(f"geglu kernel takes float32 or bfloat16 operands of one dtype, "
                         f"got {state.dtype} and {gate.dtype}")
    if gate.device != state.device:
        raise ValueError("geglu operands lie on different devices")
    rs = _row_stride(state)
    if _row_stride(gate) != rs or gate.stride() != state.stride():
        raise ValueError(f"geglu operands need one row stride, got {state.stride()} "
                         f"and {gate.stride()}")
    n = state.shape[-1]
    rows = state.numel() // n
    if rows * n >= 2**31:
        raise ValueError(f"geglu kernel takes fewer than 2^31 elements, got {rows * n}")
    vec = 16 // state.element_size()
    if n % vec or rs % vec or state.data_ptr() % 16 or gate.data_ptr() % 16:
        vec = 1
    out = torch.empty(state.shape, dtype=state.dtype, device=state.device)
    fn = function("st_geglu", _GEGLU_ARGTYPES)
    with on_device(state.device):
        stream = current_stream(state.device)
        code = fn(state.data_ptr(), gate.data_ptr(), rs, out.data_ptr(), rows, n,
                  DTYPE_CODES[state.dtype], vec, int(stepwise), stream)
    check(code, "st_geglu")
    counter.add(f"{'bf16' if state.dtype == torch.bfloat16 else 'f32'} "
                f"rows={rows} n={n} rs={rs} vec={vec}")
    return out


def _check_shapes(state: torch.Tensor, gate: torch.Tensor) -> None:
    if state.shape != gate.shape:
        raise ValueError(f"geglu shapes differ: {tuple(state.shape)} {tuple(gate.shape)}")


@register("geglu", "cuda")
def geglu(state: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """state * gelu(gate) on two (..., N) tensors of one shape, read in place
    (e.g. the halves of a (..., 2N) buffer)."""
    _check_shapes(state, gate)
    if state.device.type == "cpu":
        return geglu_plain(state, gate)
    return _geglu(state, gate, False, LAUNCHES)


@register("geglu", "cuda_bf16apply")
def geglu_bf16apply(state: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """The default binding's GEGLU, ``ops.reference.geglu``'s roundings on
    the kernel (that plain form for CPU tensors), read in place as
    :func:`geglu`."""
    _check_shapes(state, gate)
    if state.device.type == "cpu":
        return reference.geglu(state, gate)
    return _geglu(state, gate, True, BF16APPLY_LAUNCHES)
