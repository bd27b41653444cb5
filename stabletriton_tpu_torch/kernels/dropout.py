"""Seeded dropout through the hand-written Hopper kernel ``csrc/dropout.cu``.

Replaces the Pallas TPU kernel ``_dropout_kernel`` of
``stabletriton_tpu/kernels/dropout.py`` (K14): ``where(u >= rate, x * scale,
0)`` with ``scale = 1 / (1 - rate)``, deterministic in (x, seed, rate). As in
the JAX package no model path reaches it (the UNet elides dropout at
inference); it runs through ``ops.dispatch("dropout", ...)``.

What bounds it on the H100: device memory, one read and one write.

What the design does about it: the TPU kernel's per-core generator becomes
Philox4x32-10, keyed by the seed with the element's group of four as the
counter, so each element's bits depend on (seed, index) alone and the plain
version (:func:`dropout_plain`) computes the same words with integer
tensors: kernel and plain version agree bit for bit. JAX's CPU stream is
``jax.random``, so against JAX only the statistics agree.

Both backends live here, as in the JAX module: "cuda" (the kernel on CUDA
tensors, the plain version on CPU tensors) and "reference" (the plain
version).
"""

from __future__ import annotations

import ctypes
import math

import torch

from stabletriton_tpu_torch.kernels.build import (
    DTYPE_CODES, LaunchCounter, check, current_stream, function, on_device)
from stabletriton_tpu_torch.ops.registry import register

LAUNCHES = LaunchCounter()

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)

_DROPOUT_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
                     ctypes.c_uint, ctypes.c_uint, ctypes.c_float, ctypes.c_int,
                     ctypes.c_void_p]


def _mulhilo(a: torch.Tensor, m: int) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of a * m, for 32-bit words ``a`` held in
    int64 and a 32-bit constant ``m``: the product is formed from 16-bit
    halves of ``a`` so no partial sum passes 2^49."""
    p_hi, p_lo = (a >> 16) * m, (a & 0xFFFF) * m
    return (p_hi + (p_lo >> 16)) >> 16, (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK32


def philox4x32_10(ctr: torch.Tensor, key: tuple[int, int]) -> torch.Tensor:
    """Philox4x32-10 of (n, 4) int64 counter words (each < 2^32) under a
    two-word key: (n, 4) int64 output words, as ``csrc/dropout.cu`` computes
    them."""
    c0, c1, c2, c3 = ctr.unbind(-1)
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
    return torch.stack([c0, c1, c2, c3], dim=-1)


def _check_rate(rate: float) -> None:
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"rate must be in [0, 1), got {rate}")


def _key(seed) -> tuple[int, int]:
    s = int(seed)
    return s & _MASK32, (s >> 32) & _MASK32


def _threshold(rate: float) -> int:
    """u >= rate for u = (bits >> 8) * 2^-24, as an integer test on bits >> 8."""
    return math.ceil(rate * 2**24)


def _scale(rate: float) -> float:
    return float(torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32))


@register("dropout", "reference")
def dropout_plain(x: torch.Tensor, seed, *, rate: float = 0.1) -> torch.Tensor:
    """The kernel's function in plain PyTorch: the same Philox words for
    element i (group i // 4, word i % 4), the same integer keep test, x *
    float32(scale) in f32 with one rounding."""
    _check_rate(rate)
    if rate == 0.0:
        return x
    n = x.numel()
    g = torch.arange((n + 3) // 4, dtype=torch.int64, device=x.device)
    ctr = torch.stack([g & _MASK32, g >> 32, torch.zeros_like(g), torch.zeros_like(g)], -1)
    bits = philox4x32_10(ctr, _key(seed)).reshape(-1)[:n].reshape(x.shape)
    keep = (bits >> 8) >= _threshold(rate)
    return torch.where(keep, x.float() * _scale(rate), 0.0).to(x.dtype)


@register("dropout", "cuda")
def dropout(x: torch.Tensor, seed, *, rate: float = 0.1) -> torch.Tensor:
    """Deterministic dropout: the same (x, seed, rate) give the same output.
    rate 0 returns x itself with no launch."""
    _check_rate(rate)
    if rate == 0.0:
        return x
    if x.device.type == "cpu":
        return dropout_plain(x, seed, rate=rate)
    if x.dtype not in DTYPE_CODES:
        raise ValueError(f"dropout kernel takes float32 or bfloat16, got {x.dtype}")
    xc = x if x.is_contiguous() else x.contiguous()
    out = torch.empty_like(xc)
    n = xc.numel()
    if n == 0:
        return out
    fn = function("st_dropout", _DROPOUT_ARGTYPES)
    with on_device(x.device):
        stream = current_stream(x.device)
        code = fn(xc.data_ptr(), out.data_ptr(), n, *_key(seed), _threshold(rate),
                  _scale(rate), DTYPE_CODES[x.dtype], stream)
    check(code, "st_dropout")
    LAUNCHES.add(f"{'bf16' if x.dtype == torch.bfloat16 else 'f32'} n={n} rate={rate:g}")
    return out
