"""Random weights made on the device from the run's seed.

The leaves of each parameter group are drawn in a few large calls of one
generator on the device, in the dtype the group is served in: one flat
buffer a class of leaves, split into views. Weights are N(0, 1 / fan_in)
(fan_in: the product of every dim but the last, as HWIO convs and (in, out)
linears hold it); norm scales 1 + N(0, 0.05^2) and biases N(0, 0.05^2), so
that the affine parts of every norm and every bias add something a fault
could lose. Every leaf is aligned as a tensor of its own would be: a leaf
8 bytes off a 16-byte boundary sends cuBLAS to its sm80 "align2" kernels,
2-3x slower, which a checkpoint's tensors never do. The same tensors go to
the system under test and to the reference.
"""

from __future__ import annotations

import math

import torch

SCALE_STD = 0.05
BIAS_STD = 0.05
# leaves start on multiples of 256 elements (512 bytes or more), as the
# caching allocator aligns a tensor of its own
ALIGN = 256


def _leaf_class(name: str, shape: tuple[int, ...]):
    """("scale", 0) for a 1-D weight (a norm's scale), ("bias", 0) for a
    bias, else ("weight", fan_in)."""
    if len(shape) == 1:
        return ("bias", 0) if name.endswith(".bias") else ("scale", 0)
    return ("weight", math.prod(shape[:-1]))


def make_group(shapes: dict[str, tuple[int, ...]], gen: torch.Generator, dtype: torch.dtype,
               device) -> dict[str, torch.Tensor]:
    """Each leaf starts ALIGN elements after the last one's start at the
    least: as aligned as a tensor of its own (a checkpoint's loaded tensors
    are), which libraries' kernel choices depend on."""
    classes: dict[tuple, list[str]] = {}
    for name in sorted(shapes):
        classes.setdefault(_leaf_class(name, shapes[name]), []).append(name)
    out = {}
    for cls in sorted(classes):
        names = classes[cls]
        sizes = [math.prod(shapes[n]) for n in names]
        starts = [0]
        for n in sizes:
            starts.append(starts[-1] + -(-n // ALIGN) * ALIGN)
        buf = torch.randn(starts[-1], generator=gen, dtype=dtype, device=device)
        kind, fan_in = cls
        if kind == "weight":
            buf.mul_(1.0 / math.sqrt(max(fan_in, 1)))
        elif kind == "scale":
            buf.mul_(SCALE_STD).add_(1.0)
        else:
            buf.mul_(BIAS_STD)
        for n, start, size in zip(names, starts, sizes):
            out[n] = buf[start:start + size].view(shapes[n])
    return out


def make(shapes: dict[str, dict[str, tuple[int, ...]]], dtypes: dict[str, str], seed: int,
         device) -> dict[str, dict[str, torch.Tensor]]:
    """{group: {key: tensor}} for {group: {key: shape}}, each group in
    ``dtypes[group]``, from one generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % 2**63)
    return {g: make_group(shapes[g], gen, getattr(torch, dtypes[g]), device)
            for g in sorted(shapes)}
