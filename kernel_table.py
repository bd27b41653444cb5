#!/usr/bin/env python3
"""Time the port's kernels on one NVIDIA GPU, one row per (op, shape).

    python3 kernel_table.py [--only TEXT] [--parent DIR] [--plans] [--host]

For each row of ROWS and each step row (``step_rows``) whose name holds
``--only``'s text (every row without it), PERF.md's kernel table's columns:
the kernel's ms a call by CUDA events and its device ms a call by
torch.profiler's kernel events (two runs each), its launches on the step
rows' paths, its bound (operations at the card's peak rate or bytes at its
memory rate, whichever is longer; peaks from gpubench/peaks.json) and that
bound's share of the device time, the plain version's ms, the library call's
ms (SDPA, cuDNN, cuBLAS, F.group_norm ...: one PyTorch call computing the
same function) where there is one, and the largest absolute gap to the plain
version. A step row is compile_unet_kv's replayed UNet step of a
gpubench/configs/*.json configuration at a cell's UNet batch, under the
configuration's binding and under the default binding, against the reference
binding's eager step. Launches are counted: a step row runs its cross K/V
precompute, UNet step and one image's f32 VAE decode eagerly under its
binding, and a row's launches on those paths are their counts at the keys of
the row's own call (a conv's key names no epilogue: rows that differ only
there share a count); the paths' keys no row launched end the run.

Each row prints as it is timed; the last line of standard output is one
JSON object with every row. tests/test_torch_port_gpu.py holds each row of
ROWS against its plain version, within its own tolerances
(test_gpu_kernel_table_row_vs_plain).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import math
import os
import pathlib
import statistics
import subprocess
import sys
import time
from typing import Callable, NamedTuple

import torch

ROOT = pathlib.Path(__file__).resolve().parent
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
# the float32 scores the plain attention may hold at once: above it the plain
# version runs one batch row at a time
PLAIN_SCORES_MAX = 8 << 30


class Row(NamedTuple):
    op: str
    shape: tuple
    dtype: str
    path: str  # the path whose shape it is

    @property
    def name(self) -> str:
        return f"{self.op} {','.join(map(str, self.shape))} {self.dtype} [{self.path}]"


# attention: (form, B, Sq, Sk, heads, head dim); form "qkv" reads the fused QKV
# buffer, "kv" q against the fused KV buffer, "sep" separate q, k, v
# conv: (B, H, W, Cin, Cout, epilogue): "bb" a (B, Cout) f32 bias, "b" a
# (Cout,) one, "-silu" / "-res" a SiLU / a residual
# gn_conv (K8): (B, H, W, Cin, Cout, residual); group_norm: (B, H, W, C, act);
# layer_norm / rms_norm: (rows, C); geglu: (B, S, 2N), the halves of one
# buffer; linear: (M, K, N, bias, act); time_embed: (N, dim); dropout: shape.
# The *_bf16apply rows are the default binding's forms of K9-K11.
ROWS = [
    # K1 / K2: SDXL-base 1024^2 (CFG batch 2)
    Row("attention", ("qkv", 2, 1024, 1024, 20, 64), "bf16", "SDXL 32^2 self"),
    Row("attention", ("kv", 2, 4096, 77, 10, 64), "bf16", "SDXL 64^2 cross"),
    Row("attention", ("kv", 2, 1024, 77, 20, 64), "bf16", "SDXL 32^2 cross"),
    Row("attention", ("qkv", 2, 4096, 4096, 10, 64), "bf16", "SDXL 64^2 self"),
    Row("attention", ("sep", 1, 16384, 16384, 1, 512), "f32", "SDXL VAE mid"),
    # K3-K5: SD1.5 512^2
    Row("attention", ("qkv", 2, 4096, 4096, 8, 40), "bf16", "SD1.5 64^2 self"),
    Row("attention", ("qkv", 2, 1024, 1024, 8, 80), "bf16", "SD1.5 32^2 self"),
    Row("attention", ("qkv", 2, 256, 256, 8, 160), "bf16", "SD1.5 16^2 self"),
    Row("attention", ("kv", 2, 4096, 77, 8, 40), "bf16", "SD1.5 64^2 cross"),
    Row("attention", ("kv", 2, 1024, 77, 8, 80), "bf16", "SD1.5 32^2 cross"),
    Row("attention", ("kv", 2, 256, 77, 8, 160), "bf16", "SD1.5 16^2 cross"),
    Row("attention", ("qkv", 2, 64, 64, 8, 160), "bf16", "SD1.5 mid self"),
    Row("attention", ("sep", 1, 4096, 4096, 1, 512), "f32", "SD1.5 VAE mid"),
    # the SDXL refiner 1024^2
    Row("attention", ("qkv", 2, 4096, 4096, 12, 64), "bf16", "refiner 64^2 self"),
    Row("attention", ("qkv", 2, 1024, 1024, 24, 64), "bf16", "refiner 32^2 self"),
    Row("attention", ("qkv", 2, 256, 256, 24, 64), "bf16", "refiner mid self"),
    Row("attention", ("kv", 2, 4096, 77, 12, 64), "bf16", "refiner 64^2 cross"),
    Row("attention", ("kv", 2, 1024, 77, 24, 64), "bf16", "refiner 32^2 cross"),
    # SD2.x 768^2, CFG batch 2 and the sd-2.1-768.batch8 cell's UNet batch 16
    Row("attention", ("qkv", 2, 9216, 9216, 5, 64), "bf16", "SD2 96^2 self"),
    Row("attention", ("kv", 2, 9216, 77, 5, 64), "bf16", "SD2 96^2 cross"),
    Row("attention", ("qkv", 2, 2304, 2304, 10, 64), "bf16", "SD2 48^2 self"),
    Row("attention", ("kv", 2, 2304, 77, 10, 64), "bf16", "SD2 48^2 cross"),
    Row("attention", ("qkv", 2, 576, 576, 20, 64), "bf16", "SD2 24^2 self"),
    Row("attention", ("kv", 2, 576, 77, 20, 64), "bf16", "SD2 24^2 cross"),
    Row("attention", ("qkv", 2, 144, 144, 20, 64), "bf16", "SD2 mid self"),
    Row("attention", ("kv", 2, 144, 77, 20, 64), "bf16", "SD2 mid cross"),
    Row("attention", ("sep", 1, 9216, 9216, 1, 512), "f32", "SD2 VAE mid"),
    Row("attention", ("qkv", 16, 9216, 9216, 5, 64), "bf16", "SD2.1 batch8 96^2 self"),
    Row("attention", ("kv", 16, 9216, 77, 5, 64), "bf16", "SD2.1 batch8 96^2 cross"),
    Row("attention", ("qkv", 16, 2304, 2304, 10, 64), "bf16", "SD2.1 batch8 48^2 self"),
    # K6: the 3x3 convs (the default binding's; the fused-op binding sends
    # the resnets' GroupNorm + conv pairs to K8)
    Row("conv", (2, 128, 128, 320, 320, "bb-silu"), "bf16", "SDXL resnet conv2"),
    Row("conv", (2, 128, 128, 320, 320, "b-res"), "bf16", "SDXL resnet conv2 +res"),
    Row("conv", (2, 64, 64, 640, 640, "bb"), "bf16", "SDXL 64^2 resnet"),
    Row("conv", (2, 32, 32, 1280, 1280, "b-res"), "bf16", "SDXL 32^2 resnet +res"),
    Row("conv", (2, 16, 16, 1280, 1280, "bb"), "bf16", "SD1.5 16^2 resnet"),
    Row("conv", (2, 8, 8, 1280, 1280, "bb"), "bf16", "SD1.5 8^2 resnet"),
    Row("conv", (2, 128, 128, 4, 320, "b"), "bf16", "SDXL conv_in"),
    Row("conv", (2, 128, 128, 320, 4, "b"), "bf16", "SDXL conv_out"),
    Row("conv", (2, 128, 128, 9, 320, "b"), "bf16", "inpaint conv_in"),
    Row("conv", (2, 96, 96, 4, 320, "b"), "bf16", "SD2 conv_in"),
    Row("conv", (2, 96, 96, 320, 320, "b"), "bf16", "SD2 96^2 resnet"),
    Row("conv", (2, 48, 48, 640, 640, "b"), "bf16", "SD2 48^2 resnet"),
    Row("conv", (2, 24, 24, 1280, 1280, "b"), "bf16", "SD2 24^2 resnet"),
    Row("conv", (2, 12, 12, 1280, 1280, "b"), "bf16", "SD2 12^2 resnet"),
    Row("conv", (16, 96, 96, 4, 320, "b"), "bf16", "SD2.1 batch8 conv_in"),
    Row("conv", (16, 96, 96, 320, 320, "b"), "bf16", "SD2.1 batch8 96^2 resnet"),
    Row("conv", (16, 96, 96, 960, 320, "b"), "bf16", "SD2.1 batch8 up conv1"),
    Row("conv", (16, 96, 96, 640, 640, "b"), "bf16", "SD2.1 batch8 upsampler"),
    Row("conv", (16, 96, 96, 320, 4, "b"), "bf16", "SD2.1 batch8 conv_out"),
    Row("conv", (1, 128, 128, 4, 512, "b"), "f32", "SDXL VAE conv_in"),
    Row("conv", (1, 64, 64, 4, 512, "b"), "f32", "SD1.5 VAE conv_in"),
    Row("conv", (1, 128, 128, 512, 512, "b-res"), "f32", "SDXL VAE mid +res"),
    Row("conv", (1, 1024, 1024, 128, 128, "b"), "f32", "SDXL VAE 1024^2"),
    Row("conv", (1, 1024, 1024, 128, 3, "b"), "f32", "SDXL VAE conv_out"),
    Row("conv", (1, 96, 96, 4, 512, "b"), "f32", "SD2 VAE conv_in"),
    Row("conv", (1, 96, 96, 512, 512, "b"), "f32", "SD2 VAE 96^2"),
    Row("conv", (1, 768, 768, 128, 128, "b"), "f32", "SD2 VAE 768^2"),
    Row("conv", (1, 1024, 1024, 3, 128, "b"), "f32", "SDXL VAE encoder conv_in"),
    Row("conv", (1, 512, 512, 128, 256, "b"), "f32", "SDXL VAE encoder 512^2"),
    Row("conv", (1, 256, 256, 256, 512, "b"), "f32", "SDXL VAE encoder 256^2"),
    Row("conv", (1, 128, 128, 512, 8, "b"), "f32", "SDXL VAE encoder conv_out"),
    # K8: GroupNorm + SiLU fused into the conv, at every SDXL-base shape at
    # UNet batch 2 and 16 (the sdxl cells), and the other paths' shapes
    *[Row("gn_conv", (b, h, h, cin, cout, res), "bf16", f"SDXL batch {b // 2}")
      for b in (2, 16) for h, cin, cout, res in [
          (128, 320, 320, False), (128, 320, 320, True), (128, 640, 320, False),
          (128, 960, 320, False), (64, 320, 640, False), (64, 640, 640, False),
          (64, 640, 640, True), (64, 960, 640, False), (64, 1280, 640, False),
          (64, 1920, 640, False), (32, 640, 1280, False), (32, 1280, 1280, False),
          (32, 1280, 1280, True), (32, 1920, 1280, False), (32, 2560, 1280, False)]],
    Row("gn_conv", (2, 128, 128, 320, 4, False), "bf16", "SDXL conv_out"),
    Row("gn_conv", (2, 8, 8, 1280, 1280, False), "bf16", "SD1.5 8^2 resnet"),
    Row("gn_conv", (2, 8, 8, 2560, 1280, False), "bf16", "SD1.5 8^2 up resnet"),
    Row("gn_conv", (2, 96, 96, 320, 320, False), "bf16", "SD2 96^2 resnet"),
    Row("gn_conv", (2, 128, 128, 384, 384, False), "bf16", "refiner resnet"),
    Row("gn_conv", (2, 128, 128, 1152, 384, False), "bf16", "refiner up resnet"),
    Row("gn_conv", (2, 64, 64, 2304, 768, False), "bf16", "refiner up resnet"),
    # K9: every whole GroupNorm of the fused-op paths
    Row("group_norm", (2, 128, 128, 320, "silu"), "bf16", "SDXL"),
    Row("group_norm", (2, 128, 128, 640, "silu"), "bf16", "SDXL"),
    Row("group_norm", (2, 128, 128, 960, "silu"), "bf16", "SDXL"),
    Row("group_norm", (2, 64, 64, 640, None), "bf16", "SDXL Transformer2D"),
    Row("group_norm", (2, 64, 64, 1280, "silu"), "bf16", "SDXL"),
    Row("group_norm", (2, 64, 64, 1920, "silu"), "bf16", "SDXL"),
    Row("group_norm", (2, 32, 32, 1280, None), "bf16", "SDXL Transformer2D"),
    Row("group_norm", (2, 32, 32, 2560, "silu"), "bf16", "SDXL"),
    Row("group_norm", (2, 64, 64, 320, None), "bf16", "SD1.5 Transformer2D"),
    Row("group_norm", (2, 32, 32, 640, None), "bf16", "SD1.5 Transformer2D"),
    Row("group_norm", (2, 16, 16, 1280, None), "bf16", "SD1.5 Transformer2D"),
    Row("group_norm", (2, 8, 8, 1280, None), "bf16", "SD1.5 Transformer2D"),
    Row("group_norm", (2, 96, 96, 320, None), "bf16", "SD2 Transformer2D"),
    Row("group_norm", (2, 48, 48, 640, None), "bf16", "SD2 Transformer2D"),
    Row("group_norm", (2, 24, 24, 1280, None), "bf16", "SD2 Transformer2D"),
    Row("group_norm", (2, 64, 64, 768, None), "bf16", "refiner Transformer2D"),
    Row("group_norm", (1, 128, 128, 512, "silu"), "f32", "SDXL VAE"),
    Row("group_norm", (1, 256, 256, 512, "silu"), "f32", "SDXL VAE"),
    Row("group_norm", (1, 512, 512, 512, "silu"), "f32", "SDXL VAE"),
    Row("group_norm", (1, 512, 512, 256, "silu"), "f32", "SDXL VAE"),
    Row("group_norm", (1, 1024, 1024, 256, "silu"), "f32", "SDXL VAE"),
    Row("group_norm", (1, 1024, 1024, 128, "silu"), "f32", "SDXL VAE"),
    # K10
    Row("layer_norm", (8192, 640), "bf16", "SDXL 64^2"),
    Row("layer_norm", (2048, 1280), "bf16", "SDXL 32^2"),
    Row("rms_norm", (8192, 640), "bf16", "RMSNorm on K10"),
    Row("layer_norm", (8192, 768), "bf16", "refiner 64^2"),
    Row("layer_norm", (2048, 1536), "bf16", "refiner 32^2"),
    Row("layer_norm", (18432, 320), "bf16", "SD2 96^2"),
    # K11
    Row("geglu", (2, 4096, 5120), "bf16", "SDXL 64^2"),
    Row("geglu", (2, 1024, 10240), "bf16", "SDXL 32^2"),
    Row("geglu", (2, 4096, 6144), "bf16", "refiner 64^2"),
    Row("geglu", (2, 1024, 12288), "bf16", "refiner 32^2"),
    Row("geglu", (2, 9216, 2560), "bf16", "SD2 96^2"),
    # K12
    Row("time_embed", (2, 320), "f32", "SDXL timesteps"),
    Row("time_embed", (12, 256), "f32", "SDXL time ids"),
    Row("time_embed", (10, 256), "f32", "refiner time ids"),
    # K13
    Row("linear", (8192, 640, 1920, False, None), "bf16", "SDXL to_qkv"),
    Row("linear", (2048, 1280, 10240, True, None), "bf16", "SDXL ff proj"),
    Row("linear", (2048, 5120, 1280, True, None), "bf16", "SDXL ff out"),
    Row("linear", (154, 2048, 2560, False, None), "bf16", "SDXL cross K/V precompute"),
    Row("linear", (2, 1280, 1280, True, None), "bf16", "SDXL time MLP"),
    Row("linear", (2, 2816, 1280, True, None), "bf16", "SDXL add embedding"),
    Row("linear", (2, 1280, 320, True, None), "bf16", "SDXL time_emb_proj"),
    Row("linear", (2, 1280, 640, True, None), "bf16", "SDXL time_emb_proj"),
    Row("linear", (8192, 320, 960, False, None), "bf16", "SD1.5 to_qkv"),
    Row("linear", (128, 1280, 1280, True, None), "bf16", "SD1.5 8^2 projection"),
    Row("linear", (2, 320, 1280, True, "silu"), "bf16", "time MLP in"),
    Row("linear", (2048, 1280, 5120, True, "gelu"), "bf16", "the GELU epilogue"),
    Row("linear", (16384, 512, 512, True, None), "f32", "SDXL VAE attention"),
    Row("linear", (4096, 512, 512, True, None), "f32", "SD1.5 VAE attention"),
    Row("linear", (8192, 768, 2304, False, None), "bf16", "refiner to_qkv"),
    Row("linear", (2048, 1536, 12288, True, None), "bf16", "refiner ff proj"),
    Row("linear", (2, 2560, 1536, True, None), "bf16", "refiner add embedding"),
    Row("linear", (18432, 320, 960, False, None), "bf16", "SD2 to_qkv"),
    Row("linear", (154, 1024, 640, False, None), "bf16", "SD2 cross K/V precompute"),
    # K14 (on no model path)
    Row("dropout", (2, 4096, 640), "bf16", "rate 0.1"),
    Row("dropout", (2, 4096, 640), "f32", "rate 0.1"),
    Row("dropout", (1 << 20,), "f32", "rate 0.1"),
    # the default binding's K9-K11 forms: SD1.5 512^2 at UNet batch 16, the
    # sd-2.1-768.batch8 cell's level 0, the f32 decoders
    Row("gn_bf16apply", (16, 64, 64, 320, "silu"), "bf16", "SD1.5 batch8"),
    Row("gn_bf16apply", (16, 64, 64, 960, "silu"), "bf16", "SD1.5 batch8"),
    Row("ln_bf16apply", (65536, 320), "bf16", "SD1.5 batch8"),
    Row("geglu_bf16apply", (16, 4096, 2560), "bf16", "SD1.5 batch8"),
    Row("gn_bf16apply", (1, 512, 512, 128, "silu"), "f32", "SD1.5 VAE"),
    Row("gn_bf16apply", (16, 96, 96, 320, "silu"), "bf16", "SD2.1 batch8"),
    Row("gn_bf16apply", (16, 96, 96, 640, "silu"), "bf16", "SD2.1 batch8"),
    Row("gn_bf16apply", (16, 96, 96, 960, "silu"), "bf16", "SD2.1 batch8"),
    Row("gn_bf16apply", (16, 96, 96, 320, None), "bf16", "SD2.1 batch8 Transformer2D"),
    Row("ln_bf16apply", (147456, 320), "bf16", "SD2.1 batch8"),
    Row("geglu_bf16apply", (16, 9216, 2560), "bf16", "SD2.1 batch8"),
    Row("gn_bf16apply", (1, 768, 768, 128, "silu"), "f32", "SD2.1 VAE"),
]
assert len({r.name for r in ROWS}) == len(ROWS), "two rows of one name"


@dataclasses.dataclass
class Case:
    """A row made on a device: its kernel call, plain version and library
    call (None where no PyTorch call computes the same function), the
    operations and bytes its bound counts (each input read once, each output
    written once) and the peak rate those operations run at, the launch
    counter its launches add to and the leading fields of the key the route
    gives them (None: not checked); a step row's path launches by counter."""
    kernel: Callable
    plain: Callable
    library: Callable | None
    library_label: str | None
    flops: float
    bytes: int
    peak: str
    counter: object
    want: str | None
    path: dict | None = None


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def case(row: Row, dev) -> Case:
    """The row's inputs (from a fixed seed) and calls on ``dev``."""
    import torch.nn.functional as F

    from stabletriton_tpu_torch.kernels import conv_direct as cd, dropout as dr, geglu as gg
    from stabletriton_tpu_torch.kernels import flash_attention as fa, group_norm as gn
    from stabletriton_tpu_torch.kernels import layer_norm as ln, linear as lin, time_embed as te
    from stabletriton_tpu_torch.ops import reference

    dtype = DTYPES[row.dtype]
    gen = torch.Generator(device=dev).manual_seed(sum(map(ord, row.name)))
    peak = "bfloat16" if dtype == torch.bfloat16 else "float32"

    def randn(*shape, dt=dtype, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dt)

    op, s = row.op, row.shape
    if op == "attention":
        form, b, sq, sk, h, d = s
        c = h * d
        if form == "qkv":
            qkv = randn(b, sq, 3 * c)
            inputs, (q, k, v) = (qkv,), qkv.chunk(3, -1)
        elif form == "kv":
            q, kv = randn(b, sq, c), randn(b, sk, 2 * c)
            inputs, (k, v) = (q, kv), kv.chunk(2, -1)
        else:
            q, k, v = randn(b, sq, c), randn(b, sk, c), randn(b, sk, c)
            inputs = (q, k, v)

        def kernel():
            if form == "qkv":
                return fa.flash_attention_qkv(qkv, num_heads=h)
            if form == "kv":
                return fa.flash_attention_kv(q, kv, num_heads=h)
            return fa.flash_attention(q, k, v, num_heads=h)

        def plain():
            if b * h * sq * sk * 4 <= PLAIN_SCORES_MAX:
                return fa.attention_plain(q, k, v, num_heads=h)
            return torch.cat([fa.attention_plain(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                                 num_heads=h) for i in range(b)])

        qh, kh, vh = (t.reshape(b, -1, h, d).transpose(1, 2).contiguous() for t in (q, k, v))
        return Case(kernel, plain, lambda: F.scaled_dot_product_attention(qh, kh, vh), "SDPA",
                    4 * b * h * sq * sk * d, nbytes(*inputs) + b * sq * c * q.element_size(),
                    "bfloat16" if dtype == torch.bfloat16 else "tf32x3", fa.LAUNCHES,
                    f"{fa.attention_class(h, d, sk)} {fa.kernel_name(dtype, sk)}")
    if op == "conv":
        b, hh, ww, cin, cout, epi = s
        x = randn(b, hh, ww, cin)
        w = randn(3, 3, cin, cout, scale=1 / math.sqrt(9 * cin))
        bias = randn(b, cout, dt=torch.float32) if epi.startswith("bb") else randn(cout)
        res = randn(b, hh, ww, cout) if epi.endswith("res") else None
        act = "silu" if epi.endswith("silu") else None
        variant = cd.conv_variant(tuple(x.shape), cout, dtype)
        if dtype == torch.bfloat16:
            library = lambda: reference.conv2d(x, w, bias, residual=res, act=act)  # noqa: E731
            label = "cuDNN (reference op)"
        else:
            xc = x.permute(0, 3, 1, 2)
            wc = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
            library, label = (lambda: F.conv2d(xc, wc, bias, padding=1)), "F.conv2d f32"
        return Case(lambda: cd.conv3x3(x, w, bias, residual=res, act=act),
                    lambda: cd.conv3x3_plain(x, w, bias, residual=res, act=act), library, label,
                    2 * b * hh * ww * cout * 9 * cin,
                    nbytes(x, w, bias, res) + b * hh * ww * cout * x.element_size(),
                    "tf32x3" if variant == "wgmma_tf32x3" else peak, cd.LAUNCHES, variant)
    if op == "gn_conv":
        b, hh, ww, cin, cout, has_res = s
        x = randn(b, hh, ww, cin, scale=2.0, shift=0.5)
        scale = torch.rand((b, cin), generator=gen, device=dev) + 0.5
        shift = torch.randn((b, cin), generator=gen, device=dev)
        w = randn(3, 3, cin, cout, scale=1 / math.sqrt(9 * cin))
        bias = randn(cout, dt=torch.float32) if has_res else randn(b, cout, dt=torch.float32)
        res = randn(b, hh, ww, cout) if has_res else None
        return Case(lambda: cd.gn_conv3x3(x, scale, shift, w, bias, residual=res, gn_act="silu"),
                    lambda: cd.gn_conv3x3_plain(x, scale, shift, w, bias, residual=res,
                                                gn_act="silu"),
                    lambda: cd.conv3x3(gn.apply(x, scale, shift, "silu"), w, bias, residual=res),
                    "unfused pair (K9 apply + K6)", 2 * b * hh * ww * cout * 9 * cin,
                    nbytes(x, w, bias, res, scale, shift) + b * hh * ww * cout * 2, peak,
                    cd.GN_LAUNCHES, cd.conv_variant(tuple(x.shape), cout, dtype, gn=True))
    if op in ("group_norm", "gn_bf16apply"):
        b, hh, ww, c, act = s
        if op == "group_norm":
            x = randn(b, hh, ww, c, scale=2.0, shift=0.5)
            g, bb = randn(c, shift=1.0), randn(c)
            nchw = x.permute(0, 3, 1, 2).contiguous()
            return Case(lambda: gn.group_norm(x, g, bb, num_groups=32, act=act),
                        lambda: gn.group_norm_plain(x, g, bb, num_groups=32, act=act),
                        lambda: F.group_norm(nchw, 32, g, bb, 1e-5), "F.group_norm", 0,
                        2 * nbytes(x) + nbytes(g, bb), peak, gn.LAUNCHES, None)
        x, g, bb = (randn(b, hh, ww, c, scale=2.0, shift=0.5), randn(c, scale=0.05, shift=1.0),
                    randn(c, scale=0.05))
        eps = 1e-6 if dtype == torch.float32 else 1e-5
        return Case(lambda: gn.group_norm_bf16apply(x, g, bb, num_groups=32, eps=eps, act=act),
                    lambda: reference.group_norm_bf16apply(x, g, bb, num_groups=32, eps=eps,
                                                           act=act),
                    None, None, 0, 2 * nbytes(x) + nbytes(g, bb), peak, gn.BF16APPLY_LAUNCHES, None)
    if op in ("layer_norm", "rms_norm"):
        rows, c = s
        x, g, bb = randn(rows, c, scale=2.0, shift=0.3), randn(c, shift=1.0), randn(c)
        rms = op == "rms_norm"
        fn = ln.rms_norm if rms else ln.layer_norm
        library = ((lambda: F.rms_norm(x, (c,), g, 1e-6)) if rms
                   else (lambda: F.layer_norm(x, (c,), g, bb, 1e-6)))
        return Case(lambda: fn(x, g, bb, eps=1e-6),
                    lambda: ln.layer_norm_plain(x, g, bb, eps=1e-6, rmsnorm=rms), library,
                    "F.rms_norm" if rms else "F.layer_norm", 0, 2 * nbytes(x) + nbytes(g, bb),
                    peak, ln.LAUNCHES, None)
    if op == "ln_bf16apply":
        rows, c = s
        x, g, bb = (randn(rows, c, scale=2.0, shift=0.5), randn(c, scale=0.05, shift=1.0),
                    randn(c, scale=0.05))
        return Case(lambda: ln.layer_norm_bf16apply(x, g, bb, eps=1e-6),
                    lambda: reference.layer_norm_bf16apply(x, g, bb, eps=1e-6), None, None, 0,
                    2 * nbytes(x) + nbytes(g, bb), peak, ln.BF16APPLY_LAUNCHES, None)
    if op in ("geglu", "geglu_bf16apply"):
        proj = randn(*s, scale=2.0)
        state, gate = proj.chunk(2, dim=-1)
        if op == "geglu":
            return Case(lambda: gg.geglu(state, gate), lambda: gg.geglu_plain(state, gate),
                        None, None, 0, nbytes(proj) * 3 // 2, peak, gg.LAUNCHES, None)
        return Case(lambda: gg.geglu_bf16apply(state, gate), lambda: reference.geglu(state, gate),
                    None, None, 0, nbytes(proj) * 3 // 2, peak, gg.BF16APPLY_LAUNCHES, None)
    if op == "linear":
        m, k, n, has_bias, act = s
        x, w = randn(m, k), randn(k, n, scale=1 / math.sqrt(k))
        bias = randn(n) if has_bias else None
        variant = lin.variant(m, k, n, dtype)
        return Case(lambda: lin.linear(x, w, bias, act=act),
                    lambda: lin.linear_plain(x, w, bias, act=act),
                    (lambda: torch.addmm(bias, x, w)) if has_bias else (lambda: x @ w),
                    "cuBLAS addmm" if has_bias else "cuBLAS matmul", 2 * m * n * k,
                    nbytes(x, w, bias) + m * n * x.element_size(),
                    "tf32x3" if variant == "wgmma_tf32x3" else peak, lin.LAUNCHES, variant)
    if op == "time_embed":
        n, dim = s
        values = {2: [999.0] * 2, 12: [1024.0, 1024, 0, 0, 1024, 1024] * 2,
                  10: [1024.0, 1024, 0, 0, 2.5, 1024, 1024, 0, 0, 6.0]}[n]
        t = torch.tensor(values, device=dev)
        return Case(lambda: te.time_embed(t, dim=dim), lambda: te.time_embed_plain(t, dim=dim),
                    None, None, 0, nbytes(t) * (1 + dim), peak, te.LAUNCHES, None)
    if op == "dropout":
        x = randn(*s)
        return Case(lambda: dr.dropout(x, 20260417, rate=0.1),
                    lambda: dr.dropout_plain(x, 20260417, rate=0.1), None, None, 0,
                    2 * nbytes(x), peak, dr.LAUNCHES, None)
    raise ValueError(f"no op {op!r}")


# ---------------------------------------------------------------------------
# step rows: compile_unet_kv's replayed step per gpubench configuration
# ---------------------------------------------------------------------------


def step_rows() -> list[Row]:
    """(config, UNet batch, binding) of each benchmark cell's UNet step: its
    configuration's binding, and the default binding where that differs."""
    from gpubench import harness

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    rows = []
    for cell in bench["workloads"]:
        cfg = json.loads((ROOT / "gpubench" / "configs" / f"{cell['config']}.json").read_text())
        mix = json.loads((ROOT / "gpubench" / "traffic" / f"{cell['traffic']}.json").read_text())
        batch = 2 * min(mix["outstanding"], harness.MAX_GROUP)
        rows += [Row("step", (cell["config"], batch, binding),
                     "bf16" if cfg["dtypes"]["unet"] == "bfloat16" else "f32", cell["name"])
                 for binding in dict.fromkeys((cfg["binding"], "default"))]
    return list(dict.fromkeys(rows))


def counters() -> dict:
    """Every launch counter of the port's kernels, by the kernel it counts."""
    from stabletriton_tpu_torch.kernels import (conv_direct, dropout, flash_attention, geglu,
                                                group_norm, layer_norm, linear, time_embed)

    return {"attention": flash_attention.LAUNCHES, "K6": conv_direct.LAUNCHES,
            "K8": conv_direct.GN_LAUNCHES, "K9": group_norm.LAUNCHES,
            "K9_bf16apply": group_norm.BF16APPLY_LAUNCHES, "K10": layer_norm.LAUNCHES,
            "K10_bf16apply": layer_norm.BF16APPLY_LAUNCHES, "K11": geglu.LAUNCHES,
            "K11_bf16apply": geglu.BF16APPLY_LAUNCHES, "K12": time_embed.LAUNCHES,
            "K13": linear.LAUNCHES, "K14": dropout.LAUNCHES}


def counted(fn) -> tuple:
    """fn()'s result and the launches that run made, {counter: {key: n}}."""
    before = {name: dict(c.by_key) for name, c in counters().items()}
    out = fn()
    torch.cuda.synchronize()
    return out, {name: {k: n - before[name].get(k, 0) for k, n in c.by_key.items()
                        if n != before[name].get(k, 0)} for name, c in counters().items()}


def step_inputs(cfg, latent: int, device, batch: int = 2, seed: int = 7):
    """A UNet step's inputs: bf16 latents and context, SDXL's pooled text
    embeds and time ids (zero-width for SD1.x / SD2.x), t = 500."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sample = torch.randn((batch, latent, latent, cfg.in_channels), generator=gen,
                         device=device).to(torch.bfloat16)
    ctx = torch.randn((batch, 77, cfg.cross_attention_dim), generator=gen, device=device).to(
        torch.bfloat16)
    if cfg.has_addition_embedding:
        width = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        te = torch.randn((batch, width), generator=gen, device=device).to(torch.bfloat16)
        size = 8.0 * latent
        tid = torch.tensor([[size, size, 0, 0, size, size]] * batch, device=device)
    else:
        te = torch.zeros((batch, 0), device=device, dtype=torch.bfloat16)
        tid = torch.zeros((batch, 0), device=device)
    return sample, torch.full((batch,), 500.0, device=device), ctx, te, tid


def step_case(row: Row, dev, weights: dict) -> Case:
    """The replayed step (the first call runs it eagerly and captures it) on
    seeded random inputs, the reference binding's eager step on the same
    weights and inputs a CFG pair at a time (``weights`` keeps one
    configuration's between rows), and the launches of its paths."""
    from gpubench import harness
    from gpubench.work.unet2d import evaluation_flops
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import (CompileConfig, compile_unet_kv,
                                                fuse_attention_projections, resolve_binding)
    from stabletriton_tpu_torch.models.unet import UNetConfig, init_unet_params
    from stabletriton_tpu_torch.models.vae import VAEConfig, init_vae_params, vae_decode

    name, batch, binding = row.shape
    cfg = json.loads((ROOT / "gpubench" / "configs" / f"{name}.json").read_text())
    u = cfg["unet"]
    if weights.get("name") != name:
        weights.clear()
        ucfg, vcfg = (c(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})
                      for c, d in ((UNetConfig, u), (VAEConfig, cfg["vae"])))
        params = init_unet_params(ucfg, 0, device=dev, dtype=torch.bfloat16)
        weights.update(name=name, ucfg=ucfg, params=params, vcfg=vcfg,
                       vae=init_vae_params(vcfg, 0, device=dev),
                       fused=fuse_attention_projections(params))
    ucfg, params, fused = weights["ucfg"], weights["params"], weights["fused"]
    lat = cfg["height"] // 8
    sample, t, ctx, pooled, tid = step_inputs(ucfg, lat, dev, batch, seed=batch)
    ccfg = harness.compile_config({**cfg, "binding": binding})
    pre, _, step = compile_unet_kv(ucfg, ccfg)
    rpre, _, rstep = compile_unet_kv(ucfg, CompileConfig(backend="reference"))
    z = sample[:1, ..., :weights["vcfg"].latent_channels].float()
    with torch.inference_mode(), ops.use_backends(resolve_binding(ccfg)):  # eager: no capture
        kv, pre_launches = counted(lambda: pre.__wrapped__(fused, ctx))
        path = {"a precompute": pre_launches, **{part: counted(fn)[1] for part, fn in (
            ("a step", lambda: step.__wrapped__(fused, sample, t, kv, pooled, tid)),
            ("a decode", lambda: vae_decode(weights["vcfg"], weights["vae"], z)))}}

    def kernel():
        with torch.inference_mode():
            return step(fused, sample, t, kv, pooled, tid)

    def plain():  # two rows (a CFG pair) at a time: the plain attention's scores fit
        with torch.inference_mode():
            return torch.cat([rstep.__wrapped__(params, sample[i:i + 2], t[i:i + 2],
                                                rpre.__wrapped__(params, ctx[i:i + 2]),
                                                pooled[i:i + 2], tid[i:i + 2])
                              for i in range(0, batch, 2)])

    return Case(kernel, plain, None, None, evaluation_flops(u, batch, lat, lat),
                nbytes(*fused.values()), "bfloat16", None, None,
                {f"{name} b{batch} {binding}": path})


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def events_ms(fn, iters: int) -> float:
    """Mean ms a call of fn() over ``iters`` back-to-back calls (CUDA
    events), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> tuple[float | None, float | None]:
    """The device's own ms a call of fn() (the sum of its kernels' durations
    in torch.profiler's CUDA events, so host gaps do not count) and its
    kernels a call. A session that lost kernel events (their count no
    multiple of the calls) reads short and is taken again; (None, None)
    after three such sessions."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans and len(spans) % iters == 0:
            return sum(spans) / iters / 1e3, len(spans) / iters
    return None, None


def host_us(fn, calls: int = 50, rounds: int = 5) -> float:
    """The median over ``rounds`` of the host us a call of fn() takes to
    return, ``calls`` calls back to back (the device drained between rounds)."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        out.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(out)


def iterations(fn, target_ms: float = 20.0, most: int = 50) -> int:
    return max(1, min(most, round(target_ms / max(events_ms(fn, 1), 1e-3))))


def peaks() -> dict:
    """The card's published peaks (gpubench/peaks.json), by its name."""
    name = torch.cuda.get_device_name(0)
    table = json.loads((ROOT / "gpubench" / "peaks.json").read_text())
    if name not in table:
        raise SystemExit(f"kernel_table: no peaks for {name!r} in gpubench/peaks.json")
    p = table[name]
    return {**p["flops"], "tf32x3": p["flops"]["tf32"] / 3, "bytes_per_s": p["bytes_per_s"]}


def launches(keys: list, paths: dict) -> dict | None:
    """Launches at ``keys`` ([counter, key] pairs) on each measured path
    that has any; None where no path was measured."""
    n = {f"{label}, {part}": sum(by[c].get(k, 0) for c, k in keys)
         for label, parts in paths.items() for part, by in parts.items()}
    return {path: v for path, v in n.items() if v} if paths else None


def measure(row: Row, c: Case, pk: dict, host: bool, paths: dict) -> dict:
    """One row's columns (its launches on ``paths``, a step row's on its own)."""
    out, new = counted(c.kernel)
    keys = [] if c.path else [[n, k] for n, by in new.items() for k in by]
    kernels = sorted({" ".join(k.split()[:2]) if k[:1] == "K" else k.split()[0] for _, k in keys})
    ref = c.plain()
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    rel = err / max(ref.float().abs().max().item(), 1e-30)
    del out, ref
    iters = iterations(c.kernel)
    t_ops = c.flops / pk[c.peak]
    t_mem = c.bytes / pk["bytes_per_s"]
    r = {"name": row.name, "op": row.op, "shape": list(row.shape), "dtype": row.dtype,
         "path": row.path, "keys": keys, "kernels": kernels,
         "launches": ({f"{label}, {part}": sum(sum(by.values()) for by in p.values())
                       for label, parts in c.path.items() for part, p in parts.items()}
                      if c.path else launches(keys, paths)),
         "ms": [events_ms(c.kernel, iters) for _ in range(2)],
         "device_ms": [], "kernels_a_call": None,
         "bound_ms": max(t_ops, t_mem) * 1e3, "bound_by": "operations" if t_ops >= t_mem
         else "bytes", "plain_ms": events_ms(c.plain, iterations(c.plain, most=5)),
         "library": c.library_label, "library_ms": None, "library_device_ms": None,
         "max_abs_err": err, "max_rel_err": rel}
    for _ in range(2):
        ms, per_call = device_ms(c.kernel, iters)
        r["device_ms"].append(ms)
        r["kernels_a_call"] = per_call
    if c.library is not None:
        r["library_ms"] = events_ms(c.library, iters)
        r["library_device_ms"] = device_ms(c.library, iters)[0]
    if host:  # a call longer than a millisecond alone: back to back, they queue
        r["host_us"] = host_us(c.kernel, calls=1 if r["ms"][0] > 1.0 else 50)
    dev = [m for m in r["device_ms"] if m]
    r["bound_share"] = r["bound_ms"] / min(dev) if dev else None
    return r


def text(r: dict) -> str:
    def f(v, fmt=".4f"):
        return "not measured" if v is None else format(v, fmt)

    paths = ("launches " + ", ".join(f"{k}: {n}" for k, n in r["launches"].items())
             if r["launches"] else "launches not measured" if r["launches"] is None
             else "on no measured path")
    line = (f"{r['name']} {r['kernels']}: kernel ms {' / '.join(f(v) for v in r['ms'])}; device "
            f"ms {' / '.join(f(v) for v in r['device_ms'])} ({f(r['kernels_a_call'], '.1f')} "
            f"kernels a call); {paths}; bound {r['bound_ms'] * 1e3:.4g} us "
            f"({r['bound_by']}, {f(r['bound_share'], '.1%')} of the device time); plain ms "
            f"{r['plain_ms']:.4f}; {r['library'] or 'no library call'}"
            + (f" ms {f(r['library_ms'])} (device {f(r['library_device_ms'])})"
               if r["library"] else "") + f"; max abs err {r['max_abs_err']:.2e}")
    if "parent_ms" in r:
        line += (f"; parent kernel ms {' / '.join(f(v) for v in r['parent_ms'])}, device ms "
                 f"{' / '.join(f(v) for v in r['parent_device_ms'])}")
    if "host_us" in r:
        line += f"; host {r['host_us']:.2f} us a call"
    return line


# ---------------------------------------------------------------------------
# forced plans
# ---------------------------------------------------------------------------

# the GEMMs and convs with the most launches or time a step on the SDXL and
# SD1.5 paths, and the skinny linear's (K, N) at M = 2
PLAN_GEMMS = [(8192, 640, 1920), (8192, 640, 640), (2048, 1280, 10240), (2048, 5120, 1280),
              (2048, 1280, 1280), (154, 2048, 2560), (8192, 320, 960), (128, 1280, 1280)]
PLAN_SKINNY = [(2, 320, 1280), (2, 1280, 320), (2, 1280, 640), (2, 1280, 1280),
               (2, 2816, 1280)]
PLAN_CONVS = [(2, 128, 128, 320, 320), (2, 64, 64, 640, 640), (2, 32, 32, 1280, 1280),
              (2, 32, 32, 2560, 1280), (2, 16, 16, 1280, 1280), (2, 8, 8, 1280, 1280)]
PLAN_GN_CONVS = [(16, 128, 128, 320, 320), (16, 64, 64, 640, 640), (16, 32, 32, 1280, 1280)]


def plan_text(plan) -> str:
    fields = plan._asdict() if hasattr(plan, "_asdict") else dataclasses.asdict(plan)
    return " ".join(f"{k}={v}" for k, v in fields.items())


def plan_rows() -> list[dict]:
    """Each shape's plans as the tuner times them (a graph of launches a
    plan, through the wrapper's launch at a forced plan; nothing recorded),
    beside the rule's."""
    from stabletriton_tpu_torch.kernels import autotune

    conv = dict(has_res=False, act=None)
    runs = ([("linear", s, {}) for s in PLAN_GEMMS + PLAN_SKINNY]
            + [("conv", s, conv) for s in PLAN_CONVS]
            + [("gn_conv", s, {**conv, "gn": True}) for s in PLAN_GN_CONVS])
    out = []
    try:
        for op, shape, kw in runs:
            tune = autotune.tune_linear if op == "linear" else autotune.tune_conv
            t = tune(*shape, persist=False, **kw)
            times = {plan_text(p): us for p, us in sorted(t.times_us.items(),
                                                          key=lambda kv: kv[1])}
            best = min(t.times_us, key=t.times_us.get)
            r = {"op": op, "shape": list(shape), "rule": plan_text(t.rule),
                 "rule_us": t.times_us[t.rule], "fastest": plan_text(best),
                 "fastest_us": t.times_us[best], "us_by_plan": times}
            out.append(r)
            print(f"plans {op} {shape}: rule {r['rule']} {r['rule_us']:.2f} us, fastest "
                  f"{r['fastest']} {r['fastest_us']:.2f} us; "
                  + ", ".join(f"{p} {us:.2f}" for p, us in times.items()), flush=True)
    finally:
        autotune.reload()  # the tuner's in-memory entries go: later calls read the tables
    return out


# ---------------------------------------------------------------------------


def parent_rows(parent: str, only: str | None) -> dict:
    """The rows timed with the package of the tree in ``parent``: this file
    run from that directory (its package first on the path), on this card."""
    argv = [str(ROOT / "kernel_table.py")] + (["--only", only] if only else [])
    code = (f"import runpy, sys; sys.argv = {argv!r}; "
            "runpy.run_path(sys.argv[0], run_name='__main__')")
    t0 = time.perf_counter()
    run = subprocess.run([sys.executable, "-c", code], cwd=parent, capture_output=True, text=True)
    if run.returncode != 0:
        raise SystemExit(f"kernel_table: the parent tree's run failed:\n{run.stderr[-4000:]}")
    result = json.loads(run.stdout.strip().splitlines()[-1])
    print(f"parent tree {parent}: {len(result['rows'])} rows in "
          f"{time.perf_counter() - t0:.1f} s (its build included)", flush=True)
    return {r["name"]: r for r in result["rows"]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--only", help="the rows whose name holds this text")
    p.add_argument("--parent", help="a tree (e.g. a git archive of the parent commit) whose "
                   "package times the same rows first, in a subprocess on this card")
    p.add_argument("--plans", action="store_true", help="then the wgmma GEMM, conv and skinny "
                   "linear at each plan the tuner tries, beside the rule's")
    p.add_argument("--host", action="store_true", help="the host us a launch of each row, too")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_table: torch sees no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "not read"
    from stabletriton_tpu_torch.kernels import build

    print(f"{card}; torch {torch.__version__} cuda {torch.version.cuda}; package "
          f"{build.PACKAGE_DIR}", flush=True)
    parent = parent_rows(os.path.abspath(args.parent), args.only) if args.parent else {}
    t0 = time.perf_counter()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    pk = peaks()
    dev = torch.device("cuda", 0)
    rows, weights, paths = [], {}, {}
    selected = [r for r in ROWS + step_rows() if not args.only or args.only in r.name]
    steps = sorted((r for r in selected if r.op == "step"), key=lambda r: r.shape[0])
    # the paths' launches first, eagerly; the steps' captures last: after them
    # the profiler's sessions lose kernel events
    for row in steps:
        paths.update(step_case(row, dev, weights).path)
    weights.clear()
    for row in [r for r in selected if r.op != "step"] + steps:
        c = step_case(row, dev, weights) if row.op == "step" else case(row, dev)
        r = measure(row, c, pk, args.host, paths)
        del c
        if row.name in parent:
            r["parent_ms"] = parent[row.name]["ms"]
            r["parent_device_ms"] = parent[row.name]["device_ms"]
        rows.append(r)
        print(text(r), flush=True)
        torch.cuda.empty_cache()
    weights.clear()
    unrowed = None
    if paths and not args.only:
        unrowed = sorted({(c, k) for parts in paths.values() for by in parts.values()
                          for c, keys in by.items() for k in keys}
                         - {tuple(k) for r in rows for k in r["keys"]})
        print(f"launch keys on the measured paths that no row launched (the JSON line lists "
              f"them): {dict(collections.Counter(c for c, _ in unrowed))}", flush=True)
    plans = plan_rows() if args.plans else []
    print(json.dumps({"device": {"kind": torch.cuda.get_device_name(0), "card": card,
                                 "count": torch.cuda.device_count()},
                      "package": str(build.PACKAGE_DIR), "rows": rows, "plans": plans,
                      "unrowed_keys": unrowed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
