#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stabletriton_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (non-zero exit, no result line):

  1. device: the card's name and power limit from nvidia-smi;
  2. build: compile the CUDA kernels from stabletriton_tpu_torch/csrc/ for sm_90a;
  3. kernels: each kernel against its plain PyTorch version at the shapes the
     SDXL-base 1024^2 path gives it (max abs / max relative error, times);
     each attention launch must carry its class (the JAX package's Pallas
     kernel it stands in for, K1-K5) in its launch key;
  3b. fused-op kernels: GroupNorm (K9), LayerNorm / RMSNorm (K10), GEGLU
     (K11) and the GN-fused 3x3 conv (K8) against their plain versions at
     the same path's shapes; K8 also beside the unfused pair (K9 apply, K6);
  3c. SD1.5 attention: the bf16 kernels at the SD1.5 512^2 path's shapes
     (K3 at d=40, K4 at d=80 and 160, K5 against 77 keys and the mid-block's
     64), then phase 3's d=64 rows again;
  4. step deviation: one full-width SDXL-base UNet step (128^2 latent, CFG
     batch 2, bf16, random weights) under the default binding (kernels,
     fused projections, cross K/V cache) against the "reference" binding;
     MSE must stay under 1e-3; attention launches per step K1 130, K2 10;
  4b. the same step under the fused-op binding (CompileConfig.overrides:
     group_norm, layer_norm, geglu -> "cuda", gn_conv2d -> "fused") against
     the reference binding, MSE under 1e-3, with its per-step launch counts
     (K8 35, K9 11, K10 210, K11 70);
  4c. one full-width SD1.5 UNet step (64^2 latent, CFG batch 2, bf16) under
     both bindings against the reference binding, MSE under 1e-3;
     attention launches per step K3 5, K4 10, K5 17 and no K1 or K2; the
     fused-op step's K8 45, K9 16, K10 48, K11 16;
  5. serving: a ServingEngine over a full-width SDXL-base pipeline answers
     three 1024^2 requests (4 Euler steps, guidance 5); the images must be
     finite, (1024, 1024, 3) and inside [-1, 1], and the attention (K1, K2,
     K3) and conv launch counters must have moved during this phase;
  5b. a second ServingEngine, over a pipeline with the fused-op binding,
     answers two co-batched 1024^2 requests and one alone; same image
     checks, and the launch counters of K8-K11 must match the per-step
     counts times the UNet steps run (K9 also once per VAE GroupNorm per
     image);
  5c. with the SDXL weights freed, a ServingEngine over a full-width SD1.5
     pipeline (CLIP-L, one encoder; VAE scaling 0.18215) answers two
     co-batched 512^2 requests and one alone (4 Euler steps, guidance 7.5);
     the images must be finite, (512, 512, 3) and inside [-1, 1]; the
     K3/K4/K5 bf16 launches must be the per-step counts times the UNet
     steps run, plus one f32 K3 launch per image for the VAE.

Prints a JSON line of per-kernel results, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Weights are random, made from fixed seeds; it needs no network.
"""

from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

BF16_REL_TOL = 2e-2   # bf16 outputs: ~2-3 bf16 ulps of the largest value
F32_REL_TOL = 1e-4    # f32: summation order only
STEP_MSE_GATE = 1e-3  # the JAX package's fidelity gate


def log(*args):
    print(*args, flush=True)


def timed_ms(fn, iters: int) -> float:
    """Mean device time of fn() over ``iters`` launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def compare(name, kernel_fn, plain_fn, tol, iters, op_fn=None,
            op_label="reference-binding op"):
    """Run kernel and plain version on the same inputs; fail past ``tol``
    (max abs error relative to the largest plain output). ``op_fn`` (timed
    only) is another binding's op at the same shape, for context."""
    out = kernel_fn()
    ref = plain_fn()
    torch.cuda.synchronize()
    if out.shape != ref.shape or out.dtype != ref.dtype:
        raise AssertionError(f"{name}: {out.shape}/{out.dtype} vs {ref.shape}/{ref.dtype}")
    if not torch.isfinite(out).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    err = (out.float() - ref.float()).abs().max().item()
    scale = ref.float().abs().max().item()
    rel = err / max(scale, 1e-30)
    ms = timed_ms(kernel_fn, iters)
    plain_ms = timed_ms(plain_fn, iters)
    op_ms = timed_ms(op_fn, iters) if op_fn is not None else None
    log(f"kernel {name}: max_abs_err={err:.3e} max_rel_err={rel:.3e} (tol {tol:g}) "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
        + (f", {op_label} {op_ms:.4f} ms" if op_ms is not None else ""))
    if not rel <= tol:
        raise AssertionError(f"{name}: relative error {rel:.3e} exceeds {tol:g}")
    return {"max_abs_err": err, "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms}


def phase_fused_kernels(dev):
    """K8-K11 against their plain versions at the fused-op path's shapes."""
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import geglu as gg
    from stabletriton_tpu_torch.kernels import group_norm as gn
    from stabletriton_tpu_torch.kernels import layer_norm as ln
    from stabletriton_tpu_torch.ops import reference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(4321)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf16, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale + shift).to(dtype)

    results = []

    def record(tpu, name, source, r):
        r.update(name=name, source=f"stabletriton_tpu_torch/csrc/{source}", tpu=tpu)
        results.append(r)

    # K9: UNet transformer GroupNorms (bf16, no act), a resnet-sized one with
    # SiLU, and the VAE decoder's f32 GroupNorms with SiLU
    for shape, dtype, act, iters in [((2, 64, 64, 640), bf16, None, 20),
                                     ((2, 128, 128, 320), bf16, "silu", 20),
                                     ((1, 128, 128, 512), f32, "silu", 20),
                                     ((1, 1024, 1024, 128), f32, "silu", 5)]:
        x = randn(*shape, dtype=dtype, scale=2.0, shift=0.5)
        g, b = randn(shape[3], dtype=dtype, shift=1.0), randn(shape[3], dtype=dtype)
        kfn = lambda x=x, g=g, b=b, act=act: gn.group_norm(x, g, b, num_groups=32, act=act)
        pfn = lambda x=x, g=g, b=b, act=act: gn.group_norm_plain(x, g, b, num_groups=32,
                                                                 act=act)
        ofn = lambda x=x, g=g, b=b, act=act: (
            reference.group_norm_bf16apply if x.dtype == bf16 else reference.group_norm)(
                x, g, b, num_groups=32, act=act)
        name = f"group_norm {tuple(shape)} {'bf16' if dtype == bf16 else 'f32'} act={act}"
        record("K9", name, "group_norm.cu",
               compare(name, kfn, pfn, BF16_REL_TOL if dtype == bf16 else F32_REL_TOL,
                       iters, ofn, "default-binding op"))
        del x

    # K10: the transformer LayerNorms, and RMSNorm through the same kernel
    for rows, c, rms in [(8192, 640, False), (2048, 1280, False), (8192, 640, True)]:
        x = randn(rows, c, scale=2.0, shift=0.3)
        g, b = randn(c, shift=1.0), randn(c)
        fn, plain = (ln.rms_norm, reference.rms_norm) if rms else (ln.layer_norm,
                                                                   reference.layer_norm_bf16apply)
        kfn = lambda x=x, g=g, b=b, fn=fn: fn(x, g, b, eps=1e-6)
        pfn = lambda x=x, g=g, b=b, rms=rms: ln.layer_norm_plain(x, g, b, eps=1e-6,
                                                                 rmsnorm=rms)
        ofn = lambda x=x, g=g, b=b, plain=plain: plain(x, g, b, eps=1e-6)
        name = f"{'rms_norm' if rms else 'layer_norm'} ({rows}, {c}) bf16"
        record("K10", name, "layer_norm.cu",
               compare(name, kfn, pfn, BF16_REL_TOL, 50, ofn, "default-binding op"))

    # K11: the halves of the feed-forward projection, read in place
    for b_, s_, n in [(2, 4096, 2560), (2, 1024, 5120)]:
        proj = randn(b_, s_, 2 * n, scale=2.0)
        state, gate = proj.chunk(2, dim=-1)
        kfn = lambda st=state, ga=gate: gg.geglu(st, ga)
        pfn = lambda st=state, ga=gate: gg.geglu_plain(st, ga)
        ofn = lambda st=state, ga=gate: reference.geglu(st, ga)
        name = f"geglu halves of ({b_}, {s_}, {2 * n}) bf16"
        record("K11", name, "geglu.cu",
               compare(name, kfn, pfn, BF16_REL_TOL, 20, ofn, "default-binding op"))
        del proj, state, gate

    # K8: GroupNorm + SiLU fused into the 3x3 conv; the unfused pair (K9
    # apply, then K6) timed beside it on the same scale / shift
    for label, (b_, hh, ww, cin, cout), bias_kind, with_res in [
            ("resnet conv1 128x128 320->320 batch-bias", (2, 128, 128, 320, 320), "bb", False),
            ("resnet conv2 64x64 640->640 bias+residual", (2, 64, 64, 640, 640), "b", True),
            ("up resnet conv1 32x32 2560->1280 batch-bias", (2, 32, 32, 2560, 1280), "bb",
             False),
            ("conv_out 128x128 320->4", (2, 128, 128, 320, 4), "b", False)]:
        x = randn(b_, hh, ww, cin, scale=2.0, shift=0.5)
        s1, s2 = gn.moments(x)
        scale, shift = gn.fold(s1, s2, randn(cin, dtype=f32, scale=0.2, shift=1.0),
                               randn(cin, dtype=f32, scale=0.2), hw=hh * ww, num_groups=32,
                               eps=1e-5)
        w = randn(3, 3, cin, cout, scale=1.0 / math.sqrt(9 * cin))
        bias = randn(b_, cout, dtype=f32) if bias_kind == "bb" else randn(cout)
        res = randn(b_, hh, ww, cout) if with_res else None
        args = (x, scale, shift, w, bias)
        kfn = lambda a=args, r=res: cd.gn_conv3x3(*a, residual=r, gn_act="silu")
        pfn = lambda a=args, r=res: cd.gn_conv3x3_plain(*a, residual=r, gn_act="silu")
        name = f"gn_conv3x3 {label}"
        r = compare(name, kfn, pfn, BF16_REL_TOL, 10)
        unfused = lambda a=args, r=res: cd.conv3x3(gn.apply(a[0], a[1], a[2], "silu"), a[3],
                                                     a[4], residual=r)
        r["unfused_ms"] = timed_ms(unfused, 10)
        log(f"  unfused pair (K9 apply + K6) {r['unfused_ms']:.4f} ms vs fused {r['ms']:.4f} ms")
        record("K8", name, "conv3x3.cu", r)
        del x, w, res, args
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    return results


# (label, class, operand form, shape, dtype, timing iterations); shapes are
# (B, S, C, H) for the fused QKV buffer ("qkv") and separate q, k, v
# ("qkv3"), (B, Sq, Sk, C, H) against the fused KV buffer ("kv")
SDXL_ATTENTION_CASES = [
    ("self S=1024 h=20 bf16", "K1", "qkv", (2, 1024, 1280, 20), torch.bfloat16, 20),
    ("cross Sq=4096 Sk=77 h=10 bf16", "K1", "kv", (2, 4096, 77, 640, 10), torch.bfloat16, 20),
    ("cross Sq=1024 Sk=77 h=20 bf16", "K1", "kv", (2, 1024, 77, 1280, 20), torch.bfloat16, 20),
    ("self S=4096 h=10 bf16", "K2", "qkv", (2, 4096, 640, 10), torch.bfloat16, 10),
    ("vae S=16384 h=1 d=512 f32", "K3", "qkv3", (1, 16384, 512, 1), torch.float32, 2),
]

# the SD1.5 512^2 path's attention shapes (8 heads, d = C/8), CFG batch 2
SD15_ATTENTION_CASES = [
    ("self S=4096 h=8 d=40 bf16", "K3", "qkv", (2, 4096, 320, 8), torch.bfloat16, 10),
    ("self S=1024 h=8 d=80 bf16", "K4", "qkv", (2, 1024, 640, 8), torch.bfloat16, 20),
    ("self S=256 h=8 d=160 bf16", "K4", "qkv", (2, 256, 1280, 8), torch.bfloat16, 20),
    ("cross Sq=4096 Sk=77 h=8 d=40 bf16", "K5", "kv", (2, 4096, 77, 320, 8), torch.bfloat16,
     20),
    ("cross Sq=1024 Sk=77 h=8 d=80 bf16", "K5", "kv", (2, 1024, 77, 640, 8), torch.bfloat16,
     20),
    ("cross Sq=256 Sk=77 h=8 d=160 bf16", "K5", "kv", (2, 256, 77, 1280, 8), torch.bfloat16,
     20),
    ("self S=64 h=8 d=160 bf16 (mid)", "K5", "qkv", (2, 64, 1280, 8), torch.bfloat16, 20),
    ("vae S=4096 h=1 d=512 f32", "K3", "qkv3", (1, 4096, 512, 1), torch.float32, 5),
]


def attention_cases(randn, cases, record=True):
    """Each attention case: the wrapper against attention_plain on the same
    inputs. The launch must carry the case's class in its counter key."""
    from stabletriton_tpu_torch.kernels import flash_attention as fa

    results = []
    for label, tpu, kind, shape, dtype, iters in cases:
        tol = BF16_REL_TOL if dtype == torch.bfloat16 else F32_REL_TOL
        if kind == "qkv":
            b, s, c, h = shape
            qkv = randn(b, s, 3 * c, dtype=dtype)
            kfn = lambda qkv=qkv, h=h: fa.flash_attention_qkv(qkv, num_heads=h)
            pfn = lambda qkv=qkv, h=h: fa.attention_plain(*qkv.chunk(3, -1), num_heads=h)
        elif kind == "kv":
            b, sq, sk, c, h = shape
            q, kv = randn(b, sq, c, dtype=dtype), randn(b, sk, 2 * c, dtype=dtype)
            kfn = lambda q=q, kv=kv, h=h: fa.flash_attention_kv(q, kv, num_heads=h)
            pfn = lambda q=q, kv=kv, h=h: fa.attention_plain(q, *kv.chunk(2, -1), num_heads=h)
        else:
            b, s, c, h = shape
            q, k, v = (randn(b, s, c, dtype=dtype) for _ in range(3))
            kfn = lambda q=q, k=k, v=v, h=h: fa.flash_attention(q, k, v, num_heads=h)
            pfn = lambda q=q, k=k, v=v, h=h: fa.attention_plain(q, k, v, num_heads=h)
        before = dict(fa.LAUNCHES.by_key)
        name = f"flash_attention {label}"
        r = compare(name, kfn, pfn, tol, iters)
        keys = {k for k, n in fa.LAUNCHES.by_key.items() if n != before.get(k, 0)}
        if {k.split()[0] for k in keys} != {tpu}:
            raise AssertionError(f"{name}: launched {sorted(keys)}, expected class {tpu}")
        key = sorted(keys)[0]
        log(f"  launch key: {key}")
        r.update(name=name, source="stabletriton_tpu_torch/csrc/flash_attention.cu", tpu=tpu,
                 kernel=" ".join(key.split()[:2]))
        if record:
            results.append(r)
    torch.cuda.empty_cache()
    return results


def phase_sd15_attention(dev):
    """Phase 3c: K3 (bf16, d=40), K4 and K5 at the SD1.5 path's shapes, then
    phase 3's d=64 rows again (the same template; their spread between the
    two phases is the timing noise of this run)."""
    gen = torch.Generator(device=dev).manual_seed(4242)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    results = attention_cases(randn, SD15_ATTENTION_CASES)
    log("phase 3's d=64 rows again:")
    attention_cases(randn, SDXL_ATTENTION_CASES[:4], record=False)
    return results


def phase_kernels(dev):
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.ops import reference

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    results = []
    bf16 = torch.bfloat16

    # K1: packed single-KV (self at S=1024, cross against 77 keys); K2: packed
    # online (self at S=4096); K3: head-major online (VAE mid-block, f32)
    results += attention_cases(randn, SDXL_ATTENTION_CASES)

    # K6: every 3x3 stride-1 conv; the epilogue forms the path uses
    conv_cases = [
        ("unet 128x128 320->320 batch-bias silu", (2, 128, 128, 320, 320), bf16, "bb", None),
        ("unet 128x128 320->320 bias+residual", (2, 128, 128, 320, 320), bf16, "b", "res"),
        ("unet 64x64 640->640 batch-bias", (2, 64, 64, 640, 640), bf16, "bb", None),
        ("unet 32x32 1280->1280 bias+residual", (2, 32, 32, 1280, 1280), bf16, "b", "res"),
        ("unet conv_in 128x128 4->320", (2, 128, 128, 4, 320), bf16, "b", None),
        ("unet conv_out 128x128 320->4", (2, 128, 128, 320, 4), bf16, "b", None),
        ("vae 128x128 512->512 f32", (1, 128, 128, 512, 512), torch.float32, "b", "res"),
        ("vae 1024x1024 128->128 f32", (1, 1024, 1024, 128, 128), torch.float32, "b", None),
        ("vae conv_out 1024x1024 128->3 f32", (1, 1024, 1024, 128, 3), torch.float32, "b", None),
    ]
    for label, (b, hh, ww, cin, cout), dtype, bias_kind, res_kind in conv_cases:
        tol = BF16_REL_TOL if dtype == bf16 else F32_REL_TOL
        x = randn(b, hh, ww, cin, dtype=dtype)
        w = randn(3, 3, cin, cout, dtype=dtype, scale=1.0 / math.sqrt(9 * cin))
        bias = (randn(b, cout, dtype=torch.float32) if bias_kind == "bb"
                else randn(cout, dtype=dtype))
        res = randn(b, hh, ww, cout, dtype=dtype) if res_kind else None
        act = "silu" if bias_kind == "bb" else None
        kfn = lambda x=x, w=w, bias=bias, res=res, act=act: cd.conv3x3(
            x, w, bias, residual=res, act=act)
        pfn = lambda x=x, w=w, bias=bias, res=res, act=act: cd.conv3x3_plain(
            x, w, bias, residual=res, act=act)
        ofn = lambda x=x, w=w, bias=bias, res=res, act=act: reference.conv2d(
            x, w, bias, residual=res, act=act)
        iters = 3 if dtype == torch.float32 else 10
        r = compare(f"conv3x3 {label}", kfn, pfn, tol, iters, ofn)
        r.update(name=f"conv3x3 {label}", source="stabletriton_tpu_torch/csrc/conv3x3.cu",
                 tpu="K6")
        results.append(r)
        del x, w, bias, res
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    return results


def make_unet_params(dev, cfg):
    from stabletriton_tpu_torch.models.unet import init_unet_params

    return init_unet_params(cfg, 0, device=dev, dtype=torch.bfloat16)


# launches of each fused-op kernel per UNet step under the fused-op binding:
# resnets x 2 GN+SiLU+conv pairs + norm_out/conv_out (K8); one GroupNorm per
# Transformer2D (K9); transformer blocks x 3 LayerNorms (K10) and x 1 GEGLU
# (K11). SDXL-base: 17 resnets, 11 Transformer2D, 70 blocks. SD1.5: 22
# resnets (4 levels x 2 down, 2 mid, 4 x 3 up), 16 Transformer2D of one
# block each.
FUSED_PER_STEP = {"K8": 35, "K9": 11, "K10": 210, "K11": 70}
SD15_FUSED_PER_STEP = {"K8": 45, "K9": 16, "K10": 48, "K11": 16}
# attention launches per UNet step by class, under either kernel binding.
# SDXL-base: self at 64^2 (h=10) 10 x K2, self at 32^2 (h=20) 60 x K1, 70
# cross x K1. SD1.5: self at 64^2 (d=40) 5 x K3, at 32^2 (d=80) and 16^2
# (d=160) 10 x K4, mid self at 8^2 (d=160) 1 + 16 cross x K5.
ATTN_PER_STEP = {"K1": 130, "K2": 10, "K3": 0, "K4": 0, "K5": 0}
SD15_ATTN_PER_STEP = {"K1": 0, "K2": 0, "K3": 5, "K4": 10, "K5": 17}


def fused_counters():
    """Launch counters of K8-K11 (and K6, the plain conv kernel)."""
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import geglu as gg
    from stabletriton_tpu_torch.kernels import group_norm as gn
    from stabletriton_tpu_torch.kernels import layer_norm as ln

    return {"K8": cd.GN_LAUNCHES, "K9": gn.LAUNCHES, "K10": ln.LAUNCHES,
            "K11": gg.LAUNCHES, "K6": cd.LAUNCHES}


def attention_by_class(by_key: dict, kernel: str = "") -> dict:
    """Attention launches summed by class (the key's first field), counting
    only keys of ``kernel`` (e.g. "wmma_bf16") when it is given."""
    out = dict.fromkeys(("K1", "K2", "K3", "K4", "K5"), 0)
    for key, n in by_key.items():
        cls, name = key.split()[:2]
        if not kernel or name == kernel:
            out[cls] += n
    return out


def sdxl_step_inputs(dev):
    gen = torch.Generator(device=dev).manual_seed(7)
    return dict(
        sample=torch.randn((2, 128, 128, 4), generator=gen, device=dev).to(torch.bfloat16),
        ctx=torch.randn((2, 77, 2048), generator=gen, device=dev).to(torch.bfloat16),
        pooled=torch.randn((2, 1280), generator=gen, device=dev).to(torch.bfloat16),
        time_ids=torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2, device=dev))


def sd15_step_inputs(dev):
    """SD1.5 at 512^2: 64^2 latent, 768-wide context, no added conditioning."""
    gen = torch.Generator(device=dev).manual_seed(8)
    return dict(
        sample=torch.randn((2, 64, 64, 4), generator=gen, device=dev).to(torch.bfloat16),
        ctx=torch.randn((2, 77, 768), generator=gen, device=dev).to(torch.bfloat16),
        pooled=torch.zeros((2, 0), device=dev, dtype=torch.bfloat16),
        time_ids=torch.zeros((2, 0), device=dev))


def phase_step_deviation(dev, cfg, params, inputs, fused_per_step, attn_per_step, label):
    """One full-width UNet step: the default binding and the fused-op
    binding, each against the reference binding, with the per-step launch
    counts of the attention classes and of the fused-op kernels."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import (
        FUSED_OP_OVERRIDES, CompileConfig, fuse_attention_projections, resolve_binding)
    from stabletriton_tpu_torch.kernels import flash_attention as fa
    from stabletriton_tpu_torch.models.unet import precompute_cross_kv, unet_apply

    sample, ctx, pooled, time_ids = (inputs[k] for k in ("sample", "ctx", "pooled", "time_ids"))
    t = torch.full((2,), 500.0, device=dev)
    fused = fuse_attention_projections(params)
    bindings = {"default": resolve_binding(CompileConfig()),
                "fused_ops": resolve_binding(CompileConfig(overrides=FUSED_OP_OVERRIDES))}
    reference = resolve_binding(CompileConfig(backend="reference"))

    def kernel_step(binding):
        def run():
            with ops.use_backends(binding):
                kv = precompute_cross_kv(cfg, fused, ctx)
                return unet_apply(cfg, fused, sample, t, None, pooled, time_ids, cross_kv=kv)
        return run

    def run_reference():
        with ops.use_backends(reference):
            return unet_apply(cfg, params, sample, t, ctx, pooled, time_ids)

    runs = {"reference": run_reference,
            **{name: kernel_step(b) for name, b in bindings.items()}}
    counters = fused_counters()
    result = {}
    lat = sample.shape[1]
    with torch.inference_mode():
        out_r = run_reference().float()
        for name in bindings:
            for c in (*counters.values(), fa.LAUNCHES):
                c.reset()
            out_k = runs[name]().float()
            torch.cuda.synchronize()
            counts = {k: c.count for k, c in counters.items()}
            attn = attention_by_class(fa.LAUNCHES.by_key)
            if not (torch.isfinite(out_k).all() and torch.isfinite(out_r).all()):
                raise AssertionError(f"{label} UNet step output is not finite ({name} binding)")
            mse = (out_k - out_r).square().mean().item()
            mx = (out_k - out_r).abs().max().item()
            log(f"step deviation, {label}, {name} binding vs reference: UNet {lat}x{lat} "
                f"latent, CFG batch 2, bf16: mse={mse:.3e} max_abs={mx:.3e} (gate "
                f"mse<{STEP_MSE_GATE:g}); output rms {out_r.square().mean().sqrt().item():.4f}; "
                f"launches in one step {json.dumps(counts)}, attention {json.dumps(attn)}")
            if not mse < STEP_MSE_GATE:
                raise AssertionError(f"{label} {name} step deviation mse {mse:.3e} exceeds "
                                     f"{STEP_MSE_GATE:g}")
            if attn != attn_per_step:
                raise AssertionError(f"{label} {name}: attention launches {attn} in one step, "
                                     f"expected {attn_per_step}")
            if name == "fused_ops":
                for k, want in fused_per_step.items():
                    if counts[k] != want:
                        raise AssertionError(f"{label} {k}: {counts[k]} launches in one "
                                             f"fused-op step, expected {want}")
            elif any(counts[k] for k in fused_per_step):
                raise AssertionError(f"{label} default binding launched fused-op kernels: "
                                     f"{counts}")
            result[name] = {"mse": mse, "max_abs": mx, "launches": counts, "attention": attn}
        torch.cuda.synchronize()
        times = {}
        for name in ("reference", "default", "fused_ops", "fused_ops", "default", "reference"):
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
    log(f"step time, {label} (host clock around a synchronised step, ms, two runs each): "
        + ", ".join(f"{k}={v[0]:.1f}/{v[1]:.1f}" for k, v in times.items()))
    del fused
    result["step_ms"] = times
    return result


class StubTokenizer:
    """Deterministic ids without vocab files: BOS, one id per character, EOS,
    then padding (CLIP pools at argmax(ids == eos))."""

    def __init__(self, bos: int, eos: int):
        self.bos, self.eos = bos, eos

    def encode_batch(self, texts, *, max_len=77, pad=None, **kw):
        pad = self.eos if pad is None else pad
        out = np.full((len(texts), max_len), pad, np.int32)
        for i, t in enumerate(texts):
            ids = [self.bos] + [(ord(c) % 400) + 300 for c in t[: max_len - 2]] + [self.eos]
            out[i, : len(ids)] = ids
        return out


def make_other_params(dev):
    """SDXL's CLIP and VAE configs and random weights (fixed seeds)."""
    from stabletriton_tpu_torch.models import clip as clip_mod
    from stabletriton_tpu_torch.models import vae as vae_mod

    c1, c2 = clip_mod.sdxl_text_encoder_config(), clip_mod.sdxl_text_encoder_2_config()
    vcfg = vae_mod.sdxl_vae_config()
    params = {
        "text_encoder": clip_mod.init_clip_params(c1, 1, device=dev),
        "text_encoder_2": clip_mod.init_clip_params(c2, 2, device=dev),
        "vae": vae_mod.init_vae_params(vcfg, 3, device=dev),
    }
    return (c1, c2, vcfg), params


def make_sd15_other_params(dev):
    """SD1.5's CLIP-L (in both encoder slots: the pipeline reads one) and
    its VAE, random weights from fixed seeds."""
    from stabletriton_tpu_torch.models import clip as clip_mod
    from stabletriton_tpu_torch.models import vae as vae_mod

    c1, vcfg = clip_mod.sd15_text_encoder_config(), vae_mod.sd15_vae_config()
    params = {"text_encoder": clip_mod.init_clip_params(c1, 21, device=dev),
              "vae": vae_mod.init_vae_params(vcfg, 22, device=dev)}
    return (c1, c1, vcfg), params


def check_images(done, size):
    for i, (img, latency) in enumerate(done):
        ok = (img.shape == (size, size, 3) and np.isfinite(img).all()
              and img.min() >= -1.0 and img.max() <= 1.0)
        log(f"request {i}: latency {latency:.3f} s, image {img.shape} "
            f"range [{img.min():.3f}, {img.max():.3f}] mean {img.mean():.4f}")
        if not ok:
            raise AssertionError(f"request {i}: bad image")


def serve(dev, ucfg, unet_params, other, compile_config, prompts, counters, solo=None, *,
          size=1024, guidance=5.0):
    """A ServingEngine over a full-width pipeline: submit ``prompts`` together
    (one signature, so they co-batch), then ``solo`` alone. The counters are
    set to 0 just before the requests and read just after."""
    from stabletriton_tpu_torch.runtime.pipeline import SDXLPipeline
    from stabletriton_tpu_torch.runtime.serving import Request, ServingEngine

    (c1, c2, vcfg), params = other
    pipe = SDXLPipeline(unet_config=ucfg, clip_config=c1, clip2_config=c2,
                        vae_config=vcfg, params={"unet": unet_params, **params},
                        compile_config=compile_config, device=dev)
    tok = StubTokenizer(c1.bos_token_id, c1.eos_token_id)
    engine = ServingEngine(pipe, tok, tok, max_wait_s=0.5)
    kw = dict(height=size, width=size, steps=4, guidance_scale=guidance, solver="euler")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for c in counters.values():
            c.reset()
        t0 = time.perf_counter()
        futs = [engine.submit(Request(prompt=p, seed=s, **kw)) for p, s in prompts]
        done = []
        for f in futs:
            done.append((f.result(timeout=900), time.perf_counter() - t0))
        if solo is not None:
            t1 = time.perf_counter()
            fut = engine.submit(Request(prompt=solo[0], seed=solo[1], **kw))
            done.append((fut.result(timeout=900), time.perf_counter() - t1))
        counts = {k: c.count for k, c in counters.items()}
        by_key = {k: dict(c.by_key) for k, c in counters.items()}
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        engine.close()
    del pipe, engine
    gc.collect()  # the pipeline's program cache holds closures over the pipeline
    torch.cuda.empty_cache()
    check_images(done, size)
    log(f"peak device memory during serving: {peak / 2**30:.2f} GiB")
    log(f"kernel launches during serving: {json.dumps(counts)}")
    for name, keys in by_key.items():
        for key, n in sorted(keys.items()):
            log(f"  {name} {key}: {n}")
    return done, counts, by_key


def unet_steps(conv_by_key: dict, ucfg, kernel: str) -> int:
    """UNet steps run, from the conv_out launches (one conv with Cout = 4
    per step) of the given conv kernel counter's keys."""
    return sum(n for key, n in conv_by_key.items() if key.startswith(kernel)
               and key.split("->")[1].split()[0] == str(ucfg.out_channels))


def phase_serving(dev, ucfg, unet_params, other):
    """Phase 5: the default binding, two co-batched requests and one alone."""
    from stabletriton_tpu_torch.compile import CompileConfig
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import flash_attention as fa

    counters = {"flash_attention": fa.LAUNCHES, "conv3x3": cd.LAUNCHES}
    # two requests with one signature co-batch; the third repeats the first
    # one's seed alone
    done, counts, by_key = serve(
        dev, ucfg, unet_params, other, CompileConfig(), counters=counters,
        prompts=[("a lighthouse at dusk", 11), ("a bowl of ramen", 12)],
        solo=("a lighthouse at dusk", 11))
    solo_vs_batched = float(np.abs(done[0][0] - done[2][0]).max())
    log(f"same seed, batched (bucket 2) vs solo (bucket 1): max abs diff {solo_vs_batched:.3e}")
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"{name}: no launch during the serving run")
    attn = attention_by_class(by_key["flash_attention"])
    for k in ("K1", "K2", "K3"):
        if attn[k] == 0:
            raise AssertionError(f"no attention launch of class {k} during serving")
    return by_key


def phase_serving_fused(dev, ucfg, unet_params, other):
    """Phase 5b: the fused-op binding, two co-batched requests and the first
    one's seed alone. Every K8-K11 launch count must be its per-step count
    times the UNet steps run, which the conv_out launches (one K8 launch with
    Cout = 4 per step) give; K9 also runs each f32 VAE decoder GroupNorm once
    per image."""
    from stabletriton_tpu_torch.compile import FUSED_OP_OVERRIDES, CompileConfig

    counters = fused_counters()
    done, counts, by_key = serve(
        dev, ucfg, unet_params, other, CompileConfig(overrides=FUSED_OP_OVERRIDES),
        counters=counters, prompts=[("a red fox in snow", 21), ("a glass teapot", 22)],
        solo=("a red fox in snow", 21))
    log(f"same seed, batched (bucket 2) vs solo (bucket 1), fused-op binding: max abs diff "
        f"{float(np.abs(done[0][0] - done[2][0]).max()):.3e}")
    steps = unet_steps(by_key["K8"], ucfg, "wmma_bf16")
    vae_norms = sum(1 for k in other[1]["vae"] if k.endswith(
        ("norm1.weight", "norm2.weight", "group_norm.weight", "conv_norm_out.weight")))
    k9_f32 = sum(n for key, n in by_key["K9"].items() if key.startswith("f32"))
    log(f"fused-op serving: {steps} UNet steps, {len(done)} images, "
        f"{vae_norms} VAE GroupNorms per image")
    if steps == 0:
        raise AssertionError("no UNet step ran through K8 during the fused-op serving run")
    want = {k: n * steps for k, n in FUSED_PER_STEP.items()}
    want["K9"] += vae_norms * len(done)
    for k, n in want.items():
        if counts[k] != n:
            raise AssertionError(f"{k}: {counts[k]} launches during fused-op serving, "
                                 f"expected {n}")
    if k9_f32 != vae_norms * len(done):
        raise AssertionError(f"K9: {k9_f32} f32 launches, expected {vae_norms * len(done)}")
    return counts


def phase_serving_sd15(dev, ucfg, unet_params, other):
    """Phase 5c: SD1.5 at 512^2 under the default binding, two co-batched
    requests and the first one's seed alone (4 Euler steps, guidance 7.5).
    The bf16 attention launches of each class must be its per-step count
    times the UNet steps run (from the conv_out launches); the VAE decode
    adds one f32 K3 launch per image."""
    from stabletriton_tpu_torch.compile import CompileConfig
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import flash_attention as fa

    counters = {"flash_attention": fa.LAUNCHES, "conv3x3": cd.LAUNCHES}
    done, counts, by_key = serve(
        dev, ucfg, unet_params, other, CompileConfig(), counters=counters,
        prompts=[("a watercolor of a harbour", 31), ("an owl on a branch", 32)],
        solo=("a watercolor of a harbour", 31), size=512, guidance=7.5)
    log(f"same seed, batched (bucket 2) vs solo (bucket 1), SD1.5: max abs diff "
        f"{float(np.abs(done[0][0] - done[2][0]).max()):.3e}")
    steps = unet_steps(by_key["conv3x3"], ucfg, "wmma_bf16")
    bf16 = attention_by_class(by_key["flash_attention"], "wmma_bf16")
    tiny = attention_by_class(by_key["flash_attention"], "tinykv_bf16")
    f32 = attention_by_class(by_key["flash_attention"], "scalar_f32")
    got = {k: bf16[k] + tiny[k] for k in bf16}
    want = {k: n * steps for k, n in SD15_ATTN_PER_STEP.items()}
    log(f"SD1.5 serving: {steps} UNet steps, {len(done)} images; bf16 attention {got}, "
        f"f32 attention {f32}")
    if steps == 0 or got != want or tiny["K5"] != want["K5"]:
        raise AssertionError(f"SD1.5 serving: bf16 attention launches {got} "
                             f"(tiny-KV kernel {tiny['K5']}), expected {want}")
    if f32 != {**{k: 0 for k in f32}, "K3": len(done)}:
        raise AssertionError(f"SD1.5 serving: f32 attention {f32}, expected K3 {len(done)}")
    return by_key


REPLACES = {
    "K1": "stabletriton_tpu/kernels/flash_attention.py:228",
    "K2": "stabletriton_tpu/kernels/flash_attention.py:276",
    "K3": "stabletriton_tpu/kernels/flash_attention.py:120",
    "K4": "stabletriton_tpu/kernels/flash_attention.py:209",
    "K5": "stabletriton_tpu/kernels/flash_attention.py:184",
    "K6": "stabletriton_tpu/kernels/conv_direct.py:60",
    "K8": "stabletriton_tpu/kernels/conv_direct.py:60",  # with gs_ref/gsh_ref
    "K9": "stabletriton_tpu/kernels/group_norm.py:36",   # and _apply_kernel :54
    "K10": "stabletriton_tpu/kernels/layer_norm.py:23",
    "K11": "stabletriton_tpu/kernels/geglu.py:21",
}


def free(*objs):
    """Drop the caller's last references (passed in a container) and
    return the device memory they held to the card."""
    for o in objs:
        o.clear()
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; a CUDA GPU is required",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    from stabletriton_tpu_torch.kernels import build
    from stabletriton_tpu_torch.models.unet import sd15_unet_config, sdxl_base_unet_config

    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s ({build.build_info})")
    if "log" in build.build_info:
        for line in open(build.build_info["log"]).read().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("  ptxas " + line.strip())

    kernel_results = phase_kernels(dev) + phase_fused_kernels(dev) + phase_sd15_attention(dev)

    # SDXL-base at 1024^2: phases 4, 4b, 5, 5b
    ucfg = sdxl_base_unet_config()
    sdxl = {"unet": make_unet_params(dev, ucfg)}
    phase_step_deviation(dev, ucfg, sdxl["unet"], sdxl_step_inputs(dev), FUSED_PER_STEP,
                         ATTN_PER_STEP, "SDXL-base")
    sdxl["other"] = make_other_params(dev)
    by_key = phase_serving(dev, ucfg, sdxl["unet"], sdxl["other"])
    fused_counts = phase_serving_fused(dev, ucfg, sdxl["unet"], sdxl["other"])
    free(sdxl)

    # SD1.5 at 512^2: phases 4c, 5c
    ucfg = sd15_unet_config()
    sd15 = {"unet": make_unet_params(dev, ucfg)}
    phase_step_deviation(dev, ucfg, sd15["unet"], sd15_step_inputs(dev), SD15_FUSED_PER_STEP,
                         SD15_ATTN_PER_STEP, "SD1.5")
    sd15["other"] = make_sd15_other_params(dev)
    sd15_by_key = phase_serving_sd15(dev, ucfg, sd15["unet"], sd15["other"])
    free(sd15)

    # launches of each kernel on the serving paths (phases 5, 5b, 5c), by
    # the first two fields of its launch key ("K3 wmma_bf16") for attention
    attention = [*by_key["flash_attention"].items(), *sd15_by_key["flash_attention"].items()]
    conv = sum(by_key["conv3x3"].values()) + sum(sd15_by_key["conv3x3"].values())

    def launches(r):
        if r["tpu"] == "K6":
            return conv
        if r["tpu"] in FUSED_PER_STEP:
            return fused_counts[r["tpu"]]
        return sum(n for key, n in attention if key.startswith(r["kernel"] + " "))

    kernels = [{
        "name": r["name"], "route": "cuda", "source": r["source"],
        "replaces": REPLACES[r["tpu"]], "launches": launches(r),
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
    } for r in kernel_results]
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']}: no launch of its kernel on the serving paths")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
