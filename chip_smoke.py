#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (stabletriton_tpu_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py [--profile] [--plans]
    python3 chip_smoke.py --host-time [DIR]

``--profile`` adds a torch.profiler breakdown of one step under each
binding to phases 4 and 4c (device time by kernel family, idle share, the
attention kernels by name) and of the default binding's 1024^2 decode to
phase 5e (the same, and its 12 longest kernels);
``--plans`` times the wgmma kernels at forced tile widths and K splits
beside the planner's choice and a plain wave-filling rule's (before phase
3). ``--host-time`` only builds the kernels and prints the host time a
launch of the linear, conv, GroupNorm, LayerNorm, attention, timestep
embedding and dropout wrappers, of bare C entries and of the fused GN conv
op, of the package in DIR (a copy of another tree, to compare two in one
run) or of this checkout, with the skinny linear's, LayerNorm's and
dropout's device time and their PyTorch calls'; it prints no result line.

Phases, each fatal on failure (non-zero exit, no result line):

  1. device: the card's name and power limit from nvidia-smi;
  2. build: compile the CUDA kernels from stabletriton_tpu_torch/csrc/ for sm_90a;
  3. kernels: each kernel against its plain PyTorch version at the shapes the
     SDXL-base 1024^2 path gives it (max abs / max relative error, times:
     CUDA events through the wrapper, and in this and every later kernel
     phase the device time a call from torch.profiler's kernel events, for
     the kernel and the library call, since short rows read host time),
     beside its bound (operations over the peak rate or bytes over the
     memory rate, whichever is longer) and one PyTorch call computing the
     same function where there is one (SDPA for attention; the reference
     op's cuDNN conv for the bf16 convs, F.conv2d with TF32 off for the f32
     ones); each attention launch must carry its class (the JAX package's
     Pallas kernel it stands in for, K1-K5) and its kernel in its launch key
     (bf16 at most 128 keys on attn_tinykv_wgmma_bf16, above on
     attn_wgmma_bf16, f32 on the 3xTF32 GEMM wgmma_tf32x3, whose
     row also prints its bound at the f32 FMA peak and the time of its
     operand split); the convs run on the kernel the routing picks (bf16:
     wgmma, conv_in's Cin 4 padded to 8 and conv_out's Cout 4 on the
     8-column tile, with the padding's time printed; f32: the 3xTF32 wgmma
     kernel, beside the scalar kernel it replaced, or for the VAE's conv_in
     (Cin 4, SDXL's 128^2 and SD1.5's 64^2) the direct kernel, beside the
     scalar kernel it replaced and the 3xTF32 conv on Cin padded to 8),
     SD1.5's 16^2 and 8^2 levels included, and the tf32 rows beside their
     bound in 3xTF32 on the tensor cores as well; each bf16 attention row
     with Sk <= 128 (K5, and K1's cross-attention) also prints the device
     time of every bf16 kernel at the same operands;
  3b. fused-op kernels: GroupNorm (K9: stats, device fold and apply behind
     one C entry, beside F.group_norm, its device time from the profiler
     beside the wrapper's), LayerNorm / RMSNorm (K10, beside F.layer_norm /
     F.rms_norm), GEGLU (K11) and the GN-fused 3x3 conv (K8, its scale /
     shift from the GroupNorm fold kernel) against their plain versions at
     the same path's shapes; K8 also beside the unfused pair (K9 apply, K6);
  3c. SD1.5 attention: the bf16 kernels at the SD1.5 512^2 path's shapes
     (K3 at d=40, K4 at d=80 and 160, K5 on attn_tinykv_wgmma_bf16 against
     77 keys and the mid-block's 64), then phase 3's d=64 rows again;
  3e. C4: the bf16 attention kernels (K1 self and cross, K2, K3 at d=40,
     K4 at d=80 and 160, K5 at d=40, 80 and 160 and the mid block's S=64)
     on inputs where each output is an exact f32 quotient x / l whose bf16
     rounding differs from that of x * f32(1 / l): every output must be
     bf16(x / l) bit for bit, as JAX's o / l.clip(1e-30) gives it; and
     on inputs that put zeros, quotients under 2^-99 or over 2^99,
     infinities and NaN (by position) beside in-range outputs in one warp's
     rows, which the epilogue stores again with the division;
  3d. the rest of the opt-in kernels: the timestep embedding (K12) at
     (2,)->(2,320) and (12,)->(12,256), bit for bit against its plain
     version, beside the launch floor (the device time of an empty
     kernel); linear (K13) at every GEMM shape of
     both paths (wgmma, the f32 3xTF32 GEMM, SiLU and GELU epilogues, and
     the skinny kernel at each M = 2 shape of the steps, whose launches are
     counted by shape), each beside cuBLAS's addmm of the same GEMM (f32 with TF32
     off), the wgmma rows beside the WMMA kernel (element loads, the route
     of the shapes TMA cannot take), the f32 rows beside their f32-FMA bound
     and the time of the wrapper's weight split; seeded dropout (K14)
     through ops.dispatch under a ("dropout", "cuda") binding at (2, 4096,
     640) in bf16 and f32 and at 2^20 f32 elements, bit for bit against
     its plain version, deterministic, seed-sensitive, and dropping a
     fraction within 4 sigma of the rate;
  4, 4b, 4d. step deviation: one full-width SDXL-base UNet step (128^2
     latent, CFG batch 2, bf16, random weights, fused projections and the
     cross K/V precompute) under the default binding, the fused-op binding
     (CompileConfig.overrides: group_norm, layer_norm, geglu -> "cuda",
     gn_conv2d -> "fused") and the all-kernel binding (the fused-op binding
     plus linear and time_embed -> "cuda"), each against the "reference"
     binding: MSE under 1e-3; attention launches per step K1 130, K2 10:
     K1's 70 cross-attention launches (77 keys) on attn_tinykv_wgmma_bf16,
     the 60 self and K2 on attn_wgmma_bf16;
     fused-op launches K8 35, K9 11, K10 210, K11 70; all-kernel also K12 2
     and K13 463 + 70 in the precompute, every linear dispatch on the
     kernel and none on the reference (cuBLAS) op, 512 of the 533 on the
     wgmma kernel and 21 (M = 2) on the skinny one; under every binding all
     38 convs on the wgmma kernel;
  4c. one full-width SD1.5 UNet step (64^2 latent, CFG batch 2, bf16) under
     the three bindings against the reference binding, MSE under 1e-3;
     attention launches per step K3 5, K4 10, K5 17 (all on the tiny-KV
     kernel) and no K1 or K2; K8 45,
     K9 16, K10 48, K11 16; all-kernel K12 1, K13 152 + 16 (144 wgmma, 24
     skinny); all 49 convs on wgmma;
  5. serving: a ServingEngine over a full-width SDXL-base pipeline answers
     three 1024^2 requests (4 Euler steps, guidance 5); the images must be
     finite, (1024, 1024, 3) and inside [-1, 1], and the attention (K1, K2,
     K3) and conv launch counters must have moved during this phase, every
     K1/K2 launch on its kernel as in phase 4 and each image's f32 decode on the
     3xTF32 conv 32 times and the direct conv once (conv_in), its attention
     once on the 3xTF32 GEMM;
  5b. a second ServingEngine, over a pipeline with the fused-op binding,
     answers two co-batched 1024^2 requests and one alone; same image
     checks, and the launch counters of K8-K11 must match the per-step
     counts times the UNet steps run (K9 also once per VAE GroupNorm per
     image), and the attention and decode convs as in phase 5;
  5d. a third, with the all-kernel binding: as 5b, and K12 must launch 2 a
     UNet step, K13 463 a step + 70 a generation (the precompute) + 4 an
     image (the f32 VAE mid-attention);
  5e. the reference binding (cuBLAS, cuDNN, SDPA) serves the same three
     requests as phase 5; the same seed alone and co-batched must differ by
     at most SOLO_VS_BATCHED_BOUND under each of the four bindings (and
     under SD1.5's default binding in 5c), and a kernel binding by at most
     SOLO_VS_BATCHED_RATIO times the reference binding's diff; then one
     1024^2 f32 decode under the default binding against the reference
     binding's (TF32 off): max abs (at most DECODE_MAX_ABS), MSE and each
     decode's time, logged;
  5c. with the SDXL weights freed, a ServingEngine over a full-width SD1.5
     pipeline (CLIP-L, one encoder; VAE scaling 0.18215) answers two
     co-batched 512^2 requests and one alone (4 Euler steps, guidance 7.5);
     the images must be finite, (512, 512, 3) and inside [-1, 1]; the
     K3/K4/K5 bf16 launches must be the per-step counts times the UNet
     steps run (K3 and K4 on attn_wgmma_bf16, K5 on the tiny-KV kernel),
     plus one f32 K3 launch per
     image for the VAE on the 3xTF32 GEMM; the decode convs as in phase 5.

Each phase logs its peak device memory.

Prints a JSON line of per-kernel results, then as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Weights are random, made from fixed seeds; it needs no network.
"""

from __future__ import annotations

import ctypes
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
# one 1024^2 f32 decode under the default binding against the reference
# binding's (cuDNN, cuBLAS, SDPA; TF32 off), images in [-1, 1]: the kernels
# compute the same f32 function, 3xTF32 keeping ~f32 accuracy
DECODE_MAX_ABS = 5e-5
# the H100 SXM's published peaks (NVIDIA's data sheet, dense): bf16 on the
# tensor cores, f32 outside them, HBM3. The 3xTF32 conv does its f32
# products as three tf32 ones on the tensor cores, so its bound (and share)
# is taken at the TF32 peak over three, TF32X3_FLOPS (3 x flops at 495
# TFLOP/s); its bound at the f32 FMA peak, the rate of the scalar f32
# kernels, is printed beside it ("bound_f32_fma_ms")
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32X3_FLOPS = 495e12 / 3
MEMORY_BYTES_PER_S = 3.35e12


def log(*args):
    print(*args, flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def bound(flops: float, moved: int, dtype, peak: float | None = None) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the operations
    over the dtype's peak rate (or ``peak``) and the bytes (each input read
    once, each output written once) over the memory rate, and which of the
    two it is."""
    t_ops = flops / (peak or PEAK_FLOPS[dtype])
    t_mem = moved / MEMORY_BYTES_PER_S
    return max(t_ops, t_mem) * 1e3, ("operations" if t_ops >= t_mem else "bytes")


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


def device_ms(fn, iters: int) -> tuple[float, float, dict]:
    """Device time of one fn() call, its kernel launches a call and its
    device time a call by kernel name: the sums of its kernels' durations
    (torch.profiler's CUDA kernel events) over ``iters`` calls after one
    warm-up, so the host's gaps between launches do not count."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):  # a session now and then records no kernel at all
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        spans = [(e.name, e.time_range.end - e.time_range.start) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if spans:
            break
        log(f"  (profiler session {attempt + 1} recorded no kernel; profiling again)")
    if not spans:
        raise AssertionError("the profiler saw no kernel on the device")
    by_name = {}
    for name, us in spans:
        by_name[name] = by_name.get(name, 0.0) + us / iters / 1e3
    return sum(by_name.values()), len(spans) / iters, by_name


def compare(name, kernel_fn, plain_fn, tol, iters, *, bound_ms, library_fn=None,
            library_label="library call", old_fn=None, old_label="old kernel", op_fn=None,
            op_label="reference-binding op"):
    """Run kernel and plain version on the same inputs; fail past ``tol``
    (max abs error relative to the largest plain output). Timed beside them:
    ``library_fn``, one PyTorch call computing the same function (the
    yardstick, never called by the port); ``old_fn``, the kernel a
    redesigned kernel replaced (``old_label``), at the same shape, where the
    tree still has it; ``op_fn``, another binding's op. ``bound_ms`` is (ms,
    "operations" or "bytes")."""
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
    r = {"max_abs_err": err, "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
         "bound_ms": bound_ms[0], "bound_by": bound_ms[1],
         "library_ms": timed_ms(library_fn, iters) if library_fn is not None else None}
    # the device's own time a call, without the host's gaps between launches
    r["device_ms"], per_call, r["device_by_name"] = device_ms(kernel_fn, iters)
    dev_extra = ""
    if library_fn is not None:
        r["library_device_ms"] = device_ms(library_fn, iters)[0]
        dev_extra = f", {library_label} {r['library_device_ms']:.4f} ms"
    extra = ""
    if old_fn is not None:
        r["old_ms"], r["old_kernel"] = timed_ms(old_fn, iters), old_label
        r["old_device_ms"] = device_ms(old_fn, iters)[0]
        extra += f", {old_label} {r['old_ms']:.4f} ms (device {r['old_device_ms']:.4f})"
    if r["library_ms"] is not None:
        extra += f", {library_label} {r['library_ms']:.4f} ms"
    if op_fn is not None:
        extra += f", {op_label} {timed_ms(op_fn, iters):.4f} ms"
    log(f"kernel {name}: max_abs_err={err:.3e} max_rel_err={rel:.3e} (tol {tol:g}) "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{extra}; bound {bound_ms[0] * 1e3:.4g} us "
        f"({bound_ms[1]}), {bound_ms[0] / ms:.1%} of bound")
    log(f"  device time (profiler, kernels only): {r['device_ms']:.4f} ms in {per_call:g} "
        f"kernels a call, {bound_ms[0] / r['device_ms']:.1%} of bound{dev_extra}")
    if not rel <= tol:
        raise AssertionError(f"{name}: relative error {rel:.3e} exceeds {tol:g}")
    return r


def phase_fused_kernels(dev):
    """K8-K11 against their plain versions at the fused-op path's shapes,
    each beside its library call where one PyTorch call computes the same
    function (K9 F.group_norm, K10 F.layer_norm / F.rms_norm; no single call
    computes K11's state * gelu(gate) or K8's GroupNorm-fused conv)."""
    import torch.nn.functional as F

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

    def record(tpu, name, source, r, kernel=None):
        r.update(name=name, source=f"stabletriton_tpu_torch/csrc/{source}", tpu=tpu,
                 kernel=kernel)
        results.append(r)

    # K9: UNet transformer GroupNorms (bf16, no act), a resnet-sized one with
    # SiLU, and the VAE decoder's f32 GroupNorms with SiLU; the library call
    # is F.group_norm on an NCHW copy made outside the timed call (GroupNorm
    # alone: the SiLU rows' library time leaves the activation out)
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
        nchw = x.permute(0, 3, 1, 2).contiguous()
        lfn = lambda x=nchw, g=g, b=b: F.group_norm(x, 32, g, b, 1e-5)
        name = f"group_norm {tuple(shape)} {'bf16' if dtype == bf16 else 'f32'} act={act}"
        record("K9", name, "group_norm.cu", compare(
            name, kfn, pfn, BF16_REL_TOL if dtype == bf16 else F32_REL_TOL, iters,
            bound_ms=bound(0, 2 * nbytes(x) + nbytes(g, b), dtype), library_fn=lfn,
            library_label="F.group_norm", op_fn=ofn, op_label="default-binding op"))
        del x, nchw

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
        lfn = ((lambda x=x, g=g, c=c: F.rms_norm(x, (c,), g, 1e-6)) if rms
               else (lambda x=x, g=g, b=b, c=c: F.layer_norm(x, (c,), g, b, 1e-6)))
        name = f"{'rms_norm' if rms else 'layer_norm'} ({rows}, {c}) bf16"
        record("K10", name, "layer_norm.cu",
               compare(name, kfn, pfn, BF16_REL_TOL, 50,
                       bound_ms=bound(0, 2 * nbytes(x) + nbytes(g, b), bf16), library_fn=lfn,
                       library_label="F.rms_norm" if rms else "F.layer_norm", op_fn=ofn,
                       op_label="default-binding op"))

    # K11: the halves of the feed-forward projection, read in place
    for b_, s_, n in [(2, 4096, 2560), (2, 1024, 5120)]:
        proj = randn(b_, s_, 2 * n, scale=2.0)
        state, gate = proj.chunk(2, dim=-1)
        kfn = lambda st=state, ga=gate: gg.geglu(st, ga)
        pfn = lambda st=state, ga=gate: gg.geglu_plain(st, ga)
        ofn = lambda st=state, ga=gate: reference.geglu(st, ga)
        name = f"geglu halves of ({b_}, {s_}, {2 * n}) bf16"
        record("K11", name, "geglu.cu",
               compare(name, kfn, pfn, BF16_REL_TOL, 20,
                       bound_ms=bound(0, nbytes(proj) + nbytes(proj) // 2, bf16), op_fn=ofn,
                       op_label="default-binding op"))
        del proj, state, gate

    # K8: GroupNorm + SiLU fused into the 3x3 conv, on the wgmma kernel
    # (conv_out's Cout = 4 on its 8-column tile); beside it the unfused pair
    # (K9 apply, then K6) on the same scale / shift
    for label, (b_, hh, ww, cin, cout), bias_kind, with_res in [
            ("resnet conv1 128x128 320->320 batch-bias", (2, 128, 128, 320, 320), "bb", False),
            ("resnet conv2 64x64 640->640 bias+residual", (2, 64, 64, 640, 640), "b", True),
            ("up resnet conv1 32x32 2560->1280 batch-bias", (2, 32, 32, 2560, 1280), "bb",
             False),
            ("SD1.5 resnet conv1 8x8 1280->1280 batch-bias", (2, 8, 8, 1280, 1280), "bb",
             False),
            ("conv_out 128x128 320->4", (2, 128, 128, 320, 4), "b", False)]:
        x = randn(b_, hh, ww, cin, scale=2.0, shift=0.5)
        scale, shift = gn.scale_shift(x, randn(cin, dtype=f32, scale=0.2, shift=1.0),
                                      randn(cin, dtype=f32, scale=0.2), num_groups=32, eps=1e-5)
        w = randn(3, 3, cin, cout, scale=1.0 / math.sqrt(9 * cin))
        bias = randn(b_, cout, dtype=f32) if bias_kind == "bb" else randn(cout)
        res = randn(b_, hh, ww, cout) if with_res else None
        args = (x, scale, shift, w, bias)
        kernel = cd.conv_variant(tuple(x.shape), cout, bf16, gn=True)
        kfn = lambda a=args, r=res: cd.gn_conv3x3(*a, residual=r, gn_act="silu")
        pfn = lambda a=args, r=res: cd.gn_conv3x3_plain(*a, residual=r, gn_act="silu")
        name = f"gn_conv3x3 {label}"
        flops = 2 * b_ * hh * ww * cout * 9 * cin
        moved = nbytes(x, w, bias, res, scale, shift) + b_ * hh * ww * cout * 2
        r = compare(name, kfn, pfn, BF16_REL_TOL, 10, bound_ms=bound(flops, moved, bf16))
        unfused = lambda a=args, r=res: cd.conv3x3(gn.apply(a[0], a[1], a[2], "silu"), a[3],
                                                     a[4], residual=r)
        r["unfused_ms"] = timed_ms(unfused, 10)
        log(f"  {kernel}; unfused pair (K9 apply + K6) {r['unfused_ms']:.4f} ms vs fused "
            f"{r['ms']:.4f} ms")
        record("K8", name, "conv3x3.cu", r, kernel)
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
    inputs, beside F.scaled_dot_product_attention on (B, h, S, d) copies made
    outside the timed call. The launch must carry the case's class in its
    counter key."""
    import torch.nn.functional as F

    from stabletriton_tpu_torch.kernels import flash_attention as fa

    def heads(t, h):
        b, s, c = t.shape
        return t.reshape(b, s, h, c // h).transpose(1, 2).contiguous()

    results = []
    for label, tpu, kind, shape, dtype, iters in cases:
        tol = BF16_REL_TOL if dtype == torch.bfloat16 else F32_REL_TOL
        if kind == "qkv":
            b, s, c, h = shape
            qkv = randn(b, s, 3 * c, dtype=dtype)
            kfn = lambda qkv=qkv, h=h: fa.flash_attention_qkv(qkv, num_heads=h)
            pfn = lambda qkv=qkv, h=h: fa.attention_plain(*qkv.chunk(3, -1), num_heads=h)
            q, k, v = qkv.chunk(3, -1)
            sq, sk, inputs = s, s, (qkv,)
        elif kind == "kv":
            b, sq, sk, c, h = shape
            q, kv = randn(b, sq, c, dtype=dtype), randn(b, sk, 2 * c, dtype=dtype)
            kfn = lambda q=q, kv=kv, h=h: fa.flash_attention_kv(q, kv, num_heads=h)
            pfn = lambda q=q, kv=kv, h=h: fa.attention_plain(q, *kv.chunk(2, -1), num_heads=h)
            k, v = kv.chunk(2, -1)
            inputs = (q, kv)
        else:
            b, s, c, h = shape
            q, k, v = (randn(b, s, c, dtype=dtype) for _ in range(3))
            kfn = lambda q=q, k=k, v=v, h=h: fa.flash_attention(q, k, v, num_heads=h)
            pfn = lambda q=q, k=k, v=v, h=h: fa.attention_plain(q, k, v, num_heads=h)
            sq, sk, inputs = s, s, (q, k, v)
        qh, kh, vh = heads(q, h), heads(k, h), heads(v, h)
        lfn = lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(qh, kh, vh)
        flops = 4 * b * h * sq * sk * (c // h)
        moved = nbytes(*inputs) + b * sq * c * qh.element_size()
        before = dict(fa.LAUNCHES.by_key)
        name = f"flash_attention {label}"
        f32 = dtype == torch.float32
        r = compare(name, kfn, pfn, tol, iters,
                    bound_ms=bound(flops, moved, dtype, TF32X3_FLOPS if f32 else None),
                    library_fn=lfn, library_label="SDPA")
        if f32:
            # the 3xTF32 GEMM's bound (above) and the f32 FMA one; the operand
            # split (plain torch, inside the kernel's time)
            r["bound_f32_fma_ms"] = bound(flops, moved, dtype)[0]
            r["prep_ms"] = timed_ms(lambda k=k, v=v, h=h: fa.tf32_attention_operands(k, v, h),
                                    iters)
            log(f"  bound in 3xTF32 (above); at the f32 FMA peak {r['bound_f32_fma_ms']:.4f} ms; "
                f"the wrapper's K / V^T split (tf32_attention_operands, inside the kernel's "
                f"time) {r['prep_ms']:.4f} ms; {fa.attention_chunk_rows(b * h, sq, sk)} query "
                f"rows a chunk")
        keys = {k for k, n in fa.LAUNCHES.by_key.items() if n != before.get(k, 0)}
        want = fa.kernel_name(dtype, sk)
        if {tuple(k.split()[:2]) for k in keys} != {(tpu, want)}:
            raise AssertionError(f"{name}: launched {sorted(keys)}, expected class {tpu} on "
                                 f"{want}")
        key = sorted(keys)[0]
        log(f"  launch key: {key}")
        if dtype == torch.bfloat16 and sk <= fa.LANES:
            # every bf16 kernel of the C entry at the same operands (launched
            # past the route, after the key check), device time a call: the
            # measurement behind which kernel the route gives Sk <= 128 (K5,
            # and SDXL's K1 cross-attention)
            operands = ((qkv, 0, qkv, c, qkv, 2 * c) if kind == "qkv" else (q, 0, kv, 0, kv, c))
            r["alt_device_ms"] = {name: device_ms(
                lambda name=name: fa._launch(*operands, sq=sq, sk=sk, num_heads=h, d=c // h,
                                             scale=None, kernel=name), iters)[0]
                for name in fa._KERNEL_CODES}
            log(f"  {tpu} {label}, device ms a call by kernel at the same operands: "
                + ", ".join(f"{n} {ms:.4f}" for n, ms in r["alt_device_ms"].items())
                + f", SDPA {r['library_device_ms']:.4f}; bound {r['bound_ms'] * 1e3:.4g} us")
        r.update(name=name, source="stabletriton_tpu_torch/csrc/flash_attention.cu", tpu=tpu,
                 kernel=" ".join(key.split()[:2]))
        if record:
            results.append(r)
        del qh, kh, vh
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


# C4: (form, b, sq, sk, h, d, live keys, class) of division_probe on each
# route of the bf16 kernels: K1 self off the fused QKV buffer and cross off
# the fused KV buffer (the tiny-KV kernel at Sk <= 128, the KV loop above;
# SDXL's 77 keys with 56 live), K2 past 1024 keys, K3 bf16 at d = 40 (h = 1
# on both kernels, unpacked heads past 1024 keys), K4 at d = 80 and 160, K5
# at d = 40, 80, 160 and SD1.5's mid-block self-attention (S = 64 with 56
# live keys: a power-of-two row sum divides exactly either way); the list of
# tests/test_torch_port_gpu.py's C4 test
C4_ROUTES = (
    [("qkv", 2, s, s, 2, 64, s, "K1") for s in (28, 56, 112, 224)]
    + [("kv", 2, 300, s, 2, 64, s, "K1") for s in (28, 56, 112)]
    + [("kv", 2, 1024, 77, 10, 64, 56, "K1"),
       ("qkv", 1, 1792, 1792, 2, 64, 1792, "K2"),
       ("sep", 2, 300, 28, 1, 40, 28, "K3"),
       ("sep", 2, 300, 224, 1, 40, 224, "K3"),
       ("qkv", 1, 1792, 1792, 2, 40, 1792, "K3")]
    + [("qkv", 2, s, s, 2, d, s, "K4") for d in (80, 160) for s in (224, 448)]
    + [("kv", 2, 300, s, 2, d, s, "K5") for d in (40, 80, 160) for s in (28, 56, 112)]
    + [("qkv", 2, 64, 64, 8, 160, 56, "K5")]
)


# the epilogue's out-of-range outputs: (form, b, sq, sk, h, d, live keys a
# half, class) of range_probe on each bf16 kernel and head dim; the list of
# tests/test_torch_port_gpu.py's out-of-range test
RANGE_ROUTES = [
    ("kv", 2, 300, 56, 2, 64, 28, "K1"),
    ("kv", 2, 300, 77, 10, 64, 28, "K1"),
    ("qkv", 2, 224, 224, 2, 64, 112, "K1"),
    ("sep", 2, 300, 224, 1, 40, 112, "K3"),
    ("qkv", 2, 224, 224, 2, 80, 112, "K4"),
    ("kv", 2, 300, 112, 2, 40, 56, "K5"),
    ("kv", 2, 300, 112, 2, 80, 56, "K5"),
    ("kv", 2, 300, 112, 2, 160, 56, "K5"),
    ("qkv", 2, 64, 64, 8, 160, 28, "K5"),
]


def probe_run(fa, dev, form, h, q, k, v):
    """One launch of the bf16 attention on a probe's operands (fa: the
    attention module; q, k, v float32 holding bf16 values)."""
    q, k, v = (t.to(torch.bfloat16).to(dev) for t in (q, k, v))
    if form == "qkv":
        out = fa.flash_attention_qkv(torch.cat([q, k, v], -1), num_heads=h)
    elif form == "kv":
        out = fa.flash_attention_kv(q, torch.cat([k, v], -1), num_heads=h)
    else:
        out = fa.flash_attention(q, k, v, num_heads=h)
    torch.cuda.synchronize()
    return out


def phase_c4(dev):
    """Phase 3e: C4 on every route of the bf16 attention kernels (K1-K5):
    each output of division_probe is the f32 quotient x / l rounded once
    to bf16, on inputs where x * f32(1 / l) rounds to another bf16 for every
    output; and so is each output of range_probe, whose zeros, tiny, huge,
    infinite and NaN outputs (NaN by position) the epilogue stores with the
    division. Fails on any output that differs and on a launch off its
    class or kernel."""
    from stabletriton_tpu_torch.kernels import flash_attention as fa

    outputs = 0
    cases = ([("C4", r, fa.division_probe(*r[1:7], seed=r[3] + r[5] + r[4])) for r in C4_ROUTES]
             + [("range", r, fa.range_probe(*r[1:7], seed=r[3] + r[5] + r[4]))
                for r in RANGE_ROUTES])
    for probe, (form, b, sq, sk, h, d, live, cls), ops in cases:
        before = dict(fa.LAUNCHES.by_key)
        out = probe_run(fa, dev, form, h, *ops[:3])
        if probe == "C4":
            want = (ops[3] / live).to(torch.bfloat16)[:, None, :].expand(-1, sq, -1)
        else:
            want = (ops[3] / ops[4][..., None]).to(torch.bfloat16)
        want = want.to(dev)
        keys = sorted(k for k, n in fa.LAUNCHES.by_key.items() if n != before.get(k, 0))
        kernel = fa.kernel_name(torch.bfloat16, sk)
        nan = want.isnan()
        differ = int((out.isnan() != nan).sum()) + int(
            (out.view(torch.int16)[~nan] != want.view(torch.int16)[~nan]).sum())
        log(f"{probe} {form} b={b} sq={sq} sk={sk} h={h} d={d} l={live}: {keys}, {differ} of "
            f"{out.numel()} outputs differ from bf16(x / l)")
        if [k.split()[:2] for k in keys] != [[cls, kernel]]:
            raise AssertionError(f"{probe} {form} sk={sk} d={d}: launched {keys}, expected "
                                 f"{cls} on {kernel}")
        if differ:
            raise AssertionError(f"{probe} {form} sk={sk} d={d}: {differ} outputs differ")
        outputs += out.numel()
    log(f"C4: {len(cases)} launches ({len(RANGE_ROUTES)} with outputs out of the Markstein "
        f"step's range), all {outputs} outputs bf16(x / l) bit for bit")


# K13 at the shapes of both paths: (label, M, K, N, bias, act, dtype, timing
# iterations); "+b" marks a bias
LINEAR_CASES = [
    ("SDXL to_qkv (8192,640)@(640,1920)", 8192, 640, 1920, False, None, torch.bfloat16, 20),
    ("SDXL ff proj (2048,1280)@(1280,10240)+b", 2048, 1280, 10240, True, None, torch.bfloat16,
     10),
    ("SDXL ff out (2048,5120)@(5120,1280)+b", 2048, 5120, 1280, True, None, torch.bfloat16, 10),
    ("SDXL cross K/V precompute (154,2048)@(2048,2560)", 154, 2048, 2560, False, None,
     torch.bfloat16, 20),
    ("SDXL time MLP (2,1280)@(1280,1280)+b", 2, 1280, 1280, True, None, torch.bfloat16, 50),
    ("SDXL add embedding (2,2816)@(2816,1280)+b", 2, 2816, 1280, True, None, torch.bfloat16,
     50),
    ("SDXL time_emb_proj (2,1280)@(1280,320)+b", 2, 1280, 320, True, None, torch.bfloat16, 50),
    ("SDXL time_emb_proj (2,1280)@(1280,640)+b", 2, 1280, 640, True, None, torch.bfloat16, 50),
    ("SD1.5 to_qkv (8192,320)@(320,960)", 8192, 320, 960, False, None, torch.bfloat16, 20),
    ("SD1.5 8x8 level (128,1280)@(1280,1280)+b", 128, 1280, 1280, True, None, torch.bfloat16,
     50),
    ("VAE f32 (16384,512)@(512,512)+b", 16384, 512, 512, True, None, torch.float32, 10),
    ("SD1.5 VAE f32 (4096,512)@(512,512)+b", 4096, 512, 512, True, None, torch.float32, 20),
    ("act=silu (2,320)@(320,1280)+b", 2, 320, 1280, True, "silu", torch.bfloat16, 50),
    ("act=gelu (2048,1280)@(1280,5120)+b", 2048, 1280, 5120, True, "gelu", torch.bfloat16, 10),
]


def phase_optional_kernels(dev):
    """Phase 3d: K12 (time_embed), K13 (linear, every variant the paths
    run, beside cuBLAS's addmm of the same GEMM) and K14 (dropout) against
    their plain versions. K14 runs through the op dispatch under a
    ("dropout", "cuda") binding, its path (no model reaches dropout); its
    output must equal the plain version bit for bit, repeat itself, change
    with the seed, and drop a fraction within 4 sigma of the rate."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import CompileConfig, resolve_binding
    from stabletriton_tpu_torch.kernels import build
    from stabletriton_tpu_torch.kernels import dropout as dr
    from stabletriton_tpu_torch.kernels import linear as lin
    from stabletriton_tpu_torch.kernels import time_embed as te

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev).manual_seed(4444)
    results = []

    def record(tpu, name, source, r, **extra):
        r.update(name=name, source=f"stabletriton_tpu_torch/csrc/{source}", tpu=tpu, **extra)
        results.append(r)

    # K12: the SDXL timesteps (and SD1.5's, the same shape) and time_ids; no
    # single PyTorch call computes the sinusoidal embedding. Beside each row
    # the launch floor: the device time of an empty kernel (one block of 32
    # threads, st_launch_floor), the least a launch takes
    floor_entry = build.function("st_launch_floor", [ctypes.c_void_p])
    floor_ms = device_ms(lambda: floor_entry(build.current_stream(dev)), 50)[0]
    for t_vals, dim in [([999.0, 999.0], 320), ([1024.0, 1024, 0, 0, 1024, 1024] * 2, 256)]:
        t = torch.tensor(t_vals, device=dev)
        name = f"time_embed ({len(t_vals)},)->({len(t_vals)},{dim}) f32"
        r = compare(name, lambda t=t, dim=dim: te.time_embed(t, dim=dim),
                    lambda t=t, dim=dim: te.time_embed_plain(t, dim=dim), F32_REL_TOL, 50,
                    bound_ms=bound(0, nbytes(t) * (1 + dim), torch.float32))
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{name}: not the plain version's bits")
        r["launch_floor_ms"] = floor_ms
        log(f"  launch floor (an empty kernel, device time) {floor_ms:.4f} ms; K12 "
            f"{r['device_ms']:.4f} ms, {r['device_ms'] / floor_ms:.2f}x the floor")
        record("K12", name, "time_embed.cu", r)

    # K13: each variant at the paths' shapes, cuBLAS's addmm of the same GEMM
    # as the library call; the wgmma rows also time the WMMA kernel (element
    # loads: the route of the shapes TMA cannot take), launched through the
    # wrapper's internal launch
    for label, m, k, n, has_bias, act, dtype, iters in LINEAR_CASES:
        x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
        if "time MLP" in label or "time_emb_proj" in label:
            x = torch.nn.functional.silu(x)  # these read silu of the time embedding
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(dtype)
        b = torch.randn(n, generator=gen, device=dev).to(dtype) if has_bias else None
        before = dict(lin.LAUNCHES.by_key)
        name = f"linear {label}" + (f" act={act}" if act and "act=" not in label else "")
        kernel = lin.variant(m, k, n, dtype)
        f32 = dtype == torch.float32
        flops, moved = 2 * m * n * k, nbytes(x, w, b) + m * n * x.element_size()
        r = compare(name, lambda x=x, w=w, b=b, act=act: lin.linear(x, w, b, act=act),
                    lambda x=x, w=w, b=b, act=act: lin.linear_plain(x, w, b, act=act),
                    F32_REL_TOL if f32 else BF16_REL_TOL, iters,
                    bound_ms=bound(flops, moved, dtype,
                                   TF32X3_FLOPS if kernel == "wgmma_tf32x3" else None),
                    library_fn=(lambda x=x, w=w, b=b: torch.addmm(b, x, w)) if b is not None
                    else (lambda x=x, w=w: x @ w), library_label="cuBLAS addmm",
                    old_fn=(lambda x=x, w=w, b=b, act=act: lin._launch(x, w, b, act,
                                                                      "wmma_bf16")[0])
                    if kernel == "wgmma_bf16" else None, old_label="WMMA kernel")
        if kernel == "wgmma_tf32x3":
            # the 3xTF32 GEMM's bound (above) and the f32 FMA one; on the
            # device, the w^T split kernel (inside the row's time) and the GEMM
            r["bound_f32_fma_ms"] = bound(flops, moved, dtype)[0]
            by_name = r["device_by_name"]
            r["prep_ms"] = sum(ms for kn, ms in by_name.items() if "tf32_split" in kn)
            gemm_ms = sum(ms for kn, ms in by_name.items() if "gemm_wgmma_tf32x3" in kn)
            log(f"  bound in 3xTF32 (above); at the f32 FMA peak {r['bound_f32_fma_ms']:.4f} ms; "
                f"on the device the w^T split kernel {r['prep_ms']:.4f} ms, the GEMM "
                f"{gemm_ms:.4f} ms ({r['bound_ms'] / max(gemm_ms, 1e-9):.1%} of bound)")
        keys = {key for key, c in lin.LAUNCHES.by_key.items() if c != before.get(key, 0)}
        if len(keys) != 1 or not next(iter(keys)).startswith(kernel + " "):
            raise AssertionError(f"{name}: launched {sorted(keys)}, expected {kernel}")
        log(f"  launch key: {sorted(keys)[0]}")
        record("K13", name, "linear.cu", r, kernel=kernel, shape=(m, k, n))
        del x, w, b

    # K14: through the op dispatch, its path; bit-equal to the plain version
    binding = resolve_binding(CompileConfig(backend="reference",
                                            overrides=(("dropout", "cuda"),)))
    rate, seed = 0.1, 20260417
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for shape, dtype in [((2, 4096, 640), torch.bfloat16), ((2, 4096, 640), torch.float32),
                         ((1 << 20,), torch.float32)]:
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        name = f"dropout {tuple(shape)} {'bf16' if dtype == torch.bfloat16 else 'f32'} rate={rate}"
        dr.LAUNCHES.reset()
        with ops.use_backends(binding):
            out = ops.dispatch("dropout", x, seed, rate=rate)
            again = ops.dispatch("dropout", x, seed, rate=rate)
        torch.cuda.synchronize()
        launches = dr.LAUNCHES.count
        plain = dr.dropout_plain(x, seed, rate=rate)
        other = dr.dropout(x, seed + 1, rate=rate)
        dropped = (out == 0).float().mean().item()
        sigma = math.sqrt(rate * (1 - rate) / x.numel())
        log(f"kernel {name}: {launches} launches through ops.dispatch; equal to plain "
            f"{torch.equal(out, plain)}, repeat {torch.equal(out, again)}, other seed differs "
            f"{not torch.equal(out, other)}; dropped {dropped:.5f} (rate {rate}, "
            f"4 sigma {4 * sigma:.5f})")
        if launches != 2 or not torch.equal(out, again) or torch.equal(out, other):
            raise AssertionError(f"{name}: not deterministic in (x, seed, rate)")
        if not torch.equal(out, plain):
            raise AssertionError(f"{name}: kernel and plain version differ")
        if abs(dropped - rate) > 4 * sigma:
            raise AssertionError(f"{name}: dropped {dropped:.5f}, rate {rate}")
        # no single PyTorch call computes the seeded (Philox, index-keyed) mask;
        # the bound counts the bytes alone
        r = {"max_abs_err": (out.float() - plain.float()).abs().max().item(), "max_rel_err": 0.0,
             "ms": timed_ms(lambda x=x: dr.dropout(x, seed, rate=rate), 20),
             "plain_ms": timed_ms(lambda x=x: dr.dropout_plain(x, seed, rate=rate), 5),
             "library_ms": None,
             "device_ms": device_ms(lambda x=x: dr.dropout(x, seed, rate=rate), 20)[0]}
        r["bound_ms"], r["bound_by"] = bound(0, 2 * nbytes(x), dtype)
        # the kernel alone after 64 MB written over the 50 MB L2 cache: x read
        # from device memory, as the bound counts it (the row above finds x,
        # and the output's reused block, in L2 from the call before)
        by_name = device_ms(lambda x=x: (flush.zero_(), dr.dropout(x, seed, rate=rate)), 20)[2]
        r["cold_device_ms"] = sum(ms for kn, ms in by_name.items() if "dropout_kernel" in kn)
        log(f"  kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.4f} ms (bytes); device time (profiler) {r['device_ms']:.4f} ms, "
            f"{r['bound_ms'] / r['device_ms']:.1%} of bound; L2 overwritten first "
            f"{r['cold_device_ms']:.4f} ms, {r['bound_ms'] / r['cold_device_ms']:.1%}")
        record("K14", name, "dropout.cu", r, launches=launches)
        del x, out, again, plain, other
    del flush
    torch.cuda.empty_cache()
    return results


def phase_kernels(dev):
    """K1-K3 at the SDXL path's attention shapes, then K6 at every 3x3 conv
    shape of both paths on the kernel the routing picks: the wgmma kernel
    beside the WMMA kernel it replaced and the reference binding's cuDNN op
    (the library call); the f32 VAE convs beside one F.conv2d call (TF32
    off) on channels-last copies made outside the timed call."""
    import torch.nn.functional as F

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

    # K6: every 3x3 stride-1 conv; the epilogue forms the path uses; SD1.5's
    # 16^2 and 8^2 levels, where the K split fills the card
    conv_cases = [
        ("unet 128x128 320->320 batch-bias silu", (2, 128, 128, 320, 320), bf16, "bb", None),
        ("unet 128x128 320->320 bias+residual", (2, 128, 128, 320, 320), bf16, "b", "res"),
        ("unet 64x64 640->640 batch-bias", (2, 64, 64, 640, 640), bf16, "bb", None),
        ("unet 32x32 1280->1280 bias+residual", (2, 32, 32, 1280, 1280), bf16, "b", "res"),
        ("SD1.5 16x16 1280->1280 batch-bias", (2, 16, 16, 1280, 1280), bf16, "bb", None),
        ("SD1.5 8x8 1280->1280 batch-bias", (2, 8, 8, 1280, 1280), bf16, "bb", None),
        ("unet conv_in 128x128 4->320", (2, 128, 128, 4, 320), bf16, "b", None),
        ("unet conv_out 128x128 320->4", (2, 128, 128, 320, 4), bf16, "b", None),
        ("vae conv_in 128x128 4->512 f32", (1, 128, 128, 4, 512), torch.float32, "b", None),
        ("SD1.5 vae conv_in 64x64 4->512 f32", (1, 64, 64, 4, 512), torch.float32, "b", None),
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
        kernel = cd.conv_variant(tuple(x.shape), cout, dtype)
        kfn = lambda x=x, w=w, bias=bias, res=res, act=act: cd.conv3x3(
            x, w, bias, residual=res, act=act)
        pfn = lambda x=x, w=w, bias=bias, res=res, act=act: cd.conv3x3_plain(
            x, w, bias, residual=res, act=act)
        if dtype == bf16:
            lfn = lambda x=x, w=w, bias=bias, res=res, act=act: reference.conv2d(
                x, w, bias, residual=res, act=act)
            label_l = "cuDNN (reference op)"
        else:
            xc = x.permute(0, 3, 1, 2)                                  # NCHW view, channels last
            wc = w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)  # OIHW, channels last
            lfn = lambda xc=xc, wc=wc, bias=bias: F.conv2d(xc, wc, bias, padding=1)
            label_l = "F.conv2d f32"
        # the kernel a redesigned route replaced, at the same shape, where
        # the tree still has it
        old = {"wgmma_tf32x3": "scalar", "direct_f32": "scalar"}.get(kernel)
        ofn = ((lambda x=x, w=w, bias=bias, res=res, act=act, old=old: cd._launch(
            x, w, bias, res, act, variant=old)[0]) if old else None)
        iters = 3 if dtype == torch.float32 else 10
        flops = 2 * b * hh * ww * cout * 9 * cin
        moved = nbytes(x, w, bias, res) + b * hh * ww * cout * x.element_size()
        name = f"conv3x3 {label}"
        tf32 = kernel == "wgmma_tf32x3"
        r = compare(name, kfn, pfn, tol, iters,
                    bound_ms=bound(flops, moved, dtype, TF32X3_FLOPS if tf32 else None),
                    library_fn=lfn, library_label=label_l, old_fn=ofn,
                    old_label="scalar f32 kernel")
        if dtype == torch.float32 and cin % 8:
            # the other design for a small Cin: the 3xTF32 conv on x and w
            # padded to 8 channels (the pad made outside the timed call),
            # device time of the conv kernel alone and with its weight split
            pad = -cin % 8
            xp, wp = F.pad(x, (0, pad)), F.pad(w, (0, 0, 0, pad))
            _, _, by_name = device_ms(lambda xp=xp, wp=wp, bias=bias, res=res, act=act: cd._launch(
                xp, wp, bias, res, act, variant="wgmma_tf32x3")[0], iters)
            conv_ms = sum(t for kn, t in by_name.items() if "conv_wgmma_tf32x3" in kn)
            r["tf32_padded_device_ms"] = conv_ms
            log(f"  3xTF32 conv on Cin padded to {cin + pad} (pad outside the timing), device: "
                f"conv kernel {conv_ms:.4f} ms, with its weight split "
                f"{sum(by_name.values()):.4f} ms")
            del xp, wp
        if tf32:
            r["bound_f32_fma_ms"] = bound(flops, moved, dtype)[0]
            prep_ms = timed_ms(lambda w=w: cd.tf32_split(w), iters)
            log(f"  bound in 3xTF32 (above); at the f32 FMA peak {r['bound_f32_fma_ms']:.4f} ms; "
                f"the wrapper's weight split (tf32_split, inside the kernel's time) "
                f"{prep_ms:.4f} ms")
        if dtype == bf16 and (cin % 8 or cout <= 8):
            # conv_in's Cin padded to 8, conv_out's K-major 8-row weight
            # (inside the kernel's time)
            r["prep_ms"] = timed_ms(lambda x=x, w=w: (
                cd.n8_weight(w) if cout <= 8 else cd._pad_cin(x, w, None)), iters)
            log(f"  the wrapper's {'8-row weight' if cout <= 8 else 'Cin padding'} (inside "
                f"the kernel's time) {r['prep_ms']:.4f} ms")
        log(f"  {kernel}")
        r.update(name=name, source="stabletriton_tpu_torch/csrc/conv3x3.cu", tpu="K6",
                 kernel=kernel)
        results.append(r)
        del x, w, bias, res
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True
    return results


# the GEMMs and convs whose forced plans ``--plans`` times: the SDXL and
# SD1.5 paths' shapes with the most launches or time a step
PLAN_GEMMS = [(8192, 640, 1920), (8192, 640, 640), (2048, 1280, 10240), (2048, 5120, 1280),
              (2048, 1280, 1280), (154, 2048, 2560), (8192, 320, 960), (128, 1280, 1280)]
# the skinny linear's (K, N) at M = 2 on the SDXL and SD1.5 steps
SKINNY_STEP_SHAPES = [(320, 1280), (1280, 320), (1280, 640), (1280, 1280), (2816, 1280)]
PLAN_CONVS = [(2, 128, 128, 320, 320), (2, 64, 64, 640, 640), (2, 32, 32, 1280, 1280),
              (2, 32, 32, 2560, 1280), (2, 16, 16, 1280, 1280), (2, 8, 8, 1280, 1280)]


def wave_rule(m_tiles: int, n: int, steps: int):
    """A plain wave-filling rule to hold the planner's model against: width
    256 wherever N has a 256-wide tile, then the least K split whose blocks
    fill one wave of the card's SMs."""
    from stabletriton_tpu_torch.kernels import wgmma_plan as wp

    bn = 256 if n >= 256 else 128
    splits = math.ceil(wp.SMS / (m_tiles * math.ceil(n / bn)))
    return wp.Plan(bn, max(1, min(splits, steps, wp.MAX_SPLITS)))


def phase_plans(dev):
    """``--plans``: each wgmma shape above at every width and a range of K
    splits, launched through the C entry points (no wrapper host time),
    beside the plan wgmma_plan picks (the data its model was fitted to) and
    the plan of :func:`wave_rule`; and the skinny linear at each of its
    step shapes at every slice width and a range of K splits, beside the
    plan of linear.skinny_plan."""
    from stabletriton_tpu_torch.kernels import build
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import linear as lin
    from stabletriton_tpu_torch.kernels import wgmma_plan as wp

    gen = torch.Generator(device=dev).manual_seed(99)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gemm = build.function("st_linear_wgmma", lin._WGMMA_ARGTYPES)
    conv = build.function("st_conv3x3_wgmma", cd._WGMMA_ARGTYPES)
    model_vs_rule = []

    def sweep(label, chosen, rule, steps, rows, n, launch):
        times = {}
        plans = {(bn, sp) for bn in wp.WIDTHS for sp in (1, 2, 3, 4, 6, 9, 12) if sp <= steps}
        for bn, splits in sorted(plans | {(chosen.bn, chosen.splits), (rule.bn, rule.splits)}):
            ws = torch.empty((splits, rows, n), device=dev) if splits > 1 else None
            times[(bn, splits)] = timed_ms(lambda: launch(bn, splits, ws), 10)
        best = min(times, key=times.get)
        t_model, t_rule = times[(chosen.bn, chosen.splits)], times[(rule.bn, rule.splits)]
        model_vs_rule.append(t_rule / t_model)
        log(f"plans {label}: chosen bn={chosen.bn} split={chosen.splits} {t_model:.4f} ms, "
            f"wave rule bn={rule.bn} split={rule.splits} {t_rule:.4f} ms "
            f"({t_rule / t_model - 1:+.0%}), fastest bn={best[0]} split={best[1]} "
            f"{times[best]:.4f} ms; " + ", ".join(f"{b}/{sp} {t:.4f}" for (b, sp), t in
                                                 sorted(times.items())))

    for m, k, n in PLAN_GEMMS:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
        steps = math.ceil(k / wp.BK)
        sweep(f"gemm ({m},{k})@({k},{n})", wp.gemm_plan(m, k, n),
              wave_rule(math.ceil(m / wp.BM), n, steps), steps, m, n,
              lambda bn, sp, ws: gemm(x.data_ptr(), w.data_ptr(), None, 0, out.data_ptr(),
                                      None if ws is None else ws.data_ptr(), m, n, k, 0, bn, sp,
                                      stream))
    for b, h, wd, cin, cout in PLAN_CONVS:
        x = torch.randn((b, h, wd, cin), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((3, 3, cin, cout), generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((b, h, wd, cout), device=dev, dtype=torch.bfloat16)
        tile, plan = wp.conv_plan(b, h, wd, cin, cout)
        steps = 9 * math.ceil(cin / wp.BK)
        sweep(f"conv {b}x{h}x{wd} {cin}->{cout}", plan,
              wave_rule(math.prod(tile.counts(b, h, wd)), cout, steps), steps, b * h * wd, cout,
              lambda bn, sp, ws: conv(x.data_ptr(), w.data_ptr(), None, 0, 0, None,
                                      out.data_ptr(), None if ws is None else ws.data_ptr(),
                                      b, h, wd, cin, cout, 0, None, None, 0, tile.tw, tile.th,
                                      tile.tb, bn, sp, stream))
    # the skinny kernel at each M = 2 shape of the steps: every slice width
    # and a range of K splits, device time a launch (profiler), through the
    # C entry, beside the plan skinny_plan picks
    skinny = build.function("st_linear_skinny", lin._SKINNY_ARGTYPES)
    for k, n in SKINNY_STEP_SHAPES:
        x = torch.randn((2, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((2, n), device=dev, dtype=torch.bfloat16)
        chosen = lin.skinny_plan(2, k, n, 2)
        plans = {chosen}
        for cols in (64, 32, 16):
            for want in (1, 2, 4, 6, 7, 8):
                rows = math.ceil(k / want)
                plans.add(lin.SkinnyPlan(cols, math.ceil(k / rows), rows))
        times = {}
        for plan in plans:
            dims = lin.SkinnyDims(2, n, k, 0, 1, 0, *plan)
            times[plan] = device_ms(lambda dims=dims: skinny(
                x.data_ptr(), w.data_ptr(), None, out.data_ptr(), stream,
                ctypes.addressof(dims)), 20)[0]
        best = min(times, key=times.get)
        log(f"plans skinny (2,{k})@({k},{n}): chosen cols={chosen.cols} split={chosen.splits} "
            f"{times[chosen] * 1e3:.2f} us, fastest cols={best.cols} split={best.splits} "
            f"{times[best] * 1e3:.2f} us (device, profiler); " + ", ".join(
                f"{p.cols}/{p.splits} {t * 1e3:.2f}" for p, t in sorted(times.items())))
    slower = sum(r > 1.05 for r in model_vs_rule)
    faster = sum(r < 1 / 1.05 for r in model_vs_rule)
    log(f"plans: the wave rule is more than 5% slower than the model's plan at {slower} of "
        f"{len(model_vs_rule)} shapes and more than 5% faster at {faster} (rule/model "
        f"{min(model_vs_rule):.2f}-{max(model_vs_rule):.2f})")
    torch.cuda.empty_cache()


# the shapes whose host time a launch ``--host-time`` reads: bf16 GEMMs and
# convs the wgmma kernels take, with and without a K split
HOST_GEMMS = [(8192, 640, 1920), (2048, 5120, 1280), (154, 2048, 2560), (128, 1280, 1280)]
HOST_CONVS = [(2, 128, 128, 320, 320), (2, 32, 32, 1280, 1280), (2, 8, 8, 1280, 1280)]
HOST_NORMS = [(2, 128, 128, 320), (2, 32, 32, 1280)]  # GroupNorm, and GN + SiLU + conv
# the skinny linear's (M = 2, bias) and LayerNorm's (bf16, affine) shapes of the
# SDXL step, each beside the one PyTorch call computing the same function
HOST_SKINNY = [(2, 1280, 1280), (2, 2816, 1280)]
HOST_LAYER_NORMS = [(8192, 640), (2048, 1280)]
# the attention wrapper's cross-attention against the fused KV buffer: SDXL's
# K1 (h = 10, d = 64) and SD1.5's K5 (h = 8, d = 40), as (B, Sq, Sk, C, H)
HOST_ATTENTION = [(2, 4096, 77, 640, 10), (2, 4096, 77, 320, 8)]
# the timestep embedding's two launches of a SDXL step, (B,) -> (B, dim), and
# dropout's shape, whose device time a call is printed too
HOST_TIME_EMBED = [(2, 320), (12, 256)]
HOST_DROPOUT = [((2, 4096, 640), torch.bfloat16), ((2, 4096, 640), torch.float32)]
HOST_ROUNDS = 7


def host_us(fn, calls: int = 100) -> float:
    """Mean host time (us) of one fn() call: ``calls`` calls queued back to
    back after a synchronisation, timed on the host clock before the device
    catches up (their launches stay inside CUDA's launch queue)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def skinny_entry(lin, x, w, b, out, stream):
    """The bare C entry of the skinny linear kernel of the package ``lin``
    at its planned launch, as a call: st_linear_skinny where the package
    has it, else st_linear's skinny variant (the trees before it)."""
    from stabletriton_tpu_torch.kernels import build

    (m, k), n = x.shape, w.shape[1]
    if hasattr(lin, "skinny_plan"):
        fn = build.function("st_linear_skinny", lin._SKINNY_ARGTYPES)
        dims = lin.SkinnyDims(m, n, k, 0, 1, 1, *lin.skinny_plan(m, k, n, x.element_size()))
        return lambda: fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(), stream,
                          ctypes.addressof(dims))
    fn = build.function("st_linear", lin._LINEAR_ARGTYPES)
    return lambda: fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), 1, out.data_ptr(), m, n, k, 0,
                      1, 2, stream)


def time_embed_entry(te, t, out, dim, stream):
    """The bare C entry of the timestep embedding of the package ``te`` on
    SDXL's arguments, as a call: st_time_embed with its TeDims where the
    package has them, else its seven scalar arguments (the trees before)."""
    from stabletriton_tpu_torch.kernels import build

    b, half = t.shape[0], dim // 2
    coef = float(torch.tensor(-math.log(10000.0) / half, dtype=torch.float32))
    fn = build.function("st_time_embed", te._TIME_EMBED_ARGTYPES)
    if hasattr(te, "TeDims"):
        dims = te.TeDims(b, half, coef, 1, *te.grid(b * dim))
        return lambda: fn(t.data_ptr(), out.data_ptr(), stream, ctypes.addressof(dims))
    return lambda: fn(t.data_ptr(), out.data_ptr(), b, half, coef, 1, stream)


def phase_host_time(dev):
    """``--host-time [DIR]``: the host time a launch of the package in DIR
    (default: this checkout), for each shape above: the public wrapper
    (linear, conv3x3, group_norm, layer_norm), linear's internal launch on
    the wgmma route and on the WMMA route, the kernels' bare C entries (the
    wgmma kernels at the planned plan, the skinny linear, LayerNorm), the
    fused GN conv's whole op (gn_conv2d_fused: the GroupNorm stats and fold,
    then the conv), the attention wrapper against a fused KV buffer, the
    timestep embedding's wrapper and C entry (K12, both SDXL shapes) and
    dropout's wrapper (K14), and for the skinny linear, LayerNorm and
    attention the one PyTorch call computing the same function (torch.addmm,
    F.layer_norm, SDPA). The host is shared, so each is measured in
    HOST_ROUNDS interleaved rounds and printed as its least and its median
    round. The skinny linear, LayerNorm and dropout rows also print the
    device time a call of the wrapper and of the PyTorch call
    (torch.profiler, kernels only). Run it on two trees in one call to
    compare them."""
    import statistics

    import torch.nn.functional as F

    from stabletriton_tpu_torch.kernels import build
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import dropout as dr
    from stabletriton_tpu_torch.kernels import flash_attention as fa
    from stabletriton_tpu_torch.kernels import group_norm as gn
    from stabletriton_tpu_torch.kernels import layer_norm as ln
    from stabletriton_tpu_torch.kernels import linear as lin
    from stabletriton_tpu_torch.kernels import time_embed as te
    from stabletriton_tpu_torch.kernels import wgmma_plan as wp

    gen = torch.Generator(device=dev).manual_seed(77)
    stream = torch.cuda.current_stream(dev).cuda_stream
    gemm = build.function("st_linear_wgmma", lin._WGMMA_ARGTYPES)
    conv = build.function("st_conv3x3_wgmma", cd._WGMMA_ARGTYPES)
    cases = []  # (label, {what: fn})
    for m, k, n in HOST_GEMMS:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        b = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
        plan = wp.gemm_plan(m, k, n)
        ws = torch.empty((plan.splits, m, n), device=dev)
        cases.append((f"gemm ({m},{k})@({k},{n})+b bn={plan.bn} split={plan.splits}", {
            "wrapper": lambda x=x, w=w, b=b: lin.linear(x, w, b),
            "wgmma route": lambda x=x, w=w, b=b: lin._launch(x, w, b, None, "wgmma_bf16"),
            "WMMA route": lambda x=x, w=w, b=b: lin._launch(x, w, b, None, "wmma_bf16"),
            "wgmma C entry": lambda x=x, w=w, b=b, out=out, ws=ws, m=m, k=k, n=n, plan=plan:
                gemm(x.data_ptr(), w.data_ptr(), b.data_ptr(), 1, out.data_ptr(), ws.data_ptr(),
                     m, n, k, 0, plan.bn, plan.splits, stream)}))
    for bsz, h, wd, cin, cout in HOST_CONVS:
        x = torch.randn((bsz, h, wd, cin), generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((3, 3, cin, cout), generator=gen, device=dev).to(torch.bfloat16)
        bias = torch.randn((bsz, cout), generator=gen, device=dev)
        out = torch.empty((bsz, h, wd, cout), device=dev, dtype=torch.bfloat16)
        tile, plan = wp.conv_plan(bsz, h, wd, cin, cout)
        ws = torch.empty((plan.splits, bsz * h * wd, cout), device=dev)
        cases.append((f"conv {bsz}x{h}x{wd} {cin}->{cout} bn={plan.bn} split={plan.splits}", {
            "wrapper": lambda x=x, w=w, bias=bias: cd.conv3x3(x, w, bias, act="silu"),
            "wgmma C entry": lambda x=x, w=w, bias=bias, out=out, ws=ws, s=(bsz, h, wd, cin, cout),
                tile=tile, plan=plan:
                conv(x.data_ptr(), w.data_ptr(), bias.data_ptr(), 0, s[4], None, out.data_ptr(),
                     ws.data_ptr(), *s, 1, None, None, 0, tile.tw, tile.th, tile.tb, plan.bn,
                     plan.splits, stream)}))
    for bsz, h, wd, c in HOST_NORMS:
        x = torch.randn((bsz, h, wd, c), generator=gen, device=dev).to(torch.bfloat16)
        g = torch.randn(c, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn((3, 3, c, c), generator=gen, device=dev).to(torch.bfloat16)
        cases.append((f"group norm {bsz}x{h}x{wd}x{c} g=32 +silu", {
            "K9 wrapper": lambda x=x, g=g: gn.group_norm(x, g, g, num_groups=32, act="silu"),
            "gn_conv2d_fused op": lambda x=x, g=g, w=w: cd.gn_conv2d_fused(
                x, g, g, w, g, num_groups=32, gn_act="silu")}))
    devices = []  # (label, {what: fn}) whose device time a call is printed too
    for m, k, n in HOST_SKINNY:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device=dev) / math.sqrt(k)).to(torch.bfloat16)
        b = torch.randn(n, generator=gen, device=dev).to(torch.bfloat16)
        out = torch.empty((m, n), device=dev, dtype=torch.bfloat16)
        fns = {"wrapper": lambda x=x, w=w, b=b: lin.linear(x, w, b),
               "C entry": skinny_entry(lin, x, w, b, out, stream),
               "torch.addmm": lambda x=x, w=w, b=b: torch.addmm(b, x, w)}
        cases.append((f"skinny linear ({m},{k})@({k},{n})+b", fns))
        devices.append(cases[-1])
    ln_entry = build.function("st_layer_norm", ln._LN_ARGTYPES)
    for rows, c in HOST_LAYER_NORMS:
        x = torch.randn((rows, c), generator=gen, device=dev).to(torch.bfloat16)
        g, b = (torch.randn(c, generator=gen, device=dev).to(torch.bfloat16) for _ in range(2))
        out = torch.empty_like(x)
        if hasattr(ln, "LnDims"):  # the entry with its integer arguments in one struct
            dims = ln.LnDims(1, 1, rows, c, 0, 1e-6)
            entry = (lambda x=x, g=g, b=b, out=out, dims=dims: ln_entry(
                x.data_ptr(), g.data_ptr(), b.data_ptr(), out.data_ptr(), stream,
                ctypes.addressof(dims)))
        else:
            entry = (lambda x=x, g=g, b=b, out=out, rows=rows, c=c: ln_entry(
                x.data_ptr(), g.data_ptr(), b.data_ptr(), 1, out.data_ptr(), rows, c, 1e-6, 0, 1,
                stream))
        fns = {"wrapper": lambda x=x, g=g, b=b: ln.layer_norm(x, g, b, eps=1e-6),
               "C entry": entry,
               "F.layer_norm": lambda x=x, g=g, b=b, c=c: F.layer_norm(x, (c,), g, b, 1e-6)}
        cases.append((f"layer norm ({rows},{c}) bf16", fns))
        devices.append(cases[-1])
    for bsz, sq, sk, c, h in HOST_ATTENTION:
        q = torch.randn((bsz, sq, c), generator=gen, device=dev).to(torch.bfloat16)
        kv = torch.randn((bsz, sk, 2 * c), generator=gen, device=dev).to(torch.bfloat16)
        qh, kh, vh = (t.reshape(bsz, -1, h, c // h).transpose(1, 2).contiguous()
                      for t in (q, *kv.chunk(2, -1)))
        cases.append((f"attention kv ({bsz},{sq},{c}) x ({bsz},{sk},{2 * c}) h={h}", {
            "wrapper": lambda q=q, kv=kv, h=h: fa.flash_attention_kv(q, kv, num_heads=h),
            "SDPA": lambda qh=qh, kh=kh, vh=vh: F.scaled_dot_product_attention(qh, kh, vh)}))
    for b, dim in HOST_TIME_EMBED:
        t = torch.full((b,), 999.0, device=dev)
        out = torch.empty((b, dim), device=dev)
        cases.append((f"time_embed ({b},)->({b},{dim})", {
            "wrapper": lambda t=t, dim=dim: te.time_embed(t, dim=dim),
            "C entry": time_embed_entry(te, t, out, dim, stream)}))
    for shape, dtype in HOST_DROPOUT:
        x = torch.randn(shape, generator=gen, device=dev).to(dtype)
        cases.append((f"dropout {shape} {dtype}", {
            "wrapper": lambda x=x: dr.dropout(x, 20260417, rate=0.1)}))
        devices.append(cases[-1])
    rounds = {(label, what): [] for label, fns in cases for what in fns}
    for _ in range(HOST_ROUNDS):
        for label, fns in cases:
            for what, fn in fns.items():
                rounds[(label, what)].append(host_us(fn))
    for label, fns in cases:
        log(f"host {label}: " + ", ".join(
            f"{what} {min(rounds[(label, what)]):.1f} "
            f"(median {statistics.median(rounds[(label, what)]):.1f})" for what in fns)
            + " us a launch")
    for label, fns in devices:
        log(f"device {label}: " + ", ".join(
            f"{what} {device_ms(fns[what], 50)[0] * 1e3:.2f}" for what in fns if what != "C entry")
            + " us a call")
    torch.cuda.empty_cache()


def make_unet_params(dev, cfg):
    from stabletriton_tpu_torch.models.unet import init_unet_params

    return init_unet_params(cfg, 0, device=dev, dtype=torch.bfloat16)


# launches of each opt-in kernel per UNet step under the all-kernel binding
# (the fused-op binding launches K8-K11 alone): resnets x 2 GN+SiLU+conv
# pairs + norm_out/conv_out (K8); one GroupNorm per Transformer2D (K9);
# transformer blocks x 3 LayerNorms (K10) and x 1 GEGLU (K11); the timestep
# embedding, and for SDXL the time_ids' (K12); every projection (K13):
# transformer blocks x 6 (to_qkv, to_q, two to_out, ff proj, ff out) +
# Transformer2D x 2 (proj_in, proj_out) + one time_emb_proj per resnet + the
# time MLP's 2 (+ the add embedding's 2 for SDXL). SDXL-base: 17 resnets, 11
# Transformer2D, 70 blocks. SD1.5: 22 resnets (4 levels x 2 down, 2 mid, 4 x 3
# up), 16 Transformer2D of one block each. The cross K/V precompute adds one
# K13 launch per block, once per generation.
ALL_PER_STEP = {"K8": 35, "K9": 11, "K10": 210, "K11": 70, "K12": 2, "K13": 463}
SD15_ALL_PER_STEP = {"K8": 45, "K9": 16, "K10": 48, "K11": 16, "K12": 1, "K13": 152}
FUSED_PER_STEP = {k: ALL_PER_STEP[k] for k in ("K8", "K9", "K10", "K11")}
PRECOMPUTE_LINEARS = 70
SD15_PRECOMPUTE_LINEARS = 16
VAE_LINEARS = 4  # the f32 VAE decoder's mid-attention q, k, v, out per image
# bf16 attention launches per UNet step by kernel and class, under either
# kernel binding. SDXL-base: self at 64^2 (h=10) 10 x K2 and at 32^2 (h=20)
# 60 x K1 on attn_wgmma_bf16, 70 cross (77 keys) x K1 on the tiny-KV kernel.
# SD1.5: self at 64^2 (d=40) 5 x K3, at 32^2 (d=80) and 16^2 (d=160) 10 x K4
# on attn_wgmma_bf16, mid self at 8^2 (d=160) 1 + 16 cross x K5 on the
# tiny-KV kernel.
ATTN_PER_STEP = {"wgmma_bf16": {"K1": 60, "K2": 10}, "tinykv_wgmma_bf16": {"K1": 70}}
SD15_ATTN_PER_STEP = {"wgmma_bf16": {"K3": 5, "K4": 10}, "tinykv_wgmma_bf16": {"K5": 17}}
# the kernels of one image's f32 VAE decode 3x3 convs (SDXL's and SD1.5's
# decoder alike): conv_in (Cin 4) on the direct kernel, the other 32 (mid
# and up resnets, upsamplers, conv_out) on the 3xTF32 wgmma kernel; its one
# mid-block attention on the 3xTF32 GEMM
DECODE_CONVS = {"wgmma_tf32x3": 32, "direct_f32": 1}
DECODE_ATTENTION = "wgmma_tf32x3"
# the kernels of a step's bf16 3x3 convs (K6 and K8 together): all on wgmma,
# conv_in (Cin 4, padded to 8) and conv_out (Cout 4, the 8-column tile)
# included. SDXL-base: conv_in, 34 resnet convs, 2 upsamplers, conv_out;
# SD1.5: conv_in, 44 + 3, conv_out
CONV_SPLIT = {"wgmma_bf16": 38}
SD15_CONV_SPLIT = {"wgmma_bf16": 49}
# the all-kernel step's K13 launches (precompute included) by kernel: M = 2
# on the skinny kernel (a time projection per resnet, the time MLP's 2, and
# for SDXL the add embedding's 2), every other GEMM on wgmma
LINEAR_SPLIT = {"wgmma_bf16": 512, "skinny_bf16": 21}
SD15_LINEAR_SPLIT = {"wgmma_bf16": 144, "skinny_bf16": 24}


def by_kernel(*counters) -> dict:
    """Launches summed by kernel, the first field of the launch keys."""
    out = {}
    for c in counters:
        for key, n in c.by_key.items():
            out[key.split()[0]] = out.get(key.split()[0], 0) + n
    return out


def kernel_counters():
    """Launch counters of K8-K13 (and K6, the plain conv kernel, and the
    attention kernels K1-K5)."""
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import flash_attention as fa
    from stabletriton_tpu_torch.kernels import geglu as gg
    from stabletriton_tpu_torch.kernels import group_norm as gn
    from stabletriton_tpu_torch.kernels import layer_norm as ln
    from stabletriton_tpu_torch.kernels import linear as lin
    from stabletriton_tpu_torch.kernels import time_embed as te

    return {"K8": cd.GN_LAUNCHES, "K9": gn.LAUNCHES, "K10": ln.LAUNCHES,
            "K11": gg.LAUNCHES, "K12": te.LAUNCHES, "K13": lin.LAUNCHES, "K6": cd.LAUNCHES,
            "attention": fa.LAUNCHES}


class LinearDispatches:
    """Counts the ``linear`` op's dispatches by backend while entered, by
    registering counting wrappers around its implementations (restored on
    exit): a linear that reached cuBLAS would show as a "reference" call."""

    def __init__(self):
        from stabletriton_tpu_torch import ops

        self.ops = ops
        self.impls = {}
        for bk in ops.registered_ops()["linear"]:
            with ops.use_backends(linear=bk):
                self.impls[bk] = ops.resolve("linear")
        self.calls = dict.fromkeys(self.impls, 0)

    def __enter__(self):
        for bk, fn in self.impls.items():
            def counting(*a, bk=bk, fn=fn, **kw):
                self.calls[bk] += 1
                return fn(*a, **kw)
            self.ops.register("linear", bk)(counting)
        return self

    def __exit__(self, *exc):
        for bk, fn in self.impls.items():
            self.ops.register("linear", bk)(fn)


def attention_by_class(by_key: dict, kernel: str = "") -> dict:
    """Attention launches summed by class (the key's first field), counting
    only keys of ``kernel`` (e.g. "wgmma_bf16") when it is given."""
    out = dict.fromkeys(("K1", "K2", "K3", "K4", "K5"), 0)
    for key, n in by_key.items():
        cls, name = key.split()[:2]
        if not kernel or name == kernel:
            out[cls] += n
    return out


def expected_attention(per_kernel: dict, steps: int = 1) -> dict:
    """The launches by class of each bf16 attention kernel of ``per_kernel``
    (ATTN_PER_STEP's form), times ``steps``, as attention_by_class gives them."""
    return {kernel: {**dict.fromkeys(("K1", "K2", "K3", "K4", "K5"), 0),
                     **{cls: n * steps for cls, n in by_class.items()}}
            for kernel, by_class in per_kernel.items()}


def check_bf16_attention(by_key: dict, per_kernel: dict, steps: int, label: str) -> None:
    """Every bf16 attention launch of a run on the kernel and under the class
    of ``per_kernel``: its per-step counts times the UNet steps run."""
    got = {kernel: attention_by_class(by_key, kernel) for kernel in per_kernel}
    want = expected_attention(per_kernel, steps)
    if got != want:
        raise AssertionError(f"{label}: bf16 attention launches by kernel {got} in {steps} "
                             f"steps, expected {want}")


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


def profile_step(run, label, *, unit="step", top=0):
    """Device time of two runs of ``run`` by kernel family, and the share of
    the device span in which no kernel ran (torch.profiler's CUDA kernel
    events; ``--profile`` only). Then the attention family by kernel name
    (the K5 launches' total among them), and with ``top`` the longest
    ``top`` kernels by name."""
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            run()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        raise AssertionError(f"{label}: the profiler saw no kernel on the device")
    families = {"wgmma conv": ("conv_wgmma", "conv_gn_wgmma"),
                "direct conv": ("conv_direct_f32",), "scalar conv": ("conv_scalar",),
                "wgmma linear": ("linear_wgmma",), "split-K reduce": ("splitk_reduce",),
                "skinny linear": ("linear_skinny",),
                "attention": ("attn_", "gemm_wgmma_tf32x3"),
                "GroupNorm/LayerNorm/GEGLU/time_embed": (
                    "gn_apply", "gn_stats", "gn_fold", "ln_rows", "geglu_kernel",
                    "time_embed_kernel"),
                "cuBLAS/cuDNN": ("gemm", "nvjet", "sm90_", "cutlass", "cudnn", "xmma", "conv2d")}
    by, counts, names, busy, end = {}, {}, {}, 0.0, spans[0][0]
    for t0, t1, name in spans:
        fam = next((f for f, keys in families.items() if any(k in name for k in keys)), "glue")
        by[fam] = by.get(fam, 0.0) + (t1 - t0) / 2e3
        counts[fam] = counts.get(fam, 0) + 1
        ms, n = names.get(name, (0.0, 0))
        names[name] = (ms + (t1 - t0) / 2e3, n + 1)
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    span = end - spans[0][0]
    total = sum(by.values())
    log(f"profile, {label} (2 {unit}s; ms a {unit} by kernel family, launches a {unit}): "
        + ", ".join(f"{f} {ms:.2f} ({counts[f] // 2})" for f, ms in sorted(
            by.items(), key=lambda kv: -kv[1]))
        + f"; kernel time {total:.1f} ms a {unit}, device span {span / 2e3:.1f} ms a "
          f"{unit}, idle {1 - busy / span:.1%}")

    def short(name):  # the kernel's name and template arguments, no namespace or parameters
        name = name.replace("(anonymous namespace)::", "").replace("void ", "")
        return name.split("(")[0][:90]

    attn = sorted(((n, v) for n, v in names.items() if any(
        k in n for k in families["attention"])), key=lambda kv: -kv[1][0])
    if attn:
        log(f"  attention by kernel, {label} (ms a {unit}, launches a {unit}): " + ", ".join(
            f"{short(n)} {ms:.4f} ({c // 2})" for n, (ms, c) in attn))
    if top:
        log(f"  top {top} kernels, {label} (ms a {unit}, launches a {unit}, share of kernel "
            f"time): " + ", ".join(
                f"{short(n)} {ms:.3f} ({c // 2}, {ms / total:.1%})" for n, (ms, c) in sorted(
                    names.items(), key=lambda kv: -kv[1][0])[:top]))


def phase_step_deviation(dev, cfg, params, inputs, all_per_step, precompute_linears,
                         attn_per_step, conv_split, linear_split, label, profile=False):
    """One full-width UNet step (cross K/V precompute included) under the
    default, the fused-op and the all-kernel binding, each against the
    reference binding, with the per-step launch counts of the attention
    classes and of K8-K13, and the convs' split over the wgmma and WMMA
    kernels (``conv_split``). Under the all-kernel binding every linear
    dispatch must reach the "cuda" backend and launch K13, its launches
    split over the kernels as ``linear_split``, and the precompute alone
    must launch ``precompute_linears``."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import (
        ALL_KERNEL_OVERRIDES, FUSED_OP_OVERRIDES, CompileConfig, fuse_attention_projections,
        resolve_binding)
    from stabletriton_tpu_torch.kernels import flash_attention as fa
    from stabletriton_tpu_torch.models.unet import precompute_cross_kv, unet_apply

    sample, ctx, pooled, time_ids = (inputs[k] for k in ("sample", "ctx", "pooled", "time_ids"))
    t = torch.full((2,), 500.0, device=dev)
    fused = fuse_attention_projections(params)
    bindings = {"default": resolve_binding(CompileConfig()),
                "fused_ops": resolve_binding(CompileConfig(overrides=FUSED_OP_OVERRIDES)),
                "all_kernels": resolve_binding(CompileConfig(overrides=ALL_KERNEL_OVERRIDES))}
    reference = resolve_binding(CompileConfig(backend="reference"))
    zero = dict.fromkeys(all_per_step, 0)
    expect = {"default": zero,
              "fused_ops": {**zero, **{k: all_per_step[k] for k in FUSED_PER_STEP}},
              "all_kernels": {**all_per_step, "K13": all_per_step["K13"] + precompute_linears}}

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
    counters = kernel_counters()
    result = {}
    lat = sample.shape[1]
    with torch.inference_mode():
        out_r = run_reference().float()
        for name in bindings:
            for c in counters.values():
                c.reset()
            with LinearDispatches() as linear_calls:
                out_k = runs[name]().float()
                torch.cuda.synchronize()
            counts = {k: c.count for k, c in counters.items() if k != "attention"}
            convs = by_kernel(counters["K6"], counters["K8"])
            linears = by_kernel(counters["K13"])
            attn = attention_by_class(fa.LAUNCHES.by_key)
            if not (torch.isfinite(out_k).all() and torch.isfinite(out_r).all()):
                raise AssertionError(f"{label} UNet step output is not finite ({name} binding)")
            mse = (out_k - out_r).square().mean().item()
            mx = (out_k - out_r).abs().max().item()
            log(f"step deviation, {label}, {name} binding vs reference: UNet {lat}x{lat} "
                f"latent, CFG batch 2, bf16: mse={mse:.3e} max_abs={mx:.3e} (gate "
                f"mse<{STEP_MSE_GATE:g}); output rms {out_r.square().mean().sqrt().item():.4f}; "
                f"launches in one step (precompute included) {json.dumps(counts)}, attention "
                f"{json.dumps(attn)}, linear dispatches {json.dumps(linear_calls.calls)}; "
                f"convs by kernel {json.dumps(convs)}, linears by kernel {json.dumps(linears)}")
            if not mse < STEP_MSE_GATE:
                raise AssertionError(f"{label} {name} step deviation mse {mse:.3e} exceeds "
                                     f"{STEP_MSE_GATE:g}")
            want_attn = {cls: sum(by_kernel[cls] for by_kernel in expected_attention(
                attn_per_step).values()) for cls in attn}
            if attn != want_attn:
                raise AssertionError(f"{label} {name}: attention launches {attn} in one step, "
                                     f"expected {want_attn}")
            check_bf16_attention(fa.LAUNCHES.by_key, attn_per_step, 1, f"{label} {name}")
            got = {k: counts[k] for k in expect[name]}
            if got != expect[name]:
                raise AssertionError(f"{label} {name}: launches {got} in one step, expected "
                                     f"{expect[name]}")
            if name == "all_kernels" and (linear_calls.calls.get("reference", 0)
                                          or linear_calls.calls["cuda"] != counts["K13"]):
                raise AssertionError(f"{label} all-kernel step: linear dispatches "
                                     f"{linear_calls.calls}, K13 launches {counts['K13']}")
            if convs != conv_split:
                raise AssertionError(f"{label} {name}: convs by kernel {convs}, expected "
                                     f"{conv_split}")
            if name == "all_kernels" and linears != linear_split:
                raise AssertionError(f"{label} all-kernel step: K13 by kernel {linears}, "
                                     f"expected {linear_split}")
            result[name] = {"mse": mse, "max_abs": mx, "launches": counts, "attention": attn,
                            "convs": convs, "linears": linears}
        counters["K13"].reset()
        with ops.use_backends(bindings["all_kernels"]):
            precompute_cross_kv(cfg, fused, ctx)
        if counters["K13"].count != precompute_linears:
            raise AssertionError(f"{label}: the cross K/V precompute launched K13 "
                                 f"{counters['K13'].count} times, expected {precompute_linears}")
        torch.cuda.synchronize()
        times = {}
        for name in ("reference", "default", "fused_ops", "all_kernels", "all_kernels",
                     "fused_ops", "default", "reference"):
            t0 = time.perf_counter()
            runs[name]()
            torch.cuda.synchronize()
            times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
        if profile:
            for name in ("default", "fused_ops", "all_kernels"):
                profile_step(runs[name], f"{label} {name} binding")
    log(f"step time, {label} (host clock around a synchronised step, cross K/V precompute "
        f"included, ms, two runs each): "
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


SERVE_STEPS = 4  # Euler steps of every served request


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
    kw = dict(height=size, width=size, steps=SERVE_STEPS, guidance_scale=guidance,
              solver="euler")
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


def check_decode_convs(conv_by_key: dict, images: int, label: str) -> None:
    """Each image's f32 decode launched its 3x3 convs on the kernels of
    DECODE_CONVS (the UNet's convs are bf16 and named otherwise)."""
    got = {k: sum(n for key, n in conv_by_key.items() if key.split()[0] == k)
           for k in DECODE_CONVS}
    want = {k: n * images for k, n in DECODE_CONVS.items()}
    log(f"{label}: f32 decode convs by kernel {json.dumps(got)} for {images} images")
    if got != want:
        raise AssertionError(f"{label}: f32 decode convs {got}, expected {want}")


def check_decode_attention(attn_by_key: dict, images: int, label: str) -> None:
    """Each image's f32 decode ran its mid-block attention (K3, h=1, d=512)
    once, on the 3xTF32 GEMM."""
    got = attention_by_class(attn_by_key, DECODE_ATTENTION)
    want = {**dict.fromkeys(got, 0), "K3": images}
    log(f"{label}: f32 attention on {DECODE_ATTENTION} {json.dumps(got)} for {images} images")
    if got != want:
        raise AssertionError(f"{label}: f32 attention on {DECODE_ATTENTION} {got}, expected "
                             f"{want}")


def unet_steps(conv_by_key: dict, ucfg, kernel: str) -> int:
    """UNet steps run, from the conv_out launches (one conv with Cout = 4
    per step) of the given conv kernel counter's keys."""
    return sum(n for key, n in conv_by_key.items() if key.startswith(kernel)
               and key.split("->")[1].split()[0] == str(ucfg.out_channels))


# The same seed alone (bucket 1) and co-batched (bucket 2) gives images up to
# ~0.12-0.16 apart (max abs, images in [-1, 1]) under every binding, the
# reference one (cuBLAS, cuDNN, SDPA; no kernel of the port) included: the
# kernels' plans and cuBLAS's algorithms depend on M, and 4 bf16 Euler steps
# through random full-width weights amplify a rounding apart (H100, see
# ROADMAP C2). A binding must stay under SOLO_VS_BATCHED_BOUND, about twice
# the largest measured, and a kernel binding within SOLO_VS_BATCHED_RATIO of
# the reference binding's diff on the same requests: more would be the
# kernels' own doing.
SOLO_VS_BATCHED_BOUND = 0.3
SOLO_VS_BATCHED_RATIO = 2.0


def solo_vs_batched(done, label: str) -> float:
    """Max abs diff of request 0 (co-batched) and request 2 (the same seed
    alone)."""
    diff = float(np.abs(done[0][0] - done[2][0]).max())
    log(f"same seed, batched (bucket 2) vs solo (bucket 1), {label} binding: max abs diff "
        f"{diff:.3e}")
    return diff


def phase_serving_reference(dev, ucfg, unet_params, other):
    """Phase 5e: the reference binding (no kernel of the port: cuBLAS,
    cuDNN, SDPA) serves two co-batched requests and the first one's seed
    alone, to set the kernel bindings' solo-vs-batched diffs beside it."""
    from stabletriton_tpu_torch.compile import CompileConfig

    done, _, _ = serve(dev, ucfg, unet_params, other, CompileConfig(backend="reference"),
                       counters={}, prompts=[("a lighthouse at dusk", 11), ("a bowl of ramen", 12)],
                       solo=("a lighthouse at dusk", 11))
    return solo_vs_batched(done, "reference")


def check_solo_vs_batched(diffs: dict, label: str) -> None:
    """Each binding's solo-vs-batched diff under the bound, and, where the
    reference binding ran the same requests, within the ratio of its diff."""
    log(f"{label} solo vs batched max abs diff by binding: {json.dumps(diffs)} (bound "
        f"{SOLO_VS_BATCHED_BOUND:g}, {SOLO_VS_BATCHED_RATIO:g}x the reference binding's)")
    for name, diff in diffs.items():
        ref = diffs.get("reference")
        if not diff <= SOLO_VS_BATCHED_BOUND or (
                ref is not None and not diff <= SOLO_VS_BATCHED_RATIO * ref):
            raise AssertionError(f"{label} {name} binding: the same seed alone and co-batched "
                                 f"differs by {diff:.3e} (reference binding {ref})")


def phase_decode_deviation(dev, vcfg, vae_params, profile=False):
    """One 1024^2 f32 decode (random latents from a seed) under the default
    binding (the tf32 conv, the f32 attention, linear and GroupNorm paths)
    against the reference binding's (cuDNN and cuBLAS with TF32 off), each
    timed on the host clock around a synchronised decode; with ``profile``
    the default binding's decode by kernel."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import CompileConfig, resolve_binding
    from stabletriton_tpu_torch.runtime.pipeline import _decode_images

    gen = torch.Generator(device=dev).manual_seed(9)
    lat = torch.randn((1, 128, 128, 4), generator=gen, device=dev)
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    images, times = {}, {}
    try:
        with torch.inference_mode():
            for name in ("reference", "default", "default", "reference"):
                with ops.use_backends(resolve_binding(CompileConfig(
                        **({"backend": "reference"} if name == "reference" else {})))):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    images[name] = _decode_images(vcfg, vae_params, lat).float()
                    torch.cuda.synchronize()
                    times.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)
            if profile:
                with ops.use_backends(resolve_binding(CompileConfig())):
                    profile_step(lambda: _decode_images(vcfg, vae_params, lat),
                                 "1024^2 f32 decode, default binding", unit="decode", top=12)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    got, ref = images["default"], images["reference"]
    if got.shape != (1, 1024, 1024, 3) or not torch.isfinite(got).all():
        raise AssertionError(f"decode: {tuple(got.shape)}, finite {bool(torch.isfinite(got).all())}")
    max_abs = (got - ref).abs().max().item()
    log(f"decode deviation, 1024^2 f32, default binding vs reference binding (TF32 off): "
        f"max_abs={max_abs:.3e} (limit {DECODE_MAX_ABS:g}) "
        f"mse={(got - ref).square().mean().item():.3e}; image rms "
        f"{ref.square().mean().sqrt().item():.4f}; decode ms (host clock, two runs each): "
        + ", ".join(f"{k}={v[0]:.1f}/{v[1]:.1f}" for k, v in times.items()))
    if not max_abs <= DECODE_MAX_ABS:
        raise AssertionError(f"decode: max abs {max_abs:.3e} against the reference binding "
                             f"exceeds {DECODE_MAX_ABS:g}")


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
    diff = solo_vs_batched(done, "default")
    for name, n in counts.items():
        if n == 0:
            raise AssertionError(f"{name}: no launch during the serving run")
    attn = attention_by_class(by_key["flash_attention"])
    for k in ("K1", "K2", "K3"):
        if attn[k] == 0:
            raise AssertionError(f"no attention launch of class {k} during serving")
    steps = unet_steps(by_key["conv3x3"], ucfg, "wgmma_bf16")
    check_bf16_attention(by_key["flash_attention"], ATTN_PER_STEP, steps,
                         "default-binding serving")
    check_decode_convs(by_key["conv3x3"], len(done), "default-binding serving")
    check_decode_attention(by_key["flash_attention"], len(done), "default-binding serving")
    return by_key, diff


def phase_serving_fused(dev, ucfg, unet_params, other):
    """Phase 5b: the fused-op binding, two co-batched requests and the first
    one's seed alone. Every K8-K11 launch count must be its per-step count
    times the UNet steps run, which the conv_out launches (one K8 launch with
    Cout = 4 per step) give; K9 also runs each f32 VAE decoder GroupNorm once
    per image."""
    from stabletriton_tpu_torch.compile import FUSED_OP_OVERRIDES, CompileConfig

    counters = kernel_counters()
    done, counts, by_key = serve(
        dev, ucfg, unet_params, other, CompileConfig(overrides=FUSED_OP_OVERRIDES),
        counters=counters, prompts=[("a red fox in snow", 21), ("a glass teapot", 22)],
        solo=("a red fox in snow", 21))
    diff = solo_vs_batched(done, "fused-op")
    steps = unet_steps(by_key["K8"], ucfg, "wgmma_bf16")
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
    check_bf16_attention(by_key["attention"], ATTN_PER_STEP, steps, "fused-op serving")
    check_decode_convs(by_key["K6"], len(done), "fused-op serving")
    check_decode_attention(by_key["attention"], len(done), "fused-op serving")
    return counts, by_key, diff


def phase_serving_all(dev, ucfg, unet_params, other):
    """Phase 5d: the all-kernel binding, two co-batched requests and the
    first one's seed alone. K8-K11 as in phase 5b; K12 must launch its
    per-step count times the UNet steps run; K13 its per-step count times the
    steps, plus the cross K/V precompute once per generation (a generation
    runs SERVE_STEPS steps) and the f32 VAE decoder's mid-attention
    projections once per image."""
    from stabletriton_tpu_torch.compile import ALL_KERNEL_OVERRIDES, CompileConfig

    counters = kernel_counters()
    done, counts, by_key = serve(
        dev, ucfg, unet_params, other, CompileConfig(overrides=ALL_KERNEL_OVERRIDES),
        counters=counters, prompts=[("a paper boat on a pond", 41), ("a clock tower", 42)],
        solo=("a paper boat on a pond", 41))
    diff = solo_vs_batched(done, "all-kernel")
    steps = unet_steps(by_key["K8"], ucfg, "wgmma_bf16")
    gens, images = steps // SERVE_STEPS, len(done)
    vae_norms = sum(1 for k in other[1]["vae"] if k.endswith(
        ("norm1.weight", "norm2.weight", "group_norm.weight", "conv_norm_out.weight")))
    want = {k: n * steps for k, n in ALL_PER_STEP.items()}
    want["K9"] += vae_norms * images
    want["K13"] += PRECOMPUTE_LINEARS * gens + VAE_LINEARS * images
    # the precompute's GEMMs are the only ones over the 2048-wide context
    precompute = sum(n for key, n in by_key["K13"].items() if " k=2048 " in key)
    vae = sum(n for key, n in by_key["K13"].items() if key.startswith("wgmma_tf32x3 "))
    log(f"all-kernel serving: {steps} UNet steps, {gens} generations, {images} images; "
        f"K13 precompute launches {precompute}, VAE launches {vae}")
    if steps == 0 or steps % SERVE_STEPS:
        raise AssertionError(f"all-kernel serving ran {steps} UNet steps")
    for k, n in want.items():
        if counts[k] != n:
            raise AssertionError(f"{k}: {counts[k]} launches during all-kernel serving, "
                                 f"expected {n}")
    if precompute != PRECOMPUTE_LINEARS * gens or vae != VAE_LINEARS * images:
        raise AssertionError(f"K13: {precompute} precompute and {vae} VAE launches, expected "
                             f"{PRECOMPUTE_LINEARS * gens} and {VAE_LINEARS * images}")
    check_bf16_attention(by_key["attention"], ATTN_PER_STEP, steps, "all-kernel serving")
    check_decode_convs(by_key["K6"], images, "all-kernel serving")
    check_decode_attention(by_key["attention"], images, "all-kernel serving")
    return counts, by_key, diff


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
    check_solo_vs_batched({"default": solo_vs_batched(done, "SD1.5 default")}, "SD1.5")
    steps = unet_steps(by_key["conv3x3"], ucfg, "wgmma_bf16")
    log(f"SD1.5 serving: {steps} UNet steps, {len(done)} images")
    if steps == 0:
        raise AssertionError("SD1.5 serving: no UNet step ran")
    check_bf16_attention(by_key["flash_attention"], SD15_ATTN_PER_STEP, steps, "SD1.5 serving")
    check_decode_convs(by_key["conv3x3"], len(done), "SD1.5 serving")
    check_decode_attention(by_key["flash_attention"], len(done), "SD1.5 serving")
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
    "K12": "stabletriton_tpu/kernels/time_embed.py:23",
    "K13": "stabletriton_tpu/kernels/linear.py:29",
    "K14": "stabletriton_tpu/kernels/dropout.py:25",
}


def with_peak(label, fn, *args, **kwargs):
    """fn(*args, **kwargs), logging the peak device memory it allocated."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn(*args, **kwargs)
    torch.cuda.synchronize()
    log(f"peak device memory, {label}: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return out


def free(*objs):
    """Drop the caller's last references (passed in a container) and
    return the device memory they held to the card."""
    for o in objs:
        o.clear()
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    args = sys.argv[1:]
    profile = "--profile" in args
    host_time = "--host-time" in args
    if host_time:
        at = args.index("--host-time") + 1
        if at < len(args) and not args[at].startswith("--"):
            sys.path.insert(0, os.path.abspath(args[at]))
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
    if host_time:
        log(f"package: {os.path.dirname(os.path.dirname(os.path.abspath(build.__file__)))}")
    from stabletriton_tpu_torch.models.unet import sd15_unet_config, sdxl_base_unet_config

    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.2f} s ({build.build_info})")
    if "log" in build.build_info:
        # registers and spills of the wgmma kernels, and every warning
        entry = ""
        for line in open(build.build_info["log"]).read().splitlines():
            if "Compiling entry" in line:
                entry = line.split("'")[1] if "'" in line else line
            elif "warning" in line.lower() or ("wgmma" in entry and (
                    "registers" in line or "spill" in line)):
                log(f"  ptxas {entry[:90]}: {line.strip()}")

    if host_time:
        phase_host_time(dev)
        return 0
    if "--plans" in args:
        phase_plans(dev)
    kernel_results = (with_peak("phase 3", phase_kernels, dev)
                      + with_peak("phase 3b", phase_fused_kernels, dev)
                      + with_peak("phase 3c", phase_sd15_attention, dev))
    with_peak("phase 3e", phase_c4, dev)
    kernel_results += with_peak("phase 3d", phase_optional_kernels, dev)

    # SDXL-base at 1024^2: phases 4, 4b, 4d, 5, 5b, 5d
    ucfg = sdxl_base_unet_config()
    sdxl = {"unet": make_unet_params(dev, ucfg)}
    with_peak("phases 4, 4b, 4d (weights included)", phase_step_deviation, dev, ucfg,
              sdxl["unet"], sdxl_step_inputs(dev), ALL_PER_STEP, PRECOMPUTE_LINEARS,
              ATTN_PER_STEP, CONV_SPLIT, LINEAR_SPLIT, "SDXL-base", profile)
    sdxl["other"] = make_other_params(dev)
    diffs = {}
    by_key, diffs["default"] = with_peak("phase 5", phase_serving, dev, ucfg, sdxl["unet"],
                                         sdxl["other"])
    fused_counts, fused_by_key, diffs["fused-op"] = with_peak(
        "phase 5b", phase_serving_fused, dev, ucfg, sdxl["unet"], sdxl["other"])
    all_counts, all_by_key, diffs["all-kernel"] = with_peak(
        "phase 5d", phase_serving_all, dev, ucfg, sdxl["unet"], sdxl["other"])
    diffs["reference"] = with_peak("phase 5e serving", phase_serving_reference, dev, ucfg,
                                   sdxl["unet"], sdxl["other"])
    check_solo_vs_batched(diffs, "SDXL-base")
    with_peak("phase 5e decode", phase_decode_deviation, dev, sdxl["other"][0][2],
              sdxl["other"][1]["vae"], profile)
    free(sdxl)

    # SD1.5 at 512^2: phases 4c (default, fused-op and all-kernel), 5c
    ucfg = sd15_unet_config()
    sd15 = {"unet": make_unet_params(dev, ucfg)}
    with_peak("phase 4c (weights included)", phase_step_deviation, dev, ucfg, sd15["unet"],
              sd15_step_inputs(dev), SD15_ALL_PER_STEP, SD15_PRECOMPUTE_LINEARS,
              SD15_ATTN_PER_STEP, SD15_CONV_SPLIT, SD15_LINEAR_SPLIT, "SD1.5", profile)
    sd15["other"] = make_sd15_other_params(dev)
    sd15_by_key = with_peak("phase 5c", phase_serving_sd15, dev, ucfg, sd15["unet"],
                            sd15["other"])
    free(sd15)

    # launches of each kernel on its path: the serving phases (5, 5b, 5c,
    # 5d), by the first two fields of its launch key ("K3 wgmma_tf32x3") for
    # attention and by the first (the kernel: "wgmma_bf16", "wgmma_tf32x3",
    # "scalar", "skinny_bf16" ...) for the conv (K6, K8) and K13; K14's op
    # dispatch in phase 3d
    attention = [*by_key["flash_attention"].items(), *sd15_by_key["flash_attention"].items()]
    conv = [*by_key["conv3x3"].items(), *sd15_by_key["conv3x3"].items()]

    def launches(r):
        if r["tpu"] == "K6":
            return sum(n for key, n in conv if key.startswith(r["kernel"] + " "))
        if r["tpu"] == "K8":
            return sum(n for key, n in fused_by_key["K8"].items()
                       if key.startswith(r["kernel"] + " "))
        if r["tpu"] == "K12":
            return all_counts["K12"]
        if r["tpu"] == "K13":
            # the skinny kernel's launches by (K, N) (each of the step's
            # skinny GEMMs has its row; M is 2 alone, 4 co-batched); the
            # other kernels' in all
            _, k, n = r["shape"]
            shape = f" k={k} n={n} " if r["kernel"].startswith("skinny") else ""
            return sum(c for key, c in all_by_key["K13"].items()
                       if key.startswith(r["kernel"] + " ") and shape in key)
        if r["tpu"] == "K14":
            return r["launches"]
        if r["tpu"] in FUSED_PER_STEP:
            return fused_counts[r["tpu"]]
        return sum(n for key, n in attention if key.startswith(r["kernel"] + " "))

    kernels = [{
        "name": r["name"] + (f" [{r['kernel']}]" if r.get("kernel") else ""), "route": "cuda",
        "source": r["source"], "replaces": REPLACES[r["tpu"]], "launches": launches(r),
        "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        **{k: r[k] for k in ("old_ms", "old_kernel", "old_device_ms", "bound_f32_fma_ms",
                             "prep_ms", "device_ms", "library_device_ms", "alt_device_ms",
                             "tf32_padded_device_ms", "launch_floor_ms",
                             "cold_device_ms") if k in r},
    } for r in kernel_results]
    for k in kernels:
        if k["launches"] == 0:
            raise AssertionError(f"{k['name']}: no launch of its kernel on its path")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
