"""Reference (plain PyTorch) implementations of the ops the slice dispatches.

Counterpart of ``stabletriton_tpu/ops/reference.py``; the port's tests hold
each op here against the JAX op on the same numpy inputs. Layouts are the JAX
package's, so weights carry over unchanged:

  * images are NHWC;
  * conv weights are HWIO;
  * linear weights are (in, out);
  * norms and softmax take their moments in float32 whatever the input dtype.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from stabletriton_tpu_torch.ops.registry import dispatch, register

_ACTIVATIONS = {
    None: lambda x: x,
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="none"),
}


def apply_activation(x: torch.Tensor, act: str | None) -> torch.Tensor:
    try:
        return _ACTIVATIONS[act](x)
    except KeyError:
        raise ValueError(f"unknown activation {act!r}; known: {list(_ACTIVATIONS)}")


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@register("attention", "reference")
def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              num_heads: int = 1, scale: float | None = None) -> torch.Tensor:
    """Multi-head scaled dot-product attention, non-causal.

    q: (B, Sq, H*D); k, v: (B, Sk, H*D), channel-packed heads. Logits and
    softmax in float32, max-subtracted. Returns (B, Sq, H*D) in q's dtype.
    """
    b, sq, c = q.shape
    sk = k.shape[1]
    d = c // num_heads
    if scale is None:
        scale = 1.0 / math.sqrt(d)

    def split(x, s):
        return x.reshape(b, s, num_heads, d).transpose(1, 2)

    qh, kh, vh = split(q, sq), split(k, sk), split(v, sk)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    weights = torch.softmax(logits, dim=-1)
    out = torch.matmul(weights.to(v.dtype).float(), vh.float()).to(q.dtype)
    return out.transpose(1, 2).reshape(b, sq, c)


@register("attention_qkv", "reference")
def attention_qkv(qkv: torch.Tensor, *, num_heads: int = 1,
                  scale: float | None = None) -> torch.Tensor:
    """Self-attention over the fused QKV projection output (B, S, 3*H*D)."""
    q, k, v = qkv.chunk(3, dim=-1)
    return attention(q, k, v, num_heads=num_heads, scale=scale)


@register("attention_kv", "reference")
def attention_kv(q: torch.Tensor, kv: torch.Tensor, *, num_heads: int = 1,
                 scale: float | None = None) -> torch.Tensor:
    """Cross-attention over the fused KV projection output (B, Sk, 2*H*D)."""
    k, v = kv.chunk(2, dim=-1)
    return attention(q, k, v, num_heads=num_heads, scale=scale)


# ---------------------------------------------------------------------------
# group norm (+ optional fused activation), NHWC
# ---------------------------------------------------------------------------


@register("group_norm", "reference")
def group_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, *,
               num_groups: int = 32, eps: float = 1e-5,
               act: str | None = None) -> torch.Tensor:
    """GroupNorm over NHWC input; moments and apply in float32."""
    n, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    xg = x.reshape(n, h * w, num_groups, c // num_groups).float()
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    out = xn * gamma.float() + beta.float()
    return apply_activation(out, act).to(x.dtype)


@register("group_norm", "bf16apply")
def group_norm_bf16apply(x: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, *, num_groups: int = 32,
                         eps: float = 1e-5,
                         act: str | None = None) -> torch.Tensor:
    """GroupNorm with float32 moments and the normalize + activation applied
    in the input dtype (half the traffic of the apply pass in bf16)."""
    n, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    per = c // num_groups
    xf = x.float()
    s1 = xf.sum(dim=(1, 2))
    s2 = xf.square().sum(dim=(1, 2))
    cnt = h * w * per
    mean = s1.reshape(n, num_groups, per).sum(-1) / cnt
    ex2 = s2.reshape(n, num_groups, per).sum(-1) / cnt
    rstd = torch.rsqrt(torch.clamp(ex2 - mean.square(), min=0.0) + eps)
    scale = rstd.repeat_interleave(per, dim=1) * gamma.float()
    shift = beta.float() - mean.repeat_interleave(per, dim=1) * scale
    out = (x * scale[:, None, None, :].to(x.dtype)
           + shift[:, None, None, :].to(x.dtype))
    return apply_activation(out, act).to(x.dtype)


# ---------------------------------------------------------------------------
# layer norm
# ---------------------------------------------------------------------------


@register("layer_norm", "reference")
def layer_norm(x: torch.Tensor, gamma: torch.Tensor | None,
               beta: torch.Tensor | None, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if gamma is not None:
        out = out * gamma.float()
    if beta is not None:
        out = out + beta.float()
    return out.to(x.dtype)


@register("layer_norm", "bf16apply")
def layer_norm_bf16apply(x: torch.Tensor, gamma: torch.Tensor | None,
                         beta: torch.Tensor | None, *,
                         eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm with float32 two-pass moments and the normalize + affine
    applied in the input dtype."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = (x - mean.to(x.dtype)) * rstd.to(x.dtype)
    if gamma is not None:
        out = out * gamma.to(x.dtype)
    if beta is not None:
        out = out + beta.to(x.dtype)
    return out


@register("rms_norm", "reference")
def rms_norm(x: torch.Tensor, gamma: torch.Tensor | None,
             beta: torch.Tensor | None = None, *, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last axis: x / sqrt(mean(x^2) + eps) * gamma (+beta);
    float32 moments and apply, one rounding."""
    xf = x.float()
    out = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    if gamma is not None:
        out = out * gamma.float()
    if beta is not None:
        out = out + beta.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GEGLU, linear, timestep embedding
# ---------------------------------------------------------------------------


@register("geglu", "reference")
def geglu(state: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """state * gelu(gate), exact (erf) gelu."""
    return state * F.gelu(gate, approximate="none").to(state.dtype)


def dequantize(w):
    """A quantized (int8, scale) pair as its float32 weight; a tensor
    passes through."""
    if isinstance(w, tuple):
        wq, scale = w
        return wq.float() * scale
    return w


@register("linear", "reference")
def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           act: str | None = None) -> torch.Tensor:
    """x: (..., in), w: (in, out), w cast to x's dtype. Without ``act`` the
    product runs in x's dtype with float32 accumulation inside the GEMM and
    the bias joins the float32 sum (``addmm``). With ``act`` the GEMM runs
    in float32 on the upcast operands (a bf16 product is exact in float32),
    the bias joins that sum and the activation applies to it in float32.
    Either way the output rounds once to x's dtype, as in the JAX op. A
    quantized (int8, scale) pair is dequantized first (the exact path)."""
    w = dequantize(w).to(x.dtype)
    if act is None and b is None:
        return torch.matmul(x, w)
    x2 = x.reshape(-1, x.shape[-1])
    if act is None:
        out = torch.addmm(b.to(x.dtype), x2, w)
    else:
        xf, wf = x2.float(), w.float()
        out = xf @ wf if b is None else torch.addmm(b.float(), xf, wf)
        out = apply_activation(out, act).to(x.dtype)
    return out.reshape(*x.shape[:-1], w.shape[1])


@register("time_embed", "reference")
def time_embed(t: torch.Tensor, *, dim: int, max_period: float = 10000.0,
               flip_sin_to_cos: bool = True,
               downscale_freq_shift: float = 0.0) -> torch.Tensor:
    """Sinusoidal embedding of (B,) timesteps -> (B, dim), float32."""
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(
        half, dtype=torch.float32, device=t.device)
    freqs = torch.exp(exponent / (half - downscale_freq_shift))
    args = t.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    if flip_sin_to_cos:
        return torch.cat([cos, sin], dim=-1)
    return torch.cat([sin, cos], dim=-1)


# ---------------------------------------------------------------------------
# conv2d (+ bias + residual + activation), NHWC / HWIO
# ---------------------------------------------------------------------------


def _norm_padding(padding) -> tuple[tuple[int, int], tuple[int, int]]:
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    (t, bo), (le, r) = padding
    return (int(t), int(bo)), (int(le), int(r))


@register("conv2d", "reference")
def conv2d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
           stride: int = 1, padding=1, residual: torch.Tensor | None = None,
           act: str | None = None) -> torch.Tensor:
    """NHWC conv with HWIO weights; optional bias, residual add, activation.

    ``padding``: int (symmetric) or ((top, bottom), (left, right)). ``b`` may
    be (Cout,) or a per-batch (B, Cout) bias. The epilogue runs in float32.
    The NHWC tensor is handed to cuDNN as a channels-last NCHW view, so no
    layout copy is made. A quantized (int8, scale) pair is dequantized first.
    """
    (pt, pb), (pl, pr) = _norm_padding(padding)
    xc = x.permute(0, 3, 1, 2)
    wc = dequantize(w).to(x.dtype).permute(3, 2, 0, 1)
    if pt == pb and pl == pr:
        out = F.conv2d(xc, wc, None, stride=stride, padding=(pt, pl))
    else:
        out = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), wc, None, stride=stride)
    out = out.permute(0, 2, 3, 1).float()
    if b is not None:
        bb = b.float()
        out = out + (bb[:, None, None, :] if bb.ndim == 2 else bb)
    if residual is not None:
        out = out + residual.float()
    return apply_activation(out, act).to(x.dtype).contiguous()


@register("gn_conv2d", "reference")
def gn_conv2d(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
              w: torch.Tensor, b: torch.Tensor | None = None, *,
              num_groups: int = 32, eps: float = 1e-5,
              gn_act: str | None = "silu", stride: int = 1, padding=1,
              residual: torch.Tensor | None = None,
              act: str | None = None) -> torch.Tensor:
    """GroupNorm(+gn_act) then conv2d, each through the ACTIVE binding."""
    h = dispatch("group_norm", x, gamma, beta, num_groups=num_groups,
                 eps=eps, act=gn_act)
    return dispatch("conv2d", h, w, b, stride=stride, padding=padding,
                    residual=residual, act=act)


# ---------------------------------------------------------------------------
# the int8 "turbo" ops (CompileConfig.quantize): W8A8 with dynamic
# activation quantization. The JAX package computes their int8 x int8 ->
# int32 product in plain XLA, outside any Pallas kernel; here it is
# torch._int_mm (cuBLASLt's int8 GEMM on the card). Quantize and dequantize
# are plain torch, unfused.
# ---------------------------------------------------------------------------

# float32(1 / 127), JAX's weak-typed constant: multiplied into the abs-max in float32
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def _quantize_activations(xf: torch.Tensor, dims) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric abs-max int8 over ``dims`` of float32 ``xf``: (xq, sx) with
    ``sx = max(amax, 1e-8) * f32(1/127)`` and ``xq = clip(round(xf / sx),
    -127, 127)``, in the JAX op's order."""
    sx = xf.abs().amax(dim=dims, keepdim=True).clamp_min(1e-8) * _INV127
    return torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8), sx


def pad_int8_rows(a: torch.Tensor) -> torch.Tensor:
    """An (M, K) int8 operand with its rows padded with zeros to 17:
    cuBLASLt's int8 GEMM (``torch._int_mm`` on the card) refuses M <= 16.
    Zero rows give zero rows of the product, dropped after, so the result
    is exact. It also refuses K or N not a multiple of 8, which no
    supported model has: such a call raises."""
    return F.pad(a, (0, 0, 0, 17 - a.shape[0])) if a.shape[0] < 17 else a


def int8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 -> (M, N) int32, exact: one
    ``torch._int_mm`` on :func:`pad_int8_rows`; a call it refuses raises.
    The largest SDXL sum, 9 * 2560 terms of at most 127^2, stays far
    inside int32."""
    m = a.shape[0]
    out = torch._int_mm(pad_int8_rows(a), b)
    return out[:m] if out.shape[0] != m else out


def _int8_epilogue(acc, sx, scale, b, residual, act, dtype):
    """``acc * (sx * scale)``, then the bias (broadcast as given), the
    residual and ``act`` in float32, and one cast to ``dtype``, as the JAX
    ops do."""
    out = acc.float() * (sx * scale.float())
    if b is not None:
        out = out + b.float()
    if residual is not None:
        out = out + residual.float()
    return apply_activation(out, act).to(dtype)


@register("linear", "int8")
def linear_int8(x: torch.Tensor, w, b: torch.Tensor | None = None, *,
                act: str | None = None) -> torch.Tensor:
    """The W8A8 linear of the turbo bindings: ``w`` an (int8 (in, out),
    (out,) float32 scale) pair from ``quantize_linear_weights``; x quantized
    per token (its last axis) at run time; an exact int32 product; then the
    float32 epilogue and one cast. An unquantized weight (the time and
    added-conditioning embeddings) takes the reference linear."""
    if not isinstance(w, tuple):
        return linear(x, w, b, act=act)
    wq, scale = w
    xq, sx = _quantize_activations(x.float(), -1)
    k, n = wq.shape
    acc = int8_mm(xq.reshape(-1, k), wq).reshape(*x.shape[:-1], n)
    return _int8_epilogue(acc, sx, scale, b, None, act, x.dtype)


def _im2col(xq: torch.Tensor, kh: int, kw: int, stride: int, padding):
    """The (B * Ho * Wo, kh * kw * Cin) patch rows of NHWC ``xq`` padded
    with zeros, in HWIO's (dy, dx, cin) order, and (B, Ho, Wo)."""
    (pt, pb), (pl, pr) = _norm_padding(padding)
    bsz, h, w, cin = xq.shape
    xp = F.pad(xq, (0, 0, pl, pr, pt, pb))
    ho = (h + pt + pb - kh) // stride + 1
    wo = (w + pl + pr - kw) // stride + 1
    cols = [xp[:, dy:dy + stride * (ho - 1) + 1:stride, dx:dx + stride * (wo - 1) + 1:stride]
            for dy in range(kh) for dx in range(kw)]
    return torch.stack(cols, dim=3).reshape(bsz * ho * wo, kh * kw * cin), (bsz, ho, wo)


@register("conv2d", "int8")
def conv2d_int8(x: torch.Tensor, w, b: torch.Tensor | None = None, *, stride: int = 1,
                padding=1, residual: torch.Tensor | None = None,
                act: str | None = None) -> torch.Tensor:
    """The W8A8 conv of ``quantize="int8_conv"``: ``w`` an (int8 HWIO,
    (Cout,) float32 scale) pair; x quantized per sample (over H, W, C) at
    run time; an exact int32 product of its zero-padded int8 patches (one
    ``int8_mm``); then the float32 epilogue (``b`` (Cout,) or (B, Cout)) and
    one cast. An unquantized weight takes the reference conv."""
    if not isinstance(w, tuple):
        return conv2d(x, w, b, stride=stride, padding=padding, residual=residual, act=act)
    wq, scale = w
    kh, kw, cin, cout = wq.shape
    xq, sx = _quantize_activations(x.float(), (1, 2, 3))
    cols, (bsz, ho, wo) = _im2col(xq, kh, kw, stride, padding)
    acc = int8_mm(cols, wq.reshape(kh * kw * cin, cout)).reshape(bsz, ho, wo, cout)
    if b is not None and b.dim() == 2:
        b = b[:, None, None, :]
    return _int8_epilogue(acc, sx, scale, b, residual, act, x.dtype)
