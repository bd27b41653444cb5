"""Compile options, the op -> backend binding and the compile API.

Counterpart of ``stabletriton_tpu/compile.py``. "Compiling" is choosing the
binding the model runs under, preparing the parameters (fused projections,
dtype) and, where JAX jits the step, wrapping it in a graphed callable
(``runtime/graphs.py``): on the card each signature's first call runs
eagerly and is captured as a CUDA graph, and every later call replays it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from stabletriton_tpu_torch import ops
from stabletriton_tpu_torch.models.unet import (
    UNetConfig,
    precompute_cross_kv,
    precompute_time_cond,
    unet_apply,
    unet_apply_shallow,
)
from stabletriton_tpu_torch.runtime.graphs import Graphs

# ops the "cuda" backend binds to the attention kernel
KERNEL_ATTENTION_OPS = ("attention", "attention_qkv", "attention_kv")

# ops whose "cuda" kernel exists but is opt-in (bind via overrides): the JAX
# package's OPTIONAL_PALLAS_OPS plus rms_norm (the LayerNorm kernel's other
# form). ``gn_conv2d`` binds "fused" (GN apply fused into the 3x3 conv kernel).
OPTIONAL_KERNEL_OPS = ("geglu", "group_norm", "layer_norm", "rms_norm", "linear",
                       "time_embed", "dropout")

# the default binding's GroupNorm, LayerNorm and GEGLU: the JAX package's
# plain bf16-apply forms (and its reference GEGLU), each op rounded to the
# input dtype, computed by the K9-K11 kernels in their stepwise forms
BF16APPLY_KERNEL_OPS = ("group_norm", "layer_norm", "geglu")

# the fused-op binding: the JAX package's ``backend="pallas"`` with the
# group_norm / layer_norm / geglu / gn_conv2d="fused" overrides
FUSED_OP_OVERRIDES = (("group_norm", "cuda"), ("layer_norm", "cuda"), ("geglu", "cuda"),
                      ("gn_conv2d", "fused"))

# the all-kernel binding: the fused-op binding with linear and time_embed on
# their kernels too, so every op a model path reaches runs a hand-written
# kernel (dropout is not on any model path: the UNet elides it, as in JAX)
ALL_KERNEL_OVERRIDES = FUSED_OP_OVERRIDES + (("linear", "cuda"), ("time_embed", "cuda"))


@dataclass(frozen=True)
class CompileConfig:
    """``backend``: "cuda" (hand-written Hopper kernels) or "reference"
    (plain PyTorch). ``overrides``: per-op (op, backend) pairs applied on
    top of the backend's binding, e.g. ``FUSED_OP_OVERRIDES``.
    ``cache_cross_kv``: the pipeline projects the text conditioning through
    every cross-attention K/V once per generation (``precompute_cross_kv``)
    instead of in every step; ``cache_time_cond``: it batches the
    time-conditioning projections over all steps before the loop
    (``precompute_time_cond``), opt-in as in the JAX package. Both compute
    what the step would.

    ``quantize``: the opt-in turbo draft mode, as the JAX package's. The
    pipeline turns the UNet's eligible weights into (int8, per-output-channel
    scale) pairs (:func:`quantize_linear_weights`, weights with both dims at
    least ``quantize_min_dim``) and the binding takes linear to the W8A8
    op: "int8" every eligible linear, "int8_ff" only the GEGLU
    up-projections, "int8_conv" the linears and the convs. It breaks the
    1e-3 fidelity gate by design; its numbers are reported apart."""

    backend: str = "cuda"
    dtype: str = "bfloat16"
    overrides: tuple[tuple[str, str], ...] = ()
    cache_cross_kv: bool = True
    cache_time_cond: bool = False
    quantize: str | None = None
    quantize_min_dim: int = 256

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def resolve_binding(config: CompileConfig) -> dict[str, str]:
    """The op -> backend binding for ``config``, as in the JAX package: the
    attention family on the attention kernel, conv2d on the direct 3x3 conv
    kernel, GroupNorm / LayerNorm on the bf16-apply forms and GEGLU on the
    reference form, these three computed by the kernels' "cuda_bf16apply"
    forms (the same roundings in one or two launches, where the plain
    chains take 2-27); then the quantize mode's int8 ops; then the
    overrides. An unknown quantize mode raises; an override must name a
    registered backend, or "reference"."""
    if config.backend not in ("cuda", "reference"):
        raise ValueError(f"unknown backend {config.backend!r}")
    if config.backend == "cuda" or any(bk != "reference" for _, bk in config.overrides):
        import stabletriton_tpu_torch.kernels  # noqa: F401  (registers the kernels)
    binding: dict[str, str] = {}
    if config.backend == "cuda":
        for op in KERNEL_ATTENTION_OPS:
            binding[op] = "cuda"
        for op in BF16APPLY_KERNEL_OPS:
            binding[op] = "cuda_bf16apply"
        binding["conv2d"] = "direct"
    if config.quantize in ("int8", "int8_ff"):
        binding["linear"] = "int8"
    elif config.quantize == "int8_conv":
        binding["linear"] = binding["conv2d"] = "int8"
    elif config.quantize is not None:
        raise ValueError(f"unknown quantize mode {config.quantize!r}")
    registered = ops.registered_ops()
    for op, backend in config.overrides:
        if backend != "reference" and backend not in registered.get(op, []):
            raise ValueError(f"override {op}->{backend}: backend not registered")
        binding[op] = backend
    return binding


def compile_unet(unet_config: UNetConfig, config: CompileConfig = CompileConfig()):
    """The UNet step under ``config``'s binding, as a graphed callable:
    ``step(params, sample, timesteps, encoder_hidden_states, text_embeds,
    time_ids) -> eps``. ``params`` (cast with :func:`cast_params`) are read
    in place, so each must stay where it was at the signature's capture."""
    binding = resolve_binding(config)
    dtype = config.torch_dtype

    def step(params, sample, timesteps, encoder_hidden_states, text_embeds, time_ids):
        with ops.use_backends(binding):
            return unet_apply(unet_config, params, sample.to(dtype), timesteps,
                              encoder_hidden_states, text_embeds, time_ids)

    return Graphs().wrap(step)


def compile_unet_kv(unet_config: UNetConfig, config: CompileConfig = CompileConfig()):
    """:func:`compile_unet` with the hoisted conditioning split out, as the
    JAX package's: ``(precompute, precompute_time, step)``, three graphed
    callables on one memory pool:

      precompute(params, encoder_hidden_states) -> cross_kv
      precompute_time(params, timesteps, text_embeds, time_ids) -> time_cond
          ({resnet_key: (T, B, C)}; slice step i before calling step)
      step(params, sample, t, cross_kv, text_embeds, time_ids,
           time_cond=None) -> eps

    The step computes what :func:`compile_unet`'s does: the same ops on the
    same inputs, hoisted."""
    binding = resolve_binding(config)
    dtype = config.torch_dtype
    graphs = Graphs()

    def precompute(params, encoder_hidden_states):
        with ops.use_backends(binding):
            return precompute_cross_kv(unet_config, params, encoder_hidden_states.to(dtype))

    def precompute_time(params, timesteps, text_embeds, time_ids):
        with ops.use_backends(binding):
            return precompute_time_cond(unet_config, params, timesteps, text_embeds, time_ids,
                                        dtype=dtype)

    def step(params, sample, timesteps, cross_kv, text_embeds, time_ids, time_cond=None):
        with ops.use_backends(binding):
            return unet_apply(unet_config, params, sample.to(dtype), timesteps, None,
                              text_embeds, time_ids, cross_kv=cross_kv, time_cond=time_cond)

    return graphs.wrap(precompute), graphs.wrap(precompute_time), graphs.wrap(step)


def compile_unet_deepcache(unet_config: UNetConfig, config: CompileConfig = CompileConfig()):
    """The DeepCache pair for callers that own the step loop, as the JAX
    package's: ``(full, shallow)``, two graphed callables on one memory
    pool:

      full(params, sample, t, encoder_hidden_states, text_embeds, time_ids)
          -> (eps, cache)
      shallow(params, sample, t, encoder_hidden_states, text_embeds,
              time_ids, cache) -> eps

    ``cache`` is the deep-feature tensor entering the last up block
    (``unet_apply(return_cache=True)``, ``unet_apply_shallow``). The
    pipeline carries the cache inside its replayed loop instead
    (``make_denoise_loop(deep_cache=)``)."""
    binding = resolve_binding(config)
    dtype = config.torch_dtype
    graphs = Graphs()

    def full(params, sample, timesteps, encoder_hidden_states, text_embeds, time_ids):
        with ops.use_backends(binding):
            return unet_apply(unet_config, params, sample.to(dtype), timesteps,
                              encoder_hidden_states, text_embeds, time_ids, return_cache=True)

    def shallow(params, sample, timesteps, encoder_hidden_states, text_embeds, time_ids,
                cache):
        with ops.use_backends(binding):
            return unet_apply_shallow(unet_config, params, sample.to(dtype), timesteps,
                                      encoder_hidden_states, text_embeds, time_ids, cache)

    return graphs.wrap(full), graphs.wrap(shallow)


def cast_params(params: dict[str, torch.Tensor], config: CompileConfig) -> dict:
    """Cast every parameter to the compile dtype once, not per step;
    quantized (int8, scale) pairs pass through as they are."""
    dtype = config.torch_dtype
    return {k: v if isinstance(v, tuple) else v.to(dtype) for k, v in params.items()}


def quantize_linear_weights(params: dict, *, min_dim: int = 256, conv: bool = False,
                            ff_only: bool = False) -> dict:
    """The eligible weights as (int8, per-output-channel float32 scale)
    pairs for the turbo bindings, the JAX package's rules and arithmetic:

      * a 2-D ``*.weight`` with both dims at least ``min_dim``; with
        ``conv``, also a 4-D HWIO conv weight whose Cin and Cout both reach
        it (conv_in / conv_out keep their 4-channel side exact);
      * never the time or added-conditioning embeddings; with ``ff_only``,
        only the GEGLU up-projections (``.net.0.proj.``);
      * ``scale = max(max |w| over all axes but the last, 1e-12) / 127``,
        ``wq = clip(round(w / scale), -127, 127)`` in float32, rounding
        half to even as ``jnp.round``.

    The int8 weight keeps its shape ((in, out), or HWIO) and is stored
    output-channel-major: its memory is (out, ...) contiguous, so its
    (K, N) matrix is the transposed view cuBLASLt's int8 GEMM takes (on an
    H100 1.8-5.5x faster than a row-major (K, N) weight, PERF.md). Run after
    :func:`fuse_attention_projections`, so a fused qkv / kv weight
    quantizes as one tensor. Returns a new dict; the other values are the
    same objects."""
    out = {}
    for key, w in params.items():
        ndim = w.dim() if isinstance(w, torch.Tensor) else 0
        eligible = (
            key.endswith(".weight")
            and "time_embedding" not in key
            and "add_embedding" not in key
            and (not ff_only or ".net.0.proj." in key)
            and ((ndim == 2 and min(w.shape) >= min_dim)
                 or (conv and ndim == 4 and min(w.shape[2], w.shape[3]) >= min_dim))
        )
        if eligible:
            wf = w.float()
            amax = wf.abs().amax(dim=tuple(range(ndim - 1)))  # all but the output channels
            scale = amax.clamp_min(1e-12) / 127.0
            wq = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
            out[key] = (wq.movedim(-1, 0).contiguous().movedim(0, -1), scale)
        else:
            out[key] = w
    return out


def fuse_attention_projections(params: dict[str, torch.Tensor]) -> dict:
    """Concatenate each self-attention's q/k/v weights into ``to_qkv.weight``
    (in, 3C) and each cross-attention's k/v into ``to_kv.weight`` (in, 2C):
    one wide GEMM instead of three or two narrow ones, and a fused buffer the
    attention kernel reads in place. Returns a new dict."""
    out = dict(params)
    for key in list(params):
        if key.endswith(".attn1.to_q.weight"):
            base = key[: -len(".to_q.weight")]
            names = [f"{base}.to_{x}.weight" for x in ("q", "k", "v")]
            if all(n in out for n in names):
                out[f"{base}.to_qkv.weight"] = torch.cat([out.pop(n) for n in names], dim=1)
        elif key.endswith(".attn2.to_k.weight"):
            base = key[: -len(".to_k.weight")]
            names = [f"{base}.to_{x}.weight" for x in ("k", "v")]
            if all(n in out for n in names):
                out[f"{base}.to_kv.weight"] = torch.cat([out.pop(n) for n in names], dim=1)
    return out
