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
    what the step would."""

    backend: str = "cuda"
    dtype: str = "bfloat16"
    overrides: tuple[tuple[str, str], ...] = ()
    cache_cross_kv: bool = True
    cache_time_cond: bool = False

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)


def resolve_binding(config: CompileConfig) -> dict[str, str]:
    """The op -> backend binding for ``config``, as in the JAX package: the
    attention family on the attention kernel, conv2d on the direct 3x3 conv
    kernel, GroupNorm/LayerNorm on the bf16-apply forms; then the overrides.
    An override must name a registered backend, or "reference"."""
    if config.backend not in ("cuda", "reference"):
        raise ValueError(f"unknown backend {config.backend!r}")
    if config.backend == "cuda" or any(bk != "reference" for _, bk in config.overrides):
        import stabletriton_tpu_torch.kernels  # noqa: F401  (registers the kernels)
    binding: dict[str, str] = {}
    if config.backend == "cuda":
        for op in KERNEL_ATTENTION_OPS:
            binding[op] = "cuda"
        binding["group_norm"] = "bf16apply"
        binding["layer_norm"] = "bf16apply"
        binding["conv2d"] = "direct"
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
    """Cast every parameter to the compile dtype once, not per step."""
    dtype = config.torch_dtype
    return {k: v.to(dtype) for k, v in params.items()}


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
