"""Compile options and the op -> backend binding.

Counterpart of ``stabletriton_tpu/compile.py``. PyTorch runs eagerly, so
there is no jit step: "compiling" here is choosing the binding that the
model runs under and preparing the parameters (fused projections, dtype).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from stabletriton_tpu_torch import ops

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
    top of the backend's binding, e.g. ``FUSED_OP_OVERRIDES``."""

    backend: str = "cuda"
    dtype: str = "bfloat16"
    overrides: tuple[tuple[str, str], ...] = ()

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
