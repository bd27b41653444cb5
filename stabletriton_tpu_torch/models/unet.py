"""Functional UNet (SDXL, SD1.x) in PyTorch, written against the op registry.

Counterpart of ``stabletriton_tpu/models/unet.py``: the model is a plain
function of ``(config, params, inputs)`` over a flat ``{hf_key: tensor}``
dict with the Diffusers key names. Layouts are the JAX package's: NHWC
activations, HWIO conv weights, (in, out) linear weights, so the same numpy
weights drive both packages.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from stabletriton_tpu_torch import ops
from stabletriton_tpu_torch.runtime.mesh import row_parallel_linear

# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class UNetConfig:
    """Topology of a UNet2DConditionModel (defaults = SDXL-base)."""

    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: tuple[int, ...] = (320, 640, 1280)
    down_block_types: tuple[str, ...] = (
        "DownBlock2D",
        "CrossAttnDownBlock2D",
        "CrossAttnDownBlock2D",
    )
    layers_per_block: int = 2
    transformer_layers_per_block: tuple[int, ...] = (1, 2, 10)
    attention_head_dim: int = 64
    cross_attention_dim: int = 2048
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    transformer_norm_eps: float = 1e-6
    addition_time_embed_dim: int | None = 256
    projection_class_embeddings_input_dim: int | None = 2816
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0
    fixed_num_heads: int | None = None
    mid_block_layers: int | None = None

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4

    @property
    def mid_transformer_layers(self) -> int:
        if self.mid_block_layers is not None:
            return self.mid_block_layers
        depth = self.transformer_layers_per_block[0]
        for t, d in zip(self.down_block_types, self.transformer_layers_per_block):
            if t == "CrossAttnDownBlock2D":
                depth = d
        return depth

    @property
    def up_block_types(self) -> tuple[str, ...]:
        mapping = {"DownBlock2D": "UpBlock2D", "CrossAttnDownBlock2D": "CrossAttnUpBlock2D"}
        return tuple(mapping[t] for t in reversed(self.down_block_types))

    def num_heads(self, channels: int) -> int:
        if self.fixed_num_heads is not None:
            if channels % self.fixed_num_heads:
                raise ValueError(f"{channels} channels, {self.fixed_num_heads} heads")
            return self.fixed_num_heads
        if channels % self.attention_head_dim:
            raise ValueError(f"{channels} channels, head dim {self.attention_head_dim}")
        return channels // self.attention_head_dim

    @property
    def has_addition_embedding(self) -> bool:
        return self.projection_class_embeddings_input_dim is not None


def sdxl_base_unet_config() -> UNetConfig:
    return UNetConfig()


def sd15_unet_config() -> UNetConfig:
    """Stable Diffusion 1.x UNet (runwayml/stable-diffusion-v1-5): 4 levels,
    conv-only innermost, 8 heads at every level (head dim 40/80/160),
    768-wide cross attention, no added (text_time) conditioning."""
    return UNetConfig(
        block_out_channels=(320, 640, 1280, 1280),
        down_block_types=(
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "DownBlock2D",
        ),
        transformer_layers_per_block=(1, 1, 1, 1),
        cross_attention_dim=768,
        fixed_num_heads=8,
        addition_time_embed_dim=None,
        projection_class_embeddings_input_dim=None,
        mid_block_layers=1,
    )


def sd21_unet_config() -> UNetConfig:
    """Stable Diffusion 2.x UNet (stabilityai/stable-diffusion-2-1
    ``unet/config.json``): SD1.x's topology with 1024-wide cross attention
    (OpenCLIP-H) and head dim 64 at every level, so 5/10/20/20 heads."""
    return UNetConfig(
        block_out_channels=(320, 640, 1280, 1280),
        down_block_types=(
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "DownBlock2D",
        ),
        transformer_layers_per_block=(1, 1, 1, 1),
        cross_attention_dim=1024,
        attention_head_dim=64,
        addition_time_embed_dim=None,
        projection_class_embeddings_input_dim=None,
        mid_block_layers=1,
    )


def sdxl_refiner_unet_config() -> UNetConfig:
    """SDXL refiner (stabilityai/stable-diffusion-xl-refiner-1.0
    ``unet/config.json``): 4 levels (384/768/1536/1536), the outermost and
    innermost conv-only, 4 transformer layers at each attention level and
    in the mid block, 1280-wide cross attention (bigG alone), a 2560-wide
    add embedding (pooled 1280 + 5 time ids x 256: the refiner's fifth slot
    is the aesthetic score)."""
    return UNetConfig(
        block_out_channels=(384, 768, 1536, 1536),
        down_block_types=(
            "DownBlock2D",
            "CrossAttnDownBlock2D",
            "CrossAttnDownBlock2D",
            "DownBlock2D",
        ),
        transformer_layers_per_block=(1, 4, 4, 1),
        cross_attention_dim=1280,
        projection_class_embeddings_input_dim=2560,
    )


def tiny_unet_config() -> UNetConfig:
    """Small config with the same structural features (for CPU tests)."""
    return UNetConfig(
        block_out_channels=(32, 64),
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
        layers_per_block=1,
        transformer_layers_per_block=(1, 1),
        attention_head_dim=16,
        cross_attention_dim=32,
        norm_num_groups=8,
        addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=8 * 6 + 16,
    )


# ---------------------------------------------------------------------------
# parameter shapes (identical to the JAX package's table)
# ---------------------------------------------------------------------------


class _ShapeBuilder:
    def __init__(self):
        self.shapes: dict[str, tuple[int, ...]] = {}

    def conv(self, key: str, cin: int, cout: int, k: int = 3):
        self.shapes[f"{key}.weight"] = (k, k, cin, cout)  # HWIO
        self.shapes[f"{key}.bias"] = (cout,)

    def linear(self, key: str, cin: int, cout: int, bias: bool = True):
        self.shapes[f"{key}.weight"] = (cin, cout)  # (in, out)
        if bias:
            self.shapes[f"{key}.bias"] = (cout,)

    def norm(self, key: str, c: int):
        self.shapes[f"{key}.weight"] = (c,)
        self.shapes[f"{key}.bias"] = (c,)


def _resnet_shapes(b: _ShapeBuilder, key: str, cin: int, cout: int, temb: int):
    b.norm(f"{key}.norm1", cin)
    b.conv(f"{key}.conv1", cin, cout)
    b.linear(f"{key}.time_emb_proj", temb, cout)
    b.norm(f"{key}.norm2", cout)
    b.conv(f"{key}.conv2", cout, cout)
    if cin != cout:
        b.conv(f"{key}.conv_shortcut", cin, cout, k=1)


def _transformer_shapes(b: _ShapeBuilder, key: str, c: int, cfg: UNetConfig, layers: int):
    b.norm(f"{key}.norm", c)
    b.linear(f"{key}.proj_in", c, c)
    for k in range(layers):
        tb = f"{key}.transformer_blocks.{k}"
        b.norm(f"{tb}.norm1", c)
        b.linear(f"{tb}.attn1.to_q", c, c, bias=False)
        b.linear(f"{tb}.attn1.to_k", c, c, bias=False)
        b.linear(f"{tb}.attn1.to_v", c, c, bias=False)
        b.linear(f"{tb}.attn1.to_out.0", c, c)
        b.norm(f"{tb}.norm2", c)
        b.linear(f"{tb}.attn2.to_q", c, c, bias=False)
        b.linear(f"{tb}.attn2.to_k", cfg.cross_attention_dim, c, bias=False)
        b.linear(f"{tb}.attn2.to_v", cfg.cross_attention_dim, c, bias=False)
        b.linear(f"{tb}.attn2.to_out.0", c, c)
        b.norm(f"{tb}.norm3", c)
        b.linear(f"{tb}.ff.net.0.proj", c, c * 8)  # GEGLU: 2 * (4c)
        b.linear(f"{tb}.ff.net.2", c * 4, c)
    b.linear(f"{key}.proj_out", c, c)


def unet_param_shapes(cfg: UNetConfig) -> dict[str, tuple[int, ...]]:
    """Every parameter key (Diffusers SDXL naming) and its shape in our layout."""
    b = _ShapeBuilder()
    temb = cfg.time_embed_dim
    ch0 = cfg.block_out_channels[0]

    b.conv("conv_in", cfg.in_channels, ch0)
    b.linear("time_embedding.linear_1", ch0, temb)
    b.linear("time_embedding.linear_2", temb, temb)
    if cfg.has_addition_embedding:
        b.linear("add_embedding.linear_1", cfg.projection_class_embeddings_input_dim, temb)
        b.linear("add_embedding.linear_2", temb, temb)

    cin = ch0
    for i, btype in enumerate(cfg.down_block_types):
        cout = cfg.block_out_channels[i]
        for j in range(cfg.layers_per_block):
            _resnet_shapes(b, f"down_blocks.{i}.resnets.{j}", cin if j == 0 else cout, cout, temb)
            if btype == "CrossAttnDownBlock2D":
                _transformer_shapes(b, f"down_blocks.{i}.attentions.{j}", cout, cfg,
                                    cfg.transformer_layers_per_block[i])
        if i < len(cfg.down_block_types) - 1:
            b.conv(f"down_blocks.{i}.downsamplers.0.conv", cout, cout)
        cin = cout

    cmid = cfg.block_out_channels[-1]
    _resnet_shapes(b, "mid_block.resnets.0", cmid, cmid, temb)
    _transformer_shapes(b, "mid_block.attentions.0", cmid, cfg, cfg.mid_transformer_layers)
    _resnet_shapes(b, "mid_block.resnets.1", cmid, cmid, temb)

    skip_channels = _skip_channel_stack(cfg)
    rev_channels = list(reversed(cfg.block_out_channels))
    prev = cmid
    for i, btype in enumerate(cfg.up_block_types):
        cout = rev_channels[i]
        tf_layers = tuple(reversed(cfg.transformer_layers_per_block))[i]
        for j in range(cfg.layers_per_block + 1):
            skip = skip_channels.pop()
            _resnet_shapes(b, f"up_blocks.{i}.resnets.{j}", prev + skip, cout, temb)
            prev = cout
            if btype == "CrossAttnUpBlock2D":
                _transformer_shapes(b, f"up_blocks.{i}.attentions.{j}", cout, cfg, tf_layers)
        if i < len(cfg.up_block_types) - 1:
            b.conv(f"up_blocks.{i}.upsamplers.0.conv", cout, cout)

    b.norm("conv_norm_out", ch0)
    b.conv("conv_out", ch0, cfg.out_channels)
    return b.shapes


def _skip_channel_stack(cfg: UNetConfig) -> list[int]:
    """Channel count of each down-path residual, in push order (conv_in first)."""
    stack = [cfg.block_out_channels[0]]
    for i in range(len(cfg.down_block_types)):
        cout = cfg.block_out_channels[i]
        stack.extend([cout] * cfg.layers_per_block)
        if i < len(cfg.down_block_types) - 1:
            stack.append(cout)
    return stack


_NORM_SUFFIXES = ("norm1.weight", "norm2.weight", "norm3.weight", "norm.weight",
                  "conv_norm_out.weight")


def init_unet_params(cfg: UNetConfig, seed: int = 0, *, device="cpu",
                     dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Random-init params with the JAX package's distribution (zero biases,
    unit norm scales, N(0, 1/fan_in) weights), drawn on ``device`` from a
    generator seeded with ``seed``. The numbers differ from JAX's."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = {}
    for name, shape in sorted(unet_param_shapes(cfg).items()):
        if name.endswith(".bias"):
            params[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif name.endswith(_NORM_SUFFIXES):
            params[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            fan_in = math.prod(shape[:-1]) if len(shape) > 1 else shape[0]
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            params[name] = (w / math.sqrt(max(fan_in, 1))).to(dtype)
    return params


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _resnet(p, key: str, x, temb, cfg: UNetConfig, emb=None):
    """ResnetBlock2D: GN+SiLU -> conv -> +time -> GN+SiLU -> conv -> +skip.

    The time embedding folds into conv1's per-batch (B, Cout) f32 bias and
    the shortcut add into conv2's epilogue (the residual argument). ``emb``:
    this resnet's time_emb_proj output from :func:`precompute_time_cond`, in
    place of its own projection of ``temb``."""
    if emb is None:
        emb = ops.linear(F.silu(temb), p[f"{key}.time_emb_proj.weight"],
                         p[f"{key}.time_emb_proj.bias"])
    bias1 = p[f"{key}.conv1.bias"].float()[None, :] + emb.float()
    h = ops.gn_conv2d(
        x, p[f"{key}.norm1.weight"], p[f"{key}.norm1.bias"],
        p[f"{key}.conv1.weight"], bias1,
        num_groups=cfg.norm_num_groups, eps=cfg.norm_eps, gn_act="silu",
    )
    if f"{key}.conv_shortcut.weight" in p:
        skip = ops.conv2d(x, p[f"{key}.conv_shortcut.weight"],
                          p[f"{key}.conv_shortcut.bias"], stride=1, padding=0)
    else:
        skip = x
    return ops.gn_conv2d(
        h, p[f"{key}.norm2.weight"], p[f"{key}.norm2.bias"],
        p[f"{key}.conv2.weight"], p[f"{key}.conv2.bias"],
        num_groups=cfg.norm_num_groups, eps=cfg.norm_eps, gn_act="silu",
        residual=skip,
    )


def _attention_layer(p, key: str, x, context, num_heads: int, cached_kv=None):
    """Multi-head attention, operands channel-packed (B, S, H*D). Four forms:
    a precomputed cross K/V (fused tensor or (k, v) tuple), fused QKV
    weights, fused KV weights, or separate projections. Under a
    tensor-parallel mesh (``runtime/mesh.py``) the separate projections hold
    this rank's heads' columns, so the rank attends over its own heads and
    to_out.0 is row-parallel."""
    if cached_kv is not None:
        q = ops.linear(x, p[f"{key}.to_q.weight"])
        heads = num_heads * q.shape[-1] // x.shape[-1]
        if isinstance(cached_kv, tuple):
            out = ops.attention(q, *cached_kv, num_heads=heads)
        else:
            out = ops.attention_kv(q, cached_kv, num_heads=heads)
    elif f"{key}.to_qkv.weight" in p:
        qkv = ops.linear(x, p[f"{key}.to_qkv.weight"])
        out = ops.attention_qkv(qkv, num_heads=num_heads)
    elif f"{key}.to_kv.weight" in p:
        q = ops.linear(x, p[f"{key}.to_q.weight"])
        kv = ops.linear(context, p[f"{key}.to_kv.weight"])
        out = ops.attention_kv(q, kv, num_heads=num_heads)
    else:
        q = ops.linear(x, p[f"{key}.to_q.weight"])
        k = ops.linear(context, p[f"{key}.to_k.weight"])
        v = ops.linear(context, p[f"{key}.to_v.weight"])
        out = ops.attention(q, k, v, num_heads=num_heads * q.shape[-1] // x.shape[-1])
    return row_parallel_linear(out, p[f"{key}.to_out.0.weight"], p[f"{key}.to_out.0.bias"],
                               x.shape[-1])


def _feed_forward(p, key: str, x):
    """GEGLU feed-forward: proj -> split -> state*gelu(gate) -> linear (row
    parallel under a tensor-parallel mesh)."""
    proj = ops.linear(x, p[f"{key}.net.0.proj.weight"], p[f"{key}.net.0.proj.bias"])
    state, gate = proj.chunk(2, dim=-1)
    h = ops.geglu(state, gate)
    return row_parallel_linear(h, p[f"{key}.net.2.weight"], p[f"{key}.net.2.bias"],
                               h.shape[-1])


def _transformer_block(p, key: str, x, context, num_heads: int, eps: float,
                       cross_kv=None):
    h = ops.layer_norm(x, p[f"{key}.norm1.weight"], p[f"{key}.norm1.bias"], eps=eps)
    x = x + _attention_layer(p, f"{key}.attn1", h, h, num_heads)
    h = ops.layer_norm(x, p[f"{key}.norm2.weight"], p[f"{key}.norm2.bias"], eps=eps)
    cached = None if cross_kv is None else cross_kv.get(f"{key}.attn2")
    if cached is None and context is None:
        raise KeyError(f"cross_kv is missing {key}.attn2 and no context given")
    x = x + _attention_layer(p, f"{key}.attn2", h, context, num_heads, cached_kv=cached)
    h = ops.layer_norm(x, p[f"{key}.norm3.weight"], p[f"{key}.norm3.bias"], eps=eps)
    return x + _feed_forward(p, f"{key}.ff", h)


def _transformer2d(p, key: str, x, context, cfg: UNetConfig, layers: int, cross_kv=None):
    """Transformer2DModel with linear projections."""
    n, h, w, c = x.shape
    num_heads = cfg.num_heads(c)
    residual = x
    hs = ops.group_norm(x, p[f"{key}.norm.weight"], p[f"{key}.norm.bias"],
                        num_groups=cfg.norm_num_groups, eps=cfg.transformer_norm_eps)
    hs = hs.reshape(n, h * w, c)
    hs = ops.linear(hs, p[f"{key}.proj_in.weight"], p[f"{key}.proj_in.bias"])
    for k in range(layers):
        hs = _transformer_block(p, f"{key}.transformer_blocks.{k}", hs, context,
                                num_heads, cfg.transformer_norm_eps, cross_kv=cross_kv)
    hs = ops.linear(hs, p[f"{key}.proj_out.weight"], p[f"{key}.proj_out.bias"])
    return hs.reshape(n, h, w, c) + residual


def _downsample(p, key: str, x):
    return ops.conv2d(x, p[f"{key}.conv.weight"], p[f"{key}.conv.bias"], stride=2, padding=1)


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsampling of an NHWC tensor."""
    n, h, w, c = x.shape
    return x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c).reshape(n, 2 * h, 2 * w, c)


def _upsample(p, key: str, x):
    return ops.conv2d(upsample_nearest2x(x), p[f"{key}.conv.weight"], p[f"{key}.conv.bias"])


def _time_embedding(cfg: UNetConfig, p, timesteps, text_embeds, time_ids, dtype):
    """Time + added (text_time) conditioning -> temb (B, time_embed_dim)."""
    batch = timesteps.shape[0]
    temb = ops.time_embed(timesteps, dim=cfg.block_out_channels[0],
                          flip_sin_to_cos=cfg.flip_sin_to_cos,
                          downscale_freq_shift=cfg.freq_shift).to(dtype)
    temb = ops.linear(temb, p["time_embedding.linear_1.weight"], p["time_embedding.linear_1.bias"])
    temb = ops.linear(F.silu(temb), p["time_embedding.linear_2.weight"],
                      p["time_embedding.linear_2.bias"])
    if cfg.has_addition_embedding:
        if (text_embeds.shape[-1] == cfg.projection_class_embeddings_input_dim
                and time_ids.shape[-1] == 0):
            # the caller already built the full add-embedding input
            add = text_embeds.to(dtype)
        else:
            tids = ops.time_embed(time_ids.reshape(-1), dim=cfg.addition_time_embed_dim,
                                  flip_sin_to_cos=cfg.flip_sin_to_cos,
                                  downscale_freq_shift=cfg.freq_shift).to(dtype)
            add = torch.cat([text_embeds.to(dtype), tids.reshape(batch, -1)], dim=-1)
        add = ops.linear(add, p["add_embedding.linear_1.weight"], p["add_embedding.linear_1.bias"])
        add = ops.linear(F.silu(add), p["add_embedding.linear_2.weight"],
                         p["add_embedding.linear_2.bias"])
        temb = temb + add
    return temb


def resnet_keys(cfg: UNetConfig) -> list[str]:
    """Every ResnetBlock2D key prefix, in forward order."""
    out = [f"down_blocks.{i}.resnets.{j}" for i in range(len(cfg.down_block_types))
           for j in range(cfg.layers_per_block)]
    out += ["mid_block.resnets.0", "mid_block.resnets.1"]
    out += [f"up_blocks.{i}.resnets.{j}" for i in range(len(cfg.up_block_types))
            for j in range(cfg.layers_per_block + 1)]
    return out


def precompute_time_cond(cfg: UNetConfig, params: dict, timesteps: torch.Tensor,
                         text_embeds: torch.Tensor, time_ids: torch.Tensor,
                         dtype: torch.dtype | None = None) -> dict:
    """Every timestep-conditioned projection, batched over all T steps at
    once: the time MLP, the add embedding and each resnet's time_emb_proj
    run as (T*B)-row GEMMs on ``timesteps`` (T,) against the CFG-doubled
    ``text_embeds`` / ``time_ids`` (B, ...). Returns {resnet_key: (T, B, C)};
    step i passes {resnet_key: (B, C)}, its slice, to
    ``unet_apply(time_cond=...)``. ``dtype``: the model's, by default
    ``text_embeds``'."""
    if dtype is None:
        dtype = text_embeds.dtype
    t_steps, batch = timesteps.shape[0], text_embeds.shape[0]
    temb = _time_embedding(cfg, params, timesteps.repeat_interleave(batch),
                           text_embeds.repeat(t_steps, 1), time_ids.repeat(t_steps, 1), dtype)
    s = F.silu(temb)
    return {key: ops.linear(s, params[f"{key}.time_emb_proj.weight"],
                            params[f"{key}.time_emb_proj.bias"]).reshape(t_steps, batch, -1)
            for key in resnet_keys(cfg)}


def transformer2d_keys(cfg: UNetConfig) -> list[tuple[str, int]]:
    """Every Transformer2DModel key prefix and its depth, in forward order."""
    out: list[tuple[str, int]] = []
    for i, btype in enumerate(cfg.down_block_types):
        if btype == "CrossAttnDownBlock2D":
            for j in range(cfg.layers_per_block):
                out.append((f"down_blocks.{i}.attentions.{j}",
                            cfg.transformer_layers_per_block[i]))
    out.append(("mid_block.attentions.0", cfg.mid_transformer_layers))
    for i, btype in enumerate(cfg.up_block_types):
        if btype == "CrossAttnUpBlock2D":
            depth = tuple(reversed(cfg.transformer_layers_per_block))[i]
            for j in range(cfg.layers_per_block + 1):
                out.append((f"up_blocks.{i}.attentions.{j}", depth))
    return out


def precompute_cross_kv(cfg: UNetConfig, params: dict, encoder_hidden_states):
    """Project the text conditioning through every cross-attention K/V once.

    Returns {"<tf2d key>.transformer_blocks.<k>.attn2": kv}: the fused
    (B, Sk, 2C) projection when the params are fused, else a (k, v) tuple.
    The same ``ops.linear`` the step would run, so the cached step is exact."""
    ctx = encoder_hidden_states
    cache = {}
    for tf_key, depth in transformer2d_keys(cfg):
        for k in range(depth):
            key = f"{tf_key}.transformer_blocks.{k}.attn2"
            if f"{key}.to_kv.weight" in params:
                cache[key] = ops.linear(ctx, params[f"{key}.to_kv.weight"])
            else:
                cache[key] = (ops.linear(ctx, params[f"{key}.to_k.weight"]),
                              ops.linear(ctx, params[f"{key}.to_v.weight"]))
    return cache


def unet_apply(cfg: UNetConfig, params: dict, sample: torch.Tensor,
               timesteps: torch.Tensor, encoder_hidden_states: torch.Tensor | None,
               text_embeds: torch.Tensor, time_ids: torch.Tensor,
               cross_kv: dict | None = None, time_cond: dict | None = None,
               return_cache: bool = False, cache_depth: int = 1):
    """One denoising forward pass.

    sample: (B, H, W, C_in) NHWC latents; timesteps: (B,) or scalar;
    encoder_hidden_states: (B, S, cross_attention_dim), or None when
    ``cross_kv`` (from :func:`precompute_cross_kv`) holds every cross K/V;
    text_embeds: (B, pooled); time_ids: (B, 6); both (B, 0) for a config
    without added conditioning (SD1.x). ``time_cond``: this step's
    {resnet_key: (B, C)} slice of :func:`precompute_time_cond`, which then
    replaces the time embedding. Returns the predicted noise, same shape as
    sample.

    ``return_cache``: also return the hidden state entering up block
    ``len(up) - cache_depth``, right after the preceding upsample (the
    DeepCache split point, shape :func:`deep_cache_shape`): everything below
    the outermost ``cache_depth`` levels reaches the rest of the UNet only
    through it, so :func:`unet_apply_shallow` can reuse it. Returns
    ``(eps, cache)``."""
    return _unet_pass(cfg, params, sample, timesteps, encoder_hidden_states, text_embeds,
                      time_ids, cross_kv, time_cond, cache_depth,
                      keep_cache=return_cache)


def deep_cache_shape(cfg: UNetConfig, batch: int, lat_h: int, lat_w: int,
                     cache_depth: int = 1) -> tuple[int, int, int, int]:
    """The DeepCache feature's shape for a (batch, lat_h, lat_w) latent: it
    enters up block ``len(up) - cache_depth``, so it has
    ``block_out_channels[cache_depth]`` channels at the resolution of level
    ``cache_depth - 1``. A depth outside [1, levels - 1] raises."""
    _check_cache_depth(cfg, cache_depth)
    s = cache_depth - 1
    return (batch, lat_h >> s, lat_w >> s, cfg.block_out_channels[cache_depth])


def _check_cache_depth(cfg: UNetConfig, cache_depth: int) -> None:
    levels = len(cfg.block_out_channels)
    if not 1 <= cache_depth < levels:
        raise ValueError(f"deep_cache depth must be in [1, {levels - 1}] for this "
                         f"{levels}-level UNet, got {cache_depth}")


def unet_apply_shallow(cfg: UNetConfig, params: dict, sample: torch.Tensor,
                       timesteps: torch.Tensor, encoder_hidden_states: torch.Tensor | None,
                       text_embeds: torch.Tensor, time_ids: torch.Tensor,
                       cache: torch.Tensor, cross_kv: dict | None = None,
                       time_cond: dict | None = None, cache_depth: int = 1) -> torch.Tensor:
    """The DeepCache pass: only the outermost ``cache_depth`` levels, with
    ``cache`` (from ``unet_apply(..., return_cache=True)``) in place of
    everything deeper. Runs conv_in and down blocks [0, cache_depth) for
    their skips, then the up path from block ``len(up) - cache_depth`` on.
    On a cache from a full pass on the same inputs it gives that pass's eps
    bit for bit (the shallow levels see the same operands); on a cache of
    an earlier step it is DeepCache's approximation. SDXL's depth-1 pass
    runs no attention."""
    return _unet_pass(cfg, params, sample, timesteps, encoder_hidden_states, text_embeds,
                      time_ids, cross_kv, time_cond, cache_depth, cache=cache)


def _unet_pass(cfg: UNetConfig, p: dict, sample, timesteps, encoder_hidden_states,
               text_embeds, time_ids, cross_kv, time_cond, cache_depth: int, *,
               cache=None, keep_cache: bool = False):
    """The level walk of :func:`unet_apply` (``cache`` None: every level,
    the mid block, the cache kept where ``keep_cache``) and of
    :func:`unet_apply_shallow` (the outermost ``cache_depth`` levels around
    ``cache``)."""
    dtype = sample.dtype
    if cache is not None or keep_cache:
        _check_cache_depth(cfg, cache_depth)
    if timesteps.dim() == 0:
        timesteps = timesteps.expand(sample.shape[0])
    temb = (None if time_cond is not None
            else _time_embedding(cfg, p, timesteps, text_embeds, time_ids, dtype))

    def resnet(key, h):
        return _resnet(p, key, h, temb, cfg, None if time_cond is None else time_cond[key])

    if encoder_hidden_states is None:
        if cross_kv is None:
            raise ValueError("need encoder_hidden_states or cross_kv")
        ctx = None
    else:
        ctx = encoder_hidden_states.to(dtype)

    n = len(cfg.down_block_types)
    down = n if cache is None else cache_depth
    h = ops.conv2d(sample, p["conv_in.weight"], p["conv_in.bias"])
    skips = [h]
    for i in range(down):
        for j in range(cfg.layers_per_block):
            h = resnet(f"down_blocks.{i}.resnets.{j}", h)
            if cfg.down_block_types[i] == "CrossAttnDownBlock2D":
                h = _transformer2d(p, f"down_blocks.{i}.attentions.{j}", h, ctx, cfg,
                                   cfg.transformer_layers_per_block[i], cross_kv=cross_kv)
            skips.append(h)
        if i < down - 1:
            h = _downsample(p, f"down_blocks.{i}.downsamplers.0", h)
            skips.append(h)

    if cache is None:
        h = resnet("mid_block.resnets.0", h)
        h = _transformer2d(p, "mid_block.attentions.0", h, ctx, cfg,
                           cfg.mid_transformer_layers, cross_kv=cross_kv)
        h = resnet("mid_block.resnets.1", h)
        first = 0
    else:
        h = cache.to(dtype)
        first = n - cache_depth

    kept = None
    up_types = cfg.up_block_types
    for i in range(first, n):
        if keep_cache and i == n - cache_depth:
            kept = h  # the DeepCache split point
        tf_layers = tuple(reversed(cfg.transformer_layers_per_block))[i]
        for j in range(cfg.layers_per_block + 1):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = resnet(f"up_blocks.{i}.resnets.{j}", h)
            if up_types[i] == "CrossAttnUpBlock2D":
                h = _transformer2d(p, f"up_blocks.{i}.attentions.{j}", h, ctx, cfg,
                                   tf_layers, cross_kv=cross_kv)
        if i < n - 1:
            h = _upsample(p, f"up_blocks.{i}.upsamplers.0", h)

    out = ops.gn_conv2d(
        h, p["conv_norm_out.weight"], p["conv_norm_out.bias"],
        p["conv_out.weight"], p["conv_out.bias"],
        num_groups=cfg.norm_num_groups, eps=cfg.norm_eps, gn_act="silu",
    )
    return (out, kept) if keep_cache else out
