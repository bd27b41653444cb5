"""Plain reference of Stable Diffusion txt2img (SDXL-base and SD1.x).

Written from the published model definitions (diffusers'
UNet2DConditionModel, CLIPTextModel / CLIPTextModelWithProjection,
AutoencoderKL's decoder, EulerDiscreteScheduler with epsilon prediction and
"leading" spacing) in plain PyTorch: matmuls, ``F.linear``, ``F.conv2d``,
``F.group_norm``, ``F.layer_norm`` and a softmax, with TF32 switched off. It
imports nothing of the system under test.

Each model runs in the dtype the configuration states for it
(``cfg["dtypes"]``), as diffusers' pipeline runs a model loaded in that
dtype: the text encoders and the VAE in float32; a UNet in bfloat16 holds
its activations, the latents between steps, its eps and the guidance
combine in bfloat16, accumulates matmuls and convolutions in float32, takes
attention scores and softmax in float32 (as the fused attention kernels
do) and makes the Euler update in float32, rounded back. ``unet_dtype``
overrides the UNet's dtype (float32: the whole pipeline in float32).

Parameters are flat ``{hf_key: tensor}`` dicts with the Diffusers / HF key
names, laid out as the benchmark makes them: conv weights HWIO, linear
weights (in, out), so that one set of tensors feeds both the system and this
reference. A weight is read in the dtype of the activations it meets.

Departures from the published models, shared with the system under test:
SD1.x's ``proj_in`` / ``proj_out`` 1x1 convs are held as (in, out) linears
(the same map), and attention never masks padding (as CLIP in SD does not).
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# configuration helpers (the configuration file's "unet", "text_encoder",
# "text_encoder_2" and "vae" groups are plain dicts)
# ---------------------------------------------------------------------------


def up_block_types(u: dict) -> list[str]:
    up = {"DownBlock2D": "UpBlock2D", "CrossAttnDownBlock2D": "CrossAttnUpBlock2D"}
    return [up[t] for t in reversed(u["down_block_types"])]


def num_heads(u: dict, channels: int) -> int:
    if u.get("fixed_num_heads"):
        return u["fixed_num_heads"]
    return channels // u["attention_head_dim"]


def mid_layers(u: dict) -> int:
    if u.get("mid_block_layers") is not None:
        return u["mid_block_layers"]
    depth = u["transformer_layers_per_block"][0]
    for t, d in zip(u["down_block_types"], u["transformer_layers_per_block"]):
        if t == "CrossAttnDownBlock2D":
            depth = d
    return depth


def has_added_cond(u: dict) -> bool:
    return u.get("projection_class_embeddings_input_dim") is not None


def latent_factor(v: dict) -> int:
    return 2 ** (len(v["block_out_channels"]) - 1)


# ---------------------------------------------------------------------------
# parameter shapes
# ---------------------------------------------------------------------------


class _Shapes:
    def __init__(self):
        self.shapes: dict[str, tuple[int, ...]] = {}

    def conv(self, key, cin, cout, k=3):
        self.shapes[f"{key}.weight"] = (k, k, cin, cout)
        self.shapes[f"{key}.bias"] = (cout,)

    def linear(self, key, cin, cout, bias=True):
        self.shapes[f"{key}.weight"] = (cin, cout)
        if bias:
            self.shapes[f"{key}.bias"] = (cout,)

    def norm(self, key, c):
        self.shapes[f"{key}.weight"] = (c,)
        self.shapes[f"{key}.bias"] = (c,)

    def resnet(self, key, cin, cout, temb=None):
        self.norm(f"{key}.norm1", cin)
        self.conv(f"{key}.conv1", cin, cout)
        if temb is not None:
            self.linear(f"{key}.time_emb_proj", temb, cout)
        self.norm(f"{key}.norm2", cout)
        self.conv(f"{key}.conv2", cout, cout)
        if cin != cout:
            self.conv(f"{key}.conv_shortcut", cin, cout, k=1)

    def transformer(self, key, c, ctx_dim, layers):
        self.norm(f"{key}.norm", c)
        self.linear(f"{key}.proj_in", c, c)
        for k in range(layers):
            tb = f"{key}.transformer_blocks.{k}"
            self.norm(f"{tb}.norm1", c)
            for p in ("to_q", "to_k", "to_v"):
                self.linear(f"{tb}.attn1.{p}", c, c, bias=False)
            self.linear(f"{tb}.attn1.to_out.0", c, c)
            self.norm(f"{tb}.norm2", c)
            self.linear(f"{tb}.attn2.to_q", c, c, bias=False)
            self.linear(f"{tb}.attn2.to_k", ctx_dim, c, bias=False)
            self.linear(f"{tb}.attn2.to_v", ctx_dim, c, bias=False)
            self.linear(f"{tb}.attn2.to_out.0", c, c)
            self.norm(f"{tb}.norm3", c)
            self.linear(f"{tb}.ff.net.0.proj", c, 8 * c)
            self.linear(f"{tb}.ff.net.2", 4 * c, c)
        self.linear(f"{key}.proj_out", c, c)


def unet_shapes(u: dict) -> dict[str, tuple[int, ...]]:
    b = _Shapes()
    ch = u["block_out_channels"]
    temb = 4 * ch[0]
    ctx = u["cross_attention_dim"]
    b.conv("conv_in", u["in_channels"], ch[0])
    b.linear("time_embedding.linear_1", ch[0], temb)
    b.linear("time_embedding.linear_2", temb, temb)
    if has_added_cond(u):
        b.linear("add_embedding.linear_1", u["projection_class_embeddings_input_dim"], temb)
        b.linear("add_embedding.linear_2", temb, temb)
    skips = [ch[0]]
    cin = ch[0]
    n = len(ch)
    for i, kind in enumerate(u["down_block_types"]):
        for j in range(u["layers_per_block"]):
            b.resnet(f"down_blocks.{i}.resnets.{j}", cin, ch[i], temb)
            cin = ch[i]
            if kind == "CrossAttnDownBlock2D":
                b.transformer(f"down_blocks.{i}.attentions.{j}", ch[i], ctx,
                              u["transformer_layers_per_block"][i])
            skips.append(cin)
        if i < n - 1:
            b.conv(f"down_blocks.{i}.downsamplers.0.conv", cin, cin)
            skips.append(cin)
    b.resnet("mid_block.resnets.0", cin, cin, temb)
    b.transformer("mid_block.attentions.0", cin, ctx, mid_layers(u))
    b.resnet("mid_block.resnets.1", cin, cin, temb)
    rev = list(reversed(ch))
    depths = list(reversed(u["transformer_layers_per_block"]))
    for i, kind in enumerate(up_block_types(u)):
        for j in range(u["layers_per_block"] + 1):
            b.resnet(f"up_blocks.{i}.resnets.{j}", cin + skips.pop(), rev[i], temb)
            cin = rev[i]
            if kind == "CrossAttnUpBlock2D":
                b.transformer(f"up_blocks.{i}.attentions.{j}", cin, ctx, depths[i])
        if i < n - 1:
            b.conv(f"up_blocks.{i}.upsamplers.0.conv", cin, cin)
    b.norm("conv_norm_out", ch[0])
    b.conv("conv_out", ch[0], u["out_channels"])
    return b.shapes


def clip_shapes(c: dict) -> dict[str, tuple[int, ...]]:
    d, inter = c["hidden_size"], c["intermediate_size"]
    s = {
        "text_model.embeddings.token_embedding.weight": (c["vocab_size"], d),
        "text_model.embeddings.position_embedding.weight": (c["max_position_embeddings"], d),
        "text_model.final_layer_norm.weight": (d,),
        "text_model.final_layer_norm.bias": (d,),
    }
    for i in range(c["num_layers"]):
        pre = f"text_model.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            s[f"{pre}.self_attn.{proj}.weight"] = (d, d)
            s[f"{pre}.self_attn.{proj}.bias"] = (d,)
        for ln in ("layer_norm1", "layer_norm2"):
            s[f"{pre}.{ln}.weight"] = (d,)
            s[f"{pre}.{ln}.bias"] = (d,)
        s[f"{pre}.mlp.fc1.weight"] = (d, inter)
        s[f"{pre}.mlp.fc1.bias"] = (inter,)
        s[f"{pre}.mlp.fc2.weight"] = (inter, d)
        s[f"{pre}.mlp.fc2.bias"] = (d,)
    if c.get("projection_dim") is not None:
        s["text_projection.weight"] = (d, c["projection_dim"])
    return s


def vae_decoder_shapes(v: dict) -> dict[str, tuple[int, ...]]:
    b = _Shapes()
    ch = v["block_out_channels"]
    top, lat = ch[-1], v["latent_channels"]
    b.conv("post_quant_conv", lat, lat, k=1)
    b.conv("decoder.conv_in", lat, top)
    b.resnet("decoder.mid_block.resnets.0", top, top)
    b.norm("decoder.mid_block.attentions.0.group_norm", top)
    for proj in ("to_q", "to_k", "to_v", "to_out.0"):
        b.linear(f"decoder.mid_block.attentions.0.{proj}", top, top)
    b.resnet("decoder.mid_block.resnets.1", top, top)
    prev = top
    rev = list(reversed(ch))
    for i, cout in enumerate(rev):
        for j in range(v["layers_per_block"] + 1):
            b.resnet(f"decoder.up_blocks.{i}.resnets.{j}", prev, cout)
            prev = cout
        if i < len(rev) - 1:
            b.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", cout, cout)
    b.norm("decoder.conv_norm_out", ch[0])
    b.conv("decoder.conv_out", ch[0], v["out_channels"])
    return b.shapes


def param_shapes(cfg: dict) -> dict[str, dict[str, tuple[int, ...]]]:
    """Every parameter group of the configuration and its {key: shape}."""
    out = {"unet": unet_shapes(cfg["unet"]), "text_encoder": clip_shapes(cfg["text_encoder"]),
           "vae": vae_decoder_shapes(cfg["vae"])}
    if cfg.get("text_encoder_2"):
        out["text_encoder_2"] = clip_shapes(cfg["text_encoder_2"])
    return out


# ---------------------------------------------------------------------------
# layers (NCHW activations inside, in the dtype of their input)
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def strict_float32():
    """Float32 matmuls and convolutions, without TF32, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def _w(p, key, dtype=torch.float32):
    return p[key].to(dtype)


def _linear(p, key, x, bias=True):
    return F.linear(x, _w(p, f"{key}.weight", x.dtype).t(),
                    _w(p, f"{key}.bias", x.dtype) if bias else None)


def _conv(p, key, x, stride=1, padding=None):
    w = _w(p, f"{key}.weight", x.dtype)
    k = w.shape[0]
    pad = k // 2 if padding is None else padding
    return F.conv2d(x, w.permute(3, 2, 0, 1), _w(p, f"{key}.bias", x.dtype), stride=stride,
                    padding=pad)


def _group_norm(p, key, x, groups, eps):
    return F.group_norm(x, groups, _w(p, f"{key}.weight", x.dtype),
                        _w(p, f"{key}.bias", x.dtype), eps)


def _layer_norm(p, key, x, eps):
    return F.layer_norm(x, (x.shape[-1],), _w(p, f"{key}.weight", x.dtype),
                        _w(p, f"{key}.bias", x.dtype), eps)


def _attend(q, k, v, heads, causal=False):
    """softmax(q k^T / sqrt(d)) v over (B, S, heads*d) operands, one batch
    row at a time so that the scores of a long sequence fit. Scores and
    softmax in float32; the probabilities meet v in its dtype."""
    b, sq, c = q.shape
    d = c // heads
    out = []
    for i in range(b):
        qi = q[i].reshape(sq, heads, d).transpose(0, 1)
        ki = k[i].reshape(-1, heads, d).transpose(0, 1)
        vi = v[i].reshape(-1, heads, d).transpose(0, 1)
        s = (qi.float() @ ki.float().transpose(1, 2)) * (1.0 / math.sqrt(d))
        if causal:
            mask = torch.ones(s.shape[-2:], dtype=torch.bool, device=s.device).triu(1)
            s = s.masked_fill(mask, float("-inf"))
        out.append((torch.softmax(s, dim=-1).to(vi.dtype) @ vi).transpose(0, 1).reshape(sq, c))
    return torch.stack(out)


def sinusoid(t: torch.Tensor, dim: int, flip_sin_to_cos: bool, shift: float) -> torch.Tensor:
    """diffusers' get_timestep_embedding, max period 10000."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device)
    args = t.float()[:, None] * torch.exp(exponent / (half - shift))[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)


# ---------------------------------------------------------------------------
# UNet
# ---------------------------------------------------------------------------


def _unet_resnet(u, p, key, x, temb):
    g, eps = u["norm_num_groups"], u["norm_eps"]
    h = _conv(p, f"{key}.conv1", F.silu(_group_norm(p, f"{key}.norm1", x, g, eps)))
    h = h + _linear(p, f"{key}.time_emb_proj", F.silu(temb))[:, :, None, None]
    h = _conv(p, f"{key}.conv2", F.silu(_group_norm(p, f"{key}.norm2", h, g, eps)))
    skip = _conv(p, f"{key}.conv_shortcut", x) if f"{key}.conv_shortcut.weight" in p else x
    return skip + h


def _unet_transformer(u, p, key, x, ctx, layers):
    n, c, hh, ww = x.shape
    heads = num_heads(u, c)
    eps = u["transformer_norm_eps"]
    h = _group_norm(p, f"{key}.norm", x, u["norm_num_groups"], eps)
    h = _linear(p, f"{key}.proj_in", h.permute(0, 2, 3, 1).reshape(n, hh * ww, c))
    for k in range(layers):
        tb = f"{key}.transformer_blocks.{k}"
        a = _layer_norm(p, f"{tb}.norm1", h, eps)
        o = _attend(_linear(p, f"{tb}.attn1.to_q", a, False), _linear(p, f"{tb}.attn1.to_k", a, False),
                    _linear(p, f"{tb}.attn1.to_v", a, False), heads)
        h = h + _linear(p, f"{tb}.attn1.to_out.0", o)
        a = _layer_norm(p, f"{tb}.norm2", h, eps)
        o = _attend(_linear(p, f"{tb}.attn2.to_q", a, False),
                    _linear(p, f"{tb}.attn2.to_k", ctx, False),
                    _linear(p, f"{tb}.attn2.to_v", ctx, False), heads)
        h = h + _linear(p, f"{tb}.attn2.to_out.0", o)
        a = _layer_norm(p, f"{tb}.norm3", h, eps)
        state, gate = _linear(p, f"{tb}.ff.net.0.proj", a).chunk(2, dim=-1)
        h = h + _linear(p, f"{tb}.ff.net.2", state * F.gelu(gate))
    h = _linear(p, f"{key}.proj_out", h)
    return h.reshape(n, hh, ww, c).permute(0, 3, 1, 2) + x


def unet(u: dict, p: dict, x: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor,
         pooled: torch.Tensor | None, time_ids: torch.Tensor | None) -> torch.Tensor:
    """eps for NCHW latents ``x`` (B, C, h, w) at timesteps ``t`` (B,), in
    the dtype of ``x``."""
    dt = x.dtype
    ch = u["block_out_channels"]
    flip, shift = u["flip_sin_to_cos"], u["freq_shift"]
    ctx = ctx.to(dt)
    temb = sinusoid(t, ch[0], flip, shift).to(dt)
    temb = _linear(p, "time_embedding.linear_2",
                   F.silu(_linear(p, "time_embedding.linear_1", temb)))
    if has_added_cond(u):
        tids = sinusoid(time_ids.reshape(-1), u["addition_time_embed_dim"], flip, shift)
        add = torch.cat([pooled.to(dt), tids.reshape(x.shape[0], -1).to(dt)], dim=-1)
        temb = temb + _linear(p, "add_embedding.linear_2",
                              F.silu(_linear(p, "add_embedding.linear_1", add)))
    n = len(ch)
    h = _conv(p, "conv_in", x)
    skips = [h]
    for i, kind in enumerate(u["down_block_types"]):
        for j in range(u["layers_per_block"]):
            h = _unet_resnet(u, p, f"down_blocks.{i}.resnets.{j}", h, temb)
            if kind == "CrossAttnDownBlock2D":
                h = _unet_transformer(u, p, f"down_blocks.{i}.attentions.{j}", h, ctx,
                                      u["transformer_layers_per_block"][i])
            skips.append(h)
        if i < n - 1:
            h = _conv(p, f"down_blocks.{i}.downsamplers.0.conv", h, stride=2, padding=1)
            skips.append(h)
    h = _unet_resnet(u, p, "mid_block.resnets.0", h, temb)
    h = _unet_transformer(u, p, "mid_block.attentions.0", h, ctx, mid_layers(u))
    h = _unet_resnet(u, p, "mid_block.resnets.1", h, temb)
    depths = list(reversed(u["transformer_layers_per_block"]))
    for i, kind in enumerate(up_block_types(u)):
        for j in range(u["layers_per_block"] + 1):
            h = _unet_resnet(u, p, f"up_blocks.{i}.resnets.{j}",
                             torch.cat([h, skips.pop()], dim=1), temb)
            if kind == "CrossAttnUpBlock2D":
                h = _unet_transformer(u, p, f"up_blocks.{i}.attentions.{j}", h, ctx, depths[i])
        if i < n - 1:
            h = _conv(p, f"up_blocks.{i}.upsamplers.0.conv",
                      F.interpolate(h, scale_factor=2, mode="nearest"))
    h = F.silu(_group_norm(p, "conv_norm_out", h, u["norm_num_groups"], u["norm_eps"]))
    return _conv(p, "conv_out", h)


# ---------------------------------------------------------------------------
# CLIP text encoder
# ---------------------------------------------------------------------------


def clip(c: dict, p: dict, ids: torch.Tensor):
    """ids (B, S) -> (penultimate hidden states, final (after the final
    LayerNorm), pooled projection or None)."""
    ids = ids.long()
    b, s = ids.shape
    eps = c["layer_norm_eps"]
    heads = c["num_heads"]
    x = _w(p, "text_model.embeddings.token_embedding.weight")[ids]
    x = x + _w(p, "text_model.embeddings.position_embedding.weight")[None, :s]
    pen = None
    for i in range(c["num_layers"]):
        pre = f"text_model.encoder.layers.{i}"
        if i == c["num_layers"] - 1:
            pen = x
        h = _layer_norm(p, f"{pre}.layer_norm1", x, eps)
        o = _attend(_linear(p, f"{pre}.self_attn.q_proj", h), _linear(p, f"{pre}.self_attn.k_proj", h),
                    _linear(p, f"{pre}.self_attn.v_proj", h), heads, causal=True)
        x = x + _linear(p, f"{pre}.self_attn.out_proj", o)
        h = _layer_norm(p, f"{pre}.layer_norm2", x, eps)
        h = _linear(p, f"{pre}.mlp.fc1", h)
        h = h * torch.sigmoid(1.702 * h) if c["hidden_act"] == "quick_gelu" else F.gelu(h)
        x = x + _linear(p, f"{pre}.mlp.fc2", h)
    final = _layer_norm(p, "text_model.final_layer_norm", x, eps)
    pooled = None
    if c.get("projection_dim") is not None:
        eos = torch.argmax((ids == c["eos_token_id"]).to(torch.int32), dim=-1)
        pooled = final[torch.arange(b, device=ids.device), eos] @ _w(p, "text_projection.weight")
    return pen, final, pooled


def conditioning(cfg: dict, params: dict, ids1, ids2, neg1, neg2, height, width):
    """(ctx, pooled, time_ids), CFG-doubled with the unconditional rows
    first. SDXL: both encoders' penultimate states side by side, encoder 2's
    pooled projection and the size ids [h, w, 0, 0, h, w]. SD1.x: encoder
    1's final states (penultimate with clip_skip >= 2), nothing added."""
    if not cfg.get("text_encoder_2"):
        pen, final, _ = clip(cfg["text_encoder"], params["text_encoder"],
                             torch.cat([neg1, ids1]))
        return (pen if cfg.get("clip_skip", 1) >= 2 else final), None, None
    h1, _, _ = clip(cfg["text_encoder"], params["text_encoder"], torch.cat([neg1, ids1]))
    h2, _, pooled = clip(cfg["text_encoder_2"], params["text_encoder_2"], torch.cat([neg2, ids2]))
    rows = h1.shape[0]
    time_ids = torch.tensor([height, width, 0, 0, height, width], dtype=torch.float32,
                            device=h1.device).expand(rows, 6)
    return torch.cat([h1, h2], dim=-1), pooled, time_ids


# ---------------------------------------------------------------------------
# VAE decoder
# ---------------------------------------------------------------------------


def _vae_resnet(v, p, key, x):
    g, eps = v["norm_num_groups"], v["norm_eps"]
    h = _conv(p, f"{key}.conv1", F.silu(_group_norm(p, f"{key}.norm1", x, g, eps)))
    h = _conv(p, f"{key}.conv2", F.silu(_group_norm(p, f"{key}.norm2", h, g, eps)))
    skip = _conv(p, f"{key}.conv_shortcut", x) if f"{key}.conv_shortcut.weight" in p else x
    return skip + h


def vae_decode(v: dict, p: dict, latents: torch.Tensor) -> torch.Tensor:
    """Scaled NCHW latents (1, C, h, w) -> NCHW image, clipped to [-1, 1]."""
    z = _conv(p, "post_quant_conv", latents / v["scaling_factor"])
    h = _conv(p, "decoder.conv_in", z)
    h = _vae_resnet(v, p, "decoder.mid_block.resnets.0", h)
    n, c, hh, ww = h.shape
    key = "decoder.mid_block.attentions.0"
    a = _group_norm(p, f"{key}.group_norm", h, v["norm_num_groups"], v["norm_eps"])
    a = a.permute(0, 2, 3, 1).reshape(n, hh * ww, c)
    o = _attend(_linear(p, f"{key}.to_q", a), _linear(p, f"{key}.to_k", a),
                _linear(p, f"{key}.to_v", a), 1)
    o = _linear(p, f"{key}.to_out.0", o)
    h = h + o.reshape(n, hh, ww, c).permute(0, 3, 1, 2)
    h = _vae_resnet(v, p, "decoder.mid_block.resnets.1", h)
    levels = len(v["block_out_channels"])
    for i in range(levels):
        for j in range(v["layers_per_block"] + 1):
            h = _vae_resnet(v, p, f"decoder.up_blocks.{i}.resnets.{j}", h)
        if i < levels - 1:
            h = _conv(p, f"decoder.up_blocks.{i}.upsamplers.0.conv",
                      F.interpolate(h, scale_factor=2, mode="nearest"))
    h = F.silu(_group_norm(p, "decoder.conv_norm_out", h, v["norm_num_groups"], v["norm_eps"]))
    return _conv(p, "decoder.conv_out", h).clamp(-1.0, 1.0)


# ---------------------------------------------------------------------------
# schedule, Euler under CFG, txt2img
# ---------------------------------------------------------------------------


def euler_schedule(s: dict, steps: int) -> tuple[np.ndarray, np.ndarray]:
    """(timesteps (steps,), sigmas (steps + 1,)) as float32, the last sigma
    0: scaled-linear betas, "leading" spacing with the steps offset."""
    n = s["num_train_timesteps"]
    betas = np.linspace(s["beta_start"] ** 0.5, s["beta_end"] ** 0.5, n, dtype=np.float64) ** 2
    cum = np.cumprod(1.0 - betas)
    train = np.sqrt((1.0 - cum) / cum)
    ratio = n // steps
    ts = (np.arange(steps) * ratio).round()[::-1].astype(np.float64) + s["steps_offset"]
    sig = np.interp(ts, np.arange(n), train)
    return ts.astype(np.float32), np.concatenate([sig, [0.0]]).astype(np.float32)


def initial_noise(seed: int, shape_hwc: tuple[int, int, int], device) -> torch.Tensor:
    """The request's standard normal latent noise, drawn (h, w, c) from a
    generator seeded with the request's seed, returned NCHW (1, c, h, w)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    n = torch.randn(shape_hwc, generator=gen, dtype=torch.float32, device=device)
    return n.permute(2, 0, 1)[None]


def txt2img(cfg: dict, params: dict, ids1, ids2, neg1, neg2,
            seeds: list[int], unet_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Images (B, H, W, 3) in [-1, 1], float32, for token ids (B, S) and one
    seed a row: the CFG-doubled conditioning, ``steps`` Euler steps on
    eps = eps_u + g (eps_c - eps_u), then the decode, one image at a time.
    The UNet, the latents and eps in ``unet_dtype`` (the configuration's
    by default). Call inside :func:`strict_float32`."""
    u, v = cfg["unet"], cfg["vae"]
    dt = getattr(torch, cfg["dtypes"]["unet"]) if unet_dtype is None else unet_dtype
    f = latent_factor(v)
    height, width = cfg["height"], cfg["width"]
    device = ids1.device
    ctx, pooled, time_ids = conditioning(cfg, params, ids1, ids2, neg1, neg2, height, width)
    ts, sigmas = euler_schedule(cfg["scheduler"], cfg["steps"])
    init_sigma = float(np.sqrt(sigmas.max() ** 2 + 1))
    shape = (height // f, width // f, u["in_channels"])
    lat = (torch.cat([initial_noise(s, shape, device) for s in seeds]) * init_sigma).to(dt)
    g = float(cfg["guidance_scale"])
    b = lat.shape[0]
    for i in range(cfg["steps"]):
        sigma, nxt = sigmas[i], sigmas[i + 1]
        inp = (lat.float() / float(np.sqrt(sigma * sigma + np.float32(1.0)))).to(dt)
        t = torch.full((2 * b,), float(ts[i]), dtype=torch.float32, device=device)
        eps = unet(u, params["unet"], torch.cat([inp, inp]), t, ctx, pooled, time_ids)
        eps_u, eps_c = eps.chunk(2)
        eps = eps_u + g * (eps_c - eps_u)
        lat = (lat.float() + eps.float() * float(nxt - sigma)).to(dt)
    imgs = [vae_decode(v, params["vae"], lat[i:i + 1].float()) for i in range(b)]
    return torch.cat(imgs).permute(0, 2, 3, 1)
