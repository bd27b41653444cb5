"""Functional CLIP text encoders (SDXL's dual conditioning stack) in PyTorch.

Counterpart of ``stabletriton_tpu/models/clip.py``: a flat
``{hf_key: tensor}`` dict, linear weights (in, out). Causal attention is
plain PyTorch here, as it is plain jnp in the JAX package.

SDXL conditioning contract:
  * per-encoder sequence features = hidden_states[-2] (penultimate layer);
  * pooled = EOS-token hidden state after final_layer_norm @ text_projection
    (encoder 2 only);
  * prompt embedding = concat(enc1_feats, enc2_feats).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -1e30


@dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    projection_dim: int | None = None
    eos_token_id: int = 49407
    bos_token_id: int = 49406
    # padding token of the matching tokenizer; None means "pad with EOS"
    pad_token_id: int | None = None
    layer_norm_eps: float = 1e-5

    def empty_prompt_ids(self, batch: int, total_len: int | None = None) -> np.ndarray:
        """(batch, total_len) ids of the empty prompt "": BOS, EOS, then
        padding, per max_position_embeddings window."""
        mp = self.max_position_embeddings
        total = mp if total_len is None else total_len
        if total % mp:
            raise ValueError(f"prompt length {total} is not a multiple of {mp}")
        pad = self.eos_token_id if self.pad_token_id is None else self.pad_token_id
        row = np.full((mp,), pad, np.int32)
        row[0] = self.bos_token_id
        row[1] = self.eos_token_id
        return np.broadcast_to(np.tile(row, total // mp), (batch, total)).copy()


def sdxl_text_encoder_config() -> CLIPTextConfig:
    """openai/clip-vit-large-patch14 text tower (SDXL text_encoder)."""
    return CLIPTextConfig()


def sdxl_text_encoder_2_config() -> CLIPTextConfig:
    """laion CLIP-bigG text tower (SDXL text_encoder_2)."""
    return CLIPTextConfig(hidden_size=1280, num_layers=32, num_heads=20,
                          intermediate_size=5120, hidden_act="gelu",
                          projection_dim=1280, pad_token_id=0)


def sd15_text_encoder_config() -> CLIPTextConfig:
    """SD1.x text encoder: the same CLIP ViT-L/14 text tower."""
    return CLIPTextConfig()


def sd2_text_encoder_config() -> CLIPTextConfig:
    """SD2.x text encoder: the OpenCLIP ViT-H/14 text tower (1024 wide, 24
    layers, 16 heads, gelu). SD2.x conditions on its penultimate layer
    (the pipeline's ``clip_skip=2``)."""
    return CLIPTextConfig(hidden_size=1024, num_layers=24, num_heads=16,
                          intermediate_size=4096, hidden_act="gelu")


def tiny_clip_config() -> CLIPTextConfig:
    return CLIPTextConfig(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
                          intermediate_size=64, max_position_embeddings=16,
                          projection_dim=24, eos_token_id=99, bos_token_id=98)


def clip_param_shapes(cfg: CLIPTextConfig) -> dict[str, tuple[int, ...]]:
    d, inter = cfg.hidden_size, cfg.intermediate_size
    shapes: dict[str, tuple[int, ...]] = {
        "text_model.embeddings.token_embedding.weight": (cfg.vocab_size, d),
        "text_model.embeddings.position_embedding.weight": (cfg.max_position_embeddings, d),
        "text_model.final_layer_norm.weight": (d,),
        "text_model.final_layer_norm.bias": (d,),
    }
    for i in range(cfg.num_layers):
        pre = f"text_model.encoder.layers.{i}"
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{pre}.self_attn.{proj}.weight"] = (d, d)
            shapes[f"{pre}.self_attn.{proj}.bias"] = (d,)
        for ln in ("layer_norm1", "layer_norm2"):
            shapes[f"{pre}.{ln}.weight"] = (d,)
            shapes[f"{pre}.{ln}.bias"] = (d,)
        shapes[f"{pre}.mlp.fc1.weight"] = (d, inter)
        shapes[f"{pre}.mlp.fc1.bias"] = (inter,)
        shapes[f"{pre}.mlp.fc2.weight"] = (inter, d)
        shapes[f"{pre}.mlp.fc2.bias"] = (d,)
    if cfg.projection_dim is not None:
        shapes["text_projection.weight"] = (d, cfg.projection_dim)
    return shapes


def init_clip_params(cfg: CLIPTextConfig, seed: int = 0, *, device="cpu",
                     dtype=torch.float32) -> dict[str, torch.Tensor]:
    """Random init with the JAX package's distribution, on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in sorted(clip_param_shapes(cfg).items()):
        if name.endswith(".bias"):
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif "layer_norm" in name:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            out[name] = (w / math.sqrt(shape[0])).to(dtype)
    return out


def _act(x, kind: str):
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    if kind == "gelu":
        return F.gelu(x, approximate="none")
    raise ValueError(kind)


def _layer_norm(x, w, b, eps):
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps) * w + b).to(x.dtype)


def _causal_self_attn(p, pre: str, x, cfg: CLIPTextConfig):
    b, s, d = x.shape
    h = cfg.num_heads
    hd = d // h

    def proj(name):
        return x @ p[f"{pre}.self_attn.{name}.weight"] + p[f"{pre}.self_attn.{name}.bias"]

    q = proj("q_proj").reshape(b, s, h, hd).transpose(1, 2)
    k = proj("k_proj").reshape(b, s, h, hd).transpose(1, 2)
    v = proj("v_proj").reshape(b, s, h, hd).transpose(1, 2)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(hd))
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    logits = logits.masked_fill(~causal, NEG_INF)
    w = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(w, v).transpose(1, 2).reshape(b, s, d)
    return out @ p[f"{pre}.self_attn.out_proj.weight"] + p[f"{pre}.self_attn.out_proj.bias"]


def clip_apply(cfg: CLIPTextConfig, params: dict, input_ids: torch.Tensor):
    """input_ids (B, S) -> (penultimate_hidden, final_hidden, pooled_or_None).

    pooled = the final_layer_norm output at argmax(ids == eos), projected."""
    p = params
    b, s = input_ids.shape
    ids = input_ids.long()
    x = p["text_model.embeddings.token_embedding.weight"][ids]
    x = x + p["text_model.embeddings.position_embedding.weight"][None, :s]

    penultimate = None
    for i in range(cfg.num_layers):
        pre = f"text_model.encoder.layers.{i}"
        if i == cfg.num_layers - 1:
            penultimate = x
        h = _layer_norm(x, p[f"{pre}.layer_norm1.weight"], p[f"{pre}.layer_norm1.bias"],
                        cfg.layer_norm_eps)
        x = x + _causal_self_attn(p, pre, h, cfg)
        h = _layer_norm(x, p[f"{pre}.layer_norm2.weight"], p[f"{pre}.layer_norm2.bias"],
                        cfg.layer_norm_eps)
        h = _act(h @ p[f"{pre}.mlp.fc1.weight"] + p[f"{pre}.mlp.fc1.bias"], cfg.hidden_act)
        x = x + (h @ p[f"{pre}.mlp.fc2.weight"] + p[f"{pre}.mlp.fc2.bias"])

    final = _layer_norm(x, p["text_model.final_layer_norm.weight"],
                        p["text_model.final_layer_norm.bias"], cfg.layer_norm_eps)
    pooled = None
    if cfg.projection_dim is not None:
        eos_pos = torch.argmax((ids == cfg.eos_token_id).to(torch.int32), dim=-1)
        pooled_h = final[torch.arange(b, device=final.device), eos_pos]
        pooled = pooled_h @ p["text_projection.weight"]
    return penultimate, final, pooled


def clip_apply_chunked(cfg: CLIPTextConfig, params: dict, ids: torch.Tensor):
    """Long prompts: ids (B, k*max_pos) encode as k independent windows whose
    hidden states are re-concatenated; pooled comes from the first window."""
    b, total = ids.shape
    mp = cfg.max_position_embeddings
    if total % mp:
        raise ValueError(f"prompt length {total} is not a multiple of {mp}")
    k = total // mp
    if k == 1:
        return clip_apply(cfg, params, ids)
    pen, final, pooled = clip_apply(cfg, params, ids.reshape(b * k, mp))
    pen = pen.reshape(b, k * mp, -1)
    final = final.reshape(b, k * mp, -1)
    if pooled is not None:
        pooled = pooled.reshape(b, k, -1)[:, 0]
    return pen, final, pooled


def encode_sdxl_prompts(cfg1: CLIPTextConfig, params1: dict, cfg2: CLIPTextConfig,
                        params2: dict, ids1: torch.Tensor, ids2: torch.Tensor):
    """Dual-encoder SDXL conditioning -> (prompt_embeds (B, S, d1+d2), pooled)."""
    h1, _, _ = clip_apply_chunked(cfg1, params1, ids1)
    h2, _, pooled = clip_apply_chunked(cfg2, params2, ids2)
    return torch.cat([h1, h2], dim=-1), pooled
