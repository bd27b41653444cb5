"""Single-file checkpoints (SGM / A1111 ``.safetensors``) of the SDXL, SD2.x
and SD1.x families.

Counterpart of ``stabletriton_tpu/io/single_file.py``: the original-LDM
("SGM") tensor names are mapped to the diffusers keys the models use, for
every component in the file:

  model.diffusion_model.*              -> UNet (resnet in_layers / out_layers
                                          -> norm1 / conv1 / norm2 / conv2,
                                          block renumbering)
  first_stage_model.*                  -> VAE decoder (mid.attn_1's 1x1
                                          convs -> linears)
  conditioner.embedders.0.transformer.*-> SDXL's CLIP-L (HF names inside)
  conditioner.embedders.1.model.*      -> SDXL's CLIP-bigG (OpenCLIP names:
                                          fused in_proj split into q / k / v,
                                          ln_final -> final_layer_norm, ...)
  cond_stage_model.transformer.*       -> SD1.x's CLIP-L
  cond_stage_model.model.*             -> SD2.x's OpenCLIP-H (as bigG)

then converted to this package's layout by ``convert_state_dict``. OpenCLIP's
``text_projection`` is already (d, proj), this package's linear layout: it
is carried under the ``@pretransposed`` marker past the transposes.
"""

from __future__ import annotations

from pathlib import Path

import torch

from stabletriton_tpu_torch.io.safetensors_io import convert_state_dict, read_safetensors
from stabletriton_tpu_torch.models.unet import UNetConfig

PRETRANSPOSED = "@pretransposed"

# ---------------------------------------------------------------------------
# UNet: SGM -> diffusers names
# ---------------------------------------------------------------------------


def _unet_block_tables(cfg: UNetConfig):
    """input_blocks / output_blocks index -> diffusers module path."""
    in_map: dict[str, str] = {}
    n_levels = len(cfg.block_out_channels)
    idx = 1
    for level in range(n_levels):
        has_attn = cfg.down_block_types[level] == "CrossAttnDownBlock2D"
        for j in range(cfg.layers_per_block):
            in_map[f"input_blocks.{idx}.0"] = f"down_blocks.{level}.resnets.{j}"
            if has_attn:
                in_map[f"input_blocks.{idx}.1"] = f"down_blocks.{level}.attentions.{j}"
            idx += 1
        if level < n_levels - 1:
            in_map[f"input_blocks.{idx}.0.op"] = f"down_blocks.{level}.downsamplers.0.conv"
            idx += 1

    out_map: dict[str, str] = {}
    idx = 0
    for level in range(n_levels):
        has_attn = cfg.up_block_types[level] == "CrossAttnUpBlock2D"
        for j in range(cfg.layers_per_block + 1):
            out_map[f"output_blocks.{idx}.0"] = f"up_blocks.{level}.resnets.{j}"
            if has_attn:
                out_map[f"output_blocks.{idx}.1"] = f"up_blocks.{level}.attentions.{j}"
            if j == cfg.layers_per_block and level < n_levels - 1:
                # the upsampler rides in the level's last output block, in
                # slot 1 (conv-only levels) or 2 (attention levels)
                slot = 2 if has_attn else 1
                out_map[f"output_blocks.{idx}.{slot}.conv"] = f"up_blocks.{level}.upsamplers.0.conv"
            idx += 1
    return in_map, out_map


_RESNET_INNER = {
    "in_layers.0": "norm1",
    "in_layers.2": "conv1",
    "emb_layers.1": "time_emb_proj",
    "out_layers.0": "norm2",
    "out_layers.3": "conv2",
    "skip_connection": "conv_shortcut",
}

_UNET_FIXED = {
    "time_embed.0": "time_embedding.linear_1",
    "time_embed.2": "time_embedding.linear_2",
    "label_emb.0.0": "add_embedding.linear_1",
    "label_emb.0.2": "add_embedding.linear_2",
    "input_blocks.0.0": "conv_in",
    "middle_block.0": "mid_block.resnets.0",
    "middle_block.1": "mid_block.attentions.0",
    "middle_block.2": "mid_block.resnets.1",
    "out.0": "conv_norm_out",
    "out.2": "conv_out",
}


def convert_sgm_unet(sd: dict, cfg: UNetConfig | None = None) -> dict:
    """{SGM UNet name (prefix stripped): tensor} -> diffusers-named dict;
    names the tables do not map are dropped. ``cfg`` defaults to SDXL-base."""
    cfg = cfg or UNetConfig()
    in_map, out_map = _unet_block_tables(cfg)

    def rename(name: str) -> str | None:
        for table in (out_map, in_map, _UNET_FIXED):
            for pre, repl in table.items():
                if name.startswith(pre + "."):
                    rest = name[len(pre) + 1:]
                    for old, new in _RESNET_INNER.items():
                        if rest.startswith(old + "."):
                            rest = new + rest[len(old):]
                            break
                    return f"{repl}.{rest}"
        return None

    out = {}
    for name, t in sd.items():
        new = rename(name)
        if new is not None:
            out[new] = t
    return out


# ---------------------------------------------------------------------------
# VAE decoder: SGM -> diffusers names
# ---------------------------------------------------------------------------


def _vae_resnet(base: str, rest: str) -> str:
    mod, leaf = rest.rsplit(".", 1)
    if mod == "nin_shortcut":
        mod = "conv_shortcut"
    return f"{base}.{mod}.{leaf}"


def convert_sgm_vae_decoder(sd: dict, n_up_levels: int = 4) -> dict:
    """first_stage_model.* (prefix stripped) -> the diffusers-named decoder
    (and post_quant_conv); the encoder's tensors are dropped.

    SGM numbers the decoder's up blocks from the bottom (up.3 runs first in
    a 4-level VAE), diffusers in execution order; the mid attention's q / k /
    v / proj are 1x1 convs there and linears here."""
    out: dict = {}
    attn_ren = {"q": "to_q", "k": "to_k", "v": "to_v", "proj_out": "to_out.0",
                "norm": "group_norm"}
    for name, t in sd.items():
        if name.startswith("post_quant_conv."):
            out[name] = t
            continue
        if not name.startswith("decoder."):
            continue
        rest = name[len("decoder."):]
        parts = rest.split(".")
        if rest.startswith(("conv_in.", "conv_out.")):
            out[f"decoder.{rest}"] = t
        elif rest.startswith("norm_out."):
            out[f"decoder.conv_norm_out.{parts[-1]}"] = t
        elif rest.startswith("mid.block_1."):
            out[_vae_resnet("decoder.mid_block.resnets.0", rest[len("mid.block_1."):])] = t
        elif rest.startswith("mid.block_2."):
            out[_vae_resnet("decoder.mid_block.resnets.1", rest[len("mid.block_2."):])] = t
        elif rest.startswith("mid.attn_1."):
            mod, leaf = rest[len("mid.attn_1."):].rsplit(".", 1)
            new = attn_ren.get(mod)
            if new is None:
                continue
            if new.startswith("to_") and t.ndim == 4:
                t = t.reshape(t.shape[0], t.shape[1])  # 1x1 conv -> linear
            out[f"decoder.mid_block.attentions.0.{new}.{leaf}"] = t
        elif parts[0] == "up":
            level = n_up_levels - 1 - int(parts[1])  # reverse numbering
            if parts[2] == "block":
                out[_vae_resnet(f"decoder.up_blocks.{level}.resnets.{int(parts[3])}",
                                ".".join(parts[4:]))] = t
            elif parts[2] == "upsample":
                out[f"decoder.up_blocks.{level}.upsamplers.0.conv.{parts[-1]}"] = t
    return out


# ---------------------------------------------------------------------------
# OpenCLIP -> HF CLIP names
# ---------------------------------------------------------------------------


def convert_openclip_text(sd: dict) -> dict:
    """An OpenCLIP text tower (prefix stripped: bigG's
    conditioner.embedders.1.model.*, OpenCLIP-H's cond_stage_model.model.*)
    -> HF CLIP names. The fused ``attn.in_proj_*`` (3d, ...) is split into
    q, k and v in that order; ``text_projection``, already (d, proj), is
    keyed with the ``@pretransposed`` marker so no layout change touches it."""
    out: dict = {}
    for name, t in sd.items():
        if name == "token_embedding.weight":
            out["text_model.embeddings.token_embedding.weight"] = t
        elif name == "positional_embedding":
            out["text_model.embeddings.position_embedding.weight"] = t
        elif name.startswith("ln_final."):
            out[f"text_model.final_layer_norm.{name.split('.')[-1]}"] = t
        elif name == "text_projection":
            out["text_projection.weight" + PRETRANSPOSED] = t
        elif name.startswith("transformer.resblocks."):
            parts = name.split(".")
            i, rest, leaf = parts[2], ".".join(parts[3:]), parts[-1]
            pre = f"text_model.encoder.layers.{i}"
            if rest.startswith("ln_1."):
                out[f"{pre}.layer_norm1.{leaf}"] = t
            elif rest.startswith("ln_2."):
                out[f"{pre}.layer_norm2.{leaf}"] = t
            elif rest.startswith("mlp.c_fc."):
                out[f"{pre}.mlp.fc1.{leaf}"] = t
            elif rest.startswith("mlp.c_proj."):
                out[f"{pre}.mlp.fc2.{leaf}"] = t
            elif rest.startswith("attn.in_proj_"):
                kind = "weight" if rest.endswith("weight") else "bias"
                q, k, v = torch.as_tensor(t).chunk(3, dim=0)
                out[f"{pre}.self_attn.q_proj.{kind}"] = q
                out[f"{pre}.self_attn.k_proj.{kind}"] = k
                out[f"{pre}.self_attn.v_proj.{kind}"] = v
            elif rest.startswith("attn.out_proj."):
                out[f"{pre}.self_attn.out_proj.{leaf}"] = t
    return out


# ---------------------------------------------------------------------------
# top level
# ---------------------------------------------------------------------------


def detect_family(tensor_names) -> str:
    """"sdxl" | "sd2" | "sd1" from a single file's tensor names."""
    names = list(tensor_names)
    if any(n.startswith("conditioner.embedders.1.") for n in names):
        return "sdxl"
    if any(n.startswith("cond_stage_model.model.") for n in names):
        return "sd2"
    return "sd1"


_GROUPS = (
    ("model.diffusion_model.", "unet_sgm"),
    ("first_stage_model.", "vae_sgm"),
    ("conditioner.embedders.0.transformer.", "te1"),
    ("conditioner.embedders.1.model.", "te2_openclip"),
    ("cond_stage_model.transformer.", "te1"),       # SD1.x: HF-named CLIP-L
    ("cond_stage_model.model.", "te2_openclip"),    # SD2.x: OpenCLIP-H
)


def _finish(d: dict, *, dtype: torch.dtype | None = None, device=None) -> dict:
    """convert_state_dict, with the ``@pretransposed`` tensors keyed by
    their real names and left in their layout (cast and moved the same)."""
    plain = {k: v for k, v in d.items() if not k.endswith(PRETRANSPOSED)}
    out = convert_state_dict(plain, dtype=dtype, device=device)
    for k, v in d.items():
        if k.endswith(PRETRANSPOSED):
            t = torch.as_tensor(v).detach()
            out[k[: -len(PRETRANSPOSED)]] = t.to(device=device, dtype=dtype)
    return out


def load_single_file(path: str | Path, *, unet_config: UNetConfig | None = None,
                     dtype: torch.dtype | None = None, device="cpu") -> dict:
    """One SGM-format .safetensors -> this package's param dicts, each
    tensor on ``device`` in ``dtype`` (None: the file's):
    {"unet", "vae", "text_encoder", "text_encoder_2"}. SD1.x's encoder is
    "text_encoder", SD2.x's OpenCLIP-H "text_encoder_2" (as SDXL's bigG)."""
    groups: dict[str, dict] = {g: {} for _, g in _GROUPS}
    for name, t in read_safetensors(path).items():
        for prefix, group in _GROUPS:
            if name.startswith(prefix):
                groups[group][name[len(prefix):]] = t
                break
    parts = {
        "unet": convert_sgm_unet(groups["unet_sgm"], unet_config),
        "vae": convert_sgm_vae_decoder(groups["vae_sgm"]),
        "text_encoder": groups["te1"],
        "text_encoder_2": convert_openclip_text(groups["te2_openclip"]),
    }
    return {k: _finish(d, dtype=dtype, device=device) for k, d in parts.items()}
