"""A live torch module -> this package's parameters and UNet config.

Counterpart of ``stabletriton_tpu/io/torch_ingest.py``, the capture step of
``frontends.diffusers.compile``: read the module's ``config`` (topology) and
``state_dict`` (weights) and rebuild both in this package. The weights stay
on the module's device unless the caller names another, so a module on the
card is ingested on the card.
"""

from __future__ import annotations

from typing import Any

import torch

from stabletriton_tpu_torch.io.safetensors_io import convert_state_dict
from stabletriton_tpu_torch.models.unet import UNetConfig


def state_dict_to_params(module: Any, dtype: torch.dtype | None = None,
                         device=None) -> dict[str, torch.Tensor]:
    """torch module -> param dict (names kept, layout converted), on
    ``device`` (None: where each tensor lies), cast to ``dtype``."""
    return convert_state_dict(module.state_dict(), dtype=dtype, device=device)


def unet_config_from_diffusers(config: Any) -> UNetConfig:
    """A diffusers UNet2DConditionModel config (dict or attributes) ->
    UNetConfig."""
    def get(k, d=None):
        return config.get(k, d) if isinstance(config, dict) else getattr(config, k, d)

    block_out = tuple(get("block_out_channels"))
    tf_layers = get("transformer_layers_per_block", 1)
    if isinstance(tf_layers, int):
        tf_layers = (tf_layers,) * len(block_out)
    # diffusers' legacy naming: attention_head_dim holds the head COUNT. A
    # per-level list (SDXL [5, 10, 20], SD2.x [5, 10, 20, 20]) means a fixed
    # head dim (channels / heads, 64); a scalar (SD1.x: 8) a fixed count.
    heads = get("num_attention_heads") or get("attention_head_dim")
    fixed_num_heads = None
    if isinstance(heads, (list, tuple)):
        head_dim = block_out[-1] // heads[-1]
    else:
        head_dim, fixed_num_heads = 64, int(heads)
    # SD1.x / 2.x have no added conditioning (addition_embed_type None)
    text_time = get("addition_embed_type", "text_time") == "text_time"
    return UNetConfig(
        fixed_num_heads=fixed_num_heads,
        in_channels=get("in_channels", 4),
        out_channels=get("out_channels", 4),
        block_out_channels=block_out,
        down_block_types=tuple(get("down_block_types")),
        layers_per_block=get("layers_per_block", 2),
        transformer_layers_per_block=tuple(tf_layers),
        attention_head_dim=head_dim,
        cross_attention_dim=get("cross_attention_dim", 2048),
        norm_num_groups=get("norm_num_groups", 32),
        norm_eps=get("norm_eps", 1e-5),
        addition_time_embed_dim=get("addition_time_embed_dim", 256) if text_time else None,
        projection_class_embeddings_input_dim=(
            get("projection_class_embeddings_input_dim", 2816) if text_time else None),
        flip_sin_to_cos=get("flip_sin_to_cos", True),
        freq_shift=get("freq_shift", 0.0),
    )
