"""Functional VAE (AutoencoderKL) in PyTorch: the decoder (latents -> RGB)
and the encoder (RGB -> latents).

Counterpart of ``stabletriton_tpu/models/vae.py``: a flat ``{hf_key:
tensor}`` dict ("decoder.*" / "post_quant_conv.*", and for the encoder
"encoder.*" / "quant_conv.*"), HWIO convs, (in, out) linears, NHWC
activations. The mid-block single-head attention over the whole latent grid
goes through ``ops.attention``, so under the default binding it runs on the
attention kernel (h=1, d=512). The encoder's stride-2 downsamplers (the HF
asymmetric pad, then a valid conv) go to the plain conv, as in the JAX
package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from stabletriton_tpu_torch import ops
from stabletriton_tpu_torch.models.unet import _ShapeBuilder, upsample_nearest2x


@dataclass(frozen=True)
class VAEConfig:
    latent_channels: int = 4
    out_channels: int = 3
    block_out_channels: tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-6
    scaling_factor: float = 0.13025  # SDXL VAE

    @property
    def spatial_scale_factor(self) -> int:
        """Pixels per latent cell (8 for the 4-level SDXL VAE)."""
        return 2 ** (len(self.block_out_channels) - 1)


def sdxl_vae_config() -> VAEConfig:
    return VAEConfig()


def sd15_vae_config() -> VAEConfig:
    """SD1.x/2.x AutoencoderKL: same topology, 0.18215 scaling."""
    return VAEConfig(scaling_factor=0.18215)


def tiny_vae_config() -> VAEConfig:
    return VAEConfig(block_out_channels=(8, 16), norm_num_groups=4, layers_per_block=1)


def _resnet_shapes(b: _ShapeBuilder, key, cin, cout):
    b.norm(f"{key}.norm1", cin)
    b.conv(f"{key}.conv1", cin, cout)
    b.norm(f"{key}.norm2", cout)
    b.conv(f"{key}.conv2", cout, cout)
    if cin != cout:
        b.conv(f"{key}.conv_shortcut", cin, cout, k=1)


def vae_decoder_param_shapes(cfg: VAEConfig) -> dict[str, tuple[int, ...]]:
    b = _ShapeBuilder()
    top = cfg.block_out_channels[-1]
    b.conv("post_quant_conv", cfg.latent_channels, cfg.latent_channels, k=1)
    b.conv("decoder.conv_in", cfg.latent_channels, top)
    _resnet_shapes(b, "decoder.mid_block.resnets.0", top, top)
    b.norm("decoder.mid_block.attentions.0.group_norm", top)
    for proj in ("to_q", "to_k", "to_v", "to_out.0"):
        b.linear(f"decoder.mid_block.attentions.0.{proj}", top, top)
    _resnet_shapes(b, "decoder.mid_block.resnets.1", top, top)
    rev = list(reversed(cfg.block_out_channels))
    prev = top
    for i, cout in enumerate(rev):
        for j in range(cfg.layers_per_block + 1):
            _resnet_shapes(b, f"decoder.up_blocks.{i}.resnets.{j}", prev, cout)
            prev = cout
        if i < len(rev) - 1:
            b.conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", cout, cout)
    b.norm("decoder.conv_norm_out", cfg.block_out_channels[0])
    b.conv("decoder.conv_out", cfg.block_out_channels[0], cfg.out_channels)
    return b.shapes


def vae_encoder_param_shapes(cfg: VAEConfig) -> dict[str, tuple[int, ...]]:
    """The encoder's table (HF "encoder.*" / "quant_conv.*" keys): RGB ->
    posterior moments (mean and log-variance, 2 x latent_channels)."""
    b = _ShapeBuilder()
    ch0, top = cfg.block_out_channels[0], cfg.block_out_channels[-1]
    b.conv("encoder.conv_in", cfg.out_channels, ch0)
    prev = ch0
    for i, cout in enumerate(cfg.block_out_channels):
        for j in range(cfg.layers_per_block):
            _resnet_shapes(b, f"encoder.down_blocks.{i}.resnets.{j}", prev, cout)
            prev = cout
        if i < len(cfg.block_out_channels) - 1:
            b.conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", cout, cout)
    _resnet_shapes(b, "encoder.mid_block.resnets.0", top, top)
    b.norm("encoder.mid_block.attentions.0.group_norm", top)
    for proj in ("to_q", "to_k", "to_v", "to_out.0"):
        b.linear(f"encoder.mid_block.attentions.0.{proj}", top, top)
    _resnet_shapes(b, "encoder.mid_block.resnets.1", top, top)
    b.norm("encoder.conv_norm_out", top)
    b.conv("encoder.conv_out", top, 2 * cfg.latent_channels)
    b.conv("quant_conv", 2 * cfg.latent_channels, 2 * cfg.latent_channels, k=1)
    return b.shapes


def _init(shapes: dict, seed: int, device, dtype) -> dict[str, torch.Tensor]:
    gen = torch.Generator(device=device).manual_seed(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith(".bias"):
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
        elif ".norm" in name or "group_norm" in name:
            out[name] = torch.ones(shape, dtype=dtype, device=device)
        else:
            fan = math.prod(shape[:-1])
            w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
            out[name] = (w / math.sqrt(max(fan, 1))).to(dtype)
    return out


def init_vae_params(cfg: VAEConfig, seed: int = 0, *, device="cpu",
                    dtype=torch.float32) -> dict[str, torch.Tensor]:
    """The decoder's random init with the JAX package's distribution, on
    ``device``."""
    return _init(vae_decoder_param_shapes(cfg), seed, device, dtype)


def init_vae_encoder_params(cfg: VAEConfig, seed: int = 0, *, device="cpu",
                            dtype=torch.float32) -> dict[str, torch.Tensor]:
    """The encoder's random init, as :func:`init_vae_params`; merge it into
    the decoder's dict for a full VAE."""
    return _init(vae_encoder_param_shapes(cfg), seed, device, dtype)


def _resnet(p, key, x, cfg: VAEConfig):
    h = ops.group_norm(x, p[f"{key}.norm1.weight"], p[f"{key}.norm1.bias"],
                       num_groups=cfg.norm_num_groups, eps=cfg.norm_eps, act="silu")
    h = ops.conv2d(h, p[f"{key}.conv1.weight"], p[f"{key}.conv1.bias"])
    h = ops.group_norm(h, p[f"{key}.norm2.weight"], p[f"{key}.norm2.bias"],
                       num_groups=cfg.norm_num_groups, eps=cfg.norm_eps, act="silu")
    if f"{key}.conv_shortcut.weight" in p:
        skip = ops.conv2d(x, p[f"{key}.conv_shortcut.weight"],
                          p[f"{key}.conv_shortcut.bias"], padding=0)
    else:
        skip = x
    return ops.conv2d(h, p[f"{key}.conv2.weight"], p[f"{key}.conv2.bias"], residual=skip)


def _mid_attention(p, key, x, cfg: VAEConfig):
    n, h, w, c = x.shape
    hs = ops.group_norm(x, p[f"{key}.group_norm.weight"], p[f"{key}.group_norm.bias"],
                        num_groups=cfg.norm_num_groups, eps=cfg.norm_eps)
    hs = hs.reshape(n, h * w, c)
    q = ops.linear(hs, p[f"{key}.to_q.weight"], p[f"{key}.to_q.bias"])
    k = ops.linear(hs, p[f"{key}.to_k.weight"], p[f"{key}.to_k.bias"])
    v = ops.linear(hs, p[f"{key}.to_v.weight"], p[f"{key}.to_v.bias"])
    out = ops.attention(q, k, v, num_heads=1)
    out = ops.linear(out, p[f"{key}.to_out.0.weight"], p[f"{key}.to_out.0.bias"])
    return out.reshape(n, h, w, c) + x


def vae_decode(cfg: VAEConfig, params: dict, latents: torch.Tensor) -> torch.Tensor:
    """latents (B, h, w, 4), *scaled* as the denoiser produces them ->
    RGB (B, 8h, 8w, 3), nominally in [-1, 1]."""
    p = params
    z = latents / cfg.scaling_factor
    z = ops.conv2d(z, p["post_quant_conv.weight"], p["post_quant_conv.bias"], padding=0)
    h = ops.conv2d(z, p["decoder.conv_in.weight"], p["decoder.conv_in.bias"])
    h = _resnet(p, "decoder.mid_block.resnets.0", h, cfg)
    h = _mid_attention(p, "decoder.mid_block.attentions.0", h, cfg)
    h = _resnet(p, "decoder.mid_block.resnets.1", h, cfg)
    rev = list(reversed(cfg.block_out_channels))
    for i in range(len(rev)):
        for j in range(cfg.layers_per_block + 1):
            h = _resnet(p, f"decoder.up_blocks.{i}.resnets.{j}", h, cfg)
        if i < len(rev) - 1:
            h = ops.conv2d(upsample_nearest2x(h),
                           p[f"decoder.up_blocks.{i}.upsamplers.0.conv.weight"],
                           p[f"decoder.up_blocks.{i}.upsamplers.0.conv.bias"])
    h = ops.group_norm(h, p["decoder.conv_norm_out.weight"], p["decoder.conv_norm_out.bias"],
                       num_groups=cfg.norm_num_groups, eps=cfg.norm_eps, act="silu")
    return ops.conv2d(h, p["decoder.conv_out.weight"], p["decoder.conv_out.bias"])


def posterior_noise(shape: tuple[int, ...], generator: torch.Generator,
                    device) -> torch.Tensor:
    """The standard normal draw of a sampled encode, float32, from
    ``generator``. Its bits are not those of the JAX package's
    ``jax.random``."""
    return torch.randn(shape, generator=generator, dtype=torch.float32, device=device)


def vae_encode(cfg: VAEConfig, params: dict, images: torch.Tensor, *,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """images (B, H, W, 3) in [-1, 1] -> scaled latents (B, H/8, W/8, 4).

    The posterior mean when ``generator`` is None; else the sample mean +
    exp(0.5 clip(logvar, -30, 20)) * noise (:func:`posterior_noise`)."""
    p = params
    h = ops.conv2d(images, p["encoder.conv_in.weight"], p["encoder.conv_in.bias"])
    for i in range(len(cfg.block_out_channels)):
        for j in range(cfg.layers_per_block):
            h = _resnet(p, f"encoder.down_blocks.{i}.resnets.{j}", h, cfg)
        if i < len(cfg.block_out_channels) - 1:
            # the HF downsampler: pad (0, 1) x (0, 1), then a stride-2 valid conv
            h = ops.conv2d(h, p[f"encoder.down_blocks.{i}.downsamplers.0.conv.weight"],
                           p[f"encoder.down_blocks.{i}.downsamplers.0.conv.bias"],
                           stride=2, padding=((0, 1), (0, 1)))
    h = _resnet(p, "encoder.mid_block.resnets.0", h, cfg)
    h = _mid_attention(p, "encoder.mid_block.attentions.0", h, cfg)
    h = _resnet(p, "encoder.mid_block.resnets.1", h, cfg)
    h = ops.group_norm(h, p["encoder.conv_norm_out.weight"], p["encoder.conv_norm_out.bias"],
                       num_groups=cfg.norm_num_groups, eps=cfg.norm_eps, act="silu")
    h = ops.conv2d(h, p["encoder.conv_out.weight"], p["encoder.conv_out.bias"])
    h = ops.conv2d(h, p["quant_conv.weight"], p["quant_conv.bias"], padding=0)
    mean, logvar = h.chunk(2, dim=-1)
    if generator is not None:
        std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
        mean = mean + std * posterior_noise(tuple(mean.shape), generator, mean.device)
    return mean * cfg.scaling_factor
