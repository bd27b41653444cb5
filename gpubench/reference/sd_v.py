"""Plain reference of Stable Diffusion txt2img for a v-prediction UNet
(SD2.x 768-v: stabilityai/stable-diffusion-2-1).

The model is ``sd.py``'s: the same UNet, text encoder, VAE decoder, Euler
schedule and noise, by import. Only the sampler's reading of the UNet's
output differs: it is v = alpha_t eps - sigma_t x0 (Salimans & Ho 2022), as
the published ``scheduler_config.json`` states ("prediction_type":
"v_prediction"). diffusers' EulerDiscreteScheduler takes it to

    pred_x0 = x / (sigma^2 + 1) - v * sigma / sqrt(sigma^2 + 1)

at the unscaled sample x, and its Euler step moves x along (x - pred_x0) /
sigma, which is eps = x * sigma / (sigma^2 + 1) + v / sqrt(sigma^2 + 1).
The guidance combine runs on v in the UNet's dtype, as diffusers' pipeline
combines the model's output; the conversion and the Euler update run in
float32 (the scheduler upcasts the sample), rounded back to the latents'
dtype once a step. Plain PyTorch, TF32 off; it imports nothing of the
system under test.
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.sd import (  # noqa: F401  (the harness reads these by name)
    conditioning,
    euler_schedule,
    initial_noise,
    latent_factor,
    param_shapes,
    strict_float32,
    unet,
    vae_decode,
)


def v_to_eps(sample: torch.Tensor, v: torch.Tensor, sigma: float) -> torch.Tensor:
    """eps in float32 for the output v at the unscaled sample and sigma."""
    var = float(sigma) ** 2 + 1.0
    return sample.float() * (float(sigma) / var) + v.float() / float(np.sqrt(var))


def txt2img(cfg: dict, params: dict, ids1, ids2, neg1, neg2,
            seeds: list[int], unet_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Images (B, H, W, 3) in [-1, 1], float32, as ``sd.txt2img`` makes
    them, the UNet's output read as v: v = v_u + g (v_c - v_u) in the UNet's
    dtype, then eps from v in float32 and the Euler step on it. Call inside
    :func:`strict_float32`."""
    u, v_cfg = cfg["unet"], cfg["vae"]
    dt = getattr(torch, cfg["dtypes"]["unet"]) if unet_dtype is None else unet_dtype
    f = latent_factor(v_cfg)
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
        out = unet(u, params["unet"], torch.cat([inp, inp]), t, ctx, pooled, time_ids)
        v_u, v_c = out.chunk(2)
        eps = v_to_eps(lat, v_u + g * (v_c - v_u), float(sigma))
        lat = (lat.float() + eps * float(nxt - sigma)).to(dt)
    imgs = [vae_decode(v_cfg, params["vae"], lat[i:i + 1].float()) for i in range(b)]
    return torch.cat(imgs).permute(0, 2, 3, 1)
