"""The denoise loop: Euler steps with classifier-free guidance.

Counterpart of ``stabletriton_tpu/runtime/denoise.py`` (solver "euler" with
CFG). JAX's ``lax.scan`` becomes a Python loop over eager steps. The CFG
pair (uncond first, cond second) runs as one batch-2B UNet call inside each
step, so the UNet always sees one batch shape. With ``guidance_scale <= 1``
the loop runs the cond branch alone, as the JAX loop does: the conditioning
is cut to its cond half once before the loop and each step calls the UNet
on the B un-doubled rows and takes its eps as it is.
"""

from __future__ import annotations

from typing import Callable

import torch

from stabletriton_tpu_torch.runtime import scheduler as sched


def make_denoise_loop(unet_step: Callable, schedule: sched.Schedule, *,
                      guidance_scale: float = 5.0, solver: str = "euler",
                      precompute: Callable | None = None):
    """Build loop(params, latents, ctx, text_embeds, time_ids) -> final latents.

    ``unet_step(params, sample2, t2, cond, text_embeds, time_ids)`` is the
    UNet forward under the caller's binding; ``sample2`` is the CFG-doubled
    batch (the B cond rows alone when ``guidance_scale <= 1``). ``latents``:
    (B, H, W, C), already scaled by init_noise_sigma.
    ``ctx``/``text_embeds``/``time_ids``: CFG-doubled (2B, ...) conditioning,
    uncond first. ``precompute(params, ctx) -> cond`` runs once before the
    loop (the cross-attention K/V cache); its result replaces ``ctx`` in
    every step.
    """
    if solver != "euler":
        raise ValueError(f"unknown solver {solver!r}; this port runs 'euler'")
    g = float(guidance_scale)
    no_cfg = g <= 1.0
    sigmas = [float(s) for s in schedule.sigmas]
    timesteps = [float(t) for t in schedule.timesteps]

    def loop(params, latents, ctx, text_embeds, time_ids):
        if no_cfg:
            b = latents.shape[0]
            ctx, text_embeds, time_ids = ctx[b:], text_embeds[b:], time_ids[b:]
        cond = precompute(params, ctx) if precompute is not None else ctx
        lat = latents
        for i, t in enumerate(timesteps):
            sigma, sigma_next = sigmas[i], sigmas[i + 1]
            inp = sched.scale_model_input(lat, sigma)
            if not no_cfg:
                inp = torch.cat([inp, inp], dim=0)
            tt = torch.full((inp.shape[0],), t, dtype=torch.float32, device=inp.device)
            eps = unet_step(params, inp, tt, cond, text_embeds, time_ids)
            if not no_cfg:
                eps_u, eps_c = eps.chunk(2, dim=0)
                eps = eps_u + g * (eps_c - eps_u)
            lat = sched.euler_step(lat, eps, sigma, sigma_next)
        return lat

    loop.num_steps = len(timesteps)
    return loop
