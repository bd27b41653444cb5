"""The denoise loop: Euler steps with classifier-free guidance.

Counterpart of ``stabletriton_tpu/runtime/denoise.py`` (solver "euler" with
CFG). JAX's ``lax.scan`` becomes a Python loop over the steps, which the
pipeline captures whole as one CUDA graph per signature
(``runtime/graphs.py``): every step's timestep, sigma and branch are
constants of the schedule, decided on the host, so the loop launches the
same kernels on every call. The CFG pair (uncond first, cond second) runs as
one batch-2B UNet call inside each step. With ``guidance_scale <= 1`` the
loop runs the cond branch alone, as the JAX loop does: the conditioning is
cut to its cond half once before the loop and each step calls the UNet on
the B un-doubled rows and takes its eps as it is.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from stabletriton_tpu_torch.runtime import scheduler as sched


def norm_guidance_interval(guidance_interval, guidance_scale: float):
    """The guidance interval as a signature holds it (the pipeline's program
    key, a request's batching key): a float pair, or None, also where
    ``guidance_scale <= 1`` makes it inert. So a list (from JSON) stays
    hashable, int and float bounds are one signature, and an inert interval
    is the signature of none."""
    if guidance_interval is None or float(guidance_scale) <= 1.0:
        return None
    return (float(guidance_interval[0]), float(guidance_interval[1]))


def guided_steps(sigmas, guidance_scale: float,
                 guidance_interval: tuple[float, float] | None) -> list[bool]:
    """Whether each step runs the CFG pair: never with ``guidance_scale <=
    1``; with ``guidance_interval=(lo, hi)`` where lo <= sigma <= hi,
    compared in float32 as JAX's ``lax.cond`` compares its float32 sigmas
    (a float64 comparison can pick other steps at the window's edges)."""
    if guidance_scale <= 1.0:
        return [False] * len(sigmas)
    if guidance_interval is None:
        return [True] * len(sigmas)
    lo, hi = (np.float32(v) for v in guidance_interval)
    return [bool(lo <= np.float32(s) <= hi) for s in sigmas]


def _half(tree, b: int):
    """The cond half (rows b:) of every tensor of a conditioning tree (a
    tensor, a (k, v) tuple, a dict of either, or None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _half(v, b) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_half(v, b) for v in tree)
    return tree[b:]


def make_denoise_loop(unet_step: Callable, schedule: sched.Schedule, *,
                      guidance_scale: float = 5.0, solver: str = "euler",
                      precompute: Callable | None = None,
                      precompute_time: Callable | None = None,
                      guidance_interval: tuple[float, float] | None = None):
    """Build loop(params, latents, ctx, text_embeds, time_ids) -> final latents.

    ``unet_step(params, sample2, t2, cond, text_embeds, time_ids[, tc])`` is
    the UNet forward under the caller's binding; ``sample2`` is the
    CFG-doubled batch (the B cond rows alone when a step runs without CFG).
    ``latents``: (B, H, W, C), already scaled by init_noise_sigma.
    ``ctx``/``text_embeds``/``time_ids``: CFG-doubled (2B, ...) conditioning,
    uncond first. ``precompute(params, ctx) -> cond`` runs once before the
    loop (the cross-attention K/V cache); its result replaces ``ctx`` in
    every step. ``precompute_time(params, timesteps, text_embeds, time_ids)``
    runs once before the loop on the (T,) timesteps and returns
    {key: (T, 2B, C)}; step i passes its slice i to ``unet_step`` as a 7th
    argument.

    ``guidance_interval=(sigma_lo, sigma_hi)`` (with ``guidance_scale >
    1``): a step runs the CFG pair only where sigma_lo <= sigma <= sigma_hi
    (:func:`guided_steps`) and the cond branch alone, on the conditioning's
    cond half, elsewhere; None keeps CFG at every step.
    """
    if solver != "euler":
        raise ValueError(f"unknown solver {solver!r}; this port runs 'euler'")
    g = float(guidance_scale)
    no_cfg = g <= 1.0
    sigmas = [float(s) for s in schedule.sigmas]
    timesteps = [float(t) for t in schedule.timesteps]
    guided = guided_steps(sigmas[:-1], g, guidance_interval)

    def call(params, inp, t, cond, text_embeds, time_ids, tc):
        tt = torch.full((inp.shape[0],), t, dtype=torch.float32, device=inp.device)
        if tc is None:
            return unet_step(params, inp, tt, cond, text_embeds, time_ids)
        return unet_step(params, inp, tt, cond, text_embeds, time_ids, tc)

    def loop(params, latents, ctx, text_embeds, time_ids):
        b = latents.shape[0]
        tc_all = None
        if precompute_time is not None:
            ts = torch.cat([torch.full((1,), t, dtype=torch.float32, device=latents.device)
                            for t in timesteps])
            tc_all = precompute_time(params, ts, text_embeds, time_ids)
        if no_cfg:
            # the (T, 2B, C) time cache holds the batch on axis 1
            ctx, text_embeds, time_ids = (_half(x, b) for x in (ctx, text_embeds, time_ids))
            tc_all = None if tc_all is None else {k: v[:, b:] for k, v in tc_all.items()}
        cond = precompute(params, ctx) if precompute is not None else ctx
        # the cond half, for the steps outside a guidance interval
        half = (None if no_cfg or all(guided) else
                (_half(cond, b), _half(text_embeds, b), _half(time_ids, b)))
        lat = latents
        for i, t in enumerate(timesteps):
            sigma, sigma_next = sigmas[i], sigmas[i + 1]
            tc = None if tc_all is None else {k: v[i] for k, v in tc_all.items()}
            inp = sched.scale_model_input(lat, sigma)
            if guided[i]:
                eps = call(params, torch.cat([inp, inp], dim=0), t, cond, text_embeds,
                           time_ids, tc)
                eps_u, eps_c = eps.chunk(2, dim=0)
                eps = eps_u + g * (eps_c - eps_u)
            elif no_cfg:
                eps = call(params, inp, t, cond, text_embeds, time_ids, tc)
            else:
                eps = call(params, inp, t, *half, _half(tc, b))
            lat = sched.euler_step(lat, eps, sigma, sigma_next)
        return lat

    loop.num_steps = len(timesteps)
    return loop
