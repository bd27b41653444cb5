"""The denoise loop: the Euler, Euler-Ancestral, Heun and DPM-Solver++(2M)
solvers with classifier-free guidance, the guidance interval and DeepCache.

Counterpart of ``stabletriton_tpu/runtime/denoise.py``. JAX's ``lax.scan``
becomes a Python loop over the steps, which the pipeline captures whole as
one CUDA graph per signature (``runtime/graphs.py``). Every choice JAX makes
with ``lax.cond`` is a function of the step index and sigma, constants of
the schedule: whether a UNet evaluation runs the CFG pair
(:func:`guided_steps`), whether it is DeepCache's full or shallow pass
(``i % interval == 0``), the solvers' collapses at ``sigma_next == 0``.
So the host decides each of them, and a signature launches the same
kernels at every call.

The CFG pair (uncond first, cond second) runs as one batch-2B UNet call.
With ``guidance_scale <= 1`` the loop runs the cond branch alone, as the JAX
loop does: the conditioning (and the time cache, on its axis 1) is cut to
its cond half once before the loop and each evaluation calls the UNet on
the B un-doubled rows and takes its eps as it is.

A v-prediction UNet's output becomes eps in each evaluation, after the CFG
combine and before any solver or DeepCache sees it
(``scheduler.v_to_eps``), so every solver steps on eps alike.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from stabletriton_tpu_torch.runtime import scheduler as sched

SOLVERS = ("euler", "euler_a", "heun", "dpmpp_2m")


def norm_guidance_interval(guidance_interval, guidance_scale: float):
    """The guidance interval as a signature holds it (the pipeline's program
    key, a request's batching key): a float pair, or None, also where
    ``guidance_scale <= 1`` makes it inert. So a list (from JSON) stays
    hashable, int and float bounds are one signature, and an inert interval
    is the signature of none."""
    if guidance_interval is None or float(guidance_scale) <= 1.0:
        return None
    return (float(guidance_interval[0]), float(guidance_interval[1]))


def norm_deep_cache(deep_cache):
    """The DeepCache knob as a signature holds it: ``(interval, depth)``, or
    None. ``deep_cache=N`` is ``(N, 1)``, the classic split (on SDXL the
    shallow pass runs no attention); ``(N, d)`` recomputes the outermost
    ``d`` levels; a list (from JSON) is the tuple."""
    if deep_cache is None:
        return None
    if isinstance(deep_cache, (tuple, list)):
        interval, depth = deep_cache
        return (int(interval), int(depth))
    return (int(deep_cache), 1)


def guided_steps(sigmas, guidance_scale: float,
                 guidance_interval: tuple[float, float] | None) -> list[bool]:
    """Whether an evaluation at each sigma runs the CFG pair: never with
    ``guidance_scale <= 1``; with ``guidance_interval=(lo, hi)`` where lo <=
    sigma <= hi, compared in float32 as JAX's ``lax.cond`` compares its
    float32 sigmas (a float64 comparison can pick other steps at the
    window's edges)."""
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
                      guidance_interval: tuple[float, float] | None = None,
                      deep_cache: tuple | None = None,
                      prediction_type: str = "epsilon"):
    """Build loop(params, latents, ctx, text_embeds, time_ids[, noise][,
    extra]) -> final latents.

    ``solver``: "euler", "euler_a" (ancestral: ``noise``, (steps, B, H, W,
    C), is required), "heun" (two UNet evaluations a step) or "dpmpp_2m".

    ``unet_step(params, sample2, t2, cond, text_embeds, time_ids[, tc])`` is
    the UNet forward under the caller's binding; ``sample2`` is the
    CFG-doubled batch (the B cond rows alone when an evaluation runs without
    CFG). ``latents``: (B, H, W, C), already scaled by init_noise_sigma.
    ``ctx``/``text_embeds``/``time_ids``: CFG-doubled (2B, ...) conditioning,
    uncond first. ``precompute(params, ctx) -> cond`` runs once before the
    loop (the cross-attention K/V cache); its result replaces ``ctx`` in
    every step. ``precompute_time(params, timesteps, text_embeds, time_ids)``
    runs once before the loop on the (T,) timesteps and returns
    {key: (T, 2B, C)}; step i passes its slice i to the UNet as a 7th
    argument. ``extra`` (inpainting: the latent mask and the masked image's
    latents, (2B, H, W, C'), CFG-doubled, uncond rows first) is
    concatenated *unscaled* after the scaled, CFG-doubled latents on the
    channel axis, in their dtype: its 2B rows on a guided evaluation, its
    cond half on a cond-only one (cut once before the loop under
    ``guidance_scale <= 1``); DeepCache's shallow pass reads it too.

    ``guidance_interval=(sigma_lo, sigma_hi)`` (with ``guidance_scale >
    1``): an evaluation runs the CFG pair only where sigma_lo <= sigma <=
    sigma_hi (:func:`guided_steps`) and the cond branch alone, on the
    conditioning's cond half, elsewhere; None keeps CFG everywhere.

    ``deep_cache=(interval, full_fn, shallow_fn, cache_hwc)`` (DeepCache, Ma
    et al. 2023): step i runs ``full_fn`` (``unet_step``'s arguments with
    the 7th always given, returning (eps, cache)) where ``i % interval ==
    0`` and ``shallow_fn`` (the same, then the carried cache) elsewhere.
    The cache, (2B or B, *cache_hwc) in the latents' dtype, starts as zeros;
    step 0 is always full. Under a guidance interval it stays CFG-doubled,
    uncond rows first: a cond-only full pass refreshes its cond half, a
    cond-only shallow pass reads that half, and the uncond half stays as of
    the last guided full pass. A guided shallow pass before any guided full
    pass thus splices the zeros of the uncond half: the JAX package's
    approximation, kept (pick the window and interval so that a guided step
    is full early).

    Heun's correction evaluation runs at sigma_next, with the next step's
    timestep and time-cache slice, under the guidance window tested at
    sigma_next, and with the step's full / shallow choice: its full pass
    refreshes the cache the next step reads. At the last step (sigma_next
    == 0) the step is the Euler step and JAX's correction evaluation is
    discarded, so this loop does not run it: the result is the same.

    ``prediction_type``: "epsilon" (the UNet's output is eps) or
    "v_prediction" (it is v: the guided output becomes eps at the
    evaluation's unscaled sample and sigma, ``scheduler.v_to_eps``, the
    scalars host constants; Heun's correction converts at its own sigma).
    """
    if solver not in SOLVERS:
        raise ValueError(f"unknown solver {solver!r}; one of {SOLVERS}")
    if prediction_type not in sched.PREDICTION_TYPES:
        raise ValueError(f"unknown prediction_type {prediction_type!r}; "
                         f"one of {sched.PREDICTION_TYPES}")
    v_pred = prediction_type == "v_prediction"
    if deep_cache is not None and int(deep_cache[0]) < 1:
        raise ValueError(f"deep_cache interval must be >= 1: {deep_cache[0]}")
    g = float(guidance_scale)
    no_cfg = g <= 1.0
    sigmas = [float(s) for s in schedule.sigmas]
    timesteps = [float(t) for t in schedule.timesteps]
    n = len(timesteps)
    # an evaluation at sigmas[k] runs the CFG pair where guided[k]: step i's
    # at k = i, Heun's correction at k = i + 1
    guided = guided_steps(sigmas, g, guidance_interval)
    full_at = (None if deep_cache is None else
               [i % int(deep_cache[0]) == 0 for i in range(n)])
    evaluated = guided[:n] + (guided[1:n] if solver == "heun" else [])
    needs_half = not no_cfg and not all(evaluated)

    def loop(params, latents, ctx, text_embeds, time_ids, noise=None, extra=None):
        if solver == "euler_a" and noise is None:
            raise ValueError("euler_a needs per-step noise (steps, *latents.shape)")
        b = latents.shape[0]
        if extra is not None:
            if extra.shape[0] != 2 * b:
                raise ValueError(f"extra has {extra.shape[0]} rows; it is CFG-doubled: {2 * b}")
            extra = extra.to(latents.dtype)  # the UNet input's dtype, cast once
        tc_all = None
        if precompute_time is not None:
            ts = torch.cat([torch.full((1,), t, dtype=torch.float32, device=latents.device)
                            for t in timesteps])
            tc_all = precompute_time(params, ts, text_embeds, time_ids)
        if no_cfg:
            # the (T, 2B, C) time cache holds the batch on axis 1
            ctx, text_embeds, time_ids, extra = (
                _half(x, b) for x in (ctx, text_embeds, time_ids, extra))
            tc_all = None if tc_all is None else {k: v[:, b:] for k, v in tc_all.items()}
        cond = precompute(params, ctx) if precompute is not None else ctx
        conds = (cond, text_embeds, time_ids)
        # the cond half, for the evaluations outside a guidance interval
        half = tuple(_half(x, b) for x in conds) if needs_half else None
        cache = None
        if deep_cache is not None:
            rows = b if no_cfg else 2 * b
            cache = torch.zeros((rows, *deep_cache[3]), dtype=latents.dtype,
                                device=latents.device)
        prev_x0 = (torch.zeros(latents.shape, dtype=torch.float32, device=latents.device)
                   if solver == "dpmpp_2m" else None)

        def evaluate(x, k, full, cache):
            """eps at ``x`` and sigmas[k] (timestep k, time-cache slice k), and
            the cache after: one UNet evaluation, on the CFG pair where
            guided[k], DeepCache's full or shallow pass where ``full`` is not
            None; a v-prediction output converted to eps."""
            inp = sched.scale_model_input(x, sigmas[k])
            tc = None if tc_all is None else {key: v[k] for key, v in tc_all.items()}
            # without CFG the conditioning, time cache and cache are B rows
            # already; a cond-only evaluation under CFG takes their cond halves
            cond_only = not guided[k] and not no_cfg
            args, ext = conds, extra
            if guided[k]:
                inp = torch.cat([inp, inp], dim=0)
            if cond_only:
                args, tc, ext = half, _half(tc, b), _half(extra, b)
            if ext is not None:
                inp = torch.cat([inp, ext], dim=-1)
            tt = torch.full((inp.shape[0],), timesteps[k], dtype=torch.float32,
                            device=inp.device)
            if deep_cache is None:
                eps = (unet_step(params, inp, tt, *args) if tc is None
                       else unet_step(params, inp, tt, *args, tc))
            elif full:
                eps, fresh = deep_cache[1](params, inp, tt, *args, tc)
                fresh = fresh.to(cache.dtype)
                cache = torch.cat([cache[:b], fresh], dim=0) if cond_only else fresh
            else:
                eps = deep_cache[2](params, inp, tt, *args, tc,
                                    cache[b:] if cond_only else cache)
            if guided[k]:
                eps_u, eps_c = eps.chunk(2, dim=0)
                eps = eps_u + g * (eps_c - eps_u)
            if v_pred:
                eps = sched.v_to_eps(x, eps, sigmas[k])
            return eps, cache

        lat = latents
        for i in range(n):
            sigma, sigma_next = sigmas[i], sigmas[i + 1]
            full = None if full_at is None else full_at[i]
            eps, cache = evaluate(lat, i, full, cache)
            if solver == "euler":
                lat = sched.euler_step(lat, eps, sigma, sigma_next)
            elif solver == "euler_a":
                lat = sched.euler_ancestral_step(lat, eps, sigma, sigma_next, noise[i])
            elif solver == "heun":
                eps_next = None
                if np.float32(sigma_next) != 0:  # else JAX's correction is discarded
                    proposal = sched.euler_step(lat, eps, sigma, sigma_next)
                    eps_next, cache = evaluate(proposal, i + 1, full, cache)
                lat = sched.heun_step(lat, eps, eps_next, sigma, sigma_next)
            else:
                sigma_prev = sigmas[i - 1] if i else sigmas[0]
                lat, prev_x0 = sched.dpmpp_2m_step(lat, eps, sigma, sigma_next, prev_x0,
                                                   i > 0, sigma_prev)
        return lat

    loop.num_steps = n
    return loop
