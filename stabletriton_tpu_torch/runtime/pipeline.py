"""End-to-end txt2img: CLIP -> CFG denoise loop (Euler, Euler-Ancestral, Heun
or DPM-Solver++(2M), with the guidance interval and DeepCache) -> VAE decode.

SDXL conditions on two encoders (penultimate states, pooled bigG, size
micro-conditioning); SD1.x on one (final states, or penultimate with
``clip_skip >= 2``) and nothing added.

Counterpart of ``SDXLPipeline.txt2img`` in ``stabletriton_tpu/runtime/pipeline.py``.
JAX traces the whole program into one executable. Here the denoise loop (the
cross K/V precompute, every step's UNet evaluations with their CFG combine,
the solver's update) is the executable: on the card it is captured as one
CUDA graph per signature at its first call and replayed at every later one
(``runtime/graphs.py``); the text encoders, the noise and the VAE decode
around it run eagerly (:meth:`SDXLPipeline._build` says why). The op binding is entered inside
:meth:`SDXLPipeline.txt2img`, on the thread that runs the model, and the model
runs under ``torch.inference_mode()``.

Token ids in, images out: tokenization stays with the caller.
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from stabletriton_tpu_torch import ops
from ..compile import (
    CompileConfig,
    cast_params,
    fuse_attention_projections,
    resolve_binding,
)
from stabletriton_tpu_torch.models import clip as clip_mod
from stabletriton_tpu_torch.models import vae as vae_mod
from stabletriton_tpu_torch.models.unet import (
    UNetConfig,
    deep_cache_shape,
    init_unet_params,
    precompute_cross_kv,
    precompute_time_cond,
    tiny_unet_config,
    unet_apply,
    unet_apply_shallow,
)
from stabletriton_tpu_torch.runtime import scheduler as sched
from stabletriton_tpu_torch.runtime.denoise import (
    make_denoise_loop,
    norm_deep_cache,
    norm_guidance_interval,
)
from stabletriton_tpu_torch.runtime.graphs import Graphs

logger = logging.getLogger("stabletriton_tpu_torch")


def _decode_images(vae_config: vae_mod.VAEConfig, vae_params: dict,
                   latents: torch.Tensor) -> torch.Tensor:
    """VAE decode in float32, one image at a time (the decoder's
    full-resolution feature maps cost GBs per 1024^2 image), clipped to
    [-1, 1]."""
    lat = latents.float()
    imgs = [vae_mod.vae_decode(vae_config, vae_params, lat[i:i + 1])
            for i in range(lat.shape[0])]
    return torch.cat(imgs, dim=0).clamp(-1.0, 1.0)


def _seed_vector(seed, batch: int) -> list[int]:
    """int -> per-image seeds seed + i; a sequence passes through."""
    arr = np.asarray(seed)
    if arr.ndim == 0:
        arr = int(arr) + np.arange(batch)
    if arr.shape != (batch,):
        raise ValueError(f"need {batch} seeds, got {arr.shape}")
    return [int(s) for s in arr]


def initial_noise(seeds: list[int], shape: tuple[int, ...], device) -> torch.Tensor:
    """(B, *shape) float32 standard normal noise, one generator per image
    seeded by that image's seed: an image never depends on its batch slot."""
    out = []
    for s in seeds:
        gen = torch.Generator(device=device).manual_seed(s)
        out.append(torch.randn(shape, generator=gen, dtype=torch.float32, device=device))
    return torch.stack(out)


def ancestral_noise(seeds: list[int], steps: int, shape: tuple[int, ...], device
                    ) -> torch.Tensor:
    """(steps, B, *shape) float32 standard normal noise for an ancestral
    solver: one chain per image, from a generator seeded by that image's
    seed mixed with 1 (``numpy.random.SeedSequence([seed, 1])``), so the
    chain is disjoint from the image's initial noise and batching never
    changes an image. Its bits are not those of the JAX package's
    ``jax.random`` chain."""
    out = []
    for s in seeds:
        derived = int(np.random.SeedSequence([s, 1]).generate_state(1, np.uint64)[0])
        gen = torch.Generator(device=device).manual_seed(derived)
        out.append(torch.randn((steps, *shape), generator=gen, dtype=torch.float32,
                               device=device))
    return torch.stack(out, dim=1)


@dataclass
class SDXLPipeline:
    """Holds configs and params; builds one txt2img program per signature,
    whose denoise loop replays one CUDA graph on the card.

    The params are fused and cast once, in ``__post_init__``, and must not
    move afterwards: the graphs read them at the addresses they had when
    each graph was captured. Code that replaces params must drop the
    pipeline's programs (``_cache``) with them."""

    unet_config: UNetConfig
    clip_config: clip_mod.CLIPTextConfig
    clip2_config: clip_mod.CLIPTextConfig
    vae_config: vae_mod.VAEConfig
    # unet, text_encoder, vae; and text_encoder_2 for SDXL
    params: dict[str, dict[str, torch.Tensor]]
    compile_config: CompileConfig = field(default_factory=CompileConfig)
    scheduler_config: sched.SchedulerConfig = field(default_factory=sched.SchedulerConfig)
    # single-encoder (SD1.x) configs: condition on the penultimate encoder
    # layer when >= 2, else on the final one
    clip_skip: int = 1
    # the card unless the caller asks for the CPU (the CPU-sized twins below
    # do); with no CUDA device the default raises, it never falls back
    device: Any = "cuda"
    _cache: dict[Any, Any] = field(default_factory=dict, repr=False)
    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False)
    # the memory pool, side stream and replay lock of every program's graph
    _graphs: Graphs = field(default_factory=Graphs, repr=False)

    def __post_init__(self):
        self.device = torch.device(self.device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("SDXLPipeline runs on the CUDA device and torch sees none; "
                               "pass device='cpu' to run on the CPU")
        self.params = dict(self.params)
        unet = self.params["unet"]
        if self.compile_config.backend != "reference":
            unet = fuse_attention_projections(unet)
        self.params["unet"] = cast_params(unet, self.compile_config)

    def _check_resolution(self, height: int, width: int) -> None:
        f = self.vae_config.spatial_scale_factor
        unet_div = 2 ** (len(self.unet_config.block_out_channels) - 1)
        step = f * unet_div
        if height % step or width % step:
            raise ValueError(f"height/width must be multiples of {step}; got {height}x{width}")

    def _unet_step_fns(self):
        """(unet_step, precompute, precompute_time) for make_denoise_loop.
        With ``cache_cross_kv`` (default) the step reads the precomputed
        cross-attention K/V in place of the context; with ``cache_time_cond``
        (opt-in) it reads its slice of the time-conditioning projections,
        batched over all steps before the loop. Either computes what the
        step would."""
        ucfg = self.unet_config
        use_kv = self.compile_config.cache_cross_kv
        use_tc = self.compile_config.cache_time_cond

        def unet_step(unet_params, sample, t, cond, text_embeds, time_ids, tc=None):
            ctx, kv = (None, cond) if use_kv else (cond, None)
            return unet_apply(ucfg, unet_params, sample, t, ctx, text_embeds, time_ids,
                              cross_kv=kv, time_cond=tc)

        def kv_pre(unet_params, ctx):
            return precompute_cross_kv(ucfg, unet_params, ctx)

        def time_pre(unet_params, timesteps, text_embeds, time_ids):
            return precompute_time_cond(ucfg, unet_params, timesteps, text_embeds, time_ids)

        return unet_step, (kv_pre if use_kv else None), (time_pre if use_tc else None)

    def _deep_cache_tuple(self, deep_cache, lat_h, lat_w):
        """make_denoise_loop's ``deep_cache`` for a normalised (interval,
        depth): full and shallow UNet passes bound as :meth:`_unet_step_fns`'
        step is (the cross K/V cache, the time cache), and the cache's
        (H, W, C) from ``deep_cache_shape``."""
        if deep_cache is None:
            return None
        interval, depth = deep_cache
        ucfg = self.unet_config
        use_kv = self.compile_config.cache_cross_kv

        def full_fn(unet_params, sample, t, cond, text_embeds, time_ids, tc=None):
            ctx, kv = (None, cond) if use_kv else (cond, None)
            return unet_apply(ucfg, unet_params, sample, t, ctx, text_embeds, time_ids,
                              cross_kv=kv, time_cond=tc, return_cache=True,
                              cache_depth=depth)

        def shallow_fn(unet_params, sample, t, cond, text_embeds, time_ids, tc, cache):
            ctx, kv = (None, cond) if use_kv else (cond, None)
            return unet_apply_shallow(ucfg, unet_params, sample, t, ctx, text_embeds,
                                      time_ids, cache, cross_kv=kv, time_cond=tc,
                                      cache_depth=depth)

        hwc = deep_cache_shape(ucfg, 1, lat_h, lat_w, cache_depth=depth)[1:]
        return (interval, full_fn, shallow_fn, hwc)

    def _build(self, *, batch, height, width, steps, guidance_scale, solver,
               return_latents, guidance_interval=None, deep_cache=None):
        """The txt2img program for one signature. The denoise loop is a
        graphed callable whose static inputs are the latents, ctx, pooled and
        time ids (and an ancestral solver's noise); the params are read in
        place. Eager around it, each for a reason:

          * CLIP and the time ids: ``torch.tensor(..., device=)`` is a copy
            from the host, which a capture refuses;
          * the initial and ancestral noise: one generator per image, seeded
            per request;
          * the f32 VAE decode: it is device-bound (under 2% idle on an
            H100, PERF.md §5), and its 1024^2 activations would stay
            reserved in the pool.

        The program carries its loop (``program.loop``, whose ``__wrapped__``
        is the eager loop) and the eager part that makes the loop's inputs
        (``program.loop_inputs``: latents, ctx, pooled, time ids, and under
        "euler_a" the noise)."""
        binding = resolve_binding(self.compile_config)
        dtype = self.compile_config.torch_dtype
        schedule = sched.make_schedule(self.scheduler_config, steps)
        ucfg = self.unet_config
        f = self.vae_config.spatial_scale_factor
        lat_h, lat_w = height // f, width // f
        unet_step, kv_pre, time_pre = self._unet_step_fns()
        loop = self._graphs.wrap(make_denoise_loop(
            unet_step, schedule, guidance_scale=guidance_scale, solver=solver,
            precompute=kv_pre, precompute_time=time_pre,
            guidance_interval=guidance_interval,
            deep_cache=self._deep_cache_tuple(deep_cache, lat_h, lat_w)))

        def loop_inputs(params, ids1, ids2, neg_ids1, neg_ids2, seeds):
            """(latents, ctx, pooled, time_ids[, noise]), under the caller's
            binding."""
            ids1_all = torch.cat([neg_ids1, ids1])
            if ucfg.has_addition_embedding:
                # SDXL: dual encoders, penultimate states + pooled bigG
                ctx, pooled = clip_mod.encode_sdxl_prompts(
                    self.clip_config, params["text_encoder"],
                    self.clip2_config, params["text_encoder_2"],
                    ids1_all, torch.cat([neg_ids2, ids2]),
                )
                ctx, pooled = ctx.to(dtype), pooled.to(dtype)
                # SDXL micro-conditioning: [oh, ow, ct, cl, th, tw]
                tid = torch.tensor([height, width, 0, 0, height, width],
                                   dtype=torch.float32, device=self.device)
                time_ids = tid.expand(2 * batch, 6)
            else:
                # SD1.x: one encoder, final (or clip-skipped) states, no
                # added conditioning; ids2 is not read
                pen, final, _ = clip_mod.clip_apply_chunked(
                    self.clip_config, params["text_encoder"], ids1_all)
                ctx = (pen if self.clip_skip >= 2 else final).to(dtype)
                pooled = torch.zeros((2 * batch, 0), dtype=dtype, device=self.device)
                time_ids = torch.zeros((2 * batch, 0), dtype=torch.float32,
                                       device=self.device)
            shape = (lat_h, lat_w, ucfg.in_channels)
            noise = initial_noise(seeds, shape, self.device)
            latents = (noise * schedule.init_noise_sigma).to(dtype)
            if solver == "euler_a":
                return latents, ctx, pooled, time_ids, ancestral_noise(
                    seeds, steps, shape, self.device)
            return latents, ctx, pooled, time_ids

        def program(params, ids1, ids2, neg_ids1, neg_ids2, seeds):
            with torch.inference_mode(), ops.use_backends(binding):
                latents = loop(params["unet"], *loop_inputs(
                    params, ids1, ids2, neg_ids1, neg_ids2, seeds))
                if return_latents:
                    return latents
                return _decode_images(self.vae_config, params["vae"], latents)

        program.loop, program.loop_inputs = loop, loop_inputs
        return program

    def _program(self, batch, height, width, steps, guidance_scale, solver,
                 return_latents, guidance_interval=None, deep_cache=None):
        sig = (batch, height, width, steps, guidance_scale, solver, return_latents,
               guidance_interval, deep_cache)
        fn = self._cache.get(sig)
        if fn is None:
            with self._lock:
                fn = self._cache.get(sig)
                if fn is None:
                    logger.info("building txt2img program for signature %s", sig)
                    fn = self._build(batch=batch, height=height, width=width,
                                     steps=steps, guidance_scale=guidance_scale,
                                     solver=solver, return_latents=return_latents,
                                     guidance_interval=guidance_interval,
                                     deep_cache=deep_cache)
                    self._cache[sig] = fn
        return fn

    def txt2img(self, ids1, ids2, *, neg_ids1=None, neg_ids2=None,
                height: int = 1024, width: int = 1024, steps: int = 30,
                guidance_scale: float = 5.0, solver: str = "euler", seed=0,
                return_latents: bool = False,
                guidance_interval: tuple[float, float] | None = None,
                deep_cache: int | tuple[int, int] | None = None) -> torch.Tensor:
        """Token ids (B, 77) per encoder -> images (B, height, width, 3) in
        [-1, 1] on the pipeline's device (or the final latents).

        A missing negative prompt is the empty prompt "" (BOS, EOS, pad), as
        diffusers tokenizes it. ``seed``: an int (image i gets seed + i) or
        one seed per image. ``solver``: "euler", "euler_a", "heun" or
        "dpmpp_2m". ``guidance_interval=(sigma_lo, sigma_hi)``: CFG only
        inside the sigma window, the cond branch alone outside it.
        ``deep_cache=N`` (DeepCache): the full UNet every N-th step and only
        the outermost level, around the carried deep features, in between;
        ``(N, depth)`` recomputes the outermost ``depth`` levels. Both draft
        knobs compose with each other and with ``guidance_scale <= 1`` (see
        make_denoise_loop). On the card the first call of a signature
        captures its denoise loop; later calls replay it."""
        self._check_resolution(height, width)
        batch = int(ids1.shape[0])
        if neg_ids1 is None:
            neg_ids1 = self.clip_config.empty_prompt_ids(batch, int(ids1.shape[1]))
        if neg_ids2 is None:
            neg_ids2 = self.clip2_config.empty_prompt_ids(batch, int(ids2.shape[1]))
        fn = self._program(batch, height, width, steps, float(guidance_scale), solver,
                           return_latents,
                           norm_guidance_interval(guidance_interval, guidance_scale),
                           norm_deep_cache(deep_cache))
        ids = [torch.as_tensor(np.asarray(a), dtype=torch.long).to(self.device)
               for a in (ids1, ids2, neg_ids1, neg_ids2)]
        return fn(self.params, *ids, _seed_vector(seed, batch))

    def cache_signatures(self):
        return sorted(self._cache, key=repr)


def tiny_configs():
    """(unet, clip1, clip2, vae) configs of the tiny test pipeline, the same
    as the JAX package's ``make_tiny_pipeline``."""
    ucfg = tiny_unet_config()
    c1 = clip_mod.CLIPTextConfig(
        vocab_size=100, hidden_size=ucfg.cross_attention_dim // 2, num_layers=2,
        num_heads=4, intermediate_size=32, max_position_embeddings=16,
        eos_token_id=99, bos_token_id=98,
    )
    c2 = clip_mod.CLIPTextConfig(
        vocab_size=100, hidden_size=ucfg.cross_attention_dim - c1.hidden_size,
        num_layers=2, num_heads=4, intermediate_size=32, max_position_embeddings=16,
        projection_dim=16, eos_token_id=99, bos_token_id=98,
    )
    return ucfg, c1, c2, vae_mod.tiny_vae_config()


def make_tiny_pipeline(compile_config: CompileConfig | None = None, *,
                       params: dict | None = None, device="cpu") -> SDXLPipeline:
    """A structurally complete but tiny pipeline, the CPU-sized test twin of
    the full one: it runs on the CPU unless ``device`` names another (the
    pipeline's own default is the card). ``params`` (optional) replaces the
    seeded random init, e.g. with the JAX package's weights through
    ``io.convert.params_from_numpy``."""
    ucfg, c1, c2, vcfg = tiny_configs()
    if params is None:
        params = {
            "unet": init_unet_params(ucfg, 0, device=device),
            "text_encoder": clip_mod.init_clip_params(c1, 1, device=device),
            "text_encoder_2": clip_mod.init_clip_params(c2, 2, device=device),
            "vae": vae_mod.init_vae_params(vcfg, 3, device=device),
        }
    return SDXLPipeline(
        unet_config=ucfg, clip_config=c1, clip2_config=c2, vae_config=vcfg,
        params=params, device=device,
        compile_config=compile_config or CompileConfig(backend="reference", dtype="float32"),
    )


def tiny_sd15_configs():
    """(unet, clip, vae) configs of the tiny SD1.x test pipeline, the same as
    the JAX package's ``make_tiny_sd15_pipeline``: one encoder, 4 heads at
    every level (head dims 8 and 16, which do not pack), no added
    conditioning."""
    c1 = clip_mod.CLIPTextConfig(
        vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
        intermediate_size=32, max_position_embeddings=16, eos_token_id=99, bos_token_id=98,
    )
    ucfg = UNetConfig(
        block_out_channels=(32, 64),
        down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        layers_per_block=1,
        transformer_layers_per_block=(1, 1),
        fixed_num_heads=4,
        cross_attention_dim=c1.hidden_size,
        norm_num_groups=8,
        addition_time_embed_dim=None,
        projection_class_embeddings_input_dim=None,
        mid_block_layers=1,
    )
    return ucfg, c1, vae_mod.tiny_vae_config()


def make_tiny_sd15_pipeline(compile_config: CompileConfig | None = None, *,
                            params: dict | None = None, device="cpu") -> SDXLPipeline:
    """A tiny SD1.x-style pipeline, the CPU-sized test twin: single text
    encoder, fixed head count, no added conditioning; on the CPU unless
    ``device`` names another. ``params`` (optional) replaces the seeded
    random init, as in :func:`make_tiny_pipeline`."""
    ucfg, c1, vcfg = tiny_sd15_configs()
    if params is None:
        params = {
            "unet": init_unet_params(ucfg, 20, device=device),
            "text_encoder": clip_mod.init_clip_params(c1, 21, device=device),
            "vae": vae_mod.init_vae_params(vcfg, 22, device=device),
        }
    return SDXLPipeline(
        unet_config=ucfg, clip_config=c1, clip2_config=c1, vae_config=vcfg,
        params=params, device=device,
        compile_config=compile_config or CompileConfig(backend="reference", dtype="float32"),
    )
