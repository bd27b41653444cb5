"""End-to-end pipelines: txt2img, img2img (from latents or pixels),
inpainting and base + refiner. CLIP -> CFG denoise loop (Euler,
Euler-Ancestral, Heun or DPM-Solver++(2M), with the guidance interval and
DeepCache) -> VAE decode.

SDXL conditions on two encoders (penultimate states, pooled bigG, size
micro-conditioning); the SDXL refiner on bigG alone, with the aesthetic
score in its fifth time id; SD1.x on one (final states, or penultimate with
``clip_skip >= 2``) and nothing added.

Counterpart of ``SDXLPipeline`` and ``TwoStageSDXL`` in
``stabletriton_tpu/runtime/pipeline.py``. JAX traces each program into one
executable. Here the denoise loop (the cross K/V precompute, every step's
UNet evaluations with their CFG combine, the solver's update) is the
executable: on the card it is captured as one CUDA graph per signature at
its first call and replayed at every later one (``runtime/graphs.py``); the
text encoders, the noise, the VAE encode and the VAE decode around it run
eagerly (:meth:`SDXLPipeline._build` says why). The op binding is entered
inside each entry point, on the thread that runs the model, and the model
runs under ``torch.inference_mode()``.

Token ids in, images out: ``io/tokenizer.py`` makes the ids from prompts.

Under a ``runtime/mesh.py`` mesh every rank runs the same call (SPMD): a
rank takes its contiguous rows of the batch ("data"), holds its shards of
the UNet's attention and feed-forward weights ("model"), and returns the
whole batch, all-gathered. With ``ST_TPU_AUTOTUNE=1`` a new signature's
kernel shapes are tuned on the card before its loop is built
(``kernels/autotune.py``).

Each entry point records (``runtime/profiling.py``) a ``pipeline.call`` span
(the anchor of its device intervals where no serving group anchors them)
around ``pipeline.build`` (a new signature's program), then
``pipeline.conditioning`` (the loop's inputs: CLIP, time ids, noise),
``pipeline.loop`` (the graphed loop, with the UNet's ``prediction`` type)
and ``pipeline.decode``, each with its device interval; and the counters
``pipeline.calls`` and ``pipeline.builds``.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from stabletriton_tpu_torch import ops
from ..compile import (
    CompileConfig,
    cast_params,
    fuse_attention_projections,
    quantize_linear_weights,
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
from stabletriton_tpu_torch.runtime import mesh as mesh_mod
from stabletriton_tpu_torch.runtime import profiling
from stabletriton_tpu_torch.runtime import scheduler as sched
from stabletriton_tpu_torch.runtime.denoise import (
    SOLVERS,
    make_denoise_loop,
    norm_deep_cache,
    norm_guidance_interval,
)
from stabletriton_tpu_torch.runtime.graphs import Graphs, on_card
from stabletriton_tpu_torch.runtime.profiling import logger


def _entry(method):
    """A pipeline's entry point in its ``pipeline.call`` span, the anchor of
    its device intervals where no serving group anchors them; counts its
    calls."""

    @functools.wraps(method)
    def call(self, *args, **kwargs):
        profiling.count("pipeline.calls")
        with profiling.span("pipeline.call", anchor=self.device, entry=method.__name__):
            return method(self, *args, **kwargs)

    return call


def _decode_images(vae_config: vae_mod.VAEConfig, vae_params: dict,
                   latents: torch.Tensor) -> torch.Tensor:
    """VAE decode in float32, one image at a time (the decoder's
    full-resolution feature maps cost GBs per 1024^2 image), clipped to
    [-1, 1]."""
    lat = latents.float()
    imgs = [vae_mod.vae_decode(vae_config, vae_params, lat[i:i + 1])
            for i in range(lat.shape[0])]
    return torch.cat(imgs, dim=0).clamp(-1.0, 1.0)


def _encode_images(vae_config: vae_mod.VAEConfig, vae_params: dict, images: torch.Tensor,
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """VAE encode in float32, one image at a time as the decode (each of
    the encoder's 128-channel maps is 512 MiB at 1024^2): the posterior
    mean, or with ``generator`` a sample, drawn image by image."""
    img = images.float()
    lats = [vae_mod.vae_encode(vae_config, vae_params, img[i:i + 1], generator=generator)
            for i in range(img.shape[0])]
    return torch.cat(lats, dim=0)


def latent_mask(mask: torch.Tensor, f: int) -> torch.Tensor:
    """The nearest downsample of a (B, H, W, 1) mask by the VAE's factor f,
    as ``jax.image.resize(..., "nearest")`` takes it: pixel f i + f // 2
    (its half-pixel centres), not f i."""
    return mask[:, f // 2::f, f // 2::f]


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

    The params are fused, cast (and under ``CompileConfig.quantize``
    quantized, under a mesh sharded) once, in ``__post_init__``, and must
    not move afterwards:
    the graphs read them at the addresses they had when each graph was
    captured. Code that replaces params must drop the pipeline's programs
    (``_cache``) with them."""

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
    # multi-rank: a ("data", "model") DeviceMesh (runtime/mesh.make_mesh),
    # entered by every rank with the same calls. Params are sharded at
    # construction (with model > 1 the attention projections stay unfused:
    # a contiguous split of a fused [q|k|v] weight is not head-aligned), a
    # rank runs its rows of each batch, and every rank returns the whole
    # batch
    mesh: Any = None
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
        if self.compile_config.backend != "reference" and self._tp_size() == 1:
            unet = fuse_attention_projections(unet)
        unet = cast_params(unet, self.compile_config)
        mode = self.compile_config.quantize
        if mode:
            # turbo: the eligible weights, already in the compile dtype, as
            # (int8, scale) pairs; the binding takes linear (and under
            # int8_conv conv2d) to the int8 ops
            unet = quantize_linear_weights(unet, min_dim=self.compile_config.quantize_min_dim,
                                           conv=mode == "int8_conv", ff_only=mode == "int8_ff")
        self.params["unet"] = unet
        if self.mesh is not None:
            if self._tp_size() > 1 and self.device.type == "cuda":
                backend = dist.get_backend(self.mesh.get_group(mesh_mod.MODEL_AXIS))
                if backend != "nccl":
                    raise ValueError(
                        f"a tensor-parallel pipeline on the card captures its all-reduces in "
                        f"the denoise loop's graph, and a {backend} group cannot be captured: "
                        f"use NCCL for the mesh's \"model\" axis")
            self.params = {group: mesh_mod.shard_params(p, self.mesh)
                           for group, p in self.params.items()}

    def _tp_size(self) -> int:
        """The tensor-parallel ("model") axis size; 1 off a mesh."""
        return mesh_mod.axis_size(self.mesh, mesh_mod.MODEL_AXIS)

    def _shard_batch(self, batch: int, *arrays):
        """This rank's rows of each array (None stays None) of a batch of
        ``batch``, and how many they are: all of them off a mesh. The
        counterpart of JAX's ``_shard_batch``; there is no ``_decode_chunk``,
        since each rank decodes its own rows, one image at a time, so the
        data axis decodes that many images at once."""
        rows = mesh_mod.batch_slice(batch, self.mesh)
        return rows.stop - rows.start, [None if a is None else a[rows] for a in arrays]

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """The whole batch of a rank's rows, on every rank."""
        return mesh_mod.gather_batch(t, self.mesh)

    def _ensure_tuned(self, batch, lat_h, lat_w, guidance_scale, guidance_interval) -> None:
        """With ST_TPU_AUTOTUNE set, a bf16 pipeline on the card off a
        tensor-parallel mesh: tune every shape of the signature (``batch``
        this rank's rows) that the binding sends to a kernel and the table
        lacks, before its loop is built and captured; the UNet's batch
        multiples are the JAX pipeline's ``cfg_factors`` rule."""
        from stabletriton_tpu_torch.kernels import autotune

        if (not autotune.autotune_enabled() or self.device.type != "cuda"
                or self.compile_config.torch_dtype != torch.bfloat16 or self._tp_size() > 1):
            return
        autotune.ensure_tuned_for(
            resolve_binding(self.compile_config), self.unet_config, lat_h, lat_w, batch,
            torch.bfloat16, autotune.cfg_factors(guidance_scale, guidance_interval),
            fused=self.compile_config.backend != "reference")

    def _check_resolution(self, height: int, width: int) -> None:
        f = self.vae_config.spatial_scale_factor
        unet_div = 2 ** (len(self.unet_config.block_out_channels) - 1)
        step = f * unet_div
        if height % step or width % step:
            raise ValueError(f"height/width must be multiples of {step}; got {height}x{width}")

    def check_txt2img(self, *, height: int, width: int, solver: str = "euler",
                      deep_cache: int | tuple[int, int] | None = None) -> None:
        """Raise the ValueError txt2img raises for these settings, before any
        work on the device: a resolution the VAE and UNet do not divide, an
        unknown solver, a DeepCache interval below 1 or a depth outside the
        UNet's levels. A serving leader on a mesh checks each group's call
        with it before it broadcasts the call to the other ranks."""
        self._check_resolution(height, width)
        if solver not in SOLVERS:
            raise ValueError(f"unknown solver {solver!r}; one of {SOLVERS}")
        deep_cache = norm_deep_cache(deep_cache)
        if deep_cache is not None:
            if deep_cache[0] < 1:
                raise ValueError(f"deep_cache interval must be >= 1: {deep_cache[0]}")
            f = self.vae_config.spatial_scale_factor
            deep_cache_shape(self.unet_config, 1, height // f, width // f,
                             cache_depth=deep_cache[1])

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

    def _one_encoder(self, params, ids, negs):
        """SD1.x's conditioning, CFG-doubled: encoder 1's final states (the
        penultimate ones with ``clip_skip >= 2``), pooled and time ids of
        width 0."""
        dtype = self.compile_config.torch_dtype
        pen, final, _ = clip_mod.clip_apply_chunked(self.clip_config, params["text_encoder"],
                                                    torch.cat([negs, ids]))
        rows = 2 * ids.shape[0]
        return ((pen if self.clip_skip >= 2 else final).to(dtype),
                torch.zeros((rows, 0), dtype=dtype, device=self.device),
                torch.zeros((rows, 0), dtype=torch.float32, device=self.device))

    def _size_ids(self, height, width, rows):
        """SDXL's micro-conditioning [oh, ow, ct, cl, th, tw], (rows, 6)."""
        return torch.tensor([height, width, 0, 0, height, width], dtype=torch.float32,
                            device=self.device).expand(rows, 6)

    def _text_conditioning(self, params, ids1, ids2, neg_ids1, neg_ids2, height, width):
        """(ctx, pooled, time_ids), CFG-doubled (uncond rows first), as
        txt2img and inpaint condition: SDXL on both encoders and the size
        micro-conditioning; SD1.x on encoder 1 alone (``ids2`` is not
        read)."""
        if not self.unet_config.has_addition_embedding:
            return self._one_encoder(params, ids1, neg_ids1)
        dtype = self.compile_config.torch_dtype
        ctx, pooled = clip_mod.encode_sdxl_prompts(
            self.clip_config, params["text_encoder"], self.clip2_config,
            params["text_encoder_2"], torch.cat([neg_ids1, ids1]), torch.cat([neg_ids2, ids2]))
        return ctx.to(dtype), pooled.to(dtype), self._size_ids(height, width, 2 * ids1.shape[0])

    def _img2img_conditioning(self, params, ids1, ids2, neg_ids1, neg_ids2, height, width,
                              aesthetic_scores):
        """(ctx, pooled, time_ids), CFG-doubled, as img2img conditions: a
        model without added conditioning (SD1.x) on one encoder (``ids1``,
        or ``ids2`` where it is None); else bigG's states and pooled output,
        with encoder 1's states before them where ``ids1`` is given and the
        params hold it (SDXL-base as img2img), and bigG's alone otherwise
        (the refiner). The refiner's 5-slot time ids are [oh, ow, ct, cl,
        aesthetic score], one row of ``aesthetic_scores`` (uncond, cond) per
        CFG half; other models take txt2img's 6 slots."""
        ucfg = self.unet_config
        if ucfg.addition_time_embed_dim is None:
            return (self._one_encoder(params, ids2, neg_ids2) if ids1 is None
                    else self._one_encoder(params, ids1, neg_ids1))
        dtype = self.compile_config.torch_dtype
        rows = 2 * ids2.shape[0]
        ctx, _, pooled = clip_mod.clip_apply(self.clip2_config, params["text_encoder_2"],
                                             torch.cat([neg_ids2, ids2]))
        if ids1 is not None and "text_encoder" in params:
            h1, _, _ = clip_mod.clip_apply(self.clip_config, params["text_encoder"],
                                           torch.cat([neg_ids1, ids1]))
            ctx = torch.cat([h1, ctx], dim=-1)
        if (ucfg.projection_class_embeddings_input_dim
                == (self.clip2_config.projection_dim or 0) + 5 * ucfg.addition_time_embed_dim):
            # the refiner's add embedding: pooled + 5 time-id embeddings
            tid = torch.tensor([[height, width, 0, 0, s] for s in aesthetic_scores],
                               dtype=torch.float32, device=self.device)
            time_ids = tid.repeat_interleave(rows // 2, dim=0)
        else:
            time_ids = self._size_ids(height, width, rows)
        return ctx.to(dtype), pooled.to(dtype), time_ids

    def _loop(self, schedule, *, batch, guidance_scale, solver, lat_h, lat_w,
              guidance_interval, deep_cache):
        """A program's denoise loop over ``schedule``, graphed on the
        pipeline's pool; its shapes tuned first (:meth:`_ensure_tuned`)."""
        self._ensure_tuned(batch, lat_h, lat_w, guidance_scale, guidance_interval)
        unet_step, kv_pre, time_pre = self._unet_step_fns()
        return self._graphs.wrap(make_denoise_loop(
            unet_step, schedule, guidance_scale=guidance_scale, solver=solver,
            precompute=kv_pre, precompute_time=time_pre,
            guidance_interval=guidance_interval,
            deep_cache=self._deep_cache_tuple(deep_cache, lat_h, lat_w),
            prediction_type=self.scheduler_config.prediction_type))

    def _program_around(self, loop, loop_inputs, decode: bool, *, batch, schedule, lat_h, lat_w,
                        guidance_scale):
        """program(params, *args): ``loop_inputs(params, *args)`` and the
        graphed ``loop`` on them, under the binding and inference mode, then
        the decode where ``decode``, each in its span; the loop's span
        carries its rows, steps, latent size, guidance scale and the UNet's
        prediction type. It carries ``program.loop`` (whose ``__wrapped__``
        is the eager loop) and ``program.loop_inputs``."""
        binding = resolve_binding(self.compile_config)
        shape = dict(rows=batch, steps=len(schedule.timesteps), lat_h=lat_h, lat_w=lat_w,
                     guidance_scale=guidance_scale,
                     prediction=self.scheduler_config.prediction_type)

        def program(params, *args):
            with torch.inference_mode(), ops.use_backends(binding), mesh_mod.use_mesh(self.mesh):
                with profiling.span("pipeline.conditioning", device=True):
                    inputs = loop_inputs(params, *args)
                with profiling.span("pipeline.loop", device=True, **shape):
                    latents = loop(params["unet"], *inputs)
                if not decode:
                    return latents
                with profiling.span("pipeline.decode", device=True, rows=int(latents.shape[0])):
                    return _decode_images(self.vae_config, params["vae"], latents)

        program.loop, program.loop_inputs = loop, loop_inputs
        return program

    def _build(self, *, batch, height, width, steps, guidance_scale, solver, return_latents,
               guidance_interval=None, deep_cache=None):
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
            reserved in the pool; the f32 encode of img2img_image and
            inpaint likewise (each of its 128-channel maps is 512 MiB at
            1024^2), one image at a time as the decode.

        The program carries its loop (``program.loop``, whose ``__wrapped__``
        is the eager loop) and the eager part that makes the loop's inputs
        (``program.loop_inputs``: latents, ctx, pooled, time ids, and under
        "euler_a" the noise). img2img's and inpaint's programs are made the
        same way."""
        dtype = self.compile_config.torch_dtype
        schedule = sched.make_schedule(self.scheduler_config, steps)
        f = self.vae_config.spatial_scale_factor
        lat_h, lat_w = height // f, width // f
        loop = self._loop(schedule, batch=batch, guidance_scale=guidance_scale, solver=solver,
                          lat_h=lat_h, lat_w=lat_w, guidance_interval=guidance_interval,
                          deep_cache=deep_cache)

        def loop_inputs(params, ids1, ids2, neg_ids1, neg_ids2, seeds):
            """(latents, ctx, pooled, time_ids[, noise]), under the caller's
            binding."""
            ctx, pooled, time_ids = self._text_conditioning(params, ids1, ids2, neg_ids1,
                                                            neg_ids2, height, width)
            shape = (lat_h, lat_w, self.unet_config.in_channels)
            noise = initial_noise(seeds, shape, self.device)
            latents = (noise * schedule.init_noise_sigma).to(dtype)
            if solver == "euler_a":
                return latents, ctx, pooled, time_ids, ancestral_noise(
                    seeds, steps, shape, self.device)
            return latents, ctx, pooled, time_ids

        return self._program_around(loop, loop_inputs, not return_latents, batch=batch,
                                    schedule=schedule, lat_h=lat_h, lat_w=lat_w,
                                    guidance_scale=guidance_scale)

    def _cached(self, sig, build):
        """The program of ``sig``, built by ``build()`` on its first call
        (under the lock: two threads never build one signature twice)."""
        fn = self._cache.get(sig)
        if fn is None:
            with self._lock:
                fn = self._cache.get(sig)
                if fn is None:
                    logger.info("building program for signature %s", sig)
                    profiling.count("pipeline.builds")
                    with profiling.span("pipeline.build", signature=sig):
                        fn = self._cache[sig] = build()
        return fn

    def _program(self, batch, height, width, steps, guidance_scale, solver,
                 return_latents, guidance_interval=None, deep_cache=None):
        sig = (batch, height, width, steps, guidance_scale, solver, return_latents,
               guidance_interval, deep_cache)
        return self._cached(sig, lambda: self._build(
            batch=batch, height=height, width=width, steps=steps, guidance_scale=guidance_scale,
            solver=solver, return_latents=return_latents, guidance_interval=guidance_interval,
            deep_cache=deep_cache))

    def _ids(self, *arrays) -> list[torch.Tensor | None]:
        """Token ids (numpy or tensors) as int64 tensors on the device; None
        stays None."""
        return [None if a is None else torch.as_tensor(np.asarray(a), dtype=torch.long).to(
            self.device) for a in arrays]

    @_entry
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
        captures its denoise loop; later calls replay it. Under a mesh every
        rank makes the same call; image i keeps seed + i on any mesh."""
        self.check_txt2img(height=height, width=width, solver=solver, deep_cache=deep_cache)
        batch = int(ids1.shape[0])
        if neg_ids1 is None:
            neg_ids1 = self.clip_config.empty_prompt_ids(batch, int(ids1.shape[1]))
        if neg_ids2 is None:
            neg_ids2 = self.clip2_config.empty_prompt_ids(batch, int(ids2.shape[1]))
        local, (ids1, ids2, neg_ids1, neg_ids2, seeds) = self._shard_batch(
            batch, ids1, ids2, neg_ids1, neg_ids2, _seed_vector(seed, batch))
        fn = self._program(local, height, width, steps, float(guidance_scale), solver,
                           return_latents,
                           norm_guidance_interval(guidance_interval, guidance_scale),
                           norm_deep_cache(deep_cache))
        return self._gather(fn(self.params, *self._ids(ids1, ids2, neg_ids1, neg_ids2), seeds))

    def warmup(self, *, batch: int = 1, height: int = 1024, width: int = 1024,
               steps: int = 30, guidance_scale: float = 5.0, solver: str = "euler",
               guidance_interval: tuple[float, float] | None = None,
               deep_cache: int | tuple[int, int] | None = None,
               prompt_len: int | None = None) -> None:
        """Build one txt2img signature's program ahead of its first request
        (serving cold-start): on the card also run its denoise loop's eager
        warm-up, capture and instantiate, on the loop inputs of all-zero
        token ids and seeds, so that the first real request of the
        signature replays. Decodes nothing and returns nothing. On the CPU
        nothing is captured, so only the program is built. ``batch`` is the
        whole batch, as txt2img's."""
        self._check_resolution(height, width)
        batch, _ = self._shard_batch(batch)
        fn = self._program(batch, height, width, steps, float(guidance_scale), solver, False,
                           norm_guidance_interval(guidance_interval, guidance_scale),
                           norm_deep_cache(deep_cache))
        if not on_card(torch.empty(0, device=self.device)):
            return
        n1 = prompt_len or self.clip_config.max_position_embeddings
        n2 = prompt_len or self.clip2_config.max_position_embeddings
        ids1 = torch.zeros((batch, n1), dtype=torch.long, device=self.device)
        ids2 = torch.zeros((batch, n2), dtype=torch.long, device=self.device)
        with (torch.inference_mode(), ops.use_backends(resolve_binding(self.compile_config)),
              mesh_mod.use_mesh(self.mesh)):
            fn.loop(self.params["unet"], *fn.loop_inputs(self.params, ids1, ids2, ids1, ids2,
                                                         [0] * batch))

    def _build_img2img(self, *, batch, lat_h, lat_w, steps, start, guidance_scale, solver,
                       aesthetic_scores, decode, guidance_interval=None, deep_cache=None):
        """The img2img program of one signature: the input latents noised to
        sigmas[start], the schedule's steps from ``start`` on, the decode
        where ``decode``. Its loop's static inputs are txt2img's."""
        dtype = self.compile_config.torch_dtype
        full = sched.make_schedule(self.scheduler_config, steps)
        part = sched.Schedule(timesteps=full.timesteps[start:], sigmas=full.sigmas[start:],
                              init_noise_sigma=float(np.sqrt(full.sigmas[start] ** 2 + 1)))
        loop = self._loop(part, batch=batch, guidance_scale=guidance_scale, solver=solver,
                          lat_h=lat_h, lat_w=lat_w, guidance_interval=guidance_interval,
                          deep_cache=deep_cache)
        f = self.vae_config.spatial_scale_factor
        sigma0 = float(part.sigmas[0])

        def loop_inputs(params, latents_in, ids1, ids2, neg_ids1, neg_ids2, seeds):
            """(latents, ctx, pooled, time_ids[, noise]): the latents are
            ``latents_in + noise * sigmas[start]``, the noise drawn per
            image as txt2img's initial noise."""
            ctx, pooled, time_ids = self._img2img_conditioning(
                params, ids1, ids2, neg_ids1, neg_ids2, lat_h * f, lat_w * f, aesthetic_scores)
            shape = tuple(latents_in.shape[1:])
            noise = initial_noise(seeds, shape, self.device)
            latents = (latents_in.float() + noise * sigma0).to(dtype)
            if solver == "euler_a":
                return latents, ctx, pooled, time_ids, ancestral_noise(
                    seeds, steps - start, shape, self.device)
            return latents, ctx, pooled, time_ids

        return self._program_around(loop, loop_inputs, decode, batch=batch, schedule=part,
                                    lat_h=lat_h, lat_w=lat_w, guidance_scale=guidance_scale)

    @_entry
    def img2img(self, latents, ids1, ids2, *, neg_ids1=None, neg_ids2=None,
                steps: int = 30, strength: float = 0.3, guidance_scale: float = 5.0,
                solver: str = "euler", seed=0,
                aesthetic_scores: tuple[float, float] = (2.5, 6.0), decode: bool = True,
                guidance_interval: tuple[float, float] | None = None,
                deep_cache: int | tuple[int, int] | None = None) -> torch.Tensor:
        """Refine clean (scaled) latents (B, h, w, 4): noise them to the
        ``strength`` point of a ``steps``-step schedule and denoise the
        remaining steps (the SDXL refiner, or img2img). ``ids1`` is None for
        a model conditioned on one encoder's ids2 (the refiner);
        ``aesthetic_scores`` (uncond, cond) feed the refiner's fifth time
        id. ``decode=False`` returns the latents. The other knobs as
        txt2img's; the first call of a signature captures its loop."""
        batch, lat_h, lat_w = (int(n) for n in latents.shape[:3])
        start = min(max(steps - int(round(steps * strength)), 0), steps - 1)
        if neg_ids1 is None and ids1 is not None:
            neg_ids1 = self.clip_config.empty_prompt_ids(batch, int(ids1.shape[1]))
        if neg_ids2 is None:
            neg_ids2 = self.clip2_config.empty_prompt_ids(batch, int(ids2.shape[1]))
        local, (latents, ids1, ids2, neg_ids1, neg_ids2, seeds) = self._shard_batch(
            batch, latents, ids1, ids2, neg_ids1, neg_ids2, _seed_vector(seed, batch))
        scores = tuple(float(v) for v in aesthetic_scores)
        gi = norm_guidance_interval(guidance_interval, guidance_scale)
        dc = norm_deep_cache(deep_cache)
        g = float(guidance_scale)
        sig = ("i2i", local, lat_h, lat_w, steps, start, g, solver, scores, decode, gi, dc)
        fn = self._cached(sig, lambda: self._build_img2img(
            batch=local, lat_h=lat_h, lat_w=lat_w, steps=steps, start=start, guidance_scale=g,
            solver=solver, aesthetic_scores=scores, decode=decode, guidance_interval=gi,
            deep_cache=dc))
        latents = torch.as_tensor(latents).to(self.device)
        return self._gather(fn(self.params, latents,
                               *self._ids(ids1, ids2, neg_ids1, neg_ids2), seeds))

    def _require_encoder(self, what: str) -> None:
        if "encoder.conv_in.weight" not in self.params["vae"]:
            raise ValueError(f"params['vae'] has no encoder weights; load the full VAE "
                             f"(vae_encoder_param_shapes) to use {what}")

    def img2img_image(self, image, ids1, ids2, *, encode_seed: int | None = None,
                      **kwargs) -> torch.Tensor:
        """img2img from pixels (B, H, W, 3) in [-1, 1]: the VAE encodes them
        (the posterior mean, or a sample from a generator seeded with
        ``encode_seed``), eagerly and in float32 under the pipeline's
        binding, then :meth:`img2img` refines the latents. Needs the
        encoder's weights ("encoder.*" / "quant_conv.*") in
        ``params["vae"]``."""
        self._require_encoder("image-input img2img")
        gen = (None if encode_seed is None
               else torch.Generator(device=self.device).manual_seed(int(encode_seed)))
        image = torch.as_tensor(image).to(self.device)
        with torch.inference_mode(), ops.use_backends(resolve_binding(self.compile_config)):
            latents = _encode_images(self.vae_config, self.params["vae"], image, gen)
        return self.img2img(latents, ids1, ids2, **kwargs)

    def _build_inpaint(self, *, batch, height, width, steps, guidance_scale, solver,
                       guidance_interval=None, deep_cache=None):
        """The inpainting program of one signature: txt2img's with the
        UNet's 5 extra input channels, the latent mask and the masked
        image's latents, a static input of the loop (``extra``,
        CFG-doubled). The masked image is VAE-encoded eagerly in float32."""
        dtype = self.compile_config.torch_dtype
        schedule = sched.make_schedule(self.scheduler_config, steps)
        f = self.vae_config.spatial_scale_factor
        lat_h, lat_w = height // f, width // f
        loop = self._loop(schedule, batch=batch, guidance_scale=guidance_scale, solver=solver,
                          lat_h=lat_h, lat_w=lat_w, guidance_interval=guidance_interval,
                          deep_cache=deep_cache)

        def loop_inputs(params, image, mask, ids1, ids2, neg_ids1, neg_ids2, seeds):
            """(latents, ctx, pooled, time_ids, noise or None, extra)."""
            ctx, pooled, time_ids = self._text_conditioning(params, ids1, ids2, neg_ids1,
                                                            neg_ids2, height, width)
            maskf = mask.float()
            masked_lat = _encode_images(self.vae_config, params["vae"],
                                        image.float() * (maskf < 0.5))
            extra = torch.cat([latent_mask(maskf, f), masked_lat], dim=-1)
            shape = (lat_h, lat_w, self.vae_config.latent_channels)
            latents = (initial_noise(seeds, shape, self.device)
                       * schedule.init_noise_sigma).to(dtype)
            noise = (ancestral_noise(seeds, steps, shape, self.device)
                     if solver == "euler_a" else None)
            return latents, ctx, pooled, time_ids, noise, torch.cat([extra, extra])

        return self._program_around(loop, loop_inputs, True, batch=batch, schedule=schedule,
                                    lat_h=lat_h, lat_w=lat_w, guidance_scale=guidance_scale)

    @_entry
    def inpaint(self, image, mask, ids1, ids2, *, neg_ids1=None, neg_ids2=None,
                steps: int = 30, guidance_scale: float = 5.0, solver: str = "euler", seed=0,
                guidance_interval: tuple[float, float] | None = None,
                deep_cache: int | tuple[int, int] | None = None) -> torch.Tensor:
        """Inpainting with a 9-channel UNet (4 noisy + 1 mask + 4
        masked-image latent channels): ``image`` (B, H, W, 3) in [-1, 1],
        ``mask`` (B, H, W, 1), 1 where the image is repainted. Needs the
        encoder's weights in ``params["vae"]``. The knobs as txt2img's; the
        first call of a signature captures its loop."""
        if self.unet_config.in_channels != 9:
            raise ValueError(f"inpaint needs a 9-channel inpaint UNet; this model has "
                             f"in_channels={self.unet_config.in_channels}")
        self._require_encoder("inpaint")
        batch, height, width = (int(n) for n in image.shape[:3])
        self._check_resolution(height, width)
        if neg_ids1 is None:
            neg_ids1 = self.clip_config.empty_prompt_ids(batch, int(ids1.shape[1]))
        if neg_ids2 is None:
            neg_ids2 = self.clip2_config.empty_prompt_ids(batch, int(ids2.shape[1]))
        gi = norm_guidance_interval(guidance_interval, guidance_scale)
        dc = norm_deep_cache(deep_cache)
        g = float(guidance_scale)
        local, (image, mask, ids1, ids2, neg_ids1, neg_ids2, seeds) = self._shard_batch(
            batch, image, mask, ids1, ids2, neg_ids1, neg_ids2, _seed_vector(seed, batch))
        sig = ("inpaint", local, height, width, steps, g, solver, gi, dc)
        fn = self._cached(sig, lambda: self._build_inpaint(
            batch=local, height=height, width=width, steps=steps, guidance_scale=g,
            solver=solver, guidance_interval=gi, deep_cache=dc))
        image, mask = (torch.as_tensor(a).to(self.device) for a in (image, mask))
        return self._gather(fn(self.params, image, mask,
                               *self._ids(ids1, ids2, neg_ids1, neg_ids2), seeds))

    def cache_signatures(self):
        return sorted(self._cache, key=repr)


@dataclass
class TwoStageSDXL:
    """Base + refiner, as the JAX package's: the base runs its whole
    txt2img schedule and hands its latents to the refiner, whose img2img
    noises them again to the ``refiner_strength`` point of the same
    schedule, denoises the tail and decodes. Each stage's loop replays its
    own graph; the hand-off is one latent tensor on the device."""

    base: SDXLPipeline
    refiner: SDXLPipeline

    def txt2img(self, ids1, ids2, *, neg_ids1=None, neg_ids2=None, height: int = 1024,
                width: int = 1024, steps: int = 30, refiner_strength: float = 0.25,
                guidance_scale: float = 5.0, solver: str = "euler", seed: int = 0
                ) -> torch.Tensor:
        """Images (B, height, width, 3) in [-1, 1]: the base's txt2img
        latents, refined from the ``refiner_strength`` point of the same
        ``steps``-step schedule on bigG's ids (``ids2``) with the seeds
        ``seed + 1 + i``."""
        latents = self.base.txt2img(ids1, ids2, neg_ids1=neg_ids1, neg_ids2=neg_ids2,
                                    height=height, width=width, steps=steps,
                                    guidance_scale=guidance_scale, solver=solver, seed=seed,
                                    return_latents=True)
        return self.refiner.img2img(latents, None, ids2, neg_ids2=neg_ids2, steps=steps,
                                    strength=refiner_strength, guidance_scale=guidance_scale,
                                    solver=solver, seed=seed + 1)


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
                       params: dict | None = None, device="cpu", mesh=None) -> SDXLPipeline:
    """A structurally complete but tiny pipeline, the CPU-sized test twin of
    the full one: it runs on the CPU unless ``device`` names another (the
    pipeline's own default is the card). ``params`` (optional) replaces the
    seeded random init, e.g. with the JAX package's weights through
    ``io.convert.params_from_numpy``; ``mesh`` shards it (every rank of the
    mesh makes the same pipeline)."""
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
        params=params, device=device, mesh=mesh,
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


def tiny_refiner_configs():
    """(unet, clip, vae) configs of the tiny refiner-shaped test pipeline,
    the same as the JAX package's ``make_tiny_refiner_pipeline``: one
    encoder (bigG's slot), the 5-slot time ids, conv-only innermost level."""
    c2 = clip_mod.CLIPTextConfig(
        vocab_size=100, hidden_size=32, num_layers=2, num_heads=4, intermediate_size=32,
        max_position_embeddings=16, projection_dim=16, eos_token_id=99, bos_token_id=98,
    )
    ucfg = UNetConfig(
        block_out_channels=(32, 64, 64),
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "DownBlock2D"),
        layers_per_block=1,
        transformer_layers_per_block=(1, 1, 1),
        attention_head_dim=16,
        cross_attention_dim=32,
        norm_num_groups=8,
        addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=16 + 5 * 8,
        mid_block_layers=1,
    )
    return ucfg, c2, vae_mod.tiny_vae_config()


def make_tiny_refiner_pipeline(compile_config: CompileConfig | None = None, *,
                               params: dict | None = None, device="cpu") -> SDXLPipeline:
    """A tiny refiner-shaped pipeline, the CPU-sized twin of the SDXL
    refiner's: on the CPU unless ``device`` names another. ``params``
    (optional, groups unet, text_encoder_2 and vae) replaces the seeded
    random init, as in :func:`make_tiny_pipeline`."""
    ucfg, c2, vcfg = tiny_refiner_configs()
    if params is None:
        params = {
            "unet": init_unet_params(ucfg, 10, device=device),
            "text_encoder_2": clip_mod.init_clip_params(c2, 11, device=device),
            "vae": vae_mod.init_vae_params(vcfg, 12, device=device),
        }
    return SDXLPipeline(
        unet_config=ucfg, clip_config=c2, clip2_config=c2, vae_config=vcfg,
        params=params, device=device,
        compile_config=compile_config or CompileConfig(backend="reference", dtype="float32"),
    )
