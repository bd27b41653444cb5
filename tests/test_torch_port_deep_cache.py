"""DeepCache against the JAX package, on the CPU: the model split
(``unet_apply(return_cache=)``, ``deep_cache_shape``,
``unet_apply_shallow``), the denoise loop's carried cache under every
solver, CFG mode and interval, txt2img, ``compile_unet_deepcache`` and the
batching signature.

The same numpy weights and inputs (from seeds) go through both packages in
float32 under the reference binding (the "cuda" binding on CPU tensors runs
the kernels' plain versions). Tolerances:

  * the UNet's eps and cache: 1e-4 against JAX (summation order through the
    tiny UNet, outputs of order 1); the shallow pass against the full pass
    on the same inputs: bit for bit (the same ops on the same operands;
    JAX's own test allows 1e-6);
  * the loop with a stand-in UNet pair (JAX's ``_fake_pair`` idea: the
    cache depends on the conditioning, so a wrong half shows): 2e-6 of the
    largest latent (values to ~20, a few float32 ulps);
  * txt2img's latents on the tiny pipeline: 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu import ops as jops
from stabletriton_tpu.compile import CompileConfig as JCompileConfig
from stabletriton_tpu.compile import compile_unet_deepcache as jcompile_deepcache
from stabletriton_tpu.compile import resolve_binding as jresolve
from stabletriton_tpu.models import clip as jclip
from stabletriton_tpu.models import unet as junet
from stabletriton_tpu.models import vae as jvae
from stabletriton_tpu.runtime import pipeline as jpipe
from stabletriton_tpu.runtime import scheduler as jsched
from stabletriton_tpu.runtime.denoise import make_denoise_loop as jmake_loop
from stabletriton_tpu.runtime.serving import Request as JRequest
from stabletriton_tpu_torch import ops as tops
from stabletriton_tpu_torch.compile import (
    CompileConfig,
    compile_unet_deepcache,
    fuse_attention_projections,
    resolve_binding,
)
from stabletriton_tpu_torch.io.convert import params_from_numpy
from stabletriton_tpu_torch.models import unet as tunet
from stabletriton_tpu_torch.runtime import graphs as tgraphs
from stabletriton_tpu_torch.runtime import pipeline as tpipe
from stabletriton_tpu_torch.runtime import scheduler as tsched
from stabletriton_tpu_torch.runtime.denoise import SOLVERS, norm_deep_cache
from stabletriton_tpu_torch.runtime.denoise import make_denoise_loop as tmake_loop
from stabletriton_tpu_torch.runtime.serving import Request, ServingEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZE = 32
LOOP_TOL = 2e-6
JAX_REFERENCE = jresolve(JCompileConfig(backend="reference"))


def np_init(shapes: dict, seed: int) -> dict:
    """Zero biases, unit norm scales, N(0, 1/fan_in) weights, from numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith(".bias"):
            out[name] = np.zeros(shape, np.float32)
        elif "norm" in name and len(shape) == 1:
            out[name] = np.ones(shape, np.float32)
        else:
            fan = int(np.prod(shape[:-1]))
            out[name] = (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)
    return out


# --------------------------------------------------------------------------
# the model split
# --------------------------------------------------------------------------


def _three_level():
    """JAX's ``test_shallow_parity_depth2`` config: depth 2 keeps the middle
    level's attention live."""
    return tunet.UNetConfig(
        block_out_channels=(32, 48, 64),
        down_block_types=("DownBlock2D", "CrossAttnDownBlock2D", "CrossAttnDownBlock2D"),
        layers_per_block=1, transformer_layers_per_block=(1, 1, 1), attention_head_dim=16,
        cross_attention_dim=32, norm_num_groups=8, addition_time_embed_dim=8,
        projection_class_embeddings_input_dim=8 * 6 + 16)


def _config(family):
    return {"sdxl": lambda: tpipe.tiny_configs()[0], "sd15": lambda: tpipe.tiny_sd15_configs()[0],
            "three_level": _three_level}[family]()


def _step_inputs(tcfg, seed, batch=2, hw=16):
    rng = np.random.default_rng(seed)
    sample = rng.standard_normal((batch, hw, hw, tcfg.in_channels)).astype(np.float32)
    t = np.full((batch,), 400.0, np.float32)
    ehs = rng.standard_normal((batch, 7, tcfg.cross_attention_dim)).astype(np.float32)
    if tcfg.has_addition_embedding:
        pooled = tcfg.projection_class_embeddings_input_dim - 6 * tcfg.addition_time_embed_dim
        te = rng.standard_normal((batch, pooled)).astype(np.float32)
        tid = np.tile(np.asarray([[2 * hw, 2 * hw, 0, 0, 2 * hw, 2 * hw]], np.float32),
                      (batch, 1))
    else:
        te, tid = np.zeros((batch, 0), np.float32), np.zeros((batch, 0), np.float32)
    return sample, t, ehs, te, tid


SPLITS = [("sdxl", 1), ("sd15", 1), ("three_level", 1), ("three_level", 2)]


@pytest.mark.parametrize("family,depth", SPLITS)
def test_split_matches_jax(family, depth):
    """The full pass's eps and cache, and the shallow pass on that cache,
    against JAX's within 1e-4; the cache's shape is ``deep_cache_shape``'s
    (and JAX's); the shallow pass equals the full pass bit for bit."""
    tcfg = _config(family)
    jcfg = junet.UNetConfig(**dataclasses.asdict(tcfg))
    params = np_init(junet.unet_param_shapes(jcfg), 5)
    inputs = _step_inputs(tcfg, 9)
    targs = [torch.from_numpy(a) for a in inputs]
    jargs = [jnp.asarray(a) for a in inputs]
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}

    @jax.jit
    def jax_split(jp, *jargs):
        with jops.use_backends(JAX_REFERENCE):
            eps, cache = junet.unet_apply(jcfg, jp, *jargs, return_cache=True,
                                          cache_depth=depth)
            return eps, cache, junet.unet_apply_shallow(jcfg, jp, *jargs, cache,
                                                        cache_depth=depth)

    jeps, jcache, jshallow = jax_split(jp, *jargs)
    eps, cache = tunet.unet_apply(tcfg, tp, *targs, return_cache=True, cache_depth=depth)
    shallow = tunet.unet_apply_shallow(tcfg, tp, *targs, cache, cache_depth=depth)
    want_shape = tunet.deep_cache_shape(tcfg, 2, 16, 16, depth)
    assert tuple(cache.shape) == want_shape == junet.deep_cache_shape(jcfg, 2, 16, 16, depth)
    for got, want in [(eps, jeps), (cache, jcache), (shallow, jshallow)]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert torch.equal(shallow, eps)
    assert torch.equal(tunet.unet_apply(tcfg, tp, *targs), eps)  # return_cache changes nothing


@pytest.mark.parametrize("family", ["sdxl", "sd15"])
def test_shallow_takes_the_cached_conditioning(family):
    """With the cross K/V cache and the time cache (fused projections, the
    "cuda" binding's plain versions), the shallow pass on the full pass's
    cache equals that pass bit for bit, and the cached full pass equals the
    plain one within 1e-6; a cache of another timestep gives another,
    finite eps (DeepCache's approximation)."""
    tcfg = _config(family)
    params = fuse_attention_projections({k: torch.from_numpy(v) for k, v in np_init(
        junet.unet_param_shapes(junet.UNetConfig(**dataclasses.asdict(tcfg))), 6).items()})
    sample, t, ehs, te, tid = (torch.from_numpy(a) for a in _step_inputs(tcfg, 10))
    with tops.use_backends(resolve_binding(CompileConfig(dtype="float32"))):
        kv = tunet.precompute_cross_kv(tcfg, params, ehs)
        tc = {k: v[0] for k, v in tunet.precompute_time_cond(tcfg, params, t[:1], te,
                                                             tid).items()}
        kw = dict(cross_kv=kv, time_cond=tc)
        eps, cache = tunet.unet_apply(tcfg, params, sample, t, None, te, tid, return_cache=True,
                                      **kw)
        shallow = tunet.unet_apply_shallow(tcfg, params, sample, t, None, te, tid, cache, **kw)
        plain = tunet.unet_apply(tcfg, params, sample, t, ehs, te, tid)
        stale = tunet.unet_apply_shallow(tcfg, params, sample, t, None, te, tid, cache * 0.5,
                                         **kw)
    assert torch.equal(shallow, eps)
    np.testing.assert_allclose(eps.numpy(), plain.numpy(), atol=1e-6, rtol=1e-6)
    assert torch.isfinite(stale).all() and not torch.allclose(stale, eps)


def test_deep_cache_shape_and_depth_range():
    for family in ("sdxl", "sd15", "three_level"):
        tcfg = _config(family)
        jcfg = junet.UNetConfig(**dataclasses.asdict(tcfg))
        levels = len(tcfg.block_out_channels)
        for depth in range(1, levels):
            assert tunet.deep_cache_shape(tcfg, 3, 32, 48, depth) == junet.deep_cache_shape(
                jcfg, 3, 32, 48, depth)
        for depth in (0, levels):
            with pytest.raises(ValueError, match="depth"):
                tunet.deep_cache_shape(tcfg, 1, 32, 32, depth)
            with pytest.raises(ValueError):
                junet.deep_cache_shape(jcfg, 1, 32, 32, depth)
    sdxl = tunet.sdxl_base_unet_config()
    assert tunet.deep_cache_shape(sdxl, 2, 128, 128) == (2, 128, 128, 640)
    assert tunet.deep_cache_shape(sdxl, 2, 128, 128, 2) == (2, 64, 64, 1280)
    assert tunet.deep_cache_shape(tunet.sd15_unet_config(), 2, 64, 64) == (2, 64, 64, 640)
    tcfg = _config("sdxl")
    sample, t, ehs, te, tid = (torch.from_numpy(a) for a in _step_inputs(tcfg, 1))
    p = tunet.init_unet_params(tcfg, 0)
    with pytest.raises(ValueError, match="depth"):
        tunet.unet_apply_shallow(tcfg, p, sample, t, ehs, te, tid, sample, cache_depth=2)


# --------------------------------------------------------------------------
# the loop, every solver x {CFG, no CFG, guidance interval} x interval
# --------------------------------------------------------------------------


def _pair(xp):
    """(unet_step, full_fn, shallow_fn) of a stand-in UNet for ``xp`` (torch
    or jax.numpy). eps = 0.1 inp + mean(ctx) + 1e-4 t, the shallow pass adds
    0.01 cache; a full pass's cache is 0.5 inp + mean(ctx) (so the uncond
    and cond halves differ)."""
    def mu(ctx):
        m = ctx.mean(dim=(1, 2)) if xp is torch else ctx.mean(axis=(1, 2))
        return m.reshape(-1, 1, 1, 1)

    def step(params, inp, t, ctx, te, tid, tc=None):
        return 0.1 * inp + mu(ctx) + 1e-4 * t.reshape(-1, 1, 1, 1)

    def full(params, inp, t, ctx, te, tid, tc=None):
        return step(params, inp, t, ctx, te, tid), 0.5 * inp + mu(ctx)

    def shallow(params, inp, t, ctx, te, tid, tc, cache):
        return step(params, inp, t, ctx, te, tid) + 0.01 * cache

    return step, full, shallow


def _loop_inputs(steps):
    rng = np.random.default_rng(4)
    lat = (rng.standard_normal((2, 4, 4, 4)) * 10).astype(np.float32)
    ctx = rng.standard_normal((4, 3, 5)).astype(np.float32)
    noise = rng.standard_normal((steps, 2, 4, 4, 4)).astype(np.float32)
    return lat, ctx, noise


def _loops(solver, mode, interval, steps=5):
    """JAX's and the port's loop on the stand-in pair, and their outputs."""
    s = jsched.make_schedule(jsched.SchedulerConfig(), steps).sigmas
    g, gi = {"cfg": (5.0, None), "no_cfg": (1.0, None),
             # the window holds steps 1-3: step 1 is shallow at interval 2
             # and 3, a guided shallow pass before any guided full one
             "interval": (5.0, (float(s[3] + s[4]) / 2, float(s[0] + s[1]) / 2))}[mode]
    lat, ctx, noise = _loop_inputs(steps)
    out = []
    for xp, make, sched, arr in [(jnp, jmake_loop, jsched, jnp.asarray),
                                 (torch, tmake_loop, tsched, torch.from_numpy)]:
        step, full, shallow = _pair(xp)
        dc = None if interval is None else (interval, full, shallow, (4, 4, 4))
        loop = make(step, sched.make_schedule(sched.SchedulerConfig(), steps), guidance_scale=g,
                    solver=solver, guidance_interval=gi, deep_cache=dc)
        kw = {"noise": arr(noise)} if solver == "euler_a" else {}
        out.append(np.asarray(loop({}, arr(lat), arr(ctx), None, None, **kw)))
    return out


@pytest.mark.parametrize("interval", [1, 2, 3])
@pytest.mark.parametrize("mode", ["cfg", "no_cfg", "interval"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_loop_matches_jax(solver, mode, interval):
    want, got = _loops(solver, mode, interval)
    np.testing.assert_allclose(got, want, atol=LOOP_TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("solver", SOLVERS)
def test_interval_one_is_the_plain_loop(solver):
    """Interval 1: a full pass every evaluation, the plain loop's eps, bit
    for bit; intervals 2 and 3 differ from it."""
    lat, ctx, noise = _loop_inputs(5)
    schedule = tsched.make_schedule(tsched.SchedulerConfig(), 5)
    step, full, shallow = _pair(torch)
    kw = {"noise": torch.from_numpy(noise)} if solver == "euler_a" else {}
    args = ({}, torch.from_numpy(lat), torch.from_numpy(ctx), None, None)
    base = tmake_loop(step, schedule, solver=solver)(*args, **kw)
    for interval in (1, 2, 3):
        out = tmake_loop(step, schedule, solver=solver,
                         deep_cache=(interval, full, shallow, (4, 4, 4)))(*args, **kw)
        assert torch.equal(out, base) == (interval == 1)


def test_interval_below_one_raises():
    step, full, shallow = _pair(torch)
    schedule = tsched.make_schedule(tsched.SchedulerConfig(), 2)
    for interval in (0, -1):
        with pytest.raises(ValueError, match="interval"):
            tmake_loop(step, schedule, deep_cache=(interval, full, shallow, (4, 4, 4)))


def test_passes_and_cache_rows_under_heun_and_a_window():
    """The composition (Heun, interval 2, a window over steps 1-2 of 4):
    each evaluation's pass, batch and the cache rows it reads, as JAX's
    nested lax.conds pick them. The correction shares its step's pass; the
    window is tested at its own sigma."""
    schedule = tsched.make_schedule(tsched.SchedulerConfig(), 4)
    s = schedule.sigmas
    calls = []
    step, full, shallow = _pair(torch)

    def full_fn(params, inp, t, ctx, te, tid, tc=None):
        calls.append(("full", inp.shape[0]))
        return full(params, inp, t, ctx, te, tid)

    def shallow_fn(params, inp, t, ctx, te, tid, tc, cache):
        calls.append(("shallow", inp.shape[0], cache.shape[0]))
        return shallow(params, inp, t, ctx, te, tid, tc, cache)

    lat, ctx, _ = _loop_inputs(4)
    loop = tmake_loop(step, schedule, solver="heun", guidance_interval=(float(s[2]), float(s[1])),
                      deep_cache=(2, full_fn, shallow_fn, (4, 4, 4)))
    loop({}, torch.from_numpy(lat), torch.from_numpy(ctx), None, None)
    assert calls == [("full", 2), ("full", 4),            # step 0 at s0, correction at s1
                     ("shallow", 4, 4), ("shallow", 4, 4),  # step 1, its correction at s2
                     ("full", 4), ("full", 2),            # step 2, its correction at s3
                     ("shallow", 2, 2)]                   # step 3; no correction


# --------------------------------------------------------------------------
# txt2img and compile_unet_deepcache on the tiny UNet
# --------------------------------------------------------------------------


def _jax_noise(seeds, shape, device):
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
        jax.random.PRNGKey(s), shape, jnp.float32)) for s in seeds]))


def _jax_ancestral(seeds, steps, shape, device):
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(np.asarray(seeds, np.uint32)))
    return torch.from_numpy(np.array(jpipe._ancestral_noise(keys, steps, shape)))


def _ids(cfg, batch, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.full((batch, cfg.max_position_embeddings), cfg.eos_token_id, np.int32)
    for i in range(batch):
        n = 3 + 2 * i
        ids[i, 0] = cfg.bos_token_id
        ids[i, 1:1 + n] = rng.integers(0, 90, n)
    return ids


def tiny_pipelines(**cache):
    """JAX's tiny pipeline and the port's over the same numpy weights,
    reference binding, float32; ``cache``: CompileConfig's cache flags."""
    ucfg, c1, c2, vcfg = tpipe.tiny_configs()
    ju, jc1, jc2 = (junet.UNetConfig(**dataclasses.asdict(ucfg)),
                    jclip.CLIPTextConfig(**dataclasses.asdict(c1)),
                    jclip.CLIPTextConfig(**dataclasses.asdict(c2)))
    jv = jvae.VAEConfig(**dataclasses.asdict(vcfg))
    params = {"unet": np_init(junet.unet_param_shapes(ju), 0),
              "text_encoder": np_init(jclip.clip_param_shapes(jc1), 1),
              "text_encoder_2": np_init(jclip.clip_param_shapes(jc2), 2),
              "vae": np_init(jvae.vae_decoder_param_shapes(jv), 3)}
    jp = jpipe.SDXLPipeline(
        unet_config=ju, clip_config=jc1, clip2_config=jc2, vae_config=jv,
        params={g: {k: jnp.asarray(v) for k, v in tree.items()} for g, tree in params.items()},
        compile_config=JCompileConfig(backend="reference", dtype="float32", **cache))
    tp = tpipe.make_tiny_pipeline(CompileConfig(backend="reference", dtype="float32", **cache),
                                  params=params_from_numpy(params))
    return jp, tp


def _sigmas(steps):
    return [float(v) for v in jsched.make_schedule(jsched.SchedulerConfig(), steps).sigmas]


@pytest.mark.parametrize("case", ["dpmpp_2m_interval", "heun_window", "euler_a_time_cache",
                                  "euler_depth_tuple"])
def test_txt2img_deep_cache_matches_jax(case, monkeypatch):
    """4 steps, two images, the same injected noise: DPM++ with deep_cache=2
    and a window over the middle steps; Heun with deep_cache=2 and a window
    (the composition); Euler-A with deep_cache=3 and the time cache; Euler
    with deep_cache=(2, 1) (the tiny UNet's one split point). Latents within
    1e-4; the program key holds the normalised knob."""
    s = _sigmas(4)
    window = ((s[2] + s[3]) / 2, (s[0] + s[1]) / 2)
    solver, dc, gi, cache = {
        "dpmpp_2m_interval": ("dpmpp_2m", 2, window, {}),
        "heun_window": ("heun", 2, window, {}),
        "euler_a_time_cache": ("euler_a", 3, None, {"cache_time_cond": True}),
        "euler_depth_tuple": ("euler", (2, 1), None, {}),
    }[case]
    jp, tp = tiny_pipelines(**cache)
    monkeypatch.setattr(tpipe, "initial_noise", _jax_noise)
    monkeypatch.setattr(tpipe, "ancestral_noise", _jax_ancestral)
    ids = _ids(tp.clip_config, 2)
    kw = dict(height=SIZE, width=SIZE, steps=4, seed=[3, 4], solver=solver,
              guidance_interval=gi, deep_cache=dc, return_latents=True)
    want = np.asarray(jp.txt2img(jnp.asarray(ids), jnp.asarray(ids), **kw))
    got = tp.txt2img(ids, ids, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert [sig[-1] for sig in tp.cache_signatures()] == [norm_deep_cache(dc)]
    plain = tp.txt2img(ids, ids, **{**kw, "deep_cache": None})
    assert not torch.allclose(plain, got, atol=1e-3)


def test_deep_cache_knob_forms_share_a_program():
    """deep_cache=2, (2, 1) and [2, 1] are one program; 3 and (2, 2) on a
    3-level UNet are others; a solver is another."""
    tp = tpipe.make_tiny_pipeline()
    ids = _ids(tp.clip_config, 1)
    kw = dict(height=SIZE, width=SIZE, steps=3, seed=7, return_latents=True)
    a = tp.txt2img(ids, ids, deep_cache=2, **kw)
    assert torch.equal(tp.txt2img(ids, ids, deep_cache=(2, 1), **kw), a)
    assert torch.equal(tp.txt2img(ids, ids, deep_cache=[2, 1], **kw), a)
    assert len(tp.cache_signatures()) == 1
    tp.txt2img(ids, ids, deep_cache=3, **kw)
    tp.txt2img(ids, ids, deep_cache=2, solver="heun", **kw)
    sigs = tp.cache_signatures()
    assert len(sigs) == 3 and {(sig[5], sig[-1]) for sig in sigs} == {
        ("euler", (2, 1)), ("euler", (3, 1)), ("heun", (2, 1))}
    with pytest.raises(ValueError, match="depth"):
        tp.txt2img(ids, ids, deep_cache=(2, 2), **kw)  # the tiny UNet has 2 levels


@pytest.mark.parametrize("family", ["sdxl", "sd15"])
def test_compile_unet_deepcache_matches_jax(family):
    """The (full, shallow) pair against JAX's, reference binding: eps and
    cache within 1e-4, the shallow pass on the full pass's cache equal to
    it bit for bit; graphed callables on one pool, nothing captured on the
    CPU."""
    tcfg = _config(family)
    jcfg = junet.UNetConfig(**dataclasses.asdict(tcfg))
    params = np_init(junet.unet_param_shapes(jcfg), 8)
    inputs = _step_inputs(tcfg, 11)
    config = CompileConfig(backend="reference", dtype="float32")
    full, shallow = compile_unet_deepcache(tcfg, config)
    jfull, jshallow = jcompile_deepcache(jcfg, JCompileConfig(backend="reference",
                                                              dtype="float32"))
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    targs, jargs = [torch.from_numpy(a) for a in inputs], [jnp.asarray(a) for a in inputs]
    eps, cache = full(tp, *targs)
    jeps, jcache = jfull(jp, *jargs)
    for got, want in [(eps, jeps), (cache, jcache), (shallow(tp, *targs, cache),
                                                     jshallow(jp, *jargs, jcache))]:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)
    assert torch.equal(shallow(tp, *targs, cache), eps)
    for fn in (full, shallow):
        assert isinstance(fn, tgraphs.GraphedCallable) and fn.captured == {}
    assert full._graphs is shallow._graphs


# --------------------------------------------------------------------------
# the batching signature
# --------------------------------------------------------------------------


def test_request_signature_normalises_deep_cache():
    """As JAX's Request.signature: 2 is (2, 1), a list is the tuple; another
    interval or depth is another signature."""
    kw = dict(prompt="p", height=SIZE, width=SIZE, steps=2)
    forms = [2, (2, 1), [2, 1], (2.0, 1)]
    sigs = {Request(deep_cache=dc, **kw).signature for dc in forms}
    assert len(sigs) == 1 and hash(next(iter(sigs)))
    for dc in forms + [None, 3, (2, 2), [3, 2]]:
        assert Request(deep_cache=dc, **kw).signature == JRequest(deep_cache=dc, **kw).signature
    others = {Request(deep_cache=dc, **kw).signature for dc in (None, 3, (2, 2))}
    assert len(others) == 3 and not others & sigs
    assert norm_deep_cache([3, 2]) == (3, 2) and norm_deep_cache(None) is None


class _Tok:
    def encode_batch(self, texts, *, max_len=16, pad=99, **kw):
        out = np.full((len(texts), max_len), pad, np.int32)
        for i, t in enumerate(texts):
            ids = [98] + [(ord(c) % 90) + 5 for c in t[: max_len - 2]] + [99]
            out[i, : len(ids)] = ids
        return out


def test_engine_co_batches_equal_deep_cache_knobs():
    """deep_cache=2 and (2, 1) requests share one group (one txt2img call,
    one program); the knob reaches txt2img as the request gave it."""
    pipe = tpipe.make_tiny_pipeline()
    calls = []
    real = pipe.txt2img

    def spy(ids1, ids2, **kw):
        calls.append((ids1.shape[0], kw["deep_cache"]))
        return real(ids1, ids2, **kw)

    pipe.txt2img = spy
    eng = ServingEngine(pipe, _Tok(), _Tok(), max_wait_s=0.5)
    try:
        kw = dict(height=SIZE, width=SIZE, steps=3)
        futs = [eng.submit(Request(prompt="a", deep_cache=2, **kw)),
                eng.submit(Request(prompt="b", deep_cache=(2, 1), **kw))]
        assert all(f.result(timeout=300).shape == (SIZE, SIZE, 3) for f in futs)
    finally:
        eng.close()
    assert len(calls) == 1 and calls[0][0] == 2
    assert [s[-1] for s in pipe.cache_signatures()] == [(2, 1)]
