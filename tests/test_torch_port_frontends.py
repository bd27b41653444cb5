"""The port's frontends against the JAX package's, as tests/test_frontends.py
holds the JAX ones: a duck-typed torch UNet (``FakeTorchUNet``) through
``frontends.diffusers.compile``; ``return_dict=False``; DeepCache with
several calls a step; the ComfyUI registry and txt2img node; SGM's
pre-projected ``y`` on the base (6 time-id slots) and refiner (5 slots)
layouts through ``CompVisUNetShim`` and ``splice``; and ``splice`` refusing
an object it does not know. On CPU tensors the graphed steps run as they
are (no graph), under the binding asked for.

Tolerances: the port against the JAX package, float32 on the tiny UNet
(outputs of order 1), atol 1e-4 (summation order, as tests/test_frontends.py
holds JAX's frontend to its own unet_apply); the port's frontend against the
port's own ``unet_apply`` on the params it holds, exact.
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu import ops as jops
from stabletriton_tpu.compile import CompileConfig as JCompileConfig
from stabletriton_tpu.compile import compile_unet_deepcache as jcompile_unet_deepcache
from stabletriton_tpu.frontends import diffusers as jfe
from stabletriton_tpu.io.torch_ingest import state_dict_to_params as jstate_dict_to_params
from stabletriton_tpu.models import unet as junet
from stabletriton_tpu_torch import ops as tops
from stabletriton_tpu_torch.compile import CompileConfig, resolve_binding
from stabletriton_tpu_torch.frontends import comfyui as tcomfy
from stabletriton_tpu_torch.frontends import diffusers as tfe
from stabletriton_tpu_torch.frontends import sgm as tsgm
from stabletriton_tpu_torch.models import unet as tunet
from stabletriton_tpu_torch.runtime import pipeline as tpipe
from test_frontends import FakeTorchUNet
from test_torch_port_single_file import sgm_unet_names
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-4
CONFIGS = {"reference": (CompileConfig(backend="reference", dtype="float32"),
                         JCompileConfig(backend="reference", dtype="float32")),
           "default": (CompileConfig(dtype="float32"),
                       JCompileConfig(backend="reference", dtype="float32"))}


@pytest.fixture(scope="module")
def fake():
    return FakeTorchUNet(junet.tiny_unet_config())


def _inputs(seed, b=2, hw=16, ctx=32):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return t(b, 4, hw, hw), t(b, 7, ctx), t(b, 16), t(b, 6)


def _jax_apply(cfg, params, sample, t, ctx, te, ti, b):
    return np.asarray(jax.jit(functools.partial(junet.unet_apply, cfg))(
        params, jnp.asarray(sample.numpy().transpose(0, 2, 3, 1)), jnp.full((b,), t),
        jnp.asarray(ctx.numpy()), jnp.asarray(te.numpy()), jnp.asarray(ti.numpy()))
    ).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("config", sorted(CONFIGS))
@pytest.mark.parametrize("timestep", ["int", "one", "rows"])
def test_diffusers_compile_equals_jax(fake, config, timestep):
    """compile(torch_unet): ingest, convert and run, against JAX's frontend
    on the same module, and against the port's unet_apply on the params
    the compiled UNet holds, bit for bit."""
    cc, jcc = CONFIGS[config]
    compiled = tfe.compile(fake, cc, device="cpu")
    assert dataclasses.asdict(compiled.unet_config) == dataclasses.asdict(fake.cfg)
    assert compiled.device == torch.device("cpu") and compiled.dtype == torch.float32
    assert compiled.config is fake.config
    assert ("down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_qkv.weight"
            in compiled.params) == (config == "default")
    sample, ctx, te, ti = _inputs(1)
    ts = {"int": 500, "one": torch.tensor([500.0]), "rows": torch.tensor([500.0, 500.0])}
    kw = dict(added_cond_kwargs={"text_embeds": te, "time_ids": ti})
    out = compiled(sample, ts[timestep], ctx, **kw)
    assert out.sample.shape == (2, 4, 16, 16) and out.sample.is_contiguous()
    want = jfe.compile(fake, jcc)(sample, 500, ctx, **kw).sample.numpy()
    np.testing.assert_allclose(out.sample.numpy(), want, atol=ATOL, rtol=0)
    with tops.use_backends(resolve_binding(cc)):
        own = tunet.unet_apply(compiled.unet_config, compiled.params, sample.permute(0, 2, 3, 1),
                               torch.full((2,), 500.0), ctx, te, ti)
    assert torch.equal(out.sample, own.permute(0, 3, 1, 2))


def test_diffusers_return_dict_false_and_dtypes(fake):
    compiled = tfe.compile(fake, CONFIGS["reference"][0], device="cpu")
    sample, ctx, te, ti = _inputs(2, b=1)
    kw = dict(added_cond_kwargs={"text_embeds": te, "time_ids": ti})
    out = compiled(sample, torch.tensor([10.0]), ctx, return_dict=False, **kw)
    assert isinstance(out, tuple) and out[0].shape == (1, 4, 16, 16)
    assert compiled(sample, 10, ctx, **kw)[0].shape == (1, 4, 16, 16)  # _Output indexes
    half = compiled(sample.half(), 10, ctx, return_dict=False, **kw)[0]
    assert half.dtype == torch.float16  # cast through f32 to the sample's dtype
    want = compiled(sample.half().float(), 10, ctx, return_dict=False, **kw)[0]
    assert torch.equal(half, want.half())


def test_diffusers_drop_in_deep_cache_equals_jax(fake):
    """The first (full) step equals the exact wrapper; a shallow step on the
    stale cache differs from the exact forward and equals JAX's; a timestep
    back up starts a new generation."""
    cc, jcc = CONFIGS["reference"]
    exact = tfe.compile(fake, cc, device="cpu")
    dc = tfe.compile(fake, cc, deep_cache=2, device="cpu")
    jdc = jfe.compile(fake, JCompileConfig(backend="reference", dtype="float32",
                                           donate_sample=False), deep_cache=2)
    s0, ctx, te, ti = _inputs(3, b=1)
    s1 = _inputs(4, b=1)[0]
    kw = dict(added_cond_kwargs={"text_embeds": te, "time_ids": ti})
    a = dc(s0, 500, ctx, **kw).sample
    assert torch.equal(a, exact(s0, 500, ctx, **kw).sample)
    b = dc(s1, 400, ctx, **kw).sample
    assert not torch.allclose(b, exact(s1, 400, ctx, **kw).sample, atol=1e-3)
    jdc(s0, 500, ctx, **kw)
    np.testing.assert_allclose(b.numpy(), jdc(s1, 400, ctx, **kw).sample.numpy(), atol=ATOL,
                               rtol=0)
    assert torch.equal(dc(s0, 500, ctx, **kw).sample, a)
    dc.reset_deep_cache()
    assert dc._dc_state is None


def test_diffusers_deep_cache_multi_call_per_step_equals_jax(fake):
    """cond and uncond as separate calls at one timestep (ComfyUI's two-pass
    CFG): each call position keeps its own cache slot, as in JAX."""
    cc, _ = CONFIGS["reference"]
    jcc = JCompileConfig(backend="reference", dtype="float32", donate_sample=False)
    dc = tfe.compile(fake, cc, deep_cache=2, device="cpu")
    full, shallow = jcompile_unet_deepcache(fake.cfg, jcc)
    jparams = {k: jnp.asarray(v) for k, v in jstate_dict_to_params(fake, np.float32).items()}
    ctx = torch.zeros(1, 7, 32)
    zeros = (jnp.zeros((1, 7, 32)), jnp.zeros((1, 16)), jnp.zeros((1, 6)))
    kw = dict(added_cond_kwargs={"text_embeds": torch.zeros(1, 16), "time_ids": torch.zeros(1, 6)})

    def to_jax(x):
        return jnp.asarray(x.numpy().transpose(0, 2, 3, 1))

    a0, b0, a1, b1 = (_inputs(10 + i, b=1)[0] for i in range(4))
    dc(a0, 500, ctx, **kw)
    dc(b0, 500, ctx, **kw)
    _, cache_a = full(jparams, to_jax(a0), jnp.full((1,), 500.0), *zeros)
    _, cache_b = full(jparams, to_jax(b0), jnp.full((1,), 500.0), *zeros)
    out_a = dc(a1, torch.tensor(400.0), ctx, **kw).sample.numpy()
    out_b = dc(b1, torch.tensor([400.0]), ctx, **kw).sample.numpy()
    for out, x, cache in [(out_a, a1, cache_a), (out_b, b1, cache_b)]:
        want = np.asarray(shallow(jparams, to_jax(x), jnp.full((1,), 400.0), *zeros, cache))
        np.testing.assert_allclose(out, want.transpose(0, 3, 1, 2), atol=ATOL, rtol=0)
    wrong = np.asarray(shallow(jparams, to_jax(b1), jnp.full((1,), 400.0), *zeros, cache_a))
    assert not np.allclose(out_b, wrong.transpose(0, 3, 1, 2), atol=1e-3)
    with pytest.raises(ValueError, match="deep_cache"):
        tfe.compile(fake, cc, deep_cache=0, device="cpu")


def test_comfyui_registry_and_nodes():
    nodes, names = tcomfy.register()
    assert set(nodes) == set(names) == {"StableTritonCompile", "StableTritonTxt2Img"}
    for cls in nodes.values():
        spec = cls.INPUT_TYPES()
        assert "required" in spec and cls.FUNCTION and cls.RETURN_TYPES
    backends = nodes["StableTritonCompile"].INPUT_TYPES()["required"]["backend"][0]
    assert backends == ["cuda", "reference"]
    for solver in nodes["StableTritonTxt2Img"].INPUT_TYPES()["required"]["solver"][0]:
        assert solver in ("euler", "heun", "dpmpp_2m")


def test_comfyui_txt2img_node_on_tiny_pipeline():
    pipe = tpipe.make_tiny_pipeline()
    ids = np.full((1, 16), 99, np.int32)
    ids[0, :4] = [98, 5, 6, 99]
    (img,) = tcomfy.StableTritonTxt2Img().generate(pipe, ids, ids, 32, 32, 2, 5.0, 3, "euler")
    want = pipe.txt2img(ids, ids, height=32, width=32, steps=2, guidance_scale=5.0, seed=3)
    assert img.shape == (1, 32, 32, 3) and img.dtype == torch.float32
    assert torch.equal(img, (want + 1.0) * 0.5)
    assert 0.0 <= img.min().item() and img.max().item() <= 1.0


def test_comfyui_compile_node_runs_on_the_card_or_refuses(fake, monkeypatch):
    """The node builds its UNet on the card, the default device: with none,
    it raises rather than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = types.SimpleNamespace(model=types.SimpleNamespace(diffusion_model=fake))
    with pytest.raises(RuntimeError, match="CUDA"):
        tcomfy.StableTritonCompile().compile(model)


def _adm_y(cfg, pooled, time_ids):
    """SGM's y: concat(pooled, fourier(time ids)) with the [cos, sin]
    layout, built by the JAX package's op, as ComfyUI's encode_adm does."""
    b = pooled.shape[0]
    four = np.asarray(jops.time_embed(jnp.asarray(time_ids.reshape(-1)),
                                      dim=cfg.addition_time_embed_dim, flip_sin_to_cos=True,
                                      downscale_freq_shift=0.0)).reshape(b, -1)
    return torch.from_numpy(np.concatenate([pooled, four], axis=-1))


REFINER_LIKE = dataclasses.replace(junet.tiny_unet_config(),
                                   projection_class_embeddings_input_dim=8 * 5 + 16)


@pytest.mark.parametrize("layout", ["base", "refiner"])
def test_sgm_y_convention_equals_jax(layout):
    """The shim fed (x, t, context, y) equals JAX's unet_apply computing the
    fourier embedding itself from the raw time ids: the base's 6 slots
    through the ComfyUI shim on a diffusers-keyed module, the refiner's 5
    through ``splice`` on an SGM-keyed one inside a mock sgm
    SamplingPipeline (pipeline.model.model.diffusion_model)."""
    cfg = junet.tiny_unet_config() if layout == "base" else REFINER_LIKE
    fake_hf = FakeTorchUNet(cfg)
    tcfg = tunet.UNetConfig(**dataclasses.asdict(cfg))
    cc = CONFIGS["reference"][0]
    if layout == "base":
        shim = tcomfy._ComfyUNetShim(tfe.compile(fake_hf, cc, device="cpu"))
    else:
        names = sgm_unet_names(cfg)
        sgm_sd = {names[k]: v for k, v in fake_hf.state_dict().items()}
        wrapper = types.SimpleNamespace(diffusion_model=types.SimpleNamespace(
            state_dict=lambda: sgm_sd))
        pipeline = types.SimpleNamespace(model=types.SimpleNamespace(model=wrapper))
        assert tsgm.splice(pipeline, unet_config=tcfg, compile_config=cc,
                           device="cpu") is pipeline
        shim = wrapper.diffusion_model
        assert isinstance(shim, tsgm.CompVisUNetShim)
    rng = np.random.default_rng(13)
    x, ctx, _, _ = _inputs(13)
    pooled = rng.standard_normal((2, 16)).astype(np.float32)
    slots = [32.0, 32.0, 0.0, 0.0, 32.0, 32.0] if layout == "base" else [32.0, 32.0, 0, 0, 6.0]
    time_ids = np.tile(np.asarray(slots, np.float32), (2, 1))
    y = _adm_y(cfg, pooled, time_ids)
    assert y.shape[-1] == cfg.projection_class_embeddings_input_dim
    got = shim(x, timesteps=torch.tensor([500.0]), context=ctx, y=y)
    params = {k: jnp.asarray(v) for k, v in jstate_dict_to_params(fake_hf, np.float32).items()}
    want = _jax_apply(cfg, params, x, 500.0, ctx, torch.from_numpy(pooled),
                      torch.from_numpy(time_ids), 2)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("name,width", [("sdxl_base", 2816), ("sdxl_refiner", 2560)])
def test_full_width_y_with_zero_width_time_ids(name, width):
    """At the full SDXL-base and refiner widths, unet_apply's time embedding
    takes a y of the add embedding's input width with zero-width time ids as
    that input, and equals the same embedding built from the raw time ids
    (the embedding's own parameters only; the rest of the UNet is not
    built)."""
    cfg = getattr(tunet, f"{name}_unet_config")()
    assert cfg.projection_class_embeddings_input_dim == width
    shapes = {k: s for k, s in tunet.unet_param_shapes(cfg).items()
              if k.startswith(("time_embedding.", "add_embedding."))}
    g = torch.Generator().manual_seed(0)
    p = {k: torch.randn(s, generator=g) / (s[0] ** 0.5 if len(s) > 1 else 1.0)
         for k, s in shapes.items()}
    slots = 6 if name == "sdxl_base" else 5
    pooled = torch.randn((2, width - slots * cfg.addition_time_embed_dim), generator=g)
    time_ids = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024][:slots - 1] + [6.0]] * 2)
    t = torch.tensor([500.0, 500.0])
    y = torch.cat([pooled, tops.time_embed(time_ids.reshape(-1), dim=cfg.addition_time_embed_dim,
                                           flip_sin_to_cos=True, downscale_freq_shift=0.0
                                           ).reshape(2, -1)], dim=-1)
    assert y.shape == (2, width)
    with tops.use_backends({}):
        raw = tunet._time_embedding(cfg, p, t, pooled, time_ids, torch.float32)
        pre = tunet._time_embedding(cfg, p, t, y, torch.zeros((2, 0)), torch.float32)
    assert torch.equal(raw, pre)


def test_splice_rejects_unrecognized_object():
    with pytest.raises(ValueError, match="diffusion_model"):
        tsgm.splice(object())
    deep = types.SimpleNamespace(model=types.SimpleNamespace(model=types.SimpleNamespace(
        model=types.SimpleNamespace(diffusion_model=None))))
    with pytest.raises(ValueError, match="diffusion_model"):
        tsgm.splice(deep)  # more than three .model levels down
