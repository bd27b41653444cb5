"""The port's models, scheduler and compile helpers against the JAX package.

The same weights (made from a seed with numpy, carried into the port
through ``io.convert.params_from_numpy``) and the same numpy inputs go
through both packages at their tiny configs, float32 on the CPU. Each tolerance is stated
at its test with the deviation measured on this suite's inputs.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu import ops as jops
from stabletriton_tpu.compile import CompileConfig as JCompileConfig
from stabletriton_tpu.compile import fuse_attention_projections as jfuse
from stabletriton_tpu.compile import resolve_binding as jresolve
from stabletriton_tpu.models import clip as jclip
from stabletriton_tpu.models import unet as junet
from stabletriton_tpu.models import vae as jvae
from stabletriton_tpu.runtime import scheduler as jsched
from stabletriton_tpu_torch import ops as tops
from stabletriton_tpu_torch.compile import (ALL_KERNEL_OVERRIDES, FUSED_OP_OVERRIDES,
                                            CompileConfig, fuse_attention_projections,
                                            resolve_binding)
from stabletriton_tpu_torch.io.convert import params_from_numpy
from stabletriton_tpu_torch.models import clip as tclip
from stabletriton_tpu_torch.models import unet as tunet
from stabletriton_tpu_torch.models import vae as tvae
from stabletriton_tpu_torch.runtime import scheduler as tsched
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def np_init(shapes: dict, seed: int) -> dict:
    """Weights for both packages from numpy: zero biases, unit norm scales,
    N(0, 1/fan_in) matrices and kernels (the packages' own init law)."""
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


def _to_torch(np_params, group="unet"):
    return params_from_numpy({group: np_params})[group]


def _close(j, t, atol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.fixture(scope="module")
def unet_case():
    jcfg = junet.tiny_unet_config()
    np_params = np_init(junet.unet_param_shapes(jcfg), 0)
    rng = np.random.default_rng(0)
    inputs = dict(
        sample=rng.standard_normal((2, 16, 16, 4)).astype(np.float32),
        t=np.array([999.0, 261.0], np.float32),
        ctx=rng.standard_normal((2, 7, 32)).astype(np.float32),
        text_embeds=rng.standard_normal((2, 16)).astype(np.float32),
        time_ids=np.tile(np.array([32, 32, 0, 0, 32, 32], np.float32), (2, 1)),
    )
    return jcfg, np_params, inputs


def test_configs_and_shape_tables_match():
    for jc, tc in [(junet.tiny_unet_config(), tunet.tiny_unet_config()),
                   (junet.sdxl_base_unet_config(), tunet.sdxl_base_unet_config())]:
        assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
        assert junet.unet_param_shapes(jc) == tunet.unet_param_shapes(tc)
    assert (dataclasses.asdict(jclip.sdxl_text_encoder_2_config())
            == dataclasses.asdict(tclip.sdxl_text_encoder_2_config()))
    assert (jclip.clip_param_shapes(jclip.sdxl_text_encoder_config())
            == tclip.clip_param_shapes(tclip.sdxl_text_encoder_config()))
    assert (jvae.vae_decoder_param_shapes(jvae.sdxl_vae_config())
            == tvae.vae_decoder_param_shapes(tvae.sdxl_vae_config()))


def test_init_distribution():
    cfg = tunet.tiny_unet_config()
    params = tunet.init_unet_params(cfg, 0, dtype=torch.bfloat16)
    assert {k: tuple(v.shape) for k, v in params.items()} == tunet.unet_param_shapes(cfg)
    assert all(v.dtype == torch.bfloat16 for v in params.values())
    assert not params["conv_in.bias"].any()
    assert (params["conv_norm_out.weight"] == 1).all()
    w = params["mid_block.resnets.0.conv1.weight"].float()
    assert abs(w.std().item() * np.sqrt(9 * 64) - 1.0) < 0.05
    again = tunet.init_unet_params(cfg, 0, dtype=torch.bfloat16)
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_fuse_attention_projections_matches_jax(unet_case):
    _, np_params, _ = unet_case
    j = _np(jfuse(np_params))
    t = fuse_attention_projections(_to_torch(np_params))
    assert sorted(j) == sorted(t)
    for k in j:
        np.testing.assert_array_equal(t[k].numpy(), j[k])


def test_unet_reference_binding(unet_case):
    """Tolerance 1e-4: measured max abs deviation 3.0e-6 over the whole tiny
    UNet (float32 rounding of two implementations)."""
    jcfg, np_params, x = unet_case
    j = jax.jit(functools.partial(junet.unet_apply, jcfg))(
        np_params, *(jnp.asarray(x[k]) for k in ("sample", "t", "ctx", "text_embeds",
                                                  "time_ids")))
    t = tunet.unet_apply(tunet.tiny_unet_config(), _to_torch(np_params),
                         *(torch.from_numpy(x[k]) for k in
                           ("sample", "t", "ctx", "text_embeds", "time_ids")))
    _close(j, t, 1e-4)


def test_unet_kernel_binding_fused_kv_cache(unet_case):
    """The default bindings of both packages (JAX: Pallas kernels in
    interpret mode; port: its kernels' plain versions on the CPU), fused
    projections and the hoisted cross K/V, float32. Tolerance 1e-3, the
    Pallas kernels' own gate; measured 2.4e-6."""
    jcfg, np_params, x = unet_case
    jp = jfuse({k: jnp.asarray(v) for k, v in np_params.items()})

    @jax.jit
    def jstep(params, sample, t, ctx, text_embeds, time_ids):
        with jops.use_backends(jresolve(JCompileConfig(backend="pallas", dtype="float32"))):
            kv = junet.precompute_cross_kv(jcfg, params, ctx)
            return junet.unet_apply(jcfg, params, sample, t, None, text_embeds, time_ids,
                                    cross_kv=kv)

    j = jstep(jp, *(jnp.asarray(x[k]) for k in ("sample", "t", "ctx", "text_embeds",
                                                   "time_ids")))
    tcfg = tunet.tiny_unet_config()
    tp = fuse_attention_projections(_to_torch(np_params))
    with tops.use_backends(resolve_binding(CompileConfig(dtype="float32"))):
        tkv = tunet.precompute_cross_kv(tcfg, tp, torch.from_numpy(x["ctx"]))
        assert all(v.shape[-1] == 2 * 64 for v in tkv.values())
        t = tunet.unet_apply(tcfg, tp, torch.from_numpy(x["sample"]), torch.from_numpy(x["t"]),
                             None, torch.from_numpy(x["text_embeds"]),
                             torch.from_numpy(x["time_ids"]), cross_kv=tkv)
    _close(j, t, 1e-3)


def test_unet_unfused_cached_kv_tuple(unet_case):
    """precompute_cross_kv on unfused params gives (k, v) tuples; the cached
    step equals the inline step."""
    _, np_params, x = unet_case
    cfg = tunet.tiny_unet_config()
    p = _to_torch(np_params)
    args = [torch.from_numpy(x[k]) for k in ("sample", "t", "ctx", "text_embeds", "time_ids")]
    kv = tunet.precompute_cross_kv(cfg, p, args[2])
    assert all(isinstance(v, tuple) for v in kv.values())
    inline = tunet.unet_apply(cfg, p, *args)
    cached = tunet.unet_apply(cfg, p, args[0], args[1], None, args[3], args[4], cross_kv=kv)
    torch.testing.assert_close(cached, inline, atol=1e-6, rtol=0)


@pytest.mark.parametrize("windows", [1, 2])
def test_clip(windows):
    """Tolerance 1e-5 (measured at most 1.7e-6)."""
    jcfg = jclip.tiny_clip_config()
    np_params = np_init(jclip.clip_param_shapes(jcfg), 1)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 98, (2, 16 * windows)).astype(np.int32)
    ids[:, 0] = 98
    ids[0, 5] = 99
    ids[1, 9] = 99
    j = jax.jit(functools.partial(jclip.clip_apply_chunked, jcfg))(np_params, jnp.asarray(ids))
    t = tclip.clip_apply_chunked(tclip.tiny_clip_config(), _to_torch(np_params, "text_encoder"),
                                 torch.from_numpy(ids))
    for a, b in zip(j, t):
        _close(a, b, 1e-5)


def test_empty_prompt_ids_match():
    for jc, tc in [(jclip.sdxl_text_encoder_config(), tclip.sdxl_text_encoder_config()),
                   (jclip.sdxl_text_encoder_2_config(), tclip.sdxl_text_encoder_2_config())]:
        np.testing.assert_array_equal(jc.empty_prompt_ids(2, 154), tc.empty_prompt_ids(2, 154))


@pytest.mark.parametrize("binding", ["reference", "kernels"])
def test_vae_decode(binding):
    """Tolerance 1e-4 for the reference bindings; 1e-3 for the kernel
    bindings (JAX Pallas interpret vs the port's plain versions). Measured
    1.1e-6 and 9.5e-7."""
    jcfg = jvae.tiny_vae_config()
    np_params = np_init(jvae.vae_decoder_param_shapes(jcfg), 3)
    lat = np.random.default_rng(2).standard_normal((2, 6, 5, 4)).astype(np.float32)
    jb = ({} if binding == "reference"
          else jresolve(JCompileConfig(backend="pallas", dtype="float32")))
    tb = {} if binding == "reference" else resolve_binding(CompileConfig(dtype="float32"))

    @jax.jit
    def jdecode(params, z):
        with jops.use_backends(jb):
            return jvae.vae_decode(jcfg, params, z)

    j = jdecode(np_params, jnp.asarray(lat))
    with tops.use_backends(tb):
        t = tvae.vae_decode(tvae.tiny_vae_config(), _to_torch(np_params, "vae"),
                            torch.from_numpy(lat))
    assert t.shape == (2, 12, 10, 3)
    _close(j, t, 1e-4 if binding == "reference" else 1e-3)


@pytest.mark.parametrize("steps", [2, 4, 30])
def test_schedule_tables(steps):
    j = jsched.make_schedule(jsched.SchedulerConfig(), steps)
    t = tsched.make_schedule(tsched.SchedulerConfig(), steps)
    np.testing.assert_array_equal(j.timesteps, t.timesteps)
    np.testing.assert_array_equal(j.sigmas, t.sigmas)
    assert j.init_noise_sigma == t.init_noise_sigma


def test_euler_step_and_scaling():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    eps = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    s = jsched.make_schedule(jsched.SchedulerConfig(), 4).sigmas
    _close(jsched.scale_model_input(jnp.asarray(x), s[1]),
           tsched.scale_model_input(torch.from_numpy(x), float(s[1])), 1e-6)
    _close(jsched.euler_step(jnp.asarray(x), jnp.asarray(eps), s[1], s[2]),
           tsched.euler_step(torch.from_numpy(x), torch.from_numpy(eps), float(s[1]),
                             float(s[2])), 1e-6)


def test_params_from_numpy():
    tree = {"unet": {"a.weight": np.ones((2, 3), np.float32)},
            "vae": {"b.bias": np.zeros((4,), np.float64)}}
    out = params_from_numpy(tree)
    assert out["unet"]["a.weight"].dtype == torch.float32
    assert out["vae"]["b.bias"].dtype == torch.float64
    cast = params_from_numpy(tree, dtype=torch.bfloat16)
    assert {t.dtype for g in cast.values() for t in g.values()} == {torch.bfloat16}
    with pytest.raises(KeyError, match="unknown parameter groups"):
        params_from_numpy({"unet2": {}})


def test_resolve_binding():
    assert resolve_binding(CompileConfig(backend="reference")) == {}
    b = resolve_binding(CompileConfig())
    # GroupNorm / LayerNorm / GEGLU: the plain bf16-apply (and reference GEGLU)
    # roundings, computed by the kernels' stepwise forms
    assert b == {"attention": "cuda", "attention_qkv": "cuda", "attention_kv": "cuda",
                 "group_norm": "cuda_bf16apply", "layer_norm": "cuda_bf16apply",
                 "geglu": "cuda_bf16apply", "conv2d": "direct"}
    # the fused-op and all-kernel bindings are as they were
    fused = {"attention": "cuda", "attention_qkv": "cuda", "attention_kv": "cuda",
             "group_norm": "cuda", "layer_norm": "cuda", "geglu": "cuda", "gn_conv2d": "fused",
             "conv2d": "direct"}
    assert resolve_binding(CompileConfig(overrides=FUSED_OP_OVERRIDES)) == fused
    assert resolve_binding(CompileConfig(overrides=ALL_KERNEL_OVERRIDES)) == {
        **fused, "linear": "cuda", "time_embed": "cuda"}
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_binding(CompileConfig(backend="pallas"))
