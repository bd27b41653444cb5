"""The SD2.x slice of the port against the JAX package.

SD2.x fixes the head dim at 64 (5/10/20/20 heads at 320/640/1280/1280
channels): h=5 does not divide into JAX's two-head 128-lane packs, so
level 0's self-attention takes the head-major route (K3 at 96^2 latents)
and its cross-attention the all-heads tiny-KV route (K5), while levels 1-3
pack (K1 / K2). Here: the configs and shape tables, the routing table at
the 768^2 path's shapes, attention at h=5 d=64 against JAX's Pallas kernels
(interpret mode), a tiny SD2-like UNet whose attention level has 5 heads
against JAX's ``unet_apply``, and a tiny single-encoder pipeline (gelu
encoder, ``clip_skip=2``) against JAX's txt2img.

Inputs and weights come from numpy seeds. Tolerances as
``test_torch_port_sd15.py``: attention f32 max abs 1e-5, bf16 2 bf16 ulps
of the largest output; UNet and images f32 atol 1e-3.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu import ops as jops
from stabletriton_tpu.compile import CompileConfig as JCompileConfig
from stabletriton_tpu.compile import fuse_attention_projections as jfuse
from stabletriton_tpu.compile import resolve_binding as jresolve
from stabletriton_tpu.kernels import flash_attention as jfa
from stabletriton_tpu.models import clip as jclip
from stabletriton_tpu.models import unet as junet
from stabletriton_tpu.models import vae as jvae
from stabletriton_tpu.runtime import pipeline as jpipe
from stabletriton_tpu_torch import ops as tops
from stabletriton_tpu_torch.compile import (
    CompileConfig,
    fuse_attention_projections,
    resolve_binding,
)
from stabletriton_tpu_torch.io.convert import params_from_numpy
from stabletriton_tpu_torch.kernels import flash_attention as tfa
from stabletriton_tpu_torch.models import clip as tclip
from stabletriton_tpu_torch.models import unet as tunet
from stabletriton_tpu_torch.models import vae as tvae
from stabletriton_tpu_torch.runtime import pipeline as tpipe
from test_torch_port_sd15 import (
    _attn_close,
    _ids,
    _inputs,
    jax_initial_noise,
    jax_route,
    np_init,
)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def test_sd2_configs_match_jax():
    jc, tc = junet.sd21_unet_config(), tunet.sd21_unet_config()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    shapes = tunet.unet_param_shapes(tc)
    assert shapes == junet.unet_param_shapes(jc)
    assert sum(math.prod(s) for s in shapes.values()) == 865_910_724
    assert [tc.num_heads(c) for c in tc.block_out_channels] == [5, 10, 20, 20]
    assert shapes["down_blocks.0.attentions.0.transformer_blocks.0.attn2.to_k.weight"] == (
        1024, 320)
    jt, tt = jclip.sd2_text_encoder_config(), tclip.sd2_text_encoder_config()
    assert dataclasses.asdict(jt) == dataclasses.asdict(tt)
    assert tclip.clip_param_shapes(tt) == jclip.clip_param_shapes(jt)
    assert (tt.hidden_size, tt.num_layers, tt.num_heads, tt.hidden_act) == (1024, 24, 16, "gelu")
    assert dataclasses.asdict(tvae.sd15_vae_config()) == dataclasses.asdict(jvae.sd15_vae_config())


# the 768^2 path (96^2 latent): (heads, head dim, keys) -> class
SD2_CLASSES = {(5, 64, 9216): "K3", (5, 64, 77): "K5", (10, 64, 2304): "K2",
               (10, 64, 77): "K1", (20, 64, 576): "K1", (20, 64, 144): "K1",
               (20, 64, 77): "K1", (1, 512, 9216): "K3"}


def test_sd2_attention_class_table():
    for (h, d, sk), cls in SD2_CLASSES.items():
        assert tfa.attention_class(h, d, sk) == cls, (h, d, sk)
        if h > 1:
            assert jax_route(sk, sk, h, d, 2) == ("packed" if cls in ("K1", "K2") else cls)
    assert tfa.kernel_name(torch.bfloat16, 9216) == "wgmma_bf16"
    assert tfa.kernel_name(torch.bfloat16, 77) == "tinykv_wgmma_bf16"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk,route", [(1100, 1100, "K3"), (96, 77, "K5"), (300, 300, "K4")])
def test_attention_h5_d64_vs_pallas_route(sq, sk, route, dtype):
    """Five heads of 64: JAX's head-major routes, which SD2.x's level 0 is
    the first model of the port to take at d=64."""
    h, d = 5, 64
    rng = np.random.default_rng(sq + sk)
    (jq, tq), (jk, tk), (jv, tv) = (_inputs(rng, dtype, 1, s, h * d) for s in (sq, sk, sk))
    itemsize = 4 if dtype == torch.float32 else 2
    assert jax_route(sq, sk, h, d, itemsize) == route == tfa.attention_class(h, d, sk)
    j = jfa.flash_attention(jq, jk, jv, num_heads=h)
    _attn_close(j, tfa.flash_attention(tq, tk, tv, num_heads=h), dtype)


# --------------------------------------------------------------------------
# a tiny SD2-like UNet and pipeline
# --------------------------------------------------------------------------


def tiny_sd2_configs():
    """(unet, clip, vae): SD2.x's features at tiny widths: head dim fixed (8)
    so level 0 has 5 heads and level 1 10, neither packing; one gelu
    encoder; no added conditioning."""
    c1 = jclip.CLIPTextConfig(vocab_size=100, hidden_size=32, num_layers=2, num_heads=4,
                              intermediate_size=32, max_position_embeddings=16,
                              hidden_act="gelu", eos_token_id=99, bos_token_id=98)
    ucfg = junet.UNetConfig(
        block_out_channels=(40, 80), down_block_types=("CrossAttnDownBlock2D", "DownBlock2D"),
        layers_per_block=1, transformer_layers_per_block=(1, 1), attention_head_dim=8,
        cross_attention_dim=c1.hidden_size, norm_num_groups=8, addition_time_embed_dim=None,
        projection_class_embeddings_input_dim=None, mid_block_layers=1)
    return ucfg, c1, jvae.VAEConfig(block_out_channels=(8, 16), norm_num_groups=4,
                                    layers_per_block=1)


@pytest.fixture(scope="module")
def sd2_weights():
    ucfg, c1, vcfg = tiny_sd2_configs()
    assert [ucfg.num_heads(c) for c in ucfg.block_out_channels] == [5, 10]
    assert all(tfa.pack_factor(ucfg.num_heads(c), 8) == 1 for c in ucfg.block_out_channels)
    params = {"unet": np_init(junet.unet_param_shapes(ucfg), 30),
              "text_encoder": np_init(jclip.clip_param_shapes(c1), 31),
              "vae": np_init(jvae.vae_decoder_param_shapes(vcfg), 32)}
    return (ucfg, c1, vcfg), params


# 36^2 latent: level 0 (h=5) attends over 1296 keys (K3), the mid block
# (h=10) over 324 (K4), cross-attention over 16 keys (K5)
LATENT = 36


@pytest.mark.parametrize("binding", ["reference", "cuda"])
def test_tiny_sd2_unet_vs_jax(sd2_weights, binding):
    """The "cuda" binding (its kernels' plain versions on CPU tensors, fused
    projections, cross K/V cache) against JAX's default Pallas binding
    (interpret mode), and the reference bindings against each other."""
    (jcfg, _, _), params = sd2_weights
    rng = np.random.default_rng(35)
    sample = rng.standard_normal((2, LATENT, LATENT, 4)).astype(np.float32)
    t = np.array([999.0, 261.0], np.float32)
    ctx = rng.standard_normal((2, 16, 32)).astype(np.float32)
    empty = np.zeros((2, 0), np.float32)
    jb = {} if binding == "reference" else jresolve(JCompileConfig(dtype="float32"))

    @jax.jit
    def jstep(p, sample, t, ctx, empty):
        with jops.use_backends(jb):
            if binding == "reference":
                return junet.unet_apply(jcfg, p, sample, t, ctx, empty, empty)
            kv = junet.precompute_cross_kv(jcfg, p, ctx)
            return junet.unet_apply(jcfg, p, sample, t, None, empty, empty, cross_kv=kv)

    jp = {k: jnp.asarray(v) for k, v in params["unet"].items()}
    j = jstep(jp if binding == "reference" else jfuse(jp), sample, t, ctx, empty)

    tcfg = tunet.UNetConfig(**dataclasses.asdict(jcfg))
    tp = params_from_numpy({"unet": params["unet"]})["unet"]
    args = [torch.from_numpy(a) for a in (sample, t, ctx, empty)]
    if binding == "reference":
        out = tunet.unet_apply(tcfg, tp, args[0], args[1], args[2], args[3], args[3])
    else:
        tp = fuse_attention_projections(tp)
        with tops.use_backends(resolve_binding(CompileConfig(dtype="float32"))):
            kv = tunet.precompute_cross_kv(tcfg, tp, args[2])
            out = tunet.unet_apply(tcfg, tp, args[0], args[1], None, args[3], args[3],
                                   cross_kv=kv)
    assert out.shape == (2, LATENT, LATENT, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(j), atol=1e-3, rtol=0)


SIZE, STEPS, GUIDANCE = 72, 2, 7.5  # 72^2 image: a 36^2 latent through the tiny VAE


def _port_pipeline(weights, config, clip_skip):
    (ju, jc1, jv), params = weights
    c1 = tclip.CLIPTextConfig(**dataclasses.asdict(jc1))
    return tpipe.SDXLPipeline(
        unet_config=tunet.UNetConfig(**dataclasses.asdict(ju)), clip_config=c1, clip2_config=c1,
        vae_config=tvae.VAEConfig(**dataclasses.asdict(jv)), params=params_from_numpy(params),
        compile_config=config, clip_skip=clip_skip, device="cpu")


@pytest.mark.parametrize("jax_backend", ["reference", "pallas"])
def test_tiny_sd2_txt2img_vs_jax(sd2_weights, jax_backend, monkeypatch):
    """The single-encoder branch on the penultimate layer of a gelu encoder
    (SD2.x's clip_skip=2), the same weights, ids and seeds as JAX's
    pipeline; JAX's "pallas" runs its kernels in interpret mode, held
    against the port's "cuda" binding."""
    (ju, jc1, jv), params = sd2_weights
    monkeypatch.setenv("ST_TPU_COMPILE_CACHE", "0")
    ids = _ids(jc1, np.random.default_rng(17), 2)
    seed = 50
    jp = jpipe.SDXLPipeline(
        unet_config=ju, clip_config=jc1, clip2_config=jc1, vae_config=jv,
        params={g: {k: jnp.asarray(v) for k, v in p.items()} for g, p in params.items()},
        compile_config=JCompileConfig(backend=jax_backend, dtype="float32"), clip_skip=2)
    want = np.asarray(jp.txt2img(jnp.asarray(ids), jnp.asarray(ids), height=SIZE, width=SIZE,
                                 steps=STEPS, guidance_scale=GUIDANCE, seed=seed))
    lat = SIZE // jv.spatial_scale_factor
    noise = torch.from_numpy(jax_initial_noise([seed, seed + 1], (lat, lat, 4)))
    monkeypatch.setattr(tpipe, "initial_noise", lambda seeds, shape, device: noise)
    config = (CompileConfig(backend="reference", dtype="float32") if jax_backend == "reference"
              else CompileConfig(dtype="float32"))
    got = _port_pipeline(sd2_weights, config, 2).txt2img(
        ids, ids, height=SIZE, width=SIZE, steps=STEPS, guidance_scale=GUIDANCE, seed=seed)
    assert got.shape == want.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_tiny_sd2_clip_skip_changes_output(sd2_weights):
    """clip_skip=2 conditions on another encoder layer than clip_skip=1: the
    images differ by far more than the parity tolerance (as
    tests/test_sd15.py holds for JAX's pipeline)."""
    ids = _ids(sd2_weights[0][1], np.random.default_rng(17), 1)
    config = CompileConfig(backend="reference", dtype="float32")
    out = {skip: _port_pipeline(sd2_weights, config, skip).txt2img(
        ids, ids, height=SIZE, width=SIZE, steps=STEPS, guidance_scale=GUIDANCE, seed=5)
        for skip in (1, 2)}
    assert (out[1] - out[2]).abs().max().item() > 0.1
