"""The SD1.5 slice of the port against the JAX package.

SD1.5 has 8 heads at every level, so its head dims (40, 80, 160) do not pack
into 128 lanes: the JAX package routes its attention to the head-major
Pallas kernels K3 (``_flash_kernel``) and K4 (``_single_kv_kernel_bh``) and to
the all-heads tiny-KV kernel K5 (``_single_kv_kernel``). Here the port's
attention wrappers (their plain version, on CPU tensors) go against JAX's
``flash_attention`` and its fused entry points, Pallas in interpret mode, at
small shapes that JAX routes to each kernel; each test asserts that route.
Then the SD1.5 configs, the tiny SD1.5 UNet, txt2img with ``clip_skip`` 1
and 2, and the serving engine over the tiny SD1.5 pipeline.

Inputs and weights are made with numpy from seeds. Tolerances: attention
f32 max abs 1e-5, bf16 2 bf16 ulps of the largest output (summation order
of two implementations); UNet and images f32 atol 1e-3 (the Pallas kernels'
own gate, as in ``test_torch_port_slice.py``).
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
from stabletriton_tpu.kernels.common import round_up
from stabletriton_tpu.models import clip as jclip
from stabletriton_tpu.models import unet as junet
from stabletriton_tpu.models import vae as jvae
from stabletriton_tpu.runtime import pipeline as jpipe
from stabletriton_tpu_torch import ops as tops
from stabletriton_tpu_torch.compile import (
    ALL_KERNEL_OVERRIDES,
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
from stabletriton_tpu_torch.runtime.serving import Request, ServingEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


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
# attention: K3, K4, K5 at unpackable head dims
# --------------------------------------------------------------------------


def jax_route(sq: int, sk: int, h: int, d: int, itemsize: int) -> str:
    """The Pallas kernel JAX's ``flash_attention`` runs for this shape, by
    its own routing functions (no tuned table: the CPU has none)."""
    if jfa.pack_factor(h, d) > 1:
        return "packed"
    mode, _ = jfa._attn_layout(sk, h, d)
    _, bk = jfa._pick_blocks(sq, sk, h, d, itemsize)
    block_k = min(bk, round_up(sk, jfa.LANES))
    if sk <= jfa.LANES:
        block_k = round_up(sk, jfa.LANES)
    sk_p = round_up(sk, block_k)
    if mode == "allheads" and sk_p <= jfa.LANES:
        return "K5"
    return "K4" if sk_p == block_k else "K3"


def _attn_close(j, t, dtype):
    j = np.asarray(j.astype(jnp.float32))
    t = t.float().numpy()
    if dtype == torch.float32:
        atol = 1e-5
    else:  # 2 bf16 ulps (8 significant bits) of the largest output
        atol = 2 * 2.0 ** (math.floor(math.log2(np.abs(j).max())) - 7)
    np.testing.assert_allclose(t, j, atol=atol, rtol=0)


def _inputs(rng, dtype, *shape):
    x = rng.standard_normal(shape).astype(np.float32)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return jnp.asarray(x, jd), torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,sq,sk,route", [
    (40, 64, 77, "K5"),      # cross attention: 77 keys padded to one 128 block
    (40, 300, 300, "K4"),    # the whole KV in one JAX block
    (40, 1100, 1100, "K3"),  # KV past one 1024 block: the loop, pad keys masked
    (80, 96, 77, "K5"),
    (80, 200, 200, "K4"),
    (160, 64, 64, "K5"),     # the mid-block self attention's form
    (160, 130, 130, "K4"),
])
def test_attention_vs_pallas_route(d, sq, sk, route, dtype):
    h = 2
    rng = np.random.default_rng(d + sq)
    (jq, tq), (jk, tk), (jv, tv) = (_inputs(rng, dtype, 1, s, h * d) for s in (sq, sk, sk))
    itemsize = 4 if dtype == torch.float32 else 2
    assert jax_route(sq, sk, h, d, itemsize) == route == tfa.attention_class(h, d, sk)
    j = jfa.flash_attention(jq, jk, jv, num_heads=h)
    _attn_close(j, tfa.flash_attention(tq, tk, tv, num_heads=h), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("entry,s,route", [("qkv", 300, "K4"), ("kv", 77, "K5")])
def test_fused_entries_d40_vs_pallas(entry, s, route, dtype):
    """JAX's fused entry points refuse to pack d=40 and split their fused
    operand into flash_attention; the port reads the same fused buffers."""
    h, d, sq = 2, 40, 96
    rng = np.random.default_rng(7)
    assert not jfa._can_pack(h * d, h, d)
    assert jax_route(s if entry == "qkv" else sq, s, h, d, 4) == route
    assert tfa.attention_class(h, d, s) == route
    if entry == "qkv":
        jx, tx = _inputs(rng, dtype, 2, s, 3 * h * d)
        j = jfa.flash_attention_qkv(jx, num_heads=h)
        t = tfa.flash_attention_qkv(tx, num_heads=h)
    else:
        (jq, tq), (jkv, tkv) = _inputs(rng, dtype, 2, sq, h * d), _inputs(rng, dtype, 2, s,
                                                                          2 * h * d)
        j = jfa.flash_attention_kv(jq, jkv, num_heads=h)
        t = tfa.flash_attention_kv(tq, tkv, num_heads=h)
    _attn_close(j, t, dtype)


@pytest.mark.parametrize("d,sq,sk", [(40, 64, 77), (80, 200, 200), (64, 128, 77)])
def test_attention_bf16_prescales_q_like_jax(d, sq, sk):
    """bf16: q * bf16(scale*log2e) is rounded to bf16 before the product, as
    in JAX. Scaling the f32 scores instead changed 56-62% of the outputs by
    up to 1.5 bf16 ulps at these shapes; with the JAX form at most 0.05%
    differ (summation order)."""
    h = 2
    rng = np.random.default_rng(d + sq)
    (jq, tq), (jk, tk), (jv, tv) = (_inputs(rng, torch.bfloat16, 1, s, h * d)
                                    for s in (sq, sk, sk))
    j = np.asarray(jfa.flash_attention(jq, jk, jv, num_heads=h).astype(jnp.float32))
    t = tfa.flash_attention(tq, tk, tv, num_heads=h).float().numpy()
    assert (t != j).mean() <= 1e-3


def test_attention_class_table():
    """The JAX rule at the SD1.5 and SDXL path shapes (CFG batch 2)."""
    cases = {(8, 40, 4096): "K3", (8, 80, 1024): "K4", (8, 160, 256): "K4",
             (8, 160, 64): "K5", (8, 40, 77): "K5", (8, 80, 77): "K5", (8, 160, 77): "K5",
             (10, 64, 4096): "K2", (20, 64, 1024): "K1", (10, 64, 77): "K1",
             (1, 512, 16384): "K3", (1, 512, 4096): "K3"}
    for (h, d, sk), cls in cases.items():
        assert tfa.attention_class(h, d, sk) == cls, (h, d, sk)
        if h > 1:
            assert jax_route(sk, sk, h, d, 2) == ("packed" if cls in ("K1", "K2") else cls)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------


def test_sd15_configs_match_jax():
    jc, tc = junet.sd15_unet_config(), tunet.sd15_unet_config()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    shapes = tunet.unet_param_shapes(tc)
    assert shapes == junet.unet_param_shapes(jc)
    assert sum(math.prod(s) for s in shapes.values()) == 859_520_964
    assert {tc.num_heads(c) for c in tc.block_out_channels} == {8}
    assert (dataclasses.asdict(jclip.sd15_text_encoder_config())
            == dataclasses.asdict(tclip.sd15_text_encoder_config()))
    assert (dataclasses.asdict(jvae.sd15_vae_config())
            == dataclasses.asdict(tvae.sd15_vae_config()))
    assert tvae.sd15_vae_config().scaling_factor == 0.18215


def test_tiny_sd15_configs_match_jax(monkeypatch):
    # only the configs are compared: skip JAX's weight init
    for mod, name in [(junet, "init_unet_params"), (jclip, "init_clip_params"),
                      (jvae, "init_vae_params")]:
        monkeypatch.setattr(mod, name, lambda *a, **k: {})
    monkeypatch.setenv("ST_TPU_COMPILE_CACHE", "0")
    jp = jpipe.make_tiny_sd15_pipeline()
    ucfg, c1, vcfg = tpipe.tiny_sd15_configs()
    assert dataclasses.asdict(jp.unet_config) == dataclasses.asdict(ucfg)
    assert dataclasses.asdict(jp.clip_config) == dataclasses.asdict(c1)
    assert dataclasses.asdict(jp.vae_config) == dataclasses.asdict(vcfg)
    assert not ucfg.has_addition_embedding
    assert all(tfa.pack_factor(4, c // 4) == 1 for c in ucfg.block_out_channels)


# --------------------------------------------------------------------------
# tiny SD1.5 UNet and txt2img
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sd15_weights():
    """The tiny SD1.5 pipeline's configs and numpy weights for both packages."""
    ucfg, c1, vcfg = tpipe.tiny_sd15_configs()
    jcfg = (junet.UNetConfig(**dataclasses.asdict(ucfg)),
            jclip.CLIPTextConfig(**dataclasses.asdict(c1)),
            jvae.VAEConfig(**dataclasses.asdict(vcfg)))
    params = {
        "unet": np_init(junet.unet_param_shapes(jcfg[0]), 20),
        "text_encoder": np_init(jclip.clip_param_shapes(jcfg[1]), 21),
        "vae": np_init(jvae.vae_decoder_param_shapes(jcfg[2]), 22),
    }
    return jcfg, params


# 36^2 latent: level 0 attends over 1296 keys (K3 in JAX), level 1 over
# 324 (K4), cross attention over 16 (K5)
UNET_LATENT = 36


# the port's kernel bindings -> the JAX package's overrides on its default
# Pallas binding
UNET_BINDINGS = {
    "cuda": ((), ()),
    "all_kernels": (ALL_KERNEL_OVERRIDES,
                    (("group_norm", "pallas"), ("layer_norm", "pallas"), ("geglu", "pallas"),
                     ("gn_conv2d", "fused"), ("linear", "pallas"), ("time_embed", "pallas"))),
}


@pytest.mark.parametrize("binding", ["reference", "cuda", "all_kernels"])
def test_tiny_sd15_unet_vs_jax(sd15_weights, binding):
    """No added conditioning: text_embeds and time_ids have width 0. The
    "cuda" binding (its kernels' plain versions on the CPU, fused
    projections, cross K/V cache) against JAX's default Pallas binding;
    "all_kernels" adds the fused-op, linear and time_embed kernels to both
    (JAX's in interpret mode)."""
    (jcfg, _, _), params = sd15_weights
    rng = np.random.default_rng(5)
    sample = rng.standard_normal((2, UNET_LATENT, UNET_LATENT, 4)).astype(np.float32)
    t = np.array([999.0, 261.0], np.float32)
    ctx = rng.standard_normal((2, 16, 32)).astype(np.float32)
    empty = np.zeros((2, 0), np.float32)
    overrides, joverrides = UNET_BINDINGS.get(binding, ((), ()))
    jb = {} if binding == "reference" else jresolve(JCompileConfig(dtype="float32",
                                                                   overrides=joverrides))

    @jax.jit
    def jstep(p, sample, t, ctx, empty):
        with jops.use_backends(jb):
            if binding == "reference":
                return junet.unet_apply(jcfg, p, sample, t, ctx, empty, empty)
            kv = junet.precompute_cross_kv(jcfg, p, ctx)
            return junet.unet_apply(jcfg, p, sample, t, None, empty, empty, cross_kv=kv)

    jp = {k: jnp.asarray(v) for k, v in params["unet"].items()}
    j = jstep(jp if binding == "reference" else jfuse(jp), sample, t, ctx, empty)

    tcfg, _, _ = tpipe.tiny_sd15_configs()
    tp = params_from_numpy({"unet": params["unet"]})["unet"]
    args = [torch.from_numpy(a) for a in (sample, t, ctx, empty)]
    if binding == "reference":
        out = tunet.unet_apply(tcfg, tp, args[0], args[1], args[2], args[3], args[3])
    else:
        tp = fuse_attention_projections(tp)
        before = tfa.LAUNCHES.count
        with tops.use_backends(resolve_binding(CompileConfig(dtype="float32",
                                                             overrides=overrides))):
            kv = tunet.precompute_cross_kv(tcfg, tp, args[2])
            out = tunet.unet_apply(tcfg, tp, args[0], args[1], None, args[3], args[3],
                                   cross_kv=kv)
        assert tfa.LAUNCHES.count == before  # CPU tensors launch nothing
    assert out.shape == (2, UNET_LATENT, UNET_LATENT, 4)
    np.testing.assert_allclose(out.numpy(), np.asarray(j), atol=1e-3, rtol=0)


SIZE, STEPS, GUIDANCE = 72, 2, 7.5  # 72^2 image: 36^2 latent through the tiny VAE


def _ids(cfg, rng, batch):
    ids = np.full((batch, cfg.max_position_embeddings), cfg.eos_token_id, np.int32)
    for i in range(batch):
        n = 3 + 2 * i
        ids[i, 0] = cfg.bos_token_id
        ids[i, 1:1 + n] = rng.integers(0, 90, n)
        ids[i, 1 + n] = cfg.eos_token_id
    return ids


def jax_initial_noise(seeds, shape) -> np.ndarray:
    """The JAX pipeline's initial noise: one PRNG key per image seed."""
    keys = jax.vmap(jax.random.PRNGKey)(jnp.asarray(np.asarray(seeds, np.uint32)))
    return np.array(jax.vmap(lambda k: jax.random.normal(k, shape, jnp.float32))(keys))


@pytest.mark.parametrize("clip_skip", [1, 2])
@pytest.mark.parametrize("jax_backend", ["reference", "pallas"])
def test_tiny_sd15_txt2img_vs_jax(sd15_weights, clip_skip, jax_backend, monkeypatch):
    """The port's SD1.x branch against JAX's ``make_tiny_sd15_pipeline``
    configs, the same weights, ids and seeds. JAX ``backend="pallas"`` runs
    K3, K4 and K5 in interpret mode, held against the port's "cuda"
    binding; ids2 is accepted and not read by either."""
    (ju, jc1, jv), params = sd15_weights
    monkeypatch.setenv("ST_TPU_COMPILE_CACHE", "0")
    rng = np.random.default_rng(13)
    ids = _ids(jc1, rng, 2)
    junk2 = np.zeros_like(ids)
    seed = 40
    jpipe_ = jpipe.SDXLPipeline(
        unet_config=ju, clip_config=jc1, clip2_config=jc1, vae_config=jv,
        params={g: {k: jnp.asarray(v) for k, v in p.items()} for g, p in params.items()},
        compile_config=JCompileConfig(backend=jax_backend, dtype="float32"),
        clip_skip=clip_skip)
    want = np.asarray(jpipe_.txt2img(jnp.asarray(ids), jnp.asarray(junk2), height=SIZE,
                                     width=SIZE, steps=STEPS, guidance_scale=GUIDANCE,
                                     seed=seed))

    lat = SIZE // jv.spatial_scale_factor
    noise = torch.from_numpy(jax_initial_noise([seed, seed + 1], (lat, lat, 4)))
    monkeypatch.setattr(tpipe, "initial_noise", lambda seeds, shape, device: noise)
    config = (CompileConfig(backend="reference", dtype="float32") if jax_backend == "reference"
              else CompileConfig(dtype="float32"))
    pipe = tpipe.make_tiny_sd15_pipeline(config, params=params_from_numpy(params))
    pipe.clip_skip = clip_skip
    got = pipe.txt2img(ids, junk2, height=SIZE, width=SIZE, steps=STEPS,
                       guidance_scale=GUIDANCE, seed=seed)
    assert got.shape == want.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


def test_clip_skip_cases_are_told_apart(sd15_weights):
    """The two clip_skip cases above condition on different encoder layers:
    their images differ by far more than the parity tolerance, so each case
    holds the port to JAX's choice of layer."""
    _, params = sd15_weights
    ids = _ids(tpipe.tiny_sd15_configs()[1], np.random.default_rng(13), 2)
    out = {}
    for skip in (1, 2):
        pipe = tpipe.make_tiny_sd15_pipeline(params=params_from_numpy(params))
        pipe.clip_skip = skip
        out[skip] = pipe.txt2img(ids, ids, height=SIZE, width=SIZE, steps=STEPS,
                                 guidance_scale=GUIDANCE, seed=40)
    assert (out[1] - out[2]).abs().max().item() > 0.1


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


class IdentityTok:
    """Deterministic token ids without vocab files (BOS 98 ... EOS 99)."""

    def encode_batch(self, texts, *, max_len=16, pad=99, **kw):
        out = np.full((len(texts), max_len), pad, np.int32)
        for i, t in enumerate(texts):
            ids = [98] + [(ord(c) % 90) + 5 for c in t[: max_len - 2]] + [99]
            out[i, : len(ids)] = ids
        return out


def test_serving_sd15_batched_equals_solo():
    """A ServingEngine over the tiny SD1.5 pipeline, with the one tokenizer
    for both slots: co-batched requests give each image of its solo run."""
    tok = IdentityTok()
    eng = ServingEngine(tpipe.make_tiny_sd15_pipeline(), tok, tok, max_wait_s=0.2)
    try:
        kw = dict(height=32, width=32, steps=2, guidance_scale=GUIDANCE)
        reqs = [("a dog", 11), ("a cat", 12), ("a fox", 13)]
        futs = [eng.submit(Request(prompt=p, seed=s, **kw)) for p, s in reqs]
        batched = [f.result(timeout=300) for f in futs]
        solo = [eng.generate(p, seed=s, **kw) for p, s in reqs]
    finally:
        eng.close()
    assert not eng._thread.is_alive()
    for img, alone in zip(batched, solo):
        assert img.shape == (32, 32, 3) and np.isfinite(img).all()
        assert img.min() >= -1 and img.max() <= 1
        np.testing.assert_allclose(alone, img, atol=2e-5)
    assert not np.array_equal(batched[0], batched[1])
