"""Inpainting against the JAX package, on the CPU: the latent mask, the
denoise loop's ``extra`` channels and ``SDXLPipeline.inpaint`` on the tiny
9-channel pipeline of the JAX package's ``tests/test_inpaint.py``.

The same numpy weights and inputs (from seeds) go through both packages in
float32; the JAX side runs its reference binding, the port its reference,
default and all-kernel bindings (on CPU tensors the kernels' plain
versions). The port's initial noise is replaced by the JAX pipeline's own
draw for the same seeds. Tolerances:

  * the latent mask: exact (the same pixels);
  * the loop with a stand-in UNet that reads the extra channels: 2e-6 of
    the largest latent (a few float32 ulps);
  * inpaint's images (tiny pipeline, 2-3 steps, values in [-1, 1]): 1e-4
    (summation order through the tiny UNet and VAE).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu.compile import CompileConfig as JCompileConfig
from stabletriton_tpu.models import clip as jclip
from stabletriton_tpu.models import unet as junet
from stabletriton_tpu.models import vae as jvae
from stabletriton_tpu.runtime import pipeline as jpipe
from stabletriton_tpu.runtime import scheduler as jsched
from stabletriton_tpu.runtime.denoise import make_denoise_loop as jmake_loop
from stabletriton_tpu_torch.compile import ALL_KERNEL_OVERRIDES, CompileConfig
from stabletriton_tpu_torch.io.convert import params_from_numpy
from stabletriton_tpu_torch.runtime import pipeline as tpipe
from stabletriton_tpu_torch.runtime import scheduler as tsched
from stabletriton_tpu_torch.runtime.denoise import SOLVERS
from stabletriton_tpu_torch.runtime.denoise import make_denoise_loop as tmake_loop
from test_torch_port_img2img import (  # noqa: F401
    _ids, jax_ancestral, jax_noise, np_init, one_torch_thread, stand_in)

SIZE = 32
IMAGE_TOL = 1e-4
LOOP_TOL = 2e-6
BINDINGS = {"reference": CompileConfig(backend="reference", dtype="float32"),
            "default": CompileConfig(dtype="float32"),
            "all_kernels": CompileConfig(dtype="float32", overrides=ALL_KERNEL_OVERRIDES)}


def inpaint_configs():
    """JAX's tiny inpainting pipeline: the tiny base with in_channels=9."""
    ucfg, c1, c2, vcfg = tpipe.tiny_configs()
    return dataclasses.replace(ucfg, in_channels=9), c1, c2, vcfg


def _as_jax(cfgs):
    ucfg, c1, c2, vcfg = cfgs
    return (junet.UNetConfig(**dataclasses.asdict(ucfg)),
            jclip.CLIPTextConfig(**dataclasses.asdict(c1)),
            jclip.CLIPTextConfig(**dataclasses.asdict(c2)),
            jvae.VAEConfig(**dataclasses.asdict(vcfg)))


def inpaint_params():
    ju, jc1, jc2, jv = _as_jax(inpaint_configs())
    return {"unet": np_init(junet.unet_param_shapes(ju), 5),
            "text_encoder": np_init(jclip.clip_param_shapes(jc1), 1),
            "text_encoder_2": np_init(jclip.clip_param_shapes(jc2), 2),
            "vae": {**np_init(jvae.vae_decoder_param_shapes(jv), 3),
                    **np_init(jvae.vae_encoder_param_shapes(jv), 6)}}


def port_pipeline(params, config=BINDINGS["reference"], **kw):
    ucfg, c1, c2, vcfg = inpaint_configs()
    return tpipe.SDXLPipeline(unet_config=ucfg, clip_config=c1, clip2_config=c2,
                              vae_config=vcfg, params=params_from_numpy(params),
                              compile_config=config, device="cpu", **kw)


def _sigmas(steps):
    return [float(v) for v in jsched.make_schedule(jsched.SchedulerConfig(), steps).sigmas]


def _inputs(batch=2):
    rng = np.random.default_rng(4)
    image = rng.uniform(-1, 1, (batch, SIZE, SIZE, 3)).astype(np.float32)
    mask = np.zeros((batch, SIZE, SIZE, 1), np.float32)
    mask[0, 7:21, 9:26] = 1.0   # edges off the latent grid
    mask[-1, 16:, :13] = 1.0
    return image, mask


# --------------------------------------------------------------------------
# the latent mask
# --------------------------------------------------------------------------


@pytest.mark.parametrize("f,hw", [(8, 64), (8, 1024), (2, 32)])
def test_latent_mask_picks_jax_pixels(f, hw):
    """The nearest downsample of a mask whose edges fall off the f-pixel
    grid: the same pixels as JAX's ``jax.image.resize(..., "nearest")``
    (f i + f / 2, not f i), exactly."""
    rng = np.random.default_rng(f + hw)
    mask = np.zeros((2, hw, hw, 1), np.float32)
    for b in range(2):
        t, le = rng.integers(1, hw // 2, 2)
        mask[b, t:t + hw // 3 + 3, le:le + hw // 4 + 5] = 1.0
    want = np.asarray(jax.image.resize(jnp.asarray(mask), (2, hw // f, hw // f, 1), "nearest"))
    got = tpipe.latent_mask(torch.from_numpy(mask), f)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert not np.array_equal(got.numpy(), mask[:, ::f, ::f])  # pixel f i differs


# --------------------------------------------------------------------------
# the loop's extra channels, on a stand-in UNet
# --------------------------------------------------------------------------


def _fake_unet_torch(params, sample, t, ctx, te, tid):
    """eps over the 4 latent channels from all 9 input channels: the row's
    extra channels (the mask and the masked latents), its ctx and t move it,
    so a wrong half or a scaled extra shows."""
    lat, extra = sample[..., :4], sample[..., 4:]
    return (0.1 * lat + 0.3 * extra[..., :1] - 0.2 * extra[..., 1:]
            + ctx.mean(dim=(1, 2)).reshape(-1, 1, 1, 1) + 1e-4 * t.reshape(-1, 1, 1, 1))


def _fake_unet_jax(params, sample, t, ctx, te, tid):
    lat, extra = sample[..., :4], sample[..., 4:]
    return (0.1 * lat + 0.3 * extra[..., :1] - 0.2 * extra[..., 1:]
            + ctx.mean(axis=(1, 2)).reshape(-1, 1, 1, 1) + 1e-4 * t.reshape(-1, 1, 1, 1))


def _fake_pair(torch_side):
    """DeepCache's stand-in (full, shallow): the cache is the full pass's
    input's extra channels, so the shallow pass splices the extra of the
    last full pass of its rows."""
    unet = _fake_unet_torch if torch_side else _fake_unet_jax

    def full(params, inp, t, ctx, te, tid, tc=None):
        return unet(params, inp, t, ctx, te, tid), inp[..., 4:8]

    def shallow(params, inp, t, ctx, te, tid, tc, cache):
        return unet(params, inp, t, ctx, te, tid) + 0.05 * cache

    return full, shallow


LOOP_CASES = [(solver, mode, dc) for solver in SOLVERS
              for mode in ("cfg", "no_cfg", "interval") for dc in (None, 2)]


@pytest.mark.parametrize("solver,mode,dc", LOOP_CASES)
def test_loop_extra_matches_jax(solver, mode, dc):
    """5 steps, batch 2, CFG-doubled extra (the uncond rows differ from
    the cond rows here, so its halving shows): every solver x {CFG,
    guidance_scale 1, a window over steps 1-3} x {no DeepCache, interval 2}
    against JAX's make_denoise_loop with the same ``extra``."""
    s = _sigmas(5)
    g, gi = {"cfg": (5.0, None), "no_cfg": (1.0, None),
             "interval": (5.0, ((s[3] + s[4]) / 2, (s[0] + s[1]) / 2))}[mode]
    rng = np.random.default_rng(3)
    lat = (rng.standard_normal((2, 4, 4, 4)) * 10).astype(np.float32)
    ctx = rng.standard_normal((4, 3, 5)).astype(np.float32)
    extra = rng.standard_normal((4, 4, 4, 5)).astype(np.float32)
    noise = rng.standard_normal((5, 2, 4, 4, 4)).astype(np.float32)
    kw_j = {"noise": jnp.asarray(noise)} if solver == "euler_a" else {}
    jdc = None if dc is None else (dc, *_fake_pair(False), (4, 4, 4))
    tdc = None if dc is None else (dc, *_fake_pair(True), (4, 4, 4))
    want = jmake_loop(_fake_unet_jax, jsched.make_schedule(jsched.SchedulerConfig(), 5),
                      guidance_scale=g, solver=solver, guidance_interval=gi, deep_cache=jdc)(
        {}, jnp.asarray(lat), jnp.asarray(ctx), None, None, jnp.asarray(extra), **kw_j)
    got = tmake_loop(_fake_unet_torch, tsched.make_schedule(tsched.SchedulerConfig(), 5),
                     guidance_scale=g, solver=solver, guidance_interval=gi, deep_cache=tdc)(
        {}, torch.from_numpy(lat), torch.from_numpy(ctx), None, None,
        torch.from_numpy(noise) if solver == "euler_a" else None, torch.from_numpy(extra))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, atol=LOOP_TOL * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("guidance,rows", [(5.0, [4, 2]), (1.0, [2, 2])])
def test_loop_extra_rows_follow_guidance(guidance, rows):
    """The UNet's input holds 9 channels, the extra unscaled: 2B rows on a
    guided evaluation, the B cond rows outside the window (step 1 of 2
    here) and without CFG; an extra that is not CFG-doubled raises."""
    s = _sigmas(2)
    seen = []

    def unet(params, sample, t, ctx, te, tid):
        seen.append((sample.shape[0], sample.shape[-1], sample[..., 4:].clone()))
        return sample[..., :4] * 0.0

    extra = torch.arange(4.0).reshape(4, 1, 1, 1).expand(4, 2, 2, 5).contiguous()
    loop = tmake_loop(unet, tsched.make_schedule(tsched.SchedulerConfig(), 2),
                      guidance_scale=guidance, guidance_interval=(s[0], s[0]))
    loop({}, torch.ones(2, 2, 2, 4), torch.zeros(4, 3, 5), None, None, None, extra)
    assert [n for n, _, _ in seen] == rows and all(c == 9 for _, c, _ in seen)
    for n, _, got in seen:
        assert torch.equal(got, extra if n == 4 else extra[2:])
    with pytest.raises(ValueError, match="CFG-doubled"):
        loop({}, torch.ones(2, 2, 2, 4), torch.zeros(4, 3, 5), None, None, None, extra[:2])


# --------------------------------------------------------------------------
# SDXLPipeline.inpaint
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def inpaint_case():
    """The numpy weights, the inputs, and the JAX pipeline's images of each
    mode (computed once per mode)."""
    params = inpaint_params()
    ucfg, c1, c2, vcfg = _as_jax(inpaint_configs())
    jp = jpipe.SDXLPipeline(
        unet_config=ucfg, clip_config=c1, clip2_config=c2, vae_config=vcfg,
        params={g: {k: jnp.asarray(v) for k, v in tree.items()} for g, tree in params.items()},
        compile_config=JCompileConfig(backend="reference", dtype="float32"))
    image, mask = _inputs()
    ids = _ids(c1, 2)
    images = {}

    def jax_images(mode):
        if mode not in images:
            images[mode] = np.asarray(jp.inpaint(jnp.asarray(image), jnp.asarray(mask),
                                                 jnp.asarray(ids), jnp.asarray(ids),
                                                 **MODES[mode]))
        return images[mode]

    return params, image, mask, ids, jax_images


def _modes():
    s = _sigmas(3)
    return {
        "euler": dict(steps=2, seed=[3, 4]),
        "heun_interval_deep_cache": dict(steps=3, seed=[3, 4], solver="heun", deep_cache=2,
                                         guidance_interval=((s[1] + s[2]) / 2, s[0] + 1.0)),
        "no_cfg": dict(steps=2, seed=[3, 4], guidance_scale=1.0),
        "euler_a_no_cfg_deep_cache": dict(steps=3, seed=[5, 6], solver="euler_a",
                                        guidance_scale=0.5, deep_cache=2),
    }


MODES = _modes()


@pytest.mark.parametrize("binding", list(BINDINGS))
@pytest.mark.parametrize("mode", list(MODES))
def test_inpaint_matches_jax(inpaint_case, mode, binding, monkeypatch):
    """Batch 2, the masks' edges off the latent grid: Euler; Heun with a
    guidance window that leaves the last evaluations cond-only and
    DeepCache every 2nd step (the extra's cond half and the shallow
    pass's 9-channel conv_in); guidance_scale 1 (the extra cut to its
    cond half once); Euler-A at guidance 0.5 with DeepCache. Images within
    1e-4 of JAX's under each binding."""
    params, image, mask, ids, jax_images = inpaint_case
    want = jax_images(mode)
    monkeypatch.setattr(tpipe, "initial_noise", jax_noise)
    monkeypatch.setattr(tpipe, "ancestral_noise", jax_ancestral)
    pipe = port_pipeline(params, BINDINGS[binding])
    got = pipe.inpaint(image, mask, ids, ids, **MODES[mode])
    assert got.shape == want.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=IMAGE_TOL, rtol=0)
    (sig,) = pipe.cache_signatures()
    assert sig[0] == "inpaint" and sig[1:4] == (2, SIZE, SIZE)


def test_inpaint_keeps_what_the_mask_keeps(inpaint_case, monkeypatch):
    """The latent mask and the masked image's latents reach the UNet: the
    image under a changed unmasked region changes, and a mask of zeros
    gives other images than a mask of ones."""
    params, image, mask, ids, _ = inpaint_case
    pipe = port_pipeline(params)
    kw = dict(steps=2, seed=[3, 4])
    base = pipe.inpaint(image, mask, ids, ids, **kw)
    other = image.copy()
    other[:, :4] = -other[:, :4]  # unmasked rows in both images
    assert not torch.allclose(pipe.inpaint(other, mask, ids, ids, **kw), base, atol=1e-3)
    assert not torch.allclose(pipe.inpaint(image, np.zeros_like(mask), ids, ids, **kw),
                              pipe.inpaint(image, np.ones_like(mask), ids, ids, **kw), atol=1e-3)
    assert len(pipe.cache_signatures()) == 1


def test_inpaint_refuses_a_non_inpaint_unet():
    pipe = tpipe.make_tiny_pipeline()
    with pytest.raises(ValueError, match="9-channel"):
        pipe.inpaint(np.zeros((1, SIZE, SIZE, 3), np.float32),
                     np.zeros((1, SIZE, SIZE, 1), np.float32),
                     _ids(pipe.clip_config, 1), _ids(pipe.clip2_config, 1))


def test_inpaint_refuses_without_encoder_weights(inpaint_case):
    params = dict(inpaint_case[0])
    params["vae"] = {k: v for k, v in params["vae"].items()
                     if not k.startswith(("encoder.", "quant_conv."))}
    pipe = port_pipeline(params)
    with pytest.raises(ValueError, match="no encoder weights"):
        pipe.inpaint(*_inputs(1), _ids(pipe.clip_config, 1), _ids(pipe.clip_config, 1), steps=1)


# --------------------------------------------------------------------------
# the inpaint loop under the replay runtime, the card stood in for (the
# img2img file's ``stand_in``)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(), dict(solver="heun", deep_cache=2),
                                dict(solver="euler_a")])
def test_inpaint_loop_captures_once_and_replays(inpaint_case, stand_in, kw):
    """inpaint's loop on the replay runtime: the first call captures, a
    second with another image, mask, prompt and seed replays the one graph
    of its signature and gives the eager loop's latents on its own inputs
    bit for bit; the extra channels are one more static input, a copy."""
    params, image, mask, ids, _ = inpaint_case
    pipe = port_pipeline(params)
    kw = dict(steps=2, **kw)
    pipe.inpaint(image, mask, ids, ids, seed=[1, 2], **kw)
    image2, mask2 = -image[::-1].copy(), mask[::-1].copy()
    ids2 = _ids(pipe.clip_config, 2, seed=5)
    got = pipe.inpaint(image2, mask2, ids2, ids2, seed=[7, 8], **kw)
    (prog,) = pipe._cache.values()
    (entry,) = prog.loop.captured.values()
    assert entry.graph.replays == 1
    neg = torch.as_tensor(pipe.clip_config.empty_prompt_ids(2, ids2.shape[1]), dtype=torch.long)
    tids = torch.as_tensor(ids2, dtype=torch.long)
    with torch.inference_mode():
        inputs = prog.loop_inputs(pipe.params, torch.from_numpy(image2), torch.from_numpy(mask2),
                                  tids, tids, neg, neg, [7, 8])
        eager = prog.loop.__wrapped__(pipe.params["unet"], *inputs)
        want = tpipe._decode_images(pipe.vae_config, pipe.params["vae"], eager)
    assert torch.equal(got, want)
    extra = inputs[-1]
    assert extra.shape == (4, SIZE // 2, SIZE // 2, 5)
    assert torch.equal(entry.inputs[-1], extra) and entry.inputs[-1] is not extra
