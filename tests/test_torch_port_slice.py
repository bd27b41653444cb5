"""The whole port slice against the JAX package, and the port's serving engine.

The slice: dual CLIP -> Euler CFG denoise loop (2 steps) -> VAE decode, on
the tiny pipeline, float32 on the CPU. The same numpy weights, token ids and
initial latents go through the JAX package's pieces (``encode_sdxl_prompts``,
``make_denoise_loop``, ``_decode_images``) and through the port's
``SDXLPipeline.txt2img`` with its initial noise replaced by the same numpy
latents. Tolerance on the images: atol 1e-3; measured max abs deviation
7.3e-6 (reference binding) and 8.1e-6 (kernel binding), on images with a
standard deviation of 0.54. The "fused" case runs the port's fused-op
binding (CompileConfig.overrides) against the JAX pipeline under the same
overrides, its Pallas kernels in interpret mode; "all_kernels" adds linear
and time_embed to both.
"""

import dataclasses
import pathlib
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu import ops as jops
from stabletriton_tpu.compile import CompileConfig as JCompileConfig
from stabletriton_tpu.compile import resolve_binding as jresolve_binding
from stabletriton_tpu.models import clip as jclip
from stabletriton_tpu.models import unet as junet
from stabletriton_tpu.models import vae as jvae
from stabletriton_tpu.runtime import scheduler as jsched
from stabletriton_tpu.runtime.denoise import make_denoise_loop as jmake_loop
from stabletriton_tpu.runtime.pipeline import _decode_images as jdecode_images
from stabletriton_tpu_torch.compile import ALL_KERNEL_OVERRIDES, FUSED_OP_OVERRIDES, CompileConfig
from stabletriton_tpu_torch.io.convert import params_from_numpy
from stabletriton_tpu_torch.runtime import pipeline as tpipe
from stabletriton_tpu_torch.runtime.serving import Request, ServingEngine, _bucket
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

STEPS, SIZE, GUIDANCE = 2, 32, 5.0


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


def _ids(cfg, rng, batch):
    ids = np.full((batch, cfg.max_position_embeddings), cfg.eos_token_id, np.int32)
    for i in range(batch):
        n = 3 + 2 * i
        ids[i, 0] = cfg.bos_token_id
        ids[i, 1:1 + n] = rng.integers(0, 90, n)
        ids[i, 1 + n] = cfg.eos_token_id
    return ids


@pytest.fixture(scope="module")
def slice_case():
    ucfg, c1, c2, vcfg = tpipe.tiny_configs()
    jcfg = (junet.UNetConfig(**dataclasses.asdict(ucfg)),
            jclip.CLIPTextConfig(**dataclasses.asdict(c1)),
            jclip.CLIPTextConfig(**dataclasses.asdict(c2)),
            jvae.VAEConfig(**dataclasses.asdict(vcfg)))
    params = {
        "unet": np_init(junet.unet_param_shapes(jcfg[0]), 0),
        "text_encoder": np_init(jclip.clip_param_shapes(jcfg[1]), 1),
        "text_encoder_2": np_init(jclip.clip_param_shapes(jcfg[2]), 2),
        "vae": np_init(jvae.vae_decoder_param_shapes(jcfg[3]), 3),
    }
    rng = np.random.default_rng(11)
    batch = 2
    ids1, ids2 = _ids(c1, rng, batch), _ids(c2, rng, batch)
    lat = SIZE // vcfg.spatial_scale_factor
    noise = rng.standard_normal((batch, lat, lat, ucfg.in_channels)).astype(np.float32)

    schedule = jsched.make_schedule(jsched.SchedulerConfig(), STEPS)
    ju, jc1, jc2, jv = jcfg
    neg1, neg2 = c1.empty_prompt_ids(batch), c2.empty_prompt_ids(batch)
    images = {}

    def jax_images(binding: dict, guidance: float = GUIDANCE) -> np.ndarray:
        """The JAX pipeline's images, traced under ``binding``."""
        key = (tuple(sorted(binding.items())), guidance)
        if key in images:
            return images[key]

        def unet_step(p, sample, t, ctx, text_embeds, time_ids):
            return junet.unet_apply(ju, p, sample, t, ctx, text_embeds, time_ids)

        loop = jmake_loop(unet_step, schedule, guidance_scale=guidance)

        @jax.jit
        def program(p, ids1_all, ids2_all, latents):
            with jops.use_backends(binding):
                ctx, pooled = jclip.encode_sdxl_prompts(jc1, p["text_encoder"], jc2,
                                                        p["text_encoder_2"], ids1_all, ids2_all)
                tid = jnp.asarray([SIZE, SIZE, 0, 0, SIZE, SIZE], jnp.float32)
                time_ids = jnp.broadcast_to(tid, (2 * batch, 6))
                out = loop(p["unet"], latents, ctx, pooled, time_ids)
                return jdecode_images(jv, p["vae"], out)

        images[key] = np.asarray(program(
            params, jnp.asarray(np.concatenate([neg1, ids1])),
            jnp.asarray(np.concatenate([neg2, ids2])),
            jnp.asarray(noise * schedule.init_noise_sigma)))
        return images[key]

    return params, ids1, ids2, noise, jax_images


# the port's binding -> the JAX binding its images are held against
JAX_FUSED = (("group_norm", "pallas"), ("layer_norm", "pallas"), ("geglu", "pallas"),
             ("gn_conv2d", "fused"))
BINDINGS = {
    "reference": (CompileConfig(backend="reference", dtype="float32"), {}),
    "cuda": (CompileConfig(backend="cuda", dtype="float32"), {}),
    "fused": (CompileConfig(backend="cuda", dtype="float32", overrides=FUSED_OP_OVERRIDES),
              JAX_FUSED),
    "all_kernels": (CompileConfig(backend="cuda", dtype="float32",
                                  overrides=ALL_KERNEL_OVERRIDES),
                    JAX_FUSED + (("linear", "pallas"), ("time_embed", "pallas"))),
}


@pytest.mark.parametrize("backend", ["reference", "cuda", "fused", "all_kernels"])
def test_txt2img_slice_matches_jax(slice_case, backend, monkeypatch):
    """The "cuda" binding on CPU tensors runs the kernels' plain versions,
    with fused projections and the cross K/V cache, as on the card; "fused"
    adds the fused-op overrides, against the JAX pipeline under the same
    overrides (on the JAX reference base: its Pallas attention and conv
    kernels compute what the port's reference ops do); "all_kernels" also
    binds linear and time_embed to their kernels in both packages."""
    params, ids1, ids2, noise, jax_images = slice_case
    config, jax_overrides = BINDINGS[backend]
    want = jax_images(jresolve_binding(JCompileConfig(backend="reference",
                                                      overrides=tuple(jax_overrides))))
    monkeypatch.setattr(tpipe, "initial_noise",
                        lambda seeds, shape, device: torch.from_numpy(noise))
    pipe = tpipe.make_tiny_pipeline(config, params=params_from_numpy(params))
    if backend != "reference":
        assert any(k.endswith("to_qkv.weight") for k in pipe.params["unet"])
    got = pipe.txt2img(ids1, ids2, height=SIZE, width=SIZE, steps=STEPS,
                       guidance_scale=GUIDANCE)
    assert got.shape == want.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("guidance", [0.0, 0.5, 1.0])
def test_txt2img_without_cfg_matches_jax(slice_case, guidance, monkeypatch):
    """guidance_scale <= 1 runs the cond branch alone in both packages (the
    JAX loop's no_cfg mode): f32, reference binding, 2 Euler steps, the same
    injected noise, max abs 1e-4 on images of std ~0.5 (summation order)."""
    params, ids1, ids2, noise, jax_images = slice_case
    want = jax_images(jresolve_binding(JCompileConfig(backend="reference")), guidance)
    monkeypatch.setattr(tpipe, "initial_noise",
                        lambda seeds, shape, device: torch.from_numpy(noise))
    pipe = tpipe.make_tiny_pipeline(BINDINGS["reference"][0], params=params_from_numpy(params))
    got = pipe.txt2img(ids1, ids2, height=SIZE, width=SIZE, steps=STEPS,
                       guidance_scale=guidance)
    assert got.shape == want.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("guidance,rows", [(1.0, 2), (5.0, 4)])
def test_unet_batch_rows_follow_guidance(guidance, rows, monkeypatch):
    """One step at batch 2: the UNet sees the B cond rows alone when
    guidance_scale <= 1 (its cross K/V precompute too), and the 2B CFG pair
    otherwise."""
    seen = []
    real_apply, real_pre = tpipe.unet_apply, tpipe.precompute_cross_kv

    def apply(cfg, p, sample, t, ctx, te, tid, **kw):
        seen.append(("unet", sample.shape[0], t.shape[0], te.shape[0], tid.shape[0]))
        return real_apply(cfg, p, sample, t, ctx, te, tid, **kw)

    def pre(cfg, p, ctx):
        seen.append(("precompute", ctx.shape[0]))
        return real_pre(cfg, p, ctx)

    monkeypatch.setattr(tpipe, "unet_apply", apply)
    monkeypatch.setattr(tpipe, "precompute_cross_kv", pre)
    pipe = tpipe.make_tiny_pipeline()
    ids = _ids(pipe.clip_config, np.random.default_rng(0), 2)
    pipe.txt2img(ids, ids, height=SIZE, width=SIZE, steps=1, guidance_scale=guidance)
    assert seen == [("precompute", rows), ("unet", rows, rows, rows, rows)]


def test_txt2img_seeds_and_signature_cache():
    pipe = tpipe.make_tiny_pipeline()
    ids = _ids(pipe.clip_config, np.random.default_rng(0), 2)
    a = pipe.txt2img(ids, ids, height=SIZE, width=SIZE, steps=1, seed=[5, 6])
    # image 1 of the pair equals a solo run of row 1 with the same seed
    c = pipe.txt2img(ids[1:], ids[1:], height=SIZE, width=SIZE, steps=1, seed=6)
    np.testing.assert_allclose(a[1].numpy(), c[0].numpy(), atol=2e-5)
    assert not torch.equal(a[0], a[1])
    assert len(pipe.cache_signatures()) == 2  # batch 2 and batch 1
    lat = pipe.txt2img(ids, ids, height=SIZE, width=SIZE, steps=1, seed=0,
                       return_latents=True)
    assert lat.shape == (2, 16, 16, 4)
    with pytest.raises(ValueError, match="multiples"):
        pipe.txt2img(ids, ids, height=30, width=SIZE, steps=1)


def test_pipeline_runs_on_the_card_unless_told_otherwise():
    """SDXLPipeline's device defaults to the card, read from the dataclass
    without building a pipeline; with no card, building one on that default
    raises (it never falls back to the CPU). The tiny twins stay on the CPU."""
    default = {f.name: f.default for f in dataclasses.fields(tpipe.SDXLPipeline)}["device"]
    assert torch.device(default).type == "cuda"
    tiny = tpipe.make_tiny_pipeline()
    assert tiny.device == torch.device("cpu")
    assert tpipe.make_tiny_sd15_pipeline().device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tpipe.SDXLPipeline(unet_config=tiny.unet_config, clip_config=tiny.clip_config,
                               clip2_config=tiny.clip2_config, vae_config=tiny.vae_config,
                               params=tiny.params)


def test_port_imports_without_jax():
    code = ("import sys; sys.modules['jax'] = None; sys.modules['stabletriton_tpu'] = None\n"
            "import stabletriton_tpu_torch, stabletriton_tpu_torch.kernels\n"
            "import stabletriton_tpu_torch.runtime.serving, stabletriton_tpu_torch.io.convert\n"
            "assert not any(m == 'jax' or m.startswith(('jax.', 'stabletriton_tpu.'))\n"
            "               for m, v in sys.modules.items() if v is not None)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=pathlib.Path(__file__).resolve().parent.parent)
    assert proc.returncode == 0, proc.stderr


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


def test_bucket_sizes():
    assert [_bucket(n) for n in (1, 2, 3, 4, 5, 8, 20)] == [1, 2, 4, 4, 8, 8, 8]


@pytest.fixture(scope="module")
def engine():
    eng = ServingEngine(tpipe.make_tiny_pipeline(), IdentityTok(), IdentityTok(),
                        max_wait_s=0.2)
    yield eng
    eng.close()
    assert not eng._thread.is_alive()


def test_single_request(engine):
    img = engine.generate("a cat", height=SIZE, width=SIZE, steps=2, seed=7)
    assert img.shape == (SIZE, SIZE, 3)
    assert np.isfinite(img).all() and img.min() >= -1 and img.max() <= 1


def test_batching_keeps_each_image(engine):
    kw = dict(height=SIZE, width=SIZE, steps=2)
    solo = engine.generate("a dog", seed=11, **kw)
    futs = [engine.submit(Request(prompt=p, seed=s, **kw))
            for p, s in [("a dog", 11), ("x", 1), ("y", 2), ("z", 3)]]
    outs = [f.result(timeout=300) for f in futs]
    np.testing.assert_allclose(solo, outs[0], atol=2e-5)
    assert not np.array_equal(outs[1], outs[2])


def test_mixed_signatures_split_groups(engine):
    kw = dict(height=SIZE, width=SIZE)
    futs = [engine.submit(Request(prompt="a", steps=2, **kw)),
            engine.submit(Request(prompt="b", steps=3, **kw)),
            engine.submit(Request(prompt="c", steps=2, **kw))]
    assert all(f.result(timeout=300).shape == (SIZE, SIZE, 3) for f in futs)


def test_worker_runs_under_inference_mode_with_its_own_binding():
    """The binding is entered on the worker thread inside txt2img, and the
    worker runs under inference mode whatever the caller's thread does."""
    pipe = tpipe.make_tiny_pipeline(CompileConfig(dtype="float32"))
    seen = {}
    real = pipe._build

    def spy_build(**kw):
        program = real(**kw)

        def wrapped(*a):
            seen["thread"] = threading.current_thread()
            seen["inference"] = torch.is_inference_mode_enabled()
            return program(*a)

        return wrapped

    pipe._build = spy_build
    eng = ServingEngine(pipe, IdentityTok(), IdentityTok(), max_wait_s=0.01)
    try:
        with torch.enable_grad():
            img = eng.generate("p", height=SIZE, width=SIZE, steps=1)
    finally:
        eng.close()
    assert img.shape == (SIZE, SIZE, 3)
    assert seen["thread"] is eng._thread and seen["inference"]
    assert not eng._thread.is_alive()


def test_error_propagates():
    eng = ServingEngine(tpipe.make_tiny_pipeline(), IdentityTok(), IdentityTok(),
                        max_wait_s=0.01)
    try:
        fut = eng.submit(Request(prompt="p", height=31, width=SIZE, steps=1))
        with pytest.raises(ValueError, match="multiples"):
            fut.result(timeout=120)
    finally:
        eng.close()
