"""The VAE encoder, img2img (from latents and from pixels), the SDXL refiner
and TwoStageSDXL against the JAX package, on the CPU; the shape tables of
the encoder, the refiner and the 9-channel UNet; ``warmup``.

The same numpy weights and inputs (from seeds) go through both packages in
float32; the JAX side runs its reference binding, the port its reference,
default and all-kernel bindings (on CPU tensors the kernels' plain
versions). The port's initial noise, and a sampled encode's noise, are
replaced by the JAX package's own draws for the same seeds. Tolerances:

  * ``vae_encode`` on the tiny VAE (latents of order 1): 1e-5;
  * img2img, img2img_image and TwoStageSDXL on the tiny pipelines (images
    in [-1, 1] or latents of order 1, 2-4 steps): 1e-4 (summation order
    through the tiny UNet, CLIP and VAE).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu import ops as jops
from stabletriton_tpu.compile import CompileConfig as JCompileConfig
from stabletriton_tpu.compile import resolve_binding as jresolve
from stabletriton_tpu.models import clip as jclip
from stabletriton_tpu.models import unet as junet
from stabletriton_tpu.models import vae as jvae
from stabletriton_tpu.runtime import pipeline as jpipe
from stabletriton_tpu_torch import ops as tops
from stabletriton_tpu_torch.compile import ALL_KERNEL_OVERRIDES, CompileConfig, resolve_binding
from stabletriton_tpu_torch.io.convert import params_from_numpy
from stabletriton_tpu_torch.models import unet as tunet
from stabletriton_tpu_torch.models import vae as tvae
from stabletriton_tpu_torch.runtime import graphs as tgraphs
from stabletriton_tpu_torch.runtime import pipeline as tpipe

SIZE = 32
ENCODE_TOL = 1e-5
TOL = 1e-4
BINDINGS = {"reference": CompileConfig(backend="reference", dtype="float32"),
            "default": CompileConfig(dtype="float32"),
            "all_kernels": CompileConfig(dtype="float32", overrides=ALL_KERNEL_OVERRIDES)}
JAX_REFERENCE = jresolve(JCompileConfig(backend="reference"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The tiny pipelines on one intra-op thread: the suite runs files in
    several processes at once, whose thread pools would oversubscribe the
    cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


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


def _keys(seeds):
    return jax.vmap(jax.random.PRNGKey)(jnp.asarray(np.asarray(seeds, np.uint32)))


def jax_noise(seeds, shape, device):
    """The JAX pipeline's initial noise for ``seeds``: one key per image."""
    return torch.from_numpy(np.array(jax.vmap(
        lambda k: jax.random.normal(k, tuple(shape), jnp.float32))(_keys(seeds))))


def jax_ancestral(seeds, steps, shape, device):
    return torch.from_numpy(np.array(jpipe._ancestral_noise(_keys(seeds), steps, tuple(shape))))


def _ids(cfg, batch, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.full((batch, cfg.max_position_embeddings), cfg.eos_token_id, np.int32)
    for i in range(batch):
        n = 3 + 2 * i
        ids[i, 0] = cfg.bos_token_id
        ids[i, 1:1 + n] = rng.integers(0, 90, n)
    return ids


def _jax_cfg(cfg):
    kind = {tunet.UNetConfig: junet.UNetConfig, tvae.VAEConfig: jvae.VAEConfig}.get(
        type(cfg), jclip.CLIPTextConfig)
    return kind(**dataclasses.asdict(cfg))


# --------------------------------------------------------------------------
# shape tables
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["sdxl", "sd15", "tiny"])
def test_vae_encoder_shapes_match_jax(name):
    cfg = {"sdxl": tvae.sdxl_vae_config, "sd15": tvae.sd15_vae_config,
           "tiny": tvae.tiny_vae_config}[name]()
    assert tvae.vae_encoder_param_shapes(cfg) == jvae.vae_encoder_param_shapes(_jax_cfg(cfg))


@pytest.mark.parametrize("name", ["refiner", "sdxl_inpaint", "tiny_refiner", "tiny_inpaint"])
def test_unet_shapes_match_jax(name):
    """The SDXL refiner (``sdxl_refiner_unet_config`` against JAX's), SDXL-base
    with in_channels=9, and their tiny twins."""
    if name == "refiner":
        tcfg, jcfg = tunet.sdxl_refiner_unet_config(), junet.sdxl_refiner_unet_config()
        assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    else:
        tcfg = {"sdxl_inpaint": lambda: dataclasses.replace(tunet.sdxl_base_unet_config(),
                                                            in_channels=9),
                "tiny_refiner": lambda: tpipe.tiny_refiner_configs()[0],
                "tiny_inpaint": lambda: dataclasses.replace(tpipe.tiny_configs()[0],
                                                            in_channels=9)}[name]()
        jcfg = _jax_cfg(tcfg)
    shapes = tunet.unet_param_shapes(tcfg)
    assert shapes == junet.unet_param_shapes(jcfg)
    if "inpaint" in name:
        assert shapes["conv_in.weight"][2] == 9
    if name == "refiner":
        assert 2.2e9 < sum(int(np.prod(s)) for s in shapes.values()) < 2.35e9


def test_encoder_and_nine_channel_conv_in_round_trip_from_numpy():
    """params_from_numpy carries the encoder's keys and a 9-channel conv_in
    over from the JAX package's numpy dict unchanged."""
    vcfg = tvae.tiny_vae_config()
    enc = np_init(jvae.vae_encoder_param_shapes(_jax_cfg(vcfg)), 6)
    ucfg = dataclasses.replace(tpipe.tiny_configs()[0], in_channels=9)
    unet = np_init(junet.unet_param_shapes(_jax_cfg(ucfg)), 5)
    got = params_from_numpy({"vae": enc, "unet": unet})
    assert set(got["vae"]) == set(tvae.vae_encoder_param_shapes(vcfg))
    for k, v in enc.items():
        assert got["vae"][k].dtype == torch.float32 and np.array_equal(got["vae"][k].numpy(), v)
    assert tuple(got["unet"]["conv_in.weight"].shape) == (3, 3, 9, 32)
    assert np.array_equal(got["unet"]["conv_in.weight"].numpy(), unet["conv_in.weight"])


def test_init_vae_encoder_params_follows_the_table():
    """The table's keys and shapes, with the JAX package's init rule: zero
    biases, unit ".norm" / group_norm scales (conv_norm_out's, as JAX's,
    drawn), seeded."""
    cfg = tvae.tiny_vae_config()
    p = tvae.init_vae_encoder_params(cfg, 6)
    assert {k: tuple(v.shape) for k, v in p.items()} == tvae.vae_encoder_param_shapes(cfg)
    assert torch.equal(p["encoder.mid_block.resnets.0.norm1.weight"], torch.ones(16))
    assert torch.equal(p["encoder.mid_block.attentions.0.group_norm.weight"], torch.ones(16))
    assert torch.equal(p["quant_conv.bias"], torch.zeros(8))
    assert torch.equal(tvae.init_vae_encoder_params(cfg, 6)["encoder.conv_in.weight"],
                       p["encoder.conv_in.weight"])


# --------------------------------------------------------------------------
# vae_encode
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def encode_case():
    """Tiny VAE encoder weights, a batch of 2 images, and JAX's posterior
    mean and its sample under PRNGKey(9)."""
    vcfg = tvae.tiny_vae_config()
    jv = _jax_cfg(vcfg)
    enc = np_init(jvae.vae_encoder_param_shapes(jv), 6)
    images = np.random.default_rng(2).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in enc.items()}

    @jax.jit
    def encode(p, x):
        with jops.use_backends(JAX_REFERENCE):
            return (jvae.vae_encode(jv, p, x),
                    jvae.vae_encode(jv, p, x, rng=jax.random.PRNGKey(9)))

    mean, sample = (np.asarray(a) for a in encode(jp, jnp.asarray(images)))
    noise = np.array(jax.random.normal(jax.random.PRNGKey(9), mean.shape, jnp.float32))
    return vcfg, enc, images, mean, sample, noise


@pytest.mark.parametrize("binding", list(BINDINGS))
def test_vae_encode_matches_jax(encode_case, binding, monkeypatch):
    """The posterior mean, and the sample with JAX's draw injected, within
    1e-5 of JAX's; the latents are (B, H/f, W/f, 4) and the sample differs
    from the mean."""
    vcfg, enc, images, mean, sample, noise = encode_case
    params = params_from_numpy({"vae": enc})["vae"]
    monkeypatch.setattr(tvae, "posterior_noise",
                        lambda shape, gen, device: torch.from_numpy(noise))
    with torch.inference_mode(), tops.use_backends(resolve_binding(BINDINGS[binding])):
        got_mean = tvae.vae_encode(vcfg, params, torch.from_numpy(images))
        got_sample = tvae.vae_encode(vcfg, params, torch.from_numpy(images),
                                     generator=torch.Generator().manual_seed(9))
    assert got_mean.shape == (2, SIZE // 2, SIZE // 2, 4)
    np.testing.assert_allclose(got_mean.numpy(), mean, atol=ENCODE_TOL, rtol=0)
    np.testing.assert_allclose(got_sample.numpy(), sample, atol=ENCODE_TOL, rtol=0)
    assert np.abs(sample - mean).max() > 1e-2


def test_vae_encode_sample_is_seeded():
    """A sampled encode draws from its generator: the same seed, the same
    latents; another seed, others."""
    vcfg = tvae.tiny_vae_config()
    params = tvae.init_vae_encoder_params(vcfg, 6)
    x = torch.rand(1, SIZE, SIZE, 3) * 2 - 1
    a, b, c = (tvae.vae_encode(vcfg, params, x, generator=torch.Generator().manual_seed(s))
               for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)


# --------------------------------------------------------------------------
# img2img on the tiny base (dual encoders), SD1.5 (one encoder) and refiner
# --------------------------------------------------------------------------


def _family(family):
    """(configs, numpy params, JAX pipeline) of a tiny family; the base
    carries the VAE encoder's weights."""
    if family == "base":
        ucfg, c1, c2, vcfg = tpipe.tiny_configs()
    elif family == "sd15":
        ucfg, c1, vcfg = tpipe.tiny_sd15_configs()
        c2 = c1
    else:
        ucfg, c2, vcfg = tpipe.tiny_refiner_configs()
        c1 = c2
    ju, jc1, jc2, jv = (_jax_cfg(c) for c in (ucfg, c1, c2, vcfg))
    params = {"unet": np_init(junet.unet_param_shapes(ju), 10),
              "vae": np_init(jvae.vae_decoder_param_shapes(jv), 12)}
    if family != "refiner":
        params["text_encoder"] = np_init(jclip.clip_param_shapes(jc1), 11)
    if family != "sd15":
        params["text_encoder_2"] = np_init(jclip.clip_param_shapes(jc2), 13)
    if family == "base":
        params["vae"].update(np_init(jvae.vae_encoder_param_shapes(jv), 14))
    jp = jpipe.SDXLPipeline(
        unet_config=ju, clip_config=jc1, clip2_config=jc2, vae_config=jv,
        params={g: {k: jnp.asarray(v) for k, v in tree.items()} for g, tree in params.items()},
        compile_config=JCompileConfig(backend="reference", dtype="float32"))
    return (ucfg, c1, c2, vcfg), params, jp


def port_pipeline(family_case, binding="reference"):
    (ucfg, c1, c2, vcfg), params, _ = family_case
    return tpipe.SDXLPipeline(unet_config=ucfg, clip_config=c1, clip2_config=c2,
                              vae_config=vcfg, params=params_from_numpy(params),
                              compile_config=BINDINGS[binding], device="cpu")


@pytest.fixture(scope="module")
def families():
    cache = {}

    def get(family):
        if family not in cache:
            cache[family] = _family(family)
        return cache[family]

    return get


@pytest.fixture(scope="module")
def jax_results():
    """JAX's result of each case, computed once."""
    return {}


def _latents(batch=2, seed=7):
    return np.random.default_rng(seed).standard_normal(
        (batch, SIZE // 2, SIZE // 2, 4)).astype(np.float32)


# family -> (ids1 given, img2img keywords); the base's program is also
# img2img_image's, the refiner's the second stage of TwoStageSDXL's, so
# the JAX side compiles each once
I2I_CASES = {
    "base": (True, dict(steps=4, strength=0.5, seed=[3, 4])),
    "sd15": (True, dict(steps=5, strength=0.6, seed=[3, 4], guidance_scale=7.5,
                        solver="euler_a")),
    "refiner": (False, dict(steps=4, strength=0.5, seed=[3, 4])),
}


@pytest.mark.parametrize("binding", list(BINDINGS))
@pytest.mark.parametrize("family", list(I2I_CASES))
def test_img2img_matches_jax(families, jax_results, family, binding, monkeypatch):
    """img2img's images against JAX's: the tiny base on both encoders (6
    time ids), SD1.5 on one under euler_a (the ancestral noise covers the
    3 steps run, JAX's chain injected), the refiner on bigG alone with the
    5-slot time ids; the steps from ``start`` run."""
    case = families(family)
    (_, c1, c2, _), _, jp = case
    with_ids1, kw = I2I_CASES[family]
    lat = _latents()
    ids1 = _ids(c1, 2, 1) if with_ids1 else None
    ids2 = _ids(c2, 2, 2)
    key = ("i2i", family)
    if key not in jax_results:
        jax_results[key] = np.asarray(jp.img2img(
            jnp.asarray(lat), None if ids1 is None else jnp.asarray(ids1), jnp.asarray(ids2),
            **kw))
    want = jax_results[key]
    monkeypatch.setattr(tpipe, "initial_noise", jax_noise)
    drawn = []

    def anc(seeds, steps, shape, device):
        drawn.append((steps, tuple(shape)))
        return jax_ancestral(seeds, steps, shape, device)

    monkeypatch.setattr(tpipe, "ancestral_noise", anc)
    pipe = port_pipeline(case, binding)
    got = pipe.img2img(lat, ids1, ids2, **kw)
    assert got.shape == want.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    (sig,) = pipe.cache_signatures()
    start = kw["steps"] - round(kw["steps"] * kw["strength"])
    assert sig[:6] == ("i2i", 2, SIZE // 2, SIZE // 2, kw["steps"], start)
    assert drawn == ([(kw["steps"] - start, (SIZE // 2, SIZE // 2, 4))]
                     if kw.get("solver") == "euler_a" else [])


def test_refiner_takes_five_time_ids_with_the_aesthetic_scores(families, monkeypatch):
    """The refiner's UNet sees (2B, 5) time ids [h, w, 0, 0, score], the
    uncond rows' score first; the base's sees txt2img's 6."""
    seen = []
    real = tpipe.unet_apply

    def spy(cfg, p, sample, t, ctx, te, tid, **kw):
        seen.append(tid.clone())
        return real(cfg, p, sample, t, ctx, te, tid, **kw)

    monkeypatch.setattr(tpipe, "unet_apply", spy)
    refiner = port_pipeline(families("refiner"))
    refiner.img2img(_latents(), None, _ids(refiner.clip2_config, 2), steps=2, strength=0.5,
                    aesthetic_scores=(2.0, 7.5), decode=False)
    want = torch.tensor([[SIZE, SIZE, 0, 0, 2.0]] * 2 + [[SIZE, SIZE, 0, 0, 7.5]] * 2)
    assert torch.equal(seen[-1], want)
    base = port_pipeline(families("base"))
    ids = _ids(base.clip_config, 1)
    base.img2img(_latents(1), ids, ids, steps=2, strength=0.5, decode=False)
    assert torch.equal(seen[-1], torch.tensor([[SIZE, SIZE, 0, 0, SIZE, SIZE]] * 2,
                                              dtype=torch.float32))


@pytest.mark.parametrize("steps", [1, 2, 4, 30])
def test_strength_maps_to_start_as_jax(families, steps, monkeypatch):
    """The first step run, over a sweep of strengths, is JAX's (its
    program's ``start``, read from the builder of each package)."""
    case = families("refiner")
    _, _, jp = case
    pipe = port_pipeline(case)
    starts = {"jax": [], "port": []}
    monkeypatch.setattr(jp, "_build_img2img",
                        lambda **kw: starts["jax"].append(kw["start"]) or (lambda *a: None))
    monkeypatch.setattr(pipe, "_build_img2img",
                        lambda **kw: starts["port"].append(kw["start"]) or (lambda *a: None))
    lat, ids = _latents(1), _ids(pipe.clip2_config, 1)
    for strength in (0.0, 0.1, 0.25, 0.3, 0.5, 0.55, 0.75, 0.99, 1.0):
        jp.img2img(jnp.asarray(lat), None, jnp.asarray(ids), steps=steps, strength=strength)
        pipe.img2img(lat, None, ids, steps=steps, strength=strength)
    assert starts["port"] == starts["jax"] and all(0 <= s < steps for s in starts["port"])
    assert len(set(starts["port"])) == min(steps, len(set(starts["jax"])))


@pytest.mark.parametrize("binding", list(BINDINGS))
@pytest.mark.parametrize("encode_seed", [None, 5])
def test_img2img_image_matches_jax(families, jax_results, encode_seed, binding, monkeypatch):
    """Pixels in: the encode (posterior mean, or a sample with JAX's draw
    for the seed injected image by image), then img2img, against JAX's
    img2img_image on the tiny base."""
    case = families("base")
    (_, c1, c2, _), _, jp = case
    image = np.random.default_rng(6).uniform(-1, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    ids1, ids2 = _ids(c1, 2, 1), _ids(c2, 2, 2)
    kw = I2I_CASES["base"][1]
    key = ("pixels", encode_seed)
    if key not in jax_results:
        jax_results[key] = np.asarray(jp.img2img_image(
            jnp.asarray(image), jnp.asarray(ids1), jnp.asarray(ids2), encode_seed=encode_seed,
            **kw))
    want = jax_results[key]
    monkeypatch.setattr(tpipe, "initial_noise", jax_noise)
    if encode_seed is not None:
        draw = np.array(jax.random.normal(jax.random.PRNGKey(encode_seed),
                                          (2, SIZE // 2, SIZE // 2, 4), jnp.float32))
        rows = iter(range(2))
        monkeypatch.setattr(tvae, "posterior_noise", lambda shape, gen, device: torch.from_numpy(
            draw[next(rows)][None]))
    got = port_pipeline(case, binding).img2img_image(image, ids1, ids2,
                                                     encode_seed=encode_seed, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_img2img_image_refuses_without_encoder_weights():
    pipe = tpipe.make_tiny_pipeline()
    ids = _ids(pipe.clip_config, 1)
    with pytest.raises(ValueError, match="no encoder weights"):
        pipe.img2img_image(np.zeros((1, SIZE, SIZE, 3), np.float32), ids, ids)


# --------------------------------------------------------------------------
# TwoStageSDXL
# --------------------------------------------------------------------------


@pytest.mark.parametrize("binding", list(BINDINGS))
def test_two_stage_matches_jax(families, jax_results, binding, monkeypatch):
    """Base txt2img latents handed to the refiner's img2img (seed + 1):
    images within 1e-4 of JAX's TwoStageSDXL; each stage builds one
    program."""
    base_case, ref_case = families("base"), families("refiner")
    (_, c1, c2, _), _, jbase = base_case
    _, _, jref = ref_case
    ids = _ids(c1, 2, 3)
    kw = dict(height=SIZE, width=SIZE, steps=4, refiner_strength=0.5, seed=2)
    if "two" not in jax_results:
        jax_results["two"] = np.asarray(jpipe.TwoStageSDXL(base=jbase, refiner=jref).txt2img(
            jnp.asarray(ids), jnp.asarray(ids), **kw))
    want = jax_results["two"]
    monkeypatch.setattr(tpipe, "initial_noise", jax_noise)
    base, refiner = port_pipeline(base_case, binding), port_pipeline(ref_case, binding)
    got = tpipe.TwoStageSDXL(base=base, refiner=refiner).txt2img(ids, ids, **kw)
    assert got.shape == want.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    assert len(base.cache_signatures()) == len(refiner.cache_signatures()) == 1
    assert refiner.cache_signatures()[0][5] == 2  # start: 2 of 4 steps refined


# --------------------------------------------------------------------------
# warmup and the replay runtime, the card stood in for
# --------------------------------------------------------------------------


def test_warmup_builds_one_signature_the_next_call_reuses():
    """warmup builds exactly the signature a request of the same knobs
    uses (return_latents off, normalised knobs); the request builds none."""
    pipe = tpipe.make_tiny_pipeline()
    pipe.warmup(height=SIZE, width=SIZE, steps=2, solver="heun", deep_cache=2,
                guidance_interval=[0.5, 9])
    (sig,) = pipe.cache_signatures()
    built = []
    real = pipe._build
    pipe._build = lambda **kw: built.append(kw) or real(**kw)
    ids = _ids(pipe.clip_config, 1)
    img = pipe.txt2img(ids, ids, height=SIZE, width=SIZE, steps=2, solver="heun", deep_cache=2,
                       guidance_interval=(0.5, 9.0))
    assert img.shape == (1, SIZE, SIZE, 3) and built == [] and pipe.cache_signatures() == [sig]
    with pytest.raises(ValueError, match="multiples"):
        pipe.warmup(height=SIZE + 1, width=SIZE)


class _StandIn:
    """The torch.cuda calls of runtime/graphs.py stood in for on CPU
    tensors: a "capture" records the loop's body, a replay runs it again
    into the static outputs."""

    capturing = None

    class Graph:
        def __init__(self, keep_graph=False):
            self.body, self.out, self.replays = None, None, 0

        def instantiate(self):
            pass

        def replay(self):
            self.replays += 1
            new = self.body()
            for buf, value in zip(_leaves(self.out), _leaves(new)):
                buf.copy_(value)

    class Capture:
        def __init__(self, graph, **kw):
            self.graph = graph

        def __enter__(self):
            _StandIn.capturing = self.graph

        def __exit__(self, *exc):
            _StandIn.capturing = None

    class Stream:
        def __init__(self, device=None):
            pass

        def wait_stream(self, other):
            pass

        def wait_event(self, event):
            pass

    class Event:
        def record(self, stream=None):
            pass


def _leaves(tree):
    out = []
    tgraphs.flatten(tree, out)
    return out


@pytest.fixture
def stand_in(monkeypatch):
    import contextlib

    monkeypatch.setattr(tgraphs, "on_card", lambda t: True)
    monkeypatch.setattr(tpipe, "on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StandIn.Graph)
    monkeypatch.setattr(torch.cuda, "graph", _StandIn.Capture)
    monkeypatch.setattr(torch.cuda, "Stream", _StandIn.Stream)
    monkeypatch.setattr(torch.cuda, "Event", _StandIn.Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _StandIn.Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    real = tpipe.make_denoise_loop

    def make(*args, **kwargs):
        loop = real(*args, **kwargs)

        def replayable(params, latents, ctx, text_embeds, time_ids, noise=None, extra=None):
            def body():
                return loop(params, latents, ctx, text_embeds, time_ids, noise, extra)

            out = body()
            if _StandIn.capturing is not None:
                _StandIn.capturing.body, _StandIn.capturing.out = body, out
            return out

        return replayable

    monkeypatch.setattr(tpipe, "make_denoise_loop", make)
    return _StandIn


def test_warmup_captures_so_the_first_request_replays(stand_in):
    """On the card warmup runs the loop's warm-up and capture on zero
    inputs and decodes nothing; the first request of the signature then
    replays that graph (captures nothing) and gives the eager loop's
    result on its own inputs."""
    pipe = tpipe.make_tiny_pipeline()
    decoded = []
    real_decode = tpipe._decode_images
    tpipe._decode_images = lambda *a: decoded.append(1) or real_decode(*a)
    try:
        assert pipe.warmup(height=SIZE, width=SIZE, steps=2) is None
        assert decoded == []
        (prog,) = pipe._cache.values()
        (entry,) = prog.loop.captured.values()
        assert entry.graph.replays == 0
        ids = _ids(pipe.clip_config, 1, 4)
        got = pipe.txt2img(ids, ids, height=SIZE, width=SIZE, steps=2, seed=3)
    finally:
        tpipe._decode_images = real_decode
    assert len(prog.loop.captured) == 1 and entry.graph.replays == 1 and decoded == [1]
    neg = torch.as_tensor(pipe.clip_config.empty_prompt_ids(1, ids.shape[1]), dtype=torch.long)
    tids = torch.as_tensor(ids, dtype=torch.long)
    with torch.inference_mode():
        eager = prog.loop.__wrapped__(pipe.params["unet"], *prog.loop_inputs(
            pipe.params, tids, tids, neg, neg, [3]))
        want = real_decode(pipe.vae_config, pipe.params["vae"], eager)
    assert torch.equal(got, want)


@pytest.mark.parametrize("family,kw", [
    ("refiner", dict(strength=0.5)), ("base", dict(strength=0.75, solver="euler_a")),
    ("sd15", dict(strength=0.5, deep_cache=2, guidance_interval=(0.0, 5.0)))])
def test_img2img_loop_captures_once_and_replays(families, stand_in, family, kw):
    """img2img's loop on the replay runtime: the first call captures, a
    second with other latents, prompt and seed replays the one graph and
    gives the eager loop's latents on its own inputs bit for bit."""
    pipe = port_pipeline(families(family))
    ids1 = None if family == "refiner" else _ids(pipe.clip_config, 1)
    kw = dict(steps=4, decode=False, **kw)
    pipe.img2img(_latents(1, 1), ids1, _ids(pipe.clip2_config, 1), seed=1, **kw)
    ids1 = None if family == "refiner" else _ids(pipe.clip_config, 1, 3)
    ids2, lat = _ids(pipe.clip2_config, 1, 3), _latents(1, 2)
    got = pipe.img2img(lat, ids1, ids2, seed=2, **kw)
    (prog,) = pipe._cache.values()
    (entry,) = prog.loop.captured.values()
    assert entry.graph.replays == 1
    neg1 = None if ids1 is None else torch.as_tensor(
        pipe.clip_config.empty_prompt_ids(1, ids1.shape[1]), dtype=torch.long)
    neg2 = torch.as_tensor(pipe.clip2_config.empty_prompt_ids(1, ids2.shape[1]),
                           dtype=torch.long)
    with torch.inference_mode(), tops.use_backends(resolve_binding(pipe.compile_config)):
        eager = prog.loop.__wrapped__(pipe.params["unet"], *prog.loop_inputs(
            pipe.params, torch.from_numpy(lat),
            None if ids1 is None else torch.as_tensor(ids1, dtype=torch.long),
            torch.as_tensor(ids2, dtype=torch.long), neg1, neg2, [2]))
    assert torch.equal(got, eager)
