"""v-prediction (SD2.x 768-v) on the CPU: the conversion to eps, every solver
and DeepCache under it, a tiny SD2-shaped pipeline against the benchmark's
plain reference (``gpubench/reference/sd_v.py``), the epsilon path left as
it was, the serving engine's per-encoder padding, the loop's span and
counter, and the work counts of ``gpubench/configs/sd-2.1-768.json``.

Tolerances, each with its reason:

  * the conversion against diffusers' pred_x0 formula in float64: 4e-7 of
    the largest eps (a few float32 ulps: the port's scalars are float32
    host constants, two products and a sum);
  * a solver's loop under v against the same solver fed eps converted
    outside it: 2e-6 of the largest latent (values to ~10; the outside
    conversion undoes the input scaling, x = inp * sqrt(sigma^2 + 1), and
    converts each CFG half before the combine, a reordering of float32
    sums that 5 steps carry; measured 1.2e-7 to 3.0e-7);
  * the tiny pipeline against the reference, float32 on both sides: 1e-4
    of the image's RMS and 1e-4 absolute, the benchmark's own CPU bound
    (summation orders of CLIP, the convolutions and attention differ;
    measured 6.2e-6 to 6.8e-6 of the RMS, 1.7e-5 absolute); reading the
    same UNet as epsilon misses it by 0.50 of the RMS;
  * an image alone against the same image co-batched: 2e-5, the serving
    tests' bound.

The file imports neither JAX nor the JAX package.
"""

import dataclasses
import json
import math
import pathlib

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import harness, weights
from gpubench.reference import sd as ref_sd
from gpubench.reference import sd_v as ref_v
from gpubench.tokenizer import StubTokenizer
from gpubench.work import unet2d
from stabletriton_tpu_torch.models import clip as tclip
from stabletriton_tpu_torch.models import unet as tunet
from stabletriton_tpu_torch.runtime import pipeline as tpipe
from stabletriton_tpu_torch.runtime import profiling
from stabletriton_tpu_torch.runtime import scheduler as tsched
from stabletriton_tpu_torch.runtime.denoise import SOLVERS, make_denoise_loop
from stabletriton_tpu_torch.runtime.serving import Request, ServingEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = pathlib.Path(__file__).resolve().parents[1]
SD21 = json.loads((REPO / "gpubench/configs/sd-2.1-768.json").read_text())
SIZE = 32
V = tsched.SchedulerConfig(prediction_type="v_prediction")


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * max(1.0, np.abs(want).max()), rtol=0)


# --------------------------------------------------------------------------
# the conversion
# --------------------------------------------------------------------------


def _x0_eps(x, v, sigma):
    """diffusers' EulerDiscreteScheduler under v_prediction, in float64:
    pred_x0 = v * (-sigma / sqrt(sigma^2 + 1)) + x / (sigma^2 + 1), and the
    eps its Euler step moves along, (x - pred_x0) / sigma."""
    x, v, s = np.float64(x), np.float64(v), np.float64(sigma)
    x0 = v * (-s / np.sqrt(s * s + 1)) + x / (s * s + 1)
    return (x - x0) / s


@pytest.mark.parametrize("k", [0, 1, 7, 15, 28, 29])
def test_v_to_eps_against_diffusers_x0(k):
    """Every sigma of the 30-step schedule's ends and middle, f32."""
    sigma = tsched.make_schedule(V, 30).sigmas[k]
    rng = np.random.default_rng(k)
    x = (rng.standard_normal((2, 8, 8, 4)) * max(1.0, float(sigma))).astype(np.float32)
    v = (rng.standard_normal((2, 8, 8, 4)) * 1.5).astype(np.float32)
    got = tsched.v_to_eps(torch.from_numpy(x), torch.from_numpy(v), float(sigma))
    assert got.dtype == torch.float32
    _close(got.numpy(), _x0_eps(x, v, sigma), 4e-7)


def test_v_to_eps_rounds_once_to_the_sample_dtype():
    gen = torch.Generator().manual_seed(0)
    x = (torch.randn((2, 4, 4, 4), generator=gen) * 10).to(torch.bfloat16)
    v = torch.randn((2, 4, 4, 4), generator=gen).to(torch.bfloat16)
    var = np.float32(3.5) ** 2 + np.float32(1.0)
    c_x, c_v = np.float32(3.5) / var, np.float32(1.0) / np.sqrt(var)
    want = (x.float() * float(c_x) + v.float() * float(c_v)).to(torch.bfloat16)
    got = tsched.v_to_eps(x, v, 3.5)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


def test_prediction_type_is_checked():
    assert tsched.SchedulerConfig().prediction_type == "epsilon"
    with pytest.raises(ValueError, match="prediction_type"):
        tsched.SchedulerConfig(prediction_type="sample")
    with pytest.raises(ValueError, match="prediction_type"):
        make_denoise_loop(lambda *a: None, tsched.make_schedule(V, 2), prediction_type="v")


# --------------------------------------------------------------------------
# every solver, the guidance interval and DeepCache under v
# --------------------------------------------------------------------------


def _mu(ctx):
    return ctx.mean(dim=(1, 2)).reshape(-1, 1, 1, 1)


def _v_unet(params, inp, t, ctx, te, tid, tc=None):
    """A stand-in v-prediction UNet: cond and uncond differ, and each
    evaluation sees its own timestep."""
    return 0.1 * inp + _mu(ctx) + 1e-4 * t.reshape(-1, 1, 1, 1)


def _v_pair():
    def full(params, inp, t, ctx, te, tid, tc=None):
        return _v_unet(params, inp, t, ctx, te, tid), 0.5 * inp + _mu(ctx)

    def shallow(params, inp, t, ctx, te, tid, tc, cache):
        return _v_unet(params, inp, t, ctx, te, tid) + 0.01 * cache

    return full, shallow


def _as_eps(fn, schedule):
    """``fn``'s v output turned into eps outside the loop, row by row, at the
    sigma of its timestep and the unscaled sample the input scaling came
    from, by diffusers' formula: the epsilon solver is fed that."""
    sigma_of = {float(t): float(s) for t, s in zip(schedule.timesteps, schedule.sigmas)}

    def eps(v, inp, t):
        s = sigma_of[float(t[0])]
        x = inp.double() * math.sqrt(s * s + 1.0)
        x0 = v.double() * (-s / math.sqrt(s * s + 1.0)) + x / (s * s + 1.0)
        return ((x - x0) / s).float()

    def wrapped(params, inp, t, *rest):
        out = fn(params, inp, t, *rest)
        if isinstance(out, tuple):
            return eps(out[0], inp, t), out[1]
        return eps(out, inp, t)

    return wrapped


def _inputs(steps):
    rng = np.random.default_rng(3)
    lat = torch.from_numpy((rng.standard_normal((2, 4, 4, 4)) * 10).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((4, 3, 5)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((steps, 2, 4, 4, 4)).astype(np.float32))
    return lat, ctx, noise


def _modes(schedule):
    s = schedule.sigmas
    return {"cfg": (5.0, None), "no_cfg": (1.0, None),
            "interval": (5.0, (float(s[3] + s[4]) / 2, float(s[0] + s[1]) / 2))}


@pytest.mark.parametrize("deep_cache", [None, 2])
@pytest.mark.parametrize("mode", ["cfg", "no_cfg", "interval"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_solver_under_v_equals_epsilon_fed_converted_eps(solver, mode, deep_cache):
    """5 steps; the window holds steps 1-3; DeepCache at interval 2 (its
    shallow passes read the cache a full pass left)."""
    schedule = tsched.make_schedule(V, 5)
    g, gi = _modes(schedule)[mode]
    lat, ctx, noise = _inputs(5)
    kw = {"noise": noise} if solver == "euler_a" else {}
    loops = []
    for pred, wrap in (("v_prediction", lambda f: f),
                       ("epsilon", lambda f: _as_eps(f, schedule))):
        dc = None
        if deep_cache is not None:
            full, shallow = _v_pair()
            dc = (deep_cache, wrap(full), wrap(shallow), (4, 4, 4))
        loops.append(make_denoise_loop(wrap(_v_unet), schedule, guidance_scale=g,
                                       solver=solver, guidance_interval=gi, deep_cache=dc,
                                       prediction_type=pred))
    got = loops[0]({}, lat, ctx, None, None, **kw)
    want = loops[1]({}, lat, ctx, None, None, **kw)
    assert torch.isfinite(got).all()
    _close(got.numpy(), want.numpy(), 2e-6)
    if deep_cache is None:
        # read as eps, the same UNet lands elsewhere
        other = make_denoise_loop(_v_unet, schedule, guidance_scale=g, solver=solver,
                                  guidance_interval=gi)({}, lat, ctx, None, None, **kw)
        assert (other - got).abs().max() > 1e-2


def test_heun_converts_its_correction_at_its_own_sigma():
    """Heun's second evaluation converts at sigmas[i + 1] with the proposal as
    its sample: the sigmas each conversion sees are the evaluations'."""
    schedule = tsched.make_schedule(V, 3)
    seen = []
    real = tsched.v_to_eps

    def spy(sample, v, sigma):
        seen.append(sigma)
        return real(sample, v, sigma)

    lat, ctx, _ = _inputs(3)
    loop = make_denoise_loop(_v_unet, schedule, guidance_scale=5.0, solver="heun",
                             prediction_type="v_prediction")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tsched, "v_to_eps", spy)
        loop({}, lat, ctx, None, None)
    s = [float(x) for x in schedule.sigmas]
    assert seen == [s[0], s[1], s[1], s[2], s[2]]


# --------------------------------------------------------------------------
# the epsilon path, as it was
# --------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["sdxl", "sd15"])
def test_explicit_epsilon_equals_the_default_loop_bit_for_bit(family, monkeypatch):
    """A pipeline with ``prediction_type="epsilon"`` gives the default
    pipeline's images bit for bit, and its loop never reaches the
    conversion (the branch launches nothing new)."""
    make = tpipe.make_tiny_pipeline if family == "sdxl" else tpipe.make_tiny_sd15_pipeline
    default = make()
    explicit = make(params=default.params)
    explicit.scheduler_config = tsched.SchedulerConfig(prediction_type="epsilon")
    ids = default.clip_config.empty_prompt_ids(2)
    ids[:, 1:4] = [[5, 6, 7], [8, 9, 10]]
    ids[:, 4] = default.clip_config.eos_token_id
    kw = dict(height=SIZE, width=SIZE, steps=2, seed=[3, 4])
    want = default.txt2img(ids, ids, **kw)

    def refuse(*a, **k):
        raise AssertionError("an epsilon loop converted its output")

    monkeypatch.setattr(tsched, "v_to_eps", refuse)
    got = explicit.txt2img(ids, ids, **kw)
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# a tiny SD2-shaped pipeline against the benchmark's reference
# --------------------------------------------------------------------------


def _lists(d):
    return {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(d).items()}


def tiny_sd2_config(prediction_type="v_prediction") -> dict:
    """SD2.1-768's shape at a CPU size: d = 8 heads by channel count (4 and
    8 heads, as SD2 counts its heads from the head size), one OpenCLIP-style
    encoder of an odd depth read after its final LayerNorm (clip_skip 1)
    and padded with "!" (id 0), v-prediction, the reference binding in
    float32."""
    u, _, v = tpipe.tiny_sd15_configs()
    u = dataclasses.replace(u, fixed_num_heads=None, attention_head_dim=8)
    c = tclip.CLIPTextConfig(vocab_size=1000, hidden_size=u.cross_attention_dim, num_layers=3,
                             num_heads=4, intermediate_size=64, max_position_embeddings=16,
                             hidden_act="gelu", eos_token_id=999, bos_token_id=998,
                             pad_token_id=0)
    return {"name": "tiny-v", "reference": "sd_v", "work": "unet2d",
            "unet": _lists(u), "text_encoder": _lists(c), "vae": _lists(v),
            "scheduler": _lists(tsched.SchedulerConfig(prediction_type=prediction_type)),
            "clip_skip": 1, "height": SIZE, "width": SIZE, "steps": 3, "guidance_scale": 7.5,
            "solver": "euler", "binding": "reference",
            "dtypes": {"unet": "float32", "text_encoder": "float32", "vae": "float32"}}


@pytest.fixture(scope="module")
def tiny_v():
    cfg = tiny_sd2_config()
    params = weights.make(ref_v.param_shapes(cfg), cfg["dtypes"], 2**33 + 5, "cpu")
    return cfg, params


PROMPTS = ["a fox in the snow, watercolor", "x", "a lighthouse at dusk"]
SEEDS = [11, 2**31 + 7, 5]


def _served(cfg, params, prompts, seeds, **engine_kw):
    pipe, engine = harness.build_system(cfg, params, "cpu")
    engine.max_wait_s = engine_kw.get("max_wait_s", 0.5)
    try:
        futs = [engine.submit(Request(prompt=p, seed=s, height=cfg["height"],
                                      width=cfg["width"], steps=cfg["steps"],
                                      guidance_scale=cfg["guidance_scale"]))
                for p, s in zip(prompts, seeds)]
        return pipe, np.stack([f.result(timeout=300) for f in futs])
    finally:
        engine.close()


def _reference(cfg, params, prompts, seeds):
    ids = harness.reference_ids(cfg, prompts, [""] * len(prompts), "cpu")
    with torch.inference_mode(), ref_v.strict_float32():
        return ref_v.txt2img(cfg, params, *ids, seeds).numpy()


def test_tiny_v_pipeline_equals_the_reference(tiny_v):
    """Served through ServingEngine (one padded group of 4) against
    ``sd_v.txt2img`` on the same weights, ids and seeds, float32."""
    cfg, params = tiny_v
    pipe, got = _served(cfg, params, PROMPTS, SEEDS)
    assert pipe.scheduler_config.prediction_type == "v_prediction"
    want = _reference(cfg, params, PROMPTS, SEEDS)
    for g, w in zip(got, want):
        numbers = harness.compare_images(g, w)
        assert numbers["image_rel_rms"] <= 1e-4 and numbers["image_max_abs"] <= 1e-4, numbers
    # read as eps, the same weights miss the reference by far more
    _, as_eps = _served(dict(cfg, scheduler=dict(cfg["scheduler"], prediction_type="epsilon")),
                        params, PROMPTS[:1], SEEDS[:1])
    assert harness.compare_images(as_eps[0], want[0])["image_rel_rms"] > 1e-2


def test_tiny_v_pipeline_alone_equals_co_batched(tiny_v):
    cfg, params = tiny_v
    _, batched = _served(cfg, params, PROMPTS, SEEDS)
    _, alone = _served(cfg, params, PROMPTS[2:], SEEDS[2:])
    np.testing.assert_allclose(alone[0], batched[2], atol=2e-5, rtol=0)


def test_reference_v_reads_the_output_as_v(tiny_v):
    """The reference's loop is sd.py's but for the conversion: with a UNet
    that returns v = 0 everywhere, each Euler step scales the latents by
    1 + c_x (sigma_next - sigma), which sd.py's epsilon loop would leave
    alone."""
    cfg, params = tiny_v
    cfg = dict(cfg, steps=2)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ref_v, "unet", lambda u, p, x, *a: torch.zeros_like(x))
        mp.setattr(ref_v, "vae_decode", lambda v, p, lat: seen.append(lat) or lat[:, :3])
        ids = harness.reference_ids(cfg, ["a"], [""], "cpu")
        ref_v.txt2img(cfg, params, *ids, [3])
    ts, sigmas = ref_sd.euler_schedule(cfg["scheduler"], 2)
    init = float(np.sqrt(sigmas.max() ** 2 + 1))
    f = ref_sd.latent_factor(cfg["vae"])
    lat = ref_sd.initial_noise(3, (SIZE // f, SIZE // f, 4), "cpu") * init
    for i in range(2):
        s, n = float(sigmas[i]), float(sigmas[i + 1])
        lat = lat * (1.0 + s / (s * s + 1.0) * (n - s))
    _close(seen[0].numpy(), lat.numpy(), 1e-6)


# --------------------------------------------------------------------------
# serving: each encoder's pad id
# --------------------------------------------------------------------------


class _RecordingTok(StubTokenizer):
    def __init__(self):
        super().__init__(998, 999)
        self.pads = []

    def encode_batch(self, texts, *, max_len=77, **kw):
        self.pads.append(kw.get("pad", "default"))
        return super().encode_batch(texts, max_len=max_len, **kw)


class _StubPipeline:
    """What the engine reads of a pipeline; txt2img keeps its ids."""

    def __init__(self, pad1, pad2):
        self.clip_config = tclip.CLIPTextConfig(max_position_embeddings=16, pad_token_id=pad1)
        self.clip2_config = tclip.CLIPTextConfig(max_position_embeddings=16, pad_token_id=pad2)
        self.device = torch.device("cpu")
        self.calls = []

    def txt2img(self, **call):
        self.calls.append(call)
        return torch.zeros((len(call["seed"]), 2, 2, 3))


@pytest.mark.parametrize("pad1,pad2,want1,want2", [
    (None, None, "default", "default"),  # SD1.5's CLIP-L in both slots (EOS)
    (None, 0, "default", 0),      # SDXL-base
    (0, 0, 0, 0),                 # SD2.x's OpenCLIP-H in both slots
    (7, 5, 7, 5),
])
def test_engine_pads_each_encoder_with_its_pad_id(pad1, pad2, want1, want2):
    pipe = _StubPipeline(pad1, pad2)
    tok1, tok2 = _RecordingTok(), _RecordingTok()
    eng = ServingEngine(pipe, tok1, tok2, max_wait_s=0.01)
    try:
        eng.submit(Request(prompt="ab", height=16, width=16)).result(timeout=60)
    finally:
        eng.close()
    assert tok1.pads == [want1, want1] and tok2.pads == [want2, want2]
    (call,) = pipe.calls
    for key, want in (("ids1", want1), ("neg_ids1", want1), ("ids2", want2), ("neg_ids2", want2)):
        row = call[key][0]
        first_pad = int(np.argmax(row == 999)) + 1
        expect = 999 if want == "default" else want
        assert (row[first_pad:] == expect).all(), key


def test_engine_ids_equal_the_reference_ids(tiny_v):
    """The ids the engine sends SD2's one encoder are the benchmark
    reference's, pad id 0 and all."""
    cfg, _ = tiny_v
    pipe = _StubPipeline(0, 0)
    tok1, tok2 = harness.tokenizers(cfg)
    eng = ServingEngine(pipe, tok1, tok2, max_wait_s=0.01)
    try:
        eng.submit(Request(prompt=PROMPTS[0], height=16, width=16)).result(timeout=60)
    finally:
        eng.close()
    ids1, _, neg1, _ = harness.reference_ids(cfg, PROMPTS[:1], [""], "cpu")
    assert np.array_equal(pipe.calls[0]["ids1"], ids1.numpy())
    assert np.array_equal(pipe.calls[0]["neg_ids1"], neg1.numpy())


# --------------------------------------------------------------------------
# tracing
# --------------------------------------------------------------------------


def test_loop_span_names_the_prediction(tiny_v):
    """Every group's loop span says which parameterisation served it."""
    cfg, params = tiny_v
    profiling.set_recording(True)
    profiling.reset()
    _served(cfg, params, PROMPTS[:2], SEEDS[:2])
    loops = [s for s in profiling.spans() if s.name == "pipeline.loop"]
    assert loops and all(s.attrs["prediction"] == "v_prediction" for s in loops)
    assert not any(k.startswith("pipeline.loops") for k in profiling.counters())


# --------------------------------------------------------------------------
# the configuration and its work counts
# --------------------------------------------------------------------------


def test_config_is_the_ports_sd2_config_with_its_published_encoder_read():
    """The configuration's UNet is the port's ``sd21_unet_config``; its
    encoder is OpenCLIP-H's 23 layers with pad id 0; v-prediction."""
    u = tunet.UNetConfig(**{k: tuple(v) if isinstance(v, list) else v
                            for k, v in SD21["unet"].items()})
    assert u == tunet.sd21_unet_config()
    assert [u.num_heads(c) for c in u.block_out_channels] == [5, 10, 20, 20]
    c = tclip.CLIPTextConfig(**SD21["text_encoder"])
    assert c == dataclasses.replace(tclip.sd2_text_encoder_config(), num_layers=23,
                                    pad_token_id=0)
    assert tsched.SchedulerConfig(**SD21["scheduler"]).prediction_type == "v_prediction"
    assert SD21["clip_skip"] == 1 and SD21["reference"] == "sd_v"
    assert (SD21["height"], SD21["width"], SD21["steps"]) == (768, 768, 30)


def test_sd21_work_counts_equal_a_flop_counter():
    """At a 96^2 latent, CFG batch 2: the work module's count equals a FLOP
    counter run over the reference on meta tensors; 2,149 GFLOP a row,
    29.2% of it attention."""
    u = SD21["unet"]
    p = {k: torch.empty(s, device="meta") for k, s in ref_sd.unet_shapes(u).items()}
    x = torch.empty((2, 4, 96, 96), device="meta")
    t = torch.empty((2,), device="meta")
    ctx = torch.empty((2, 77, 1024), device="meta")
    with FlopCounterMode(display=False) as fc:
        ref_sd.unet(u, p, x, t, ctx, None, None)
    ours = unet2d.evaluation_flops(u, 2, 96, 96)
    assert ours == fc.get_total_flops()
    assert abs(ours / 2 / 1e9 - 2149.1) < 0.1
    calls = unet2d.unet_calls(u, 1, 96, 96)
    att = sum(c["flops"] for c in calls if c["kind"] == "attention")
    assert abs(att / (ours / 2) - 0.292) < 0.001
    assert sum(math.prod(s) for s in ref_sd.unet_shapes(u).values()) == 865_910_724


# --------------------------------------------------------------------------
# the single-file SD2 path's conditioning (a fault kept: ROADMAP §C)
# --------------------------------------------------------------------------


def test_sd2_single_file_conditioning_reads_before_final_layer_norm():
    """What ``io/pretrained.load_single_file_auto`` builds for an SD2.x file
    (the 24-layer OpenCLIP-H tower, ``clip_skip=2``) conditions, through
    ``SDXLPipeline._one_encoder``, on the state that enters layer 24, before
    ``final_layer_norm``. SD2 reads that state after it (ldm's
    "penultimate" with ``ln_final``; diffusers' 23-layer text encoder,
    which is what ``gpubench/configs/sd-2.1-768.json`` serves). On the
    tower's published widths and depth, seeded random weights (the port's
    init), the two reads differ by max abs 18.47 and MSE 20.69; the
    23-layer read is the 24-layer tower's penultimate state through its
    final LayerNorm, bit for bit."""
    c24 = dataclasses.replace(tclip.sd2_text_encoder_config(), pad_token_id=0)
    c23 = dataclasses.replace(c24, num_layers=23)
    params = tclip.init_clip_params(c24, 7)
    pipe = tpipe.make_tiny_sd15_pipeline()
    pipe.clip_config = pipe.clip2_config = c24
    pipe.clip_skip = 2
    neg = torch.as_tensor(c24.empty_prompt_ids(2), dtype=torch.long)
    ids = neg.clone()
    ids[0, 1:8] = torch.arange(300, 307)
    ids[0, 8] = c24.eos_token_id
    with torch.inference_mode():
        got, _, _ = pipe._one_encoder({"text_encoder": params}, ids, neg)
        pen, _, _ = tclip.clip_apply(c24, params, torch.cat([neg, ids]))
        _, read23, _ = tclip.clip_apply(c23, params, torch.cat([neg, ids]))
    assert torch.equal(got, pen)
    ln = tclip._layer_norm(pen, params["text_model.final_layer_norm.weight"],
                           params["text_model.final_layer_norm.bias"], c24.layer_norm_eps)
    assert torch.equal(read23, ln)
    d = (got - read23).double()
    assert d.abs().max().item() > 10 and (d * d).mean().item() > 10
