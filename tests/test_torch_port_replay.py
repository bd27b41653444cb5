"""The whole-loop replay slice against the JAX package, on the CPU.

The modules that come with the replay runtime: the time-conditioning cache
(``resnet_keys``, ``precompute_time_cond``, ``unet_apply(time_cond=)``),
the compile API (``compile_unet``, ``compile_unet_kv``,
``CompileConfig.cache_cross_kv`` / ``cache_time_cond``), ``guidance_interval``
in the loop, the pipeline and ``Request``, and the runtime's own pieces that
a CPU can reach: the graphed callable's signature keying and the launch
counters' capture tally and replay accounting. On the CPU a graphed callable
runs its function as it is; its capture and replay are held on the card
(``tests/test_torch_port_gpu.py``, at full width too). The
stand-in cases at the end (``fake_cuda``) also replay the other solvers' and
DeepCache's loops; ``tests/test_torch_port_solvers.py`` and
``tests/test_torch_port_deep_cache.py`` hold those against JAX.

The same numpy weights and inputs (from seeds) go through both packages, in
float32 under the reference binding (the "cuda" binding on CPU tensors runs
the kernels' plain versions). Tolerances: the time cache 1e-5 against JAX
and 1e-6 against the inline step (the JAX package's own
``tests/test_kv_cache.py`` bound); the compile API 1e-4 against JAX, bit for
bit against ``compile_unet`` without the time cache; images 1e-4 (std ~0.5,
summation order); the loop with a stand-in UNet 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu import ops as jops
from stabletriton_tpu.compile import CompileConfig as JCompileConfig
from stabletriton_tpu.compile import compile_unet_kv as jcompile_unet_kv
from stabletriton_tpu.compile import resolve_binding as jresolve
from stabletriton_tpu.models import unet as junet
from stabletriton_tpu.runtime import pipeline as jpipe
from stabletriton_tpu.runtime import scheduler as jsched
from stabletriton_tpu.runtime.denoise import make_denoise_loop as jmake_loop
from stabletriton_tpu.runtime.serving import Request as JRequest
from stabletriton_tpu_torch import ops as tops
from stabletriton_tpu_torch.compile import (
    CompileConfig,
    compile_unet,
    compile_unet_kv,
    fuse_attention_projections,
    resolve_binding,
)
from stabletriton_tpu_torch.io.convert import params_from_numpy
from stabletriton_tpu_torch.kernels import build
from stabletriton_tpu_torch.models import unet as tunet
from stabletriton_tpu_torch.runtime import graphs as tgraphs
from stabletriton_tpu_torch.runtime import pipeline as tpipe
from stabletriton_tpu_torch.runtime import scheduler as tsched
from stabletriton_tpu_torch.runtime.denoise import guided_steps
from stabletriton_tpu_torch.runtime.denoise import make_denoise_loop as tmake_loop
from stabletriton_tpu_torch.runtime.serving import Request, ServingEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZE = 32
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


def _configs(family: str):
    """(port config, JAX config) of a tiny UNet: SDXL's (added
    conditioning) or SD1.5's (none)."""
    tcfg = tpipe.tiny_configs()[0] if family == "sdxl" else tpipe.tiny_sd15_configs()[0]
    return tcfg, junet.UNetConfig(**dataclasses.asdict(tcfg))


def _step_inputs(tcfg, seed=0, batch=2):
    """numpy (sample, t, ehs, text_embeds, time_ids) of one CFG-doubled step."""
    rng = np.random.default_rng(seed)
    sample = rng.standard_normal((batch, 8, 8, tcfg.in_channels)).astype(np.float32)
    t = np.asarray([500.0] * batch, np.float32)
    ehs = rng.standard_normal((batch, 7, tcfg.cross_attention_dim)).astype(np.float32)
    if tcfg.has_addition_embedding:
        pooled = tcfg.projection_class_embeddings_input_dim - 6 * tcfg.addition_time_embed_dim
        te = rng.standard_normal((batch, pooled)).astype(np.float32)
        tid = np.tile(np.asarray([[32.0, 32, 0, 0, 32, 32]], np.float32), (batch, 1))
    else:
        te, tid = np.zeros((batch, 0), np.float32), np.zeros((batch, 0), np.float32)
    return sample, t, ehs, te, tid


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    return [jnp.asarray(a) for a in arrays]


# --------------------------------------------------------------------------
# the time-conditioning cache
# --------------------------------------------------------------------------


@pytest.mark.parametrize("family", ["sdxl", "sd15"])
def test_resnet_keys_match_jax(family):
    tcfg, jcfg = _configs(family)
    keys = tunet.resnet_keys(tcfg)
    assert keys == junet.resnet_keys(jcfg)
    shapes = tunet.unet_param_shapes(tcfg)
    assert sorted(k for k in shapes if k.endswith("time_emb_proj.weight")) == sorted(
        f"{k}.time_emb_proj.weight" for k in keys)


@pytest.mark.parametrize("family", ["sdxl", "sd15"])
def test_precompute_time_cond_matches_jax(family):
    """(T, B, C) per resnet over a 3-step schedule, within 1e-5."""
    tcfg, jcfg = _configs(family)
    params = np_init(junet.unet_param_shapes(jcfg), 5)
    _, _, _, te, tid = _step_inputs(tcfg, 1)
    ts = np.asarray([981.0, 500.0, 1.0], np.float32)
    with jops.use_backends(JAX_REFERENCE):
        want = junet.precompute_time_cond(jcfg, _jax_params(params), *_jax(ts, te, tid))
    got = tunet.precompute_time_cond(tcfg, _torch_params(params), *_torch(ts, te, tid))
    assert list(got) == list(want) == tunet.resnet_keys(tcfg)
    for key, value in got.items():
        assert value.shape == (3, 2, want[key].shape[-1])
        np.testing.assert_allclose(value.numpy(), np.asarray(want[key]), atol=1e-5, rtol=0)


def _jax_params(params):
    return {k: jnp.asarray(v) for k, v in params.items()}


def _torch_params(params):
    return {k: torch.from_numpy(v) for k, v in params.items()}


@pytest.mark.parametrize("family", ["sdxl", "sd15"])
def test_time_cond_step_equals_inline(family):
    """Each step's slice of the cache reproduces the inline time embedding
    (the JAX package's ``test_time_cond_cache_matches_inline``), within 1e-6."""
    tcfg, jcfg = _configs(family)
    params = _torch_params(np_init(junet.unet_param_shapes(jcfg), 6))
    sample, _, ehs, te, tid = _torch(*_step_inputs(tcfg, 2))
    ts = torch.tensor([500.0, 250.0, 10.0])
    tc_all = tunet.precompute_time_cond(tcfg, params, ts, te, tid)
    for i, tv in enumerate(ts):
        t = tv.expand(sample.shape[0])
        base = tunet.unet_apply(tcfg, params, sample, t, ehs, te, tid)
        cached = tunet.unet_apply(tcfg, params, sample, t, ehs, te, tid,
                                  time_cond={k: v[i] for k, v in tc_all.items()})
        np.testing.assert_allclose(cached.numpy(), base.numpy(), atol=1e-6, rtol=1e-6)


# --------------------------------------------------------------------------
# the compile API
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["reference", "cuda"])
@pytest.mark.parametrize("family", ["sdxl", "sd15"])
def test_compile_unet_kv_matches_compile_unet(family, backend):
    """The (precompute, precompute_time, step) triple reproduces
    compile_unet bit for bit without the time cache and within 1e-6 with it
    (the JAX package's ``test_compile_unet_kv_matches_compile_unet``)."""
    tcfg, jcfg = _configs(family)
    ccfg = CompileConfig(backend=backend, dtype="float32")
    params = _torch_params(np_init(junet.unet_param_shapes(jcfg), 7))
    if backend != "reference":
        params = fuse_attention_projections(params)
    sample, t, ehs, te, tid = _torch(*_step_inputs(tcfg, 3))
    pre, pre_t, step = compile_unet_kv(tcfg, ccfg)
    base = compile_unet(tcfg, ccfg)(params, sample, t, ehs, te, tid)
    kv = pre(params, ehs)
    assert isinstance(next(iter(kv.values())), tuple) == (backend == "reference")
    assert torch.equal(step(params, sample, t, kv, te, tid), base)
    tc = {k: v[0] for k, v in pre_t(params, t[:1], te, tid).items()}
    np.testing.assert_allclose(step(params, sample, t, kv, te, tid, tc).numpy(), base.numpy(),
                               atol=1e-6, rtol=1e-6)
    for fn in (pre, pre_t, step):
        assert isinstance(fn, tgraphs.GraphedCallable) and fn.captured == {}


@pytest.mark.parametrize("family", ["sdxl", "sd15"])
def test_compile_unet_kv_matches_jax(family):
    """The port's triple against JAX's compile_unet_kv (reference binding,
    fused projections on both sides), with and without the time cache,
    within 1e-4."""
    tcfg, jcfg = _configs(family)
    params = np_init(junet.unet_param_shapes(jcfg), 8)
    inputs = _step_inputs(tcfg, 4)
    sample, t, ehs, te, tid = _torch(*inputs)
    tparams = fuse_attention_projections(_torch_params(params))
    pre, pre_t, step = compile_unet_kv(tcfg, CompileConfig(backend="reference", dtype="float32"))
    jpre, jpre_t, jstep = jcompile_unet_kv(jcfg, JCompileConfig(backend="reference",
                                                                dtype="float32"))
    from stabletriton_tpu.compile import fuse_attention_projections as jfuse
    jparams = jfuse(_jax_params(params))
    js, jt, jehs, jte, jtid = _jax(*inputs)
    jkv, kv = jpre(jparams, jehs), pre(tparams, ehs)
    for key in kv:
        np.testing.assert_allclose(kv[key].numpy(), np.asarray(jkv[key]), atol=1e-4, rtol=0)
    jtc = jax.tree.map(lambda a: a[0], jpre_t(jparams, jt[:1], jte, jtid))
    tc = {k: v[0] for k, v in pre_t(tparams, t[:1], te, tid).items()}
    for got, want in [(step(tparams, sample, t, kv, te, tid), jstep(jparams, js, jt, jkv, jte, jtid)),
                      (step(tparams, sample, t, kv, te, tid, tc),
                       jstep(jparams, js, jt, jkv, jte, jtid, jtc))]:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


@pytest.mark.parametrize("family", ["sdxl", "sd15"])
def test_compile_unet_kv_step_takes_time_cond_by_name(family):
    """``step(..., time_cond=tc)``, as ``tests/test_kv_cache.py`` calls
    JAX's step, is the positional call bit for bit, and within 1e-4 of
    JAX's step called the same way."""
    tcfg, jcfg = _configs(family)
    params = np_init(junet.unet_param_shapes(jcfg), 9)
    inputs = _step_inputs(tcfg, 5)
    sample, t, ehs, te, tid = _torch(*inputs)
    tparams = fuse_attention_projections(_torch_params(params))
    pre, pre_t, step = compile_unet_kv(tcfg, CompileConfig(backend="reference", dtype="float32"))
    kv = pre(tparams, ehs)
    tc = {k: v[0] for k, v in pre_t(tparams, t[:1], te, tid).items()}
    got = step(tparams, sample, t, kv, te, tid, time_cond=tc)
    assert torch.equal(got, step(tparams, sample, t, kv, te, tid, tc))
    assert torch.equal(step(tparams, sample, t, kv, te, tid, time_cond=None),
                       step(tparams, sample, t, kv, te, tid))
    from stabletriton_tpu.compile import fuse_attention_projections as jfuse
    jpre, jpre_t, jstep = jcompile_unet_kv(jcfg, JCompileConfig(backend="reference",
                                                                dtype="float32"))
    jparams = jfuse(_jax_params(params))
    js, jt, jehs, jte, jtid = _jax(*inputs)
    jtc = jax.tree.map(lambda a: a[0], jpre_t(jparams, jt[:1], jte, jtid))
    want = jstep(jparams, js, jt, jpre(jparams, jehs), jte, jtid, time_cond=jtc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


# --------------------------------------------------------------------------
# txt2img with the caches and the guidance interval, against JAX's pipeline
# --------------------------------------------------------------------------


def _jax_noise(seeds, shape, device):
    """The JAX pipeline's initial noise (one PRNG key per image's seed)."""
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
        jax.random.PRNGKey(s), shape, jnp.float32)) for s in seeds]))


def _ids(cfg, batch, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.full((batch, cfg.max_position_embeddings), cfg.eos_token_id, np.int32)
    for i in range(batch):
        n = 3 + 2 * i
        ids[i, 0] = cfg.bos_token_id
        ids[i, 1:1 + n] = rng.integers(0, 90, n)
    return ids


def _pipelines(monkeypatch, sd15=False, **cache):
    """JAX's tiny pipeline and the port's over the same weights (JAX's
    random init carried across) and the same initial noise."""
    jconfig = JCompileConfig(backend="reference", dtype="float32", **cache)
    jp = (jpipe.make_tiny_sd15_pipeline if sd15 else jpipe.make_tiny_pipeline)(jconfig)
    params = params_from_numpy({g: {k: np.asarray(v) for k, v in tree.items()}
                                for g, tree in jp.params.items()})
    monkeypatch.setattr(tpipe, "initial_noise", _jax_noise)
    make = tpipe.make_tiny_sd15_pipeline if sd15 else tpipe.make_tiny_pipeline
    tp = make(CompileConfig(backend="reference", dtype="float32", **cache), params=params)
    return jp, tp


@pytest.mark.parametrize("sd15", [False, True])
@pytest.mark.parametrize("cache", [
    {"cache_time_cond": True},
    {"cache_cross_kv": False},
    {"cache_cross_kv": False, "cache_time_cond": True},
])
def test_txt2img_caches_match_jax(monkeypatch, cache, sd15):
    """txt2img with the time cache on, the cross K/V cache off, or both,
    against JAX's tiny pipeline with the same settings: 3 Euler steps,
    guidance 5, images within 1e-4."""
    jp, tp = _pipelines(monkeypatch, sd15, **cache)
    ids = _ids(tp.clip_config, 2)
    kw = dict(height=SIZE, width=SIZE, steps=3, seed=[3, 4])
    want = np.asarray(jp.txt2img(jnp.asarray(ids), jnp.asarray(ids), **kw))
    got = tp.txt2img(ids, ids, **kw)
    assert got.shape == want.shape == (2, SIZE, SIZE, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("guidance", [0.5, 1.0])
def test_txt2img_time_cache_without_cfg_matches_jax(monkeypatch, guidance):
    """guidance_scale <= 1 with the time cache: the cache is made on the
    CFG-doubled conditioning and halved before the loop, as JAX's
    hoist_cond does; images within 1e-4."""
    jp, tp = _pipelines(monkeypatch, cache_time_cond=True)
    ids = _ids(tp.clip_config, 1)
    kw = dict(height=SIZE, width=SIZE, steps=2, seed=5, guidance_scale=guidance)
    want = np.asarray(jp.txt2img(jnp.asarray(ids), jnp.asarray(ids), **kw))
    np.testing.assert_allclose(tp.txt2img(ids, ids, **kw).numpy(), want, atol=1e-4, rtol=0)


def _sigmas(steps):
    return jsched.make_schedule(jsched.SchedulerConfig(), steps).sigmas


@pytest.mark.parametrize("window", ["middle", "f32_sigma", "all", "none"])
def test_txt2img_guidance_interval_matches_jax(monkeypatch, window):
    """The guidance interval through txt2img, against JAX's: a window
    holding the middle two of four steps (cut between steps), one equal to
    a float32 sigma, one covering every step and one none; images within
    1e-4."""
    s = [float(v) for v in _sigmas(4)]
    gi = {"middle": ((s[2] + s[3]) / 2, (s[0] + s[1]) / 2), "f32_sigma": (s[2], s[1]),
          "all": (0.0, 1e9), "none": (-2.0, -1.0)}[window]
    jp, tp = _pipelines(monkeypatch)
    ids = _ids(tp.clip_config, 2)
    kw = dict(height=SIZE, width=SIZE, steps=4, seed=[1, 2], guidance_interval=gi)
    want = np.asarray(jp.txt2img(jnp.asarray(ids), jnp.asarray(ids), **kw))
    np.testing.assert_allclose(tp.txt2img(ids, ids, **kw).numpy(), want, atol=1e-4, rtol=0)
    assert [sig[-2:] for sig in tp.cache_signatures()] == [(gi, None)]


def test_guidance_interval_is_inert_without_cfg():
    """With guidance_scale <= 1 the interval changes nothing: the program's
    signature holds None, as a request with no interval's does."""
    tp = tpipe.make_tiny_pipeline()
    ids = _ids(tp.clip_config, 1)
    kw = dict(height=SIZE, width=SIZE, steps=2, seed=3, guidance_scale=1.0)
    a = tp.txt2img(ids, ids, guidance_interval=(1.0, 5.0), **kw)
    b = tp.txt2img(ids, ids, **kw)
    assert torch.equal(a, b)
    assert len(tp.cache_signatures()) == 1 and tp.cache_signatures()[0][-2] is None


def _fake_unet_torch(params, sample, t, ctx, text_embeds, time_ids):
    """eps = 0.1 * sample + the row's ctx mean (so cond and uncond differ)."""
    return 0.1 * sample + ctx.mean(dim=(1, 2)).reshape(-1, 1, 1, 1)


def _fake_unet_jax(params, sample, t, ctx, text_embeds, time_ids):
    return 0.1 * sample + ctx.mean(axis=(1, 2)).reshape(-1, 1, 1, 1)


def _edge_windows():
    """(name, guidance, window) at the edges of a 6-step schedule's sigmas."""
    s = _sigmas(6)
    above = float(np.nextafter(np.float64(s[3]), np.inf))  # rounds to s[3] in f32
    below = float(np.nextafter(np.float64(s[2]), -np.inf))
    assert np.float32(above) == s[3] and above > float(s[3])
    return [
        ("cuts_between_steps", 5.0, (float(s[4] + s[3]) / 2, float(s[1] + s[0]) / 2)),
        ("equal_to_f32_sigmas", 5.0, (float(s[3]), float(s[1]))),
        ("f64_above_an_f32_sigma", 5.0, (above, float(s[0]))),
        ("f64_below_an_f32_sigma", 5.0, (0.0, below)),
        ("inert_at_g1", 1.0, (float(s[3]), float(s[1]))),
        ("inert_below_g1", 0.5, (0.0, 1e9)),
    ]


@pytest.mark.parametrize("name,guidance,window", _edge_windows(),
                         ids=[w[0] for w in _edge_windows()])
def test_guidance_interval_edges_match_jax(name, guidance, window):
    """The steps the port guides are those JAX's f32 lax.cond picks: the
    loop with a stand-in UNet (the JAX package's guidance-interval test's)
    against JAX's loop at the window's edges, within 1e-5, and the UNet's
    batch per step (2B where guided, B elsewhere) as the f32 comparison
    says."""
    schedule = jsched.make_schedule(jsched.SchedulerConfig(), 6)
    tschedule = tsched.make_schedule(tsched.SchedulerConfig(), 6)
    rng = np.random.default_rng(9)
    lat = rng.standard_normal((1, 4, 4, 4)).astype(np.float32)
    ctx = rng.standard_normal((2, 3, 5)).astype(np.float32)
    jloop = jmake_loop(_fake_unet_jax, schedule, guidance_scale=guidance,
                       guidance_interval=window)
    want = np.asarray(jloop({}, jnp.asarray(lat), jnp.asarray(ctx), None, None))
    rows = []

    def unet(params, sample, t, cond, te, tid):
        rows.append(sample.shape[0])
        return _fake_unet_torch(params, sample, t, cond, te, tid)

    tloop = tmake_loop(unet, tschedule, guidance_scale=guidance, guidance_interval=window)
    got = tloop({}, torch.from_numpy(lat), torch.from_numpy(ctx), None, None)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    lo, hi = np.float32(window[0]), np.float32(window[1])
    guided = [guidance > 1 and bool(lo <= s <= hi) for s in schedule.sigmas[:-1]]
    assert guided_steps(tschedule.sigmas[:-1], guidance, window) == guided
    assert rows == [2 if g else 1 for g in guided]
    if name.startswith("f64"):  # a float64 comparison would pick another step
        f64 = [bool(window[0] <= float(s) <= window[1]) for s in schedule.sigmas[:-1]]
        assert f64 != guided


# --------------------------------------------------------------------------
# serving: the interval in the batching signature
# --------------------------------------------------------------------------


def test_request_signature_normalises_guidance_interval():
    """As JAX's Request.signature: a list and int bounds co-batch with the
    float pair; an inert interval (guidance <= 1) co-batches with none."""
    kw = dict(prompt="p", height=SIZE, width=SIZE, steps=2)
    pairs = [([1, 2], (1.0, 2.0)), ((1, 2.0), (1.0, 2.0))]
    for a, b in pairs:
        assert Request(guidance_interval=a, **kw).signature == Request(
            guidance_interval=b, **kw).signature
        assert hash(Request(guidance_interval=a, **kw).signature)
    inert = Request(guidance_scale=1.0, guidance_interval=(0.5, 3.0), **kw)
    assert inert.signature == Request(guidance_scale=1, **kw).signature
    assert Request(guidance_interval=(1, 2), **kw).signature != Request(**kw).signature
    for r in (inert, Request(guidance_interval=[1, 2], **kw)):
        j = JRequest(guidance_scale=r.guidance_scale, guidance_interval=r.guidance_interval, **kw)
        assert r.signature == j.signature  # deep_cache (None) last, as JAX's


class _Tok:
    def encode_batch(self, texts, *, max_len=16, pad=99, **kw):
        out = np.full((len(texts), max_len), pad, np.int32)
        for i, t in enumerate(texts):
            ids = [98] + [(ord(c) % 90) + 5 for c in t[: max_len - 2]] + [99]
            out[i, : len(ids)] = ids
        return out


def test_engine_co_batches_equal_intervals():
    """Requests whose intervals differ only in form share one group (one
    txt2img call, one program); the interval reaches txt2img normalised."""
    pipe = tpipe.make_tiny_pipeline()
    calls = []
    real = pipe.txt2img

    def spy(ids1, ids2, **kw):
        calls.append((ids1.shape[0], kw["guidance_interval"]))
        return real(ids1, ids2, **kw)

    pipe.txt2img = spy
    eng = ServingEngine(pipe, _Tok(), _Tok(), max_wait_s=0.5)
    try:
        kw = dict(height=SIZE, width=SIZE, steps=2)
        futs = [eng.submit(Request(prompt="a", guidance_interval=[1, 20], **kw)),
                eng.submit(Request(prompt="b", guidance_interval=(1.0, 20.0), **kw))]
        assert all(f.result(timeout=300).shape == (SIZE, SIZE, 3) for f in futs)
    finally:
        eng.close()
    assert len(calls) == 1 and calls[0][0] == 2
    assert [s[-2:] for s in pipe.cache_signatures()] == [((1.0, 20.0), None)]


# --------------------------------------------------------------------------
# the runtime: signatures, the CPU path, the launch accounting
# --------------------------------------------------------------------------


def test_signature_keys_shapes_dtypes_scalars_and_structure():
    p = {"w": torch.zeros(4)}
    a = torch.zeros(2, 3)
    key = tgraphs.signature((p, a, 1.5, {"x": a}))[0]
    assert key == tgraphs.signature((p, torch.ones(2, 3), 1.5, {"x": a.clone()}))[0]
    others = [(p, torch.zeros(2, 4), 1.5, {"x": a}),
              (p, a.double(), 1.5, {"x": a}),
              (p, a, 2.5, {"x": a}),
              (p, a, 1, {"x": a}),        # an int is not the float 1.0's signature
              (p, a, 1.5, {"y": a}),
              (p, a, 1.5, [a]),
              (p, a, 1.5, {"x": (a,)}),
              (p, a, None, {"x": a})]
    keys = {tgraphs.signature(args)[0] for args in others}
    assert key not in keys and len(keys) == len(others)
    assert tgraphs.signature((p, a, 1.0))[0] != tgraphs.signature((p, a, 1))[0]
    with pytest.raises(TypeError, match="trees of tensors"):
        tgraphs.signature((p, object()))


def test_signature_binds_parameters_by_address():
    """The tensors of argument 0, the parameters, are keyed by address
    (read in place); the others by shape, dtype and device (copied)."""
    p = {"w": torch.zeros(4), "b": torch.zeros(2)}
    x = torch.zeros(3)
    key, copied, held = tgraphs.signature((p, x))
    assert copied == [x] and held == [p["w"], p["b"]]
    assert tgraphs.signature(({**p}, torch.ones(3)))[0] == key  # same tensors
    moved = {"w": p["w"].clone(), "b": p["b"]}
    assert tgraphs.signature((moved, x))[0] != key
    # past argument 0, a copy of a tensor shares the key
    assert tgraphs.signature((p, {"w": p["w"].clone()}))[0] == tgraphs.signature(
        (p, {"w": p["w"]}))[0]


def test_flatten_round_trip():
    t = [torch.zeros(1), torch.ones(2), torch.full((3,), 2.0)]
    tree = {"a": t[0], "b": (t[1], None, 3, "s"), "c": [{"d": t[2]}], "e": 0.5}
    leaves = []
    spec = tgraphs.flatten(tree, leaves)
    assert leaves == t
    back = tgraphs.unflatten(spec, iter(leaves))
    assert back.keys() == tree.keys() and back["b"][1:] == (None, 3, "s")
    assert back["c"][0]["d"] is t[2] and back["e"] == 0.5
    assert isinstance(back["c"], list) and isinstance(back["b"], tuple)


def test_graphed_callable_runs_as_it_is_on_the_cpu():
    """On CPU tensors there is no graph: the function runs at every call
    and nothing is captured."""
    calls = []

    def fn(params, x, scale):
        calls.append(x.shape)
        return {"y": x * params["w"] * scale}

    g = tgraphs.Graphs().wrap(fn)
    assert g.__wrapped__ is fn and g.__name__ == "fn"
    p = {"w": torch.full((3,), 2.0)}
    for _ in range(2):
        out = g(p, torch.ones(3), 0.5)
        assert torch.equal(out["y"], torch.ones(3))
    assert calls == [(3,), (3,)] and g.captured == {}


def test_graphed_callable_binds_keywords_to_positions():
    """A call by name is the positional call with the defaults filled in:
    the same arguments reach the function, and the same signature."""
    seen = []

    def fn(params, x, scale, tc=None):
        seen.append((scale, tc))
        return x * scale if tc is None else x * scale + tc

    g = tgraphs.Graphs().wrap(fn)
    p, x, tc = {"w": torch.zeros(1)}, torch.ones(3), torch.full((3,), 2.0)
    assert torch.equal(g(p, x, 0.5, tc=tc), g(p, x, 0.5, tc))
    assert torch.equal(g(p, x=x, scale=0.5), g(p, x, 0.5))
    assert seen == [(0.5, tc), (0.5, tc), (0.5, None), (0.5, None)]
    with pytest.raises(TypeError):
        g(p, x, 0.5, time_cond=tc)


def test_launch_counter_tally_and_replay():
    """Launches made while recording (a capture) go to the tally, not the
    counters; each replay adds the tally; other threads count as usual."""
    import threading

    a, b = build.LaunchCounter(), build.LaunchCounter()
    a.add("k1")
    with build.recording() as tally:
        a.add("k1")
        a.add("k2", 2)
        b.add("k3")
        other = threading.Thread(target=b.add, args=("live",))
        other.start()
        other.join(timeout=10)
    assert not other.is_alive()
    assert tally == {(a, "k1"): 1, (a, "k2"): 2, (b, "k3"): 1}
    assert (a.count, a.by_key) == (1, {"k1": 1})
    assert (b.count, b.by_key) == (1, {"live": 1})
    for _ in range(3):
        build.count_replay(tally)
    assert (a.count, a.by_key) == (10, {"k1": 4, "k2": 6})
    assert (b.count, b.by_key) == (4, {"live": 1, "k3": 3})
    b.add("after")  # recording has ended
    assert b.by_key["after"] == 1


def test_recording_nests_and_restores():
    c = build.LaunchCounter()
    with build.recording() as outer:
        with build.recording() as inner:
            c.add("in")
        c.add("out")
    c.add("live")
    assert inner == {(c, "in"): 1} and outer == {(c, "out"): 1}
    assert c.by_key == {"live": 1}


def test_pipeline_program_carries_its_loop():
    """The program's loop is a graphed callable whose ``__wrapped__`` is
    the eager loop; on the CPU both give the txt2img latents bit for bit
    from the program's own loop inputs."""
    pipe = tpipe.make_tiny_pipeline()
    ids = _ids(pipe.clip_config, 2)
    got = pipe.txt2img(ids, ids, height=SIZE, width=SIZE, steps=2, seed=[7, 8],
                       return_latents=True, guidance_interval=(0.0, 5.0))
    prog = pipe._program(2, SIZE, SIZE, 2, 5.0, "euler", True, (0.0, 5.0))
    assert isinstance(prog.loop, tgraphs.GraphedCallable)
    tids = [torch.as_tensor(a, dtype=torch.long) for a in (ids, ids)]
    neg = [torch.as_tensor(pipe.clip_config.empty_prompt_ids(2, ids.shape[1]),
                           dtype=torch.long)] * 2
    with torch.inference_mode(), tops.use_backends(resolve_binding(pipe.compile_config)):
        inputs = prog.loop_inputs(pipe.params, *tids, *neg, [7, 8])
        eager = prog.loop.__wrapped__(pipe.params["unet"], *inputs)
    assert torch.equal(got, eager)


class _FakeCuda:
    """Stand-ins for the torch.cuda calls of runtime/graphs.py, so that its
    capture and replay bookkeeping runs on CPU tensors: a "capture" records
    what the captured function registers (:meth:`record`), and a replay
    runs that again into the static outputs."""

    capturing = None

    class Graph:
        def __init__(self, keep_graph=False):
            assert keep_graph
            self.body, self.out, self.replays, self.instantiated = None, None, 0, False

        def instantiate(self):
            self.instantiated = True

        def replay(self):
            assert self.instantiated
            self.replays += 1
            with build.recording():  # a replay launches from no Python wrapper
                new = self.body()
            for buf, value in zip(tgraphs_leaves(self.out), tgraphs_leaves(new)):
                buf.copy_(value)

    class Capture:
        def __init__(self, graph, pool=None, stream=None, capture_error_mode="global"):
            assert pool is not None and capture_error_mode == "thread_local"
            self.graph = graph

        def __enter__(self):
            _FakeCuda.capturing = self.graph

        def __exit__(self, *exc):
            _FakeCuda.capturing = None

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

    @staticmethod
    def record(body, out):
        """Called by the graphed function with its body and its output."""
        if _FakeCuda.capturing is not None:
            _FakeCuda.capturing.body, _FakeCuda.capturing.out = body, out


def tgraphs_leaves(tree):
    leaves = []
    tgraphs.flatten(tree, leaves)
    return leaves


@pytest.fixture
def fake_cuda(monkeypatch):
    import contextlib

    monkeypatch.setattr(tgraphs, "on_card", lambda t: True)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeCuda.Graph)
    monkeypatch.setattr(torch.cuda, "graph", _FakeCuda.Capture)
    monkeypatch.setattr(torch.cuda, "Stream", _FakeCuda.Stream)
    monkeypatch.setattr(torch.cuda, "Event", _FakeCuda.Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeCuda.Stream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: ("pool",))
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, s: None)
    return _FakeCuda


def test_capture_and_replay_bookkeeping(fake_cuda):
    """The runtime's bookkeeping with the card's calls stood in for: the
    first call of a signature returns the eager warm-up's result and
    captures on static copies of its inputs (not the caller's tensors);
    later calls copy new inputs into those buffers, replay and return
    clones; parameters are read in place; scalars and shapes key new
    graphs; launches made during the capture count only at replays."""
    counter = build.LaunchCounter()
    runs = []

    def fn(params, x, scale):
        def body():
            counter.add("k")
            return {"y": x * params["w"] * scale, "n": (x.sum(),)}

        runs.append(x)
        out = body()
        fake_cuda.record(body, out)
        return out

    g = tgraphs.Graphs().wrap(fn)
    params = {"w": torch.full((3,), 2.0)}
    x0 = torch.tensor([1.0, 2.0, 3.0])
    first = g(params, x0, 0.5)
    assert torch.equal(first["y"], x0) and counter.by_key == {"k": 1}  # the warm-up counts
    assert len(runs) == 2 and runs[0] is not x0 and runs[1] is runs[0]  # static copies
    (key, entry), = g.captured.items()
    assert entry.tally == {(counter, "k"): 1} and entry.held == [params["w"]]
    assert entry.inputs[0] is runs[0] and entry.graph.replays == 0
    x1 = torch.tensor([4.0, 5.0, 6.0])
    again = g(params, x1, 0.5)
    assert torch.equal(again["y"], x1) and torch.equal(again["n"][0], torch.tensor(15.0))
    assert again["y"].data_ptr() != entry.outputs[0].data_ptr()  # a clone
    assert torch.equal(entry.inputs[0], x1) and len(runs) == 2
    assert entry.graph.replays == 1 and counter.by_key == {"k": 2}
    params["w"].fill_(3.0)  # read in place: the next replay sees it
    assert torch.equal(g(params, x1, 0.5)["y"], x1 * 1.5)
    assert torch.equal(again["y"], x1)  # an earlier result is not overwritten
    g(params, x1, 2.0)  # another scalar: another graph
    g(params, torch.ones(2, 3), 0.5)  # another shape: another graph
    assert len(g.captured) == 3 and len(runs) == 6 and counter.by_key == {"k": 5}


def test_a_capture_is_recorded_as_spans(fake_cuda):
    """A capture is a ``graphs.capture`` span around its warm-up, entry,
    captured call, end and instantiation, whose durations are the
    Captured record's times; the counters count one capture and the
    replays."""
    from stabletriton_tpu_torch.runtime import profiling

    profiling.reset()

    def fn(params, x):
        out = x * params["w"]
        fake_cuda.record(lambda: x * params["w"], out)
        return out

    g = tgraphs.Graphs().wrap(fn)
    params = {"w": torch.full((2,), 3.0)}
    for v in (1.0, 2.0, 4.0):
        assert torch.equal(g(params, torch.full((2,), v)), torch.full((2,), 3 * v))
    spans = profiling.spans()
    (cap,) = [s for s in spans if s.name == "graphs.capture"]
    parts = [s for s in spans if s.parent == cap.id]
    assert cap.attrs == {"function": "fn"}
    assert [s.name for s in parts] == ["graphs.warmup", "graphs.enter", "graphs.captured_call",
                                       "graphs.end", "graphs.instantiate"]
    assert all(cap.start_ns <= s.start_ns <= s.end_ns <= cap.end_ns for s in parts)
    assert all(a.end_ns <= b.start_ns for a, b in zip(parts, parts[1:]))
    (entry,) = g.captured.values()
    assert [entry.warmup_s, entry.enter_s, entry.capture_s, entry.end_s,
            entry.instantiate_s] == [s.seconds for s in parts]
    assert profiling.counters() == {"graphs.captures": 1, "graphs.replays": 2}


def test_call_by_name_replays_the_positional_graph(fake_cuda):
    """A call that names an argument, or leaves a default out, has the
    signature of the positional call with every argument: it replays that
    call's graph and captures nothing new."""
    def fn(params, x, scale, tc=None):
        out = x * scale if tc is None else x * scale + tc
        fake_cuda.record(lambda: x * scale if tc is None else x * scale + tc, out)
        return out

    g = tgraphs.Graphs().wrap(fn)
    p, tc = {}, torch.full((3,), 2.0)
    g(p, torch.ones(3), 0.5, tc)
    g(p, torch.ones(3), 0.5)
    (_, with_tc), (_, without) = g.captured.items()
    x = torch.tensor([1.0, 2.0, 3.0])
    assert torch.equal(g(p, x, 0.5, tc=tc), x * 0.5 + tc)
    assert torch.equal(g(p, x=x, scale=0.5, tc=None), x * 0.5)
    assert torch.equal(g(p, x, 0.5), x * 0.5)
    assert len(g.captured) == 2 and (with_tc.graph.replays, without.graph.replays) == (1, 2)


def test_failed_capture_raises_and_keeps_nothing(fake_cuda):
    """A capture that fails raises (the warm-up's result is not handed out
    in its place) and keeps no graph; the next call captures again."""
    fail = [True]

    def fn(params, x):
        if fake_cuda.capturing is not None and fail[0]:
            raise RuntimeError("operation not permitted when stream is capturing")
        out = x + 1
        fake_cuda.record(lambda: x + 1, out)
        return out

    graphs = tgraphs.Graphs()
    g = graphs.wrap(fn)
    with pytest.raises(RuntimeError, match="capturing fn failed") as err:
        g({}, torch.zeros(2))
    assert "not permitted" in str(err.value.__cause__) and g.captured == {}
    assert graphs._pool is None  # the next capture takes a new pool
    fail[0] = False
    assert torch.equal(g({}, torch.zeros(2)), torch.ones(2)) and len(g.captured) == 1
    assert torch.equal(g({}, torch.ones(2)), torch.full((2,), 2.0))


# --------------------------------------------------------------------------
# the solvers and DeepCache under the replay runtime, the card stood in for
# --------------------------------------------------------------------------


@pytest.fixture
def recorded_loops(fake_cuda, monkeypatch):
    """The pipeline's loops, each registering its body with the stand-in
    capture so that a replay runs it again on the static buffers."""
    real = tpipe.make_denoise_loop

    def make(*args, **kwargs):
        loop = real(*args, **kwargs)

        def replayable(params, latents, ctx, text_embeds, time_ids, noise=None):
            tail = () if noise is None else (noise,)
            out = loop(params, latents, ctx, text_embeds, time_ids, *tail)
            fake_cuda.record(lambda: loop(params, latents, ctx, text_embeds, time_ids, *tail),
                             out)
            return out

        return replayable

    monkeypatch.setattr(tpipe, "make_denoise_loop", make)
    return fake_cuda


def _eager(pipe, prog, ids, seeds):
    neg = torch.as_tensor(pipe.clip_config.empty_prompt_ids(len(seeds), ids.shape[1]),
                          dtype=torch.long)
    tids = torch.as_tensor(ids, dtype=torch.long)
    with torch.inference_mode(), tops.use_backends(resolve_binding(pipe.compile_config)):
        inputs = prog.loop_inputs(pipe.params, tids, tids, neg, neg, seeds)
        return prog.loop.__wrapped__(pipe.params["unet"], *inputs), inputs


@pytest.mark.parametrize("solver,deep_cache,gi", [
    ("euler", 2, None), ("heun", (2, 1), (0.5, 5.0)), ("dpmpp_2m", 3, None),
    ("euler_a", None, None), ("euler_a", 2, (0.5, 5.0))])
def test_solver_and_deep_cache_loops_capture_once(recorded_loops, solver, deep_cache, gi):
    """A DeepCache or non-Euler loop through txt2img: the first call
    captures, a later one with another prompt and seed replays the one graph
    of its signature and gives the eager loop's latents on its own inputs;
    an ancestral solver's noise is one more static input, copied in at each
    call (a copy: the caller's tensor is not the buffer)."""
    pipe = tpipe.make_tiny_pipeline()
    kw = dict(height=SIZE, width=SIZE, steps=3, solver=solver, deep_cache=deep_cache,
              guidance_interval=gi, return_latents=True)
    first_ids, ids = _ids(pipe.clip_config, 1, 0), _ids(pipe.clip_config, 1, 1)
    first = pipe.txt2img(first_ids, first_ids, seed=5, **kw)
    got = pipe.txt2img(ids, ids, seed=6, **kw)
    (prog,) = pipe._cache.values()
    (entry,) = prog.loop.captured.values()
    assert entry.graph.replays == 1
    eager, inputs = _eager(pipe, prog, ids, [6])
    assert torch.equal(got, eager) and not torch.equal(got, first)
    assert torch.equal(first, _eager(pipe, prog, first_ids, [5])[0])
    assert len(entry.inputs) == len(inputs) == 4 + (solver == "euler_a")
    if solver == "euler_a":
        noise, lat = inputs[-1], SIZE // pipe.vae_config.spatial_scale_factor
        assert noise.shape == (3, 1, lat, lat, 4)
        assert torch.equal(entry.inputs[-1], noise) and entry.inputs[-1] is not noise


def test_deep_cache_and_solver_split_graphs(recorded_loops):
    """deep_cache and solver are part of a program's signature: each
    combination is its own program and graph; deep_cache=2 and (2, 1)
    replay one graph."""
    pipe = tpipe.make_tiny_pipeline()
    ids = _ids(pipe.clip_config, 1)
    kw = dict(height=SIZE, width=SIZE, steps=2, return_latents=True)
    for solver, dc in [("euler", None), ("euler", 2), ("euler", (2, 1)), ("euler", 3),
                       ("heun", 2), ("euler_a", 2), ("euler_a", None)]:
        pipe.txt2img(ids, ids, seed=1, solver=solver, deep_cache=dc, **kw)
    sigs = pipe.cache_signatures()
    assert len(sigs) == 6
    assert all(len(prog.loop.captured) == 1 for prog in pipe._cache.values())
    replays = {(sig[5], sig[-1]): next(iter(pipe._cache[sig].loop.captured.values())).graph.replays
               for sig in sigs}
    assert replays[("euler", (2, 1))] == 1 and sum(replays.values()) == 1


def test_deep_cache_loop_tally_counts_its_passes(fake_cuda):
    """A captured DeepCache loop (4 Euler steps, interval 2, CFG) counts its
    full and shallow passes once a replay, as the eager loop runs them."""
    counter = build.LaunchCounter()
    schedule = tsched.make_schedule(tsched.SchedulerConfig(), 4)

    def full(params, inp, t, ctx, te, tid, tc=None):
        counter.add(f"full {inp.shape[0]}")
        return _fake_unet_torch(params, inp, t, ctx, te, tid), 0.5 * inp

    def shallow(params, inp, t, ctx, te, tid, tc, cache):
        counter.add(f"shallow {inp.shape[0]}")
        return _fake_unet_torch(params, inp, t, ctx, te, tid) + 0.01 * cache

    loop = tmake_loop(_fake_unet_torch, schedule, deep_cache=(2, full, shallow, (4, 4, 4)))

    def fn(params, latents, ctx):
        out = loop(params, latents, ctx, None, None)
        fake_cuda.record(lambda: loop(params, latents, ctx, None, None), out)
        return out

    g = tgraphs.Graphs().wrap(fn)
    rng = np.random.default_rng(2)
    ctx = torch.from_numpy(rng.standard_normal((2, 3, 5)).astype(np.float32))
    g({}, torch.ones(1, 4, 4, 4), ctx)
    assert counter.by_key == {"full 2": 2, "shallow 2": 2}  # the warm-up counts
    (entry,) = g.captured.values()
    assert entry.tally == {(counter, "full 2"): 2, (counter, "shallow 2"): 2}
    lat = torch.from_numpy(rng.standard_normal((1, 4, 4, 4)).astype(np.float32))
    assert torch.equal(g({}, lat, ctx), loop({}, lat, ctx, None, None))
    assert counter.by_key == {"full 2": 6, "shallow 2": 6}  # replay + the eager check
