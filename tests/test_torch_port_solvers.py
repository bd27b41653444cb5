"""The solvers against the JAX package, on the CPU: Euler-Ancestral, Heun and
DPM-Solver++(2M), the scheduler's step functions, the denoise loop, txt2img
and serving.

The same numpy inputs (from seeds) go through both packages in float32.
Tolerances:

  * the step functions: 2e-6 of the largest magnitude (a few float32 ulps:
    the port computes each step's scalars on the host in float32, JAX inside
    its jitted step, where XLA may fuse a multiply-add or take ``log`` /
    ``expm1`` an ulp apart);
  * the analytic-ODE checks: the JAX package's own bounds
    (``tests/test_scheduler.py``);
  * the loop with a stand-in UNet: 2e-6 of the largest latent (values to
    ~20);
  * txt2img's latents on the tiny pipeline: 1e-4 (std ~1, summation order
    through CLIP and the UNet);
  * an image alone against the same image co-batched: 2e-5, JAX's bound
    (``tests/test_serving.py``).

The ancestral noise is injected: the port's chain is its own (per-image
torch generators), so the JAX package's ``_ancestral_noise`` replaces it
where the two are compared.
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
from stabletriton_tpu.runtime.serving import Request as JRequest
from stabletriton_tpu_torch.compile import CompileConfig
from stabletriton_tpu_torch.io.convert import params_from_numpy
from stabletriton_tpu_torch.runtime import pipeline as tpipe
from stabletriton_tpu_torch.runtime import scheduler as tsched
from stabletriton_tpu_torch.runtime.denoise import SOLVERS
from stabletriton_tpu_torch.runtime.denoise import make_denoise_loop as tmake_loop
from stabletriton_tpu_torch.runtime.serving import Request, ServingEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZE = 32
STEP_TOL = 2e-6


def _close(got, want, rel):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * max(1.0, np.abs(want).max()), rtol=0)


# --------------------------------------------------------------------------
# the step functions
# --------------------------------------------------------------------------


def _sigma_pairs():
    """(sigma, sigma_next, sigma_prev) from the SDXL schedule: the first
    step, a middle one, the last (sigma_next == 0), and Karras spacing's."""
    s = jsched.make_schedule(jsched.SchedulerConfig(), 8).sigmas
    k = jsched.make_schedule(jsched.SchedulerConfig(use_karras_sigmas=True), 6).sigmas
    return [(s[0], s[1], s[0]), (s[3], s[4], s[2]), (s[7], s[8], s[6]), (k[2], k[3], k[1]),
            (k[5], k[6], k[4])]


def _tensors(seed, shape=(2, 4, 4, 4)):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(shape) * scale).astype(np.float32)
            for scale in (8.0, 1.0, 1.0, 3.0)]


@pytest.mark.parametrize("case", range(5))
def test_ancestral_sigmas_match_jax(case):
    sigma, sigma_next, _ = _sigma_pairs()[case]
    want = jsched.ancestral_sigmas(jnp.float32(sigma), jnp.float32(sigma_next))
    got = tsched.ancestral_sigmas(sigma, sigma_next)
    assert all(isinstance(v, np.float32) for v in got)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=2e-7, atol=0)


@pytest.mark.parametrize("case", range(5))
def test_euler_ancestral_step_matches_jax(case):
    sigma, sigma_next, _ = _sigma_pairs()[case]
    x, eps, _, noise = _tensors(case)
    want = jsched.euler_ancestral_step(jnp.asarray(x), jnp.asarray(eps), jnp.float32(sigma),
                                       jnp.float32(sigma_next), jnp.asarray(noise))
    got = tsched.euler_ancestral_step(*map(torch.from_numpy, (x, eps)), float(sigma),
                                      float(sigma_next), torch.from_numpy(noise))
    _close(got, want, STEP_TOL)


@pytest.mark.parametrize("case", range(5))
def test_heun_step_matches_jax(case):
    """Including sigma_next == 0, where the port does not read eps_next."""
    sigma, sigma_next, _ = _sigma_pairs()[case]
    x, eps, eps2, _ = _tensors(10 + case)
    want = jsched.heun_step(jnp.asarray(x), jnp.asarray(eps), jnp.asarray(eps2),
                            jnp.float32(sigma), jnp.float32(sigma_next))
    eps_next = None if sigma_next == 0 else torch.from_numpy(eps2)
    got = tsched.heun_step(torch.from_numpy(x), torch.from_numpy(eps), eps_next, float(sigma),
                           float(sigma_next))
    _close(got, want, STEP_TOL)


@pytest.mark.parametrize("have_prev", [False, True])
@pytest.mark.parametrize("case", range(5))
def test_dpmpp_2m_step_matches_jax(case, have_prev):
    sigma, sigma_next, sigma_prev = _sigma_pairs()[case]
    x, eps, prev, _ = _tensors(20 + case)
    want, want_x0 = jsched.dpmpp_2m_step(
        jnp.asarray(x), jnp.asarray(eps), jnp.float32(sigma), jnp.float32(sigma_next),
        jnp.asarray(prev), jnp.bool_(have_prev), jnp.float32(sigma_prev))
    got, x0 = tsched.dpmpp_2m_step(torch.from_numpy(x), torch.from_numpy(eps), float(sigma),
                                   float(sigma_next), torch.from_numpy(prev), have_prev,
                                   float(sigma_prev))
    _close(got, want, STEP_TOL)
    _close(x0, want_x0, STEP_TOL)
    assert x0.dtype == torch.float32


def test_dpmpp_2m_floors():
    """JAX's floors: 1e-10 on each sigma and on r0 (sigma_prev == sigma,
    the first step's, gives r0 = 0): finite coefficients, the same as
    JAX's formula evaluated in float32 numpy."""
    ratio, expm1_h, c_cur, c_prev = tsched.dpmpp_2m_coefficients(2.0, 1.0, 2.0)
    assert ratio == np.float32(0.5) and expm1_h == np.expm1(-np.float32(np.log(2.0)))
    assert c_prev == np.float32(1.0) / np.float32(2e-10) and np.isfinite(c_cur)
    x = torch.full((1, 2, 2, 1), 3.0)
    out, _ = tsched.dpmpp_2m_step(x, torch.ones_like(x), 2.0, 1.0, torch.zeros_like(x), True,
                                  2.0)
    want, _ = jsched.dpmpp_2m_step(jnp.full((1, 2, 2, 1), 3.0), jnp.ones((1, 2, 2, 1)),
                                   jnp.float32(2.0), jnp.float32(1.0), jnp.zeros((1, 2, 2, 1)),
                                   jnp.bool_(True), jnp.float32(2.0))
    _close(out, want, STEP_TOL)


def test_steps_keep_the_sample_dtype():
    x = torch.randn(1, 2, 2, 4).to(torch.bfloat16)
    e = torch.randn(1, 2, 2, 4).to(torch.bfloat16)
    assert tsched.euler_ancestral_step(x, e, 3.0, 2.0, torch.randn(1, 2, 2, 4)).dtype == x.dtype
    assert tsched.heun_step(x, e, e, 3.0, 2.0).dtype == x.dtype
    out, x0 = tsched.dpmpp_2m_step(x, e, 3.0, 2.0, torch.zeros(1, 2, 2, 4), False, 3.0)
    assert out.dtype == x.dtype and x0.dtype == torch.float32


# --------------------------------------------------------------------------
# the JAX package's analytic checks (tests/test_scheduler.py), on the port
# --------------------------------------------------------------------------


def test_dpmpp_first_step_exact_for_exact_eps():
    x0 = torch.ones((1, 2, 2, 1))
    eps = torch.ones_like(x0)
    out, x0_pred = tsched.dpmpp_2m_step(x0 + 10.0 * eps, eps, 10.0, 5.0, torch.zeros_like(x0),
                                        False, 10.0)
    np.testing.assert_allclose(x0_pred.numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), 6.0, atol=1e-4)


def test_dpmpp_trajectory_exact_on_analytic_ode():
    schedule = tsched.make_schedule(tsched.SchedulerConfig(), 12)
    x0, c = np.float32(2.5), np.float32(-1.25)
    x = torch.full((1, 2, 2, 1), float(x0 + schedule.sigmas[0] * c))
    prev = torch.zeros_like(x)
    for i in range(12):
        s, s_next = float(schedule.sigmas[i]), float(schedule.sigmas[i + 1])
        s_prev = float(schedule.sigmas[i - 1] if i else schedule.sigmas[0])
        x, prev = tsched.dpmpp_2m_step(x, (x - float(x0)) / s, s, s_next, prev, i > 0, s_prev)
        np.testing.assert_allclose(x.numpy(), x0 + s_next * c, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(x.numpy(), x0, rtol=2e-5)


def test_dpmpp_final_step_returns_x0():
    x = torch.full((1, 2, 2, 1), 4.0)
    out, _ = tsched.dpmpp_2m_step(x, torch.ones_like(x), 2.0, 0.0, torch.zeros_like(x), True, 4.0)
    np.testing.assert_allclose(out.numpy(), 2.0, atol=1e-5)


def test_heun_trajectory_exact_on_analytic_ode():
    """Exact eps on x = x0 + sigma * c: Heun's two equal slopes track the
    solution and finish at x0 (the loop with a UNet that knows the answer)."""
    schedule = tsched.make_schedule(tsched.SchedulerConfig(), 8)
    x0, c = np.float32(1.5), np.float32(0.75)
    sig_of_t = {float(t): float(s) for t, s in zip(schedule.timesteps, schedule.sigmas)}

    def exact_unet(params, sample, t, ctx, te, tid):
        sigma = sig_of_t[float(t[0])]
        x = sample * float(np.sqrt(np.float32(sigma) ** 2 + np.float32(1.0)))
        return (x - float(x0)) / max(sigma, 1e-6)

    loop = tmake_loop(exact_unet, schedule, guidance_scale=1.0, solver="heun")
    lat = torch.full((1, 2, 2, 1), float(x0 + schedule.sigmas[0] * c))
    out = loop({}, lat, torch.zeros((2, 3, 8)), torch.zeros((2, 8)), torch.zeros((2, 6)))
    np.testing.assert_allclose(out.numpy(), x0, rtol=1e-4, atol=1e-4)


def test_heun_final_step_collapses_to_x0():
    x = torch.full((1, 2, 2, 1), 4.0)
    out = tsched.heun_step(x, torch.ones_like(x), None, 2.0, 0.0)
    np.testing.assert_allclose(out.numpy(), 2.0, atol=1e-6)


def test_dpmpp_loop_anneals_noise():
    schedule = tsched.make_schedule(tsched.SchedulerConfig(), 20)
    loop = tmake_loop(lambda p, s, t, c, te, ti: s, schedule, guidance_scale=1.0,
                      solver="dpmpp_2m")
    lat = torch.full((1, 4, 4, 4), float(schedule.init_noise_sigma))
    out = loop({}, lat, torch.zeros((2, 3, 8)), torch.zeros((2, 8)), torch.zeros((2, 6)))
    assert float(out.abs().max()) < 0.25 * schedule.init_noise_sigma


def test_ancestral_sigmas_variance_split():
    down, up = tsched.ancestral_sigmas(10.0, 5.0)
    np.testing.assert_allclose(float(down ** 2 + up ** 2), 25.0, rtol=1e-6)
    assert 0.0 < float(up) < 5.0
    assert tsched.ancestral_sigmas(10.0, 0.0) == (0.0, 0.0)


def test_euler_ancestral_step_semantics():
    x0 = torch.ones((1, 2, 2, 1))
    eps = torch.full_like(x0, 0.5)
    x = x0 + 4.0 * eps
    down, _ = tsched.ancestral_sigmas(4.0, 2.0)
    out = tsched.euler_ancestral_step(x, eps, 4.0, 2.0, torch.zeros_like(x))
    np.testing.assert_allclose(out.numpy(), (x + eps * float(down - 4.0)).numpy(), atol=1e-6)
    out0 = tsched.euler_ancestral_step(x, eps, 4.0, 0.0, torch.full_like(x, 9.0))
    np.testing.assert_allclose(out0.numpy(), x0.numpy(), atol=1e-6)


def test_euler_a_loop_needs_noise_and_reads_it():
    schedule = tsched.make_schedule(tsched.SchedulerConfig(), 6)
    loop = tmake_loop(lambda p, s, t, c, te, ti: 0.1 * s, schedule, guidance_scale=1.0,
                      solver="euler_a")
    lat = torch.ones((2, 4, 4, 4)) * schedule.init_noise_sigma
    cond = (torch.zeros((4, 7, 8)), torch.zeros((4, 8)), torch.zeros((4, 6)))
    with pytest.raises(ValueError, match="noise"):
        loop({}, lat, *cond)
    nz = torch.randn((6, 2, 4, 4, 4), generator=torch.Generator().manual_seed(0))
    out = loop({}, lat, *cond, noise=nz)
    assert out.shape == lat.shape and torch.isfinite(out).all()
    assert not torch.allclose(out, loop({}, lat, *cond, noise=nz * 0.5))


def test_unknown_solver_raises():
    schedule = tsched.make_schedule(tsched.SchedulerConfig(), 2)
    assert SOLVERS == ("euler", "euler_a", "heun", "dpmpp_2m")
    for solver in ("ddim", "dpmpp_2s", "Euler"):
        with pytest.raises(ValueError, match="unknown solver"):
            tmake_loop(lambda *a: None, schedule, solver=solver)


# --------------------------------------------------------------------------
# the loop, every solver x {CFG, no CFG, guidance interval}, stand-in UNet
# --------------------------------------------------------------------------


def _fake_unet_torch(params, sample, t, ctx, te, tid):
    """eps = 0.1 * sample + the row's ctx mean + 1e-4 t: cond and uncond
    differ, and Heun's correction sees its own timestep."""
    return 0.1 * sample + ctx.mean(dim=(1, 2)).reshape(-1, 1, 1, 1) + 1e-4 * t.reshape(-1, 1, 1, 1)


def _fake_unet_jax(params, sample, t, ctx, te, tid):
    return 0.1 * sample + ctx.mean(axis=(1, 2)).reshape(-1, 1, 1, 1) + 1e-4 * t.reshape(-1, 1, 1, 1)


def _loop_inputs(steps, seed=3):
    rng = np.random.default_rng(seed)
    lat = (rng.standard_normal((2, 4, 4, 4)) * 10).astype(np.float32)
    ctx = rng.standard_normal((4, 3, 5)).astype(np.float32)
    noise = rng.standard_normal((steps, 2, 4, 4, 4)).astype(np.float32)
    return lat, ctx, noise


def _modes():
    s = jsched.make_schedule(jsched.SchedulerConfig(), 5).sigmas
    return {"cfg": (5.0, None), "no_cfg": (1.0, None),
            "interval": (5.0, (float(s[3] + s[4]) / 2, float(s[0] + s[1]) / 2))}


@pytest.mark.parametrize("mode", ["cfg", "no_cfg", "interval"])
@pytest.mark.parametrize("solver", SOLVERS)
def test_loop_matches_jax(solver, mode):
    """5 steps; the window holds steps 1-3 (Heun's corrections at sigmas 2-4
    too, so its last guided correction follows a guided step)."""
    g, gi = _modes()[mode]
    schedule = jsched.make_schedule(jsched.SchedulerConfig(), 5)
    lat, ctx, noise = _loop_inputs(5)
    kw_j = {"noise": jnp.asarray(noise)} if solver == "euler_a" else {}
    kw_t = {"noise": torch.from_numpy(noise)} if solver == "euler_a" else {}
    want = jmake_loop(_fake_unet_jax, schedule, guidance_scale=g, solver=solver,
                      guidance_interval=gi)({}, jnp.asarray(lat), jnp.asarray(ctx), None, None,
                                            **kw_j)
    got = tmake_loop(_fake_unet_torch, tsched.make_schedule(tsched.SchedulerConfig(), 5),
                     guidance_scale=g, solver=solver, guidance_interval=gi)(
        {}, torch.from_numpy(lat), torch.from_numpy(ctx), None, None, **kw_t)
    _close(got, want, STEP_TOL)


@pytest.mark.parametrize("solver,calls", [("euler", 4), ("euler_a", 4), ("dpmpp_2m", 4),
                                          ("heun", 7)])
def test_unet_evaluations_per_solver(solver, calls):
    """Heun evaluates twice a step but once at the last (sigma_next == 0),
    where JAX's correction is discarded; the others once a step. The
    correction's batch follows the window at sigma_next."""
    schedule = tsched.make_schedule(tsched.SchedulerConfig(), 4)
    s = schedule.sigmas
    gi = (float(s[2]), float(s[1]))  # steps 1 and 2, in float32
    rows = []

    def unet(params, sample, t, ctx, te, tid):
        rows.append((sample.shape[0], float(t[0])))
        return _fake_unet_torch(params, sample, t, ctx, te, tid)

    lat, ctx, noise = _loop_inputs(4)
    kw = {"noise": torch.from_numpy(noise)} if solver == "euler_a" else {}
    tmake_loop(unet, schedule, guidance_scale=5.0, solver=solver, guidance_interval=gi)(
        {}, torch.from_numpy(lat), torch.from_numpy(ctx), None, None, **kw)
    ts = [float(t) for t in schedule.timesteps]
    if solver == "heun":
        want = [(2, ts[0]), (4, ts[1]), (4, ts[1]), (4, ts[2]), (4, ts[2]), (2, ts[3]),
                (2, ts[3])]
    else:
        want = [(2, ts[0]), (4, ts[1]), (4, ts[2]), (2, ts[3])]
    assert len(rows) == calls and rows == want


# --------------------------------------------------------------------------
# txt2img on the tiny pipeline, every solver, against JAX's
# --------------------------------------------------------------------------


def _jax_noise(seeds, shape, device):
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
        jax.random.PRNGKey(s), shape, jnp.float32)) for s in seeds]))


def _jax_ancestral(seeds, steps, shape, device):
    """The JAX pipeline's ancestral chain for ``seeds`` (fold_in(key, 1))."""
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


@pytest.fixture(scope="module")
def pipelines():
    return tiny_pipelines()


@pytest.mark.parametrize("solver", SOLVERS)
def test_txt2img_solver_matches_jax(pipelines, solver, monkeypatch):
    """3 steps, guidance 5, two images, the same injected initial and
    ancestral noise; latents within 1e-4."""
    jp, tp = pipelines
    monkeypatch.setattr(tpipe, "initial_noise", _jax_noise)
    monkeypatch.setattr(tpipe, "ancestral_noise", _jax_ancestral)
    ids = _ids(tp.clip_config, 2)
    kw = dict(height=SIZE, width=SIZE, steps=3, seed=[3, 4], solver=solver,
              return_latents=True)
    want = np.asarray(jp.txt2img(jnp.asarray(ids), jnp.asarray(ids), **kw))
    got = tp.txt2img(ids, ids, **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    assert any(sig[5] == solver for sig in tp.cache_signatures())


def test_txt2img_unknown_solver_raises():
    tp = tpipe.make_tiny_pipeline()
    ids = _ids(tp.clip_config, 1)
    with pytest.raises(ValueError, match="unknown solver"):
        tp.txt2img(ids, ids, height=SIZE, width=SIZE, steps=2, solver="ddim")
    assert tp.cache_signatures() == []


# --------------------------------------------------------------------------
# the ancestral noise
# --------------------------------------------------------------------------


def test_ancestral_noise_is_per_image_and_apart_from_the_initial_noise():
    """(steps, B, *shape) float32; an image's chain does not depend on its
    slot or its batch; it is not the image's initial noise, and two seeds
    give two chains."""
    shape = (4, 4, 4)
    alone = tpipe.ancestral_noise([7], 3, shape, "cpu")
    pair = tpipe.ancestral_noise([5, 7], 3, shape, "cpu")
    assert alone.shape == (3, 1, *shape) and pair.shape == (3, 2, *shape)
    assert alone.dtype == torch.float32
    assert torch.equal(pair[:, 1], alone[:, 0])
    assert not torch.equal(pair[:, 0], pair[:, 1])
    first = tpipe.initial_noise([7], shape, "cpu")[0]
    assert not any(torch.allclose(first, alone[i, 0]) for i in range(3))
    assert torch.equal(tpipe.ancestral_noise([7], 3, shape, "cpu"), alone)  # deterministic


def test_txt2img_euler_a_is_seeded_per_image():
    """With the port's own chains: an image alone equals itself in slot 1
    of a batch of two within 2e-5, and another seed changes it."""
    tp = tpipe.make_tiny_pipeline()
    ids1, ids2 = _ids(tp.clip_config, 1, 1), _ids(tp.clip_config, 2, 1)
    ids2[1] = ids1[0]
    kw = dict(height=SIZE, width=SIZE, steps=3, solver="euler_a", return_latents=True)
    alone = tp.txt2img(ids1, ids1, seed=[9], **kw)
    pair = tp.txt2img(ids2, ids2, seed=[4, 9], **kw)
    np.testing.assert_allclose(pair[1:].numpy(), alone.numpy(), atol=2e-5, rtol=0)
    other = tp.txt2img(ids1, ids1, seed=[10], **kw)
    assert not torch.allclose(other, alone, atol=1e-3)


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


class _Tok:
    def encode_batch(self, texts, *, max_len=16, pad=99, **kw):
        out = np.full((len(texts), max_len), pad, np.int32)
        for i, t in enumerate(texts):
            ids = [98] + [(ord(c) % 90) + 5 for c in t[: max_len - 2]] + [99]
            out[i, : len(ids)] = ids
        return out


def test_request_signature_splits_solvers():
    kw = dict(prompt="p", height=SIZE, width=SIZE, steps=2)
    sigs = {Request(solver=s, **kw).signature for s in SOLVERS}
    assert len(sigs) == len(SOLVERS)
    for s in SOLVERS:
        assert Request(solver=s, **kw).signature == JRequest(solver=s, **kw).signature


def test_engine_euler_a_alone_equals_co_batched():
    """An Euler-A request's image alone (bucket 1) and co-batched with
    another (bucket 2) agree within 2e-5: its noise chains follow its
    seed, not its slot."""
    pipe = tpipe.make_tiny_pipeline()
    eng = ServingEngine(pipe, _Tok(), _Tok(), max_wait_s=0.5)
    kw = dict(height=SIZE, width=SIZE, steps=3, solver="euler_a")
    try:
        futs = [eng.submit(Request(prompt="a cat", seed=5, **kw)),
                eng.submit(Request(prompt="a dog", seed=6, **kw))]
        batched = [f.result(timeout=300) for f in futs]
        alone = eng.submit(Request(prompt="a cat", seed=5, **kw)).result(timeout=300)
    finally:
        eng.close()
    np.testing.assert_allclose(batched[0], alone, atol=2e-5, rtol=0)
    assert not np.allclose(batched[0], batched[1], atol=1e-3)
    assert sorted(sig[0] for sig in pipe.cache_signatures()) == [1, 2]
