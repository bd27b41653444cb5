"""``runtime/profiling.py`` on the CPU: ``bench_fn``'s chaining against the
JAX package's, ``trace``'s Chrome trace, and the pipeline's one INFO line
per new program signature, as the JAX pipeline logs one per new jitted
signature.

Times are not compared: a CPU time says nothing of the card. What is held
exactly is what ``bench_fn`` feeds the function (the same sequence of
chained arguments as JAX's, on the CPU's two-length slope) and how many
lines each pipeline logs for the same sequence of requests.
"""

import dataclasses
import json
import logging
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu.compile import CompileConfig as JCompileConfig
from stabletriton_tpu.models import clip as jclip
from stabletriton_tpu.models import unet as junet
from stabletriton_tpu.models import vae as jvae
from stabletriton_tpu.runtime import pipeline as jpipe
from stabletriton_tpu.runtime import profiling as jprofiling
from stabletriton_tpu_torch.compile import CompileConfig
from stabletriton_tpu_torch.io.convert import params_from_numpy
from stabletriton_tpu_torch.models import clip as tclip
from stabletriton_tpu_torch.models import unet as tunet
from stabletriton_tpu_torch.models import vae as tvae
from stabletriton_tpu_torch.runtime import pipeline as tpipe
from stabletriton_tpu_torch.runtime import profiling
from test_torch_port_turbo import _ids, np_init
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _chained():
    """fn(x, y, *, step) -> x + y + step, recording the first elements of
    each call's ``x`` and ``y``. Each call sleeps 1 ms, so a longer chain
    always takes longer and neither bench_fn lengthens it."""
    seen = []

    def fn(x, y, *, step):
        seen.append((float(x.reshape(-1)[0]), float(y.reshape(-1)[0])))
        time.sleep(1e-3)
        return x + y + step

    return fn, seen


@pytest.mark.parametrize("chain_arg", [0, 1])
def test_bench_fn_chains_like_jax(chain_arg):
    """Each call's output goes into positional argument ``chain_arg``: the
    port's bench_fn feeds the function the same sequence of values as JAX's
    (warm-up, ``reps`` chains of each length), keyword arguments passed on,
    and returns a positive number of seconds."""
    runs = {}
    for name, bench, make in (("port", profiling.bench_fn, torch.zeros),
                              ("jax", jprofiling.bench_fn, np.zeros)):
        fn, seen = _chained()
        args = [make((2, 3)), make((2, 3))]
        t = bench(fn, *args, chain_arg=chain_arg, n_short=2, n_long=5, reps=2,
                  min_window=0.0, step=1.0)
        assert isinstance(t, float) and t > 0
        runs[name] = seen
    assert runs["port"] == runs["jax"]
    # one call, the warm-up chain of 2, then 2 chains of 2 and 2 of 5, each
    # starting from the first call's output, the other argument held
    chained = [0.0, 1.0, 2.0] + [1.0, 2.0] * 2 + [1.0, 2.0, 3.0, 4.0, 5.0] * 2
    assert [v[chain_arg] for v in runs["port"]] == chained
    assert all(v[1 - chain_arg] == 0.0 for v in runs["port"])


def test_bench_fn_lengthens_to_the_window():
    """With a window the chain of n_long calls cannot fill, the long chain
    grows 4x at a time until it does."""
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    t = profiling.bench_fn(fn, torch.zeros(1), n_short=1, n_long=2, reps=1, min_window=1e-3)
    assert t > 0 and len(calls) > 1 + 2 + 1 + 2


def test_trace_writes_a_chrome_trace(tmp_path, caplog):
    """``trace`` writes a Chrome trace of the block's ops into ``log_dir``
    and logs its path."""
    with caplog.at_level(logging.INFO, logger="stabletriton_tpu_torch"):
        with profiling.trace(log_dir=str(tmp_path)) as path:
            torch.ones((64, 64)) @ torch.ones((64, 64))
    assert path.startswith(str(tmp_path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert [r.getMessage() for r in caplog.records] == [f"profiler trace written to {path}"]


def test_trace_holds_the_serving_worker_and_the_spans(tmp_path):
    """``trace`` around a request served by ``ServingEngine``: the Chrome
    file holds the worker thread's ops, and the engine's and pipeline's
    spans on the profiler's clock, the worker's ops inside its group's
    span."""
    from stabletriton_tpu_torch.runtime.serving import ServingEngine

    class Tok:
        def encode_batch(self, texts, *, max_len=16, pad=99, **kw):
            return np.full((len(texts), max_len), pad, np.int32)

    profiling.reset()
    eng = ServingEngine(tpipe.make_tiny_pipeline(), Tok(), Tok(), max_wait_s=0.01)
    try:
        eng.generate("warm", height=32, width=32, steps=2)
        with profiling.trace(log_dir=str(tmp_path)) as path:
            eng.generate("traced", height=32, width=32, steps=2)
        worker = eng._thread.native_id
    finally:
        eng.close()
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e.get("tid") == worker and e.get("cat") == "cpu_op"]
    assert any(e["name"] == "aten::convolution" for e in ops)
    spans = {e["name"]: e for e in events if e.get("cat") == "program_span"}
    assert {"serve.request", "serve.queue", "serve.group", "serve.window", "serve.tokenize",
            "pipeline.call", "pipeline.conditioning", "pipeline.loop", "pipeline.decode",
            "serve.handback"} <= set(spans)
    assert spans["serve.group"]["tid"] == worker
    group = spans["serve.group"]
    lo, hi = group["ts"], group["ts"] + group["dur"]
    assert all(lo <= e["ts"] and e["ts"] + e.get("dur", 0) <= hi for e in ops)


def _signature_lines(caplog, logger):
    return [r for r in caplog.records if r.name == logger and r.levelno == logging.INFO
            and "signature" in r.getMessage()]


def test_one_info_line_per_new_signature_like_jax(caplog):
    """The same txt2img requests to JAX's tiny pipeline and the port's (the
    same numpy weights): each new signature logs one INFO line, a repeat
    none, in both."""
    ucfg, c1, c2, vcfg = tpipe.tiny_configs()
    ju, jc1, jc2, jv = (cls(**dataclasses.asdict(c)) for cls, c in (
        (junet.UNetConfig, ucfg), (jclip.CLIPTextConfig, c1), (jclip.CLIPTextConfig, c2),
        (jvae.VAEConfig, vcfg)))
    params = {"unet": np_init(junet.unet_param_shapes(ju), 0),
              "text_encoder": np_init(jclip.clip_param_shapes(jc1), 1),
              "text_encoder_2": np_init(jclip.clip_param_shapes(jc2), 2),
              "vae": np_init(jvae.vae_decoder_param_shapes(jv), 3)}
    jp = jpipe.SDXLPipeline(
        unet_config=ju, clip_config=jc1, clip2_config=jc2, vae_config=jv,
        params={g: {k: jnp.asarray(v) for k, v in t.items()} for g, t in params.items()},
        compile_config=JCompileConfig(backend="reference", dtype="float32"))
    tp = tpipe.make_tiny_pipeline(params=params_from_numpy(params))
    ids = _ids(c1, 1)
    requests = [dict(steps=1), dict(steps=1), dict(steps=2), dict(steps=1)]
    for pipe, logger, wrap in ((jp, "stabletriton_tpu", jnp.asarray),
                               (tp, "stabletriton_tpu_torch", np.asarray)):
        caplog.clear()
        counts = []
        with caplog.at_level(logging.INFO, logger=logger):
            for kw in requests:
                pipe.txt2img(wrap(ids), wrap(ids), height=32, width=32, return_latents=True,
                             seed=0, **kw)
                counts.append(len(_signature_lines(caplog, logger)))
        assert counts == [1, 1, 2, 2], logger


def test_every_program_path_logs_once(caplog):
    """txt2img, img2img and inpaint each log one INFO line for a new
    signature and none for a repeat (the port's one building site,
    ``SDXLPipeline._cached``)."""
    base = tpipe.make_tiny_pipeline()
    ucfg, c1, c2, vcfg = tpipe.tiny_configs()
    ucfg = dataclasses.replace(ucfg, in_channels=9)
    params = {"unet": tunet.init_unet_params(ucfg, 0),
              "text_encoder": tclip.init_clip_params(c1, 1),
              "text_encoder_2": tclip.init_clip_params(c2, 2),
              "vae": {**tvae.init_vae_params(vcfg, 3), **tvae.init_vae_encoder_params(vcfg, 4)}}
    inpainting = tpipe.SDXLPipeline(
        unet_config=ucfg, clip_config=c1, clip2_config=c2, vae_config=vcfg, params=params,
        device="cpu", compile_config=CompileConfig(backend="reference", dtype="float32"))
    ids = _ids(c1, 1)
    gen = torch.Generator().manual_seed(0)
    image = torch.rand((1, 32, 32, 3), generator=gen) * 2 - 1
    mask = (torch.rand((1, 32, 32, 1), generator=gen) > 0.5).float()
    latents = torch.zeros((1, 4, 4, 4))
    calls = [
        lambda: base.txt2img(ids, ids, height=32, width=32, steps=1, return_latents=True),
        lambda: base.img2img(latents, ids, ids, steps=2, strength=0.5, decode=False),
        lambda: inpainting.inpaint(image, mask, ids, ids, steps=1),
    ]
    with caplog.at_level(logging.INFO, logger="stabletriton_tpu_torch"):
        for i, call in enumerate(calls):
            for _ in range(2):
                call()
            assert len(_signature_lines(caplog, "stabletriton_tpu_torch")) == i + 1
