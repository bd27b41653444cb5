"""The port's device mesh against the JAX package's, on the CPU: one
``torch.multiprocessing`` run of four gloo ranks (a ``file://`` store under
the test's tmp_path, each rank on one torch thread, a time limit) on a
("data", "model") = (2, 2) mesh, plus (1, 4) and (4, 1) meshes over the same
ranks. The JAX side runs here, on its virtual 8-device CPU mesh, and its
results go to the ranks as numpy arrays (``tests/torch_mesh_worker.py``
imports no JAX). The checks:

  * ``param_sharding`` gives the dimension of JAX's ``param_sharding(...).spec``
    on an 8-device mesh for every key of the tiny and SDXL-base UNet shape
    tables, the fused and boundary keys too, at model sizes 2 and 4;
  * the sharded tiny UNet's forward (batch over "data", heads and the
    feed-forward width over "model", nonzero biases so a bias added on every
    rank would show) equals JAX's unsharded ``unet_apply`` on the same numpy
    weights within 2e-4, at JAX's test shapes (``tests/test_mesh.py``);
  * the sharded tiny pipeline's txt2img (projections unfused) equals JAX's
    unsharded one within 2e-4, on JAX's initial noise;
  * int8 (weight, scale) pairs stay output-channel-major after sharding;
  * image i of a batch on a data-parallel mesh is bit for bit the request
    alone off the mesh (seed + i);
  * the serving buckets and their ValueError are JAX's, and rank 0 leads
    the other ranks' engines through the same calls, past a failing group.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

from stabletriton_tpu.compile import CompileConfig as JCompileConfig
from stabletriton_tpu.models import clip as jclip
from stabletriton_tpu.models import unet as junet
from stabletriton_tpu.models import vae as jvae
from stabletriton_tpu.runtime import mesh as jmesh
from stabletriton_tpu.runtime import pipeline as jpipe
from stabletriton_tpu_torch.compile import fuse_attention_projections
from stabletriton_tpu_torch.models import unet as tunet
from stabletriton_tpu_torch.runtime import mesh as tmesh
from stabletriton_tpu_torch.runtime import pipeline as tpipe
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

WORLD = 4
SIZE = 32
TIMEOUT_S = 240


def _init(shapes: dict, seed: int) -> dict:
    """N(0, 1/fan_in) weights, unit norm scales and N(0, 0.1) biases."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith(".bias"):
            out[name] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
        elif "norm" in name and len(shape) == 1:
            out[name] = np.ones(shape, np.float32)
        else:
            fan = int(np.prod(shape[:-1]))
            out[name] = (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)
    return out


def _shape_tables() -> dict:
    tables = {}
    for name, cfg in (("tiny", tunet.tiny_unet_config()),
                      ("sdxl", tunet.sdxl_base_unet_config())):
        shapes = tunet.unet_param_shapes(cfg)
        fused = fuse_attention_projections(
            {k: torch.empty(s, device="meta") for k, s in shapes.items()})
        tables[name] = {**shapes, **{k: tuple(v.shape) for k, v in fused.items()},
                        "decoder.mid_block.attentions.0.to_q.weight": (16, 16)}
    return tables


def _jax_dim(spec) -> int | None:
    spec = tuple(spec)
    return spec.index("model") if "model" in spec else None


def _ids(cfg, batch, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.full((batch, cfg.max_position_embeddings), cfg.eos_token_id, np.int32)
    for i in range(batch):
        n = 3 + 2 * i
        ids[i, 0] = cfg.bos_token_id
        ids[i, 1:1 + n] = rng.integers(0, 90, n)
    return ids


@pytest.fixture(scope="module")
def jax_side():
    """The numpy weights and inputs, and JAX's unsharded results on them."""
    ucfg, c1, c2, vcfg = tpipe.tiny_configs()
    ju, jc1, jc2 = (junet.UNetConfig(**dataclasses.asdict(ucfg)),
                    jclip.CLIPTextConfig(**dataclasses.asdict(c1)),
                    jclip.CLIPTextConfig(**dataclasses.asdict(c2)))
    jv = jvae.VAEConfig(**dataclasses.asdict(vcfg))
    params = {"unet": _init(junet.unet_param_shapes(ju), 0),
              "text_encoder": _init(jclip.clip_param_shapes(jc1), 1),
              "text_encoder_2": _init(jclip.clip_param_shapes(jc2), 2),
              "vae": _init(jvae.vae_decoder_param_shapes(jv), 3)}
    rng = np.random.default_rng(0)
    b = 4
    inputs = {
        "params": params,
        "sample": rng.standard_normal((b, 16, 16, 4)).astype(np.float32),
        "t": np.full((b,), 500.0, np.float32),
        "ehs": rng.standard_normal((b, 7, ucfg.cross_attention_dim)).astype(np.float32),
        "te": rng.standard_normal((b, 16)).astype(np.float32),
        "ti": np.zeros((b, 6), np.float32),
        "ids": _ids(c1, b),
        "tables": _shape_tables(),
    }
    jparams = {g: {k: jnp.asarray(v) for k, v in tree.items()} for g, tree in params.items()}
    unet = np.asarray(junet.unet_apply(ju, jparams["unet"], *(jnp.asarray(inputs[k]) for k in (
        "sample", "t", "ehs", "te", "ti"))))
    jp = jpipe.SDXLPipeline(unet_config=ju, clip_config=jc1, clip2_config=jc2, vae_config=jv,
                            params=jparams,
                            compile_config=JCompileConfig(backend="reference", dtype="float32"))
    lat = (SIZE // vcfg.spatial_scale_factor,) * 2 + (vcfg.latent_channels,)
    inputs["noise"] = {s: np.asarray(jax.random.normal(jax.random.PRNGKey(s), lat, jnp.float32))
                       for s in range(b)}
    ids = jnp.asarray(inputs["ids"])
    txt2img = np.asarray(jp.txt2img(ids, ids, height=SIZE, width=SIZE, steps=2, seed=0))
    specs = {}
    for model in (2, 4):
        mesh = jmesh.make_mesh(data=8 // model, model=model, devices=jax.devices()[:8])
        specs[model] = {name: {k: _jax_dim(jmesh.param_sharding(k, shape, mesh).spec)
                               for k, shape in table.items()}
                        for name, table in inputs["tables"].items()}
    return inputs, {"unet": unet, "txt2img": txt2img, "specs": specs}


@pytest.fixture(scope="module")
def ranks(jax_side, tmp_path_factory):
    """Run the four ranks once; each rank's results, in rank order."""
    import torch_mesh_worker

    inputs, _ = jax_side
    out = tmp_path_factory.mktemp("mesh")
    ctx = tmp.start_processes(torch_mesh_worker.run,
                              args=(WORLD, str(out / "store"), inputs, str(out)),
                              nprocs=WORLD, join=False, start_method="spawn")
    try:
        done = False
        deadline = time.monotonic() + TIMEOUT_S
        while not done:
            remaining = deadline - time.monotonic()
            assert remaining > 0, f"the four ranks did not finish in {TIMEOUT_S} s"
            done = ctx.join(timeout=min(5.0, remaining))
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def test_ranks_are_data_major(ranks):
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("table", ["tiny", "sdxl"])
def test_param_sharding_equals_jax(ranks, jax_side, model, table):
    want = jax_side[1]["specs"][model][table]
    got = ranks[0]["specs"][model][table]
    assert got == want
    assert any(d == 1 for d in got.values()) and any(d == 0 for d in got.values())


def test_sharded_unet_equals_jax_unsharded(ranks, jax_side):
    want = jax_side[1]["unet"]
    for r in ranks:
        assert r["unet"].shape == want.shape
        np.testing.assert_allclose(r["unet"], want, atol=2e-4, rtol=0)


def test_sharded_pipeline_equals_jax_unsharded(ranks, jax_side):
    want = jax_side[1]["txt2img"]
    for r in ranks:
        assert r["unfused"] == []
        np.testing.assert_allclose(r["txt2img"], want, atol=2e-4, rtol=0)
    # a rank's q projection holds its heads' columns
    assert ranks[0]["local_q"] == (64, 32)
    assert "not divisible by the mesh's data axis (2)" in ranks[0]["odd_batch"]


def test_int8_pairs_stay_output_channel_major(ranks):
    layouts = ranks[1]["int8"]
    assert {v["dim"] for v in layouts.values()} == {None, 0, 1}
    for key, v in layouts.items():
        assert v["out_major"] and v["equal"], key
        if v["dim"] is not None:
            assert v["shape"][v["dim"]] * 2 == v["full"][v["dim"]], key


def test_data_parallel_image_equals_the_request_alone(ranks):
    assert all(r["dp_equal"] for r in ranks)


def test_serving_buckets_and_leader(ranks):
    for r in ranks:
        assert r["buckets"] == (2, 4, 8, 16)
        assert r["cap_error"] == ("max_batch=1 is below the smallest mesh-compatible bucket 2 "
                                  "(data axis 2); raise max_batch or use a smaller data axis")
    assert all("only global rank 0" in r["follower_submit"] for r in ranks[1:])
    served = ranks[0]["served"]
    assert served.shape == (3, SIZE, SIZE, 3)
    np.testing.assert_allclose(served, ranks[0]["direct"], atol=1e-5, rtol=0)


def test_serving_survives_a_failing_group(ranks):
    """A bad group fails its futures and the ranks go on: rank 0's check
    refuses it before the broadcast, or, where it passes the check, every
    rank raises alike and the followers follow the next call."""
    r = ranks[0]
    assert "height/width must be multiples of" in r["refused"]
    assert "unknown solver 'nope'" in r["failed"]
    np.testing.assert_allclose(r["after"], r["served"][0], atol=1e-5, rtol=0)


def test_jax_serving_raises_the_same_error():
    """JAX's engine over a data-2 mesh refuses the same cap with the same
    words (its buckets are the data axis' multiples too)."""
    from stabletriton_tpu.runtime.serving import ServingEngine as JEngine

    class Pipe:
        mesh = jmesh.make_mesh(data=2, model=4, devices=jax.devices()[:8])

    with pytest.raises(ValueError) as e:
        JEngine(Pipe(), None, None, max_batch=1)
    assert str(e.value) == ("max_batch=1 is below the smallest mesh-compatible bucket 2 "
                            "(data axis 2); raise max_batch or use a smaller data axis")


def test_make_mesh_without_a_card_raises(monkeypatch):
    """make_mesh puts the mesh on the card by default: where torch sees no
    card it raises (no process group needed to find out), and a CPU (gloo)
    mesh is built only when the caller asks for device_type="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(data=1)
