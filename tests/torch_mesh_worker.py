"""One rank of ``tests/test_torch_port_mesh.py``'s four-rank gloo run.

Imports torch and the port only (no JAX): the test computes the JAX
package's results in its own process and hands them in as numpy arrays.
Each rank writes what it computed to ``<out>/rank<r>.pt``; the test holds
the results against JAX's and each other.
"""

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from stabletriton_tpu_torch.compile import CompileConfig, quantize_linear_weights
from stabletriton_tpu_torch.io.convert import params_from_numpy
from stabletriton_tpu_torch.models import unet as tunet
from stabletriton_tpu_torch.runtime import mesh as tmesh
from stabletriton_tpu_torch.runtime import pipeline as tpipe
from stabletriton_tpu_torch.runtime.serving import Request, ServingEngine

SIZE = 32


class Tok:
    """A stand-in tokenizer: one id per character, between BOS and EOS."""

    def encode_batch(self, texts, *, max_len=16, pad=99, **kw):
        out = np.full((len(texts), max_len), pad, np.int32)
        for i, t in enumerate(texts):
            ids = [98] + [(ord(c) % 90) + 5 for c in t[: max_len - 2]] + [99]
            out[i, : len(ids)] = ids
        return out


def _specs(mesh, tables: dict) -> dict:
    return {name: {k: tmesh.param_sharding(k, shape, mesh) for k, shape in table.items()}
            for name, table in tables.items()}


def _unet(inputs: dict, mesh) -> np.ndarray:
    """The tiny UNet's forward on this rank's shards and batch rows, then
    gathered."""
    cfg = tunet.tiny_unet_config()
    params = tmesh.shard_params(params_from_numpy({"unet": inputs["params"]["unet"]})["unet"],
                                mesh)
    rows = tmesh.batch_slice(inputs["sample"].shape[0], mesh)
    args = [torch.from_numpy(inputs[k])[rows] for k in ("sample", "t", "ehs", "te", "ti")]
    with torch.inference_mode(), tmesh.use_mesh(mesh):
        out = tunet.unet_apply(cfg, params, *args)
    return tmesh.gather_batch(out, mesh).numpy()


def _int8_layout(inputs: dict, mesh) -> dict:
    """Each int8 pair of the quantized tiny UNet after sharding: whether its
    weight is output-channel-major and compact, its shape, and whether it
    dequantizes to this rank's slice of the whole weight."""
    full = quantize_linear_weights(params_from_numpy({"unet": inputs["params"]["unet"]})["unet"],
                                   min_dim=16)
    out = {}
    for k, v in tmesh.shard_params(full, mesh).items():
        if not isinstance(v, tuple):
            continue
        wq, scale = v
        dim = tmesh.param_sharding(k, tuple(full[k][0].shape), mesh)
        deq = full[k][0].float() * full[k][1]
        if dim is not None:
            sl = tmesh._rank_slice(deq.shape[dim], mesh, tmesh.MODEL_AXIS)
            deq = deq[:, sl] if dim == 1 else deq[sl]
        out[k] = {"dim": dim, "shape": tuple(wq.shape), "full": tuple(full[k][0].shape),
                  "out_major": wq.movedim(-1, 0).is_contiguous(),
                  "equal": bool(torch.equal(wq.float() * scale, deq))}
    return out


def run(rank: int, world: int, store: str, inputs: dict, out_dir: str) -> None:
    # the suite runs other files in parallel, some timing host work: the
    # ranks take the cores those leave idle rather than preempt them
    os.nice(10)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        res = {}
        mesh = tmesh.make_mesh(data=2, model=2, device_type="cpu")
        mesh4 = tmesh.make_mesh(data=1, model=4, device_type="cpu")
        dp = tmesh.make_mesh(data=4, model=1, device_type="cpu")
        res["coords"] = (mesh.get_local_rank("data"), mesh.get_local_rank("model"))
        res["specs"] = {2: _specs(mesh, inputs["tables"]), 4: _specs(mesh4, inputs["tables"])}
        res["unet"] = _unet(inputs, mesh)
        res["int8"] = _int8_layout(inputs, mesh)

        noise = {s: torch.from_numpy(a) for s, a in inputs["noise"].items()}
        real_noise = tpipe.initial_noise
        tpipe.initial_noise = lambda seeds, shape, device: torch.stack([noise[s] for s in seeds])
        params = params_from_numpy(inputs["params"])
        pipe = tpipe.make_tiny_pipeline(CompileConfig(backend="cuda", dtype="float32"),
                                        params=params, mesh=mesh)
        res["unfused"] = sorted(k for k in pipe.params["unet"]
                                if ".to_qkv." in k or ".to_kv." in k)
        res["local_q"] = tuple(pipe.params["unet"][
            "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q.weight"].shape)
        ids = inputs["ids"]
        res["txt2img"] = pipe.txt2img(ids, ids, height=SIZE, width=SIZE, steps=2,
                                      seed=0).numpy()
        try:
            tpipe.make_tiny_pipeline(params=params, mesh=mesh).txt2img(
                ids[:3], ids[:3], height=SIZE, width=SIZE, steps=2)
        except ValueError as e:
            res["odd_batch"] = str(e)
        tpipe.initial_noise = real_noise

        # data parallel alone: image i of the batch equals the request alone
        alone = tpipe.make_tiny_pipeline(CompileConfig(backend="cuda", dtype="float32"),
                                         params=params)
        dpp = tpipe.make_tiny_pipeline(CompileConfig(backend="cuda", dtype="float32"),
                                       params=params, mesh=dp)
        batch = dpp.txt2img(ids, ids, height=SIZE, width=SIZE, steps=2, seed=7)
        mine = alone.txt2img(ids[rank:rank + 1], ids[rank:rank + 1], height=SIZE, width=SIZE,
                             steps=2, seed=7 + rank)
        res["dp_equal"] = bool(torch.equal(batch[rank], mine[0]))

        # serving over the (2, 2) mesh: buckets, the cap, rank 0 leading
        try:
            ServingEngine(pipe, Tok(), Tok(), max_batch=1)
        except ValueError as e:
            res["cap_error"] = str(e)
        engine = ServingEngine(pipe, Tok(), Tok(), max_wait_s=1.0)
        res["buckets"] = engine._buckets
        served = None
        if engine.leader:
            kw = dict(height=SIZE, width=SIZE, steps=2)
            futs = [engine.submit(Request(prompt=p, seed=s, **kw))
                    for p, s in (("a red fox", 3), ("a blue bird", 4), ("a cat", 5))]
            served = np.stack([f.result(timeout=300) for f in futs])
            # a group rank 0's check refuses before anything is broadcast;
            # one that passes the check (rank 0's stood down) and raises on
            # every rank; then a good one, which needs every rank to follow
            bad = engine.submit(Request(prompt="x", height=SIZE + 1, width=SIZE, steps=2))
            res["refused"] = str(bad.exception(timeout=300))
            pipe.check_txt2img = lambda **_: None
            bad = engine.submit(Request(prompt="x", solver="nope", **kw))
            res["failed"] = str(bad.exception(timeout=300))
            del pipe.check_txt2img
            res["after"] = engine.submit(Request(prompt="a red fox", seed=3, **kw)).result(
                timeout=300)
        else:
            try:
                engine.submit(Request(prompt="x"))
            except RuntimeError as e:
                res["follower_submit"] = str(e)
        engine.close()
        tok = Tok()
        prompts = ["a red fox", "a blue bird", "a cat", ""]
        direct = pipe.txt2img(tok.encode_batch(prompts), tok.encode_batch(prompts),
                              neg_ids1=tok.encode_batch([""] * 4),
                              neg_ids2=tok.encode_batch([""] * 4), height=SIZE,
                              width=SIZE, steps=2, seed=[3, 4, 5, 0]).numpy()
        res["served"], res["direct"] = served, direct[:3]
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def card_rank(rank: int, world: int, init: str, out_path: str) -> None:
    """One rank of ``tests/test_torch_port_gpu.py``'s mesh test: two ranks
    on the one card over gloo. (a) The SDXL-base UNet step at full width,
    bf16, eager, default binding, on this rank's shards of a data=1 model=2
    mesh (rank 0 also runs the unsharded step on the same inputs); (b) a
    1024^2 4-step txt2img of batch 2 on a data=2 model=1 mesh, captured then
    replayed (rank 0 also runs the unsharded pipeline's batch 2). Writes its
    record to ``out_path % rank`` as JSON."""
    import json

    from gpubench.tokenizer import StubTokenizer
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import fuse_attention_projections, resolve_binding
    from stabletriton_tpu_torch.models import clip as tclip
    from stabletriton_tpu_torch.models import vae as tvae

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=600))
    try:
        rec = {"rank": rank}
        ucfg = tunet.sdxl_base_unet_config()
        params = tunet.init_unet_params(ucfg, 0, device=dev, dtype=torch.bfloat16)
        gen = torch.Generator(device=dev).manual_seed(7)
        sample = torch.randn((2, 128, 128, 4), generator=gen, device=dev).to(torch.bfloat16)
        ctx = torch.randn((2, 77, 2048), generator=gen, device=dev).to(torch.bfloat16)
        pooled = torch.randn((2, 1280), generator=gen, device=dev).to(torch.bfloat16)
        time_ids = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2, device=dev)
        t = torch.full((2,), 500.0, device=dev)
        binding = resolve_binding(CompileConfig())

        def step(p):
            with torch.inference_mode(), ops.use_backends(binding):
                kv = tunet.precompute_cross_kv(ucfg, p, ctx)
                return tunet.unet_apply(ucfg, p, sample, t, None, pooled, time_ids, cross_kv=kv)

        tp = tmesh.make_mesh(data=1, model=2, device_type="cuda")
        local = tmesh.shard_params(params, tp)
        rec["local_to_q"] = list(local[
            "down_blocks.1.attentions.0.transformer_blocks.0.attn1.to_q.weight"].shape)
        with tmesh.use_mesh(tp):
            out = step(local)
        if rank == 0:
            d = out.float() - step(fuse_attention_projections(params)).float()
            rec["tp_mse"] = d.pow(2).mean().item()
            rec["tp_finite"] = bool(torch.isfinite(out).all())
        del local, out
        torch.cuda.empty_cache()
        dist.barrier()

        c1, c2 = tclip.sdxl_text_encoder_config(), tclip.sdxl_text_encoder_2_config()
        vcfg = tvae.sdxl_vae_config()
        other = {"text_encoder": tclip.init_clip_params(c1, 1, device=dev),
                 "text_encoder_2": tclip.init_clip_params(c2, 2, device=dev),
                 "vae": tvae.init_vae_params(vcfg, 3, device=dev)}
        tok = StubTokenizer(c1.bos_token_id, c1.eos_token_id)
        prompts = ["a lighthouse at dusk", "a bowl of ramen"]
        ids1 = tok.encode_batch(prompts, max_len=c1.max_position_embeddings)
        ids2 = tok.encode_batch(prompts, max_len=c2.max_position_embeddings, pad=0)

        def request(mesh):
            pipe = tpipe.SDXLPipeline(unet_config=ucfg, clip_config=c1, clip2_config=c2,
                                      vae_config=vcfg, params={"unet": params, **other},
                                      compile_config=CompileConfig(), device=dev, mesh=mesh)
            img = pipe.txt2img(ids1, ids2, height=1024, width=1024, steps=4, seed=41)
            if mesh is not None:
                img = pipe.txt2img(ids1, ids2, height=1024, width=1024, steps=4, seed=41)
                rec["dp_graphs"] = sum(len(p.loop.captured) for p in pipe._cache.values())
            torch.cuda.synchronize()
            return img

        images = request(tmesh.make_mesh(data=2, model=1, device_type="cuda"))
        rec["dp_shape"] = list(images.shape)
        rec["dp_ok"] = bool(torch.isfinite(images).all() and images.abs().max() <= 1.0)
        if rank == 0:
            rec["dp_max_abs"] = (images.float() - request(None).float()).abs().max().item()
        with open(out_path % rank, "w") as f:
            json.dump(rec, f)
    finally:
        dist.destroy_process_group()
