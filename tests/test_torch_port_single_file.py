"""Single-file (SGM / A1111) checkpoints in the port against the JAX package:
synthetic tiny files of the SDXL, SD1.x and SD2.x families, written with
the port's writer in float16, through both packages' ``load_single_file``,
``detect_family`` and ``load_single_file_auto``; the SGM -> diffusers key
tables at the full SDXL, SD1.5 and SD2.1 topologies; OpenCLIP's q/k/v split
and the untransposed ``text_projection``.

Tolerance: exact throughout (keys, families, clip_skip, and every loaded
value: both packages only rename, split, transpose and cast the same bits).
"""

import dataclasses

import numpy as np
import pytest
import torch

from stabletriton_tpu.compile import CompileConfig as JCompileConfig
from stabletriton_tpu.io import pretrained as jpretrained
from stabletriton_tpu.io import single_file as jsf
from stabletriton_tpu.models import clip as jclip
from stabletriton_tpu.models import unet as junet
from stabletriton_tpu.models import vae as jvae
from stabletriton_tpu_torch.compile import CompileConfig
from stabletriton_tpu_torch.io import pretrained as tpretrained
from stabletriton_tpu_torch.io import safetensors_io as tst
from stabletriton_tpu_torch.io import single_file as tsf
from stabletriton_tpu_torch.models import unet as tunet
from test_single_file import _RESNET_INV, _invert_unet_names
from test_torch_port_io import assert_same_dicts, torch_layout
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _randn(rng, shape, dtype=torch.float16):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dtype)


def sgm_unet_names(cfg) -> dict[str, str]:
    """{diffusers key: SGM key} for a UNet config, by inverting the JAX
    package's tables (as tests/test_single_file.py does)."""
    inv = _invert_unet_names(cfg)
    out = {}
    for name in junet.unet_param_shapes(cfg):
        mod, leaf = name.rsplit(".", 1)
        best = max((d for d in inv if mod == d or mod.startswith(d + ".")), key=len)
        rest = mod[len(best):].lstrip(".")
        for dmod, smod in _RESNET_INV.items():
            if rest == dmod or rest.startswith(dmod + "."):
                rest = smod + rest[len(dmod):]
                break
        out[name] = f"{inv[best]}.{rest}.{leaf}" if rest else f"{inv[best]}.{leaf}"
    return out


def sgm_unet_state(cfg, rng) -> dict:
    shapes = junet.unet_param_shapes(cfg)
    return {sgm: _randn(rng, torch_layout(name, shapes[name]))
            for name, sgm in sgm_unet_names(cfg).items()}


def sgm_vae_state(vcfg, rng) -> dict:
    """The SGM decoder (up blocks numbered from the bottom, the mid
    attention's projections as 1x1 convs) and two encoder tensors, which the
    converters drop."""
    out = {}
    levels = len(vcfg.block_out_channels)
    for name, shape in jvae.vae_decoder_param_shapes(vcfg).items():
        t_shape = torch_layout(name, shape)
        if name.startswith("post_quant_conv."):
            out[name] = _randn(rng, t_shape)
            continue
        mod, leaf = name[len("decoder."):].rsplit(".", 1)
        parts = mod.split(".")
        if mod in ("conv_in", "conv_out"):
            sgm = f"decoder.{mod}.{leaf}"
        elif mod == "conv_norm_out":
            sgm = f"decoder.norm_out.{leaf}"
        elif mod.startswith("mid_block.resnets."):
            inner = {"conv_shortcut": "nin_shortcut"}.get(parts[3], parts[3])
            sgm = f"decoder.mid.block_{int(parts[2]) + 1}.{inner}.{leaf}"
        elif mod.startswith("mid_block.attentions.0."):
            inner = mod[len("mid_block.attentions.0."):]
            ren = {"to_q": "q", "to_k": "k", "to_v": "v", "to_out.0": "proj_out",
                   "group_norm": "norm"}[inner]
            if inner.startswith("to_") and leaf == "weight":
                t_shape = (shape[1], shape[0], 1, 1)
            sgm = f"decoder.mid.attn_1.{ren}.{leaf}"
        elif parts[2] == "resnets":
            inner = {"conv_shortcut": "nin_shortcut"}.get(parts[4], parts[4])
            sgm = f"decoder.up.{levels - 1 - int(parts[1])}.block.{parts[3]}.{inner}.{leaf}"
        else:
            sgm = f"decoder.up.{levels - 1 - int(parts[1])}.upsample.conv.{leaf}"
        out[sgm] = _randn(rng, t_shape)
    out["encoder.conv_in.weight"] = _randn(rng, (8, 3, 3, 3))
    out["quant_conv.weight"] = _randn(rng, (8, 8, 1, 1))
    return out


def hf_clip_state(cfg, rng) -> dict:
    shapes = jclip.clip_param_shapes(cfg)
    return {k: _randn(rng, torch_layout(k, s)) for k, s in sorted(shapes.items())}


def openclip_state(cfg, rng) -> dict:
    """An OpenCLIP text tower in its own names: fused in_proj, mlp c_fc /
    c_proj, text_projection (d, proj) as it is stored."""
    d, inter = cfg.hidden_size, cfg.intermediate_size
    out = {"token_embedding.weight": _randn(rng, (cfg.vocab_size, d)),
           "positional_embedding": _randn(rng, (cfg.max_position_embeddings, d)),
           "ln_final.weight": _randn(rng, (d,)), "ln_final.bias": _randn(rng, (d,)),
           "text_projection": _randn(rng, (d, cfg.projection_dim or d + 8))}
    for i in range(cfg.num_layers):
        pre = f"transformer.resblocks.{i}"
        for name, shape in [("ln_1.weight", (d,)), ("ln_1.bias", (d,)), ("ln_2.weight", (d,)),
                            ("ln_2.bias", (d,)), ("attn.in_proj_weight", (3 * d, d)),
                            ("attn.in_proj_bias", (3 * d,)), ("attn.out_proj.weight", (d, d)),
                            ("attn.out_proj.bias", (d,)), ("mlp.c_fc.weight", (inter, d)),
                            ("mlp.c_fc.bias", (inter,)), ("mlp.c_proj.weight", (d, inter)),
                            ("mlp.c_proj.bias", (d,))]:
            out[f"{pre}.{name}"] = _randn(rng, shape)
    return out


def tiny_like(cfg: junet.UNetConfig, widths) -> junet.UNetConfig:
    """A family's UNet topology (levels, block types, depths: the SGM key
    names) at tiny widths."""
    return dataclasses.replace(cfg, block_out_channels=widths, attention_head_dim=8,
                               fixed_num_heads=None, cross_attention_dim=16, norm_num_groups=4,
                               projection_class_embeddings_input_dim=(
                                   None if cfg.projection_class_embeddings_input_dim is None
                                   else 16 + 6 * 8),
                               addition_time_embed_dim=(None if cfg.addition_time_embed_dim
                                                        is None else 8))


TINY_CLIP = jclip.CLIPTextConfig(vocab_size=50, hidden_size=16, num_layers=2, num_heads=2,
                                 intermediate_size=24, max_position_embeddings=8,
                                 projection_dim=12)
TINY_VAE = jvae.VAEConfig(block_out_channels=(8, 16, 32, 32), norm_num_groups=4,
                          layers_per_block=1)
FAMILIES = {
    # widths in the family's ratios: the same conv_shortcut keys
    "sdxl": (junet.sdxl_base_unet_config(), (8, 16, 32)),
    "sd1": (junet.sd15_unet_config(), (8, 16, 32, 32)),
    "sd2": (junet.sd21_unet_config(), (8, 16, 32, 32)),
}


def write_single_file(path, family: str, seed: int = 0):
    """A synthetic SGM single file of ``family`` at tiny widths (the
    family's key names), float16; returns its tiny UNet config and the
    torch-layout tensors written."""
    rng = np.random.default_rng(seed)
    ucfg = tiny_like(*FAMILIES[family])
    sd = {f"model.diffusion_model.{k}": v for k, v in sgm_unet_state(ucfg, rng).items()}
    sd.update({f"first_stage_model.{k}": v for k, v in sgm_vae_state(TINY_VAE, rng).items()})
    if family == "sdxl":
        sd.update({f"conditioner.embedders.0.transformer.{k}": v
                   for k, v in hf_clip_state(TINY_CLIP, rng).items()})
        sd.update({f"conditioner.embedders.1.model.{k}": v
                   for k, v in openclip_state(TINY_CLIP, rng).items()})
    elif family == "sd1":
        sd.update({f"cond_stage_model.transformer.{k}": v
                   for k, v in hf_clip_state(dataclasses.replace(TINY_CLIP, projection_dim=None),
                                             rng).items()})
    else:
        sd.update({f"cond_stage_model.model.{k}": v
                   for k, v in openclip_state(dataclasses.replace(TINY_CLIP, projection_dim=None),
                                              rng).items()})
    tst.write_safetensors(path, sd)
    return ucfg, sd


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("single")
    return {f: (d / f"{f}.safetensors", *write_single_file(d / f"{f}.safetensors", f, i))
            for i, f in enumerate(FAMILIES)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
@pytest.mark.parametrize("dtype", [None, torch.float32])
def test_load_single_file_groups_equal_jax(files, family, dtype):
    path, ucfg, _ = files[family]
    got = tsf.load_single_file(path, unet_config=tunet.UNetConfig(**dataclasses.asdict(ucfg)),
                               dtype=dtype)
    want = jsf.load_single_file(path, unet_config=ucfg,
                                dtype=None if dtype is None else np.float32)
    assert sorted(got) == sorted(want) == ["text_encoder", "text_encoder_2", "unet", "vae"]
    for group in want:
        assert_same_dicts(got[group], want[group])
    assert sorted(got["unet"]) == sorted(junet.unet_param_shapes(ucfg))
    assert set(got["vae"]) == set(jvae.vae_decoder_param_shapes(TINY_VAE))
    if dtype is None:
        assert got["unet"]["conv_in.weight"].dtype == torch.float16


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_detect_family_equals_jax(files, family):
    path, _, sd = files[family]
    names = list(tst.read_safetensors(path))
    assert tsf.detect_family(names) == jsf.detect_family(names) == family
    assert sorted(names) == sorted(sd)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_openclip_split_and_pretransposed_bits(files, family):
    """q/k/v are the fused in_proj's rows in order, and text_projection is
    the stored (d, proj) tensor, not its transpose: bit for bit."""
    path, _, sd = files[family]
    prefix = {"sdxl": "conditioner.embedders.1.model.", "sd2": "cond_stage_model.model.",
              "sd1": None}[family]
    got = tsf.load_single_file(
        path, unet_config=tunet.UNetConfig(**dataclasses.asdict(files[family][1])))
    if prefix is None:
        assert got["text_encoder_2"] == {}
        return
    te = got["text_encoder_2"]
    d = TINY_CLIP.hidden_size
    for i in range(TINY_CLIP.num_layers):
        w = sd[f"{prefix}transformer.resblocks.{i}.attn.in_proj_weight"]
        b = sd[f"{prefix}transformer.resblocks.{i}.attn.in_proj_bias"]
        for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
            pre = f"text_model.encoder.layers.{i}.self_attn.{proj}"
            # this package's (in, out) layout: the rows of in_proj, transposed
            assert torch.equal(te[f"{pre}.weight"], w[j * d:(j + 1) * d].t())
            assert torch.equal(te[f"{pre}.bias"], b[j * d:(j + 1) * d])
    proj = sd[f"{prefix}text_projection"]
    assert proj.shape[0] != proj.shape[1]
    assert torch.equal(te["text_projection.weight"], proj)
    assert "text_projection.weight@pretransposed" not in te


@pytest.mark.parametrize("name", ["sdxl_base", "sdxl_refiner", "sd15", "sd21"])
def test_sgm_key_tables_at_full_topology(name):
    """The SGM names of every parameter of the full-size topologies map to
    exactly the UNet's keys, in both packages (keys only: no tensor of the
    full size is made)."""
    jcfg = getattr(junet, f"{name}_unet_config")()
    names = sgm_unet_names(jcfg)
    placeholder = torch.zeros(1)
    sgm = {v: placeholder for v in names.values()}
    got = tsf.convert_sgm_unet(sgm, tunet.UNetConfig(**dataclasses.asdict(jcfg)))
    want = jsf.convert_sgm_unet(sgm, jcfg)
    assert sorted(got) == sorted(want) == sorted(junet.unet_param_shapes(jcfg))
    assert tsf._unet_block_tables(jcfg) == jsf._unet_block_tables(jcfg)


def test_vae_and_openclip_converters_equal_jax():
    rng = np.random.default_rng(3)
    vae = sgm_vae_state(TINY_VAE, rng)
    clip = openclip_state(TINY_CLIP, rng)
    for tfn, jfn, sd in [(tsf.convert_sgm_vae_decoder, jsf.convert_sgm_vae_decoder, vae),
                         (tsf.convert_openclip_text, jsf.convert_openclip_text, clip)]:
        got = tfn(sd)
        want = jfn({k: v.float().numpy() for k, v in sd.items()})
        assert_same_dicts(got, want)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_load_single_file_auto_equals_jax(files, family, monkeypatch):
    """The family, clip_skip (2 for SD2.x) and every param dict of the
    pipeline both packages build; the full-size configs take the tiny
    files' keys, so the shape checks are off (``validate=False``)."""
    monkeypatch.setenv("ST_TPU_COMPILE_CACHE", "0")
    path = files[family][0]
    pipe, fam = tpretrained.load_single_file_auto(
        path, compile_config=CompileConfig(backend="reference", dtype="float32"),
        validate=False, device="cpu")
    jpipe, jfam = jpretrained.load_single_file_auto(
        path, compile_config=JCompileConfig(backend="reference", dtype="float32"),
        validate=False)
    assert fam == jfam == family
    assert pipe.clip_skip == jpipe.clip_skip == (2 if family == "sd2" else 1)
    assert dataclasses.asdict(pipe.unet_config) == dataclasses.asdict(jpipe.unet_config)
    assert dataclasses.asdict(pipe.clip_config) == dataclasses.asdict(jpipe.clip_config)
    assert dataclasses.asdict(pipe.vae_config) == dataclasses.asdict(jpipe.vae_config)
    assert sorted(pipe.params) == sorted(jpipe.params)
    for group in jpipe.params:
        assert_same_dicts(pipe.params[group], jpipe.params[group])
        assert all(v.dtype == torch.float32 for v in pipe.params[group].values())
    if family == "sd2":
        assert pipe.clip_config.hidden_size == 1024 and pipe.clip_config.num_layers == 24


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_load_single_file_auto_takes_the_prediction_type(files, family):
    """A file does not say whether its UNet predicts eps or v: the caller's
    ``prediction_type`` reaches the pipeline's SchedulerConfig (epsilon by
    default), and an unknown one raises before the file is read."""
    path = files[family][0]
    kw = dict(compile_config=CompileConfig(backend="reference", dtype="float32"),
              validate=False, device="cpu")
    pipe, _ = tpretrained.load_single_file_auto(path, **kw)
    assert pipe.scheduler_config.prediction_type == "epsilon"
    pipe, _ = tpretrained.load_single_file_auto(path, prediction_type="v_prediction", **kw)
    assert pipe.scheduler_config.prediction_type == "v_prediction"
    with pytest.raises(ValueError, match="prediction_type"):
        tpretrained.load_single_file_auto(path / "missing", prediction_type="x0", **kw)


def test_load_single_file_auto_validates(files):
    with pytest.raises(ValueError, match="shape"):
        tpretrained.load_single_file_auto(files["sd2"][0], device="cpu")
