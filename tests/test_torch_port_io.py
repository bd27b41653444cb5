"""The port's host side against the JAX package: the native library, the
tokenizer, safetensors I/O and layout conversion, LoRA, torch-module
ingestion and the diffusers-directory loader; and the import guard.

The same numpy inputs (from seeds) go through both packages. Tolerances:
exact for every id, key, shape, layout and converted or loaded value (both
packages only move and cast the same bits); LoRA's folded weights 1e-6
relative (a float32 product of the factors, summed in another order by
numpy and torch).
"""

import dataclasses
import json
import subprocess
import sys
import zlib
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu import native as jnative
from stabletriton_tpu.compile import CompileConfig as JCompileConfig
from stabletriton_tpu.io import lora as jlora
from stabletriton_tpu.io import pretrained as jpretrained
from stabletriton_tpu.io import safetensors_io as jst
from stabletriton_tpu.io import tokenizer as jtok
from stabletriton_tpu.io import torch_ingest as jingest
from stabletriton_tpu.models import clip as jclip
from stabletriton_tpu.models import unet as junet
from stabletriton_tpu.models import vae as jvae
from stabletriton_tpu_torch import native
from stabletriton_tpu_torch.compile import CompileConfig
from stabletriton_tpu_torch.io import lora as tlora
from stabletriton_tpu_torch.io import pretrained as tpretrained
from stabletriton_tpu_torch.io import safetensors_io as tst
from stabletriton_tpu_torch.io import tokenizer as ttok
from stabletriton_tpu_torch.io import torch_ingest as tingest
from stabletriton_tpu_torch.models import unet as tunet
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parent.parent


def as_np(x) -> np.ndarray:
    """A tensor (any dtype) or JAX / numpy array -> float32 numpy, exact."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def assert_same_dicts(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(as_np(got[k]), as_np(want[k]), err_msg=k)


# --------------------------------------------------------------------------
# the native library
# --------------------------------------------------------------------------


def test_native_builds_from_native_src_into_build():
    """The port's library is built from native/src under build/native/ and
    loaded from there, never from native/."""
    path = native.build()
    assert native.have_native()
    assert path.parent.parent == REPO / "build" / "native"
    assert Path(native.lib()._name) == path
    assert {p.name for p in native.sources()} == {"convert.cpp", "imageio.cpp", "tokenizer.cpp"}
    assert "build/" in (REPO / ".gitignore").read_text().split()


def test_native_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cpp").write_text('extern "C" int st_broken() { return undeclared_name; }\n')
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.build()
    assert not list((tmp_path / "build").glob("*/*.so"))


def test_native_widening_equals_jax_and_plain():
    rng = np.random.default_rng(0)
    vals = rng.standard_normal(1000).astype(np.float32)
    bf16 = (vals.view(np.uint32) >> 16).astype(np.uint16)
    for got in (native.bf16_to_f32(bf16), native.bf16_to_f32_plain(bf16)):
        np.testing.assert_array_equal(got, jnative.bf16_to_f32(bf16))
    specials = np.array([6e-8, -6e-8, np.inf, -np.inf, np.nan, 0.0, -0.0, 65504.0],
                        np.float16)
    for raw in (vals.astype(np.float16).view(np.uint16), specials.view(np.uint16)):
        want = jnative.f16_to_f32(raw)
        for got in (native.f16_to_f32(raw), native.f16_to_f32_plain(raw)):
            assert got.tobytes() == want.tobytes()  # NaN and -0 too


@pytest.mark.parametrize("shape", [(37, 53), (1, 7), (320, 1280)])
def test_native_transpose_2d_equals_jax_and_plain(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    want = jnative.transpose_2d(x)
    for got in (native.transpose_2d(x), native.transpose_2d_plain(x)):
        np.testing.assert_array_equal(got, want)
        assert got.flags.c_contiguous


@pytest.mark.parametrize("shape", [(5, 3, 4, 4), (320, 4, 3, 3), (8, 8, 1, 1)])
def test_native_oihw_to_hwio_equals_jax_and_plain(shape):
    x = np.random.default_rng(2).standard_normal(shape).astype(np.float32)
    want = jnative.oihw_to_hwio(x)
    for got in (native.oihw_to_hwio(x), native.oihw_to_hwio_plain(x)):
        np.testing.assert_array_equal(got, want)


def test_native_transposes_refuse_other_dtypes():
    for fn in (native.transpose_2d, native.oihw_to_hwio):
        with pytest.raises(TypeError, match="float32"):
            fn(np.zeros((2, 2, 2, 2) if fn is native.oihw_to_hwio else (2, 2), np.float16))


def test_native_rgb8_equals_jax_and_plain():
    rng = np.random.default_rng(3)
    img = rng.uniform(-1.2, 1.2, (33, 17, 3)).astype(np.float32)
    # the rounding edges: (x + 1) * 127.5 + 0.5 at whole numbers
    edges = (np.arange(256, dtype=np.float32) / np.float32(127.5) - 1).reshape(-1, 1, 1)
    for x in (img, np.broadcast_to(edges, (256, 2, 3))):
        want = jnative.to_rgb8(x)
        np.testing.assert_array_equal(native.to_rgb8(x), want)
        np.testing.assert_array_equal(native.to_rgb8_plain(x), want)


def _png_pixels(png: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 by Python's zlib alone."""
    pos, payload, w, h = 8, b"", None, None
    while pos < len(png):
        n = int.from_bytes(png[pos:pos + 4], "big")
        typ = png[pos + 4:pos + 8]
        if typ == b"IHDR":
            w, h = (int.from_bytes(png[pos + 8 + i:pos + 12 + i], "big") for i in (0, 4))
        elif typ == b"IDAT":
            payload += png[pos + 8:pos + 8 + n]
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(payload), np.uint8).reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    return rows[:, 1:].reshape(h, w, 3)


def test_native_png_round_trip_equals_jax_and_plain():
    rgb = native.to_rgb8(np.random.default_rng(4).uniform(-1, 1, (13, 17, 3)).astype(np.float32))
    png = native.encode_png(rgb)
    assert png == jnative.encode_png(rgb) == native.encode_png_plain(rgb)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(_png_pixels(png), rgb)
    with pytest.raises(ValueError, match="uint8"):
        native.encode_png(rgb.astype(np.float32))


# --------------------------------------------------------------------------
# the tokenizer
# --------------------------------------------------------------------------


def write_toy_vocab(d: Path) -> dict:
    """The JAX package's toy BPE (tests/test_native.py): printable ASCII
    with and without </w>, a few merges that build "hello"."""
    d.mkdir(parents=True, exist_ok=True)
    vocab, tid = {}, 0
    for b in range(ord(" "), 127):
        vocab[chr(b)] = tid
        vocab[chr(b) + "</w>"] = tid + 1
        tid += 2
    for extra in ["he", "llo", "hello</w>", "lo", "lo</w>", "llo</w>", "he</w>",
                  "<|startoftext|>", "<|endoftext|>"]:
        vocab[extra] = tid
        tid += 1
    merges = ["#version: 0.2", "h e", "l o</w>", "l lo</w>", "he llo</w>"]
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("\n".join(merges))
    return vocab


@pytest.fixture(scope="module")
def toy_tok(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    vocab = write_toy_vocab(d)
    return d / "vocab.json", d / "merges.txt", vocab


TEXTS = ["hello", "Hello, World!  123", "it's a test's", "", "   ", "héllo naïve", "a" * 300,
         "hello hello he llo", "x y z w v u t s"]


@pytest.mark.parametrize("max_len", [5, 16, 77])
def test_tokenizer_native_and_plain_equal_jax(toy_tok, max_len):
    vp, mp, vocab = toy_tok
    tok, py = ttok.CLIPTokenizer(vp, mp), ttok.PyCLIPTokenizer(vp, mp)
    jpy, jnat = jtok.PyCLIPTokenizer(vp, mp), jtok.CLIPTokenizer(vp, mp)
    bos, eos = vocab["<|startoftext|>"], vocab["<|endoftext|>"]
    for text in TEXTS:
        want = jpy.encode(text, max_len=max_len, bos=bos, eos=eos, pad=0)
        np.testing.assert_array_equal(jnat.encode(text, max_len=max_len, bos=bos, eos=eos,
                                                  pad=0), want)
        for t in (tok, py):
            got = t.encode(text, max_len=max_len, bos=bos, eos=eos, pad=0)
            assert got.dtype == np.int32 and got.shape == (max_len,)
            np.testing.assert_array_equal(got, want, err_msg=repr(text))
    assert list(tok.encode("Hello  hello", max_len=8, bos=bos, eos=eos, pad=0)) == [
        bos, vocab["hello</w>"], vocab["hello</w>"], eos, 0, 0, 0, 0]


def test_tokenizer_windows_and_sdxl_framing_equal_jax(toy_tok):
    vp, mp, _ = toy_tok
    tok, jnat = ttok.CLIPTokenizer(vp, mp), jtok.CLIPTokenizer(vp, mp)
    long = " ".join(["hello"] * 80 + ["a b c"])
    for text, kw in [("a b c d e f g h i j", dict(max_len=8, pad=0)),
                     ("a b", dict(windows=3, max_len=8, pad=0)), (long, {}),
                     (long, dict(windows=2))]:
        got = tok.encode_windows(text, **kw)
        np.testing.assert_array_equal(got, jnat.encode_windows(text, **kw))
        assert got.shape[0] % kw.get("max_len", 77) == 0
    assert tok.encode_windows(long).shape == (154,)  # 81 words -> 2 windows of 75
    prompts = ["hello world", "a photo of a cat, 4k", ""]
    for got, want in zip(ttok.sdxl_tokenize(tok, tok, prompts),
                         jtok.sdxl_tokenize(jnat, jnat, prompts)):
        assert got.shape == (3, 77) and got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_tokenizer_refuses_unreadable_vocab(tmp_path, toy_tok):
    (tmp_path / "vocab.json").write_text("not json")
    with pytest.raises(ValueError):
        ttok.CLIPTokenizer(tmp_path / "vocab.json", toy_tok[1])


# --------------------------------------------------------------------------
# safetensors I/O and layout
# --------------------------------------------------------------------------


def _tensors(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a.weight": torch.randn((4, 6), generator=g),
        "b.bias": torch.arange(5, dtype=torch.float16),
        "c.weight": torch.randn((2, 3, 3, 3), generator=g).to(torch.bfloat16),
        "d.weight": torch.randn((7, 5), generator=g).to(torch.float16),
        "e.scale": torch.randn((3,), generator=g).to(torch.bfloat16),
        "f.index": torch.arange(6, dtype=torch.int64).reshape(2, 3),
    }


@pytest.mark.parametrize("writer", ["port", "safetensors.torch"])
def test_safetensors_read_equals_jax(tmp_path, writer):
    """F32, F16 and BF16 files read back bit for bit, in their own dtype,
    equal to JAX's reader (which widens BF16 to float32)."""
    tensors = _tensors()
    path = tmp_path / "x.safetensors"
    if writer == "port":
        tst.write_safetensors(path, tensors, metadata={"format": "pt"})
    else:
        st_torch = pytest.importorskip("safetensors.torch")
        st_torch.save_file(tensors, str(path))
    got, want = tst.read_safetensors(path), jst.read_safetensors(path)
    assert sorted(got) == sorted(want) == sorted(tensors)
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
        np.testing.assert_array_equal(as_np(got[k]), np.asarray(want[k], np.float32), err_msg=k)
    got["a.weight"][0, 0] = 99.0  # copy-on-write: the file is unchanged
    assert tst.read_safetensors(path)["a.weight"][0, 0] == tensors["a.weight"][0, 0]


def test_port_writer_is_read_by_safetensors(tmp_path):
    st_torch = pytest.importorskip("safetensors.torch")
    tensors = _tensors(1)
    tst.write_safetensors(tmp_path / "x.safetensors", tensors)
    back = st_torch.load_file(str(tmp_path / "x.safetensors"))
    for k, t in tensors.items():
        assert torch.equal(back[k], t), k


@pytest.mark.parametrize("name,shape", [
    ("x.weight", (3, 4)), ("x.weight", (2, 5, 3, 3)), ("x.bias", (3, 4)),
    ("text_model.embeddings.token_embedding.weight", (5, 2)),
    ("text_model.embeddings.position_embedding.weight", (7, 3)), ("n.weight", (6,)),
])
def test_layout_rules_equal_jax(name, shape):
    x = np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape)
    got = tst.to_framework_layout(name, torch.from_numpy(x))
    want = jst.to_framework_layout(name, x)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_convert_state_dict_equals_jax():
    rng = np.random.default_rng(5)
    sd = {
        "vae.decoder.mid_block.attentions.0.query.weight": rng.standard_normal((4, 4)),
        "vae.decoder.mid_block.attentions.0.proj_attn.bias": rng.standard_normal(4),
        "vae.decoder.conv_in.weight": rng.standard_normal((8, 4, 3, 3)),
        "other.linear.weight": rng.standard_normal((3, 5)),
    }
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    for dtype, jdtype in [(None, None), (torch.float16, np.float16)]:
        got = tst.convert_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                                     strip_prefix="vae.", dtype=dtype)
        want = jst.convert_state_dict(sd, strip_prefix="vae.", dtype=jdtype)
        assert "decoder.mid_block.attentions.0.to_q.weight" in got
        assert all(v.dtype == (dtype or torch.float32) for v in got.values())
        assert_same_dicts(got, want)


def test_validate_against_shapes_errors_equal_jax():
    cases = [({}, {"a.weight": (2, 2)}),
             ({"a.weight": np.zeros((2, 2)), "b": np.zeros(1)}, {"a.weight": (2, 2)}),
             ({"a.weight": np.zeros((3, 3))}, {"a.weight": (2, 2)})]
    for params, expected in cases:
        with pytest.raises(ValueError) as j:
            jst.validate_against_shapes(params, expected)
        with pytest.raises(ValueError) as t:
            tst.validate_against_shapes({k: torch.from_numpy(v) for k, v in params.items()},
                                        expected)
        assert str(t.value) == str(j.value)
    tst.validate_against_shapes({"a.weight": torch.zeros(2, 2)}, {"a.weight": (2, 2)})


# --------------------------------------------------------------------------
# LoRA
# --------------------------------------------------------------------------


def _lora_base():
    rng = np.random.default_rng(6)
    return {
        "down_blocks.0.attn.to_q.weight": rng.standard_normal((8, 6)).astype(np.float32),
        "down_blocks.0.attn.to_k.weight": rng.standard_normal((8, 6)).astype(np.float32),
        "mid.norm.weight": np.ones(6, np.float32),
    }


def _lora_dialects(rng, r=2):
    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {
        "diffusers": {
            "unet.down_blocks.0.attn.to_q.lora_A.weight": f(r, 8),
            "unet.down_blocks.0.attn.to_q.lora_B.weight": f(6, r),
            "down_blocks.0.attn.to_k.lora_A.weight": f(r, 8),
            "down_blocks.0.attn.to_k.lora_B.weight": f(6, r),
            "unet.mid.norm.lora_A.weight": f(r, 6),   # a 1D target: skipped
            "unet.mid.norm.lora_B.weight": f(6, r),
        },
        "kohya": {
            "lora_unet_down_blocks_0_attn_to_q.lora_down.weight": f(4, 8),
            "lora_unet_down_blocks_0_attn_to_q.lora_up.weight": f(6, 4),
            "lora_unet_down_blocks_0_attn_to_q.alpha": np.float32(2.0),
            "lora_unet_down_blocks_0_attn_to_k.lora_down.weight": f(4, 8),  # no alpha: r
            "lora_unet_down_blocks_0_attn_to_k.lora_up.weight": f(6, 4),
            "lora_unet_nonexistent.lora_down.weight": f(4, 8),
        },
    }


@pytest.mark.parametrize("dialect", ["diffusers", "kohya"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lora_equals_jax(dialect, dtype):
    base = _lora_base()
    lora = _lora_dialects(np.random.default_rng(7))[dialect]
    tbase = {k: torch.from_numpy(v).to(dtype) for k, v in base.items()}
    jbase = {k: np.asarray(as_np(v)) for k, v in tbase.items()}
    want = jlora.apply_lora(jbase, lora, scale=0.7)
    got = tlora.apply_lora(tbase, {k: torch.as_tensor(v) for k, v in lora.items()}, scale=0.7)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == dtype
        tol = 1e-6 if dtype == torch.float32 else 2 ** -7  # one bf16 rounding apart at most
        np.testing.assert_allclose(as_np(got[k]), np.asarray(want[k], np.float32), rtol=tol,
                                   atol=tol, err_msg=k)
    assert not torch.equal(got["down_blocks.0.attn.to_q.weight"],
                           tbase["down_blocks.0.attn.to_q.weight"])
    assert torch.equal(tbase["down_blocks.0.attn.to_q.weight"],
                       torch.from_numpy(base["down_blocks.0.attn.to_q.weight"]).to(dtype))
    pairs = tlora.extract_lora_pairs(lora, tbase)
    assert sorted(p["target"] for p in pairs) == sorted(
        p["target"] for p in jlora.extract_lora_pairs(lora, jbase))


def test_lora_errors_equal_jax():
    base = _lora_base()
    tbase = {k: torch.from_numpy(v) for k, v in base.items()}
    no_match = {"lora_unet_nonexistent.lora_down.weight": np.zeros((2, 8), np.float32)}
    bad_shape = {"down_blocks.0.attn.to_q.lora_A.weight": np.ones((2, 5), np.float32),
                 "down_blocks.0.attn.to_q.lora_B.weight": np.ones((6, 2), np.float32)}
    for lora, match in [(no_match, "no LoRA"), (bad_shape, "LoRA delta")]:
        with pytest.raises(ValueError, match=match) as j:
            jlora.apply_lora(base, lora)
        with pytest.raises(ValueError, match=match) as t:
            tlora.apply_lora(tbase, lora)
        assert str(t.value) == str(j.value)


# --------------------------------------------------------------------------
# torch-module ingestion
# --------------------------------------------------------------------------


DIFFUSERS_CONFIGS = {
    # the relevant subsets of the published unet/config.json files
    "sdxl-base": {"block_out_channels": [320, 640, 1280],
                  "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D",
                                       "CrossAttnDownBlock2D"],
                  "transformer_layers_per_block": [1, 2, 10], "attention_head_dim": [5, 10, 20],
                  "cross_attention_dim": 2048, "addition_embed_type": "text_time",
                  "addition_time_embed_dim": 256,
                  "projection_class_embeddings_input_dim": 2816},
    "sd15": {"block_out_channels": [320, 640, 1280, 1280],
             "down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
             "attention_head_dim": 8, "cross_attention_dim": 768, "addition_embed_type": None},
    "sd21": {"block_out_channels": [320, 640, 1280, 1280],
             "down_block_types": ["CrossAttnDownBlock2D"] * 3 + ["DownBlock2D"],
             "attention_head_dim": [5, 10, 20, 20], "cross_attention_dim": 1024,
             "use_linear_projection": True, "addition_embed_type": None},
}


@pytest.mark.parametrize("name", sorted(DIFFUSERS_CONFIGS))
def test_unet_config_from_diffusers_equals_jax(name):
    raw = {"in_channels": 4, "out_channels": 4, "layers_per_block": 2,
           **DIFFUSERS_CONFIGS[name]}
    got = tingest.unet_config_from_diffusers(raw)
    assert dataclasses.asdict(got) == dataclasses.asdict(jingest.unet_config_from_diffusers(raw))
    assert dataclasses.asdict(got) == dataclasses.asdict(
        tingest.unet_config_from_diffusers(type("Cfg", (), raw)))  # attributes too
    if name == "sd21":
        shapes = tunet.unet_param_shapes(got)
        assert [got.num_heads(c) for c in got.block_out_channels] == [5, 10, 20, 20]
        assert sum(int(np.prod(s)) for s in shapes.values()) == 865_910_724


class FakeModule:
    def __init__(self, sd):
        self._sd = sd

    def state_dict(self):
        return self._sd


def test_state_dict_to_params_equals_jax():
    rng = np.random.default_rng(8)
    sd = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in [
        ("conv_in.weight", (8, 4, 3, 3)), ("conv_in.bias", (8,)),
        ("time_embedding.linear_1.weight", (16, 8)),
        ("down.attn1.to_q.weight", (8, 8)), ("norm.weight", (8,))]}
    for dtype, jdtype in [(None, None), (torch.float16, np.float16)]:
        got = tingest.state_dict_to_params(FakeModule(sd), dtype=dtype)
        assert_same_dicts(got, jingest.state_dict_to_params(FakeModule(sd), dtype=jdtype))


# --------------------------------------------------------------------------
# the diffusers-directory loader
# --------------------------------------------------------------------------


def torch_layout(name: str, shape: tuple) -> tuple:
    """This package's shape -> torch's, for writing checkpoints."""
    if (name.endswith(".weight") and len(shape) == 2
            and "embedding" not in name.rsplit(".", 2)[-2]):
        return (shape[1], shape[0])
    if len(shape) == 4:
        return (shape[3], shape[2], shape[0], shape[1])
    return shape


def torch_layout_state(shapes: dict, seed: int, dtype=torch.float16) -> dict:
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal(torch_layout(k, s)).astype(np.float32)
                                ).to(dtype) for k, s in sorted(shapes.items())}


TINY_UNET_JSON = {
    "in_channels": 4, "out_channels": 4, "block_out_channels": [32, 64],
    "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D"], "layers_per_block": 1,
    "transformer_layers_per_block": [1, 1], "attention_head_dim": [2, 4],
    "cross_attention_dim": 32, "norm_num_groups": 8, "addition_embed_type": "text_time",
    "addition_time_embed_dim": 8, "projection_class_embeddings_input_dim": 64,
}


def write_diffusers_dir(root: Path) -> dict:
    """A synthetic SDXL diffusers directory at tiny widths: the UNet in two
    shards with its config.json, both encoders, the whole VAE (encoder
    too), f16, and tokenizer files. Returns the torch-layout tensors."""
    ucfg = jingest.unet_config_from_diffusers(TINY_UNET_JSON)
    clip = jclip.CLIPTextConfig(vocab_size=300, hidden_size=16, num_layers=2, num_heads=2,
                                intermediate_size=32, projection_dim=8)
    vcfg = jvae.VAEConfig(block_out_channels=(8, 16), norm_num_groups=4, layers_per_block=1)
    comps = {
        "unet": torch_layout_state(junet.unet_param_shapes(ucfg), 10),
        "text_encoder": torch_layout_state(jclip.clip_param_shapes(clip), 11),
        "text_encoder_2": torch_layout_state(jclip.clip_param_shapes(clip), 12),
        "vae": torch_layout_state({**jvae.vae_decoder_param_shapes(vcfg),
                                   **jvae.vae_encoder_param_shapes(vcfg)}, 13),
    }
    for comp, sd in comps.items():
        (root / comp).mkdir(parents=True)
        keys = sorted(sd)
        if comp == "unet":
            for i, part in enumerate((keys[::2], keys[1::2])):
                tst.write_safetensors(root / comp / f"model-0000{i + 1}-of-00002.safetensors",
                                      {k: sd[k] for k in part})
            (root / comp / "config.json").write_text(json.dumps(TINY_UNET_JSON))
        else:
            tst.write_safetensors(root / comp / "model.safetensors", sd)
    for sub in ("tokenizer", "tokenizer_2"):
        write_toy_vocab(root / sub)
    return comps


@pytest.mark.parametrize("compile", ["reference_f32", "default_bf16"])
def test_load_sdxl_equals_jax(tmp_path, compile, monkeypatch):
    """The same param dicts (fused and cast by each pipeline as its binding
    says), UNetConfig, decoder-only VAE and tokenizer ids from both
    loaders."""
    monkeypatch.setenv("ST_TPU_COMPILE_CACHE", "0")
    write_diffusers_dir(tmp_path)
    cc, jcc = {"reference_f32": (CompileConfig(backend="reference", dtype="float32"),
                                 JCompileConfig(backend="reference", dtype="float32")),
               "default_bf16": (CompileConfig(), JCompileConfig())}[compile]
    pipe, tok1, tok2 = tpretrained.load_sdxl(tmp_path, compile_config=cc, device="cpu")
    jpipe, jtok1, jtok2 = jpretrained.load_sdxl(tmp_path, compile_config=jcc)
    assert dataclasses.asdict(pipe.unet_config) == dataclasses.asdict(jpipe.unet_config)
    assert pipe.device == torch.device("cpu")
    for group in ("unet", "text_encoder", "text_encoder_2", "vae"):
        assert_same_dicts(pipe.params[group], jpipe.params[group])
    assert pipe.params["unet"]["conv_in.weight"].dtype == cc.torch_dtype
    assert pipe.params["vae"]["decoder.conv_in.weight"].dtype == torch.float32
    assert not any(k.startswith("encoder.") for k in pipe.params["vae"])
    for t, j in [(tok1, jtok1), (tok2, jtok2)]:
        np.testing.assert_array_equal(t.encode("hello world"), j.encode("hello world"))


def test_load_component_validates(tmp_path):
    write_diffusers_dir(tmp_path)
    ucfg = tpretrained.unet_config_from_json(tmp_path / "unet" / "config.json")
    shapes = tunet.unet_param_shapes(ucfg)
    params = tpretrained.load_component(tmp_path / "unet", expected=shapes)
    assert len(params) == len(shapes)
    with pytest.raises(ValueError, match="missing"):
        tpretrained.load_component(tmp_path / "unet", expected={**shapes, "extra.weight": (1,)})
    with pytest.raises(FileNotFoundError):
        tpretrained.load_component(tmp_path / "tokenizer")


# --------------------------------------------------------------------------
# the import guard
# --------------------------------------------------------------------------


GUARD = """
import importlib, pkgutil, sys
sys.modules["jax"] = None               # any import of them raises ImportError
sys.modules["stabletriton_tpu"] = None
sys.path.insert(0, {repo!r})
import stabletriton_tpu_torch
names = [m.name for m in pkgutil.walk_packages(stabletriton_tpu_torch.__path__,
                                               "stabletriton_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m, mod in sys.modules.items() if mod is not None and (
    m in ("jax", "stabletriton_tpu") or m.startswith(("jax.", "jaxlib", "stabletriton_tpu."))))
assert not bad, bad
print(" ".join(names))
"""


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke.py, imports with jax and the
    JAX package blocked."""
    out = subprocess.run([sys.executable, "-c", GUARD.format(repo=str(REPO))],
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode == 0, out.stderr
    names = set(out.stdout.split())
    for mod in ("native", "io.safetensors_io", "io.tokenizer", "io.torch_ingest",
                "io.single_file", "io.pretrained", "io.lora", "frontends.diffusers",
                "frontends.sgm", "frontends.comfyui", "kernels.flash_attention",
                "runtime.pipeline", "runtime.profiling", "kernels.autotune",
                "kernels.fft_conv", "runtime.mesh"):
        assert f"stabletriton_tpu_torch.{mod}" in names
