"""Pipelines from checkpoints: a diffusers directory, or one SGM / A1111
file of the SDXL, SD2.x or SD1.x family.

Counterpart of ``stabletriton_tpu/io/pretrained.py``. The diffusers layout
(what ``StableDiffusionXLPipeline.save_pretrained`` writes):

    root/
      unet/diffusion_pytorch_model.safetensors        (+ config.json)
      vae/diffusion_pytorch_model.safetensors
      text_encoder/model.safetensors
      text_encoder_2/model.safetensors
      tokenizer/{vocab.json, merges.txt}
      tokenizer_2/{vocab.json, merges.txt}

A component in several shards (model-00001-of-0000N.safetensors) is their
union. Each tensor is read from the mapped file in its own dtype, moved to
the device, put in this package's layout there and cast once: the UNet to
the compile dtype, the text encoders and the VAE to float32. As in the JAX
package, only the VAE's decoder is kept (so a loaded pipeline has no VAE
encoder for ``img2img_image`` / ``inpaint``), and the text encoder and VAE
configs are SDXL's (or the family's) full-size ones whatever the files hold.
Every entry point builds its pipeline on the card unless ``device`` names
another.
"""

from __future__ import annotations

import json
from pathlib import Path

import torch

from stabletriton_tpu_torch.compile import CompileConfig
from stabletriton_tpu_torch.io.safetensors_io import (
    convert_state_dict,
    read_safetensors,
    validate_against_shapes,
)
from stabletriton_tpu_torch.io.single_file import detect_family, load_single_file
from stabletriton_tpu_torch.io.tokenizer import CLIPTokenizer
from stabletriton_tpu_torch.io.torch_ingest import unet_config_from_diffusers
from stabletriton_tpu_torch.models import clip as clip_mod
from stabletriton_tpu_torch.models import vae as vae_mod
from stabletriton_tpu_torch.models.unet import (
    UNetConfig,
    sd15_unet_config,
    sd21_unet_config,
    unet_param_shapes,
)
from stabletriton_tpu_torch.runtime.pipeline import SDXLPipeline
from stabletriton_tpu_torch.runtime.scheduler import SchedulerConfig


def _read_component(comp_dir: Path) -> dict[str, torch.Tensor]:
    files = sorted(comp_dir.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors under {comp_dir}")
    sd: dict[str, torch.Tensor] = {}
    for f in files:
        sd.update(read_safetensors(f))
    return sd


def load_component(comp_dir: str | Path, *, dtype: torch.dtype | None = None,
                   expected: dict | None = None, device="cpu") -> dict[str, torch.Tensor]:
    """One diffusers component directory -> its param dict on ``device`` in
    ``dtype`` (None: the file's), checked against ``expected`` (a shape
    table) where given."""
    params = convert_state_dict(_read_component(Path(comp_dir)), dtype=dtype, device=device)
    if expected is not None:
        validate_against_shapes(params, expected)
    return params


def unet_config_from_json(config_path: str | Path) -> UNetConfig:
    return unet_config_from_diffusers(json.loads(Path(config_path).read_text()))


def _tokenizers(tdir: Path) -> tuple[CLIPTokenizer, CLIPTokenizer]:
    return tuple(CLIPTokenizer(tdir / sub / "vocab.json", tdir / sub / "merges.txt")
                 for sub in ("tokenizer", "tokenizer_2"))


def _cast(params: dict, dtype: torch.dtype) -> dict:
    return {k: v.to(dtype) for k, v in params.items()}


def _sdxl_pipeline(ucfg, params, cc, device):
    return SDXLPipeline(
        unet_config=ucfg, clip_config=clip_mod.sdxl_text_encoder_config(),
        clip2_config=clip_mod.sdxl_text_encoder_2_config(),
        vae_config=vae_mod.sdxl_vae_config(), params=params, compile_config=cc,
        device=device)


def load_sdxl(root: str | Path, *, compile_config: CompileConfig | None = None,
              validate: bool = True, device="cuda"):
    """A diffusers SDXL directory -> (SDXLPipeline, tokenizer, tokenizer_2).
    The UNet's config comes from ``unet/config.json`` (SDXL-base's where
    there is none) and its params are checked against its shape table
    (``validate``)."""
    root = Path(root)
    ucfg_path = root / "unet" / "config.json"
    ucfg = unet_config_from_json(ucfg_path) if ucfg_path.exists() else UNetConfig()
    cc = compile_config or CompileConfig()
    f32 = torch.float32
    decoder_keys = set(vae_mod.vae_decoder_param_shapes(vae_mod.sdxl_vae_config()))
    params = {
        "unet": load_component(root / "unet", dtype=cc.torch_dtype, device=device,
                               expected=unet_param_shapes(ucfg) if validate else None),
        "text_encoder": load_component(root / "text_encoder", dtype=f32, device=device),
        "text_encoder_2": load_component(root / "text_encoder_2", dtype=f32, device=device),
        # the decoder's tensors alone: txt2img never encodes
        "vae": {k: v for k, v in load_component(root / "vae", dtype=f32, device=device).items()
                if k in decoder_keys},
    }
    return (_sdxl_pipeline(ucfg, params, cc, device), *_tokenizers(root))


def load_sdxl_single_file(checkpoint: str | Path, *, compile_config: CompileConfig | None = None,
                          tokenizer_dir: str | Path | None = None, validate: bool = True,
                          device="cuda"):
    """One SGM / A1111 SDXL-base .safetensors -> (SDXLPipeline, tok1, tok2).
    A single file holds no vocabularies: the tokenizers come from
    ``tokenizer_dir``'s tokenizer/ and tokenizer_2/ where given, else are
    None."""
    ucfg = UNetConfig()
    cc = compile_config or CompileConfig()
    raw = load_single_file(checkpoint, unet_config=ucfg, device=device)
    if validate:
        validate_against_shapes(raw["unet"], unet_param_shapes(ucfg))
    params = {"unet": _cast(raw["unet"], cc.torch_dtype),
              **{k: _cast(raw[k], torch.float32)
                 for k in ("text_encoder", "text_encoder_2", "vae")}}
    pipe = _sdxl_pipeline(ucfg, params, cc, device)
    if tokenizer_dir is None:
        return pipe, None, None
    return (pipe, *_tokenizers(Path(tokenizer_dir)))


def load_single_file_auto(checkpoint: str | Path, *,
                          compile_config: CompileConfig | None = None,
                          prediction_type: str = "epsilon",
                          validate: bool = True, device="cuda"):
    """A single file of any family -> (SDXLPipeline, family), the family
    ("sdxl", "sd2" or "sd1") told by its tensor names. SD2.x pipelines
    condition on OpenCLIP-H's penultimate layer (``clip_skip=2``), SD1.x's
    on CLIP-L's last; both decode with the SD1.x VAE. A file does not say
    whether its UNet predicts eps or v (SD2.x 768-v checkpoints:
    "v_prediction"): ``prediction_type`` says it, and the pipeline's
    SchedulerConfig takes it."""
    scheduler_config = SchedulerConfig(prediction_type=prediction_type)
    family = detect_family(read_safetensors(checkpoint))
    if family == "sdxl":
        pipe, _, _ = load_sdxl_single_file(checkpoint, compile_config=compile_config,
                                           validate=validate, device=device)
        pipe.scheduler_config = scheduler_config
        return pipe, family
    ucfg = sd15_unet_config() if family == "sd1" else sd21_unet_config()
    c1 = (clip_mod.sd15_text_encoder_config() if family == "sd1"
          else clip_mod.sd2_text_encoder_config())
    cc = compile_config or CompileConfig()
    raw = load_single_file(checkpoint, unet_config=ucfg, device=device)
    if validate:
        validate_against_shapes(raw["unet"], unet_param_shapes(ucfg))
    # SD1.x's encoder is HF-named CLIP-L; SD2.x's is OpenCLIP-H
    te = raw["text_encoder"] if family == "sd1" else raw["text_encoder_2"]
    params = {"unet": _cast(raw["unet"], cc.torch_dtype),
              "text_encoder": _cast(te, torch.float32),
              "vae": _cast(raw["vae"], torch.float32)}
    pipe = SDXLPipeline(unet_config=ucfg, clip_config=c1, clip2_config=c1,
                        vae_config=vae_mod.sd15_vae_config(), params=params, compile_config=cc,
                        scheduler_config=scheduler_config,
                        clip_skip=2 if family == "sd2" else 1, device=device)
    return pipe, family
