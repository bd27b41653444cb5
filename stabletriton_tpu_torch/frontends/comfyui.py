"""ComfyUI custom nodes over the port.

Counterpart of ``stabletriton_tpu/frontends/comfyui.py``:

  * ``StableTritonCompile`` wraps a ComfyUI MODEL's diffusion_model as the
    diffusers frontend wraps ``pipe.unet``: the config and weights are
    ingested once and the UNet forward runs the port's graphed step
    (ComfyUI calls it in the CompVis convention, ``frontends/sgm.py``'s
    shim).
  * ``StableTritonTxt2Img`` runs the port's whole-loop txt2img (CLIP, the
    replayed denoise loop, the VAE) on token ids, in place of ComfyUI's
    sampler.

The classes import nothing of ComfyUI (it finds nodes through
``NODE_CLASS_MAPPINGS``); :func:`register` is what a custom_nodes package's
``__init__`` calls.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from stabletriton_tpu_torch.compile import CompileConfig
from stabletriton_tpu_torch.frontends.diffusers import CompiledUNet
# ComfyUI's UNet convention (x, timesteps, context, y) is CompVis / SGM's
# (comfy.model_base.SDXL.encode_adm builds the same 2816-wide adm y)
from stabletriton_tpu_torch.frontends.sgm import CompVisUNetShim as _ComfyUNetShim

CATEGORY = "stabletriton_tpu_torch"


class StableTritonCompile:
    """ComfyUI node: MODEL in -> MODEL out, its UNet on the port."""

    CATEGORY = CATEGORY
    RETURN_TYPES = ("MODEL",)
    FUNCTION = "compile"

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "model": ("MODEL",),
                "backend": (["cuda", "reference"], {"default": "cuda"}),
                "dtype": (["bfloat16", "float32"], {"default": "bfloat16"}),
                # DeepCache interval, 0 = off (draft knob, see
                # frontends/diffusers.compile)
                "deep_cache": ("INT", {"default": 0, "min": 0, "max": 10}),
            }
        }

    def compile(self, model: Any, backend: str = "cuda", dtype: str = "bfloat16",
                deep_cache: int = 0):
        cfg = CompileConfig(backend=backend, dtype=dtype)
        # a ComfyUI MODEL holds the torch UNet at model.model.diffusion_model
        compiled = CompiledUNet(model.model.diffusion_model, cfg, deep_cache=deep_cache or None)
        patched = model.clone() if hasattr(model, "clone") else model
        patched.model.diffusion_model = _ComfyUNetShim(compiled)
        return (patched,)


class StableTritonTxt2Img:
    """ComfyUI node: the port's whole-loop txt2img -> an IMAGE."""

    CATEGORY = CATEGORY
    RETURN_TYPES = ("IMAGE",)
    FUNCTION = "generate"

    @classmethod
    def INPUT_TYPES(cls):
        return {
            "required": {
                "pipeline": ("STABLETRITON_PIPELINE",),
                "ids1": ("TOKENS",),
                "ids2": ("TOKENS",),
                "width": ("INT", {"default": 1024, "min": 256, "max": 2048, "step": 64}),
                "height": ("INT", {"default": 1024, "min": 256, "max": 2048, "step": 64}),
                "steps": ("INT", {"default": 30, "min": 1, "max": 200}),
                "cfg": ("FLOAT", {"default": 5.0, "min": 0.0, "max": 30.0}),
                "seed": ("INT", {"default": 0}),
                "solver": (["euler", "heun", "dpmpp_2m"], {"default": "euler"}),
            },
            "optional": {
                # draft knobs (SDXLPipeline.txt2img): DeepCache interval (0 =
                # off) and depth; CFG only inside a sigma window (both 0 = off)
                "deep_cache": ("INT", {"default": 0, "min": 0, "max": 10}),
                # the depth must stay under the UNet's level count (3 for
                # SDXL; models/unet.deep_cache_shape checks the real count)
                "deep_cache_depth": ("INT", {"default": 1, "min": 1, "max": 2}),
                "gi_sigma_lo": ("FLOAT", {"default": 0.0, "min": 0.0}),
                "gi_sigma_hi": ("FLOAT", {"default": 0.0, "min": 0.0}),
            },
        }

    def generate(self, pipeline, ids1, ids2, width, height, steps, cfg, seed, solver,
                 deep_cache=0, deep_cache_depth=1, gi_sigma_lo=0.0, gi_sigma_hi=0.0):
        img = pipeline.txt2img(
            np.asarray(ids1, np.int32), np.asarray(ids2, np.int32),
            height=height, width=width, steps=steps, guidance_scale=cfg, seed=seed,
            solver=solver,
            deep_cache=(deep_cache, deep_cache_depth) if deep_cache else None,
            guidance_interval=(gi_sigma_lo, gi_sigma_hi) if gi_sigma_hi > 0 else None,
        )
        # ComfyUI's IMAGE: float32 in [0, 1], (B, H, W, C), on the host
        return (((img.float() + 1.0) * 0.5).cpu(),)


NODE_CLASS_MAPPINGS = {
    "StableTritonCompile": StableTritonCompile,
    "StableTritonTxt2Img": StableTritonTxt2Img,
}

NODE_DISPLAY_NAME_MAPPINGS = {
    "StableTritonCompile": "Compile UNet (CUDA)",
    "StableTritonTxt2Img": "txt2img (CUDA, whole loop replayed)",
}


def register():
    """The entry a ComfyUI custom_nodes package's __init__ calls."""
    return NODE_CLASS_MAPPINGS, NODE_DISPLAY_NAME_MAPPINGS
