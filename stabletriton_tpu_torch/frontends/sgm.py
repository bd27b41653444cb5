"""The SGM / A1111 splice: the port's UNet step inside a CompVis-style
sampler loop.

Counterpart of ``stabletriton_tpu/frontends/sgm.py``, for both stacks that
call the UNet as ``unet(x, timesteps, context=..., y=...)``: Stability's
``sgm`` (``SamplingPipeline`` / ``DiffusionEngine``) and AUTOMATIC1111's
webui, whose ldm / sgm backends call the inner UNet the same way.

  * :func:`splice` finds the torch UNet inside an sgm ``SamplingPipeline``
    (``.model`` is the DiffusionEngine), a ``DiffusionEngine`` (``.model`` is
    the OpenAIWrapper holding ``.diffusion_model``) or an A1111 ``sd_model``,
    ingests its SGM-keyed weights once and replaces it, in place, with a
    :class:`CompVisUNetShim`; the sampler, the conditioner and the VAE keep
    running in torch.
  * :func:`compile_sgm_unet` is the one-module form: SGM keys -> HF keys
    (``io.single_file.convert_sgm_unet``) -> this package's layout -> the
    graphed step, behind the shim.

The shim takes SGM's ``y`` as it is: the adm vector concat(pooled text,
fourier(time ids)), 2816 wide for SDXL-base (6 time-id slots) and 2560 for
the refiner (pooled 1280 + 5 slots), which ``unet_apply`` takes in place of
its own add-embedding input when ``time_ids`` has width 0.
"""

from __future__ import annotations

from typing import Any

from stabletriton_tpu_torch.compile import CompileConfig
from stabletriton_tpu_torch.frontends.diffusers import CompiledUNet
from stabletriton_tpu_torch.io.safetensors_io import convert_state_dict
from stabletriton_tpu_torch.io.single_file import convert_sgm_unet
from stabletriton_tpu_torch.models.unet import UNetConfig


class CompVisUNetShim:
    """The CompVis / SGM calling convention ``(x, timesteps, context, y)``
    (NCHW torch tensors) over a :class:`CompiledUNet`; ComfyUI inherited the
    same convention, and its frontend uses this shim too."""

    def __init__(self, compiled):
        self.compiled = compiled
        self.dtype = compiled.dtype

    def __call__(self, x, timesteps=None, context=None, y=None, **kwargs):
        added = kwargs.get("added_cond_kwargs")
        if added is None:
            if "text_embeds" in kwargs and "time_ids" in kwargs:
                # diffusers-style kwargs routed through transformer_options
                added = {"text_embeds": kwargs["text_embeds"], "time_ids": kwargs["time_ids"]}
            elif y is not None:
                added = {"y": y}  # SGM: y is the whole add-embedding input
        return self.compiled(x, timesteps, context, added_cond_kwargs=added,
                             return_dict=False)[0]

    # sgm's OpenAIWrapper calls the UNet as a plain callable; some loops (and
    # A1111's hijack layers) probe these nn.Module attributes
    def parameters(self):
        return iter(())

    def eval(self):
        return self

    def to(self, *_, **__):
        return self


def compile_sgm_unet(torch_unet: Any, unet_config=None,
                     compile_config: CompileConfig | None = None,
                     deep_cache: int | None = None, device="cuda") -> CompVisUNetShim:
    """An SGM-keyed torch UNetModel -> its drop-in on the port, in the
    CompVis convention. sgm's UNetModel carries no config object to read,
    so ``unet_config`` defaults to SDXL-base's and the refiner or SD2.x
    pass theirs (``models/unet.py`` has them)."""
    cfg = unet_config or UNetConfig()
    params = convert_state_dict(convert_sgm_unet(torch_unet.state_dict(), cfg), device=device)
    return CompVisUNetShim(CompiledUNet.from_params(cfg, params, compile_config,
                                                    deep_cache=deep_cache, device=device))


def _find_wrapper(pipeline_or_engine: Any):
    """The object holding ``.diffusion_model`` (sgm's OpenAIWrapper), found
    at most three ``.model`` levels down."""
    obj = pipeline_or_engine
    for _ in range(3):
        if hasattr(obj, "diffusion_model"):
            return obj
        obj = getattr(obj, "model", None)
        if obj is None:
            break
    raise ValueError("no .diffusion_model found (expected an sgm SamplingPipeline / "
                     "DiffusionEngine or an A1111 sd_model)")


def splice(pipeline_or_engine: Any, unet_config=None,
           compile_config: CompileConfig | None = None, deep_cache: int | None = None,
           device="cuda"):
    """Replace the UNet inside an sgm / A1111 object with the shim, in
    place, and return the object."""
    wrapper = _find_wrapper(pipeline_or_engine)
    wrapper.diffusion_model = compile_sgm_unet(wrapper.diffusion_model, unet_config,
                                               compile_config, deep_cache=deep_cache,
                                               device=device)
    return pipeline_or_engine
