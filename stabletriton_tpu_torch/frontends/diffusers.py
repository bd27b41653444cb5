"""The diffusers drop-in: ``pipe.unet = compile(pipe.unet)``.

Counterpart of ``stabletriton_tpu/frontends/diffusers.py``, the JAX package's
public ``model = compile(model)``: the torch module's config and weights are
ingested once (``io.torch_ingest``, on the card where the module lies there)
and every later forward runs the port's graphed UNet step
(``compile.compile_unet``, or ``compile_unet_deepcache`` under DeepCache) on
the card: the first call of a signature runs eagerly and captures it, later
calls replay it. Nothing leaves the device between the caller's tensors and
the step. It speaks diffusers' calling convention: an NCHW ``sample``, a
scalar, 1-element or per-row ``timestep``, ``encoder_hidden_states``,
``added_cond_kwargs={"text_embeds", "time_ids"}`` or SGM's pre-projected
``{"y"}``, ``return_dict``, and ``.config`` / ``.dtype`` / ``.device``.

The graphed step copies its inputs into its static buffers, so the caller's
sample is never overwritten (the JAX package's ``donate_sample`` has no
counterpart). For whole-loop throughput the pipeline (``runtime/pipeline.py``)
replays the whole denoise loop as one graph instead of one a step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from stabletriton_tpu_torch.compile import (
    CompileConfig,
    cast_params,
    compile_unet,
    compile_unet_deepcache,
    fuse_attention_projections,
)
from stabletriton_tpu_torch.io.torch_ingest import (
    state_dict_to_params,
    unet_config_from_diffusers,
)


def _device(device) -> torch.device:
    """``device`` as a torch.device; the card raises where torch sees none
    (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CompiledUNet runs on the CUDA device and torch sees none; "
                           "pass device='cpu' to run on the CPU")
    return device


@dataclass
class _Output:
    """Duck-types diffusers' UNet2DConditionOutput."""

    sample: Any

    def __getitem__(self, i):
        return (self.sample,)[i]


class CompiledUNet:
    """A drop-in for a diffusers UNet whose forward runs the port's graphed
    step on ``device`` (the card unless the caller names another)."""

    def __init__(self, torch_unet, compile_config: CompileConfig | None = None,
                 deep_cache: int | None = None, device="cuda"):
        params = state_dict_to_params(torch_unet, device=_device(device))
        self._setup(unet_config_from_diffusers(torch_unet.config), params, compile_config,
                    deep_cache, device, config=torch_unet.config)

    @classmethod
    def from_params(cls, unet_config, params: dict, compile_config: CompileConfig | None = None,
                    deep_cache: int | None = None, device="cuda"):
        """The drop-in from a param dict already in this package's keys and
        layout (``io.single_file``, or ``convert_sgm_unet`` +
        ``convert_state_dict``) in place of a diffusers module: the SGM /
        A1111 splice's entry (``frontends/sgm.py``)."""
        self = cls.__new__(cls)
        self._setup(unet_config, params, compile_config, deep_cache, device, config=None)
        return self

    def _setup(self, unet_config, params, compile_config, deep_cache, device, config):
        self.config = config  # a diffusers pipeline reads it (None from SGM)
        self.unet_config = unet_config
        self.compile_config = compile_config or CompileConfig()
        self._device = _device(device)
        params = {k: v.to(self._device) for k, v in params.items()}
        if self.compile_config.backend != "reference":
            params = fuse_attention_projections(params)
        # cast once, and read in place by every graph from here on
        self.params = cast_params(params, self.compile_config)
        self._fn = compile_unet(unet_config, self.compile_config)
        # DeepCache (Ma et al. 2023) where the caller owns the step loop: the
        # deep-feature cache is host-side state here (draft semantics,
        # outside the exactness gate, as the pipeline's knob)
        self.deep_cache = None if deep_cache is None else int(deep_cache)
        if self.deep_cache is not None and self.deep_cache < 1:
            raise ValueError(f"deep_cache interval must be >= 1: {deep_cache}")
        if self.deep_cache is not None:
            self._dc_full, self._dc_shallow = compile_unet_deepcache(unet_config,
                                                                     self.compile_config)
        # (step index, last timestep, a cache per call slot, next call slot):
        # one scheduler step may take several UNet calls (ComfyUI can run
        # cond and uncond as separate calls at one timestep), so the step
        # index advances when the timestep changes and each call position
        # within a step keeps its own cache
        self._dc_state = None

    def reset_deep_cache(self):
        """Forget the carried cache. Done by itself when the timestep jumps
        back up (schedules descend) or the batch changes; call it when a
        generation is abandoned mid-loop and the next one's first timestep is
        not above the abandoned one's last."""
        self._dc_state = None

    def _deep_cache_call(self, t_now: float, s, t, ehs, te, ti):
        st = self._dc_state
        if st is not None and (t_now > st[1] or st[2][0].shape[0] != s.shape[0]):
            st = None  # a new generation
        if st is None:
            step_idx, caches, call_pos = 0, [], 0
        else:
            step_idx, _, caches, call_pos = st
            if t_now != st[1]:
                step_idx, call_pos = step_idx + 1, 0
        if step_idx % self.deep_cache == 0 or call_pos >= len(caches):
            out, cache = self._dc_full(self.params, s, t, ehs, te, ti)
            if call_pos < len(caches):
                caches[call_pos] = cache
            else:
                caches.append(cache)
        else:
            out = self._dc_shallow(self.params, s, t, ehs, te, ti, caches[call_pos])
        self._dc_state = (step_idx, t_now, caches, call_pos + 1)
        return out

    @property
    def dtype(self) -> torch.dtype:
        """The dtype the UNet computes in (the compile dtype)."""
        return self.compile_config.torch_dtype

    @property
    def device(self) -> torch.device:
        return self._device

    def _timesteps(self, timestep, b: int) -> tuple[torch.Tensor, float]:
        """(B,) float32 timesteps on the device, and the first as a host
        number (DeepCache's step counter; read from the host where the
        caller passed a number or a CPU tensor)."""
        if not isinstance(timestep, torch.Tensor):
            first = float(timestep)
            return torch.full((b,), first, dtype=torch.float32, device=self._device), first
        t = timestep.detach().reshape(-1)
        first = float(t[0]) if self.deep_cache is not None else 0.0
        t = t.to(self._device, torch.float32)
        return (t.expand(b) if t.shape[0] == 1 else t), first

    def __call__(self, sample, timestep, encoder_hidden_states, *,
                 added_cond_kwargs: dict | None = None, return_dict: bool = True, **_: Any):
        dev, dtype = self._device, self.compile_config.torch_dtype
        b = sample.shape[0]
        s = sample.detach().to(dev).permute(0, 2, 3, 1)  # NCHW -> NHWC
        t, t_first = self._timesteps(timestep, b)
        ehs = encoder_hidden_states.detach().to(dev, dtype)
        acs = added_cond_kwargs or {}
        if "y" in acs and "text_embeds" not in acs:
            # SGM / ComfyUI: y = concat(pooled, fourier(time_ids)), already
            # the add embedding's input
            te = acs["y"].detach().to(dev, dtype)
            ti = torch.zeros((b, 0), dtype=torch.float32, device=dev)
        elif "text_embeds" in acs:
            te = acs["text_embeds"].detach().to(dev, dtype)
            ti = acs["time_ids"].detach().to(dev, torch.float32)
        else:  # SD1.x / 2.x: no added conditioning
            te = torch.zeros((b, 0), dtype=dtype, device=dev)
            ti = torch.zeros((b, 0), dtype=torch.float32, device=dev)
        if self.deep_cache is None:
            out = self._fn(self.params, s, t, ehs, te, ti)
        else:
            out = self._deep_cache_call(t_first, s, t, ehs, te, ti)
        out = out.float().permute(0, 3, 1, 2).to(sample.dtype).contiguous()
        return _Output(sample=out) if return_dict else (out,)


def compile(torch_unet, compile_config: CompileConfig | None = None,
            deep_cache: int | None = None, device="cuda") -> CompiledUNet:
    """``model = compile(model)``: a diffusers UNet -> its drop-in on the
    port. ``deep_cache=N`` (draft knob, DeepCache): the full UNet every N-th
    step and only the outermost level, around the carried deep features, in
    between; a generation's start is told by the timestep jumping back up
    (or call ``reset_deep_cache()``)."""
    return CompiledUNet(torch_unet, compile_config, deep_cache=deep_cache, device=device)
