"""LoRA: low-rank deltas folded into a param dict before a pipeline is built.

Counterpart of ``stabletriton_tpu/io/lora.py``. A pipeline fuses the q/k/v
projections when it is built, and its graphs read every parameter at its
captured address, so LoRA is applied to the unfused dicts, before
``SDXLPipeline(...)``: :func:`apply_lora` returns a new dict, and the step
runs unchanged with no adapter products. No live pipeline is patched.

Tensor-name dialects:
  * diffusers / PEFT: ``{module}.lora_A.weight`` / ``{module}.lora_B.weight``
  * kohya / A1111:    ``lora_unet_{module_with_underscores}.lora_down.weight``
                      / ``.lora_up.weight`` / ``.alpha``
"""

from __future__ import annotations

import torch


def _module_key_index(params: dict) -> dict[str, str]:
    """Underscored module path -> the real key prefix (kohya's names)."""
    idx = {}
    for k in params:
        if k.endswith(".weight"):
            mod = k[: -len(".weight")]
            idx[mod.replace(".", "_")] = mod
    return idx


def extract_lora_pairs(lora_sd: dict, params: dict) -> list[dict]:
    """A LoRA state_dict (tensors or arrays) -> [{target, down, up, alpha}]
    for every module of ``params`` that has both factors."""
    pairs: dict[str, dict] = {}

    def slot(target):
        return pairs.setdefault(target, {"target": target, "alpha": None})

    underscore_idx = _module_key_index(params)
    for name, arr in lora_sd.items():
        t = torch.as_tensor(arr)
        if ".lora_A." in name or ".lora_B." in name:  # diffusers / PEFT
            which = "down" if ".lora_A." in name else "up"
            target = name.split(".lora_A.")[0].split(".lora_B.")[0]
            for pre in ("unet.", "text_encoder.", "text_encoder_2."):
                if target.startswith(pre):
                    target = target[len(pre):]
            slot(target + ".weight")[which] = t
        elif name.startswith(("lora_unet_", "lora_te")):  # kohya
            mangled, _, tail = name.partition(".")
            for pre in ("lora_unet_", "lora_te1_", "lora_te2_", "lora_te_"):
                if mangled.startswith(pre):
                    mangled = mangled[len(pre):]
            target_mod = underscore_idx.get(mangled)
            if target_mod is None:
                continue  # an adapter of a module this model does not have
            s = slot(target_mod + ".weight")
            if tail.startswith("lora_down"):
                s["down"] = t
            elif tail.startswith("lora_up"):
                s["up"] = t
            elif tail == "alpha":
                s["alpha"] = float(t)
    return [p for p in pairs.values() if "down" in p and "up" in p]


def apply_lora(params: dict, lora_sd: dict, *, scale: float = 1.0) -> dict:
    """A new param dict with the LoRA deltas folded in; ``params`` is not
    changed. The params are in this package's layout (a linear (in, out)),
    the LoRA factors in torch's: down (r, in), up (out, r), so the delta is
    (up @ down)^T (in, out) x scale x alpha / r, summed in float32 and cast
    back to each weight's dtype, on its device. Raises ValueError where no
    factor pair matches a 2D weight, or a delta's shape differs from its
    weight's."""
    out = dict(params)
    n_applied = 0
    for pair in extract_lora_pairs(lora_sd, params):
        key = pair["target"]
        w = out.get(key)
        if w is None or w.dim() != 2:
            continue
        down = pair["down"].to(device=w.device, dtype=torch.float32)
        up = pair["up"].to(device=w.device, dtype=torch.float32)
        r = down.shape[0]
        alpha = pair["alpha"] if pair["alpha"] is not None else float(r)
        delta = (up @ down).t() * (scale * alpha / r)
        if delta.shape != w.shape:
            raise ValueError(f"{key}: LoRA delta {tuple(delta.shape)} vs base {tuple(w.shape)}")
        out[key] = (w.float() + delta).to(w.dtype)
        n_applied += 1
    if n_applied == 0:
        raise ValueError("no LoRA tensors matched this model's parameters")
    return out
