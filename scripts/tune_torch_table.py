#!/usr/bin/env python3
"""Make the PyTorch/CUDA port's packaged autotune table on the card it runs on.

    python3 scripts/tune_torch_table.py [OUT_DIR] [--gn]

Tunes, from an empty table (no packaged file, a fresh user cache), every
kernel shape of these signatures (batch 1, the UNet at batch 2 and 1: CFG,
and the cond-only rows of no CFG or a guidance interval), under the
default, fused-op and all-kernel bindings (``kernels/autotune.py``
``ensure_tuned_for``):

  * SDXL-base at 1024^2;
  * SD1.5 at 512^2;
  * SD2.x at 768^2.

Writes the entries that name a plan off the fitted rule (those that beat
the rule by more than two timings of the rule differ) as
``<OUT_DIR>/<platform tag>.json`` (default: the package's
``kernels/tuned/``); a shape whose rule was kept has no packaged entry, so
its route takes the rule. Prints the card's name and power limit, each
tuned shape's times against its fitted rule's, and each signature's wall
time. Needs one CUDA card.

``--gn`` measures only the GroupNorm-prologue convs (K8, the ``:gn`` keys)
of the three signatures, from an empty table, and writes the packaged
table with its ``:gn`` entries replaced by those measured off the rule,
every other entry as it was.
"""

from __future__ import annotations

import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SIGNATURES = (("SDXL-base 1024^2", "sdxl_base_unet_config", 1024),
              ("SD1.5 512^2", "sd15_unet_config", 512),
              ("SD2.x 768^2", "sd21_unet_config", 768))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("tune_torch_table: torch sees no CUDA card", file=sys.stderr)
        return 1
    from stabletriton_tpu_torch.compile import (ALL_KERNEL_OVERRIDES, FUSED_OP_OVERRIDES,
                                                CompileConfig, resolve_binding)
    from stabletriton_tpu_torch.kernels import autotune
    from stabletriton_tpu_torch.models import unet

    args = [a for a in sys.argv[1:] if a != "--gn"]
    gn_only = "--gn" in sys.argv[1:]
    out_dir = pathlib.Path(args[0]) if args else autotune.PACKAGED_DIR
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    tag = autotune.platform_tag()
    packaged = autotune.packaged_path(tag)
    others = ({k: e for k, e in json.loads(packaged.read_text()).items()
               if not k.endswith(":gn")} if gn_only and packaged.exists() else {})
    print(f"{card}; platform tag {tag}", flush=True)
    bindings = {"default": CompileConfig(), "fused-op": CompileConfig(overrides=FUSED_OP_OVERRIDES),
                "all-kernel": CompileConfig(overrides=ALL_KERNEL_OVERRIDES)}
    with tempfile.TemporaryDirectory() as tmp:
        autotune.PACKAGED_DIR = pathlib.Path(tmp) / "empty"
        os.environ["ST_TPU_AUTOTUNE_CACHE"] = str(pathlib.Path(tmp) / f"{tag}.json")
        autotune.reload()
        total = time.perf_counter()
        for label, make, size in SIGNATURES:
            cfg = getattr(unet, make)()
            for name, config in bindings.items():
                if gn_only and name != "fused-op":
                    continue
                t0 = time.perf_counter()
                tuned = (autotune.ensure_conv_tuned(cfg, size // 8, size // 8, 1, torch.bfloat16,
                                                    (1, 2), gn=True) if gn_only else
                         autotune.ensure_tuned_for(resolve_binding(config), cfg, size // 8,
                                                   size // 8, 1, torch.bfloat16, (1, 2)))
                for t in tuned:
                    rule_us = [t.times_us[t.rule]] + ([t.retimed_us[t.rule]] if t.retimed_us
                                                      else [])
                    best = t.entry["t_us"]
                    kept = "the rule kept" if autotune.keeps_rule(t.entry) else "tuned"
                    print(f"  {t.key}: rule {t.rule} {'/'.join(f'{u:.2f}' for u in rule_us)} "
                          f"us, {kept} { {k: v for k, v in t.entry.items() if k != 't_us'} } "
                          f"{best:.2f} us ({best / min(rule_us) - 1:+.1%}); fastest other "
                          f"{ {str(p): round(u, 2) for p, u in t.retimed_us.items()} }",
                          flush=True)
                print(f"{label}, {name} binding: {len(tuned)} shapes tuned in "
                      f"{time.perf_counter() - t0:.1f} s", flush=True)
        measured = json.loads(pathlib.Path(os.environ["ST_TPU_AUTOTUNE_CACHE"]).read_text())
    table = {**others, **{k: e for k, e in measured.items() if not autotune.keeps_rule(e)}}
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / f"{tag}.json"
    out.write_text(json.dumps(table, indent=1, sort_keys=True) + "\n")
    print(f"{len(measured)} shapes measured, {len(table)} off the rule, in "
          f"{time.perf_counter() - total:.1f} s -> {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
