"""CPU tests of the benchmark (and, marked ``gpu``, its checks on the card).

Whether a card is present is decided inside the ``cuda`` fixture, never
while a module is imported. Run with ``python -m pytest gpubench/tests``;
on the card the ``gpu`` tests run too.
"""

import json
import pathlib
import shutil
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device (skips where torch sees none)")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch sees none")
    return torch.device("cuda")


def _lists(d):
    import dataclasses

    return {k: list(v) if isinstance(v, tuple) else v for k, v in dataclasses.asdict(d).items()}


def tiny_config(sd15: bool = False) -> dict:
    """A CPU-sized configuration of the port's tiny test models, served on
    its plain-PyTorch float32 binding."""
    from stabletriton_tpu_torch.runtime.pipeline import tiny_configs, tiny_sd15_configs
    from stabletriton_tpu_torch.runtime.scheduler import SchedulerConfig

    if sd15:
        u, c1, v = tiny_sd15_configs()
        c2 = None
    else:
        u, c1, c2, v = tiny_configs()

    def enc(c):
        # ids of the stub tokenizer reach 699
        return dict(_lists(c), vocab_size=1000, bos_token_id=998, eos_token_id=999)

    cfg = {"name": "tiny", "source": "test", "reference": "sd", "work": "unet2d",
           "unet": _lists(u), "text_encoder": enc(c1), "vae": _lists(v),
           "scheduler": _lists(SchedulerConfig()), "height": 32, "width": 32, "steps": 3,
           "guidance_scale": 5.0, "solver": "euler", "binding": "reference",
           "dtypes": {"unet": "float32", "text_encoder": "float32", "vae": "float32"},
           "control": {"compile": {"quantize": "int8_conv", "quantize_min_dim": 256}},
           # float32 both sides: the program and the reference agree to ~3e-6
           "check": {"sample": 3, "block": 2,
                     "limits": {"image_rel_rms": 1e-4, "image_max_abs": 1e-4}}}
    if c2 is not None:
        cfg["text_encoder_2"] = dict(enc(c2), pad_token_id=0)
        cfg["dtypes"]["text_encoder_2"] = "float32"
    return cfg


def make_root(dst: pathlib.Path, *, sd15: bool = False, outstanding: int = 2,
              mix: dict | None = None) -> pathlib.Path:
    """A copy of the benchmark in ``dst`` with one more configuration, mix
    (``mix``, or a closed loop of ``outstanding``) and cell ("tiny.tinymix")
    added as files and BENCHMARK.json entries, and
    every metric that names cells extended to it. Returns the copy's
    ``gpubench`` directory."""
    shutil.copytree(REPO / "gpubench", dst / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (dst / "gpubench/configs/tiny.json").write_text(json.dumps(tiny_config(sd15)))
    (dst / "gpubench/traffic/tinymix.json").write_text(json.dumps(
        mix or {"loop": "closed", "outstanding": outstanding, "words": [3, 60], "stretch": 2}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.tinymix", "config": "tiny", "traffic": "tinymix",
                               "chips": 1, "why": "CPU test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append("tiny.tinymix")
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst / "gpubench"


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
