"""The work counts against a FLOP counter run over the reference."""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench.reference import sd
from gpubench.work import unet2d

from conftest import REPO


def _count(cfg, batch, lat):
    u = cfg["unet"]
    p = {k: torch.empty(s, device="meta") for k, s in sd.unet_shapes(u).items()}
    x = torch.empty((batch, u["in_channels"], lat, lat), device="meta")
    t = torch.empty((batch,), device="meta")
    ctx = torch.empty((batch, 77, u["cross_attention_dim"]), device="meta")
    added = u.get("projection_class_embeddings_input_dim") is not None
    pooled = torch.empty((batch, cfg["text_encoder_2"]["projection_dim"]), device="meta") \
        if added else None
    tids = torch.empty((batch, 6), device="meta") if added else None
    with FlopCounterMode(display=False) as fc:
        sd.unet(u, p, x, t, ctx, pooled, tids)
    return fc.get_total_flops()


@pytest.mark.parametrize("name,lat,expect_tflop", [("sdxl-base-1.0", 128, 13.52),
                                                   ("sd-1.5", 64, 1.607)])
def test_evaluation_flops_match_a_flop_counter(name, lat, expect_tflop):
    cfg = json.loads((REPO / "gpubench/configs" / f"{name}.json").read_text())
    counted = _count(cfg, 2, lat)
    ours = unet2d.evaluation_flops(cfg["unet"], 2, lat, lat)
    assert ours == counted
    assert abs(ours / 1e12 - expect_tflop) < 0.005


@pytest.mark.parametrize("name,lat", [("sdxl-base-1.0", 128), ("sd-1.5", 64)])
def test_attention_and_conv_calls(name, lat):
    cfg = json.loads((REPO / "gpubench/configs" / f"{name}.json").read_text())
    calls = unet2d.unet_calls(cfg["unet"], 16, lat, lat)
    kinds = {c["kind"] for c in calls}
    assert kinds == {"attention", "conv3x3", "conv1x1", "linear"}
    for c in calls:
        assert c["flops"] > 0 and c["bytes"] > 0
    # the evaluation scales with its batch but for the weights' bytes
    one = unet2d.unet_calls(cfg["unet"], 1, lat, lat)
    assert sum(c["flops"] for c in calls) == 16 * sum(c["flops"] for c in one)
