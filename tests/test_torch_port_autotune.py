"""The port's autotune against the JAX package's, and its store, routes,
tuner loop and pipeline hook, on the CPU.

  * the keys are JAX's strings for the same shapes and dtypes;
  * the shape enumerators equal JAX's ``attention_shapes_for_unet`` and
    ``conv_shapes_for_unet`` (with ``gn_pairs``) for SDXL-base, SD1.5 and
    SD2.x at their serving sizes (JAX's conv probe hard-codes SDXL's
    1280-wide text embeds, so the tiny config's convs are held against the
    ones its real UNet dispatches here instead);
  * the two-layer store (the user cache over the packaged table, merged with
    the file on disk under a file lock, replaced whole, by several
    processes at once), each route's lookup and the cache that ``record``
    clears, the entry that keeps the rule, and the values a kernel cannot
    take, which raise;
  * the tuner loop under a fake clock (on the card, tests/test_torch_port_gpu.py
    tunes from an empty table): a plan off the rule is recorded only beyond the
    rule's two-timing spread; and that it refuses the CPU with the default
    clock;
  * the pipeline's hook: JAX's ``cfg_factors`` rule, never on the CPU.
"""

import dataclasses
import json
import os
import pathlib
import re
import subprocess
import sys

import jax.numpy as jnp
import pytest
import torch

from stabletriton_tpu.kernels import autotune as jtune
from stabletriton_tpu.models import unet as junet
from stabletriton_tpu_torch import ops
from stabletriton_tpu_torch.compile import (
    ALL_KERNEL_OVERRIDES,
    FUSED_OP_OVERRIDES,
    CompileConfig,
    resolve_binding,
)
from stabletriton_tpu_torch.kernels import autotune
from stabletriton_tpu_torch.kernels import conv_direct as tconv
from stabletriton_tpu_torch.kernels import flash_attention as tfa
from stabletriton_tpu_torch.kernels import linear as tlinear
from stabletriton_tpu_torch.kernels import wgmma_plan as twp
from stabletriton_tpu_torch.models import unet as tunet
from stabletriton_tpu_torch.ops import reference
from stabletriton_tpu_torch.runtime import pipeline as tpipe
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16
# (config, latent size) at each family's serving resolution, batch 1
SERVING = {
    "sdxl": (tunet.sdxl_base_unet_config, 128),
    "sd15": (tunet.sd15_unet_config, 64),
    "sd21": (tunet.sd21_unet_config, 96),
}


@pytest.fixture
def table(tmp_path, monkeypatch):
    """An empty packaged directory and user cache under tmp_path; the loaded
    tables and the routes made from them are dropped before and after."""
    monkeypatch.setattr(autotune, "PACKAGED_DIR", tmp_path / "packaged")
    monkeypatch.setenv("ST_TPU_AUTOTUNE_CACHE", str(tmp_path / "user.json"))
    autotune.reload()
    yield tmp_path
    autotune.reload()


def _jax_config(tcfg):
    return junet.UNetConfig(**dataclasses.asdict(tcfg))


# --------------------------------------------------------------------------
# keys and shapes
# --------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 4096, 4096, 10, 64), (2, 1024, 77, 20, 64),
                                   (1, 16384, 16384, 1, 512), (2, 4096, 77, 8, 40)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_attention_keys_equal_jax(shape, dtype):
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    assert autotune.attention_key(*shape, tdt) == jtune.attention_key(*shape, jdt)
    for kind in ("qkv", "kv"):
        assert (autotune.fused_attention_key(kind, *shape, tdt)
                == jtune.fused_attention_key(kind, *shape, jdt))


@pytest.mark.parametrize("shape,has_res,act,gn", [
    ((2, 128, 128, 4, 320), False, None, False),
    ((2, 32, 32, 1280, 1280), True, "silu", False),
    ((2, 64, 64, 960, 640), True, None, True),
    ((1, 8, 8, 1280, 1280), False, "silu", True),
])
def test_conv_keys_equal_jax(shape, has_res, act, gn):
    for tdt, jdt in ((BF16, jnp.bfloat16), (torch.float32, jnp.float32)):
        assert (autotune.conv_key(*shape, tdt, has_res, act, gn)
                == jtune.conv_key(*shape, jdt, has_res, act, gn))


def test_linear_key():
    assert autotune.linear_key(154, 1024, 640, BF16) == "linear:m154:k1024:n640:bfloat16"
    assert autotune.linear_key(2, 1280, 1280, "float32") == "linear:m2:k1280:n1280:float32"


@pytest.mark.parametrize("family", ["tiny", *SERVING])
@pytest.mark.parametrize("factor", [1, 2])
def test_attention_shapes_equal_jax(family, factor):
    make, lat = SERVING.get(family, (tunet.tiny_unet_config, 4))
    cfg = make()
    assert (autotune.attention_shapes_for_unet(cfg, lat, lat, 1, cfg_factor=factor)
            == jtune.attention_shapes_for_unet(_jax_config(cfg), lat, lat, 1,
                                               cfg_factor=factor))


@pytest.mark.parametrize("family", list(SERVING))
@pytest.mark.parametrize("gn_pairs", [False, True])
def test_conv_shapes_equal_jax(family, gn_pairs):
    make, lat = SERVING[family]
    cfg = make()
    got = autotune.conv_shapes_for_unet(cfg, lat, lat, 1, gn_pairs=gn_pairs)
    assert got == jtune.conv_shapes_for_unet(_jax_config(cfg), lat, lat, 1, gn_pairs=gn_pairs)
    assert got and all(s[0] == 2 for s in got)


def _recorded(cfg, lat, op, probe_args):
    """The shapes ``op`` takes in a real float32 run of the UNet on the CPU
    (the cross K/V precompute, then the step), recorded as the meta probe
    records them."""
    seen = set()
    inner = reference.conv2d if op == "conv2d" else reference.linear

    def spy(*args, **kw):
        seen.add(probe_args(*args, **kw))
        return inner(*args, **kw)

    ops.register(op, "_spy")(spy)
    try:
        params = tunet.init_unet_params(cfg, 0)
        b = 2
        pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        with torch.inference_mode(), ops.use_backends({op: "_spy"}):
            kv = tunet.precompute_cross_kv(cfg, params, torch.randn(b, 77, cfg.cross_attention_dim))
            tunet.unet_apply(cfg, params, torch.randn(b, lat, lat, cfg.in_channels),
                             torch.full((b,), 500.0), None, torch.randn(b, pooled),
                             torch.zeros(b, 6), cross_kv=kv)
    finally:
        from stabletriton_tpu_torch.ops.registry import _REGISTRY
        _REGISTRY[op].pop("_spy")
    return seen


def test_tiny_conv_and_linear_shapes_equal_a_real_run():
    cfg = tunet.tiny_unet_config()

    def conv_args(x, w, b=None, *, stride=1, padding=1, residual=None, act=None):
        if tuple(w.shape[:2]) == (3, 3) and stride == 1 and padding == 1:
            return (*x.shape[:3], *w.shape[2:], residual is not None, act)
        return None

    def linear_args(x, w, b=None, *, act=None):
        return (x.reshape(-1, x.shape[-1]).shape[0], x.shape[-1], w.shape[-1])

    convs = _recorded(cfg, 8, "conv2d", conv_args) - {None}
    assert sorted(convs, key=lambda s: (s[:5], s[5], str(s[6]))) == \
        autotune.conv_shapes_for_unet(cfg, 8, 8, 1)
    # unfused projections, as a tensor-parallel pipeline runs them
    assert sorted(_recorded(cfg, 8, "linear", linear_args)) == \
        autotune.linear_shapes_for_unet(cfg, 8, 8, 1, fused=False)


def test_linear_shapes_hold_the_recorded_misses():
    """The two GEMMs the fitted rule was recorded to miss are a
    signature's shapes: SD2.x's cross K/V precompute and SD1.5's 8^2
    level."""
    sd2 = autotune.linear_shapes_for_unet(tunet.sd21_unet_config(), 96, 96, 1)
    sd15 = autotune.linear_shapes_for_unet(tunet.sd15_unet_config(), 64, 64, 1)
    assert (154, 1024, 640) in sd2 and (128, 1280, 1280) in sd15
    sdxl = autotune.linear_shapes_for_unet(tunet.sdxl_base_unet_config(), 128, 128, 1)
    assert (8192, 640, 1920) in sdxl and (2, 2816, 1280) in sdxl  # fused qkv, add embedding
    unfused = autotune.linear_shapes_for_unet(tunet.sdxl_base_unet_config(), 128, 128, 1,
                                              fused=False)
    assert (8192, 640, 640) in unfused and (8192, 640, 1920) not in unfused


# --------------------------------------------------------------------------
# the store
# --------------------------------------------------------------------------


def test_platform_tag_on_the_cpu():
    assert autotune.platform_tag() == "cpu"


def test_record_lookup_round_trip(table):
    key = autotune.linear_key(154, 1024, 640, BF16)
    assert autotune.lookup(key) is None
    autotune.record(key, {"bn": 128, "splits": 2, "t_us": 3.5})
    assert autotune.lookup(key) == {"bn": 128, "splits": 2, "t_us": 3.5}
    assert json.loads((table / "user.json").read_text()) == {key: autotune.lookup(key)}
    autotune.reload()  # a new process reads it back from disk
    assert autotune.lookup(key)["splits"] == 2
    autotune.record("other", {"x": 1}, persist=False)
    assert "other" not in json.loads((table / "user.json").read_text())


def test_user_cache_over_packaged_table(table):
    (table / "packaged").mkdir()
    (table / "packaged" / "cpu.json").write_text(json.dumps(
        {"a": {"bn": 128, "splits": 1}, "b": {"bn": 256, "splits": 1}}))
    (table / "user.json").write_text(json.dumps({"b": {"bn": 128, "splits": 3}}))
    assert autotune.lookup("a") == {"bn": 128, "splits": 1}
    assert autotune.lookup("b") == {"bn": 128, "splits": 3}


def test_record_merges_with_the_file_on_disk(table):
    autotune.record("a", {"v": 1})
    # another tuner wrote "b" since this process loaded its table
    on_disk = json.loads((table / "user.json").read_text())
    (table / "user.json").write_text(json.dumps({**on_disk, "b": {"v": 2}}))
    autotune.record("c", {"v": 3})
    assert set(json.loads((table / "user.json").read_text())) == {"a", "b", "c"}


RECORD_MANY = """
import sys
from stabletriton_tpu_torch.kernels import autotune
for i in range(25):
    autotune.record(f"r{sys.argv[1]}:{i}", {"t_us": float(i)})
"""


def test_records_of_processes_sharing_a_cache_are_all_kept(table):
    """Ranks on one host record into one user cache at once: each merge
    reads a whole file and no entry is lost."""
    env = {**os.environ, "ST_TPU_AUTOTUNE_CACHE": str(table / "user.json")}
    procs = [subprocess.Popen([sys.executable, "-c", RECORD_MANY, str(r)], env=env,
                              cwd=pathlib.Path(__file__).resolve().parent.parent)
             for r in range(4)]
    assert [proc.wait(120) for proc in procs] == [0] * 4
    on_disk = json.loads((table / "user.json").read_text())
    assert set(on_disk) == {f"r{r}:{i}" for r in range(4) for i in range(25)}
    assert sorted(q.name for q in table.iterdir()) == ["user.json", "user.json.lock"]


def test_a_table_that_is_not_json_raises_naming_its_path(table):
    (table / "user.json").write_text('{"a": {"bn": 1')
    with pytest.raises(ValueError, match="user.json is not valid JSON"):
        autotune.lookup("a")


# --------------------------------------------------------------------------
# the routes
# --------------------------------------------------------------------------


def _linear_route(m, k, n):
    return tlinear._route((m, k), (k, n), (n,), BF16, BF16, None)


def test_linear_route_takes_the_recorded_wgmma_plan(table):
    rule = _linear_route(154, 1024, 640)
    assert rule.plan == twp.gemm_plan(154, 1024, 640) == twp.Plan(128, 4)
    autotune.record(autotune.linear_key(154, 1024, 640, BF16), {"bn": 256, "splits": 2})
    assert tlinear._route.cache_info().currsize == 0  # record cleared the route
    route = _linear_route(154, 1024, 640)
    assert route.plan == twp.Plan(256, 2) and route.key.endswith("bn=256 split=2")
    with autotune.disabled():
        assert _linear_route(154, 1024, 640).plan == rule.plan
    assert _linear_route(154, 1024, 640).plan == twp.Plan(256, 2)


def test_linear_route_takes_the_recorded_skinny_plan(table):
    autotune.record(autotune.linear_key(2, 1280, 1280, BF16), {"cols": 32, "splits": 4})
    route = _linear_route(2, 1280, 1280)
    assert route.name == "skinny_bf16"
    assert route.plan == tlinear.SkinnyPlan(32, 4, 320) and route.key.endswith("cols=32 split=4")
    assert (route.dims.cols, route.dims.splits, route.dims.rows) == (32, 4, 320)


def test_conv_route_takes_the_recorded_plan(table):
    rule = tconv._wgmma_route(2, 32, 32, 1280, 1280, False, True, "silu")
    autotune.record(autotune.conv_key(2, 32, 32, 1280, 1280, BF16, True, "silu"),
                    {"bn": 128, "splits": 6})
    tile, plan, key = tconv._wgmma_route(2, 32, 32, 1280, 1280, False, True, "silu")
    assert plan == twp.Plan(128, 6) and key.endswith("bn=128 split=6") and tile == rule[0]
    # the key holds the residual, the act and the prologue: other convs keep the rule
    assert tconv._wgmma_route(2, 32, 32, 1280, 1280, False, False, "silu")[1] == rule[1]
    # conv_in: keyed by the Cin the caller gives (4), planned at 8
    autotune.record(autotune.conv_key(2, 128, 128, 4, 320, BF16, False, None),
                    {"bn": 128, "splits": 1})
    assert tconv._wgmma_route(2, 128, 128, 4, 320, False, False, None)[1] == twp.Plan(128, 1)


def test_attention_route_takes_the_recorded_kernel_per_entry_point(table):
    args = (BF16, 2, 4096, 77, 10, 64, None, None)
    assert tfa._route(*args, (0, 0, 640), "kv").kernel == "tinykv_wgmma_bf16"
    autotune.record(autotune.fused_attention_key("kv", 2, 4096, 77, 10, 64, BF16),
                    {"kernel": "wgmma_bf16", "tiles": 1})
    route = tfa._route(*args, (0, 0, 640), "kv")
    assert route.kernel == "wgmma_bf16" and route.key.startswith("K1 wgmma_bf16 ")
    assert tfa._route(*args, (0, 0, 0), "attention").kernel == "tinykv_wgmma_bf16"
    autotune.record(autotune.attention_key(2, 4096, 77, 10, 64, BF16),
                    {"kernel": "tinykv_wgmma_bf16", "tiles": 1})
    route = tfa._route(*args, (0, 0, 0), "attention")
    assert (route.kernel, route.tiles) == ("tinykv_wgmma_bf16", 1)
    # a kernel named by the caller is not overridden
    assert tfa._route(BF16, 2, 4096, 77, 10, 64, None, "tinykv_wgmma_bf16",
                      (0, 0, 640), "kv").kernel == "tinykv_wgmma_bf16"


def test_an_entry_that_keeps_the_rule_routes_to_the_rule(table):
    rule = _linear_route(154, 1024, 640).plan
    conv_rule = tconv._wgmma_route(2, 32, 32, 1280, 1280, False, True, "silu")
    attn_args = (BF16, 2, 4096, 77, 10, 64, None, None, (0, 0, 640), "kv")
    attn_rule = tfa._route(*attn_args)
    autotune.record(autotune.linear_key(154, 1024, 640, BF16), {"t_us": 8.9})
    autotune.record(autotune.conv_key(2, 32, 32, 1280, 1280, BF16, True, "silu"),
                    {"t_us": 20.0})
    autotune.record(autotune.fused_attention_key("kv", 2, 4096, 77, 10, 64, BF16),
                    {"t_us": 14.0})
    assert autotune.keeps_rule(autotune.lookup(autotune.linear_key(154, 1024, 640, BF16)))
    assert _linear_route(154, 1024, 640).plan == rule
    assert tconv._wgmma_route(2, 32, 32, 1280, 1280, False, True, "silu") == conv_rule
    assert tfa._route(*attn_args) == attn_rule


def _route_plan(key: str):
    """The plan the route takes from the table for the bf16 ``key``
    (raising where a kernel cannot take the entry)."""
    if m := re.fullmatch(r"linear:m(\d+):k(\d+):n(\d+):bfloat16", key):
        m, k, n = map(int, m.groups())
        return tlinear.tuned_plan(m, k, n, BF16, tlinear.variant(m, k, n, BF16))
    if m := re.fullmatch(r"conv3x3:n(\d+):h(\d+):w(\d+):ci(\d+):co(\d+):bfloat16:res([01]):"
                         r"([^:]+)(:gn)?", key):
        n, h, w, cin, cout, res = map(int, m.groups()[:6])
        act = None if m[7] == "-" else m[7]
        return tconv.tuned_plan(n, h, w, cin, cout, m[8] is not None, bool(res), act)
    m = re.fullmatch(r"attention(?:_(qkv|kv))?:b(\d+):sq(\d+):sk(\d+):h(\d+):d(\d+):bfloat16",
                     key)
    b, sq, sk, h, d = map(int, m.groups()[1:])
    return tfa.tuned_plan(BF16, b, sq, sk, h, d, m[1] or "attention")


def test_every_packaged_entry_names_a_plan_its_kernel_takes(table):
    """Each packaged table holds only plans off the rule (no entry that
    keeps it), each one its route takes, on a hand-written kernel."""
    packaged = sorted(pathlib.Path(tconv.__file__).parent.joinpath("tuned").glob("*.json"))
    assert packaged
    (table / "packaged").mkdir()
    for path in packaged:
        entries = json.loads(path.read_text())
        (table / "packaged" / "cpu.json").write_text(json.dumps(entries))
        autotune.reload()
        for key, entry in entries.items():
            assert not autotune.keeps_rule(entry) and entry["t_us"] > 0, key
            plan = _route_plan(key)
            assert plan is not None, key


BAD_ENTRIES = [
    ("linear", (154, 1024, 640), {"impl": "xla"}),
    ("linear", (154, 1024, 640), {}),
    ("linear", (154, 1024, 640), {"bn": 64, "splits": 1}),
    ("linear", (154, 1024, 640), {"bn": 128, "splits": 17}),
    ("linear", (154, 1024, 640), {"bn": 128, "splits": 0}),
    ("linear", (154, 1024, 640), {"cols": 64, "splits": 1}),
    ("linear", (2, 1280, 1280), {"cols": 48, "splits": 1}),
    ("linear", (2, 1280, 1280), {"cols": 64, "splits": 9}),
    ("linear", (2, 1280, 1280), {"bn": 128, "splits": 1}),
    ("conv", (2, 32, 32, 1280, 1280, False), {"bn": 128, "splits": 200}),
    ("conv", (2, 32, 32, 1280, 1280, True), {"bn": 8, "splits": 1}),
    ("conv", (2, 128, 128, 320, 4, False), {"bn": 128, "splits": 1}),
    ("conv", (2, 32, 32, 1280, 1280, False), {"impl": "xla", "t_us": 1.0}),
    ("attention", (2, 4096, 77, 10, 64), {"kernel": "sdpa", "tiles": 1}),
    ("attention", (2, 4096, 77, 10, 64), {"kernel": "tinykv_wgmma_bf16", "tiles": 5}),
    ("attention", (2, 4096, 4096, 10, 64), {"kernel": "tinykv_wgmma_bf16", "tiles": 1}),
    ("attention", (2, 4096, 4096, 10, 64), {"kernel": "wgmma_bf16", "tiles": 2}),
]


@pytest.mark.parametrize("kind,shape,entry", BAD_ENTRIES)
def test_an_entry_no_kernel_takes_raises_naming_its_key(table, kind, shape, entry):
    if kind == "linear":
        key = autotune.linear_key(*shape, BF16)
        call = lambda: _linear_route(*shape)  # noqa: E731
    elif kind == "conv":
        *conv, gn = shape
        key = autotune.conv_key(*conv, BF16, False, None, gn)
        call = lambda: tconv._wgmma_route(*conv, gn, False, None)  # noqa: E731
    else:
        key = autotune.fused_attention_key("kv" if shape[2] == 77 else "qkv", *shape, BF16)
        c = shape[3] * shape[4]
        call = lambda: tfa._route(BF16, *shape[:4], shape[4], None, None,  # noqa: E731
                                  (0, 0, c) if shape[2] == 77 else (0, c, 2 * c),
                                  "kv" if shape[2] == 77 else "qkv")
    autotune.record(key, entry)
    for _ in range(2):  # the route cache keeps no exception
        with pytest.raises(ValueError, match=key):
            call()


def test_an_f32_linear_entry_raises(table):
    key = autotune.linear_key(300, 64, 64, torch.float32)
    autotune.record(key, {"bn": 128, "splits": 1})
    with pytest.raises(ValueError, match="wgmma_tf32x3 kernel takes no plan"):
        tlinear._route((300, 64), (64, 64), None, torch.float32, None, None)


# --------------------------------------------------------------------------
# the tuner loop
# --------------------------------------------------------------------------


class FakeClock:
    """``measure`` for the tuners: a candidate's time from its plan, every
    call recorded; no kernel runs."""

    def __init__(self, seconds):
        self.seconds, self.timed = seconds, []

    def __call__(self, cand, token, *, chain_arg, min_window):
        assert chain_arg == 0 and token.device.type == "cpu"
        self.timed.append(cand.plan)
        return self.seconds(cand.plan) * autotune.REPS


def test_tune_linear_keeps_the_least_time_and_always_times_the_rule(table):
    rule = twp.gemm_plan(154, 1024, 640)
    clock = FakeClock(lambda p: 1e-6 * (p.splits if p.bn == 256 else 10 + p.splits))
    got = autotune.tune_linear(154, 1024, 640, measure=clock, device="cpu")
    # each candidate once, then the rule and the fastest again
    first = clock.timed[:-2]
    assert rule in first and len(set(first)) == len(first)
    assert clock.timed[-2:] == [rule, twp.Plan(256, 1)]
    assert got.retimed_us == {rule: got.times_us[rule], twp.Plan(256, 1): 1.0}
    assert got.entry == {"bn": 256, "splits": 1, "t_us": 1.0}
    steps = -(-1024 // twp.BK)
    assert all(p.bn in twp.WIDTHS and 1 <= p.splits <= steps for p in clock.timed)
    assert _linear_route(154, 1024, 640).plan == twp.Plan(256, 1)


def test_tune_keeps_the_rule_on_a_tie(table):
    rule = twp.gemm_plan(128, 1280, 1280)
    clock = FakeClock(lambda p: 1e-5)
    got = autotune.tune_linear(128, 1280, 1280, measure=clock, device="cpu", persist=False)
    assert got.entry == {"t_us": 10.0} and autotune.keeps_rule(got.entry)
    assert len(set(clock.timed)) == len(clock.timed)  # nothing timed again
    assert _linear_route(128, 1280, 1280).plan == rule


def test_tune_keeps_the_rule_where_the_gain_is_inside_its_spread(table):
    """The rule reads 10 then 12 us (spread 2): a plan at 9.5 us beats its
    best time by less than that and is not recorded; one at 7.9 us is."""
    rule = twp.gemm_plan(154, 1024, 640)

    def clock_at(other_us):
        rule_us = iter((10e-6, 12e-6))
        return FakeClock(lambda p: next(rule_us) if p == rule else
                         other_us if p == twp.Plan(256, 1) else 20e-6)

    got = autotune.tune_linear(154, 1024, 640, measure=clock_at(9.5e-6), device="cpu")
    assert got.retimed_us == {rule: 12.0, twp.Plan(256, 1): 9.5}
    assert got.entry == {"t_us": 10.0}
    assert _linear_route(154, 1024, 640).plan == rule
    got = autotune.tune_linear(154, 1024, 640, measure=clock_at(7.9e-6), device="cpu")
    assert got.entry == {"bn": 256, "splits": 1, "t_us": 7.9}
    assert _linear_route(154, 1024, 640).plan == twp.Plan(256, 1)


def test_tune_skinny_times_only_plans_the_kernel_takes(table):
    clock = FakeClock(lambda p: 1e-6 * (1 + abs(p.cols - 32) + p.splits))
    got = autotune.tune_linear(2, 1280, 1280, measure=clock, device="cpu")
    assert tlinear.skinny_plan(2, 1280, 1280, 2) in clock.timed
    assert got.entry == {"cols": 32, "splits": 1, "t_us": 2.0}
    for plan in clock.timed:  # each is a plan the route takes back
        autotune.record(autotune.linear_key(2, 1280, 1280, BF16),
                        {"cols": plan.cols, "splits": plan.splits}, persist=False)
        assert _linear_route(2, 1280, 1280).plan == plan


def test_tune_conv_with_the_prologue_times_width_128_only(table):
    clock = FakeClock(lambda p: 1e-6 * p.splits)
    autotune.tune_conv(2, 16, 16, 1280, 1280, gn=True, measure=clock, device="cpu")
    # K8 at Cout > 8: its own widths, each timed
    assert clock.timed and {p.bn for p in clock.timed} == set(twp.GN_WIDTHS)
    assert twp.conv_plan(2, 16, 16, 1280, 1280, gn=True)[1] in clock.timed
    clock = FakeClock(lambda p: 1e-6)
    autotune.tune_conv(2, 128, 128, 320, 4, has_res=False, act=None, measure=clock,
                       device="cpu")
    assert clock.timed == [twp.Plan(twp.N8, 1)]  # conv_out: width 8 unsplit alone


def test_a_shape_no_kernel_takes_is_never_timed(table):
    clock = FakeClock(lambda p: 1e-6)
    with pytest.raises(ValueError, match="no wgmma conv takes"):
        autotune.tune_conv(2, 16, 16, 64, 12, measure=clock, device="cpu")  # Cout 12
    with pytest.raises(ValueError, match="takes no plan"):
        autotune.tune_linear(300, 60, 64, measure=clock, device="cpu")  # K % 8: WMMA
    with pytest.raises(ValueError, match="only the bf16 attention kernels"):
        autotune.tune_attention(1, 4096, 4096, 1, 512, torch.float32, measure=clock,
                                device="cpu")
    assert clock.timed == []


def test_tune_attention_times_both_kernels_at_tiny_kv(table):
    rule = ("tinykv_wgmma_bf16", tfa.tiny_kv_plan(2, 10, 4096, 64).tiles)
    clock = FakeClock(lambda p: 1e-6 * (1 if p == ("tinykv_wgmma_bf16", 2) else 3))
    got = autotune.tune_attention_fused(2, 4096, 77, 10, 64, measure=clock, device="cpu")
    assert got.key == autotune.fused_attention_key("kv", 2, 4096, 77, 10, 64, BF16)
    assert rule in clock.timed and ("wgmma_bf16", 1) in clock.timed
    assert sorted({t for k, t in clock.timed if k.startswith("tinykv")}) == [1, 2, 3, 4]
    assert got.entry == {"kernel": "tinykv_wgmma_bf16", "tiles": 2, "t_us": 1.0}
    assert tfa._route(BF16, 2, 4096, 77, 10, 64, None, None, (0, 0, 640), "kv").tiles == 2
    clock = FakeClock(lambda p: 1e-6)
    autotune.tune_attention(2, 4096, 4096, 10, 64, measure=clock, device="cpu")
    assert clock.timed == [("wgmma_bf16", 1)]


def test_a_tuner_refuses_the_cpu_with_the_default_clock(table):
    for call in (lambda: autotune.tune_linear(154, 1024, 640),
                 lambda: autotune.tune_conv(2, 32, 32, 1280, 1280),
                 lambda: autotune.tune_attention(2, 1024, 77, 20, 64)):
        with pytest.raises(RuntimeError, match="measures the kernels on the card"):
            call()
    assert not (table / "user.json").exists()


def test_ensure_tunes_each_missing_shape_once(table):
    cfg = tunet.sdxl_base_unet_config()
    clock = FakeClock(lambda p: 1e-6)
    tuned = autotune.ensure_conv_tuned(cfg, 128, 128, 1, measure=clock, device="cpu")
    shapes = autotune.conv_shapes_for_unet(cfg, 128, 128, 1)
    assert len(tuned) == len(shapes) == len({t.key for t in tuned})
    assert autotune.ensure_conv_tuned(cfg, 128, 128, 1, measure=clock, device="cpu") == []
    tuned = autotune.ensure_attention_tuned(cfg, 128, 128, 1, cfg_factors=(1, 2),
                                            measure=clock, device="cpu")
    assert len(tuned) == 2 * len(autotune.attention_shapes_for_unet(cfg, 128, 128, 1)) * 2


@pytest.mark.parametrize("overrides,ops_tuned", [
    ((), {"attention", "conv"}),
    (FUSED_OP_OVERRIDES, {"attention", "conv", "gn_conv"}),
    (ALL_KERNEL_OVERRIDES, {"attention", "conv", "gn_conv", "linear"}),
])
def test_ensure_tuned_for_tunes_the_ops_the_binding_sends_to_a_kernel(monkeypatch, overrides,
                                                                      ops_tuned):
    seen = set()
    monkeypatch.setattr(autotune, "ensure_attention_tuned",
                        lambda *a, **k: seen.add("attention") or [])
    monkeypatch.setattr(autotune, "ensure_conv_tuned",
                        lambda *a, gn=False, **k: seen.add("gn_conv" if gn else "conv") or [])
    monkeypatch.setattr(autotune, "ensure_linear_tuned",
                        lambda *a, **k: seen.add("linear") or [])
    binding = resolve_binding(CompileConfig(overrides=overrides))
    autotune.ensure_tuned_for(binding, tunet.tiny_unet_config(), 4, 4, 1, BF16, (2,))
    assert seen == ops_tuned
    seen.clear()
    autotune.ensure_tuned_for(resolve_binding(CompileConfig(backend="reference")),
                              tunet.tiny_unet_config(), 4, 4, 1, BF16, (2,))
    assert seen == set()


# --------------------------------------------------------------------------
# the pipeline's hook
# --------------------------------------------------------------------------


@pytest.mark.parametrize("guidance,interval,factors", [
    (5.0, None, (2,)), (1.0, None, (1,)), (0.5, (1.0, 5.0), (1,)), (5.0, (1.0, 5.0), (1, 2)),
])
def test_pipeline_hook_tunes_with_jax_cfg_factors_and_never_on_the_cpu(
        monkeypatch, guidance, interval, factors):
    calls = []
    monkeypatch.setattr(autotune, "ensure_tuned_for",
                        lambda binding, cfg, lh, lw, batch, dtype, f, fused=True:
                        calls.append((binding, lh, lw, batch, dtype, f, fused)))
    monkeypatch.setenv("ST_TPU_AUTOTUNE", "1")
    config = CompileConfig(overrides=ALL_KERNEL_OVERRIDES)
    pipe = tpipe.make_tiny_pipeline(config)
    gi = None if interval is None or guidance <= 1 else interval
    pipe._program(2, 32, 32, 2, guidance, "euler", False, gi, None)
    assert calls == []  # on the CPU: nothing to measure
    pipe.device = torch.device("cuda")  # only the hook reads the device while building
    pipe._cache.clear()
    pipe._program(2, 32, 32, 2, guidance, "euler", False, gi, None)
    lat = 32 // pipe.vae_config.spatial_scale_factor
    pipe._build_img2img(batch=2, lat_h=lat, lat_w=lat, steps=2, start=1, guidance_scale=guidance,
                        solver="euler", aesthetic_scores=(2.5, 6.0), decode=True,
                        guidance_interval=gi)
    pipe._build_inpaint(batch=2, height=32, width=32, steps=2, guidance_scale=guidance,
                        solver="euler", guidance_interval=gi)
    want = (resolve_binding(config), lat, lat, 2, BF16, factors, True)
    assert calls == [want] * 3
    assert autotune.cfg_factors(guidance, gi) == factors
    monkeypatch.setenv("ST_TPU_AUTOTUNE", "0")
    pipe._cache.clear()
    pipe._program(2, 32, 32, 2, guidance, "euler", False, gi, None)
    assert len(calls) == 3
