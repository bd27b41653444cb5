"""K5 on the tiny-KV wgmma kernel and the f32 conv_in on the direct kernel,
host side on the CPU.

``attn_tinykv_wgmma_bf16`` (csrc/flash_attention.cu) and ``conv_direct_f32``
(csrc/conv3x3.cu) run only on the card (tests/test_torch_port_gpu.py). What
the CPU can hold:

  * routing: every K5 shape (Sk <= 128 at an unpacked head dim) and K1's
    cross-attention (SDXL's 77 keys) to the tiny-KV kernel, still counted
    under their classes, and Sk = 129 to the wgmma kernel; f32 convs with
    Cin <= 4 and no GroupNorm prologue to the direct kernel, the rest of
    f32 as before;
  * ``tiny_kv_plan``: its grid covers every (batch, head, 128-row query
    tile) once and fills the card's SMs at the SD1.5 path's d = 40 shape;
  * the cached launch route: its bf16 / f32 q scale equals the per-call
    host item it replaces, and bad signatures raise on every call;
  * ``attention_plain`` (what the wrapper runs on a CPU tensor) against the
    JAX package's ``_single_kv_kernel`` route of ``flash_attention``
    (Pallas in interpret mode) at the key counts the kernel's masking
    turns on; tolerance as tests/test_torch_port_sd15.py: f32 max abs
    1e-5, bf16 2 bf16 ulps of the largest output;
  * the direct kernel's arithmetic, its fixed FMA order emulated in numpy
    (each f32 FMA taken in float64, rounded to f32), against the plain f32
    conv and the JAX package's Pallas conv (interpret mode): within 1e-5 of
    the largest output (summation order only).

Inputs are made with numpy from seeds.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu.kernels import flash_attention as jfa
from stabletriton_tpu.kernels.common import round_up
from stabletriton_tpu.kernels.conv_direct import conv3x3_direct
from stabletriton_tpu_torch.kernels import conv_direct as tconv
from stabletriton_tpu_torch.kernels import flash_attention as tfa
from stabletriton_tpu_torch.kernels import wgmma_plan as twp
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16
EDGE_KEYS = [1, 16, 17, 64, 77, 80, 128]  # one key, k16 and 64-key half edges, SD1.5's 77


# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sk", EDGE_KEYS + [129])
@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_k5_routes_to_the_tinykv_kernel(d, sk):
    """h = 3 packs at no head dim, so Sk <= 128 is K5, on the tiny-KV
    kernel with tiny_kv_plan's tiles; Sk = 129 is K4 on the wgmma kernel."""
    h, sq = 3, 300
    cls = tfa.attention_class(h, d, sk)
    route = tfa._route(BF16, 2, sq, sk, h, d, None, None, (0, 0, h * d))
    if sk <= 128:
        assert cls == "K5" and tfa.kernel_name(BF16, sk) == route.kernel == "tinykv_wgmma_bf16"
        assert route.tiles == tfa.tiny_kv_plan(2, h, sq, d).tiles
    else:
        assert cls == "K4" and tfa.kernel_name(BF16, sk) == route.kernel == "wgmma_bf16"
        assert route.tiles == 1
    assert route.key == f"{cls} {route.kernel} b=2 h={h} d={d} sq={sq} sk={sk}"
    assert tfa.kernel_name(torch.float32, sk) == "wgmma_tf32x3"


@pytest.mark.parametrize("h,sq,sk,kernel", [
    (10, 4096, 77, "tinykv_wgmma_bf16"), (20, 1024, 77, "tinykv_wgmma_bf16"),  # cross
    (20, 1024, 1024, "wgmma_bf16"), (10, 4096, 4096, "wgmma_bf16"),            # self
])
def test_sdxl_attention_keeps_its_class_on_either_kernel(h, sq, sk, kernel):
    """SDXL's d = 64 heads pack (K1 up to 1024 keys, K2 above): its
    cross-attention against 77 keys runs the tiny-KV kernel, counted as K1."""
    cls = "K1" if sk <= 1024 else "K2"
    route = tfa._route(BF16, 2, sq, sk, h, 64, None, None, (0, 0, h * 64))
    assert tfa.attention_class(h, 64, sk) == route.cls == cls
    assert route.kernel == kernel
    assert route.key == f"{cls} {kernel} b=2 h={h} d=64 sq={sq} sk={sk}"


@pytest.mark.parametrize("shape,cout,aligned,gn,want", [
    ((1, 128, 128, 4), 512, True, False, "direct_f32"),    # SDXL's decoder conv_in
    ((1, 64, 64, 4), 512, True, False, "direct_f32"),      # SD1.5's
    ((1, 128, 128, 4), 512, False, False, "direct_f32"),   # any alignment
    ((2, 13, 17, 3), 5, True, False, "direct_f32"),
    ((1, 128, 128, 4), 512, True, True, "scalar"),         # the GroupNorm prologue
    ((2, 13, 17, 12), 24, True, False, "scalar"),          # Cin > 4, no multiple of 8
    ((1, 128, 128, 8), 512, False, False, "scalar"),       # a base off 16 bytes
    ((1, 128, 128, 512), 512, True, False, "wgmma_tf32x3"),
])
def test_f32_convs_route_by_cin(shape, cout, aligned, gn, want):
    assert tconv.conv_variant(shape, cout, torch.float32, aligned, gn) == want
    # bf16 convs of any Cin stay on wgmma
    assert tconv.conv_variant(shape, cout, BF16, aligned) == "wgmma_bf16"


# --------------------------------------------------------------------------
# tiny_kv_plan
# --------------------------------------------------------------------------


@pytest.mark.parametrize("b,h,sq,d", [
    (2, 8, 4096, 40), (2, 8, 1024, 80), (2, 8, 256, 160), (2, 8, 64, 160),  # SD1.5's K5
    (2, 10, 4096, 64), (2, 20, 1024, 64),  # SDXL's cross-attention shapes
    (1, 1, 1, 40), (3, 5, 1000, 80), (4, 8, 4096, 40), (1, 3, 300, 64), (8, 8, 4096, 40),
    (8, 8, 1024, 160),
])
def test_tiny_kv_plan_covers_each_query_tile_once(b, h, sq, d):
    """Block (x, head, batch) takes query tiles x * tiles .. up to the last:
    every (batch, head, tile) is taken once, no block is empty, a block's Q
    fits its 64 KB, and the grid is no larger than the card's resident
    blocks unless a block already holds the most tiles it can."""
    plan = tfa.tiny_kv_plan(b, h, sq, d)
    q_tiles = math.ceil(sq / tfa.QUERY_TILE)
    per_head = math.ceil(q_tiles / plan.tiles)
    assert plan.tiles >= 1 and plan.blocks == b * h * per_head
    walked = []
    for bi in range(b):
        for hi in range(h):
            for x in range(per_head):
                tiles = range(x * plan.tiles, min((x + 1) * plan.tiles, q_tiles))
                assert len(tiles) > 0
                walked += [(bi, hi, t) for t in tiles]
    assert sorted(walked) == [(bi, hi, t) for bi in range(b) for hi in range(h)
                              for t in range(q_tiles)]
    slots = twp.SMS * (2 if d <= 64 else 1)
    cap = tfa.TINY_KV_Q_BOXES // math.ceil(d / 64)
    assert plan.tiles <= cap
    assert plan.blocks <= max(slots, b * h) or plan.tiles == cap


def test_tiny_kv_plan_fills_the_card_at_d40():
    """SD1.5's cross-attention at 64^2 (512 query tiles): more than one
    tile a block, and at least a block for each of the 132 SMs."""
    plan = tfa.tiny_kv_plan(2, 8, 4096, 40)
    assert plan.tiles >= 2 and plan.blocks >= twp.SMS


# --------------------------------------------------------------------------
# the cached launch route
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype,d", [(BF16, 40), (BF16, 64), (BF16, 160), (torch.float32, 64),
                                     (torch.float32, 512)])
@pytest.mark.parametrize("scale", [None, 0.125, 0.3])
def test_route_qscale_is_the_rounded_host_item(dtype, d, scale):
    """The route's q scale is the value each launch used to compute, the
    host item of scale * log2(e) rounded to the operand dtype, bit for bit;
    a second call returns the cached route itself."""
    h, sk = (1, 16384) if d == 512 else (8, 77)
    args = (dtype, 2, 1024, sk, h, d, scale, None, (0, 0, h * d))
    route = tfa._route(*args)
    want = torch.tensor((scale or 1 / math.sqrt(d)) * tfa.LOG2E, dtype=dtype).item()
    assert route.qscale == want
    assert tfa._route(*args) is route


@pytest.mark.parametrize("args,match", [
    ((BF16, 2, 64, 77, 8, 96, None, None, (0, 0, 768)), "head dims"),
    ((torch.float32, 2, 64, 77, 2, 40, None, None, (0, 0, 80)), "head dims"),
    ((torch.float16, 2, 64, 77, 2, 64, None, None, (0, 0, 128)), "float32 or bfloat16"),
    ((BF16, 2, 64, 0, 8, 40, None, None, (0, 0, 320)), "at least one key"),
    ((BF16, 2, 64, 77, 8, 40, None, None, (4, 0, 320)), "aligned"),
    ((BF16, 2, 64, 129, 8, 40, None, "tinykv_wgmma_bf16", (0, 0, 320)), "at most 128 keys"),
    ((BF16, 2, 64, 77, 8, 40, None, "wgmma_tf32x3", (0, 0, 320)), "does not take"),
])
def test_route_refuses_every_time(args, match):
    """The cache keeps no exception: a bad signature raises on each call."""
    for _ in range(2):
        with pytest.raises(ValueError, match=match):
            tfa._route(*args)


# --------------------------------------------------------------------------
# attention_plain against JAX's _single_kv_kernel route
# --------------------------------------------------------------------------


def _attn_close(j, t, dtype):
    j = np.asarray(j.astype(jnp.float32))
    t = t.float().numpy()
    if dtype == torch.float32:
        atol = 1e-5
    else:  # 2 bf16 ulps (8 significant bits) of the largest output
        atol = 2 * 2.0 ** (math.floor(math.log2(np.abs(j).max())) - 7)
    np.testing.assert_allclose(t, j, atol=atol, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, BF16])
@pytest.mark.parametrize("sk", EDGE_KEYS)
@pytest.mark.parametrize("d", [40, 80, 160])
def test_attention_plain_vs_jax_single_kv(d, sk, dtype):
    """JAX runs these in one tiny-KV block (the all-heads layout, keys
    padded to 128 and masked); the port's K5 class is the same set."""
    h, sq = 2, 24
    assert jfa._attn_layout(sk, h, d)[0] == "allheads" and round_up(sk, jfa.LANES) == jfa.LANES
    assert tfa.attention_class(h, d, sk) == "K5"
    rng = np.random.default_rng(d * 1000 + sk)
    jd = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    q, k, v = (rng.standard_normal((1, s, h * d)).astype(np.float32) for s in (sq, sk, sk))
    j = jfa.flash_attention(*(jnp.asarray(a, jd) for a in (q, k, v)), num_heads=h)
    t = tfa.flash_attention(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), num_heads=h)
    _attn_close(j, t, dtype)


# --------------------------------------------------------------------------
# the direct conv's arithmetic
# --------------------------------------------------------------------------


def _direct_emulated(x, w, bias, residual, act):
    """conv_direct_f32 in numpy: each output's 9 * Cin f32 FMAs in the
    kernel's order, tap-major (ky, kx) and channel inner, each product and
    sum taken in float64 and rounded to f32 (an FMA's single rounding); then
    bias, residual and SiLU in f32."""
    b, h, wd, cin = x.shape
    xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    acc = np.zeros((b, h, wd, w.shape[3]), np.float32)
    for ky in range(3):
        for kx in range(3):
            for ci in range(cin):
                tap = xp[:, ky:ky + h, kx:kx + wd, ci, None].astype(np.float64)
                acc = (tap * w[ky, kx, ci].astype(np.float64) + acc).astype(np.float32)
    if bias is not None:
        acc = acc + (bias[:, None, None, :] if bias.ndim == 2 else bias)
    if residual is not None:
        acc = acc + residual
    if act == "silu":
        acc = torch.nn.functional.silu(torch.from_numpy(acc)).numpy()
    return acc


@pytest.mark.parametrize("bias_kind,res,act", [("shared", False, None), ("batch", True, "silu"),
                                               ("shared", True, "silu"), (None, False, None)])
def test_direct_conv_order_matches_f32(bias_kind, res, act):
    rng = np.random.default_rng(len(str(bias_kind)) + 2 * res + 4 * (act is None))
    b, h, w, cin, cout = 2, 9, 11, 4, 6
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) / 6).astype(np.float32)
    bias = (None if bias_kind is None else
            rng.standard_normal((b, cout) if bias_kind == "batch" else (cout,)).astype(np.float32))
    r = rng.standard_normal((b, h, w, cout)).astype(np.float32) if res else None
    got = _direct_emulated(x, wt, bias, r, act)
    plain = tconv.conv3x3_plain(
        torch.from_numpy(x), torch.from_numpy(wt),
        None if bias is None else torch.from_numpy(bias),
        residual=None if r is None else torch.from_numpy(r), act=act).numpy()
    pallas = np.asarray(conv3x3_direct(
        jnp.asarray(x), jnp.asarray(wt), None if bias is None else jnp.asarray(bias),
        residual=None if r is None else jnp.asarray(r), act=act, interpret=True))
    scale = np.abs(plain).max()
    assert np.abs(got - plain).max() <= 1e-5 * scale
    assert np.abs(got - pallas).max() <= 1e-5 * scale
