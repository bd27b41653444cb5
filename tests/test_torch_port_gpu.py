"""The CUDA kernels against their plain versions, and the port's paths at
full width against the reference binding, on the card.

Every test here is marked ``gpu`` and skips where torch sees no CUDA device.
The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py -q

Tolerances, relative to the largest plain output: 2e-2 for bf16 (a few bf16
ulps), 1e-4 for float32 (summation order only). A full-width UNet step under
a kernel binding stays within the step gate (MSE 1e-3) of the reference
binding's (cuBLAS, cuDNN, SDPA).
"""

import gc
import math
import weakref

import numpy as np
import pytest
import torch

import kernel_table
from stabletriton_tpu_torch.compile import ALL_KERNEL_OVERRIDES, FUSED_OP_OVERRIDES, CompileConfig
from stabletriton_tpu_torch.kernels import autotune as tautotune
from stabletriton_tpu_torch.kernels import conv_direct as tconv
from stabletriton_tpu_torch.kernels import dropout as tdropout
from stabletriton_tpu_torch.kernels import flash_attention as tfa
from stabletriton_tpu_torch.kernels import geglu as tgeglu
from stabletriton_tpu_torch.kernels import group_norm as tgn
from stabletriton_tpu_torch.kernels import layer_norm as tln
from stabletriton_tpu_torch.kernels import linear as tlinear
from stabletriton_tpu_torch.kernels import time_embed as ttime
from stabletriton_tpu_torch.kernels import wgmma_plan as twp


@pytest.fixture
def cuda_device():
    """The card, with TF32 off so the plain versions' float32 convs and
    matmuls keep full float32 precision (cuDNN's default is TF32)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield torch.device("cuda", 0)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.fixture(autouse=True)
def release_memory():
    """After each test on the card, the pipelines it left (their programs
    hold closures over them, a cycle) and the allocator's cached blocks go,
    so each full-width test, and the mesh test's ranks, find the card free."""
    yield
    if torch.cuda.is_available():
        gc.collect()
        torch.cuda.empty_cache()


@pytest.fixture(autouse=True)
def rule_plans(request):
    """The tests here hold the kernels at the fitted rules' plans
    (``wgmma_plan``, ``skinny_plan``, ``tiny_kv_plan``, ``kernel_name``),
    which their expected launch keys name; the autotune table, which the
    routes read first, is off for them, but for the tests that tune a table
    of their own (``empty_table``: test_gpu_tuned_plans_hold_the_plain_versions)."""
    if "empty_table" in request.fixturenames:
        yield
        return
    with tautotune.disabled():
        yield


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d,h,sq,sk,tol", [
    (torch.bfloat16, 64, 4, 200, 77, 2e-2),    # cross, tiny-KV kernel, ragged tiles
    (torch.bfloat16, 64, 2, 300, 300, 2e-2),   # self, several KV tiles
    (torch.float32, 512, 1, 100, 130, 1e-4),   # VAE head dim, 3xTF32 kernel
    (torch.float32, 64, 2, 70, 33, 1e-4),
])
def test_gpu_attention_kernel_vs_plain(cuda_device, dtype, d, h, sq, sk, tol):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    qkv = torch.randn((2, sq, 3 * h * d), generator=gen, device=cuda_device).to(dtype)
    kv = torch.randn((2, sk, 2 * h * d), generator=gen, device=cuda_device).to(dtype)
    q = qkv[..., : h * d]
    before = tfa.LAUNCHES.count
    for out, ref in [
        (tfa.flash_attention_qkv(qkv, num_heads=h),
         tfa.attention_plain(*qkv.chunk(3, -1), num_heads=h)),
        (tfa.flash_attention_kv(q.contiguous(), kv, num_heads=h),
         tfa.attention_plain(q, *kv.chunk(2, -1), num_heads=h)),
    ]:
        err = (out.float() - ref.float()).abs().max().item()
        assert err <= tol * ref.float().abs().max().item()
    assert tfa.LAUNCHES.count == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("d,h,sq,sk,form,cls", [
    (40, 2, 200, 77, "kv", "K5"),      # SD1.5 cross: tiny-KV kernel, padded head dim
    (80, 2, 130, 77, "kv", "K5"),
    (160, 2, 64, 64, "qkv", "K5"),     # SD1.5 mid self-attention
    (64, 3, 50, 100, "kv", "K5"),      # d=64 with 3 heads does not pack
    (40, 2, 100, 17, "kv", "K5"),      # 15 pad keys in the last k16 step: the
    (160, 2, 64, 33, "kv", "K5"),      # mask, not the tolerance, keeps them out
    (40, 2, 300, 300, "qkv", "K4"),    # several KV tiles, ragged last tile
    (80, 2, 256, 256, "qkv", "K4"),
    (160, 2, 256, 256, "qkv", "K4"),
    (40, 2, 1100, 1100, "qkv", "K3"),  # past one JAX KV block
    (64, 1, 70, 130, "kv", "K3"),      # h=1
])
def test_gpu_attention_routes_by_class(cuda_device, d, h, sq, sk, form, cls):
    """Each (d, Sk) class of the SD1.5 path against the plain version, bf16;
    the launch is counted under the Pallas kernel it stands in for."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    c = h * d
    if form == "qkv":
        qkv = torch.randn((2, sq, 3 * c), generator=gen, device=cuda_device).to(torch.bfloat16)
        run = lambda: tfa.flash_attention_qkv(qkv, num_heads=h)
        ref = tfa.attention_plain(*qkv.chunk(3, -1), num_heads=h)
    else:
        q = torch.randn((2, sq, c), generator=gen, device=cuda_device).to(torch.bfloat16)
        kv = torch.randn((2, sk, 2 * c), generator=gen, device=cuda_device).to(torch.bfloat16)
        run = lambda: tfa.flash_attention_kv(q, kv, num_heads=h)
        ref = tfa.attention_plain(q, *kv.chunk(2, -1), num_heads=h)
    assert tfa.attention_class(h, d, sk) == cls
    before = dict(tfa.LAUNCHES.by_key)
    out = run()
    torch.cuda.synchronize()
    new = {k: n - before.get(k, 0) for k, n in tfa.LAUNCHES.by_key.items()
           if n != before.get(k, 0)}
    kernel = "tinykv_wgmma_bf16" if sk <= 128 else "wgmma_bf16"
    assert new == {f"{cls} {kernel} b=2 h={h} d={d} sq={sq} sk={sk}": 1}
    assert _rel_err(out, ref) <= 2e-2


def _wgmma_attention(q_buf, q_off, k_buf, k_off, v_buf, v_off, *, sq, sk, h, d):
    """attn_wgmma_bf16 launched at any class (SD1.5's d = 40, 80, 160 go to
    the tiny-KV kernel below 129 keys); one launch, under its own key."""
    before = dict(tfa.LAUNCHES.by_key)
    out = tfa._launch(q_buf, q_off, k_buf, k_off, v_buf, v_off, sq=sq, sk=sk, num_heads=h, d=d,
                      scale=None, kernel="wgmma_bf16")
    torch.cuda.synchronize()
    new = {k: n - before.get(k, 0) for k, n in tfa.LAUNCHES.by_key.items()
           if n != before.get(k, 0)}
    assert list(new.values()) == [1] and next(iter(new)).split()[1] == "wgmma_bf16"
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("sk", [1, 77, 1023, 1024, 4096])
@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_gpu_wgmma_attention_cross_vs_plain(cuda_device, d, sk):
    """q a column slice of a fused QKV buffer, k and v column slices of the
    first Sk rows of a wider fused KV buffer whose rows past Sk hold 1e4:
    keys past Sk must give p = 0 and their values must never be read. Sq =
    200 is no multiple of the 128-row query tile."""
    h, sq = 2, 200
    c = h * d
    gen = torch.Generator(device=cuda_device).manual_seed(d + sk)
    qkv = torch.randn((2, sq, 3 * c), generator=gen, device=cuda_device).to(torch.bfloat16)
    kv = torch.randn((2, sk + 70, 2 * c), generator=gen, device=cuda_device).to(torch.bfloat16)
    kv[:, sk:] = 1e4
    kv_rows = kv[:, :sk]
    out = _wgmma_attention(qkv, c, kv_rows, 0, kv_rows, c, sq=sq, sk=sk, h=h, d=d)
    ref = tfa.attention_plain(qkv[..., c:2 * c], kv_rows[..., :c], kv_rows[..., c:], num_heads=h)
    assert torch.isfinite(out).all()
    assert _rel_err(out, ref) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("s", [77, 200, 1023])
@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_gpu_wgmma_attention_self_vs_plain(cuda_device, d, s):
    """Self-attention read out of one fused (B, S, 3C) buffer: three column
    slices of one tensor map's rows, the last head's V box past the buffer's
    last column."""
    h = 3
    c = h * d
    gen = torch.Generator(device=cuda_device).manual_seed(d * s)
    qkv = torch.randn((2, s, 3 * c), generator=gen, device=cuda_device).to(torch.bfloat16)
    out = _wgmma_attention(qkv, 0, qkv, c, qkv, 2 * c, sq=s, sk=s, h=h, d=d)
    assert _rel_err(out, tfa.attention_plain(*qkv.chunk(3, -1), num_heads=h)) <= 2e-2


def _tf32_attention_key(b, h, d, sq, sk):
    return f"K3 wgmma_tf32x3 b={b} h={h} d={d} sq={sq} sk={sk}"


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 2])
@pytest.mark.parametrize("d", [64, 512])
@pytest.mark.parametrize("sq", [4097, 16384])
@pytest.mark.parametrize("sk", [1, 77, 300, 16384])
def test_gpu_tf32_attention_vs_plain(cuda_device, sk, sq, d, b):
    """The f32 attention (two 3xTF32 GEMM launches a chunk of query rows)
    against attention_plain at full f32 (TF32 off): one key, ragged key
    tiles, the VAE's 16384; Sq = 4097 one row past a chunk boundary (4096
    rows at b = 1, Sk = 16384); h = 1 as in the VAE."""
    gen = torch.Generator(device=cuda_device).manual_seed(sk + sq + d + b)
    q = torch.randn((b, sq, d), generator=gen, device=cuda_device)
    k, v = (torch.randn((b, sk, d), generator=gen, device=cuda_device) for _ in range(2))
    before = dict(tfa.LAUNCHES.by_key)
    out = tfa.flash_attention(q, k, v, num_heads=1)
    torch.cuda.synchronize()
    assert _new_keys(tfa.LAUNCHES, before) == {_tf32_attention_key(b, 1, d, sq, sk): 1}
    assert torch.isfinite(out).all()
    assert _rel_err(out, tfa.attention_plain(q, k, v, num_heads=1)) <= 1e-4
    assert torch.equal(out, tfa.flash_attention(q, k, v, num_heads=1))  # no atomics


@pytest.mark.gpu
@pytest.mark.parametrize("sk", [1, 77, 300])
@pytest.mark.parametrize("d,h", [(512, 1), (64, 3)])
def test_gpu_tf32_attention_masks_keys_past_sk(cuda_device, d, h, sk):
    """k and v column slices of the first Sk rows of a wider fused KV buffer
    whose rows past Sk hold 1e4, q a column slice of a fused QKV buffer:
    the keys past Sk (TMA's zero rows, up to the 128-key tile) must give p =
    0 and the planted rows must never be read."""
    c = h * d
    gen = torch.Generator(device=cuda_device).manual_seed(3 * sk + d)
    qkv = torch.randn((2, 130, 3 * c), generator=gen, device=cuda_device)
    kv = torch.randn((2, sk + 70, 2 * c), generator=gen, device=cuda_device)
    kv[:, sk:] = 1e4
    kv_rows = kv[:, :sk]
    q = qkv[..., c:2 * c]
    out = tfa.flash_attention_kv(q, kv_rows, num_heads=h)
    ref = tfa.attention_plain(q, kv_rows[..., :c], kv_rows[..., c:], num_heads=h)
    assert torch.isfinite(out).all()
    assert _rel_err(out, ref) <= 1e-4


@pytest.mark.gpu
def test_gpu_attention_refuses_what_no_kernel_takes(cuda_device):
    """Head dims and dtypes outside the kernels' table, and misaligned bf16
    operands, raise on a CUDA tensor; nothing runs the plain version."""
    before = tfa.LAUNCHES.count
    q96 = torch.randn((1, 8, 2 * 96), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q96, q96, q96, num_heads=2)
    q40 = torch.randn((1, 8, 80), device=cuda_device)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q40, q40, q40, num_heads=2)  # f32 takes d = 64, 512
    buf = torch.randn((1, 8, 2 * 40 + 4), device=cuda_device, dtype=torch.bfloat16)
    q = buf[..., 4:]
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_attention(q, q, q, num_heads=2)
    assert tfa.LAUNCHES.count == before


# the SD1.5 512^2 path's K5 launches (CFG batch 2, 8 heads): cross against
# 77 keys at the three levels, the mid block's self-attention over 64
SD15_K5 = [(40, 4096, 77, "kv"), (80, 1024, 77, "kv"), (160, 256, 77, "kv"),
           (160, 64, 64, "qkv")]


def _tinykv(d, sq, sk, form, h=8, seed=0):
    """Operands of a K5 launch (bf16; q and the fused buffers) and its two
    runs: the wrapper and the plain version."""
    c = h * d
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if form == "qkv":
        qkv = torch.randn((2, sq, 3 * c), generator=gen, device="cuda").to(torch.bfloat16)
        return (lambda: tfa.flash_attention_qkv(qkv, num_heads=h),
                lambda: tfa.attention_plain(*qkv.chunk(3, -1), num_heads=h))
    q = torch.randn((2, sq, c), generator=gen, device="cuda").to(torch.bfloat16)
    kv = torch.randn((2, sk, 2 * c), generator=gen, device="cuda").to(torch.bfloat16)
    return (lambda: tfa.flash_attention_kv(q, kv, num_heads=h),
            lambda: tfa.attention_plain(q, *kv.chunk(2, -1), num_heads=h))


@pytest.mark.gpu
@pytest.mark.parametrize("d,sq,sk,form", SD15_K5)
def test_gpu_tinykv_at_sd15_shapes(cuda_device, d, sq, sk, form):
    """attn_tinykv_wgmma_bf16 at the SD1.5 path's full K5 shapes, against
    attention_plain; one launch under its class and kernel; a second launch
    gives the same bits (no atomics, a fixed order)."""
    run, plain = _tinykv(d, sq, sk, form, seed=d + sq)
    assert tfa.attention_class(8, d, sk) == "K5"
    before = dict(tfa.LAUNCHES.by_key)
    out = run()
    torch.cuda.synchronize()
    assert _new_keys(tfa.LAUNCHES, before) == {
        f"K5 tinykv_wgmma_bf16 b=2 h=8 d={d} sq={sq} sk={sk}": 1}
    assert torch.isfinite(out).all()
    assert _rel_err(out, plain()) <= 2e-2
    assert torch.equal(run(), out)


@pytest.mark.gpu
@pytest.mark.parametrize("h,sq", [(10, 4096), (20, 1024)])
def test_gpu_tinykv_runs_sdxl_cross_attention_as_k1(cuda_device, h, sq):
    """SDXL's cross-attention (d = 64 heads packed, 77 keys) on the tiny-KV
    kernel at its full shapes, counted under K1; the same bits twice."""
    run, plain = _tinykv(64, sq, 77, "kv", h=h, seed=h)
    before = dict(tfa.LAUNCHES.by_key)
    out = run()
    torch.cuda.synchronize()
    assert _new_keys(tfa.LAUNCHES, before) == {
        f"K1 tinykv_wgmma_bf16 b=2 h={h} d=64 sq={sq} sk=77": 1}
    assert _rel_err(out, plain()) <= 2e-2
    assert torch.equal(run(), out)


@pytest.mark.gpu
@pytest.mark.parametrize("sk", [1, 17, 64, 77, 128])
@pytest.mark.parametrize("d", [40, 64, 80, 160])
def test_gpu_tinykv_key_counts_vs_plain(cuda_device, d, sk):
    """One key, a ragged k16 step, exactly one and two 64-key halves: k and
    v are column slices of the first Sk rows of a wider fused KV buffer
    whose rows past Sk hold 1e4, so a key past Sk that was not masked, or a
    V row read past Sk, shows. Sq = 300 walks three query tiles, the last
    ragged; h = 3 does not pack at d = 64."""
    h, sq = 3, 300
    c = h * d
    gen = torch.Generator(device=cuda_device).manual_seed(5 * d + sk)
    q = torch.randn((2, sq, c), generator=gen, device=cuda_device).to(torch.bfloat16)
    kv = torch.randn((2, sk + 40, 2 * c), generator=gen, device=cuda_device).to(torch.bfloat16)
    kv[:, sk:] = 1e4
    kv_rows = kv[:, :sk]
    before = dict(tfa.LAUNCHES.by_key)
    out = tfa.flash_attention_kv(q, kv_rows, num_heads=h)
    torch.cuda.synchronize()
    assert [k.split()[:2] for k in _new_keys(tfa.LAUNCHES, before)] == [
        ["K5", "tinykv_wgmma_bf16"]]
    assert torch.isfinite(out).all()
    ref = tfa.attention_plain(q, kv_rows[..., :c], kv_rows[..., c:], num_heads=h)
    assert _rel_err(out, ref) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("tiles", [1, 2, 3, 4])
def test_gpu_tinykv_any_tile_plan(cuda_device, tiles, monkeypatch):
    """The kernel's result does not depend on how many query tiles a block
    takes (up to its 64 KB of Q; a block's last tiles past Sq): the same
    bits at every plan, and tiny_kv_plan's own among them."""
    run, plain = _tinykv(40, 1000, 77, "kv", seed=3)
    want = run()
    monkeypatch.setattr(tfa, "tiny_kv_plan", lambda b, h, sq, d: tfa.TinyKvPlan(tiles, 0))
    tfa._route.cache_clear()
    try:
        got = run()
    finally:
        monkeypatch.undo()
        tfa._route.cache_clear()
    assert torch.equal(got, want)
    assert _rel_err(got, plain()) <= 2e-2


@pytest.mark.gpu
def test_gpu_tinykv_refuses_misaligned_and_long_kv(cuda_device):
    """A misaligned bf16 operand raises before any launch, as for the other
    kernels; more than 128 keys on the tiny-KV kernel raises."""
    before = tfa.LAUNCHES.count
    buf = torch.randn((2, 64, 8 * 40 + 4), device=cuda_device, dtype=torch.bfloat16)
    kv = torch.randn((2, 77, 2 * 8 * 40), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):
        tfa.flash_attention_kv(buf[..., 4:], kv, num_heads=8)
    with pytest.raises(ValueError, match="aligned"):
        tfa._launch(buf, 4, kv, 0, kv, 320, sq=64, sk=77, num_heads=8, d=40, scale=None)
    long_kv = torch.randn((2, 129, 2 * 8 * 40), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="at most 128 keys"):
        tfa._launch(buf[..., :320].contiguous(), 0, long_kv, 0, long_kv, 320, sq=64, sk=129,
                    num_heads=8, d=40, scale=None, kernel="tinykv_wgmma_bf16")
    assert tfa.LAUNCHES.count == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,cin,cout,tol", [
    (torch.bfloat16, 64, 96, 2e-2), (torch.bfloat16, 4, 3, 2e-2),
    (torch.float32, 32, 40, 1e-4), (torch.float32, 3, 5, 1e-4),
])
def test_gpu_conv_kernel_vs_plain(cuda_device, dtype, cin, cout, tol):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    x = torch.randn((2, 13, 17, cin), generator=gen, device=cuda_device).to(dtype)
    w = (torch.randn((3, 3, cin, cout), generator=gen, device=cuda_device)
         / (9 * cin) ** 0.5).to(dtype)
    bias = torch.randn((2, cout), generator=gen, device=cuda_device)
    res = torch.randn((2, 13, 17, cout), generator=gen, device=cuda_device).to(dtype)
    out = tconv.conv3x3(x, w, bias, residual=res, act="silu")
    ref = tconv.conv3x3_plain(x, w, bias, residual=res, act="silu")
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= tol * ref.float().abs().max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout,bias_kind,res,act", [
    (128, 128, "shared", True, None),    # the VAE's resnet conv2 form
    (256, 128, "batch", False, "silu"),
    (512, 512, "shared", True, "silu"),  # two column tiles
    (128, 3, "shared", False, None),     # conv_out: Cout padded to 8, 3 stored
    (128, 40, "batch", True, None),
    (64, 8, None, False, "silu"),
    (24, 16, "shared", True, None),      # a ragged 32-channel chunk
])
def test_gpu_tf32_conv_vs_plain(cuda_device, cin, cout, bias_kind, res, act):
    """conv_wgmma_tf32x3 against the f32 plain conv (TF32 off): every
    epilogue form, ragged pixel tiles and the image borders (13 x 17)."""
    gen = torch.Generator(device=cuda_device).manual_seed(cin + cout)
    x = torch.randn((2, 13, 17, cin), generator=gen, device=cuda_device)
    w = torch.randn((3, 3, cin, cout), generator=gen, device=cuda_device) / (9 * cin) ** 0.5
    bias = (None if bias_kind is None else
            torch.randn((2, cout) if bias_kind == "batch" else (cout,), generator=gen,
                        device=cuda_device))
    r = torch.randn((2, 13, 17, cout), generator=gen, device=cuda_device) if res else None
    before = dict(tconv.LAUNCHES.by_key)
    out = tconv.conv3x3(x, w, bias, residual=r, act=act)
    torch.cuda.synchronize()
    assert [k.split()[0] for k in _new_keys(tconv.LAUNCHES, before)] == ["wgmma_tf32x3"]
    assert _rel_err(out, tconv.conv3x3_plain(x, w, bias, residual=r, act=act)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cout", [((1, 128, 128, 4), 512), ((1, 37, 53, 4), 512),
                                        ((2, 37, 53, 3), 70), ((1, 9, 33, 1), 5)])
@pytest.mark.parametrize("bias_kind,res,act", [("shared", False, None), ("batch", True, "silu"),
                                               ("bf16", True, None), (None, False, "silu")])
def test_gpu_direct_conv_vs_plain(cuda_device, shape, cout, bias_kind, res, act):
    """conv_direct_f32 (Cin <= 4) against the f32 plain conv (TF32 off)
    within 1e-5 of the largest output: the VAE decoder's conv_in at 128^2,
    ragged row segments (W = 53, 33) and rows, Cout odd and below a block's
    512, every epilogue form; one launch of the direct kernel; the same bits
    twice."""
    gen = torch.Generator(device=cuda_device).manual_seed(sum(shape) + cout)
    x = torch.randn(shape, generator=gen, device=cuda_device)
    cin = shape[3]
    w = torch.randn((3, 3, cin, cout), generator=gen, device=cuda_device) / (9 * cin) ** 0.5
    bias = (None if bias_kind is None else
            torch.randn((shape[0], cout) if bias_kind == "batch" else (cout,), generator=gen,
                        device=cuda_device))
    if bias_kind == "bf16":
        bias = bias.to(torch.bfloat16)
    r = torch.randn((*shape[:3], cout), generator=gen, device=cuda_device) if res else None
    before = dict(tconv.LAUNCHES.by_key)
    out = tconv.conv3x3(x, w, bias, residual=r, act=act)
    torch.cuda.synchronize()
    b, h, wd, _ = shape
    assert _new_keys(tconv.LAUNCHES, before) == {f"direct_f32 b={b} {h}x{wd} {cin}->{cout}": 1}
    assert _rel_err(out, tconv.conv3x3_plain(x, w, bias, residual=r, act=act)) <= 1e-5
    assert torch.equal(tconv.conv3x3(x, w, bias, residual=r, act=act), out)


@pytest.mark.gpu
@pytest.mark.parametrize("cin,gn,offset", [(12, False, 0), (8, False, 1), (4, True, 0),
                                           (32, True, 0)])
def test_gpu_scalar_conv_on_the_shapes_it_keeps(cuda_device, cin, gn, offset):
    """conv_scalar takes what neither the direct nor the 3xTF32 kernel
    does: f32 Cin > 4 that is no multiple of 8, an f32 base off 16 bytes at
    Cin % 8 == 0, and the GroupNorm prologue in f32; against the plain
    versions (TF32 off)."""
    gen = torch.Generator(device=cuda_device).manual_seed(cin + offset)
    n = 2 * 11 * 13 * cin
    x = torch.randn(n + offset, generator=gen, device=cuda_device)[offset:].view(2, 11, 13, cin)
    w = torch.randn((3, 3, cin, 24), generator=gen, device=cuda_device) / (9 * cin) ** 0.5
    bias = torch.randn((2, 24), generator=gen, device=cuda_device)
    r = torch.randn((2, 11, 13, 24), generator=gen, device=cuda_device)
    assert tconv.conv_variant(tuple(x.shape), 24, torch.float32, x.data_ptr() % 16 == 0,
                              gn) == "scalar"
    counter = tconv.GN_LAUNCHES if gn else tconv.LAUNCHES
    before = dict(counter.by_key)
    if gn:
        scale = torch.rand((2, cin), generator=gen, device=cuda_device) + 0.5
        shift = torch.randn((2, cin), generator=gen, device=cuda_device)
        out = tconv.gn_conv3x3(x, scale, shift, w, bias, residual=r, act="silu")
        ref = tconv.gn_conv3x3_plain(x, scale, shift, w, bias, residual=r, act="silu")
    else:
        out = tconv.conv3x3(x, w, bias, residual=r, act="silu")
        ref = tconv.conv3x3_plain(x, w, bias, residual=r, act="silu")
    torch.cuda.synchronize()
    assert [k.split()[0] for k in _new_keys(counter, before)] == ["scalar"]
    assert _rel_err(out, ref) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("cout", [128, 3])
def test_gpu_tf32_conv_at_1024(cuda_device, cout):
    """The VAE decoder's last level: 1024^2, 128 channels in."""
    gen = torch.Generator(device=cuda_device).manual_seed(cout)
    x = torch.randn((1, 1024, 1024, 128), generator=gen, device=cuda_device)
    w = torch.randn((3, 3, 128, cout), generator=gen, device=cuda_device) / (9 * 128) ** 0.5
    bias = torch.randn((cout,), generator=gen, device=cuda_device)
    out = tconv.conv3x3(x, w, bias)
    assert _rel_err(out, tconv.conv3x3_plain(x, w, bias)) <= 1e-4


@pytest.mark.gpu
def test_gpu_routing_and_refusals(cuda_device):
    """On a CUDA tensor the binding's op reaches the kernel (its counter
    moves) or, for shapes routed to the plain conv, launches nothing; what
    a kernel does not take raises instead of running a plain version."""
    x = torch.randn((1, 8, 8, 16), device=cuda_device, dtype=torch.bfloat16)
    w = torch.randn((3, 3, 16, 16), device=cuda_device, dtype=torch.bfloat16) * 0.1
    before = tconv.LAUNCHES.count
    tconv.conv2d_direct(x, w)
    assert tconv.LAUNCHES.count == before + 1
    tconv.conv2d_direct(x, w, stride=2)
    assert tconv.LAUNCHES.count == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        tconv.conv3x3(x.transpose(1, 2), w)
    q = torch.randn((1, 8, 64), device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dims"):
        tfa.flash_attention(q, q, q, num_heads=2)  # d=32
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tfa.flash_attention(q.half(), q.half(), q.half(), num_heads=1)


def _rel_err(out, ref):
    return ((out.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


# every GroupNorm shape of the paths, (B, H, W, C) and dtype: SDXL-base
# 1024^2 (the fused conv's prologue at 128^2 x 320 / 640 / 960, 64^2 x 1280 /
# 1920, 32^2 x 2560; the Transformer2D GroupNorms at 64^2 x 640 and 32^2 x
# 1280) and the refiner's 64^2 x 768 at CFG batch 2 in bf16; SD1.5 512^2 and
# SD2.x 768^2 at their levels; the f32 VAE decoder at batch 1 from 128^2 x
# 512 through 1024^2 x 256 and x 128
PATH_GN = [((2, 128, 128, 320), torch.bfloat16), ((2, 128, 128, 640), torch.bfloat16),
           ((2, 128, 128, 960), torch.bfloat16), ((2, 64, 64, 640), torch.bfloat16),
           ((2, 64, 64, 768), torch.bfloat16), ((2, 64, 64, 1280), torch.bfloat16),
           ((2, 64, 64, 1920), torch.bfloat16), ((2, 32, 32, 1280), torch.bfloat16),
           ((2, 32, 32, 2560), torch.bfloat16),
           ((2, 64, 64, 320), torch.bfloat16), ((2, 32, 32, 640), torch.bfloat16),
           ((2, 16, 16, 1280), torch.bfloat16), ((2, 8, 8, 2560), torch.bfloat16),
           ((2, 96, 96, 320), torch.bfloat16), ((2, 48, 48, 640), torch.bfloat16),
           ((2, 24, 24, 1280), torch.bfloat16), ((2, 12, 12, 2560), torch.bfloat16),
           ((1, 128, 128, 512), torch.float32), ((1, 256, 256, 512), torch.float32),
           ((1, 512, 512, 512), torch.float32), ((1, 512, 512, 256), torch.float32),
           ((1, 1024, 1024, 256), torch.float32), ((1, 1024, 1024, 128), torch.float32)]


def _k9_holds(fn, x, other):
    """The K9 contract beyond its tolerance, for ``fn`` (a GroupNorm or its
    stats and fold) of NHWC x: the same bits in a second run; image 0 the
    same bits alone and in batches of 2 and 4 (``other`` fills the rest);
    and a CUDA graph of ``fn``, replayed twice, equal to eager bit for bit
    each time (the tickets start from zero on every replay)."""
    def same(a, b):
        a, b = (t if isinstance(t, tuple) else (t,) for t in (a, b))
        return all(torch.equal(u, v) for u, v in zip(a, b))

    def first(t):
        return tuple(u[:1] for u in t) if isinstance(t, tuple) else t[:1]

    eager = fn(x)
    assert same(fn(x), eager)
    alone = fn(x[:1].contiguous())
    for n in (2, 4):
        batch = torch.cat([x[:1]] + [other[:1]] * (n - 1))
        assert same(first(fn(batch)), alone)
    static = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(static)  # the eager warm-up a capture wants, on the capture's stream
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = fn(static)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert same(out, eager)
    del graph


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,act,tol", [
    (torch.bfloat16, (2, 9, 7, 64), None, 2e-2),     # vector loads, ragged chunks
    (torch.bfloat16, (3, 16, 16, 40), "silu", 2e-2),  # C/8 = 5 vectors: a masked slab
    (torch.float32, (1, 33, 31, 128), "silu", 1e-4),
    (torch.float32, (2, 5, 6, 12), None, 1e-4),      # C % 8, f32 vector width 4
] + [(dtype, shape, "silu" if dtype == torch.float32 else None,
      2e-2 if dtype == torch.bfloat16 else 1e-4) for shape, dtype in PATH_GN])
def test_gpu_group_norm_kernel_vs_plain(cuda_device, dtype, shape, act, tol):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    x = (torch.randn(shape, generator=gen, device=cuda_device) * 3 + 1).to(dtype)
    g = torch.randn(shape[3], generator=gen, device=cuda_device).to(dtype)
    b = torch.randn(shape[3], generator=gen, device=cuda_device).to(dtype)
    before = tgn.LAUNCHES.count
    out = tgn.group_norm(x, g, b, num_groups=4, act=act)
    assert tgn.LAUNCHES.count == before + 1
    assert _rel_err(out, tgn.group_norm_plain(x, g, b, num_groups=4, act=act)) <= tol
    # the stats are the same bits in every run and at every batch size
    again = tgn.group_norm(torch.cat([x, x]), g, b, num_groups=4, act=act)
    assert torch.equal(again[: shape[0]], out) and torch.equal(again[shape[0]:], out)
    other = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    _k9_holds(lambda t: tgn.group_norm(t, g, b, num_groups=4, act=act), x, other)


def _bf16_ulps(out, ref):
    """The largest |out - ref| in bf16 ulps (8 significant bits) of the
    largest |ref|: the outputs' scale. (An output that cancels to near 0
    carries the f32 rounding of x * scale + shift, far more of its own
    tiny ulps.)"""
    ulp = 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)
    return ((out.float() - ref.float()).abs().max() / ulp).item()


# K9 at a Transformer2D's and a resnet's shape of SDXL, the f32 decoder's
# smallest and largest, then C not a multiple of the vector (vec = 1)
GN_SHAPES = [((2, 64, 64, 640), torch.bfloat16, None),
             ((2, 128, 128, 320), torch.bfloat16, "silu"),
             ((1, 128, 128, 512), torch.float32, "silu"),
             ((1, 1024, 1024, 128), torch.float32, "silu"),
             ((2, 9, 7, 20), torch.bfloat16, "silu"),
             ((3, 5, 6, 10), torch.float32, None)] + [
    (shape, dtype, "silu") for shape, dtype in PATH_GN if shape not in (
        (2, 64, 64, 640), (2, 128, 128, 320), (1, 128, 128, 512), (1, 1024, 1024, 128))]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,act", GN_SHAPES)
def test_gpu_group_norm_one_entry_vs_plain(cuda_device, shape, dtype, act):
    """st_group_norm (stats and device fold, apply) against
    group_norm_plain: within 1 bf16 ulp of the largest output, or 1e-5 of
    the largest f32 output (the moments are summed in another order); one
    launch counted; the same bits in a second run, for image 0 alone and in
    batches of two and four, and in two graph replays."""
    groups = 32 if shape[3] % 32 == 0 else 5
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    x = (torch.randn(shape, generator=gen, device=cuda_device) * 2 + 0.5).to(dtype)
    g = (torch.randn(shape[3], generator=gen, device=cuda_device) + 1).to(dtype)
    b = torch.randn(shape[3], generator=gen, device=cuda_device).to(dtype)
    before = tgn.LAUNCHES.count
    out = tgn.group_norm(x, g, b, num_groups=groups, act=act)
    assert tgn.LAUNCHES.count == before + 1
    ref = tgn.group_norm_plain(x, g, b, num_groups=groups, act=act)
    if dtype == torch.bfloat16:
        assert _bf16_ulps(out, ref) <= 1
    else:
        assert _rel_err(out, ref) <= 1e-5
    assert torch.equal(tgn.group_norm(x, g, b, num_groups=groups, act=act), out)
    other = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    if x.numel() <= 2**23:
        pair = tgn.group_norm(torch.cat([x[:1], other[:1]]), g, b, num_groups=groups, act=act)
        assert torch.equal(pair[:1], out[:1])
    _k9_holds(lambda t: tgn.group_norm(t, g, b, num_groups=groups, act=act), x, other)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,groups,pdtype", [
    ((2, 32, 32, 320), torch.bfloat16, 32, torch.float32),   # 10 channels a group
    ((2, 16, 16, 2560), torch.bfloat16, 32, torch.bfloat16),  # 80
    ((1, 33, 31, 128), torch.float32, 32, torch.float32),
    ((2, 5, 6, 80), torch.float32, 16, torch.bfloat16),       # 5: straddles the vectors
] + [(shape, dtype, 32, dtype) for shape, dtype in PATH_GN])
def test_gpu_group_norm_fold_vs_plain(cuda_device, shape, dtype, groups, pdtype):
    """st_group_norm_fold's scale / shift against fold(moments_plain(x))
    within 1e-5 (the moments' summation order), gamma / beta read in their
    own dtype; K9 is the apply kernel on exactly these scale / shift, bit
    for bit, the values K8's prologue reads; the same bits in a second run,
    for image 0 alone and in batches of two and four, and in two graph
    replays."""
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    x = (torch.randn(shape, generator=gen, device=cuda_device) * 3 - 1).to(dtype)
    g = (torch.randn(shape[3], generator=gen, device=cuda_device) * 0.2 + 1).to(pdtype)
    b = torch.randn(shape[3], generator=gen, device=cuda_device).to(pdtype)
    scale, shift = tgn.scale_shift(x, g, b, num_groups=groups, eps=1e-5)
    s1, s2 = tgn.moments_plain(x)
    rs, rh = tgn.fold(s1, s2, g, b, hw=shape[1] * shape[2], num_groups=groups, eps=1e-5)
    assert scale.dtype == shift.dtype == torch.float32 and scale.shape == (shape[0], shape[3])
    assert _rel_err(scale, rs) <= 1e-5 and _rel_err(shift, rh) <= 1e-5
    assert torch.equal(tgn.group_norm(x, g, b, num_groups=groups, act="silu"),
                       tgn.apply(x, scale.contiguous(), shift.contiguous(), "silu"))
    other = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    _k9_holds(lambda t: tgn.scale_shift(t, g, b, num_groups=groups, eps=1e-5), x, other)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [((1, 16, 16, 64), torch.float32)] + PATH_GN)
def test_gpu_group_norm_clamps_a_near_constant_group(cuda_device, shape, dtype):
    """C3: x = 1000 + N(0, 1e-3), where E[x^2] - mean^2 rounds below 0 in
    f32; the fold kernel clamps it, so every output is finite and every
    group's rstd is at most rsqrt(eps), through the GroupNorm, its stats and
    fold, and a graph replay of both."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    c = shape[3]
    for c0 in (1000.0, 3000.0):
        x = (torch.randn(shape, generator=gen, device=cuda_device) * 1e-3 + c0).to(dtype)
        ones = torch.ones(c, device=cuda_device)
        out = tgn.group_norm(x, ones, torch.zeros_like(ones), num_groups=32)
        assert torch.isfinite(out).all()
        scale, _ = tgn.scale_shift(x, ones, torch.zeros_like(ones), num_groups=32)
        assert (scale <= (1 + 1e-6) / math.sqrt(1e-5)).all()  # rstd at most rsqrt(eps)
    _k9_holds(lambda t: tgn.group_norm(t, ones, torch.zeros_like(ones), num_groups=32), x, x)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rows,c,rms,affine,tol", [
    (torch.bfloat16, 37, 640, False, True, 2e-2),   # 80 vectors: a masked tail
    (torch.bfloat16, 16, 1280, True, True, 2e-2),
    (torch.float32, 9, 96, False, False, 1e-4),     # gamma = beta = None
    (torch.float32, 8, 1024, True, False, 1e-4),
    (torch.float32, 19, 2048, False, True, 1e-4),   # 16 f32 vectors a lane, the most
])
def test_gpu_layer_norm_kernel_vs_plain(cuda_device, dtype, rows, c, rms, affine, tol):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = (torch.randn((rows, c), generator=gen, device=cuda_device) * 2 + 0.5).to(dtype)
    g = torch.randn(c, generator=gen, device=cuda_device).to(dtype) if affine else None
    b = torch.randn(c, generator=gen, device=cuda_device).to(dtype) if affine else None
    fn = tln.rms_norm if rms else tln.layer_norm
    out = fn(x, g, b, eps=1e-6)
    assert _rel_err(out, tln.layer_norm_plain(x, g, b, eps=1e-6, rmsnorm=rms)) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("pdtype", [torch.bfloat16, torch.float32, None])
@pytest.mark.parametrize("dtype,rows,c", [
    (torch.bfloat16, 8192, 640), (torch.bfloat16, 2048, 1280), (torch.bfloat16, 77, 320),
    (torch.float32, 300, 320), (torch.float32, 2048, 1024), (torch.float32, 2048, 1280),
    (torch.float32, 2048, 1536),
])
def test_gpu_layer_norm_at_unet_shapes(cuda_device, dtype, rows, c, pdtype):
    """K10 at the UNet's LayerNorm shapes and C = 320, gamma / beta in bf16,
    in f32 (either may differ from x's dtype) or none, LayerNorm and
    RMSNorm; the same bits twice; parameters at a base off 16 bytes take
    the element loads and give the same bits as aligned ones."""
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    x = (torch.randn((rows, c), generator=gen, device=cuda_device) * 2 + 0.3).to(dtype)
    g = b = None
    if pdtype is not None:
        g = (torch.randn(c, generator=gen, device=cuda_device) + 1).to(pdtype)
        b = torch.randn(c, generator=gen, device=cuda_device).to(pdtype)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for rms, fn in ((False, tln.layer_norm), (True, tln.rms_norm)):
        out = fn(x, g, b, eps=1e-6)
        assert torch.equal(out, fn(x, g, b, eps=1e-6))
        assert _rel_err(out, tln.layer_norm_plain(x, g, b, eps=1e-6, rmsnorm=rms)) <= tol
        if pdtype is not None:
            gbuf = torch.empty(c + 1, device=cuda_device, dtype=pdtype)
            bbuf = torch.empty(c + 1, device=cuda_device, dtype=pdtype)
            gm, bm = gbuf[1:], bbuf[1:]
            gm.copy_(g)
            bm.copy_(b)
            assert gm.data_ptr() % 16
            assert torch.equal(fn(x, gm, bm, eps=1e-6), out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n,tol", [
    (torch.bfloat16, 40, 2e-2), (torch.bfloat16, 13, 2e-2), (torch.float32, 24, 1e-4),
])
def test_gpu_geglu_kernel_on_strided_halves(cuda_device, dtype, n, tol):
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    proj = (torch.randn((2, 11, 2 * n), generator=gen, device=cuda_device) * 2).to(dtype)
    state, gate = proj.chunk(2, dim=-1)
    before = tgeglu.LAUNCHES.count
    out = tgeglu.geglu(state, gate)
    assert tgeglu.LAUNCHES.count == before + 1
    assert out.is_contiguous() and out.shape == state.shape
    assert _rel_err(out, tgeglu.geglu_plain(state, gate)) <= tol
    with pytest.raises(ValueError, match="contiguous last dim"):
        tgeglu.geglu(state.transpose(1, 2), gate.transpose(1, 2))
    with pytest.raises(ValueError, match="one row stride"):
        tgeglu.geglu(state, gate.contiguous())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,cin,cout,bias_kind,res,tol", [
    (torch.bfloat16, 64, 96, "batch", False, 2e-2),
    (torch.bfloat16, 64, 48, "shared", True, 2e-2),
    (torch.bfloat16, 32, 4, "shared", False, 2e-2),   # conv_out-like Cout = 4
    (torch.bfloat16, 12, 8, "batch", False, 2e-2),    # Cin padded to 16
    (torch.float32, 32, 40, "batch", True, 1e-4),
])
def test_gpu_gn_conv_kernel_vs_plain(cuda_device, dtype, cin, cout, bias_kind, res, tol):
    """The GroupNorm prologue, including a large shift: the SAME border must
    stay exactly zero, since normalize(0) != 0."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((2, 8, 8, cin), generator=gen, device=cuda_device).to(dtype)
    scale = torch.rand((2, cin), generator=gen, device=cuda_device) + 0.5
    shift = torch.randn((2, cin), generator=gen, device=cuda_device) + 4.0
    w = (torch.randn((3, 3, cin, cout), generator=gen, device=cuda_device)
         / (9 * cin) ** 0.5).to(dtype)
    bias = torch.randn((2, cout) if bias_kind == "batch" else (cout,), generator=gen,
                       device=cuda_device)
    r = torch.randn((2, 8, 8, cout), generator=gen, device=cuda_device).to(dtype) if res else None
    before = tconv.GN_LAUNCHES.count, tconv.LAUNCHES.count
    out = tconv.gn_conv3x3(x, scale, shift, w, bias, residual=r, gn_act="silu")
    assert (tconv.GN_LAUNCHES.count, tconv.LAUNCHES.count) == (before[0] + 1, before[1])
    ref = tconv.gn_conv3x3_plain(x, scale, shift, w, bias, residual=r, gn_act="silu")
    assert _rel_err(out, ref) <= tol


@pytest.mark.gpu
def test_gpu_fused_binding_routes_to_kernels(cuda_device):
    """gn_conv2d "fused" launches K8 on eligible shapes and composes the
    active binding's group_norm and conv2d on the rest."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import FUSED_OP_OVERRIDES, CompileConfig, resolve_binding

    x = torch.randn((2, 8, 8, 32), device=cuda_device, dtype=torch.bfloat16)
    g = torch.ones(32, device=cuda_device, dtype=torch.bfloat16)
    w3 = torch.randn((3, 3, 32, 16), device=cuda_device, dtype=torch.bfloat16) * 0.1
    counts = lambda: (tconv.GN_LAUNCHES.count, tgn.LAUNCHES.count, tconv.LAUNCHES.count)
    with ops.use_backends(resolve_binding(CompileConfig(overrides=FUSED_OP_OVERRIDES))):
        before = counts()
        ops.gn_conv2d(x, g, g, w3, num_groups=8)
        assert counts() == (before[0] + 1, before[1], before[2])
        ops.gn_conv2d(x, g, g, w3, num_groups=8, stride=2)  # strided: GN kernel + plain conv
        assert counts() == (before[0] + 1, before[1] + 1, before[2])


def _new_keys(counter, before):
    return {k: n - before.get(k, 0) for k, n in counter.by_key.items()
            if n != before.get(k, 0)}


@pytest.fixture
def force_plan(monkeypatch):
    """Replaces a planner function of wgmma_plan for one test; the wrappers'
    per-shape route caches are cleared before and after, so no forced plan
    outlives it."""
    def force(name, fn):
        monkeypatch.setattr(twp, name, fn)
        tlinear._route.cache_clear()
        tconv._wgmma_route.cache_clear()
    yield force
    tlinear._route.cache_clear()
    tconv._wgmma_route.cache_clear()


def _linear_key(kernel, m, k, n, bias, act):
    head = f"{kernel} m={m} k={k} n={n} bias={int(bias)} act={act}"
    if kernel == "wgmma_bf16":
        plan = twp.gemm_plan(m, k, n)
        return f"{head} bn={plan.bn} split={plan.splits}"
    if kernel.startswith("skinny"):
        plan = tlinear.skinny_plan(m, k, n, 2 if kernel == "skinny_bf16" else 4)
        return f"{head} cols={plan.cols} split={plan.splits}"
    return head


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,m,k,n,bias,act,kernel", [
    (torch.bfloat16, 300, 136, 200, True, None, "wgmma_bf16"),    # ragged M and N tiles
    (torch.bfloat16, 130, 37, 45, True, "gelu", "wmma_bf16"),     # K, N % 8: element loads
    (torch.bfloat16, 70, 64, 4, False, "silu", "wmma_bf16"),      # N = 4: element loads
    (torch.bfloat16, 154, 2816, 136, False, None, "wgmma_bf16"),  # precompute-like, deep K
    (torch.bfloat16, 2, 1280, 40, True, "silu", "skinny_bf16"),   # time MLP rows
    (torch.bfloat16, 12, 33, 4, False, "gelu", "skinny_bf16"),
    (torch.float32, 100, 70, 40, True, "gelu", "wgmma_tf32x3"),  # K % 4 != 0: padded
    (torch.float32, 65, 512, 130, True, None, "wgmma_tf32x3"),
    (torch.float32, 16, 300, 77, True, "silu", "skinny_f32"),
])
def test_gpu_linear_kernel_vs_plain(cuda_device, dtype, m, k, n, bias, act, kernel):
    """Every variant of K13 at ragged shapes, against its plain version,
    with the launch counted under its variant and shape."""
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(dtype)
    w = (torch.randn((k, n), generator=gen, device=cuda_device) / k**0.5).to(dtype)
    b = torch.randn(n, generator=gen, device=cuda_device).to(dtype) if bias else None
    before = dict(tlinear.LAUNCHES.by_key)
    out = tlinear.linear(x, w, b, act=act)
    torch.cuda.synchronize()
    assert _new_keys(tlinear.LAUNCHES, before) == {_linear_key(kernel, m, k, n, bias, act): 1}
    assert out.shape == (m, n) and out.dtype == dtype
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert _rel_err(out, tlinear.linear_plain(x, w, b, act=act)) <= tol


# the M <= 16 GEMMs of the SDXL and SD1.5 steps, (K, N), and ragged ones:
# N % 8 != 0 (element loads), K odd, K past one shared-memory stage of x
SKINNY_SHAPES = [(320, 1280), (1280, 320), (1280, 640), (1280, 1280), (2816, 1280),
                 (1279, 44), (333, 1001), (3000, 24)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 2, 5, 16])
@pytest.mark.parametrize("k,n", SKINNY_SHAPES)
def test_gpu_skinny_linear_vs_plain(cuda_device, k, n, m, dtype):
    """The skinny kernel at every M <= 16 shape of the steps and at ragged
    ones, against its plain version, the launch counted under its plan; a
    second launch gives the same bits (the splits meet in a fixed order)."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.nn.functional.silu(torch.randn((m, k), generator=gen, device=cuda_device)).to(dtype)
    w = (torch.randn((k, n), generator=gen, device=cuda_device) / k**0.5).to(dtype)
    b = torch.randn(n, generator=gen, device=cuda_device).to(dtype)
    act = "silu" if k == 320 else None
    kernel = "skinny_bf16" if dtype == torch.bfloat16 else "skinny_f32"
    before = dict(tlinear.LAUNCHES.by_key)
    out = tlinear.linear(x, w, b, act=act)
    again = tlinear.linear(x, w, b, act=act)
    torch.cuda.synchronize()
    assert _new_keys(tlinear.LAUNCHES, before) == {_linear_key(kernel, m, k, n, True, act): 2}
    assert torch.equal(out, again)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert _rel_err(out, tlinear.linear_plain(x, w, b, act=act)) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gpu_skinny_linear_on_misaligned_operands(cuda_device, dtype):
    """x and w at bases off 16 bytes (w then takes element loads), a bias in
    the other dtype, with and without act: right, and the same bits twice."""
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    k, n = 1280, 640
    xbuf = torch.randn(2 * k + 1, generator=gen, device=cuda_device).to(dtype)
    wbuf = (torch.randn(k * n + 1, generator=gen, device=cuda_device) / k**0.5).to(dtype)
    x, w = xbuf[1:].view(2, k), wbuf[1:].view(k, n)
    assert x.data_ptr() % 16 and w.data_ptr() % 16
    other = torch.float32 if dtype == torch.bfloat16 else torch.bfloat16
    b = torch.randn(n, generator=gen, device=cuda_device).to(other)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for act in (None, "gelu"):
        out = tlinear.linear(x, w, b, act=act)
        assert torch.equal(out, tlinear.linear(x, w, b, act=act))
        assert _rel_err(out, tlinear.linear_plain(x, w, b, act=act)) <= tol
    xa, wa = x.clone(), w.clone()  # the same values at aligned bases: 16-byte loads
    assert _rel_err(tlinear.linear(xa, wa, b), tlinear.linear(x, w, b)) <= tol


@pytest.mark.gpu
def test_gpu_linear_on_misaligned_operands(cuda_device):
    """A strided view (x[..., 1:]) is copied to a contiguous one, which TMA
    takes; a contiguous view whose base is not 16-byte aligned goes to the
    WMMA kernel's element loads. Both are right."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    buf = torch.randn((3, 50, 129), generator=gen, device=cuda_device).to(torch.bfloat16)
    w = (torch.randn((128, 64), generator=gen, device=cuda_device) / 12).to(torch.bfloat16)
    x = buf[..., 1:]
    before = dict(tlinear.LAUNCHES.by_key)
    out = tlinear.linear(x, w)
    assert out.shape == (3, 50, 64)
    assert _rel_err(out, tlinear.linear_plain(x, w)) <= 2e-2
    flat = torch.randn(150 * 128 + 1, generator=gen, device=cuda_device).to(torch.bfloat16)
    x2 = flat[1:].view(150, 128)
    assert x2.data_ptr() % 16 != 0
    out2 = tlinear.linear(x2, w, act="silu")
    assert _rel_err(out2, tlinear.linear_plain(x2, w, act="silu")) <= 2e-2
    assert _new_keys(tlinear.LAUNCHES, before) == {
        _linear_key("wgmma_bf16", 150, 128, 64, False, None): 1,
        "wmma_bf16 m=150 k=128 n=64 bias=0 act=silu": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(16384, 512, 512), (4096, 512, 512), (154, 512, 512),
                                   (300, 64, 45), (130, 70, 64), (17, 3, 1)])
@pytest.mark.parametrize("bias,act", [(None, None), (torch.float32, "silu"),
                                      (torch.bfloat16, "gelu"), (torch.float32, None)])
def test_gpu_tf32_linear_vs_plain(cuda_device, m, k, n, bias, act):
    """The f32 linear on the 3xTF32 GEMM at the VAE's shapes, odd M, odd N
    (element stores), K % 4 != 0 (zero-padded), each bias dtype and act,
    against linear_plain in full f32 (TF32 off): within 1e-5 of the
    largest output; the same bits in a second run (no atomics)."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.randn((m, k), generator=gen, device=cuda_device)
    w = torch.randn((k, n), generator=gen, device=cuda_device) / k**0.5
    b = None if bias is None else torch.randn(n, generator=gen, device=cuda_device).to(bias)
    before = dict(tlinear.LAUNCHES.by_key)
    out = tlinear.linear(x, w, b, act=act)
    torch.cuda.synchronize()
    assert _new_keys(tlinear.LAUNCHES, before) == {
        _linear_key("wgmma_tf32x3", m, k, n, b is not None, act): 1}
    assert out.shape == (m, n) and out.dtype == torch.float32
    assert _rel_err(out, tlinear.linear_plain(x, w, b, act=act)) <= 1e-5
    assert torch.equal(tlinear.linear(x, w, b, act=act), out)


@pytest.mark.gpu
def test_gpu_tf32_linear_on_misaligned_and_strided_operands(cuda_device):
    """A contiguous f32 view whose base is off 16 bytes is copied to an
    aligned base; a strided one to a contiguous one; both on the 3xTF32
    GEMM, right within 1e-5."""
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    w = torch.randn((128, 96), generator=gen, device=cuda_device) / 12
    flat = torch.randn(150 * 128 + 1, generator=gen, device=cuda_device)
    x = flat[1:].view(150, 128)
    assert x.data_ptr() % 16 != 0
    buf = torch.randn((3, 50, 129), generator=gen, device=cuda_device)
    before = dict(tlinear.LAUNCHES.by_key)
    for xi in (x, buf[..., 1:]):
        assert _rel_err(tlinear.linear(xi, w, act="silu"),
                        tlinear.linear_plain(xi, w, act="silu")) <= 1e-5
    assert _new_keys(tlinear.LAUNCHES, before) == {
        _linear_key("wgmma_tf32x3", 150, 128, 96, False, "silu"): 2}


@pytest.mark.gpu
@pytest.mark.parametrize("bn,splits", [(128, 1), (128, 2), (128, 3), (128, 9),
                                       (256, 1), (256, 2), (256, 4)])
@pytest.mark.parametrize("m,k,n,bias_dtype,act", [
    (300, 584, 200, torch.bfloat16, "gelu"),  # ragged M, N; K = 9 steps, the last of 8
    (64, 576, 8, torch.float32, None),        # N = 8: one 8-column chunk of a 64-wide box
])
def test_gpu_wgmma_linear_at_each_plan(cuda_device, force_plan, bn, splits, m, k, n,
                                       bias_dtype, act):
    """The wgmma GEMM at every tile width and split count, forced through
    the planner: right, and the same bits in a second run (the splits meet
    in a fixed order, no atomics)."""
    force_plan("gemm_plan", lambda *shape: twp.Plan(bn, splits))
    gen = torch.Generator(device=cuda_device).manual_seed(10)
    x = torch.randn((m, k), generator=gen, device=cuda_device).to(torch.bfloat16)
    w = (torch.randn((k, n), generator=gen, device=cuda_device) / k**0.5).to(torch.bfloat16)
    b = torch.randn(n, generator=gen, device=cuda_device).to(bias_dtype)
    before = dict(tlinear.LAUNCHES.by_key)
    out = tlinear.linear(x, w, b, act=act)
    again = tlinear.linear(x, w, b, act=act)
    assert _new_keys(tlinear.LAUNCHES, before) == {
        f"wgmma_bf16 m={m} k={k} n={n} bias=1 act={act} bn={bn} split={splits}": 2}
    assert torch.equal(out, again)
    assert _rel_err(out, tlinear.linear_plain(x, w, b, act=act)) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("bn,splits", [(128, 1), (128, 4), (256, 1), (256, 3), (128, 18)])
def test_gpu_wgmma_conv_at_each_plan(cuda_device, force_plan, bn, splits):
    """The wgmma conv with the per-batch (B, Cout) bias and a residual at
    forced plans: two 64-channel chunks a tap (Cin 72), ragged tiles (13 x 17
    images in 16 x 8 tiles), Cout 200 over widths of 128 and 256."""
    tile = twp.conv_tile(2, 13, 17)
    force_plan("conv_plan", lambda *a, **kw: (tile, twp.Plan(bn, splits)))
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    x = torch.randn((2, 13, 17, 72), generator=gen, device=cuda_device).to(torch.bfloat16)
    w = (torch.randn((3, 3, 72, 200), generator=gen, device=cuda_device) / 25).to(torch.bfloat16)
    bias = torch.randn((2, 200), generator=gen, device=cuda_device)
    res = torch.randn((2, 13, 17, 200), generator=gen, device=cuda_device).to(torch.bfloat16)
    before = dict(tconv.LAUNCHES.by_key)
    out = tconv.conv3x3(x, w, bias, residual=res, act="silu")
    again = tconv.conv3x3(x, w, bias, residual=res, act="silu")
    assert _new_keys(tconv.LAUNCHES, before) == {
        f"wgmma_bf16 b=2 13x17 72->200 tile=16x8x1 bn={bn} split={splits}": 2}
    assert torch.equal(out, again)
    ref = tconv.conv3x3_plain(x, w, bias, residual=res, act="silu")
    assert _rel_err(out, ref) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("hw,cin,splits", [(8, 64, 1), (8, 1280, 9), (16, 320, 1), (16, 320, 5),
                                           (16, 40, 3)])
def test_gpu_wgmma_gn_conv_border(cuda_device, force_plan, hw, cin, splits):
    """K8 on the wgmma kernel at 8 x 8 images (two to a tile) and 16 x 16
    ones: a large shift makes normalize(0) far from 0, so a border pixel or
    a channel past Cin (40: a 64-channel chunk with 24 empty) that escaped
    the register mask would show."""
    real = twp.conv_plan
    force_plan("conv_plan", lambda *a, **kw: (real(*a, **kw)[0], twp.Plan(128, splits)))
    gen = torch.Generator(device=cuda_device).manual_seed(12)
    x = torch.randn((2, hw, hw, cin), generator=gen, device=cuda_device).to(torch.bfloat16)
    scale = torch.rand((2, cin), generator=gen, device=cuda_device) + 0.5
    shift = torch.randn((2, cin), generator=gen, device=cuda_device) + 4.0
    w = (torch.randn((3, 3, cin, 64), generator=gen, device=cuda_device)
         / (9 * cin) ** 0.5).to(torch.bfloat16)
    bias = torch.randn((2, 64), generator=gen, device=cuda_device)
    before = dict(tconv.GN_LAUNCHES.by_key)
    out = tconv.gn_conv3x3(x, scale, shift, w, bias, gn_act="silu")
    keys = _new_keys(tconv.GN_LAUNCHES, before)
    assert len(keys) == 1 and next(iter(keys)).startswith("wgmma_gn_bf16 ")
    ref = tconv.gn_conv3x3_plain(x, scale, shift, w, bias, gn_act="silu")
    assert _rel_err(out, ref) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("hw,center", [(16, -3.0), (16, 0.0), (8, -6.0)])
def test_gpu_wgmma_gn_conv_operand_equals_unfused_pair(cuda_device, force_plan, hw, center):
    """K8's normalised operand is the GroupNorm apply kernel's, bit for bit:
    at Cin 64 (one channel chunk, so the taps sum in the plain conv's order)
    and one plan for both, K8 equals K9's apply followed by the wgmma conv
    exactly. Normalised values centred in SiLU's negative tail (down to -6),
    where an approximate sigmoid would round differently, and images with
    borders, which must read the normalised zero padding."""
    real = twp.conv_plan
    force_plan("conv_plan", lambda *a, **kw: (real(*a, **kw)[0], twp.Plan(128, 1)))
    gen = torch.Generator(device=cuda_device).manual_seed(13)
    x = torch.randn((2, hw, hw, 64), generator=gen, device=cuda_device).to(torch.bfloat16)
    scale = torch.rand((2, 64), generator=gen, device=cuda_device) + 0.5
    shift = torch.randn((2, 64), generator=gen, device=cuda_device) + center
    w = (torch.randn((3, 3, 64, 96), generator=gen, device=cuda_device) / 24).to(torch.bfloat16)
    bias = torch.randn((2, 96), generator=gen, device=cuda_device)
    before = dict(tconv.GN_LAUNCHES.by_key), dict(tconv.LAUNCHES.by_key)
    fused = tconv.gn_conv3x3(x, scale, shift, w, bias, act="silu", gn_act="silu")
    pair = tconv.conv3x3(tgn.apply(x, scale, shift, "silu"), w, bias, act="silu")
    (k8,), (k6,) = _new_keys(tconv.GN_LAUNCHES, before[0]), _new_keys(tconv.LAUNCHES, before[1])
    # K8 on its warp-specialised kernel (its own 8-wide tile) at K6's width
    # and split: the same K order, one chunk of 9 taps
    tile = twp.gn_conv_tile(2, hw, hw)
    assert k6.startswith("wgmma_bf16 ") and k8 == (
        f"wgmma_gn_bf16 b=2 {hw}x{hw} 64->96 tile={tile.tw}x{tile.th}x{tile.tb} bn=128 split=1 "
        f"grid={twp.gn_grid(math.prod(tile.counts(2, hw, hw)), 96, twp.Plan(128, 1))} "
        "gn_act=silu")
    assert torch.equal(fused, pair)


# (b, h, cin, cout) of K8 at Cout > 8 in the SDXL-base 1024^2 step at UNet
# batch 2 and 16 (128^2, 64^2, 32^2; Cin 320-2560), the refiner's 128^2
# 384 -> 384 and SD1.5's split 8^2 2560 -> 1280
K8_SHAPES = [(b, h, cin, cout) for b in (2, 16) for h, cin, cout in [
    (128, 320, 320), (128, 640, 320), (128, 960, 320), (64, 320, 640), (64, 640, 640),
    (64, 960, 640), (64, 1280, 640), (64, 1920, 640), (32, 640, 1280), (32, 1280, 1280),
    (32, 1920, 1280), (32, 2560, 1280)]] + [(2, 128, 384, 384), (2, 8, 2560, 1280)]


def _k8_operands(dev, b, h, cin, cout, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((b, h, h, cin), generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
    gamma = torch.rand((cin,), generator=gen, device=dev) + 0.5
    beta = torch.randn((cin,), generator=gen, device=dev)
    scale, shift = tgn.scale_shift(x, gamma, beta, num_groups=32 if cin % 32 == 0 else 8,
                                   eps=1e-5)
    w = (torch.randn((3, 3, cin, cout), generator=gen, device=dev)
         / (9 * cin) ** 0.5).to(torch.bfloat16)
    return gen, x, scale, shift, w


@pytest.mark.gpu
@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("b,h,cin,cout", K8_SHAPES)
def test_gpu_k8_at_every_sdxl_shape_vs_plain(cuda_device, b, h, cin, cout, res):
    """K8 on its warp-specialised kernel at every shape it serves in
    SDXL-base at UNet batch 2 and 16, the refiner's and SD1.5's split 8^2,
    with the per-batch bias and, with ``res``, a residual: within 2e-2 of
    gn_conv3x3_plain, launched once under the rule's plan, the same bits in
    a second run."""
    gen, x, scale, shift, w = _k8_operands(cuda_device, b, h, cin, cout, b * h + cin + res)
    bias = torch.randn((b, cout), generator=gen, device=cuda_device)
    r = (torch.randn((b, h, h, cout), generator=gen, device=cuda_device).to(torch.bfloat16)
         if res else None)
    before = dict(tconv.GN_LAUNCHES.by_key)
    out = tconv.gn_conv3x3(x, scale, shift, w, bias, residual=r, gn_act="silu")
    tile, plan = twp.conv_plan(b, h, h, cin, cout, gn=True)
    grid = twp.gn_grid(math.prod(tile.counts(b, h, h)), cout, plan)
    assert _new_keys(tconv.GN_LAUNCHES, before) == {
        f"wgmma_gn_bf16 b={b} {h}x{h} {cin}->{cout} tile=8x{tile.th}x{tile.tb} bn={plan.bn} "
        f"split={plan.splits} grid={grid} gn_act=silu": 1}
    assert torch.equal(tconv.gn_conv3x3(x, scale, shift, w, bias, residual=r, gn_act="silu"),
                       out)
    ref = tconv.gn_conv3x3_plain(x, scale, shift, w, bias, residual=r, gn_act="silu")
    assert _rel_err(out, ref) <= 2e-2


# (b, h, c, plan): each route of K8 (its tiles 8 x 16 and 8 x 8 x 2, each
# width, split and unsplit, ragged images), None for the rule's plan
K8_ROUTES = [(2, 128, 320, None), (16, 64, 640, None), (2, 32, 1280, None), (2, 8, 1280, None),
             (2, 128, 384, None), (2, 16, 320, twp.Plan(128, 1)), (2, 16, 320, twp.Plan(192, 1)),
             (2, 32, 320, twp.Plan(256, 3)), (2, 16, 320, twp.Plan(128, 7)),
             (2, 8, 640, twp.Plan(192, 4)), (1, 8, 640, twp.Plan(256, 1)),
             (2, 13, 72, twp.Plan(128, 2))]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,c,plan", K8_ROUTES)
def test_gpu_k8_centre_tap_output_is_the_apply(cuda_device, force_plan, b, h, c, plan):
    """A centre-tap identity weight (Cin = Cout, no bias): K8's output is
    its normalised operand itself, which must equal K9's apply bit for bit
    at every pixel, the image borders included (the operand's zero padding
    is the normalised input's, not GroupNorm(0)). Each route: the rule's
    plan at SDXL's levels, the refiner's and SD1.5's 8^2, and forced
    widths, splits and ragged images."""
    if plan is not None:
        real = twp.conv_plan
        force_plan("conv_plan", lambda *a, **kw: (real(*a, **kw)[0], plan))
    _, x, scale, shift, _ = _k8_operands(cuda_device, b, h, c, c, 31 + b * h + c)
    eye = torch.zeros((3, 3, c, c), device=cuda_device, dtype=torch.bfloat16)
    eye[1, 1] = torch.eye(c, device=cuda_device, dtype=torch.bfloat16)
    before = dict(tconv.GN_LAUNCHES.by_key)
    out = tconv.gn_conv3x3(x, scale, shift, eye, gn_act="silu")
    (key,) = _new_keys(tconv.GN_LAUNCHES, before)
    assert key.startswith("wgmma_gn_bf16 ")
    if plan is not None:
        assert f" bn={plan.bn} split={plan.splits} " in key
    assert torch.equal(out, tgn.apply(x, scale, shift, "silu"))


@pytest.mark.gpu
@pytest.mark.parametrize("center", [-3.0, 0.0])
def test_gpu_wgmma_gn_conv_cout4_equals_unfused_pair(cuda_device, center):
    """The 8-column tile (Cout 4, the UNet's norm_out + SiLU + conv_out):
    at Cin 64 K8 equals K9's apply followed by the plain conv bit for bit,
    both on the 8-column wgmma kernel."""
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    x = torch.randn((2, 16, 16, 64), generator=gen, device=cuda_device).to(torch.bfloat16)
    scale = torch.rand((2, 64), generator=gen, device=cuda_device) + 0.5
    shift = torch.randn((2, 64), generator=gen, device=cuda_device) + center
    w = (torch.randn((3, 3, 64, 4), generator=gen, device=cuda_device) / 24).to(torch.bfloat16)
    bias = torch.randn(4, generator=gen, device=cuda_device).to(torch.bfloat16)
    before = dict(tconv.GN_LAUNCHES.by_key), dict(tconv.LAUNCHES.by_key)
    fused = tconv.gn_conv3x3(x, scale, shift, w, bias, gn_act="silu")
    pair = tconv.conv3x3(tgn.apply(x, scale, shift, "silu"), w, bias)
    (k8,), (k6,) = _new_keys(tconv.GN_LAUNCHES, before[0]), _new_keys(tconv.LAUNCHES, before[1])
    assert k8 == f"{k6} gn_act=silu"
    assert k6 == "wgmma_bf16 b=2 16x16 64->4 tile=16x8x1 bn=8 split=1"
    assert torch.equal(fused, pair)
    assert _rel_err(fused, tconv.gn_conv3x3_plain(x, scale, shift, w, bias, gn_act="silu")) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout,gn,bias_kind,res,act", [
    (4, 320, False, "shared", False, None),   # the UNet's conv_in: Cin padded to 8
    (320, 4, False, "shared", False, None),   # its conv_out: the 8-column tile
    (320, 4, True, "shared", False, None),    # norm_out + SiLU + conv_out (K8)
    (4, 4, False, "batch", True, "silu"),     # both, every epilogue input
    (3, 5, True, "batch", True, "silu"),
])
def test_gpu_unet_conv_in_and_out_vs_plain(cuda_device, cin, cout, gn, bias_kind, res, act):
    """conv_in and conv_out at the SDXL latent (2 x 128 x 128) on the wgmma
    kernel against conv3x3_plain, and again from operands whose bases are
    not 16-byte aligned (copied to aligned ones): the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(cin * cout + gn)
    shape = (2, 128, 128)

    def make(*dims, scale=1.0):
        """A bf16 tensor and a copy of it at a base 2 bytes past an aligned one."""
        t = (torch.randn(dims, generator=gen, device=cuda_device) * scale).to(torch.bfloat16)
        off = torch.empty(math.prod(dims) + 1, dtype=t.dtype, device=cuda_device)[1:].view(dims)
        off.copy_(t)
        return t, off

    x, x_off = make(*shape, cin)
    w, w_off = make(3, 3, cin, cout, scale=1 / (9 * cin) ** 0.5)
    bias = torch.randn((2, cout) if bias_kind == "batch" else (cout,), generator=gen,
                       device=cuda_device)
    r, r_off = make(*shape, cout) if res else (None, None)
    g = ((torch.rand((2, cin), generator=gen, device=cuda_device) + 0.5,
          torch.randn((2, cin), generator=gen, device=cuda_device) + 2.0) if gn else None)

    def run(x, w, r):
        if gn:
            return tconv.gn_conv3x3(x, *g, w, bias, residual=r, act=act, gn_act="silu")
        return tconv.conv3x3(x, w, bias, residual=r, act=act)

    counter = tconv.GN_LAUNCHES if gn else tconv.LAUNCHES
    before = dict(counter.by_key)
    out = run(x, w, r)
    keys = _new_keys(counter, before)
    assert len(keys) == 1 and next(iter(keys)).startswith(
        f"wgmma_bf16 b=2 128x128 {cin}->{cout} tile=16x8x1 bn={8 if cout <= 8 else ''}")
    ref = (tconv.gn_conv3x3_plain(x, *g, w, bias, residual=r, act=act, gn_act="silu") if gn
           else tconv.conv3x3_plain(x, w, bias, residual=r, act=act))
    assert _rel_err(out, ref) <= 2e-2
    assert x_off.data_ptr() % 16 and w_off.data_ptr() % 16
    assert torch.equal(run(x_off, w_off, r_off), out)


@pytest.mark.gpu
@pytest.mark.parametrize("b,dim,flip,shift", [(2, 320, True, 0.0), (12, 256, True, 0.0),
                                              (5, 64, False, 1.0)])
def test_gpu_time_embed_kernel_vs_plain(cuda_device, b, dim, flip, shift):
    t = torch.tensor([999.0, 1024.0, 0.0, 1.0, 500.0] * 3, device=cuda_device)[:b]
    before = ttime.LAUNCHES.count
    out = ttime.time_embed(t, dim=dim, flip_sin_to_cos=flip, downscale_freq_shift=shift)
    assert ttime.LAUNCHES.count == before + 1
    ref = ttime.time_embed_plain(t, dim=dim, flip_sin_to_cos=flip, downscale_freq_shift=shift)
    assert out.shape == (b, dim)
    assert (out - ref).abs().max().item() <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape", [(torch.bfloat16, (2, 100, 640)),
                                         (torch.float32, ((1 << 20) + 3,)),
                                         (torch.bfloat16, (2, 4096, 640)),
                                         (torch.float32, (2, 4096, 640)),
                                         (torch.float32, (1 << 20,))])
def test_gpu_dropout_kernel_matches_plain_bit_for_bit(cuda_device, dtype, shape):
    """K14 on its path, ops.dispatch under a ("dropout", "cuda") binding:
    two calls launch twice and give the same bits, which are the plain
    version's; another seed gives others; the dropped share lies within 4
    sigma of the rate; rate 0 returns x with no launch."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import resolve_binding

    binding = resolve_binding(CompileConfig(backend="reference", overrides=(("dropout", "cuda"),)))
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    before = tdropout.LAUNCHES.count
    with ops.use_backends(binding):
        out = ops.dispatch("dropout", x, 2**40 + 17, rate=0.1)
        again = ops.dispatch("dropout", x, 2**40 + 17, rate=0.1)
    assert tdropout.LAUNCHES.count == before + 2
    assert torch.equal(out, again)
    assert torch.equal(out, tdropout.dropout_plain(x, 2**40 + 17, rate=0.1))
    assert not torch.equal(out, tdropout.dropout(x, 17, rate=0.1))
    assert abs((out == 0).float().mean().item() - 0.1) <= 4 * math.sqrt(0.09 / x.numel())
    assert tdropout.dropout(x, 3, rate=0.0) is x
    assert tdropout.LAUNCHES.count == before + 3


# C4: (form, b, sq, sk, h, d, live keys, class) of division_probe on every
# route of the bf16 kernels: K1 self off the fused QKV buffer and cross off
# the fused KV buffer (the tiny-KV kernel at Sk <= 128, the KV loop above;
# SDXL's 77 keys with 56 live), K2 past 1024 keys, K3 bf16 at d = 40 (h = 1
# on both kernels, and unpacked heads past 1024 keys), K4 at d = 80 and 160,
# K5 at d = 40, 80 and 160 and SD1.5's mid-block self-attention (S = 64,
# 56 live keys: a power-of-two row sum would divide exactly either way)
C4_ROUTES = (
    [("qkv", 2, s, s, 2, 64, s, "K1") for s in (28, 56, 112, 224)]
    + [("kv", 2, 300, s, 2, 64, s, "K1") for s in (28, 56, 112)]
    + [("kv", 2, 1024, 77, 10, 64, 56, "K1"),
       ("qkv", 1, 1792, 1792, 2, 64, 1792, "K2"),
       ("sep", 2, 300, 28, 1, 40, 28, "K3"),
       ("sep", 2, 300, 224, 1, 40, 224, "K3"),
       ("qkv", 1, 1792, 1792, 2, 40, 1792, "K3")]
    + [("qkv", 2, s, s, 2, d, s, "K4") for d in (80, 160) for s in (224, 448)]
    + [("kv", 2, 300, s, 2, d, s, "K5") for d in (40, 80, 160) for s in (28, 56, 112)]
    + [("qkv", 2, 64, 64, 8, 160, 56, "K5")]
)


@pytest.mark.gpu
@pytest.mark.parametrize("form,b,sq,sk,h,d,live,cls", C4_ROUTES)
def test_gpu_attention_divides_like_jax(cuda_device, form, b, sq, sk, h, d, live, cls):
    """C4: every output of the probe is bf16(x / l) for an exact f32 key sum
    x and row sum l = live, as JAX's o / l.clip(1e-30) and attention_plain
    give it; x is chosen so that bf16(x * f32(1 / l)) differs: an epilogue
    that multiplies by the row's reciprocal fails on every output. Bit for
    bit, with the launch under its class."""
    q, k, v, x = tfa.division_probe(b, sq, sk, h, d, live, seed=sk + d + h)
    q, k, v = (t.to(torch.bfloat16).to(cuda_device) for t in (q, k, v))
    want = (x / live).to(torch.bfloat16)[:, None, :].expand(-1, sq, -1).to(cuda_device)
    before = dict(tfa.LAUNCHES.by_key)
    if form == "qkv":
        out = tfa.flash_attention_qkv(torch.cat([q, k, v], -1), num_heads=h)
    elif form == "kv":
        out = tfa.flash_attention_kv(q, torch.cat([k, v], -1), num_heads=h)
    else:
        out = tfa.flash_attention(q, k, v, num_heads=h)
    torch.cuda.synchronize()
    kernel = "tinykv_wgmma_bf16" if sk <= 128 else "wgmma_bf16"
    assert _new_keys(tfa.LAUNCHES, before) == {
        f"{cls} {kernel} b={b} h={h} d={d} sq={sq} sk={sk}": 1}
    differ = int((out != want).sum())
    assert differ == 0, f"{differ} of {out.numel()} outputs differ from bf16(x / l)"
    assert torch.equal(tfa.attention_plain(q, k, v, num_heads=h), want)


# the epilogue's out-of-range outputs: (form, b, sq, sk, h, d, live keys a
# half, class) of range_probe on each bf16 kernel and head dim: the tiny-KV
# kernel at one half of K / V (d = 64) and two (d = 40 in one wgmma group,
# 80, 160, SDXL's 77 keys, the mid block), the KV loop at d = 40, 64, 80
RANGE_ROUTES = [
    ("kv", 2, 300, 56, 2, 64, 28, "K1"),
    ("kv", 2, 300, 77, 10, 64, 28, "K1"),
    ("qkv", 2, 224, 224, 2, 64, 112, "K1"),
    ("sep", 2, 300, 224, 1, 40, 112, "K3"),
    ("qkv", 2, 224, 224, 2, 80, 112, "K4"),
    ("kv", 2, 300, 112, 2, 40, 56, "K5"),
    ("kv", 2, 300, 112, 2, 80, 56, "K5"),
    ("kv", 2, 300, 112, 2, 160, 56, "K5"),
    ("qkv", 2, 64, 64, 8, 160, 28, "K5"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("form,b,sq,sk,h,d,live,cls", RANGE_ROUTES)
def test_gpu_attention_divides_out_of_range(cuda_device, form, b, sq, sk, h, d, live, cls):
    """The epilogue's second store: outputs that are 0, under 2^-99, over
    2^99, infinite or NaN, planted by range_probe in one row of a warp whose
    other rows are in the Markstein step's range (and in every row of batch
    1), are bf16(x / l) bit for bit (NaN by position), as are the rows of the
    warps with none; the launch under its class and kernel."""
    q, k, v, x, l = tfa.range_probe(b, sq, sk, h, d, live, seed=sk + d + h)
    q, k, v = (t.to(torch.bfloat16).to(cuda_device) for t in (q, k, v))
    want = (x / l[..., None]).to(torch.bfloat16).to(cuda_device)
    before = dict(tfa.LAUNCHES.by_key)
    if form == "qkv":
        out = tfa.flash_attention_qkv(torch.cat([q, k, v], -1), num_heads=h)
    elif form == "kv":
        out = tfa.flash_attention_kv(q, torch.cat([k, v], -1), num_heads=h)
    else:
        out = tfa.flash_attention(q, k, v, num_heads=h)
    torch.cuda.synchronize()
    kernel = "tinykv_wgmma_bf16" if sk <= 128 else "wgmma_bf16"
    assert _new_keys(tfa.LAUNCHES, before) == {
        f"{cls} {kernel} b={b} h={h} d={d} sq={sq} sk={sk}": 1}
    nan = want.isnan()
    assert torch.equal(out.isnan(), nan)
    differ = out.view(torch.int16)[~nan] != want.view(torch.int16)[~nan]
    assert not differ.any(), f"{int(differ.sum())} of {out.numel()} outputs differ"

def _dropout_view(dtype, n, offset, seed):
    """n elements of dtype starting ``offset`` elements into a fresh buffer
    (an address offset * itemsize past a 16-byte boundary)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(n + offset, generator=gen, device="cuda").to(dtype)[offset:]


# one grid-stride pass of the dropout kernel on an H100: 132 SMs x 4 blocks
# x 256 threads x 2 pieces of 16 bytes
_DROPOUT_PASS_BYTES = 132 * 4 * 256 * 2 * 16


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,n,offset,rate", [
    *[(torch.bfloat16, n, 0, 0.1) for n in range(1, 8)],            # n < 8: no whole piece
    *[(torch.bfloat16, n, 5, 0.5) for n in (1, 3, 7)],               # ... and misaligned
    *[(torch.float32, n, 0, 0.1) for n in (1, 2, 3)],
    *[(torch.bfloat16, 8 * 1000 + r, 0, 0.1) for r in range(1, 8)],  # tails of 1-7
    *[(torch.bfloat16, 8 * 1000 + r, 1, 0.25) for r in range(8)],    # 2-byte offset: head 7
    *[(torch.float32, 4 * 1000 + r, 1, 0.1) for r in range(4)],      # 4-byte offset: head 3
    *[(torch.float32, 4 * 1000 + 1, o, 0.9) for o in (2, 3)],
    (torch.bfloat16, 3 * _DROPOUT_PASS_BYTES // 2 + 5, 0, 0.1),       # three grid passes
    (torch.bfloat16, 3 * _DROPOUT_PASS_BYTES // 2 + 3, 1, 0.1),
    (torch.float32, 2 * _DROPOUT_PASS_BYTES // 4 + 7, 1, 0.1),
    (torch.float32, 2 * _DROPOUT_PASS_BYTES // 4, 0, 0.75),
])
def test_gpu_dropout_pieces_heads_and_tails(cuda_device, dtype, n, offset, rate):
    """The 16-byte kernel bit for bit against dropout_plain on the same
    view: the head before x's first 16-byte boundary, the tail past its
    last whole piece, a piece that starts inside a Philox group (a base
    offset that is not a multiple of 4 elements) and more elements than one
    grid-stride pass; the output shares x's address modulo 16; one launch."""
    x = _dropout_view(dtype, n, offset, seed=n + offset)
    assert (x.data_ptr() % 16 != 0) == (offset % (16 // x.element_size()) != 0)
    before = tdropout.LAUNCHES.count
    out = tdropout.dropout(x, 2**33 + n, rate=rate)
    torch.cuda.synchronize()
    assert tdropout.LAUNCHES.count == before + 1
    assert out.shape == x.shape and out.is_contiguous()
    assert out.data_ptr() % 16 == x.data_ptr() % 16
    assert torch.equal(out, tdropout.dropout_plain(x, 2**33 + n, rate=rate))


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["f32", "f64", "strided"])
@pytest.mark.parametrize("shift", [0.0, 1.0])
@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("b,dim", [(2, 320), (12, 256)])
def test_gpu_time_embed_route_same_bits(cuda_device, b, dim, flip, shift, form):
    """K12 through its cached route gives the plain version's bits at the
    SDXL step's shapes, with t as a contiguous f32 vector (no conversion),
    f64 or a strided view (converted); one launch a call, under the
    route's key, the route made once per signature."""
    vals = torch.tensor([999.0, 1024.0, 0.0, 1.0, 500.0, 37.5, 1023.0, 250.25] * 2,
                        device=cuda_device)[:b]
    t = {"f32": vals, "f64": vals.double(),
         "strided": torch.stack([vals, -vals], 1)[:, 0]}[form]
    assert t.is_contiguous() == (form != "strided")
    kw = dict(dim=dim, flip_sin_to_cos=flip, downscale_freq_shift=shift)
    before = dict(ttime.LAUNCHES.by_key)
    out = ttime.time_embed(t, **kw)
    again = ttime.time_embed(t, **kw)
    torch.cuda.synchronize()
    route = ttime._route(t.device, t.shape, t.dtype, dim, 10000.0, flip, shift)
    assert _new_keys(ttime.LAUNCHES, before) == {route.key: 2}
    assert route.convert == (form == "f64")
    assert out.shape == (b, dim) and out.dtype == torch.float32
    assert torch.equal(out, ttime.time_embed_plain(t, **kw)) and torch.equal(out, again)


# --------------------------------------------------------------------------
# the whole-loop replay (runtime/graphs.py) on a small pipeline the kernels
# take: head dim 64, channels 64 / 128, the tiny test pipeline's CLIP and VAE
# --------------------------------------------------------------------------

REPLAY = dict(height=64, width=64, steps=3, return_latents=True)


def _replay_pipeline(device, **cache):
    """A small SDXL-shaped pipeline under the all-kernel binding, bf16;
    ``cache``: CompileConfig's cache_cross_kv / cache_time_cond."""
    from stabletriton_tpu_torch.compile import ALL_KERNEL_OVERRIDES, CompileConfig
    from stabletriton_tpu_torch.models import clip as tclip
    from stabletriton_tpu_torch.models import vae as tvae
    from stabletriton_tpu_torch.models.unet import UNetConfig, init_unet_params
    from stabletriton_tpu_torch.runtime import pipeline as tpipe

    _, c1, c2, vcfg = tpipe.tiny_configs()
    ucfg = UNetConfig(block_out_channels=(64, 128),
                      down_block_types=("DownBlock2D", "CrossAttnDownBlock2D"),
                      layers_per_block=1, transformer_layers_per_block=(1, 1),
                      attention_head_dim=64, cross_attention_dim=c1.hidden_size + c2.hidden_size,
                      norm_num_groups=8, addition_time_embed_dim=8,
                      projection_class_embeddings_input_dim=8 * 6 + c2.projection_dim)
    params = {"unet": init_unet_params(ucfg, 0, device=device),
              "text_encoder": tclip.init_clip_params(c1, 1, device=device),
              "text_encoder_2": tclip.init_clip_params(c2, 2, device=device),
              "vae": tvae.init_vae_params(vcfg, 3, device=device)}
    return tpipe.SDXLPipeline(unet_config=ucfg, clip_config=c1, clip2_config=c2,
                              vae_config=vcfg, params=params, device=device,
                              compile_config=CompileConfig(overrides=ALL_KERNEL_OVERRIDES,
                                                           **cache))


def _replay_ids(pipe, batch, seed):
    gen = torch.Generator().manual_seed(seed)
    ids = torch.full((batch, pipe.clip_config.max_position_embeddings),
                     pipe.clip_config.eos_token_id, dtype=torch.long)
    ids[:, 0] = pipe.clip_config.bos_token_id
    ids[:, 1:6] = torch.randint(0, 90, (batch, 5), generator=gen)
    return ids


def _eager_loop(pipe, ids, seeds, **kw):
    """The program's own eager loop (``_eager``, from the same
    make_denoise_loop) on the inputs txt2img makes for ``ids``."""
    prog = pipe._program(ids.shape[0], kw["height"], kw["width"], kw["steps"], 5.0, "euler",
                         True, kw.get("guidance_interval"))
    return _eager(pipe, prog, ids, ids, seeds), prog


def _snapshot() -> dict:
    return {name: dict(c.by_key) for name, c in kernel_table.counters().items()}


def _since(before: dict) -> dict:
    """Each counter's launches by key since ``before``."""
    return {name: _new_keys(c, before[name]) for name, c in kernel_table.counters().items()}


@pytest.mark.gpu
@pytest.mark.parametrize("cache", [{}, {"cache_time_cond": True}, {"cache_cross_kv": False}])
def test_gpu_replay_equals_eager_bit_for_bit(cuda_device, cache):
    """The first call of a signature (the eager warm-up, then the capture)
    and the second (a replay) give the eager loop's latents bit for bit
    under the all-kernel binding, with a guidance interval too, and with
    the time cache on or the cross K/V cache off; the replay counts the
    launches the eager call made."""
    pipe = _replay_pipeline(cuda_device, **cache)
    ids = _replay_ids(pipe, 2, 0)
    for gi in (None, (0.0, 5.0)):
        before = _snapshot()
        first = pipe.txt2img(ids, ids, seed=[1, 2], guidance_interval=gi, **REPLAY)
        eager_counts = _since(before)
        before = _snapshot()
        second = pipe.txt2img(ids, ids, seed=[1, 2], guidance_interval=gi, **REPLAY)
        torch.cuda.synchronize()
        assert _since(before) == eager_counts and any(eager_counts.values())
        eager, prog = _eager_loop(pipe, ids, [1, 2], guidance_interval=gi, **REPLAY)
        assert len(prog.loop.captured) == 1 and prog.loop._graphs is pipe._graphs
        assert torch.isfinite(first.float()).all()
        assert torch.equal(first, eager) and torch.equal(second, eager)


@pytest.mark.gpu
def test_gpu_replay_takes_new_inputs_without_recapture(cuda_device):
    """A later call with other prompts and seeds replays the one graph of
    its signature (its static inputs copied in place) and gives the eager
    loop's result on those inputs; another batch size is its own graph."""
    pipe = _replay_pipeline(cuda_device)
    pipe.txt2img(_replay_ids(pipe, 2, 0), _replay_ids(pipe, 2, 0), seed=[1, 2], **REPLAY)
    for seed in (1, 2):
        ids = _replay_ids(pipe, 2, seed)
        got = pipe.txt2img(ids, ids, seed=[seed + 10, seed + 20], **REPLAY)
        eager, prog = _eager_loop(pipe, ids, [seed + 10, seed + 20], **REPLAY)
        (entry,) = prog.loop.captured.values()
        assert torch.equal(got, eager)
        assert got.data_ptr() != entry.outputs[0].data_ptr()  # a clone, not the buffer
    solo = _replay_ids(pipe, 1, 5)
    got = pipe.txt2img(solo, solo, seed=3, **REPLAY)
    got_again = pipe.txt2img(solo, solo, seed=3, **REPLAY)
    assert torch.equal(got, got_again) and len(pipe.cache_signatures()) == 2


@pytest.mark.gpu
def test_gpu_replay_from_two_threads_equals_serial_calls(cuda_device):
    """Three threads call txt2img at once on a fresh pipeline (two of one
    signature, one of another, so captures and replays meet): each gets
    the serial calls' result bit for bit."""
    import threading

    serial = _replay_pipeline(cuda_device)
    jobs = [(_replay_ids(serial, 2, 0), [1, 2]), (_replay_ids(serial, 2, 1), [3, 4]),
            (_replay_ids(serial, 1, 2), [5])]
    want = [serial.txt2img(ids, ids, seed=s, **REPLAY) for ids, s in jobs]
    pipe = _replay_pipeline(cuda_device)
    got, errors = [None] * len(jobs), []
    start = threading.Barrier(len(jobs))

    def run(i):
        try:
            start.wait(timeout=60)
            ids, seeds = jobs[i]
            with torch.inference_mode():
                got[i] = pipe.txt2img(ids, ids, seed=seeds, **REPLAY)
                torch.cuda.current_stream().synchronize()
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def _failed_capture() -> None:
    """test_gpu_failed_capture_raises's case, in a process of its own."""
    from stabletriton_tpu_torch.runtime import pipeline as tpipe

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    with tautotune.disabled(), pytest.MonkeyPatch.context() as monkeypatch:
        pipe = _replay_pipeline(torch.device("cuda", 0))
        ids = _replay_ids(pipe, 1, 0)
        real = tpipe.unet_apply

        def refusing(*a, **kw):
            if torch.cuda.is_current_stream_capturing():
                torch.cuda.synchronize()
            return real(*a, **kw)

        monkeypatch.setattr(tpipe, "unet_apply", refusing)
        with pytest.raises(RuntimeError, match="capturing"):
            pipe.txt2img(ids, ids, seed=1, **REPLAY)
        assert torch.cuda.current_stream() == torch.cuda.default_stream()  # given back
        prog = pipe._program(1, 64, 64, 3, 5.0, "euler", True, None)
        assert prog.loop.captured == {}
        monkeypatch.undo()
        first = pipe.txt2img(ids, ids, seed=1, **REPLAY)
        assert torch.equal(pipe.txt2img(ids, ids, seed=1, **REPLAY), first)


@pytest.mark.gpu
def test_gpu_failed_capture_raises(cuda_device):
    """A step that synchronises the device while the loop is captured (a
    call a capture refuses) makes txt2img raise; nothing runs eagerly in
    the graph's place and nothing is kept; the pipeline captures again once
    the step is capturable. In a spawned process: a failed capture leaves
    PyTorch's caching allocator with that capture underway, and from then on
    torch.cuda.empty_cache() releases nothing of the default pool, so the
    process it fails in keeps the card's memory from the tests after it."""
    import torch.multiprocessing as mp

    proc = mp.get_context("spawn").Process(target=_failed_capture)
    proc.start()
    proc.join(300)
    if proc.is_alive():
        proc.kill()
    assert proc.exitcode == 0, "the case failed in its process (its traceback is above)"


@pytest.fixture(scope="module")
def full_width_unets():
    """SDXL-base's and SD1.5's UNets at full width, random bf16 weights on
    the card: (config, the params with fused projections, the params as
    made); made once for the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stabletriton_tpu_torch.compile import fuse_attention_projections
    from stabletriton_tpu_torch.models.unet import (init_unet_params, sd15_unet_config,
                                                    sdxl_base_unet_config)

    dev = torch.device("cuda", 0)
    out = {}
    for family, cfg in (("sdxl", sdxl_base_unet_config()), ("sd15", sd15_unet_config())):
        params = init_unet_params(cfg, 0, device=dev, dtype=torch.bfloat16)
        out[family] = (cfg, fuse_attention_projections(params), params)
    yield out
    out.clear()
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("binding", ["default", "fused_ops", "all_kernels"])
@pytest.mark.parametrize("family,latent,depth,classes", [
    ("sdxl", 128, 1, set()), ("sdxl", 128, 2, {"K1", "K2"}), ("sd15", 64, 1, {"K3", "K5"})])
def test_gpu_shallow_pass_equals_full_pass(cuda_device, full_width_unets, family, latent, depth,
                                           classes, binding):
    """At full width, CFG batch 2, bf16, on the cross K/V cache: the shallow
    pass on the full pass's cache gives the full pass's eps bit for bit, and
    launches the attention classes its outermost levels hold (none for
    SDXL's depth-1 split). Both passes captured as graphs: a replay of each
    holds to its eager run (``_held_to``), one graph each; at depth 1 so do
    compile_unet_deepcache's (full, shallow) on the context itself."""
    from stabletriton_tpu_torch import ops as tops
    from stabletriton_tpu_torch.compile import compile_unet_deepcache, resolve_binding
    from stabletriton_tpu_torch.models.unet import (precompute_cross_kv, unet_apply,
                                                    unet_apply_shallow)
    from stabletriton_tpu_torch.runtime.graphs import Graphs

    cfg, params, _ = full_width_unets[family]
    sample, t, ctx, te, tid = kernel_table.step_inputs(cfg, latent, cuda_device, seed=3)
    binding_ = resolve_binding(_config(binding))

    def full(*args):
        with tops.use_backends(binding_):
            return unet_apply(cfg, params, *args, cross_kv=kv, return_cache=True,
                              cache_depth=depth)

    def shallow(*args):
        with tops.use_backends(binding_):
            return unet_apply_shallow(cfg, params, *args, cross_kv=kv, cache_depth=depth)

    with torch.inference_mode():
        with tops.use_backends(binding_):
            kv = precompute_cross_kv(cfg, params, ctx)
        args = (sample, t, None, te, tid)
        eps, cache = full(*args)
        before = dict(tfa.LAUNCHES.by_key)
        eps_shallow = shallow(*args, cache)
        torch.cuda.synchronize()
        launched = {k.split()[0] for k in _new_keys(tfa.LAUNCHES, before)}
        graphs = Graphs()
        full_g, shallow_g = graphs.wrap(full), graphs.wrap(shallow)
        full_g(*args)                       # the eager run, then the capture
        shallow_g(*args, cache)
        exact = binding == "all_kernels"
        _held_to(full_g(*args), (eps, cache), exact=exact)
        _held_to(shallow_g(*args, cache), eps, exact=exact)
        assert len(full_g.captured) == 1 and len(shallow_g.captured) == 1
        if depth == 1:
            full_g, shallow_g = compile_unet_deepcache(cfg, _config(binding))
            args = (params, sample, t, ctx, te, tid)
            eps_d, cache_d = full_g.__wrapped__(*args)
            full_g(*args)
            shallow_g(*args, cache_d)
            _held_to(full_g(*args), (eps_d, cache_d), exact=exact)
            _held_to(shallow_g(*args, cache_d), eps_d, exact=exact)
            assert torch.equal(shallow_g.__wrapped__(*args, cache_d), eps_d)
    assert launched == classes
    assert torch.isfinite(eps.float()).all() and torch.equal(eps_shallow, eps)


@pytest.mark.gpu
@pytest.mark.parametrize("kw", [
    {"solver": "heun", "deep_cache": 2, "guidance_interval": (0.5, 8.0)},
    {"solver": "euler_a", "deep_cache": (2, 1)},
    {"solver": "dpmpp_2m"}])
def test_gpu_mode_replay_equals_eager_bit_for_bit(cuda_device, kw):
    """A solver / DeepCache mode through txt2img on the card: the first
    call (eager, then the capture) and a replay with another prompt and
    seed each equal the eager loop on their inputs bit for bit, under the
    all-kernel binding; one graph; the replay counts the first call's
    launches."""
    from stabletriton_tpu_torch import ops as tops
    from stabletriton_tpu_torch.compile import resolve_binding
    from stabletriton_tpu_torch.runtime.denoise import norm_deep_cache, norm_guidance_interval

    pipe = _replay_pipeline(cuda_device)
    outs, counts = [], []
    for seed in (1, 2):
        ids = _replay_ids(pipe, 1, seed)
        before = _snapshot()
        outs.append((ids, seed, pipe.txt2img(ids, ids, seed=seed, **REPLAY, **kw)))
        torch.cuda.synchronize()
        counts.append(_since(before))
    assert counts[0] == counts[1] and any(counts[0].values())
    prog = pipe._program(1, REPLAY["height"], REPLAY["width"], REPLAY["steps"], 5.0,
                         kw["solver"], True,
                         norm_guidance_interval(kw.get("guidance_interval"), 5.0),
                         norm_deep_cache(kw.get("deep_cache")))
    assert len(prog.loop.captured) == 1
    for ids, seed, got in outs:
        neg = torch.as_tensor(pipe.clip_config.empty_prompt_ids(1, ids.shape[1]),
                              dtype=torch.long)
        args = [a.to(cuda_device) for a in (ids, ids, neg, neg)]
        with torch.inference_mode(), tops.use_backends(resolve_binding(pipe.compile_config)):
            eager = prog.loop.__wrapped__(pipe.params["unet"], *prog.loop_inputs(
                pipe.params, *args, [seed]))
        assert torch.isfinite(got.float()).all() and torch.equal(got, eager)
    assert not torch.equal(outs[0][2], outs[1][2])


@pytest.mark.gpu
def test_gpu_ancestral_noise_is_per_image(cuda_device):
    from stabletriton_tpu_torch.runtime.pipeline import ancestral_noise

    alone = ancestral_noise([12], 4, (16, 16, 4), cuda_device)
    pair = ancestral_noise([11, 12], 4, (16, 16, 4), cuda_device)
    assert alone.device.type == "cuda" and torch.equal(pair[:, 1], alone[:, 0])


# --------------------------------------------------------------------------
# the image-conditioned paths: the twins at their new shapes, and the
# img2img and inpaint loops replayed
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,cout,kernel,tol", [
    (torch.float32, (1, 96, 80, 3), 128, "direct_f32", 1e-4),     # encoder conv_in
    (torch.float32, (1, 40, 24, 512), 8, "wgmma_tf32x3", 1e-4),   # encoder conv_out
    (torch.bfloat16, (2, 32, 24, 9), 320, "wgmma_bf16", 2e-2),    # inpaint conv_in
])
def test_gpu_image_path_convs_vs_plain(cuda_device, dtype, shape, cout, kernel, tol):
    """The convs only the image paths run: the f32 encoder's conv_in (Cin
    3, a direct block spanning 512 output channels of which 128 are live)
    and conv_out (Cout 8), and the inpainting UNet's conv_in (Cin 9,
    padded to 16), each on the kernel its route names."""
    gen = torch.Generator(device=cuda_device).manual_seed(14)
    x = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    w = (torch.randn((3, 3, shape[3], cout), generator=gen, device=cuda_device)
         / (9 * shape[3]) ** 0.5).to(dtype)
    bias = torch.randn((cout,), generator=gen, device=cuda_device).to(dtype)
    assert tconv.conv_variant(shape, cout, dtype) == kernel
    before = dict(tconv.LAUNCHES.by_key)
    out = tconv.conv3x3(x, w, bias)
    (key,) = [k for k, n in tconv.LAUNCHES.by_key.items() if n != before.get(k, 0)]
    assert key.startswith(f"{kernel} b={shape[0]} {shape[1]}x{shape[2]} {shape[3]}->{cout}")
    assert _rel_err(out, tconv.conv3x3_plain(x, w, bias)) <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("cin,cout,hw", [(384, 384, 16), (1152, 384, 16), (2304, 768, 8)])
def test_gpu_refiner_gn_convs_vs_plain(cuda_device, cin, cout, hw):
    """K8 at the refiner's GroupNorm widths: Cin 384 (12 channels a group)
    and the up path's skip concats, scale / shift from the GroupNorm fold."""
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    x = (torch.randn((2, hw, hw, cin), generator=gen, device=cuda_device) * 2 + 0.5).to(
        torch.bfloat16)
    gamma = torch.rand((cin,), generator=gen, device=cuda_device) + 0.5
    beta = torch.randn((cin,), generator=gen, device=cuda_device)
    scale, shift = tgn.scale_shift(x, gamma, beta, num_groups=32, eps=1e-5)
    w = (torch.randn((3, 3, cin, cout), generator=gen, device=cuda_device)
         / (9 * cin) ** 0.5).to(torch.bfloat16)
    bias = torch.randn((2, cout), generator=gen, device=cuda_device)
    out = tconv.gn_conv3x3(x, scale, shift, w, bias, gn_act="silu")
    ref = tconv.gn_conv3x3_plain(x, scale, shift, w, bias, gn_act="silu")
    assert _rel_err(out, ref) <= 2e-2


@pytest.mark.gpu
@pytest.mark.parametrize("h,sq,sk,form,cls,kernel", [
    (12, 4096, 4096, "qkv", "K2", "wgmma_bf16"), (24, 1024, 1024, "qkv", "K1", "wgmma_bf16"),
    (24, 256, 256, "qkv", "K1", "wgmma_bf16"), (12, 4096, 77, "kv", "K1", "tinykv_wgmma_bf16"),
    (24, 1024, 77, "kv", "K1", "tinykv_wgmma_bf16")])
def test_gpu_refiner_attention_vs_plain(cuda_device, h, sq, sk, form, cls, kernel):
    """The refiner's attention (d=64) at h=12 and 24: the class and kernel
    of each launch, and the output against attention_plain."""
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    c = 64 * h
    before = dict(tfa.LAUNCHES.by_key)
    if form == "qkv":
        qkv = torch.randn((1, sq, 3 * c), generator=gen, device=cuda_device).to(torch.bfloat16)
        out = tfa.flash_attention_qkv(qkv, num_heads=h)
        ref = tfa.attention_plain(*qkv.chunk(3, -1), num_heads=h)
    else:
        q = torch.randn((1, sq, c), generator=gen, device=cuda_device).to(torch.bfloat16)
        kv = torch.randn((1, sk, 2 * c), generator=gen, device=cuda_device).to(torch.bfloat16)
        out = tfa.flash_attention_kv(q, kv, num_heads=h)
        ref = tfa.attention_plain(q, *kv.chunk(2, -1), num_heads=h)
    (key,) = [k for k, n in tfa.LAUNCHES.by_key.items() if n != before.get(k, 0)]
    assert key.split()[:2] == [cls, kernel]
    assert _rel_err(out, ref) <= 2e-2


def _image_pipeline(device, in_channels):
    """_replay_pipeline's small SDXL-shaped pipeline (all-kernel binding,
    bf16) with ``in_channels`` UNet inputs and a small full VAE (decoder and
    encoder, factor 2) whose mid attention has d=64, a head dim the f32
    attention kernel takes (the tiny VAE's 16 is not one)."""
    import dataclasses

    from stabletriton_tpu_torch.models import vae as tvae
    from stabletriton_tpu_torch.models.unet import init_unet_params
    from stabletriton_tpu_torch.runtime import pipeline as tpipe

    base = _replay_pipeline(device)
    ucfg = dataclasses.replace(base.unet_config, in_channels=in_channels)
    vcfg = tvae.VAEConfig(block_out_channels=(32, 64), norm_num_groups=8, layers_per_block=1)
    params = dict(base.params)
    params["unet"] = init_unet_params(ucfg, 7, device=device)
    params["vae"] = {**tvae.init_vae_params(vcfg, 3, device=device),
                     **tvae.init_vae_encoder_params(vcfg, 8, device=device)}
    return tpipe.SDXLPipeline(unet_config=ucfg, clip_config=base.clip_config,
                              clip2_config=base.clip2_config, vae_config=vcfg,
                              params=params, device=device, compile_config=base.compile_config)


def _decoded(run):
    """Run ``run()`` with the pipeline module's decode tapped: the latents
    each decode received (a request's loop output), and what run returned."""
    from stabletriton_tpu_torch.runtime import pipeline as tpipe

    seen, real = [], tpipe._decode_images
    tpipe._decode_images = lambda cfg, p, lat: seen.append(lat.clone()) or real(cfg, p, lat)
    try:
        out = run()
    finally:
        tpipe._decode_images = real
    return seen, out


@pytest.mark.gpu
@pytest.mark.parametrize("kind,kw", [
    ("img2img_image", {"strength": 0.7}), ("img2img_image", {"strength": 0.5, "encode_seed": 3}),
    ("inpaint", {}), ("inpaint", {"solver": "heun", "deep_cache": 2,
                                  "guidance_interval": (0.5, 8.0)})])
def test_gpu_image_loop_replay_equals_eager_bit_for_bit(cuda_device, kind, kw):
    """img2img_image and inpaint on the card, all-kernel binding: the first
    call (eager, then the capture) and a replay with another image, prompt
    and seed each give the eager loop's latents on their inputs bit for
    bit (inpaint's taken where its decode receives them); one graph; the
    replay counts the first call's launches."""
    from stabletriton_tpu_torch import ops as tops
    from stabletriton_tpu_torch.compile import resolve_binding
    from stabletriton_tpu_torch.runtime import pipeline as tpipe

    pipe = _image_pipeline(cuda_device, 9 if kind == "inpaint" else 4)
    size = REPLAY["height"]
    mask = torch.zeros((1, size, size, 1), device=cuda_device)
    mask[:, 13:45, 20:50] = 1.0
    outs, counts = [], []
    for seed in (1, 2):
        gen = torch.Generator(device=cuda_device).manual_seed(seed)
        image = torch.rand((1, size, size, 3), generator=gen, device=cuda_device) * 2 - 1
        ids = _replay_ids(pipe, 1, seed)
        before = _snapshot()
        if kind == "inpaint":
            (got,), _ = _decoded(lambda: pipe.inpaint(image, mask, ids, ids, steps=3, seed=seed,
                                                      **kw))
        else:
            got = pipe.img2img_image(image, ids, ids, steps=3, seed=seed, decode=False, **kw)
        torch.cuda.synchronize()
        counts.append(_since(before))
        outs.append((image, ids, seed, got))
    assert counts[0] == counts[1] and any(counts[0].values())
    (prog,) = pipe._cache.values()
    assert len(prog.loop.captured) == 1
    for image, ids, seed, got in outs:
        neg = torch.as_tensor(pipe.clip_config.empty_prompt_ids(1, ids.shape[1]),
                              dtype=torch.long)
        tids = [a.to(cuda_device) for a in (ids, ids, neg, neg)]
        with torch.inference_mode(), tops.use_backends(resolve_binding(pipe.compile_config)):
            if kind == "inpaint":
                args = (image, mask, *tids, [seed])
            else:
                gen = (None if "encode_seed" not in kw else
                       torch.Generator(device=cuda_device).manual_seed(kw["encode_seed"]))
                args = (tpipe._encode_images(pipe.vae_config, pipe.params["vae"], image, gen),
                        *tids, [seed])
            eager = prog.loop.__wrapped__(pipe.params["unet"], *prog.loop_inputs(
                pipe.params, *args))
        assert torch.isfinite(got.float()).all() and torch.equal(got, eager)
    assert not torch.equal(outs[0][3], outs[1][3])


@pytest.mark.gpu
def test_gpu_warmup_captures_and_the_first_request_replays(cuda_device):
    """warmup builds and captures one txt2img signature on zero inputs;
    the first request of that signature replays it (no new graph, no new
    program) and gives the eager loop's images' latents bit for bit."""
    pipe = _image_pipeline(cuda_device, 4)
    size = REPLAY["height"]
    pipe.warmup(height=size, width=size, steps=3)
    (prog,) = pipe._cache.values()
    (entry,) = prog.loop.captured.values()
    ids = _replay_ids(pipe, 1, 4)
    seen, _ = _decoded(lambda: pipe.txt2img(ids, ids, height=size, width=size, steps=3, seed=5))
    assert list(pipe._cache.values()) == [prog] and list(prog.loop.captured.values()) == [entry]
    eager, _ = _eager_loop(pipe, ids, [5], height=size, width=size, steps=3)
    assert torch.equal(seen[0], eager)


# --------------------------------------------------------------------------
# SD2.x at 768^2 (96^2 latent, CFG batch 2): the new shapes
# --------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("form,sq,sk,h,cls", [
    ("qkv", 9216, 9216, 5, "K3"),   # level 0 self: h=5 does not pack
    ("kv", 9216, 77, 5, "K5"),      # level 0 cross: all heads, tiny KV
    ("qkv", 2304, 2304, 10, "K2"),
    ("kv", 2304, 77, 10, "K1"),
    ("qkv", 576, 576, 20, "K1"),
    ("kv", 576, 77, 20, "K1"),
    ("qkv", 144, 144, 20, "K1"),    # the mid block
    ("kv", 144, 77, 20, "K1"),
])
def test_gpu_sd2_attention_routes(cuda_device, form, sq, sk, h, cls):
    """SD2.x's d=64 attention at each level's shape against the plain
    version, bf16, on the kernel and under the class its route gives."""
    gen = torch.Generator(device=cuda_device).manual_seed(15)
    c, d = h * 64, 64
    if form == "qkv":
        qkv = torch.randn((2, sq, 3 * c), generator=gen, device=cuda_device).to(torch.bfloat16)
        run = lambda: tfa.flash_attention_qkv(qkv, num_heads=h)
        ref = tfa.attention_plain(*qkv.chunk(3, -1), num_heads=h)
    else:
        q = torch.randn((2, sq, c), generator=gen, device=cuda_device).to(torch.bfloat16)
        kv = torch.randn((2, sk, 2 * c), generator=gen, device=cuda_device).to(torch.bfloat16)
        run = lambda: tfa.flash_attention_kv(q, kv, num_heads=h)
        ref = tfa.attention_plain(q, *kv.chunk(2, -1), num_heads=h)
    before = dict(tfa.LAUNCHES.by_key)
    out = run()
    torch.cuda.synchronize()
    new = {k: n - before.get(k, 0) for k, n in tfa.LAUNCHES.by_key.items()
           if n != before.get(k, 0)}
    kernel = "tinykv_wgmma_bf16" if sk <= 128 else "wgmma_bf16"
    assert new == {f"{cls} {kernel} b=2 h={h} d={d} sq={sq} sk={sk}": 1}
    assert _rel_err(out, ref) <= 2e-2


@pytest.mark.gpu
def test_gpu_sd2_vae_attention(cuda_device):
    """The f32 VAE mid-block attention at a 96^2 latent (S=9216, d=512)."""
    gen = torch.Generator(device=cuda_device).manual_seed(16)
    q, k, v = (torch.randn((1, 9216, 512), generator=gen, device=cuda_device) for _ in range(3))
    out = tfa.flash_attention(q, k, v, num_heads=1)
    assert _rel_err(out, tfa.attention_plain(q, k, v, num_heads=1)) <= 1e-4


@pytest.mark.gpu
@pytest.mark.parametrize("shape,cout,dtype", [
    ((2, 96, 96, 4), 320, torch.bfloat16), ((2, 96, 96, 320), 320, torch.bfloat16),
    ((2, 48, 48, 640), 640, torch.bfloat16), ((2, 12, 12, 1280), 1280, torch.bfloat16),
    ((2, 96, 96, 320), 4, torch.bfloat16), ((1, 96, 96, 4), 512, torch.float32),
    ((1, 96, 96, 512), 512, torch.float32), ((1, 768, 768, 128), 128, torch.float32),
])
def test_gpu_sd2_convs(cuda_device, shape, cout, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(17)
    x = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    w = (torch.randn((3, 3, shape[3], cout), generator=gen, device=cuda_device)
         / (9 * shape[3]) ** 0.5).to(dtype)
    bias = torch.randn(cout, generator=gen, device=cuda_device).to(dtype)
    before = tconv.LAUNCHES.count
    out = tconv.conv3x3(x, w, bias)
    assert tconv.LAUNCHES.count == before + 1
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert _rel_err(out, tconv.conv3x3_plain(x, w, bias)) <= tol


@pytest.mark.gpu
def test_gpu_sd2_norms_geglu_gn_conv_linear(cuda_device):
    """Level 0's GroupNorm-fused conv (320 channels, 10 a group),
    Transformer2D GroupNorm, LayerNorm and GEGLU over its 18432 rows, its
    fused QKV projection and the cross K/V precompute of OpenCLIP-H's
    1024-wide states."""
    gen = torch.Generator(device=cuda_device).manual_seed(18)
    bf16 = torch.bfloat16

    def randn(*shape, dtype=bf16, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device=cuda_device) * scale + shift).to(dtype)

    x = randn(2, 96, 96, 320, scale=2.0, shift=0.5)
    scale, shift = tgn.scale_shift(x, randn(320, dtype=torch.float32, shift=1.0),
                                   randn(320, dtype=torch.float32), num_groups=32, eps=1e-5)
    w = randn(3, 3, 320, 320, scale=1 / 54.0)
    b = randn(2, 320, dtype=torch.float32)
    assert _rel_err(tconv.gn_conv3x3(x, scale, shift, w, b, gn_act="silu"),
                    tconv.gn_conv3x3_plain(x, scale, shift, w, b, gn_act="silu")) <= 2e-2
    g, beta = randn(320, shift=1.0), randn(320)
    assert _rel_err(tgn.group_norm(x, g, beta, num_groups=32, eps=1e-6),
                    tgn.group_norm_plain(x, g, beta, num_groups=32, eps=1e-6)) <= 2e-2
    rows = x.reshape(18432, 320)
    assert _rel_err(tln.layer_norm(rows, g, beta, eps=1e-6),
                    tln.layer_norm_plain(rows, g, beta, eps=1e-6)) <= 2e-2
    proj = randn(2, 9216, 2560, scale=2.0)
    state, gate = proj.chunk(2, dim=-1)
    assert _rel_err(tgeglu.geglu(state, gate), tgeglu.geglu_plain(state, gate)) <= 2e-2
    for m, k, n in [(18432, 320, 960), (154, 1024, 640), (154, 1024, 2560)]:
        a, wt = randn(m, k), randn(k, n, scale=k ** -0.5)
        assert _rel_err(tlinear.linear(a, wt), tlinear.linear_plain(a, wt)) <= 2e-2


@pytest.mark.gpu
def test_gpu_ingest_on_the_card_equals_the_host_route(cuda_device, tmp_path):
    """A torch-layout state dict converted on the card, and a safetensors
    file loaded onto it, equal the host route bit for bit."""
    from stabletriton_tpu_torch.io.safetensors_io import (convert_state_dict, load_params,
                                                          write_safetensors)

    gen = torch.Generator(device=cuda_device).manual_seed(19)
    sd = {"conv.weight": torch.randn((64, 32, 3, 3), generator=gen, device=cuda_device),
          "lin.weight": torch.randn((48, 64), generator=gen, device=cuda_device),
          "lin.bias": torch.randn(48, generator=gen, device=cuda_device),
          "text_model.embeddings.token_embedding.weight":
              torch.randn((100, 16), generator=gen, device=cuda_device)}
    sd = {k: v.half() for k, v in sd.items()}
    host = convert_state_dict({k: v.cpu() for k, v in sd.items()}, dtype=torch.bfloat16)
    card = convert_state_dict(sd, dtype=torch.bfloat16)
    write_safetensors(tmp_path / "x.safetensors", sd)
    loaded = load_params(tmp_path / "x.safetensors", dtype=torch.bfloat16, device=cuda_device)
    for k, v in host.items():
        assert card[k].device.type == loaded[k].device.type == "cuda"
        assert torch.equal(card[k].cpu(), v) and torch.equal(loaded[k].cpu(), v), k


# --------------------------------------------------------------------------
# the turbo int8 mode: torch._int_mm on the card, exact against the CPU
# --------------------------------------------------------------------------


def _int8_case(device, x_shape, w_shape, seed):
    """A bf16 x and a quantized (int8, scale) weight on ``device``."""
    from stabletriton_tpu_torch.compile import quantize_linear_weights

    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(x_shape, generator=gen, device=device).to(torch.bfloat16)
    w = (torch.randn(w_shape, generator=gen, device=device) * 0.05).to(torch.bfloat16)
    pair = quantize_linear_weights({"w.weight": w}, min_dim=1, conv=len(w_shape) == 4)["w.weight"]
    return x, pair


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 2, 17])
def test_gpu_linear_int8_accumulators_equal_the_cpu(cuda_device, m):
    """At M = 1, 2 (the rows padded to 17 for cuBLASLt) and 17, the int8
    activations and the int32 accumulators on the card equal the CPU op's
    bit for bit, and the output is within one bf16 ulp of the CPU op's."""
    from stabletriton_tpu_torch.ops import reference as tref

    x, (wq, scale) = _int8_case(cuda_device, (m, 1280), (1280, 640), m)
    xq, sx = tref._quantize_activations(x.float(), -1)
    xq_c, sx_c = tref._quantize_activations(x.cpu().float(), -1)
    assert torch.equal(xq.cpu(), xq_c) and torch.equal(sx.cpu(), sx_c)
    acc = tref.int8_mm(xq, wq)
    assert acc.dtype == torch.int32 and tuple(acc.shape) == (m, 640)
    assert torch.equal(acc.cpu(), tref.int8_mm(xq_c, wq.cpu()))
    out = tref.linear_int8(x, (wq, scale), act="silu")
    want = tref.linear_int8(x.cpu(), (wq.cpu(), scale.cpu()), act="silu")
    assert _rel_err(out.cpu(), want) <= 2.0 ** -8


@pytest.mark.gpu
@pytest.mark.parametrize("padding", [1, ((0, 1), (0, 1))])
def test_gpu_conv2d_int8_stride2_equals_the_cpu(cuda_device, padding):
    """A stride-2 int8 conv (the UNet's downsampler, the encoder's
    asymmetric padding): the int32 accumulators of its int8 patches on the
    card equal the CPU's, the output within one bf16 ulp."""
    from stabletriton_tpu_torch.ops import reference as tref

    x, (wq, scale) = _int8_case(cuda_device, (2, 33, 32, 64), (3, 3, 64, 96), 3)
    xq, _ = tref._quantize_activations(x.float(), (1, 2, 3))
    xq_c, _ = tref._quantize_activations(x.cpu().float(), (1, 2, 3))
    assert torch.equal(xq.cpu(), xq_c)
    cols, _ = tref._im2col(xq, 3, 3, 2, padding)
    cols_c, _ = tref._im2col(xq_c, 3, 3, 2, padding)
    wmat = wq.reshape(-1, 96)
    assert torch.equal(tref.int8_mm(cols, wmat).cpu(), tref.int8_mm(cols_c, wmat.cpu()))
    b = torch.linspace(-1, 1, 96, device=cuda_device)
    out = tref.conv2d_int8(x, (wq, scale), b, stride=2, padding=padding)
    want = tref.conv2d_int8(x.cpu(), (wq.cpu(), scale.cpu()), b.cpu(), stride=2, padding=padding)
    assert _rel_err(out.cpu(), want) <= 2.0 ** -8


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["int8", "int8_conv", "int8_ff", "int8_conv fused-op"])
def test_gpu_turbo_step_replays_bit_for_bit(cuda_device, mode, monkeypatch):
    """compile_unet_kv's turbo step on a small SDXL-shaped UNet (each mode
    on the default binding, int8_conv on the fused-op one too): the eager
    step runs int8 products (int8 and int8_conv at M <= 16 too, their rows
    padded: time_emb_proj is quantized); the first call (eager, then
    captured) and a replay equal the eager step bit for bit, and differ
    from the bf16 step."""
    from stabletriton_tpu_torch.compile import (compile_unet_kv, fuse_attention_projections,
                                                quantize_linear_weights)
    from stabletriton_tpu_torch.models.unet import init_unet_params
    from stabletriton_tpu_torch.ops import reference as tref

    quantize = mode.split()[0]
    config = CompileConfig(quantize=quantize,
                           overrides=FUSED_OP_OVERRIDES if "fused" in mode else ())
    pipe = _replay_pipeline(cuda_device)
    ucfg = pipe.unet_config
    params = fuse_attention_projections(init_unet_params(ucfg, 0, device=cuda_device,
                                                         dtype=torch.bfloat16))
    qparams = quantize_linear_weights(params, min_dim=64, conv=quantize == "int8_conv",
                                      ff_only=quantize == "int8_ff")
    assert any(isinstance(v, tuple) for v in qparams.values())
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    sample = torch.randn((2, 8, 8, 4), generator=gen, device=cuda_device).to(torch.bfloat16)
    ctx = torch.randn((2, 77, ucfg.cross_attention_dim), generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    pooled = torch.randn((2, 16), generator=gen, device=cuda_device).to(torch.bfloat16)
    time_ids = torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 2, device=cuda_device)
    t = torch.full((2,), 500.0, device=cuda_device)
    rows, real = [], tref.int8_mm
    monkeypatch.setattr(tref, "int8_mm", lambda a, b: rows.append(a.shape[0]) or real(a, b))
    with torch.inference_mode():
        pre, _, step = compile_unet_kv(ucfg, config)
        kv = pre.__wrapped__(qparams, ctx)
        eager = step.__wrapped__(qparams, sample, t, kv, pooled, time_ids)
        monkeypatch.undo()
        first = step(qparams, sample, t, kv, pooled, time_ids)
        replay = step(qparams, sample, t, kv, pooled, time_ids)
        bpre, _, bstep = compile_unet_kv(ucfg, CompileConfig())
        exact = bstep.__wrapped__(params, sample, t, bpre.__wrapped__(params, ctx), pooled,
                                  time_ids)
    torch.cuda.synchronize()
    assert rows and (quantize == "int8_ff" or min(rows) <= 16)
    assert len(step.captured) == 1
    assert torch.isfinite(eager.float()).all()
    assert torch.equal(first, eager) and torch.equal(replay, eager)
    assert not torch.equal(eager, exact)


# the turbo ops at SDXL-base's 1024^2 shapes, CFG batch 2, bf16: (x shape, N,
# conv) with conv None for a linear, else (kernel size, stride, padding, bias)
INT8_SDXL = {"to_qkv": ((2, 4096, 640), 1920, None), "ff up 64^2": ((2, 4096, 640), 5120, None),
             "ff up 32^2": ((2, 1024, 1280), 10240, None),
             "cross K/V precompute": ((2, 77, 2048), 2560, None),
             "time_emb_proj": ((2, 1280), 1280, None),
             "3x3 128^2 320->320": ((2, 128, 128, 320), 320, (3, 1, 1, "batch")),
             "3x3 s2 downsampler": ((2, 64, 64, 640), 640, (3, 2, 1, "cout")),
             "1x1 shortcut": ((2, 32, 32, 640), 1280, (1, 1, 0, "cout"))}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(INT8_SDXL))
def test_gpu_int8_ops_at_sdxl_shapes_equal_the_cpu(cuda_device, name):
    """linear_int8 / conv2d_int8 at SDXL-base's shapes: the int8 activations
    and the int32 accumulators on the card equal the CPU's (rows quantize
    and sum independently, so exactly), and the output is finite."""
    from stabletriton_tpu_torch.compile import quantize_linear_weights
    from stabletriton_tpu_torch.ops import reference as tref

    xs, n, conv = INT8_SDXL[name]
    gen = torch.Generator(device=cuda_device).manual_seed(4242)
    x = torch.randn(xs, generator=gen, device=cuda_device).to(torch.bfloat16)
    cin = xs[-1]
    if conv is None:
        ks = stride = pad = None
        w = (torch.randn((cin, n), generator=gen, device=cuda_device) * cin ** -0.5).to(
            torch.bfloat16)
        b = torch.randn(n, generator=gen, device=cuda_device).to(torch.bfloat16)
        dims, kw, k, op = -1, {}, cin, tref.linear_int8
    else:
        ks, stride, pad, bias = conv
        w = (torch.randn((ks, ks, cin, n), generator=gen, device=cuda_device)
             * (ks * ks * cin) ** -0.5).to(torch.bfloat16)
        b = torch.randn((xs[0], n) if bias == "batch" else (n,), generator=gen,
                        device=cuda_device).to(torch.bfloat16)
        dims, kw, k = (1, 2, 3), dict(stride=stride, padding=pad), ks * ks * cin
        op = tref.conv2d_int8
    pair = quantize_linear_weights({"w.weight": w}, min_dim=1, conv=conv is not None)["w.weight"]
    wmat = pair[0].reshape(k, n)

    def operands(x):
        xq, sx = tref._quantize_activations(x.float(), dims)
        a = xq.reshape(-1, k) if conv is None else tref._im2col(xq, ks, ks, stride, pad)[0]
        return xq, sx, a

    xq, sx, a = operands(x)
    xq_c, sx_c, a_c = operands(x.cpu())
    assert torch.equal(xq.cpu(), xq_c) and torch.equal(sx.cpu(), sx_c)
    assert torch.equal(tref.int8_mm(a, wmat).cpu(), tref.int8_mm(a_c, wmat.cpu()))
    assert torch.isfinite(op(x, pair, b, **kw).float()).all()


# The default binding's GroupNorm, LayerNorm and GEGLU ("cuda_bf16apply"):
# the SD1.5 512^2 UNet's inputs at one image (a step runs 61 GroupNorms, 48
# LayerNorms and 16 GEGLUs), taken at UNet batch 2 and 16, and its f32 VAE
# decoder's GroupNorms at batch 1. ((H, W, C), act) for GroupNorm, (S, C)
# for LayerNorm rows and (S, N) for GEGLU's halves of a (B, S, 2N) buffer.
SD15_GN = [((64, 64, 320), "silu"), ((64, 64, 320), None), ((64, 64, 640), "silu"),
           ((64, 64, 960), "silu"), ((32, 32, 320), "silu"), ((32, 32, 640), "silu"),
           ((32, 32, 640), None), ((32, 32, 960), "silu"), ((32, 32, 1280), "silu"),
           ((32, 32, 1920), "silu"), ((16, 16, 640), "silu"), ((16, 16, 1280), "silu"),
           ((16, 16, 1280), None), ((16, 16, 1920), "silu"), ((16, 16, 2560), "silu"),
           ((8, 8, 1280), "silu"), ((8, 8, 1280), None), ((8, 8, 2560), "silu")]
SD15_VAE_GN = [((64, 64, 512), "silu"), ((64, 64, 512), None), ((128, 128, 512), "silu"),
               ((256, 256, 512), "silu"), ((256, 256, 256), "silu"), ((512, 512, 256), "silu"),
               ((512, 512, 128), "silu")]
SD15_LN = [(4096, 320), (1024, 640), (256, 1280), (64, 1280)]
# the f32 UNets' widest LayerNorms: 1280 (SD1.5, SD2.x, SDXL), 1536 (the refiner)
F32_LN = [(1024, 1280), (1024, 1536)]
SD15_GEGLU = [(4096, 1280), (1024, 2560), (256, 5120), (64, 5120)]
SD15_STEP_CALLS = {"group_norm": 61, "layer_norm": 48, "geglu": 16}

# Where the kernel forms may differ from the plain chains they replace: only
# where the moments' summation order moves a rounding of mean, rstd, scale or
# shift, which moves some elements of that (image, channel) or row by a
# rounding of x's dtype (an element x * s past the largest output by up to
# 1.25 bf16 ulps of that output). Measured on the card over these shapes at
# three seeds (PERF.md, Findings): bf16 GroupNorm at most 1.25 ulps
# and 7.9e-5 of the elements off, LayerNorm and GEGLU bit for bit; the f32
# decoder's GroupNorm at most 5 f32 ulps of the largest output.
BF16APPLY_MAX_ULPS = 2          # bf16 ulps of the largest output
BF16APPLY_MAX_SHARE = 2e-4      # of the elements
F32APPLY_MAX_REL = 16 * 2**-24  # of the largest f32 output: at most 8 f32 ulps


def _bf16apply_inputs(device, shape, dtype, seed):
    """x ~ 2 N(0, 1) + 0.5; gamma 1 + N(0, 0.05^2), beta N(0, 0.05^2), as
    the benchmark's weights hold a norm's scale and bias."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = (torch.randn(shape, generator=gen, device=device) * 2 + 0.5).to(dtype)
    c = shape[-1]
    g = (torch.randn(c, generator=gen, device=device) * 0.05 + 1).to(dtype)
    b = (torch.randn(c, generator=gen, device=device) * 0.05).to(dtype)
    return x, g, b


def _holds_plain(out, ref):
    """The kernel form against its plain chain: bf16 within
    BF16APPLY_MAX_ULPS of the largest output and at most
    BF16APPLY_MAX_SHARE of the elements off; f32 within F32APPLY_MAX_REL."""
    assert out.shape == ref.shape and out.dtype == ref.dtype
    assert torch.isfinite(out.float()).all()
    if out.dtype == torch.bfloat16:
        assert _bf16_ulps(out, ref) <= BF16APPLY_MAX_ULPS
        assert (out != ref).float().mean().item() <= BF16APPLY_MAX_SHARE
    else:
        assert _rel_err(out, ref) <= F32APPLY_MAX_REL


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [2, 16])
@pytest.mark.parametrize("hwc,act", SD15_GN)
def test_gpu_bf16apply_group_norm_at_sd15_shapes(cuda_device, hwc, act, batch):
    """The default binding's GroupNorm kernel form against the plain
    group_norm_bf16apply on the card, one launch counted on its own
    counter (K9's untouched), the same bits in a second run."""
    from stabletriton_tpu_torch.ops import reference as tref

    x, g, b = _bf16apply_inputs(cuda_device, (batch, *hwc), torch.bfloat16, 31)
    k9, before = tgn.LAUNCHES.count, tgn.BF16APPLY_LAUNCHES.count
    out = tgn.group_norm_bf16apply(x, g, b, num_groups=32, act=act)
    assert tgn.BF16APPLY_LAUNCHES.count == before + 1 and tgn.LAUNCHES.count == k9
    _holds_plain(out, tref.group_norm_bf16apply(x, g, b, num_groups=32, act=act))
    assert torch.equal(tgn.group_norm_bf16apply(x, g, b, num_groups=32, act=act), out)


@pytest.mark.gpu
@pytest.mark.parametrize("hwc,act", SD15_VAE_GN)
def test_gpu_bf16apply_group_norm_f32_decoder(cuda_device, hwc, act):
    """The f32 VAE decoder's GroupNorms under the default binding: x * scale,
    + shift and the SiLU each an f32 rounding, as the plain form; within a
    few f32 ulps of the largest output (the moments' order), and a graph
    replay of it the same bits as eager."""
    from stabletriton_tpu_torch.ops import reference as tref

    x, g, b = _bf16apply_inputs(cuda_device, (1, *hwc), torch.float32, 32)
    out = tgn.group_norm_bf16apply(x, g, b, num_groups=32, eps=1e-6, act=act)
    _holds_plain(out, tref.group_norm_bf16apply(x, g, b, num_groups=32, eps=1e-6, act=act))
    other = torch.randn_like(x)
    _k9_holds(lambda t: tgn.group_norm_bf16apply(t, g, b, num_groups=32, eps=1e-6, act=act),
              x, other)


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [2, 16])
@pytest.mark.parametrize("s,c", SD15_LN)
def test_gpu_bf16apply_layer_norm_at_sd15_shapes(cuda_device, s, c, batch):
    """The default binding's LayerNorm kernel form against the plain
    layer_norm_bf16apply on the card, on its own counter, the same bits
    twice."""
    from stabletriton_tpu_torch.ops import reference as tref

    x, g, b = _bf16apply_inputs(cuda_device, (batch, s, c), torch.bfloat16, 33)
    k10, before = tln.LAUNCHES.count, tln.BF16APPLY_LAUNCHES.count
    out = tln.layer_norm_bf16apply(x, g, b, eps=1e-6)
    assert tln.BF16APPLY_LAUNCHES.count == before + 1 and tln.LAUNCHES.count == k10
    _holds_plain(out, tref.layer_norm_bf16apply(x, g, b, eps=1e-6))
    assert torch.equal(tln.layer_norm_bf16apply(x, g, b, eps=1e-6), out)


@pytest.mark.gpu
@pytest.mark.parametrize("s,c", F32_LN)
def test_gpu_bf16apply_layer_norm_f32_wide(cuda_device, s, c):
    """The default binding's LayerNorm in f32 at the widest rows the UNets
    take (CompileConfig(dtype="float32")): within a few f32 ulps of the
    plain chain, the same bits twice."""
    from stabletriton_tpu_torch.ops import reference as tref

    x, g, b = _bf16apply_inputs(cuda_device, (2, s, c), torch.float32, 38)
    out = tln.layer_norm_bf16apply(x, g, b, eps=1e-5)
    _holds_plain(out, tref.layer_norm_bf16apply(x, g, b, eps=1e-5))
    assert torch.equal(tln.layer_norm_bf16apply(x, g, b, eps=1e-5), out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gpu_bf16apply_layer_norm_without_affine(cuda_device, dtype):
    from stabletriton_tpu_torch.ops import reference as tref

    x, _, _ = _bf16apply_inputs(cuda_device, (2, 300, 640), dtype, 34)
    _holds_plain(tln.layer_norm_bf16apply(x, None, None), tref.layer_norm_bf16apply(x, None,
                                                                                     None))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [2, 16])
@pytest.mark.parametrize("s,n", SD15_GEGLU)
def test_gpu_bf16apply_geglu_at_sd15_shapes(cuda_device, s, n, batch):
    """The default binding's GEGLU kernel form on the halves of one
    projection buffer against the plain reference geglu on the card: no
    reduction, so the same bits; on its own counter."""
    from stabletriton_tpu_torch.ops import reference as tref

    gen = torch.Generator(device=cuda_device).manual_seed(35)
    proj = (torch.randn((batch, s, 2 * n), generator=gen, device=cuda_device) * 2).to(
        torch.bfloat16)
    state, gate = proj.chunk(2, dim=-1)
    k11, before = tgeglu.LAUNCHES.count, tgeglu.BF16APPLY_LAUNCHES.count
    out = tgeglu.geglu_bf16apply(state, gate)
    assert tgeglu.BF16APPLY_LAUNCHES.count == before + 1 and tgeglu.LAUNCHES.count == k11
    assert torch.equal(out, tref.geglu(state, gate))


@pytest.mark.gpu
def test_gpu_bf16apply_geglu_f32(cuda_device):
    from stabletriton_tpu_torch.ops import reference as tref

    gen = torch.Generator(device=cuda_device).manual_seed(36)
    state, gate = (torch.randn((2, 77, 2 * 96), generator=gen, device=cuda_device) * 2).chunk(
        2, dim=-1)
    assert torch.equal(tgeglu.geglu_bf16apply(state, gate), tref.geglu(state, gate))


@pytest.mark.gpu
@pytest.mark.parametrize("batch", [2, 16])
def test_gpu_default_binding_step_runs_the_kernel_forms(cuda_device, full_width_unets, batch):
    """Engagement: one eager SD1.5 UNet step (full width, 64^2 latent, CFG
    batch 2, and UNet batch 16 as the sd-1.5.batch8 cell runs it) under
    CompileConfig() raises the kernel forms' counters by the step's 61
    GroupNorms, 48 LayerNorms and 16 GEGLUs, K9-K11's by nothing, and stays
    within 2e-2 of the largest output and the step gate (MSE) of the step
    under the plain chains the binding had before."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import resolve_binding
    from stabletriton_tpu_torch.models.unet import unet_apply

    ucfg, params, _ = full_width_unets["sd15"]
    gen = torch.Generator(device=cuda_device).manual_seed(37)
    sample = torch.randn((batch, 64, 64, 4), generator=gen, device=cuda_device).to(
        torch.bfloat16)
    ctx = torch.randn((batch, 77, 768), generator=gen, device=cuda_device).to(torch.bfloat16)
    none = torch.zeros((batch, 0), device=cuda_device)
    t = torch.full((batch,), 500.0, device=cuda_device)
    counters = {"group_norm": tgn.BF16APPLY_LAUNCHES, "layer_norm": tln.BF16APPLY_LAUNCHES,
                "geglu": tgeglu.BF16APPLY_LAUNCHES}
    untouched = (tgn.LAUNCHES, tln.LAUNCHES, tgeglu.LAUNCHES)

    def step(binding):
        with torch.inference_mode(), ops.use_backends(binding):
            return unet_apply(ucfg, params, sample, t, ctx, none, none)

    binding = resolve_binding(CompileConfig())
    before = {k: c.count for k, c in counters.items()}
    fixed = [c.count for c in untouched]
    out = step(binding)
    torch.cuda.synchronize()
    assert {k: c.count - before[k] for k, c in counters.items()} == SD15_STEP_CALLS
    assert [c.count for c in untouched] == fixed
    plain = step({**binding, "group_norm": "bf16apply", "layer_norm": "bf16apply",
                  "geglu": "reference"})
    assert torch.isfinite(out.float()).all()
    assert _rel_err(out, plain) <= 2e-2
    assert (out.float() - plain.float()).square().mean().item() < STEP_MSE_GATE


@pytest.mark.gpu
def test_gpu_default_binding_f32_step(cuda_device):
    """CompileConfig(dtype="float32") on the card: one eager full-width SD2.x
    UNet step (1280-wide transformer blocks, 64^2 latent, CFG batch 2) in
    f32 runs every GroupNorm, LayerNorm and GEGLU on the kernel forms and
    stays within the f32 step gate of the plain chains. SD2.x rather than
    SD1.5: the f32 attention kernels take head dims 64 and 512, and SD1.5's
    are 40, 80 and 160."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import (CompileConfig, cast_params,
                                                fuse_attention_projections, resolve_binding)
    from stabletriton_tpu_torch.models.unet import (init_unet_params, sd21_unet_config,
                                                    unet_apply)

    ucfg = sd21_unet_config()
    config = CompileConfig(dtype="float32")
    params = cast_params(fuse_attention_projections(init_unet_params(ucfg, 0,
                                                                     device=cuda_device)),
                         config)
    gen = torch.Generator(device=cuda_device).manual_seed(39)
    sample = torch.randn((2, 64, 64, 4), generator=gen, device=cuda_device)
    ctx = torch.randn((2, 77, ucfg.cross_attention_dim), generator=gen, device=cuda_device)
    none = torch.zeros((2, 0), device=cuda_device)
    t = torch.full((2,), 500.0, device=cuda_device)
    counters = {"group_norm": tgn.BF16APPLY_LAUNCHES, "layer_norm": tln.BF16APPLY_LAUNCHES,
                "geglu": tgeglu.BF16APPLY_LAUNCHES}

    def step(binding):
        with torch.inference_mode(), ops.use_backends(binding):
            return unet_apply(ucfg, params, sample, t, ctx, none, none)

    binding = resolve_binding(config)
    before = {k: c.count for k, c in counters.items()}
    out = step(binding)
    torch.cuda.synchronize()
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    # SD1.5's topology, so its count of each op
    assert {k: c.count - before[k] for k, c in counters.items()} == SD15_STEP_CALLS
    plain = step({**binding, "group_norm": "bf16apply", "layer_norm": "bf16apply",
                  "geglu": "reference"})
    assert _rel_err(out, plain) <= 1e-3


# --------------------------------------------------------------------------
# SD2.1-768 under v-prediction: the full-width UNet at a 96^2 latent
# --------------------------------------------------------------------------


@pytest.mark.gpu
def test_gpu_sd2_k3_at_batch_16(cuda_device):
    """K3 <64> at h = 5, S = 9216 and UNet batch 16 (the sd-2.1-768.batch8
    cell's level-0 self-attention) against the plain attention, one batch
    row at a time (the plain scores of all 16 would need ~80 GB)."""
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    qkv = torch.randn((16, 9216, 3 * 320), generator=gen, device=cuda_device).to(torch.bfloat16)
    before = dict(tfa.LAUNCHES.by_key)
    out = tfa.flash_attention_qkv(qkv, num_heads=5)
    torch.cuda.synchronize()
    new = {k: n - before.get(k, 0) for k, n in tfa.LAUNCHES.by_key.items()
           if n != before.get(k, 0)}
    assert new == {"K3 wgmma_bf16 b=16 h=5 d=64 sq=9216 sk=9216": 1}
    for i in range(16):
        ref = tfa.attention_plain(*qkv[i:i + 1].chunk(3, -1), num_heads=5)
        assert _rel_err(out[i:i + 1], ref) <= 2e-2, i


def _sd21_pipeline(device, compile_config):
    """SD2.1-768's UNet at full width (random bf16 weights, seed 0), its
    v-prediction schedule, and a two-layer OpenCLIP-H-wide encoder (1024
    wide, pad id 0); the VAE is not run (the tests take the latents)."""
    import dataclasses

    from stabletriton_tpu_torch.models import clip as tclip
    from stabletriton_tpu_torch.models import vae as tvae
    from stabletriton_tpu_torch.models.unet import init_unet_params, sd21_unet_config
    from stabletriton_tpu_torch.runtime import pipeline as tpipe
    from stabletriton_tpu_torch.runtime.scheduler import SchedulerConfig

    ucfg = sd21_unet_config()
    c1 = dataclasses.replace(tclip.sd2_text_encoder_config(), num_layers=2, pad_token_id=0)
    params = {"unet": init_unet_params(ucfg, 0, device=device, dtype=torch.bfloat16),
              "text_encoder": tclip.init_clip_params(c1, 1, device=device), "vae": {}}
    return tpipe.SDXLPipeline(
        unet_config=ucfg, clip_config=c1, clip2_config=c1, vae_config=tvae.sd15_vae_config(),
        params=params, compile_config=compile_config, device=device,
        scheduler_config=SchedulerConfig(prediction_type="v_prediction"))


SD21_CALL = dict(height=768, width=768, steps=3, guidance_scale=7.5, return_latents=True)


def _sd21_ids(pipe, batch):
    ids = torch.as_tensor(pipe.clip_config.empty_prompt_ids(batch), dtype=torch.long)
    ids[:, 1:9] = torch.arange(300, 300 + 8 * batch).reshape(batch, 8) % 700 + 300
    ids[:, 9] = pipe.clip_config.eos_token_id
    return ids


@pytest.mark.gpu
def test_gpu_sd21_v_loop_replays_bit_for_bit_at_batch_16(cuda_device):
    """A v-prediction SD2.1 loop at full width, 8 images (UNet batch 16 at a
    96^2 latent) under the default binding: the first call (eager, then the
    capture) and a replay give the eager loop's latents bit for bit, and the
    replay launches what the eager call did."""
    from stabletriton_tpu_torch import ops as tops
    from stabletriton_tpu_torch.compile import CompileConfig, resolve_binding

    pipe = _sd21_pipeline(cuda_device, CompileConfig())
    ids = _sd21_ids(pipe, 8)
    seeds = list(range(40, 48))
    before = _snapshot()
    first = pipe.txt2img(ids, ids, seed=seeds, **SD21_CALL)
    eager_counts = _since(before)
    before = _snapshot()
    second = pipe.txt2img(ids, ids, seed=seeds, **SD21_CALL)
    torch.cuda.synchronize()
    assert _since(before) == eager_counts and any(eager_counts.values())
    prog = pipe._program(8, 768, 768, 3, 7.5, "euler", True, None, None)
    neg = torch.as_tensor(pipe.clip_config.empty_prompt_ids(8), dtype=torch.long)
    args = [t.to(cuda_device) for t in (ids, ids, neg, neg)]
    with torch.inference_mode(), tops.use_backends(resolve_binding(pipe.compile_config)):
        inputs = prog.loop_inputs(pipe.params, *args, seeds)
        eager = prog.loop.__wrapped__(pipe.params["unet"], *inputs)
    assert len(prog.loop.captured) == 1
    assert torch.isfinite(first.float()).all()
    assert torch.equal(first, eager) and torch.equal(second, eager)
    del pipe
    torch.cuda.empty_cache()


@pytest.mark.gpu
def test_gpu_sd21_v_loop_within_the_step_gate_of_the_reference(cuda_device, monkeypatch):
    """The same v-prediction loop, one image (UNet batch 2: the reference
    binding's plain attention holds the whole 9216^2 scores), eager under
    both bindings on the reference's conditioning and noise, the default
    binding's teacher-forced: each Euler step hands it the reference's next
    latents, so every evaluation of both loops sees the same sample. Each
    evaluation's CFG pair (the UNet's v) lies within the step gate of the
    reference's: 2e-2 of the reference pair's largest, M. The guided,
    converted eps the solver steps on is held to the bound that follows
    from it: the combine u + g (c - u) scales the pair's gap by at most
    |1 - g| + g = 2g - 1, and its bf16 rounding on either side adds up to 2
    more of it, so (1 + 2g) x 2e-2 x M; the conversion scales v by 1 /
    sqrt(sigma^2 + 1) and rounds eps to bf16 once on either side, one bf16
    ulp of the reference's largest eps. The largest share of that bound
    measured on an H100 is printed."""
    from stabletriton_tpu_torch import ops as tops
    from stabletriton_tpu_torch.compile import CompileConfig, resolve_binding
    from stabletriton_tpu_torch.runtime import pipeline as tpipe
    from stabletriton_tpu_torch.runtime import scheduler as tsched

    g, steps = SD21_CALL["guidance_scale"], SD21_CALL["steps"]
    pipes = {"reference": _sd21_pipeline(cuda_device, CompileConfig(backend="reference")),
             "default": _sd21_pipeline(cuda_device, CompileConfig())}
    ref = pipes["reference"]
    ids = _sd21_ids(ref, 1)
    neg = torch.as_tensor(ref.clip_config.empty_prompt_ids(1), dtype=torch.long)
    args = [t.to(cuda_device) for t in (ids, ids, neg, neg)]
    real_unet, real_conv, real_step = tpipe.unet_apply, tsched.v_to_eps, tsched.euler_step
    runs = {}
    for name in ("reference", "default"):
        pipe = pipes[name]
        rec = {"pair": [], "eps": [], "sigma": [], "lat": []}
        forced = runs["reference"]["lat"] if name == "default" else None

        def unet(*a, rec=rec, **kw):
            rec["pair"].append(real_unet(*a, **kw))
            return rec["pair"][-1]

        def conv(x, v, sigma, rec=rec):
            rec["sigma"].append(sigma)
            rec["eps"].append(real_conv(x, v, sigma))
            return rec["eps"][-1]

        def step(lat, eps, sigma, sigma_next, rec=rec, forced=forced):
            rec["lat"].append(real_step(lat, eps, sigma, sigma_next))
            return rec["lat"][-1] if forced is None else forced[len(rec["lat"]) - 1]

        monkeypatch.setattr(tpipe, "unet_apply", unet)
        monkeypatch.setattr(tsched, "v_to_eps", conv)
        monkeypatch.setattr(tsched, "euler_step", step)
        prog = pipe._program(1, SD21_CALL["height"], SD21_CALL["width"], steps, g, "euler", True,
                             None, None)
        with torch.inference_mode(), tops.use_backends(resolve_binding(pipe.compile_config)):
            if forced is None:
                inputs = prog.loop_inputs(ref.params, *args, [7])
            prog.loop.__wrapped__(pipe.params["unet"], *inputs)
        monkeypatch.undo()
        runs[name] = rec
    torch.cuda.synchronize()
    want, got = runs["reference"], runs["default"]
    assert len(want["eps"]) == len(got["eps"]) == steps and want["sigma"] == got["sigma"]
    shares = []
    for k in range(steps):
        m = want["pair"][k].float().abs().max().item()
        gap = (got["pair"][k].float() - want["pair"][k].float()).abs().max().item()
        assert torch.isfinite(got["pair"][k].float()).all() and gap <= 2e-2 * m, k
        top = want["eps"][k].float().abs().max().item()
        ulp = 2.0 ** (math.floor(math.log2(top)) - 7)
        bound = (1 + 2 * g) * 2e-2 * m / math.sqrt(want["sigma"][k] ** 2 + 1) + ulp
        eps_gap = (got["eps"][k].float() - want["eps"][k].float()).abs().max().item()
        shares.append((gap / (2e-2 * m), eps_gap / bound))
        assert eps_gap <= bound, (k, eps_gap, bound)
    print(f"sd21 v loop, share of the pair's gate and of the eps bound by step: {shares}")
    del pipes, ref, runs, want, got
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# kernel_table.py's rows: each against its plain version
# --------------------------------------------------------------------------


# each op's gate against its plain version (of the largest plain output): 2e-2
# in bf16 and 1e-4 in f32 but where named: bit for bit (0), or the default
# binding's forms' rule ("bf16apply": ``_holds_plain``); K8 and K9 also give
# the same bits in a second run
ROW_TOL = {"time_embed": 0, "dropout": 0, "gn_bf16apply": "bf16apply",
           "ln_bf16apply": "bf16apply", "geglu_bf16apply": "bf16apply"}
ROW_REPEAT = ("gn_conv", "group_norm")


@pytest.mark.gpu
@pytest.mark.parametrize("row", kernel_table.ROWS, ids=lambda r: r.name)
def test_gpu_kernel_table_row_vs_plain(cuda_device, row):
    """Each row the kernel timer times (the paths' shapes of PERF.md's
    kernel table) against its plain version on the same inputs, within
    ROW_TOL: launched on its counter under the kernel (and for attention the
    class) its route names."""
    case = kernel_table.case(row, cuda_device)
    tol = ROW_TOL.get(row.op, 2e-2 if row.dtype == "bf16" else 1e-4)
    before = dict(case.counter.by_key)
    out = case.kernel()
    torch.cuda.synchronize()
    new = _new_keys(case.counter, before)
    assert new, "no launch counted"
    if case.want is not None:
        assert all(key.startswith(case.want + " ") for key in new), new
    ref = case.plain()
    if tol == "bf16apply":
        _holds_plain(out, ref)
    else:
        assert out.shape == ref.shape and out.dtype == ref.dtype
        assert torch.isfinite(out.float()).all()
        if tol == 0:
            assert torch.equal(out, ref)
        else:
            assert _rel_err(out, ref) <= tol
    if row.op in ROW_REPEAT:
        assert torch.equal(case.kernel(), out)


# --------------------------------------------------------------------------
# the full-width UNet step under each binding: the step gate, the launches
# --------------------------------------------------------------------------

STEP_MSE_GATE = 1e-3  # the JAX package's fidelity gate

# Launches of one UNet step (CFG batch 2) at full width. Under the all-kernel
# binding (the fused-op binding launches K8-K11 alone): resnets x 2 GN+SiLU+
# conv pairs + norm_out/conv_out (K8); one GroupNorm per Transformer2D (K9);
# transformer blocks x 3 LayerNorms (K10) and x 1 GEGLU (K11); the timestep
# embedding, and SDXL's time ids (K12); every projection (K13), the cross K/V
# precompute adding one a block once a generation. SDXL-base: 17 resnets, 11
# Transformer2D, 70 blocks; SD1.5: 22 resnets, 16 Transformer2D of one block.
# The bf16 attention by kernel and class (SDXL: self at 64^2 10 x K2, at 32^2
# 60 x K1 on attn_wgmma_bf16, 70 cross x K1 on the tiny-KV kernel; SD1.5:
# K3 5, K4 10, and K5 17 on the tiny-KV kernel); the bf16 3x3 convs, all on
# wgmma; the all-kernel step's K13 by kernel (M = 2 on the skinny kernel).
STEP_LAUNCHES = {
    "sdxl": {"latent": 128, "precompute": 70,
             "all": {"K8": 35, "K9": 11, "K10": 210, "K11": 70, "K12": 2, "K13": 463},
             "attention": {"wgmma_bf16": {"K1": 60, "K2": 10}, "tinykv_wgmma_bf16": {"K1": 70}},
             "convs": 38, "linears": {"wgmma_bf16": 512, "skinny_bf16": 21}},
    "sd15": {"latent": 64, "precompute": 16,
             "all": {"K8": 45, "K9": 16, "K10": 48, "K11": 16, "K12": 1, "K13": 152},
             "attention": {"wgmma_bf16": {"K3": 5, "K4": 10}, "tinykv_wgmma_bf16": {"K5": 17}},
             "convs": 49, "linears": {"wgmma_bf16": 144, "skinny_bf16": 24}},
}
# SD2.1's UNet has SD1.5's topology; its d=64 attention by kernel and class
SD21_ATTENTION = {"wgmma_bf16": {"K1": 6, "K2": 5, "K3": 5},
                  "tinykv_wgmma_bf16": {"K1": 11, "K5": 5}}
OPT_KERNELS = ("K8", "K9", "K10", "K11", "K12", "K13")
FORMS = ("K9_bf16apply", "K10_bf16apply", "K11_bf16apply")


def _config(binding: str) -> CompileConfig:
    if binding == "reference":
        return CompileConfig(backend="reference")
    if binding.startswith("int8"):
        return CompileConfig(quantize=binding)
    return CompileConfig(overrides={"default": (), "fused_ops": FUSED_OP_OVERRIDES,
                                    "all_kernels": ALL_KERNEL_OVERRIDES}[binding])


def _by_kernel(*by_keys) -> dict:
    """Launches summed by kernel, the keys' first field."""
    out = {}
    for by_key in by_keys:
        for key, n in by_key.items():
            out[key.split()[0]] = out.get(key.split()[0], 0) + n
    return out


def _attention_by(by_key: dict, kernels=("wgmma_bf16", "tinykv_wgmma_bf16")) -> dict:
    """Attention launches of ``kernels`` as {kernel: {class: n}}."""
    out = {}
    for key, n in by_key.items():
        cls, kernel = key.split()[:2]
        if kernel in kernels:
            out.setdefault(kernel, {})
            out[kernel][cls] = out[kernel].get(cls, 0) + n
    return out


def _expected(family: str, binding: str, steps: int = 1) -> tuple[dict, dict]:
    """K8-K13 and the kernel forms' launches of ``steps`` UNet steps under a
    binding, and its 3x3 convs by kernel."""
    a = STEP_LAUNCHES["sd15" if family == "sd21" else family]
    counts = dict.fromkeys(OPT_KERNELS + FORMS, 0)
    if binding == "default":
        counts.update(K9_bf16apply=(a["all"]["K8"] + a["all"]["K9"]) * steps,
                      K10_bf16apply=a["all"]["K10"] * steps, K11_bf16apply=a["all"]["K11"] * steps)
    elif binding == "fused_ops":
        counts.update({k: a["all"][k] * steps for k in ("K8", "K9", "K10", "K11")})
    elif binding == "all_kernels":
        counts.update({k: n * steps for k, n in a["all"].items()})
    return counts, _k8_split({"wgmma_bf16": a["convs"] * steps}, counts["K8"], steps)


def _k8_split(convs: dict, k8: int, steps: int) -> dict:
    """3x3 convs by kernel when ``k8`` of them over ``steps`` steps are K8's:
    all but conv_out's (one a step, on the 8-column form) move to the
    warp-specialised kernel."""
    if k8:
        convs = {**convs, "wgmma_bf16": convs["wgmma_bf16"] - (k8 - steps),
                 "wgmma_gn_bf16": convs.get("wgmma_gn_bf16", 0) + k8 - steps}
    return convs


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in _leaves(x)]
    return [tree]


def _held_to(got, eager, reference=None, *, exact: bool = False) -> None:
    """A replay's output against its eager run: finite, and bit for bit, or,
    unless ``exact`` (the all-kernel binding runs no cuBLAS call), within the
    step gate: MSE against ``reference`` (the reference binding's eager
    output) where given, else against the eager run."""
    a = torch.cat([t.float().flatten() for t in _leaves(got)])
    assert torch.isfinite(a).all()
    if all(torch.equal(x, y) for x, y in zip(_leaves(got), _leaves(eager))):
        return
    assert not exact, "a replay differs from its eager run"
    b = torch.cat([t.float().flatten() for t in _leaves(reference if reference is not None
                                                          else eager)])
    assert (a - b).square().mean().item() < STEP_MSE_GATE


@pytest.mark.gpu
@pytest.mark.parametrize("binding", ["reference", "default", "fused_ops", "all_kernels"])
@pytest.mark.parametrize("family", ["sdxl", "sd15"])
def test_gpu_full_width_step(cuda_device, full_width_unets, family, binding):
    """compile_unet_kv's cross K/V precompute and UNet step at full width
    (SDXL-base at a 128^2 latent, SD1.5 at 64^2; CFG batch 2, bf16, random
    weights). The eager step (``__wrapped__``) under a kernel binding
    against the reference binding's on the unfused weights: finite, MSE
    under the step gate; its launches: the bf16 attention by kernel and
    class, K8-K13 and the default binding's forms by count, the 3x3 convs by
    kernel; the precompute's K13 under the all-kernel binding alone, one a
    block, and that binding's GEMMs by kernel (STEP_LAUNCHES counts every
    linear dispatch, so none reaches cuBLAS). Then the first call (the eager
    run, then the capture) and a replay of each, held as ``_held_to`` holds
    them (the step against the reference binding's eager step); one graph
    each; a replay counts the eager step's launches key by key."""
    from stabletriton_tpu_torch.compile import compile_unet_kv

    cfg, fused, params = full_width_unets[family]
    p = params if binding == "reference" else fused
    want = STEP_LAUNCHES[family]
    sample, t, ctx, te, tid = kernel_table.step_inputs(cfg, want["latent"], cuda_device)
    with torch.inference_mode():
        rpre, _, rstep = compile_unet_kv(cfg, _config("reference"))
        ref = rstep.__wrapped__(params, sample, t, rpre.__wrapped__(params, ctx), te, tid)
        pre, _, step = compile_unet_kv(cfg, _config(binding))
        before = _snapshot()
        kv_eager = pre.__wrapped__(p, ctx)
        torch.cuda.synchronize()
        pre_launches, before = _since(before), _snapshot()
        eager = step.__wrapped__(p, sample, t, kv_eager, te, tid)
        torch.cuda.synchronize()
        got = _since(before)
        pre(p, ctx)                         # the eager run, then the capture
        kv = pre(p, ctx)                    # a replay
        first = step(p, sample, t, kv, te, tid)
        before = _snapshot()
        again = step(p, sample, t, kv, te, tid)
        torch.cuda.synchronize()
        replay = _since(before)
    exact = binding == "all_kernels"
    _held_to(kv, kv_eager, exact=exact)
    _held_to(first, eager, ref, exact=exact)
    _held_to(again, eager, ref, exact=exact)
    assert replay == got
    assert len(step.captured) == 1 and len(pre.captured) == 1
    assert torch.isfinite(eager.float()).all() and torch.isfinite(ref.float()).all()
    if binding == "reference":
        return
    assert (eager.float() - ref.float()).square().mean().item() < STEP_MSE_GATE
    assert _attention_by(got["attention"]) == want["attention"]
    counts, convs = _expected(family, binding)
    assert {k: sum(got[k].values()) for k in counts} == counts
    assert _by_kernel(got["K6"], got["K8"]) == convs
    assert {k: sum(v.values()) for k, v in pre_launches.items() if v} == (
        {"K13": want["precompute"]} if exact else {})
    if exact:
        assert _by_kernel(got["K13"], pre_launches["K13"]) == want["linears"]


# --------------------------------------------------------------------------
# full-width requests: SDXL-base 1024^2, SD1.5 512^2, SD2.1 768^2, 4 steps
# --------------------------------------------------------------------------

STEPS = 4
# a request under a mode, its eager loop and the reference binding's: the
# binding's MSE against the reference's may be at most this many times its
# plain Euler MSE (a wrong cache slice or a misplaced correction is O(1) off)
MODE_MSE_RATIO = 10.0
# the same seed alone (bucket 1) and co-batched (bucket 2) gives images up to
# ~0.12-0.16 apart (max abs, images in [-1, 1]) under every binding, the
# reference one included: the plans and cuBLAS's algorithms depend on M, and
# 4 bf16 Euler steps through random full-width weights amplify a rounding. A
# binding stays under the bound, about twice the largest measured, and a
# kernel binding within the ratio of the reference binding's diff.
SOLO_VS_BATCHED_BOUND = 0.3
SOLO_VS_BATCHED_RATIO = 2.0
# one 1024^2 f32 decode under the default binding against the reference
# binding's (TF32 off), images in [-1, 1]: 3xTF32 keeps ~f32 accuracy
DECODE_MAX_ABS = 5e-5
# one image's f32 decode: conv_in on the direct kernel, 32 convs on the
# 3xTF32 wgmma kernel, its mid-block attention once on the 3xTF32 GEMM (K3);
# the f32 encode: conv_in (Cin 3) direct, 21 convs on 3xTF32 (the stride-2
# downsamplers and 1x1 shortcuts on the plain conv, as the JAX package)
DECODE_CONVS = {"wgmma_tf32x3": 32, "direct_f32": 1}
ENCODE_CONVS = {"wgmma_tf32x3": 21, "direct_f32": 1}
VAE_LINEARS = 4  # the f32 VAE's mid-attention q, k, v, out an image
NORMS = ("norm1.weight", "norm2.weight", "group_norm.weight", "conv_norm_out.weight")


def _modes() -> dict:
    """The request modes: txt2img keywords, plain Euler first."""
    from stabletriton_tpu_torch.runtime import scheduler as tsched

    s = [float(v) for v in tsched.make_schedule(tsched.SchedulerConfig(), STEPS).sigmas]
    middle = ((s[2] + s[3]) / 2, (s[0] + s[1]) / 2)  # steps 1 and 2 of 0-3
    return {"euler": {}, "euler, interval": {"guidance_interval": middle},
            "deep_cache=2": {"deep_cache": 2}, "deep_cache=(2, 2)": {"deep_cache": (2, 2)},
            "heun": {"solver": "heun"}, "dpmpp_2m": {"solver": "dpmpp_2m"},
            "euler_a": {"solver": "euler_a"},
            "heun, deep_cache=2, interval": {"solver": "heun", "deep_cache": 2,
                                             "guidance_interval": middle}}


@pytest.fixture(scope="module")
def sdxl_other():
    """SDXL-base's two text encoders and VAE decoder at full width, random
    f32 weights on the card: (clip config, clip-2 config, VAE config,
    params)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stabletriton_tpu_torch.models import clip as tclip
    from stabletriton_tpu_torch.models import vae as tvae

    c1, c2 = tclip.sdxl_text_encoder_config(), tclip.sdxl_text_encoder_2_config()
    vcfg = tvae.sdxl_vae_config()
    dev = torch.device("cuda", 0)
    yield c1, c2, vcfg, {"text_encoder": tclip.init_clip_params(c1, 1, device=dev),
                         "text_encoder_2": tclip.init_clip_params(c2, 2, device=dev),
                         "vae": tvae.init_vae_params(vcfg, 3, device=dev)}
    torch.cuda.empty_cache()


def _sdxl_pipeline(full_width_unets, sdxl_other, binding, unet=None, **kw):
    from stabletriton_tpu_torch.runtime import pipeline as tpipe

    cfg, _, params = full_width_unets["sdxl"]
    c1, c2, vcfg, other = sdxl_other
    return tpipe.SDXLPipeline(unet_config=kw.pop("unet_config", cfg), clip_config=c1,
                              clip2_config=c2, vae_config=vcfg,
                              params={"unet": params if unet is None else unet, **other,
                                      **kw.pop("params", {})},
                              compile_config=_config(binding), device="cuda", **kw)


def _tokens(pipe, prompt: str):
    """The benchmark's stub tokenizer's ids for one prompt, per encoder (the
    second padded with 0, as SDXL's second tokenizer pads)."""
    from gpubench.tokenizer import StubTokenizer

    c1, c2 = pipe.clip_config, pipe.clip2_config
    tok = StubTokenizer(c1.bos_token_id, c1.eos_token_id)
    return (tok.encode_batch([prompt], max_len=c1.max_position_embeddings),
            tok.encode_batch([prompt], max_len=c2.max_position_embeddings, pad=0))


def _eager(pipe, prog, ids1, ids2, seeds, *extra):
    """The program's eager loop (``loop.__wrapped__``) on the inputs its
    entry point makes for these ids and seeds (``extra``: the image-path
    inputs before the ids)."""
    from stabletriton_tpu_torch import ops as tops
    from stabletriton_tpu_torch.compile import resolve_binding

    b = len(seeds)
    ids = pipe._ids(ids1, ids2, pipe.clip_config.empty_prompt_ids(b, ids1.shape[1]),
                    pipe.clip2_config.empty_prompt_ids(b, ids2.shape[1]))
    with torch.inference_mode(), tops.use_backends(resolve_binding(pipe.compile_config)):
        return prog.loop.__wrapped__(pipe.params["unet"], *prog.loop_inputs(
            pipe.params, *extra, *ids, seeds))


def _program(pipe, size, kw):
    from stabletriton_tpu_torch.runtime.denoise import norm_deep_cache, norm_guidance_interval

    return pipe._program(1, size, size, STEPS, 5.0, kw.get("solver", "euler"), True,
                         norm_guidance_interval(kw.get("guidance_interval"), 5.0),
                         norm_deep_cache(kw.get("deep_cache")))


def _eager_graphs():
    """Graphs that graph nothing: every loop runs eagerly (the reference
    binding's requests, held against and never replayed)."""
    from stabletriton_tpu_torch.runtime.graphs import Graphs

    class Eager(Graphs):
        def wrap(self, fn):
            return fn

    return Eager()


@pytest.fixture(scope="module")
def reference_latents(full_width_unets, sdxl_other):
    """The reference binding's eager SDXL 1024^2 request of each mode on the
    second call's prompt and seed, made once."""
    pipe = _sdxl_pipeline(full_width_unets, sdxl_other, "reference", _graphs=_eager_graphs())
    ids1, ids2 = _tokens(pipe, "a bowl of ramen")
    out = {mode: pipe.txt2img(ids1, ids2, height=1024, width=1024, steps=STEPS, seed=12,
                              return_latents=True, **kw) for mode, kw in _modes().items()}
    del pipe
    gc.collect()
    yield out


@pytest.mark.gpu
@pytest.mark.parametrize("binding", ["reference", "default", "fused_ops", "all_kernels", "int8",
                                     "int8_ff", "int8_conv"])
def test_gpu_full_width_requests_replay_like_eager(cuda_device, full_width_unets, sdxl_other,
                                                   reference_latents, binding):
    """SDXL-base 1024^2 4-step requests (batch 1, latents returned) through
    SDXLPipeline.txt2img: plain Euler and Euler with a guidance interval over
    the middle two steps under every binding, every solver and DeepCache
    mode too under the default and the all-kernel binding, plain Euler under
    each turbo mode. Each mode twice (the first call captures, the second
    replays with another prompt and seed): each the eager loop on its inputs
    bit for bit (under the reference and fused-op bindings, and the interval
    requests, as ``_held_to`` holds a replay), all finite, one graph a
    signature, the replay counting the first call's launches key by key.
    Under the default and all-kernel bindings each mode's MSE against the
    reference binding's eager request is at most MODE_MSE_RATIO x plain
    Euler's. A graph goes with its pipeline's programs."""
    modes = _modes()
    names = (list(modes) if binding in ("default", "all_kernels") else ["euler"]
             if binding.startswith("int8") else ["euler", "euler, interval"])
    pipe = _sdxl_pipeline(full_width_unets, sdxl_other, binding)
    calls = [("a lighthouse at dusk", 11), ("a bowl of ramen", 12)]
    mse = {}
    for mode in names:
        kw = modes[mode]
        outs, counts = [], []
        for prompt, seed in calls:
            ids1, ids2 = _tokens(pipe, prompt)
            before = _snapshot()
            outs.append(pipe.txt2img(ids1, ids2, height=1024, width=1024, steps=STEPS, seed=seed,
                                     return_latents=True, **kw))
            torch.cuda.synchronize()
            counts.append(_since(before))
        prog = _program(pipe, 1024, kw)
        assert len(prog.loop.captured) == 1, mode
        assert counts[1] == counts[0], mode
        strict = binding.startswith("int8") or (binding in ("default", "all_kernels")
                                                 and mode != "euler, interval")
        for (prompt, seed), got in zip(calls, outs):
            assert got.shape == (1, 128, 128, 4) and torch.isfinite(got.float()).all(), mode
            eager = _eager(pipe, prog, *_tokens(pipe, prompt), [seed])
            if strict:
                assert torch.equal(got, eager), mode
            else:
                _held_to(got, eager, exact=binding == "all_kernels")
        mse[mode] = (outs[1].float() - reference_latents[mode].float()).square().mean().item()
    if binding in ("default", "all_kernels"):
        for mode in names:
            if mode != "euler, interval":
                assert mse[mode] <= MODE_MSE_RATIO * mse["euler"], (mode, mse)
    (entry,) = _program(pipe, 1024, {}).loop.captured.values()
    graph = weakref.ref(entry.graph)
    pipe._cache.clear()
    del entry, prog
    gc.collect()
    assert graph() is None


@pytest.mark.gpu
def test_gpu_full_width_decode_within_5e5_of_the_reference(cuda_device, sdxl_other):
    """One 1024^2 f32 decode (random latents) under the default binding (the
    3xTF32 convs, the f32 attention, linears and GroupNorm forms) against
    the reference binding's (cuDNN, cuBLAS; TF32 off): (1, 1024, 1024, 3),
    finite, max abs at most DECODE_MAX_ABS."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import resolve_binding
    from stabletriton_tpu_torch.runtime.pipeline import _decode_images

    _, _, vcfg, other = sdxl_other
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    lat = torch.randn((1, 128, 128, 4), generator=gen, device=cuda_device)
    images = {}
    with torch.inference_mode():
        for name in ("reference", "default"):
            with ops.use_backends(resolve_binding(_config(name))):
                images[name] = _decode_images(vcfg, other["vae"], lat).float()
    got, ref = images["default"], images["reference"]
    assert got.shape == (1, 1024, 1024, 3) and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= DECODE_MAX_ABS


SD21_PROMPTS = ["a lighthouse on a cliff at dawn", "a bowl of ramen", "an owl", "a red kite "
                "over a wheat field in late summer light", "a glass teapot", "a city at night",
                "a watercolor of a harbour with fishing boats", "a cat"]
# (family, binding, the co-batched (prompt, seed) requests, the first one's
# seed again alone): SDXL-base 1024^2 under each binding, SD1.5 512^2 and
# SD2.1-768 (v-prediction, a bucket of 8: UNet batch 16) as the benchmark's
# configurations serve them
SERVE_CASES = {
    "sdxl-reference": ("sdxl", "reference", [("a lighthouse at dusk", 11),
                                             ("a bowl of ramen", 12)],
                       ("a lighthouse at dusk", 11)),
    "sdxl-default": ("sdxl", "default", [("a lighthouse at dusk", 11), ("a bowl of ramen", 12)],
                     ("a lighthouse at dusk", 11)),
    "sdxl-fused_ops": ("sdxl", "fused_ops", [("a red fox in snow", 21), ("a glass teapot", 22)],
                       ("a red fox in snow", 21)),
    "sdxl-all_kernels": ("sdxl", "all_kernels", [("a paper boat on a pond", 41),
                                                 ("a clock tower", 42)],
                         ("a paper boat on a pond", 41)),
    "sd15-default": ("sd15", "default", [("a watercolor of a harbour", 31),
                                         ("an owl on a branch", 32)],
                     ("a watercolor of a harbour", 31)),
    "sd21-default": ("sd21", "default", [(p, 51 + i) for i, p in enumerate(SD21_PROMPTS)], None),
}


def _serve(pipe, prompts, solo, size: int, guidance: float):
    """A ServingEngine over ``pipe``: ``prompts`` submitted together (one
    signature, so they co-batch), then ``solo`` alone, after the same
    requests with other seeds, which run each bucket's loop eagerly and
    capture it. Returns the counted requests' images, the launches of the
    first requests and of the counted (replayed) ones, and the graphs."""
    from gpubench.tokenizer import StubTokenizer
    from stabletriton_tpu_torch.runtime.serving import Request, ServingEngine

    tok = StubTokenizer(pipe.clip_config.bos_token_id, pipe.clip_config.eos_token_id)
    engine = ServingEngine(pipe, tok, tok, max_wait_s=0.5)
    kw = dict(height=size, width=size, steps=STEPS, guidance_scale=guidance, solver="euler")

    def run(shift):
        futs = [engine.submit(Request(prompt=p, seed=s + shift, **kw)) for p, s in prompts]
        done = [f.result(timeout=900) for f in futs]
        if solo is not None:
            done.append(engine.submit(Request(prompt=solo[0], seed=solo[1] + shift,
                                              **kw)).result(timeout=900))
        return done

    try:
        before = _snapshot()
        run(1000)
        first = _since(before)
        before = _snapshot()
        done = run(0)
        counted = _since(before)
    finally:
        engine.close()
    return done, first, counted, sum(len(p.loop.captured) for p in pipe._cache.values())


@pytest.fixture(scope="module")
def reference_serving(full_width_unets, sdxl_other):
    """The reference binding (cuBLAS, cuDNN, SDPA) serving SDXL-base's
    two co-batched requests and the first one's seed alone, once."""
    _, _, prompts, solo = SERVE_CASES["sdxl-reference"]
    pipe = _sdxl_pipeline(full_width_unets, sdxl_other, "reference")
    out = _serve(pipe, prompts, solo, 1024, 5.0)
    del pipe
    gc.collect()
    yield out


def _serving_pipeline(family, binding, full_width_unets, sdxl_other, device):
    """SDXL-base, SD1.5 (CLIP-L in both encoder slots) or SD2.1-768 (its
    23-layer OpenCLIP-H text tower, pad id 0, v-prediction) at full width."""
    import dataclasses

    from stabletriton_tpu_torch.models import clip as tclip
    from stabletriton_tpu_torch.models import vae as tvae
    from stabletriton_tpu_torch.models.unet import init_unet_params, sd21_unet_config
    from stabletriton_tpu_torch.runtime import pipeline as tpipe
    from stabletriton_tpu_torch.runtime.scheduler import SchedulerConfig

    if family == "sdxl":
        return _sdxl_pipeline(full_width_unets, sdxl_other, binding)
    vcfg = tvae.sd15_vae_config()
    if family == "sd15":
        ucfg, _, unet = full_width_unets["sd15"]
        c1, seeds, kw = tclip.sd15_text_encoder_config(), (21, 22), {}
    else:
        ucfg = sd21_unet_config()
        unet = init_unet_params(ucfg, 0, device=device, dtype=torch.bfloat16)
        c1 = dataclasses.replace(tclip.sd2_text_encoder_config(), num_layers=23, pad_token_id=0)
        seeds = (61, 62)
        kw = {"scheduler_config": SchedulerConfig(prediction_type="v_prediction")}
    params = {"unet": unet, "text_encoder": tclip.init_clip_params(c1, seeds[0], device=device),
              "vae": tvae.init_vae_params(vcfg, seeds[1], device=device)}
    return tpipe.SDXLPipeline(unet_config=ucfg, clip_config=c1, clip2_config=c1, vae_config=vcfg,
                              params=params, compile_config=_config(binding), device=device, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_gpu_serving_at_full_width(cuda_device, full_width_unets, sdxl_other, reference_serving,
                                   case):
    """A ServingEngine over a full-width pipeline serves 4-step requests:
    two co-batched and the first one's seed alone (SD2.1: a bucket of
    eight). The images are finite, (size, size, 3) and inside [-1, 1]; the
    counted requests replay, one graph a bucket, and launch what the first
    (eager) ones did key by key; the same seed alone and co-batched differ
    by at most SOLO_VS_BATCHED_BOUND, and under an SDXL kernel binding by at
    most SOLO_VS_BATCHED_RATIO x the reference binding's diff. The launches
    (the UNet steps run read off conv_out's): the bf16 attention by kernel
    and class a step; each image's f32 decode (its convs by kernel, its
    attention on the 3xTF32 GEMM); under the default binding the kernel
    forms a step and the decoder's GroupNorms (f32) an image; under the
    fused-op binding K8-K11 a step and K9 once a decoder GroupNorm, every
    resnet K8 on the warp-specialised kernel and conv_out's on the 8-column
    form; under the all-kernel binding K8-K13 a step, K13 also the cross K/V
    precompute a generation and the decoder's attention projections an
    image. SD2.1's attention all at UNet batch 16, its loops v-prediction."""
    from stabletriton_tpu_torch.runtime import profiling

    family, binding, prompts, solo = SERVE_CASES[case]
    size, guidance = {"sdxl": (1024, 5.0), "sd15": (512, 7.5), "sd21": (768, 7.5)}[family]
    profiling.reset()
    if case == "sdxl-reference":
        done, first, counted, graphs = reference_serving
    else:
        pipe = _serving_pipeline(family, binding, full_width_unets, sdxl_other, cuda_device)
        norms = sum(1 for k in pipe.params["vae"] if k.endswith(NORMS))
        done, first, counted, graphs = _serve(pipe, prompts, solo, size, guidance)
        del pipe
        gc.collect()
    for img in done:
        assert img.shape == (size, size, 3) and np.isfinite(img).all()
        assert -1.0 <= img.min() and img.max() <= 1.0
    assert counted == first
    assert graphs == 1 + (solo is not None)
    if solo is not None:
        diff = float(np.abs(done[0] - done[2]).max())
        assert diff <= SOLO_VS_BATCHED_BOUND
        if family == "sdxl" and binding != "reference":
            ref = reference_serving[0]
            assert diff <= SOLO_VS_BATCHED_RATIO * float(np.abs(ref[0] - ref[2]).max())
    if binding == "reference":
        return
    images = len(done)
    steps = sum(n for name in ("K6", "K8") for key, n in counted[name].items()
                if key.startswith("wgmma_bf16 ") and key.split("->")[1].split()[0] == "4")
    assert steps > 0 and steps % STEPS == 0
    per_step = SD21_ATTENTION if family == "sd21" else STEP_LAUNCHES[family]["attention"]
    assert _attention_by(counted["attention"]) == {
        k: {cls: n * steps for cls, n in by.items()} for k, by in per_step.items()}
    assert {k: sum(n for key, n in counted["K6"].items() if key.split()[0] == k)
            for k in DECODE_CONVS} == {k: n * images for k, n in DECODE_CONVS.items()}
    assert _attention_by(counted["attention"], ("wgmma_tf32x3",)) == {
        "wgmma_tf32x3": {"K3": images}}
    counts, _ = _expected(family, binding, steps)
    f32_norms = sum(n for name in ("K9", "K9_bf16apply") for key, n in counted[name].items()
                    if key.startswith("f32"))
    assert f32_norms == norms * images
    if binding == "default":
        counts["K9_bf16apply"] += norms * images
        keys = FORMS
    elif binding == "fused_ops":
        counts["K9"] += norms * images
        keys = ("K8", "K9", "K10", "K11")
        assert _by_kernel(counted["K8"]) == {"wgmma_gn_bf16": (counts["K8"] // steps - 1) * steps,
                                             "wgmma_bf16": steps}
    else:
        gens = steps // STEPS
        counts["K9"] += norms * images
        counts["K13"] += STEP_LAUNCHES[family]["precompute"] * gens + VAE_LINEARS * images
        keys = OPT_KERNELS
        assert sum(n for key, n in counted["K13"].items() if " k=2048 " in key) == (
            STEP_LAUNCHES[family]["precompute"] * gens)
        assert sum(n for key, n in counted["K13"].items()
                   if key.startswith("wgmma_tf32x3 ")) == VAE_LINEARS * images
    assert {k: sum(counted[k].values()) for k in keys} == {k: counts[k] for k in keys}
    if family == "sd21":
        assert steps == STEPS and images == len(SD21_PROMPTS)
        assert {int(f[2:]) for key in counted["attention"] if "tf32" not in key
                for f in key.split() if f.startswith("b=")} == {16}
        loops = [s.attrs.get("prediction") for s in profiling.spans() if s.name == "pipeline.loop"]
        assert loops and set(loops) == {"v_prediction"}


# One image-path request's pieces. The SDXL refiner's step (44 transformer
# blocks, 22 resnets, 11 Transformer2D): self-attention at 64^2 (h=12) 20 x
# K2, at 32^2 and the mid block's 16^2 (h=24) 24 x K1, 44 cross x K1 on the
# tiny-KV kernel; 49 bf16 3x3 convs; all-kernel K8 45, K9 11, K10 132, K11
# 44, K12 2, K13 312, and 44 in the precompute. The 9-channel UNet launches
# SDXL-base's.
REFINER_STEP = {"attention": {"wgmma_bf16": {"K1": 24, "K2": 20},
                              "tinykv_wgmma_bf16": {"K1": 44}},
                "convs": 49, "precompute": 44,
                "all": {"K8": 45, "K9": 11, "K10": 132, "K11": 44, "K12": 2, "K13": 312}}
# each kind's pipelines and pieces (None: its launches are held only to the
# first call's)
IMAGE_KINDS = {
    "txt2img": (("base",), [("sdxl_step", STEPS), ("sdxl_generation", 1), ("decode", 1)]),
    "img2img_image": (("base",), [("encode", 1), ("sdxl_step", STEPS // 2),
                                  ("sdxl_generation", 1)]),
    "inpaint": (("inpaint",), [("encode", 1), ("sdxl_step", STEPS), ("sdxl_generation", 1),
                               ("decode", 1)]),
    "inpaint heun, interval, deep_cache=2": (("inpaint",), None),
    "two_stage": (("base", "refiner"), [("sdxl_step", STEPS), ("sdxl_generation", 1),
                                        ("refiner_step", 1), ("refiner_generation", 1),
                                        ("decode", 1)]),
}


def _image_parts(decode_norms: int, encode_norms: int) -> dict:
    x = STEP_LAUNCHES["sdxl"]
    return {
        "sdxl_step": {"attention": x["attention"], "conv": {"wgmma_bf16": x["convs"]},
                      "all": x["all"]},
        "refiner_step": {"attention": REFINER_STEP["attention"],
                         "conv": {"wgmma_bf16": REFINER_STEP["convs"]}, "all": REFINER_STEP["all"]},
        "sdxl_generation": {"all": {"K13": x["precompute"]}},
        "refiner_generation": {"all": {"K13": REFINER_STEP["precompute"]}},
        "encode": {"conv": ENCODE_CONVS, "f32_attention": 1,
                   "all": {"K9": encode_norms, "K13": VAE_LINEARS}},
        "decode": {"conv": DECODE_CONVS, "f32_attention": 1,
                   "all": {"K9": decode_norms, "K13": VAE_LINEARS}},
    }


def _summary(delta: dict) -> dict:
    """A request's launches (``_since``): bf16 attention by class and
    kernel, f32 attention in all, the 3x3 convs by kernel, K8-K13."""
    attn, f32 = {}, 0
    for key, n in delta["attention"].items():
        cls, kernel = key.split()[:2]
        if kernel == "wgmma_tf32x3":
            f32 += n
        else:
            attn[f"{cls} {kernel}"] = attn.get(f"{cls} {kernel}", 0) + n
    return {"attention": attn, "f32_attention": f32, "conv": _by_kernel(delta["K6"], delta["K8"]),
            "opt": {k: sum(delta[k].values()) for k in OPT_KERNELS}}


def _expected_summary(parts: dict, pieces, all_kernels: bool) -> dict:
    """``_summary``'s form of ``pieces`` ((piece, times), ...)."""
    attn, f32, conv = {}, 0, {}
    opt = dict.fromkeys(OPT_KERNELS, 0)
    for piece, times in pieces:
        p = parts[piece]
        for kernel, by_class in p.get("attention", {}).items():
            for cls, n in by_class.items():
                attn[f"{cls} {kernel}"] = attn.get(f"{cls} {kernel}", 0) + n * times
        f32 += p.get("f32_attention", 0) * times
        for kernel, n in p.get("conv", {}).items():
            conv[kernel] = conv.get(kernel, 0) + n * times
        k8 = p.get("all", {}).get("K8", 0) * times
        if all_kernels:
            for k, n in p.get("all", {}).items():
                opt[k] += n * times
            conv = _k8_split(conv, k8, times)
    return {"attention": attn, "f32_attention": f32, "conv": conv, "opt": opt}


@pytest.fixture(scope="module")
def image_assets(full_width_unets, sdxl_other):
    """The image paths' weights beside SDXL-base's: the VAE encoder, the
    9-channel UNet (SDXL-base's tensors with a new conv_in), the SDXL
    refiner's UNet; two calls' prompts, seeds and 1024^2 images; a centred
    square mask."""
    import dataclasses

    from stabletriton_tpu_torch.models import vae as tvae
    from stabletriton_tpu_torch.models.unet import init_unet_params, sdxl_refiner_unet_config

    cfg, _, params = full_width_unets["sdxl"]
    _, _, vcfg, other = sdxl_other
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(66)
    rcfg = sdxl_refiner_unet_config()
    mask = torch.zeros((1, 1024, 1024, 1), device=dev)
    mask[:, 256:768, 256:768] = 1.0

    def image(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        return torch.rand((1, 1024, 1024, 3), generator=g, device=dev) * 2 - 1

    yield {"vae": {**other["vae"], **tvae.init_vae_encoder_params(vcfg, 4, device=dev)},
           "cfg9": dataclasses.replace(cfg, in_channels=9),
           "unet9": {**params, "conv_in.weight": (torch.randn(
               (3, 3, 9, cfg.block_out_channels[0]), generator=gen, device=dev) / 9.0).to(
                   torch.bfloat16)},
           "rcfg": rcfg, "refiner": init_unet_params(rcfg, 5, device=dev, dtype=torch.bfloat16),
           "calls": [("a lighthouse at dusk", 11, image(101)), ("a bowl of ramen", 12, image(102))],
           "mask": mask}
    torch.cuda.empty_cache()


def _image_pipes(kind, binding, full_width_unets, sdxl_other, assets, **kw) -> list:
    from stabletriton_tpu_torch.runtime import pipeline as tpipe

    c1, c2, vcfg, other = sdxl_other
    pipes = []
    for name in IMAGE_KINDS[kind][0]:
        if name == "refiner":
            pipes.append(tpipe.SDXLPipeline(
                unet_config=assets["rcfg"], clip_config=c2, clip2_config=c2, vae_config=vcfg,
                params={"unet": assets["refiner"], "text_encoder_2": other["text_encoder_2"],
                        "vae": other["vae"]},
                compile_config=_config(binding), device="cuda", **kw))
        elif name == "inpaint":
            pipes.append(_sdxl_pipeline(full_width_unets, sdxl_other, binding,
                                        unet=assets["unet9"], unet_config=assets["cfg9"],
                                        params={"vae": assets["vae"]}, **kw))
        else:
            pipes.append(_sdxl_pipeline(full_width_unets, sdxl_other, binding,
                                        params={"vae": assets["vae"]}, **kw))
    return pipes


def _image_request(kind, pipes, call, mask):
    """A request's latents through its entry point: the loop's output,
    taken where the decode receives it (img2img_image returns it)."""
    from stabletriton_tpu_torch.runtime import pipeline as tpipe

    prompt, seed, img = call
    ids1, ids2 = _tokens(pipes[0], prompt)
    if kind == "img2img_image":
        return pipes[0].img2img_image(img, ids1, ids2, steps=STEPS, strength=0.5, seed=seed,
                                      decode=False)
    if kind == "txt2img":
        run = lambda: pipes[0].txt2img(ids1, ids2, height=1024, width=1024,  # noqa: E731
                                       steps=STEPS, seed=seed)
    elif kind == "inpaint":
        run = lambda: pipes[0].inpaint(img, mask, ids1, ids2, steps=STEPS, seed=seed)  # noqa: E731
    elif kind.startswith("inpaint"):
        run = lambda: pipes[0].inpaint(img, mask, ids1, ids2, steps=STEPS,  # noqa: E731
                                       seed=seed, solver="heun", deep_cache=2,
                                       **_modes()["euler, interval"])
    else:
        run = lambda: tpipe.TwoStageSDXL(base=pipes[0], refiner=pipes[1]).txt2img(  # noqa: E731
            ids1, ids2, height=1024, width=1024, steps=STEPS, refiner_strength=0.25, seed=seed)
    (latents,), _ = _decoded(run)
    return latents


def _image_eager(kind, pipes, call, mask):
    """The eager loop of the request's program (the refiner's for two_stage)
    on the inputs its entry point makes for ``call``, and that program."""
    from stabletriton_tpu_torch import ops as tops
    from stabletriton_tpu_torch.compile import resolve_binding
    from stabletriton_tpu_torch.runtime import pipeline as tpipe

    prompt, seed, img = call
    pipe = pipes[0]
    ids1, ids2 = _tokens(pipe, prompt)
    (prog,) = pipe._cache.values()
    if kind == "img2img_image":
        with torch.inference_mode(), tops.use_backends(resolve_binding(pipe.compile_config)):
            encoded = tpipe._encode_images(pipe.vae_config, pipe.params["vae"], img)
        return _eager(pipe, prog, ids1, ids2, [seed], encoded), prog
    if kind.startswith("inpaint"):
        return _eager(pipe, prog, ids1, ids2, [seed], img, mask), prog
    base = _eager(pipe, prog, ids1, ids2, [seed])
    if kind == "txt2img":
        return base, prog
    refiner = pipes[1]
    (prog,) = refiner._cache.values()
    ids = refiner._ids(ids2, refiner.clip2_config.empty_prompt_ids(1, ids2.shape[1]))
    with torch.inference_mode(), tops.use_backends(resolve_binding(refiner.compile_config)):
        return prog.loop.__wrapped__(refiner.params["unet"], *prog.loop_inputs(
            refiner.params, base, None, ids[0], None, ids[1], [seed + 1])), prog


@pytest.fixture(scope="module")
def image_references(full_width_unets, sdxl_other, image_assets):
    """The reference binding's request of each image-path kind on the second
    call, run eagerly (its yardstick), made once; it launches no kernel of
    the port."""
    out = {}
    for kind in IMAGE_KINDS:
        pipes = _image_pipes(kind, "reference", full_width_unets, sdxl_other, image_assets,
                             _graphs=_eager_graphs())
        before = _snapshot()
        out[kind] = _image_request(kind, pipes, image_assets["calls"][1], image_assets["mask"])
        assert not any(_since(before).values()), kind
        del pipes
        gc.collect()
    yield out


@pytest.mark.gpu
@pytest.mark.parametrize("binding", ["default", "all_kernels"])
def test_gpu_full_width_image_paths(cuda_device, full_width_unets, sdxl_other, image_assets,
                                    image_references, binding):
    """The image-conditioned paths at 1024^2, 4 Euler steps, batch 1, random
    weights. The f32 VAE encode against the reference binding's (TF32 off):
    (1, 128, 128, 4), finite, max abs within 1e-4 of the largest latent,
    its launches as ``_expected_summary`` counts them. Then warmup and the
    same signature's txt2img (which must capture nothing more),
    img2img_image at strength 0.5, inpaint on the 9-channel UNet (Euler,
    and Heun with a guidance interval and DeepCache 2), TwoStageSDXL with
    the refiner at strength 0.25; each twice (the first call captures, the
    second replays with another prompt, image and seed): both the eager loop
    on their inputs bit for bit, finite, one graph; the replay counting the
    first call's launches, which the plain kinds' pieces count; the latents'
    MSE against the reference binding's request at most MODE_MSE_RATIO x
    the binding's plain txt2img MSE."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import resolve_binding
    from stabletriton_tpu_torch.runtime import pipeline as tpipe

    _, _, vcfg, _ = sdxl_other
    vae, calls, mask = image_assets["vae"], image_assets["calls"], image_assets["mask"]
    parts = _image_parts(sum(1 for k in vae if k.startswith("decoder.") and k.endswith(NORMS)),
                         sum(1 for k in vae if k.startswith("encoder.") and k.endswith(NORMS)))
    all_kernels = binding == "all_kernels"
    encoded = {}
    with torch.inference_mode():
        for name in ("reference", binding):
            before = _snapshot()
            with ops.use_backends(resolve_binding(_config(name))):
                encoded[name] = tpipe._encode_images(vcfg, vae, calls[0][2])
            torch.cuda.synchronize()
            if name == binding:
                assert _summary(_since(before)) == _expected_summary(parts, [("encode", 1)],
                                                                     all_kernels)
    got, ref = encoded[binding], encoded["reference"]
    assert got.shape == (1, 128, 128, 4) and torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    mse = {}
    for kind, (_, pieces) in IMAGE_KINDS.items():
        pipes = _image_pipes(kind, binding, full_width_unets, sdxl_other, image_assets)
        if kind == "txt2img":
            pipes[0].warmup(height=1024, width=1024, steps=STEPS)
            (warm,) = next(iter(pipes[0]._cache.values())).loop.captured.values()
        outs, counts = [], []
        for call in calls:
            before = _snapshot()
            outs.append(_image_request(kind, pipes, call, mask))
            torch.cuda.synchronize()
            counts.append(_since(before))
        assert counts[1] == counts[0], kind
        if pieces is not None:
            assert _summary(counts[1]) == _expected_summary(parts, pieces, all_kernels), kind
        for call, out in zip(calls, outs):
            eager, prog = _image_eager(kind, pipes, call, mask)
            assert torch.isfinite(out.float()).all() and torch.equal(out, eager), kind
            assert len(prog.loop.captured) == 1, kind
        if kind == "txt2img":
            (entry,) = prog.loop.captured.values()
            assert entry is warm and len(pipes[0]._cache) == 1
        mse[kind] = (outs[1].float() - image_references[kind].float()).square().mean().item()
        del pipes, prog
        gc.collect()
        torch.cuda.empty_cache()
    for kind, m in mse.items():
        assert m <= MODE_MSE_RATIO * mse["txt2img"], (kind, mse)


# --------------------------------------------------------------------------
# the front door at full width: checkpoints written here from seeded random
# weights, loaded onto the card; the diffusers frontend
# --------------------------------------------------------------------------

# SDXL-base's unet/config.json (stabilityai/stable-diffusion-xl-base-1.0), the
# fields the loader reads
SDXL_UNET_JSON = {"in_channels": 4, "out_channels": 4, "block_out_channels": [320, 640, 1280],
                  "down_block_types": ["DownBlock2D", "CrossAttnDownBlock2D",
                                       "CrossAttnDownBlock2D"],
                  "layers_per_block": 2, "transformer_layers_per_block": [1, 2, 10],
                  "attention_head_dim": [5, 10, 20], "cross_attention_dim": 2048,
                  "norm_num_groups": 32, "addition_embed_type": "text_time",
                  "addition_time_embed_dim": 256, "projection_class_embeddings_input_dim": 2816,
                  "flip_sin_to_cos": True, "freq_shift": 0}
VOCAB_WORDS = ("a", "photo", "of", "lighthouse", "at", "dusk", "bowl", "ramen", "cat",
               "watercolor", "harbour", "highly", "detailed", "dream")


def _write_vocab(d) -> None:
    """A synthetic CLIP vocabulary: every byte's symbol with and without
    </w>, the merges that build VOCAB_WORDS, and the start / end tokens at
    CLIP's ids 49406 / 49407."""
    import json

    from stabletriton_tpu_torch.io.tokenizer import _byte_encoder

    d.mkdir(parents=True, exist_ok=True)
    enc = _byte_encoder()
    vocab = {enc[b]: b for b in range(256)}
    vocab.update({enc[b] + "</w>": 256 + b for b in range(256)})
    merges = []
    for word in VOCAB_WORDS:
        syms = list(word[:-1]) + [word[-1] + "</w>"]
        while len(syms) > 1:
            merges.append(f"{syms[0]} {syms[1]}")
            syms = [syms[0] + syms[1]] + syms[2:]
            vocab.setdefault(syms[0], len(vocab))
    vocab["<|startoftext|>"], vocab["<|endoftext|>"] = 49406, 49407
    (d / "vocab.json").write_text(json.dumps(vocab))
    (d / "merges.txt").write_text("#version: 0.2\n" + "\n".join(merges) + "\n")


def _torch_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """This package's layout -> torch's (a view): the inverse of
    io.safetensors_io.to_framework_layout."""
    if not name.endswith(".weight") or "embedding" in name.rsplit(".", 2)[-2]:
        return t
    if t.dim() == 2:
        return t.t()
    if t.dim() == 4:
        return t.permute(3, 2, 0, 1)
    return t


@pytest.mark.gpu
def test_gpu_loaded_sdxl_directory_equals_the_pipeline_in_memory(cuda_device, tmp_path):
    """A full-width SDXL-base diffusers directory (f16 seeded random weights:
    the UNet, both text encoders, the whole VAE, unet/config.json, synthetic
    tokenizer files) written by the port's safetensors writer; load_sdxl
    loads it onto the card with SDXL-base's UNet config and keys; two
    prompts through its tokenizers, two 1024^2 4-step requests (capture,
    replay): each image finite, (1, 1024, 1024, 3) and bit for bit the same
    request on a pipeline built in memory from the same f16 tensors; the
    two images differ."""
    import json

    from stabletriton_tpu_torch.io import pretrained
    from stabletriton_tpu_torch.io.safetensors_io import write_safetensors
    from stabletriton_tpu_torch.io.tokenizer import sdxl_tokenize
    from stabletriton_tpu_torch.models import clip as tclip
    from stabletriton_tpu_torch.models import vae as tvae
    from stabletriton_tpu_torch.models.unet import init_unet_params, sdxl_base_unet_config
    from stabletriton_tpu_torch.runtime import pipeline as tpipe

    f16 = torch.float16
    ucfg = sdxl_base_unet_config()
    c1, c2 = tclip.sdxl_text_encoder_config(), tclip.sdxl_text_encoder_2_config()
    vcfg = tvae.sdxl_vae_config()
    comps = {"unet": init_unet_params(ucfg, 70, device=cuda_device, dtype=f16),
             "text_encoder": tclip.init_clip_params(c1, 71, device=cuda_device, dtype=f16),
             "text_encoder_2": tclip.init_clip_params(c2, 72, device=cuda_device, dtype=f16),
             "vae": {**tvae.init_vae_params(vcfg, 73, device=cuda_device, dtype=f16),
                     **tvae.init_vae_encoder_params(vcfg, 74, device=cuda_device, dtype=f16)}}
    for comp, params in comps.items():
        (tmp_path / comp).mkdir()
        name = "model" if comp.startswith("text") else "diffusion_pytorch_model"
        write_safetensors(tmp_path / comp / f"{name}.safetensors",
                          {k: _torch_layout(k, v) for k, v in params.items()})
    (tmp_path / "unet" / "config.json").write_text(json.dumps(SDXL_UNET_JSON))
    for sub in ("tokenizer", "tokenizer_2"):
        _write_vocab(tmp_path / sub)
    pipe, tok1, tok2 = pretrained.load_sdxl(tmp_path, device=cuda_device)
    decoder = set(tvae.vae_decoder_param_shapes(vcfg))
    memory = tpipe.SDXLPipeline(
        unet_config=ucfg, clip_config=c1, clip2_config=c2, vae_config=vcfg,
        params={"unet": comps["unet"],
                **{k: {n: t.float() for n, t in comps[k].items()}
                   for k in ("text_encoder", "text_encoder_2")},
                "vae": {n: t.float() for n, t in comps["vae"].items() if n in decoder}},
        compile_config=CompileConfig(), device=cuda_device)
    assert pipe.unet_config == ucfg and pipe.params["unet"].keys() == memory.params["unet"].keys()
    prompts = [("a photo of a lighthouse at dusk", 11), ("a bowl of ramen, highly detailed", 12)]
    images = {}
    for name, p in (("loaded", pipe), ("in memory", memory)):
        for i, (prompt, seed) in enumerate(prompts):
            ids1, ids2 = sdxl_tokenize(tok1, tok2, [prompt])
            images[name, i] = p.txt2img(ids1, ids2, height=1024, width=1024, steps=STEPS,
                                        seed=seed)
        (prog,) = p._cache.values()
        assert len(prog.loop.captured) == 1
    for i in range(len(prompts)):
        a = images["loaded", i]
        assert a.shape == (1, 1024, 1024, 3) and torch.isfinite(a).all()
        assert torch.equal(a, images["in memory", i])
    assert not torch.equal(images["loaded", 0], images["loaded", 1])


@pytest.mark.gpu
def test_gpu_sd2_requests_at_768(cuda_device):
    """SD2.x at full width as a single file loads it (the UNet, OpenCLIP-H's
    text tower read at its penultimate layer, the SD1.x VAE decoder; f16
    seeded random weights, the encoders and decoder in f32): 768^2 4-step
    requests under the default and the all-kernel binding, each twice
    (capture, replay with another prompt and seed): images finite, (1, 768,
    768, 3) inside [-1, 1]; latents finite and the eager loop's on their
    inputs bit for bit; one graph; the all-kernel binding's latent MSE
    against the reference binding's same request at most MODE_MSE_RATIO x
    the default binding's. The single file itself (names, family, clip_skip,
    every tensor as written) is tests/test_torch_port_single_file.py's."""
    from stabletriton_tpu_torch.models import clip as tclip
    from stabletriton_tpu_torch.models import vae as tvae
    from stabletriton_tpu_torch.models.unet import init_unet_params, sd21_unet_config
    from stabletriton_tpu_torch.runtime import pipeline as tpipe

    f16 = torch.float16
    ucfg, ccfg, vcfg = (sd21_unet_config(), tclip.sd2_text_encoder_config(),
                        tvae.sd15_vae_config())
    params = {"unet": init_unet_params(ucfg, 80, device=cuda_device, dtype=f16),
              "text_encoder": {k: v.float() for k, v in tclip.init_clip_params(
                  ccfg, 81, device=cuda_device, dtype=f16).items()},
              "vae": {k: v.float() for k, v in tvae.init_vae_params(
                  vcfg, 82, device=cuda_device, dtype=f16).items()}}
    pipes = {name: tpipe.SDXLPipeline(
        unet_config=ucfg, clip_config=ccfg, clip2_config=ccfg, vae_config=vcfg, params=params,
        compile_config=_config(name), clip_skip=2, device=cuda_device,
        **({"_graphs": _eager_graphs()} if name == "reference" else {}))
        for name in ("reference", "default", "all_kernels")}
    calls = [("a watercolor of a harbour", 21), ("a photo of a cat at dusk", 22)]

    def request(pipe, prompt, seed):
        ids1, ids2 = _tokens(pipe, prompt)
        (lat,), img = _decoded(lambda: pipe.txt2img(ids1, ids2, height=768, width=768,
                                                    steps=STEPS, seed=seed))
        assert img.shape == (1, 768, 768, 3) and torch.isfinite(img).all()
        assert -1.0 <= img.min().item() and img.max().item() <= 1.0
        return lat

    reference = {seed: request(pipes["reference"], prompt, seed) for prompt, seed in calls}
    mse = {}
    for name in ("default", "all_kernels"):
        pipe = pipes[name]
        outs = [request(pipe, prompt, seed) for prompt, seed in calls]
        (prog,) = pipe._cache.values()
        assert len(prog.loop.captured) == 1
        for (prompt, seed), out in zip(calls, outs):
            assert torch.isfinite(out.float()).all()
            assert torch.equal(out, _eager(pipe, prog, *_tokens(pipe, prompt), [seed]))
        mse[name] = max((o.float() - reference[seed].float()).square().mean().item()
                        for o, (_, seed) in zip(outs, calls))
    assert mse["all_kernels"] <= MODE_MSE_RATIO * max(mse["default"], 1e-12)


@pytest.mark.gpu
def test_gpu_diffusers_frontend_at_full_width(cuda_device):
    """A duck-typed full-width SDXL-base UNet module (torch layout, bf16 on
    the card) through frontends.diffusers.compile under the default binding:
    its config SDXL-base's; two steps (capture, replay) each bit for bit
    unet_apply on the params the compiled UNet holds; a DeepCache pair (its
    full step the plain step's bits, its shallow one unet_apply_shallow on
    the carried cache); one CompVisUNetShim call with a 2816-wide y and
    zero-width time ids, bit for bit unet_apply on that y."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import resolve_binding
    from stabletriton_tpu_torch.frontends import diffusers as fe
    from stabletriton_tpu_torch.frontends.sgm import CompVisUNetShim
    from stabletriton_tpu_torch.models.unet import (init_unet_params, sdxl_base_unet_config,
                                                    unet_apply, unet_apply_shallow)
    from stabletriton_tpu_torch.ops import time_embed

    bf16, lat = torch.bfloat16, 128
    ucfg = sdxl_base_unet_config()

    class DuckUNet:
        config = SDXL_UNET_JSON

        def __init__(self, params):
            self._sd = {k: _torch_layout(k, v) for k, v in params.items()}

        def state_dict(self):
            return self._sd

    cc = CompileConfig()
    compiled = fe.compile(DuckUNet(init_unet_params(ucfg, 90, device=cuda_device, dtype=bf16)),
                          cc, device=cuda_device)
    assert compiled.unet_config == ucfg
    binding = resolve_binding(cc)
    gen = torch.Generator(device=cuda_device).manual_seed(91)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=cuda_device).to(bf16)

    ctx = randn(2, 77, ucfg.cross_attention_dim)
    pooled = randn(2, ucfg.projection_class_embeddings_input_dim - 6 * ucfg.addition_time_embed_dim)
    time_ids = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2, device=cuda_device)
    kw = {"added_cond_kwargs": {"text_embeds": pooled, "time_ids": time_ids}}

    def nhwc(x):
        return x.permute(0, 2, 3, 1).to(bf16).contiguous()

    def nchw(x):
        return x.float().permute(0, 3, 1, 2).to(bf16)

    def direct(sample, t, fn=unet_apply, y=pooled, tid=time_ids, **extra):
        with torch.inference_mode(), ops.use_backends(binding):
            return fn(ucfg, compiled.params, nhwc(sample), torch.full((2,), float(t),
                                                                      device=cuda_device),
                      ctx, y, tid, **extra)

    for t in (999.0, 501.0):
        sample = randn(2, 4, lat, lat)
        assert torch.equal(compiled(sample, t, ctx, **kw).sample, nchw(direct(sample, t)))
    assert len(compiled._fn.captured) == 1
    dc = fe.CompiledUNet.from_params(ucfg, compiled.params, cc, deep_cache=2, device=cuda_device)
    s0, s1 = randn(2, 4, lat, lat), randn(2, 4, lat, lat)
    assert torch.equal(dc(s0, 900.0, ctx, **kw).sample, compiled(s0, 900.0, ctx, **kw).sample)
    shallow = dc(s1, 800.0, ctx, **kw).sample
    _, cache = direct(s0, 900.0, return_cache=True)
    assert torch.equal(shallow, nchw(direct(s1, 800.0, unet_apply_shallow, cache=cache)))
    y = torch.cat([pooled, time_embed(time_ids.reshape(-1), dim=ucfg.addition_time_embed_dim
                                      ).to(bf16).reshape(2, -1)], dim=-1)
    assert y.shape == (2, ucfg.projection_class_embeddings_input_dim)
    x = randn(2, 4, lat, lat)
    got = CompVisUNetShim(compiled)(x, timesteps=torch.tensor([700.0], device=cuda_device),
                                    context=ctx, y=y)
    assert torch.equal(got, nchw(direct(x, 700.0, y=y, tid=torch.zeros((2, 0),
                                                                       device=cuda_device))))


# --------------------------------------------------------------------------
# runtime/profiling.py, autotune, fft_conv and the mesh on the card
# --------------------------------------------------------------------------


@pytest.mark.gpu
def test_gpu_bench_fn_agrees_with_cuda_events_and_the_trace_names_the_kernel(cuda_device,
                                                                              tmp_path):
    """bench_fn on K2's shape (self-attention S=4096 h=10 d=64 bf16 against a
    fused KV buffer, chained through q) within 10% of CUDA events on the same
    call, in turns (events, bench_fn, bench_fn, events), every launch K2 on
    attn_wgmma_bf16; profiling.trace around a few launches writes a Chrome
    trace naming the kernel (a session that records no kernel, as one now
    and then does, is traced again, at most three times)."""
    import json

    from stabletriton_tpu_torch.runtime import profiling

    gen = torch.Generator(device=cuda_device).manual_seed(88)
    q = torch.randn((2, 4096, 640), generator=gen, device=cuda_device).to(torch.bfloat16)
    kv = torch.randn((2, 4096, 1280), generator=gen, device=cuda_device).to(torch.bfloat16)

    def call(q):
        return tfa.flash_attention_kv(q, kv, num_heads=10)

    before = dict(tfa.LAUNCHES.by_key)
    events = [kernel_table.events_ms(lambda: call(q), 20)]
    bench = [profiling.bench_fn(call, q) * 1e3 for _ in range(2)]
    events.append(kernel_table.events_ms(lambda: call(q), 20))
    assert {tuple(k.split()[:2]) for k in _new_keys(tfa.LAUNCHES, before)} == {
        ("K2", "wgmma_bf16")}
    mean = sum(events) / len(events)
    assert max(abs(b - mean) for b in bench) <= 0.10 * mean, (bench, events)
    for _ in range(3):
        with profiling.trace(log_dir=str(tmp_path)) as path:
            for _ in range(5):
                call(q)
        with open(path) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
        if names:
            break
    assert any("attn_wgmma_bf16" in n for n in names), names


@pytest.fixture
def empty_table(monkeypatch, tmp_path):
    """The autotune table starts empty (no packaged file, a user cache under
    tmp_path) and the routes read it; the table as it was is back after."""
    monkeypatch.setattr(tautotune, "PACKAGED_DIR", tmp_path / "none")
    monkeypatch.setenv("ST_TPU_AUTOTUNE_CACHE", str(tmp_path / "user.json"))
    tautotune.reload()
    yield tmp_path / "user.json"
    monkeypatch.undo()
    tautotune.reload()


@pytest.mark.gpu
def test_gpu_tuned_plans_hold_the_plain_versions(cuda_device, empty_table, monkeypatch):
    """Autotune on the card from an empty table: the fitted rule's two
    recorded misses ((154,1024)@(1024,640), (128,1280)@(1280,1280)), K8 at
    SDXL's 128^2 320->320 and the tiny-KV attention of SDXL's 64^2
    cross-attention, tuned; the route then runs each on the table's plan
    within 2e-2 of the plain version. A small SDXL-shaped pipeline under the
    all-kernel binding with the pipeline's hook on (ST_TPU_AUTOTUNE=1): its
    first request tunes the signature, the second tunes nothing, both finite
    (that each route then takes the table's plan, tests/test_torch_port_autotune.py
    holds)."""
    import json

    gen = torch.Generator(device=cuda_device).manual_seed(71)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=cuda_device) * scale).to(torch.bfloat16)

    for m, k, n in [(154, 1024, 640), (128, 1280, 1280)]:
        tautotune.tune_linear(m, k, n)
        x, w, b = randn(m, k), randn(k, n, scale=k ** -0.5), randn(n)
        assert _rel_err(tlinear.linear(x, w, b), tlinear.linear_plain(x, w, b)) <= 2e-2
    tautotune.tune_conv(2, 128, 128, 320, 320, has_res=False, act=None, gn=True)
    x, w = randn(2, 128, 128, 320), randn(3, 3, 320, 320, scale=1 / 54)
    bias = torch.randn((2, 320), generator=gen, device=cuda_device)
    scale = torch.rand((2, 320), generator=gen, device=cuda_device) + 0.5
    shift = torch.randn((2, 320), generator=gen, device=cuda_device)
    assert _rel_err(tconv.gn_conv3x3(x, scale, shift, w, bias),
                    tconv.gn_conv3x3_plain(x, scale, shift, w, bias)) <= 2e-2
    tautotune.tune_attention_fused(2, 4096, 77, 10, 64)
    q, kv = randn(2, 4096, 640), randn(2, 77, 1280)
    assert _rel_err(tfa.flash_attention_kv(q, kv, num_heads=10),
                    tfa.attention_plain(q, *kv.chunk(2, -1), num_heads=10)) <= 2e-2
    monkeypatch.setenv("ST_TPU_AUTOTUNE", "1")
    pipe = _replay_pipeline(cuda_device)
    ids = _replay_ids(pipe, 1, 0)
    first = pipe.txt2img(ids, ids, seed=5, **REPLAY)
    entries = len(json.loads(empty_table.read_text()))
    again = pipe.txt2img(ids, ids, seed=6, **REPLAY)
    assert torch.isfinite(first.float()).all() and torch.isfinite(again.float()).all()
    assert len(json.loads(empty_table.read_text())) == entries


@pytest.mark.gpu
def test_gpu_fft_conv2d_vs_conv2d(cuda_device):
    """fft_conv2d (torch.fft, cuFFT) at (1, 128, 128, 4) with a 9 x 9 kernel
    against F.conv2d in depthwise form (TF32 off; the kernel flipped, since
    fft_conv2d convolves and conv2d correlates): within 1e-4 of the largest
    output."""
    import torch.nn.functional as F

    from stabletriton_tpu_torch.kernels.fft_conv import fft_conv2d

    gen = torch.Generator(device=cuda_device).manual_seed(81)
    x = torch.randn((1, 128, 128, 4), generator=gen, device=cuda_device)
    k = torch.randn((9, 9), generator=gen, device=cuda_device)
    weight = k.flip(0, 1)[None, None].expand(4, 1, 9, 9).contiguous()
    out = fft_conv2d(x, k)
    ref = F.conv2d(x.permute(0, 3, 1, 2), weight, padding=4, groups=4).permute(0, 2, 3, 1)
    assert out.shape == ref.shape and _rel_err(out, ref) <= 1e-4


@pytest.mark.gpu
def test_gpu_mesh_two_gloo_ranks_on_one_card(cuda_device, tmp_path):
    """runtime/mesh.py over torch.distributed, two spawned ranks on the one
    card over gloo with a TCP store on localhost (tests/torch_mesh_worker.py
    ``card_rank``): data=1 model=2, the full-width SDXL-base UNet step on
    rank-local shards (each rank half of to_q) against the unsharded step,
    MSE under the step gate; data=2 model=1, a replayed 1024^2 4-step
    txt2img of batch 2 (one graph a rank; images (2, 1024, 1024, 3), finite,
    inside [-1, 1]) against the unsharded pipeline's batch 2 within
    SOLO_VS_BATCHED_BOUND. An NCCL mesh is not run here (one card)."""
    import json
    import socket
    import time

    import torch.multiprocessing as mp

    import torch_mesh_worker

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = str(tmp_path / "rank%d.json")
    ctx = mp.start_processes(torch_mesh_worker.card_rank,
                             args=(2, f"tcp://127.0.0.1:{port}", out), nprocs=2, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + 400
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < deadline, "the two ranks did not finish in 400 s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    recs = [json.loads((tmp_path / f"rank{r}.json").read_text()) for r in range(2)]
    assert recs[0]["tp_finite"] and recs[0]["tp_mse"] <= STEP_MSE_GATE
    for r in recs:
        assert r["local_to_q"] == [640, 320] and r["dp_shape"] == [2, 1024, 1024, 3]
        assert r["dp_ok"] and r["dp_graphs"] == 1
    assert recs[0]["dp_max_abs"] <= SOLO_VS_BATCHED_BOUND

