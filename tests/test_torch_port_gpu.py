"""The CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips where torch sees no CUDA device.
The file imports neither JAX nor the JAX package, so it runs on a machine
that has only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py -q

Tolerances, relative to the largest plain output: 2e-2 for bf16 (a few bf16
ulps), 1e-4 for float32 (summation order only).
"""

import math

import pytest
import torch

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
def rule_plans():
    """The tests here hold the kernels at the fitted rules' plans
    (``wgmma_plan``, ``skinny_plan``, ``tiny_kv_plan``, ``kernel_name``),
    which their expected launch keys name; the autotune table, which the
    routes read first, is off for them (``chip_smoke.py`` phase 9t holds
    the tuned plans against the plain versions)."""
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


# chip_smoke.py's K9 shapes, then C not a multiple of the vector (vec = 1)
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
                                         (torch.float32, ((1 << 20) + 3,))])
def test_gpu_dropout_kernel_matches_plain_bit_for_bit(cuda_device, dtype, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    before = tdropout.LAUNCHES.count
    out = tdropout.dropout(x, 2**40 + 17, rate=0.1)
    again = tdropout.dropout(x, 2**40 + 17, rate=0.1)
    assert tdropout.LAUNCHES.count == before + 2
    assert torch.equal(out, again)
    assert torch.equal(out, tdropout.dropout_plain(x, 2**40 + 17, rate=0.1))
    assert not torch.equal(out, tdropout.dropout(x, 17, rate=0.1))
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
    """The program's own eager loop (``program.loop.__wrapped__``, from the
    same make_denoise_loop) on the inputs txt2img makes for ``ids``."""
    from stabletriton_tpu_torch import ops as tops
    from stabletriton_tpu_torch.compile import resolve_binding

    batch = ids.shape[0]
    prog = pipe._program(batch, kw["height"], kw["width"], kw["steps"], 5.0, "euler", True,
                         kw.get("guidance_interval"))
    neg = torch.as_tensor(pipe.clip_config.empty_prompt_ids(batch, ids.shape[1]),
                          dtype=torch.long)
    args = [t.to(pipe.device) for t in (ids, ids, neg, neg)]
    with torch.inference_mode(), tops.use_backends(resolve_binding(pipe.compile_config)):
        inputs = prog.loop_inputs(pipe.params, *args, seeds)
        return prog.loop.__wrapped__(pipe.params["unet"], *inputs), prog


def _all_launches():
    from stabletriton_tpu_torch.kernels import conv_direct, flash_attention, geglu, group_norm
    from stabletriton_tpu_torch.kernels import layer_norm, linear, time_embed

    counters = (conv_direct.LAUNCHES, conv_direct.GN_LAUNCHES, flash_attention.LAUNCHES,
                geglu.LAUNCHES, group_norm.LAUNCHES, layer_norm.LAUNCHES, linear.LAUNCHES,
                time_embed.LAUNCHES)
    return [dict(c.by_key) for c in counters]


def _launched(before):
    return [{k: n - b.get(k, 0) for k, n in now.items() if n != b.get(k, 0)}
            for now, b in zip(_all_launches(), before)]


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
        before = _all_launches()
        first = pipe.txt2img(ids, ids, seed=[1, 2], guidance_interval=gi, **REPLAY)
        eager_counts = _launched(before)
        before = _all_launches()
        second = pipe.txt2img(ids, ids, seed=[1, 2], guidance_interval=gi, **REPLAY)
        torch.cuda.synchronize()
        assert _launched(before) == eager_counts and any(eager_counts)
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


@pytest.mark.gpu
def test_gpu_failed_capture_raises(cuda_device, monkeypatch):
    """A step that synchronises the device while the loop is captured (a
    call a capture refuses) makes txt2img raise; nothing runs eagerly in
    the graph's place and nothing is kept; the pipeline captures again once
    the step is capturable."""
    from stabletriton_tpu_torch.runtime import pipeline as tpipe

    pipe = _replay_pipeline(cuda_device)
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


@pytest.fixture(scope="module")
def full_width_unets():
    """SDXL-base's and SD1.5's UNets at full width, random bf16 weights on
    the card, fused projections; made once for the module's tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stabletriton_tpu_torch.compile import fuse_attention_projections
    from stabletriton_tpu_torch.models.unet import (init_unet_params, sd15_unet_config,
                                                    sdxl_base_unet_config)

    dev = torch.device("cuda", 0)
    out = {}
    for family, cfg in (("sdxl", sdxl_base_unet_config()), ("sd15", sd15_unet_config())):
        out[family] = (cfg, fuse_attention_projections(
            init_unet_params(cfg, 0, device=dev, dtype=torch.bfloat16)))
    yield out
    out.clear()
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("binding", ["default", "all_kernels"])
@pytest.mark.parametrize("family,latent,depth,classes", [
    ("sdxl", 128, 1, set()), ("sdxl", 128, 2, {"K1", "K2"}), ("sd15", 64, 1, {"K3", "K5"})])
def test_gpu_shallow_pass_equals_full_pass(cuda_device, full_width_unets, family, latent, depth,
                                           classes, binding):
    """At full width, CFG batch 2, bf16, on the cross K/V cache: the shallow
    pass on the full pass's cache gives the full pass's eps bit for bit, and
    launches the attention classes its outermost levels hold (none for
    SDXL's depth-1 split)."""
    from stabletriton_tpu_torch import ops as tops
    from stabletriton_tpu_torch.compile import (ALL_KERNEL_OVERRIDES, CompileConfig,
                                                resolve_binding)
    from stabletriton_tpu_torch.models.unet import (precompute_cross_kv, unet_apply,
                                                    unet_apply_shallow)

    cfg, params = full_width_unets[family]
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    sample = torch.randn((2, latent, latent, 4), generator=gen, device=cuda_device)
    ctx = torch.randn((2, 77, cfg.cross_attention_dim), generator=gen, device=cuda_device)
    if cfg.has_addition_embedding:
        te = torch.randn((2, 1280), generator=gen, device=cuda_device).to(torch.bfloat16)
        tid = torch.tensor([[1024.0, 1024, 0, 0, 1024, 1024]] * 2, device=cuda_device)
    else:
        te = torch.zeros((2, 0), device=cuda_device, dtype=torch.bfloat16)
        tid = torch.zeros((2, 0), device=cuda_device)
    t = torch.full((2,), 500.0, device=cuda_device)
    config = CompileConfig(overrides=ALL_KERNEL_OVERRIDES if binding == "all_kernels" else ())
    with torch.inference_mode(), tops.use_backends(resolve_binding(config)):
        kv = precompute_cross_kv(cfg, params, ctx.to(torch.bfloat16))
        args = (cfg, params, sample.to(torch.bfloat16), t, None, te, tid)
        eps, cache = unet_apply(*args, cross_kv=kv, return_cache=True, cache_depth=depth)
        before = dict(tfa.LAUNCHES.by_key)
        shallow = unet_apply_shallow(*args, cache, cross_kv=kv, cache_depth=depth)
        torch.cuda.synchronize()
    launched = {k.split()[0] for k, n in tfa.LAUNCHES.by_key.items() if n != before.get(k, 0)}
    assert launched == classes
    assert torch.isfinite(eps.float()).all() and torch.equal(shallow, eps)


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
        before = _all_launches()
        outs.append((ids, seed, pipe.txt2img(ids, ids, seed=seed, **REPLAY, **kw)))
        torch.cuda.synchronize()
        counts.append(_launched(before))
    assert counts[0] == counts[1] and any(counts[0])
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
    outs, counts, seen = [], [], []
    real_decode = tpipe._decode_images
    tpipe._decode_images = lambda cfg, p, lat: seen.append(lat.clone()) or real_decode(cfg, p,
                                                                                      lat)
    try:
        for seed in (1, 2):
            gen = torch.Generator(device=cuda_device).manual_seed(seed)
            image = torch.rand((1, size, size, 3), generator=gen, device=cuda_device) * 2 - 1
            ids = _replay_ids(pipe, 1, seed)
            before = _all_launches()
            if kind == "inpaint":
                pipe.inpaint(image, mask, ids, ids, steps=3, seed=seed, **kw)
                got = seen[-1]
            else:
                got = pipe.img2img_image(image, ids, ids, steps=3, seed=seed, decode=False, **kw)
            torch.cuda.synchronize()
            counts.append(_launched(before))
            outs.append((image, ids, seed, got))
    finally:
        tpipe._decode_images = real_decode
    assert counts[0] == counts[1] and any(counts[0])
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
    from stabletriton_tpu_torch.runtime import pipeline as tpipe

    pipe = _image_pipeline(cuda_device, 4)
    size = REPLAY["height"]
    pipe.warmup(height=size, width=size, steps=3)
    (prog,) = pipe._cache.values()
    (entry,) = prog.loop.captured.values()
    ids = _replay_ids(pipe, 1, 4)
    seen = []
    real_decode = tpipe._decode_images
    tpipe._decode_images = lambda cfg, p, lat: seen.append(lat.clone()) or real_decode(cfg, p,
                                                                                      lat)
    try:
        pipe.txt2img(ids, ids, height=size, width=size, steps=3, seed=5)
    finally:
        tpipe._decode_images = real_decode
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
@pytest.mark.parametrize("mode", ["int8", "int8_conv"])
def test_gpu_turbo_step_replays_bit_for_bit(cuda_device, mode):
    """compile_unet_kv's turbo step on a small SDXL-shaped UNet: the first
    call (eager, then captured) and a replay equal the eager step bit for
    bit, and differ from the bf16 step."""
    from stabletriton_tpu_torch.compile import (CompileConfig, compile_unet_kv,
                                                fuse_attention_projections,
                                                quantize_linear_weights)
    from stabletriton_tpu_torch.models.unet import init_unet_params

    pipe = _replay_pipeline(cuda_device)
    ucfg = pipe.unet_config
    params = fuse_attention_projections(init_unet_params(ucfg, 0, device=cuda_device,
                                                         dtype=torch.bfloat16))
    qparams = quantize_linear_weights(params, min_dim=64, conv=mode == "int8_conv")
    assert any(isinstance(v, tuple) for v in qparams.values())
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    sample = torch.randn((2, 8, 8, 4), generator=gen, device=cuda_device).to(torch.bfloat16)
    ctx = torch.randn((2, 77, ucfg.cross_attention_dim), generator=gen,
                      device=cuda_device).to(torch.bfloat16)
    pooled = torch.randn((2, 16), generator=gen, device=cuda_device).to(torch.bfloat16)
    time_ids = torch.tensor([[64.0, 64, 0, 0, 64, 64]] * 2, device=cuda_device)
    t = torch.full((2,), 500.0, device=cuda_device)
    with torch.inference_mode():
        pre, _, step = compile_unet_kv(ucfg, CompileConfig(quantize=mode))
        kv = pre.__wrapped__(qparams, ctx)
        eager = step.__wrapped__(qparams, sample, t, kv, pooled, time_ids)
        first = step(qparams, sample, t, kv, pooled, time_ids)
        replay = step(qparams, sample, t, kv, pooled, time_ids)
        bpre, _, bstep = compile_unet_kv(ucfg, CompileConfig())
        exact = bstep.__wrapped__(params, sample, t, bpre.__wrapped__(params, ctx), pooled,
                                  time_ids)
    torch.cuda.synchronize()
    assert len(step.captured) == 1
    assert torch.isfinite(eager.float()).all()
    assert torch.equal(first, eager) and torch.equal(replay, eager)
    assert not torch.equal(eager, exact)


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
def test_gpu_default_binding_step_runs_the_kernel_forms(cuda_device):
    """Engagement: one eager SD1.5 UNet step (full width, 64^2 latent, CFG
    batch 2) under CompileConfig() raises the kernel forms' counters by the
    step's 61 GroupNorms, 48 LayerNorms and 16 GEGLUs, K9-K11's by nothing,
    and stays within the step gate of the step under the plain chains the
    binding had before."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import (CompileConfig, fuse_attention_projections,
                                                resolve_binding)
    from stabletriton_tpu_torch.models.unet import (init_unet_params, sd15_unet_config,
                                                    unet_apply)

    ucfg = sd15_unet_config()
    params = fuse_attention_projections(init_unet_params(ucfg, 0, device=cuda_device,
                                                         dtype=torch.bfloat16))
    gen = torch.Generator(device=cuda_device).manual_seed(37)
    sample = torch.randn((2, 64, 64, 4), generator=gen, device=cuda_device).to(torch.bfloat16)
    ctx = torch.randn((2, 77, 768), generator=gen, device=cuda_device).to(torch.bfloat16)
    none = torch.zeros((2, 0), device=cuda_device)
    t = torch.full((2,), 500.0, device=cuda_device)
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
    before = _all_launches()
    first = pipe.txt2img(ids, ids, seed=seeds, **SD21_CALL)
    eager_counts = _launched(before)
    before = _all_launches()
    second = pipe.txt2img(ids, ids, seed=seeds, **SD21_CALL)
    torch.cuda.synchronize()
    assert _launched(before) == eager_counts and any(eager_counts)
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
