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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape,act,tol", [
    (torch.bfloat16, (2, 9, 7, 64), None, 2e-2),     # vector loads, ragged chunks
    (torch.bfloat16, (3, 16, 16, 40), "silu", 2e-2),  # C/8 = 5 vectors: a masked slab
    (torch.float32, (1, 33, 31, 128), "silu", 1e-4),
    (torch.float32, (2, 5, 6, 12), None, 1e-4),      # C % 8, f32 vector width 4
])
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
             ((3, 5, 6, 10), torch.float32, None)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,act", GN_SHAPES)
def test_gpu_group_norm_one_entry_vs_plain(cuda_device, shape, dtype, act):
    """st_group_norm (stats, device fold, apply) against group_norm_plain:
    within 1 bf16 ulp of the largest output, or 1e-5 of the largest f32
    output (the moments are summed in another order); one launch counted;
    the same bits in a second run and for each image of a batch of two."""
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
    if x.numel() <= 2**23:
        other = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
        pair = tgn.group_norm(torch.cat([x[:1], other[:1]]), g, b, num_groups=groups, act=act)
        assert torch.equal(pair[:1], out[:1])


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,groups,pdtype", [
    ((2, 32, 32, 320), torch.bfloat16, 32, torch.float32),   # 10 channels a group
    ((2, 16, 16, 2560), torch.bfloat16, 32, torch.bfloat16),  # 80
    ((1, 33, 31, 128), torch.float32, 32, torch.float32),
    ((2, 5, 6, 80), torch.float32, 16, torch.bfloat16),       # 5: straddles the vectors
])
def test_gpu_group_norm_fold_vs_plain(cuda_device, shape, dtype, groups, pdtype):
    """st_group_norm_fold's scale / shift against fold(moments_plain(x))
    within 1e-5 (the moments' summation order), gamma / beta read in their
    own dtype; K9 is the apply kernel on exactly these scale / shift, bit
    for bit, the values K8's prologue reads."""
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


@pytest.mark.gpu
def test_gpu_group_norm_clamps_a_near_constant_group(cuda_device):
    """C3: x = 1000 + N(0, 1e-3), where E[x^2] - mean^2 rounds below 0 in
    f32; the fold kernel clamps it, so every output is finite."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    for c0 in (1000.0, 3000.0):
        x = torch.randn((1, 16, 16, 64), generator=gen, device=cuda_device) * 1e-3 + c0
        ones = torch.ones(64, device=cuda_device)
        out = tgn.group_norm(x, ones, torch.zeros_like(ones), num_groups=32)
        assert torch.isfinite(out).all()
        scale, _ = tgn.scale_shift(x, ones, torch.zeros_like(ones), num_groups=32)
        assert (scale <= (1 + 1e-6) / math.sqrt(1e-5)).all()  # rstd at most rsqrt(eps)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rows,c,rms,affine,tol", [
    (torch.bfloat16, 37, 640, False, True, 2e-2),   # 80 vectors: a masked tail
    (torch.bfloat16, 16, 1280, True, True, 2e-2),
    (torch.float32, 9, 96, False, False, 1e-4),     # gamma = beta = None
    (torch.float32, 8, 1024, True, False, 1e-4),
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
    (torch.float32, 300, 320), (torch.float32, 2048, 1024),
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
    assert len(keys) == 1 and next(iter(keys)).startswith("wgmma_bf16 ")
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
    assert k8 == f"{k6} gn_act=silu" and k6.startswith("wgmma_bf16 ")
    assert torch.equal(fused, pair)


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
