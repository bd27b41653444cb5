"""The skinny linear (K13 at M <= 16) and LayerNorm (K10) of the port against
the JAX package, their launch planning and their launch paths' checks.

On the CPU the wrappers run their kernels' plain versions (a CUDA kernel
has no interpret mode); the JAX entry points run their Pallas kernels in
interpret mode, as tests/test_kernels.py runs them. Inputs are made with
numpy from seeds. Tolerances:

  * linear, f32: max abs error within 1e-5 of the largest output (f32
    summation order);
  * linear, bf16: outputs equal, or 1 bf16 ulp apart (the f32 sums meet the
    rounding boundary in another order), on at most 0.2% of outputs or one
    output, as tests/test_torch_port_optional.py holds K13;
  * the skinny kernel's summation order, emulated in numpy: within 1e-5 of
    the largest output of the plain version in f32 (summation order only);
  * LayerNorm / RMSNorm, f32: abs 1e-4 (tests/test_torch_port_fused.py's
    NORM_ATOL); bf16: 1 bf16 ulp on at most 0.2% of outputs.

The CUDA kernels themselves are checked on the card by
tests/test_torch_port_gpu.py.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu.kernels.layer_norm import layer_norm as jlayer_norm
from stabletriton_tpu.kernels.linear import fused_linear as jfused_linear
from stabletriton_tpu_torch.kernels import layer_norm as tln
from stabletriton_tpu_torch.kernels import linear as tlinear
from stabletriton_tpu_torch.kernels import wgmma_plan as twp
from stabletriton_tpu_torch.ops.reference import apply_activation
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# the M <= 16 GEMMs of the SDXL and SD1.5 steps at full width, (M, K, N):
# the time MLP's linear_1 (320 -> 1280) and linear_2, the add embedding's
# linear_1 (2816 -> 1280; SDXL) and linear_2, each resnet's time_emb_proj
# (1280 -> 320, 640, 1280)
STEP_SHAPES = [(2, 320, 1280), (2, 1280, 320), (2, 1280, 640), (2, 1280, 1280),
               (2, 2816, 1280)]


def _bf16_ulp(*arrays):
    """1 bf16 ulp (8 significant bits) of the larger magnitude, at least
    2^-21 (the f32 sum-order noise where outputs approach 0)."""
    mag = np.maximum.reduce([np.abs(a) for a in arrays])
    return 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0**-14))) - 7)


def _assert_bf16_close(got, want):
    differ = got != want
    assert differ.sum() <= max(1, 0.002 * differ.size)
    assert (np.abs(got - want) <= _bf16_ulp(got, want))[differ].all()


def _operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / math.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    return x, w, b


# --------------------------------------------------------------------------
# K13 at M <= 16
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n,act", [(*s, None) for s in STEP_SHAPES]
                         + [(2, 320, 1280, "silu"), (2, 2816, 1280, "silu")])
def test_skinny_step_shapes_vs_pallas(m, k, n, act, dtype):
    """linear_plain, and the "cuda" wrapper on CPU tensors, against JAX's
    K13 (fused_linear, interpret) at each M <= 16 GEMM of the steps."""
    x, w, b = _operands(m, k, n, 40 + k + n)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jfused_linear(jnp.asarray(x, jd), jnp.asarray(w, jd), jnp.asarray(b, jd),
                                    act=act, interpret=True).astype(jnp.float32))
    targs = [torch.from_numpy(a).to(td) for a in (x, w, b)]
    plain = tlinear.linear_plain(*targs, act=act)
    assert plain.dtype == td and plain.shape == (m, n)
    assert torch.equal(tlinear.linear(*targs, act=act), plain)
    got = plain.float().numpy()
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    else:
        _assert_bf16_close(got, want)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("m,k,n", [*STEP_SHAPES, (1, 1, 1), (16, 33, 77), (5, 4097, 9),
                                   (16, 8192, 10240), (3, 0, 64), (2, 100000, 8)])
def test_skinny_plan_covers_n_and_k(m, k, n, itemsize):
    """The grid covers N and K exactly: every column slice holds a column
    and every split a row of K; a slice is 8, 4 or 2 vectors of 16 bytes,
    a split (one cluster) at most 8 blocks."""
    plan = tlinear.skinny_plan(m, k, n, itemsize)
    vec = 16 // itemsize
    assert plan.cols in (8 * vec, 4 * vec, 2 * vec)
    slices = math.ceil(n / plan.cols)
    assert (slices - 1) * plan.cols < n <= slices * plan.cols
    assert 1 <= plan.splits <= tlinear.SKINNY_MAX_SPLITS
    if k:
        assert (plan.splits - 1) * plan.rows < k <= plan.splits * plan.rows
    else:
        assert plan.splits == 1
    assert plan == tlinear.skinny_plan(m, k, n, itemsize)  # a pure function


@pytest.mark.parametrize("k,n", [(320, 1280), (1280, 1280), (2816, 1280), (1280, 640),
                                 (1280, 320)])
def test_skinny_plan_fills_the_card(k, n):
    """At N = 1280 the kernel runs at least one block on each of the card's
    132 SMs, on whole 128-byte lines of a w row; at every N and K of the
    steps' M = 2 GEMMs on at least half of them, at a K split of 8 where
    fewer slices leave SMs idle."""
    plan = tlinear.skinny_plan(2, k, n, 2)
    blocks = math.ceil(n / plan.cols) * plan.splits
    assert blocks >= twp.SMS // 2
    if blocks < twp.SMS:
        assert plan.splits == tlinear.SKINNY_MAX_SPLITS
    if n == 1280:
        assert blocks >= twp.SMS and plan.cols * 2 == 128


def _emulate_skinny(x, w, plan):
    """The skinny kernel's f32 sum in its own order (csrc/linear.cu
    linear_skinny), in numpy: a thread of row r of a pass of RP = 256 /
    (vectors a row) rows chains its FMAs along k = k0 + r, k0 + r + RP, ...
    of its split (each product exact in float64, each sum rounded to f32);
    a warp's 32 / (vectors a row) rows meet in an xor butterfly (a pairwise
    tree in row order); the block's 8 warps add in order from 0, then the
    splits in rank order from 0. Returns the f32 sums (M, N) and how often
    each k was read."""
    m, k = x.shape
    vec = 16 // x.dtype.itemsize
    rp = 256 // (plan.cols // vec)
    rpw = rp // 8
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    reads = np.zeros(k, np.int64)
    total = np.zeros((m, w.shape[1]), np.float32)
    for s in range(plan.splits):
        k0, k1 = s * plan.rows, min(k, (s + 1) * plan.rows)
        rows = []
        for r in range(rp):
            acc = np.zeros_like(total)
            for kk in range(k0 + r, k1, rp):
                acc = (acc + np.outer(x64[:, kk], w64[kk])).astype(np.float32)
                reads[kk] += 1
            rows.append(acc)
        block = np.zeros_like(total)
        for q in range(8):
            tree = rows[q * rpw:(q + 1) * rpw]
            while len(tree) > 1:
                tree = [tree[i] + tree[i + 1] for i in range(0, len(tree), 2)]
            block = block + tree[0]
        total = total + block
    return total, reads


@pytest.mark.parametrize("m,k,n", [(2, 1280, 1280), (2, 320, 1280), (2, 1280, 320),
                                   (5, 777, 40)])
def test_skinny_summation_order_emulated(m, k, n):
    """The kernel's fixed summation order reads every k exactly once, and
    its f32 sum is the plain version's up to summation order (1e-5 of the
    largest output); with bias and act added as the epilogue adds them."""
    x, w, b = _operands(m, k, n, 50 + k)
    plan = tlinear.skinny_plan(m, k, n, 4)
    sums, reads = _emulate_skinny(x, w, plan)
    assert (reads == 1).all()
    tx, tw, tb = (torch.from_numpy(a) for a in (x, w, b))
    for act in (None, "silu"):
        want = tlinear.linear_plain(tx, tw, tb, act=act).numpy()
        got = apply_activation(torch.from_numpy(sums) + tb, act).numpy()
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_linear_route_raises_alike_on_every_call():
    """The signature checks are cached with the route: a bad operand raises
    the same ValueError on its first call and on later ones, before and
    after a good call of the same shapes; the per-call device check
    raises after a good route of the same signature."""
    bf16 = torch.bfloat16
    good = ((2, 1280), (1280, 1280), (1280,), bf16, bf16, None, True)
    route = tlinear._route(*good)
    assert route.name == "skinny_bf16" and route.plan == tlinear.skinny_plan(2, 1280, 1280, 2)
    assert route.key == "skinny_bf16 m=2 k=1280 n=1280 bias=1 act=None cols=64 split=7"
    assert route.ints == (2, 1280, 1280, 0, 1, 1, *route.plan)
    d = tlinear.SkinnyDims.from_address(route.address)  # what the C entry reads
    assert tuple(getattr(d, f) for f, _ in d._fields_) == route.ints
    bad = [
        (((2, 1280), (1280, 1280), (1280,), bf16, bf16, "relu", True), "act"),
        (((2, 1280), (1280, 640), (1280,), bf16, bf16, None, True), "bias"),
        (((2, 1280), (640, 1280), (1280,), bf16, bf16, None, True), "weight"),
        (((2, 1280), (1280, 1280), (1280,), torch.float16, bf16, None, True), "float32"),
        (((2, 1280), (1280, 1280), (1280,), bf16, torch.float16, None, True), "bias"),
        (((2**31, 1280), (1280, 1280), (1280,), bf16, bf16, None, True), "2\\^31"),
    ]
    for args, match in bad:
        for _ in range(2):
            with pytest.raises(ValueError, match=match):
                tlinear._route(*args)
        assert tlinear._route(*good) is route
    for _ in range(2):
        with pytest.raises(ValueError, match="different devices"):
            tlinear.check_devices(0, 1, None)
        with pytest.raises(ValueError, match="different devices"):
            tlinear.check_devices(0, 0, -1)
    tlinear.check_devices(0, 0, 0)
    tlinear.check_devices(1, 1, None)
    x, w = torch.zeros(2, 8), torch.zeros(8, 4)
    for _ in range(2):  # the CPU path checks the same operands
        with pytest.raises(ValueError, match="act"):
            tlinear.linear(x, w, act="relu")
        tlinear.linear(x, w)


def test_linear_routes_each_kernel_with_its_key():
    """The route names the kernel variant() picks, its plan and key; a
    forced kernel (the internal launch's) takes its own route; an empty
    output launches nothing."""
    f32, bf16 = torch.float32, torch.bfloat16
    r = tlinear._route((154, 2048), (2048, 2560), None, bf16, None, None, True)
    assert r.name == "wgmma_bf16" and r.plan == twp.gemm_plan(154, 2048, 2560)
    assert r.key.endswith(f"bn={r.plan.bn} split={r.plan.splits}")
    r = tlinear._route((154, 2048), (2048, 2560), None, bf16, None, None, False)
    assert r.name == "wmma_bf16" and r.ints == (154, 2560, 2048, 0, 1, 1)
    r = tlinear._route((154, 2048), (2048, 2560), None, bf16, None, "gelu", True, "wmma_bf16")
    assert r.key == "wmma_bf16 m=154 k=2048 n=2560 bias=0 act=gelu"
    r = tlinear._route((3, 5, 16), (16, 9), (9,), f32, bf16, "silu", False)
    assert r.name == "skinny_f32" and r.out_shape == (3, 5, 9) and r.m == 15
    assert r.ints[:6] == (15, 9, 16, 1, 0, 1)
    assert tlinear._route((0, 16), (16, 9), None, f32, None, None, True).name is None


# --------------------------------------------------------------------------
# K10 LayerNorm / RMSNorm
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("c", [320, 640, 1280])
def test_layer_norm_plain_vs_pallas(c, rms, dtype):
    """layer_norm_plain (LayerNorm and RMSNorm), and the wrappers on CPU
    tensors, against JAX's K10 (interpret) at the UNet's widths."""
    rng = np.random.default_rng(60 + c)
    x = (rng.standard_normal((24, c)) * 2.0 + 0.3).astype(np.float32)
    g = (rng.standard_normal(c) + 1.0).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(jlayer_norm(jnp.asarray(x, jd), jnp.asarray(g, jd), jnp.asarray(b, jd),
                                  eps=1e-6, rmsnorm=rms, interpret=True).astype(jnp.float32))
    tx, tg, tb = (torch.from_numpy(a).to(td) for a in (x, g, b))
    plain = tln.layer_norm_plain(tx, tg, tb, eps=1e-6, rmsnorm=rms)
    wrapper = tln.rms_norm if rms else tln.layer_norm
    assert torch.equal(wrapper(tx, tg, tb, eps=1e-6), plain)
    got = plain.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    else:
        _assert_bf16_close(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [1280, 1536, 2048])
def test_layer_norm_route_takes_every_unet_width(dtype, c):
    """Either dtype takes rows up to 2048 wide (64 values a lane), so the
    1280-wide transformer blocks of every UNet and the refiner's 1536-wide
    ones route in f32 as in bf16, in both forms; one vector more raises."""
    for stepwise in (False, True):
        route = tln._route((2, 1024, c), dtype, (c,), dtype, (c,), dtype, False, 1e-5,
                           stepwise)
        assert route.fields[2:4] == (2048, c) and route.fields[6] == int(stepwise)
    wide = 2048 + 16 // dtype.itemsize
    with pytest.raises(ValueError, match="up to 2048"):
        tln._route((2, 1024, wide), dtype, None, None, None, None, False, 1e-5, True)


def test_layer_norm_route_raises_alike_on_every_call():
    """As for linear: the cached signature checks raise the same ValueError
    on every call, before and after a good call; the per-call checks (x's
    layout, the parameters' device and layout) raise after a good route."""
    bf16, f32 = torch.bfloat16, torch.float32
    good = ((2, 4096, 640), bf16, (640,), bf16, (640,), bf16, False, 1e-6)
    route = tln._route(*good)
    assert route.key == "ln bf16 rows=8192 c=640"
    assert route.fields == (1, 1, 8192, 640, 0, 1e-6, 0)
    d = tln.LnDims.from_address(route.address)  # what the C entry reads
    assert (d.dtype, d.pdtype, d.rows, d.c, d.rms) == route.fields[:5]
    assert d.eps == np.float32(1e-6)
    route2 = tln._route((2048, 1024), f32, None, None, None, None, True, 1e-5)
    assert route2.key == "rms f32 rows=2048 c=1024"
    assert route2.fields == (0, 0, 2048, 1024, 1, 1e-5, 0)
    # the default binding's stepwise LayerNorm: its own key, stepwise = 1 in the struct
    route3 = tln._route(*good, True)
    assert route3.key == "ln_bf16apply bf16 rows=8192 c=640"
    assert route3.fields == (1, 1, 8192, 640, 0, 1e-6, 1)
    assert tln.LnDims.from_address(route3.address).stepwise == 1
    bad = [
        (((2, 4096, 640), bf16, (320,), bf16, (640,), bf16, False, 1e-6), "norm parameter"),
        (((2, 4096, 640), torch.float16, (640,), bf16, (640,), bf16, False, 1e-6), "float32"),
        (((2, 4096, 644), bf16, None, None, None, None, False, 1e-6), "multiple of 8"),
        (((2, 4096, 4096), bf16, None, None, None, None, False, 1e-6), "up to 2048"),
        (((2, 4096, 640), bf16, (640,), bf16, (640,), f32, False, 1e-6), "share"),
        (((2, 4096, 640), bf16, (640,), torch.float16, None, None, False, 1e-6), "share"),
        (((2, 4096, 640), bf16, (640,), bf16, (640,), bf16, True, 1e-6, True), "LayerNorm's"),
    ]
    for args, match in bad:
        for _ in range(2):
            with pytest.raises(ValueError, match=match):
                tln._route(*args)
        assert tln._route(*good) is route
    calls = [((False, 0, 0, 0, 0, True), "contiguous, 16-byte"),
             ((True, 8, 0, 0, 0, True), "contiguous, 16-byte"),
             ((True, 0, 0, 1, 0, True), "x's device"),
             ((True, 0, 0, None, 1, True), "x's device"),
             ((True, 0, 0, 0, 0, False), "x's device")]
    for args, match in calls:
        for _ in range(2):
            with pytest.raises(ValueError, match=match):
                tln.check_call(*args)
    tln.check_call(True, 0, 0, 0, None, True)
    x = torch.zeros(3, 16)
    for _ in range(2):  # the CPU path checks the parameters' shapes
        with pytest.raises(ValueError, match="norm parameter"):
            tln.layer_norm(x, torch.ones(8), None)
        tln.layer_norm(x, torch.ones(16), None)
