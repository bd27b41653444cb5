"""The PyTorch port's reference ops against the JAX package's reference ops.

Same numpy inputs (np.random.default_rng) through both, float32 on the CPU.
Tolerance: atol 1e-5, the float32 rounding noise of two implementations of
the same formula that sum in different orders.
"""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu import ops as jops
from stabletriton_tpu_torch import kernels  # noqa: F401  (registers the kernel backends)
from stabletriton_tpu_torch import ops as tops
from stabletriton_tpu_torch.ops import registry

ATOL = 1e-5


def _pair(rng, *shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize("b,sq,sk,h,d", [(2, 24, 24, 2, 8), (1, 16, 77, 4, 16), (2, 9, 5, 1, 32)])
def test_attention(b, sq, sk, h, d):
    rng = np.random.default_rng(0)
    qj, qt = _pair(rng, b, sq, h * d)
    kj, kt = _pair(rng, b, sk, h * d)
    vj, vt = _pair(rng, b, sk, h * d)
    _close(jops.attention(qj, kj, vj, num_heads=h), tops.attention(qt, kt, vt, num_heads=h))


def test_attention_fused_operands():
    rng = np.random.default_rng(1)
    qkvj, qkvt = _pair(rng, 2, 20, 3 * 32)
    _close(jops.attention_qkv(qkvj, num_heads=4), tops.attention_qkv(qkvt, num_heads=4))
    qj, qt = _pair(rng, 2, 20, 32)
    kvj, kvt = _pair(rng, 2, 7, 64)
    _close(jops.attention_kv(qj, kvj, num_heads=2), tops.attention_kv(qt, kvt, num_heads=2))


# the port's backend -> the JAX op it is held against: the default binding's
# kernel forms ("cuda_bf16apply") compute the plain bf16-apply forms (on CPU
# tensors, by calling them)
_JAX_BACKEND = {"cuda_bf16apply": "bf16apply"}


@pytest.mark.parametrize("backend", ["reference", "bf16apply", "cuda_bf16apply"])
@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm(backend, act):
    rng = np.random.default_rng(2)
    xj, xt = _pair(rng, 2, 5, 6, 16, scale=3.0)
    gj, gt = _pair(rng, 16)
    bj, bt = _pair(rng, 16)
    jax_backend = _JAX_BACKEND.get(backend, backend)
    with jops.use_backends(group_norm=jax_backend), tops.use_backends(group_norm=backend):
        _close(jops.group_norm(xj, gj, bj, num_groups=4, eps=1e-6, act=act),
               tops.group_norm(xt, gt, bt, num_groups=4, eps=1e-6, act=act))


@pytest.mark.parametrize("backend", ["reference", "bf16apply", "cuda_bf16apply"])
def test_layer_norm(backend):
    rng = np.random.default_rng(3)
    xj, xt = _pair(rng, 3, 7, 24, scale=2.0)
    gj, gt = _pair(rng, 24)
    bj, bt = _pair(rng, 24)
    jax_backend = _JAX_BACKEND.get(backend, backend)
    with jops.use_backends(layer_norm=jax_backend), tops.use_backends(layer_norm=backend):
        _close(jops.layer_norm(xj, gj, bj, eps=1e-6), tops.layer_norm(xt, gt, bt, eps=1e-6))
        _close(jops.layer_norm(xj, None, None), tops.layer_norm(xt, None, None))


def test_geglu():
    rng = np.random.default_rng(4)
    sj, st = _pair(rng, 2, 9, 16, scale=2.0)
    gj, gt = _pair(rng, 2, 9, 16, scale=2.0)
    _close(jops.geglu(sj, gj), tops.geglu(st, gt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_geglu_default_binding_kernel_form(dtype):
    """The default binding's GEGLU ("cuda_bf16apply") on the halves of one
    projection buffer against the JAX reference op on the same values, in
    f32 and in bf16; JAX rounds each op of its bf16 gelu where the port
    rounds the gelu once, so bf16 is held within one bf16 ulp of the largest
    output."""
    rng = np.random.default_rng(5)
    pj, pt = _pair(rng, 2, 9, 32, scale=2.0)
    with tops.use_backends(geglu="cuda_bf16apply"):
        got = tops.geglu(*pt.to(dtype).chunk(2, dim=-1))
    assert got.dtype == dtype
    if dtype == torch.float32:
        _close(jops.geglu(*jnp.split(pj, 2, axis=-1)), got)
    else:
        want = np.asarray(jops.geglu(*jnp.split(pj.astype(jnp.bfloat16), 2, axis=-1)).astype(
            jnp.float32))
        _close(want, got.float(), atol=2.0**-7 * float(np.abs(want).max()))


@pytest.mark.parametrize("act,bias", [(None, False), (None, True), ("silu", True), ("gelu", True)])
def test_linear(act, bias):
    rng = np.random.default_rng(5)
    xj, xt = _pair(rng, 2, 6, 12)
    wj, wt = _pair(rng, 12, 20, scale=0.3)
    bj, bt = _pair(rng, 20) if bias else (None, None)
    _close(jops.linear(xj, wj, bj, act=act), tops.linear(xt, wt, bt, act=act))


@pytest.mark.parametrize("x_shape", [(308, 640), (2, 77, 640)])
def test_linear_bf16_bias_rounds_once(x_shape):
    """In bf16 the bias joins the f32 GEMM sum and the output rounds once,
    as in the JAX op: the two agree bit for bit."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal((640, 1280)) / 25).astype(np.float32)
    b = rng.standard_normal(1280).astype(np.float32)
    j = jops.linear(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)))
    t = tops.linear(*(torch.from_numpy(a).bfloat16() for a in (x, w, b)))
    assert t.dtype == torch.bfloat16 and t.shape == (*x_shape[:-1], 1280)
    np.testing.assert_array_equal(t.float().numpy(), np.asarray(j.astype(jnp.float32)))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_linear_bf16_act_rounds_once(act):
    """With an activation the bias and the activation apply to the f32 sum
    and the output rounds once, as in the JAX op. The two GEMMs sum in
    another order, so a few outputs may differ by 1 bf16 ulp; rounding the
    GEMM before the activation made 25% (silu) and 33% (gelu) differ. Below
    2^-14 in magnitude the ulp gives way to an absolute 2^-21: there the
    f32 sum order (~1e-7 over 640 unit terms) and the gelu tail (XLA's and
    PyTorch's f32 erf differ by up to 3.1e-7 where gelu(x) ~ 1e-5) decide."""
    rng = np.random.default_rng(9)
    x = rng.standard_normal((308, 640)).astype(np.float32)
    w = (rng.standard_normal((640, 1280)) / 25).astype(np.float32)
    b = rng.standard_normal(1280).astype(np.float32)
    j = np.asarray(jops.linear(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)),
                               act=act).astype(jnp.float32))
    t = tops.linear(*(torch.from_numpy(a).bfloat16() for a in (x, w, b)), act=act)
    assert t.dtype == torch.bfloat16
    t = t.float().numpy()
    differ = t != j
    assert differ.mean() <= 0.005
    # 1 bf16 ulp (8 significant bits) of each differing output
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.maximum(np.abs(j), np.abs(t)), 2.0**-14))) - 7)
    assert (np.abs(t - j) <= ulp)[differ].all()


@pytest.mark.parametrize("flip,shift", [(True, 0.0), (False, 1.0)])
def test_time_embed(flip, shift):
    t = np.array([0.0, 1.0, 499.0, 999.0], np.float32)
    j = jops.time_embed(jnp.asarray(t), dim=32, flip_sin_to_cos=flip, downscale_freq_shift=shift)
    tt = tops.time_embed(torch.from_numpy(t), dim=32, flip_sin_to_cos=flip,
                         downscale_freq_shift=shift)
    # sin/cos of arguments up to ~1e3 rad: float32 argument rounding dominates
    _close(j, tt, atol=1e-4)


@pytest.mark.parametrize(
    "stride,padding,ksize,bias_kind,res,act",
    [
        (1, 1, 3, "shared", False, None),
        (1, 1, 3, "batch", True, "silu"),
        (2, 1, 3, "shared", False, None),          # UNet downsampler
        (2, ((0, 1), (0, 1)), 3, "shared", False, None),  # asymmetric padding
        (1, 0, 1, "shared", True, None),           # 1x1 shortcut
    ],
)
def test_conv2d(stride, padding, ksize, bias_kind, res, act):
    rng = np.random.default_rng(6)
    xj, xt = _pair(rng, 2, 8, 10, 6)
    wj, wt = _pair(rng, ksize, ksize, 6, 5, scale=0.3)
    bj, bt = _pair(rng, *((2, 5) if bias_kind == "batch" else (5,)))
    out_hw = jops.conv2d(xj, wj, None, stride=stride, padding=padding).shape[1:3]
    rj, rt = _pair(rng, 2, *out_hw, 5) if res else (None, None)
    _close(jops.conv2d(xj, wj, bj, stride=stride, padding=padding, residual=rj, act=act),
           tops.conv2d(xt, wt, bt, stride=stride, padding=padding, residual=rt, act=act))


def test_gn_conv2d_composes_through_binding():
    rng = np.random.default_rng(7)
    xj, xt = _pair(rng, 2, 6, 6, 8)
    gj, gt = _pair(rng, 8)
    bj, bt = _pair(rng, 8)
    wj, wt = _pair(rng, 3, 3, 8, 4, scale=0.3)
    cbj, cbt = _pair(rng, 2, 4)
    rj, rt = _pair(rng, 2, 6, 6, 4)
    with jops.use_backends(group_norm="bf16apply"), tops.use_backends(group_norm="bf16apply"):
        _close(jops.gn_conv2d(xj, gj, bj, wj, cbj, num_groups=4, residual=rj),
               tops.gn_conv2d(xt, gt, bt, wt, cbt, num_groups=4, residual=rt))


def test_registry_nesting_and_errors():
    assert registry.active_backend("attention") == "reference"
    with tops.use_backends({"conv2d": "x"}, attention="y"):
        assert tops.current_binding() == {"conv2d": "x", "attention": "y"}
        with tops.use_backends(attention="z"):
            assert registry.active_backend("attention") == "z"
            assert registry.active_backend("conv2d") == "x"
        assert registry.active_backend("attention") == "y"
        with pytest.raises(KeyError, match="no backend"):
            tops.attention(torch.zeros(1, 1, 1), torch.zeros(1, 1, 1), torch.zeros(1, 1, 1))
    assert tops.current_binding() == {}
    with pytest.raises(KeyError, match="unknown op"):
        registry.resolve("no_such_op")


def test_registry_binding_is_thread_local():
    seen = {}
    entered = threading.Event()
    release = threading.Event()

    def other():
        seen["start"] = tops.current_binding()
        entered.set()
        release.wait(timeout=10)
        seen["end"] = tops.current_binding()

    th = threading.Thread(target=other)
    with tops.use_backends(attention="cuda"):
        th.start()
        assert entered.wait(timeout=10)
        release.set()
        th.join(timeout=10)
    assert not th.is_alive()
    assert seen == {"start": {}, "end": {}}
