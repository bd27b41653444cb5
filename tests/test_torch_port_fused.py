"""The fused-op binding's kernel modules against the JAX package's Pallas kernels.

GroupNorm (K9), LayerNorm / RMSNorm (K10), GEGLU (K11) and the GN-fused 3x3
conv (K8). On the CPU the port's wrappers run their kernels' plain versions
(a CUDA kernel has no interpret mode); the JAX entry points run their Pallas
kernels in interpret mode, as tests/test_kernels.py runs them. Same numpy
inputs, float32. Tolerances: atol 1e-4 for the norms and GEGLU (f32
summation order and erf vs the Pallas kernel's erf polynomial, |err| <
1.5e-7); atol 1e-3 for the conv (sums of 9*Cin products in another order,
as tests/test_kernels.py holds the Pallas conv).

The CUDA kernels themselves are checked on the card by
tests/test_torch_port_gpu.py.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu.kernels import conv_direct as jconv
from stabletriton_tpu.kernels.geglu import geglu as jgeglu
from stabletriton_tpu.kernels.group_norm import group_norm as jgroup_norm
from stabletriton_tpu.kernels.layer_norm import layer_norm_op as jlayer_norm
from stabletriton_tpu.kernels.layer_norm import rms_norm_op as jrms_norm
from stabletriton_tpu.ops import reference as jref
from stabletriton_tpu_torch import ops as tops
from stabletriton_tpu_torch.compile import (
    FUSED_OP_OVERRIDES,
    OPTIONAL_KERNEL_OPS,
    CompileConfig,
    resolve_binding,
)
from stabletriton_tpu_torch.kernels import conv_direct as tconv
from stabletriton_tpu_torch.kernels import geglu as tgeglu
from stabletriton_tpu_torch.kernels import group_norm as tgn
from stabletriton_tpu_torch.kernels import layer_norm as tln
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

NORM_ATOL = 1e-4
CONV_ATOL = 1e-3


def _arr(rng, *shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _close(j, t, atol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


# --------------------------------------------------------------------------
# K9 GroupNorm
# --------------------------------------------------------------------------


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape,groups", [((2, 8, 8, 16), 4), ((1, 9, 7, 24), 8)])
def test_group_norm_vs_pallas(shape, groups, act):
    rng = np.random.default_rng(20)
    x = _arr(rng, *shape, scale=3.0, shift=1.0)
    g, b = _arr(rng, shape[3]), _arr(rng, shape[3])
    j = jgroup_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), num_groups=groups,
                    act=act, block_rows=16)
    t = tgn.group_norm(torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b),
                       num_groups=groups, act=act)
    _close(j, t, NORM_ATOL)


def test_group_norm_moments_and_fold():
    """The stats, folded, reproduce the reference op; the fold clamps a
    negative E[x^2] - mean^2 at 0 (a constant group); the fold kernel's
    wrapper (scale_shift) takes the same plain path on the CPU."""
    rng = np.random.default_rng(21)
    x = torch.from_numpy(_arr(rng, 2, 5, 6, 16, scale=2.0))
    x[1, ..., :4] = 3.0  # group 0 of image 1 is constant
    g, b = torch.from_numpy(_arr(rng, 16)), torch.from_numpy(_arr(rng, 16))
    s1, s2 = tgn.moments_plain(x)
    np.testing.assert_allclose(s1.numpy(), x.sum(dim=(1, 2)).numpy(), rtol=1e-5)
    scale, shift = tgn.fold(s1, s2, g, b, hw=30, num_groups=4, eps=1e-5)
    assert scale.shape == shift.shape == (2, 16) and scale.dtype == torch.float32
    wrapped = tgn.scale_shift(x, g, b, num_groups=4, eps=1e-5)
    assert torch.equal(wrapped[0], scale) and torch.equal(wrapped[1], shift)
    assert torch.isfinite(scale).all()
    np.testing.assert_allclose(tgn.apply(x, scale, shift, "silu").numpy(),
                               tops.reference.group_norm(x, g, b, num_groups=4,
                                                         act="silu").numpy(), atol=1e-4)


def test_group_norm_refuses_other_activations():
    """The Pallas apply kernel ignores any act but "silu"; the port raises."""
    x = torch.zeros(1, 2, 2, 8)
    with pytest.raises(ValueError, match="act"):
        tgn.group_norm(x, torch.ones(8), torch.zeros(8), num_groups=2, act="gelu")
    with pytest.raises(ValueError, match="divisible"):
        tgn.group_norm(x, torch.ones(8), torch.zeros(8), num_groups=3)


def test_stats_chunking_ignores_batch():
    """The kernels' plans (slabs of channel vectors by chunks of rows) are
    functions of (H*W, C, vec, groups) alone (they take no batch), so an
    image's moments are the same bits at every batch bucket; at least LOADS
    rows a row lane, at most UNITS_PER_IMAGE units an image where the slabs
    allow."""
    assert list(inspect.signature(tgn.plan).parameters) == ["hw", "c", "vec", "groups"]
    assert list(inspect.signature(tgn.apply_plan).parameters) == ["hw", "c", "vec"]
    assert tgn.plan(64, 640, 8, 32) == (5, 16, 4 * 51, 1)    # one chunk of 4 rows a lane
    sv, slabs, rows, chunks = tgn.plan(1024 * 1024, 128, 4, 32)
    assert (sv, slabs, rows % 64) == (4, 8, 0) and slabs * chunks == tgn.UNITS_PER_IMAGE
    assert tgn.plan(32 * 32, 2560, 8, 32) == (10, 32, 150, 7)  # 124 rows in the last chunk
    assert tgn.apply_plan(32 * 32, 2560, 8) == (8, 40, 192, 6)


# --------------------------------------------------------------------------
# K10 LayerNorm / RMSNorm
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rms", [False, True])
@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("shape", [(6, 32), (3, 11, 48)])
def test_layer_norm_vs_pallas(shape, affine, rms):
    rng = np.random.default_rng(22)
    x = _arr(rng, *shape, scale=2.0, shift=1.5)
    g = _arr(rng, shape[-1]) if affine else None
    b = _arr(rng, shape[-1]) if affine else None
    jfn, tfn = (jrms_norm, tln.rms_norm) if rms else (jlayer_norm, tln.layer_norm)
    j = jfn(jnp.asarray(x), None if g is None else jnp.asarray(g),
            None if b is None else jnp.asarray(b), eps=1e-6)
    t = tfn(torch.from_numpy(x), None if g is None else torch.from_numpy(g),
            None if b is None else torch.from_numpy(b), eps=1e-6)
    _close(j, t, NORM_ATOL)


def test_rms_norm_reference_op_vs_jax():
    rng = np.random.default_rng(23)
    x, g = _arr(rng, 4, 24, scale=3.0, shift=1.0), _arr(rng, 24)
    _close(jref.rms_norm(jnp.asarray(x), jnp.asarray(g)),
           tops.rms_norm(torch.from_numpy(x), torch.from_numpy(g)), 1e-5)


# --------------------------------------------------------------------------
# K11 GEGLU
# --------------------------------------------------------------------------


def test_geglu_on_strided_halves_vs_pallas():
    """state and gate are the chunk halves of one (B, S, 2N) buffer, as the
    UNet's feed-forward hands them over."""
    rng = np.random.default_rng(24)
    proj = _arr(rng, 2, 13, 64, scale=2.0)
    state, gate = torch.from_numpy(proj).chunk(2, dim=-1)
    assert state.stride() == gate.stride() == (13 * 64, 64, 1)
    j = jgeglu(jnp.asarray(proj[..., :32]), jnp.asarray(proj[..., 32:]), block_rows=8)
    t = tgeglu.geglu(state, gate)
    assert t.is_contiguous()
    _close(j, t, NORM_ATOL)


def test_geglu_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="shapes differ"):
        tgeglu.geglu(torch.zeros(2, 4), torch.zeros(2, 5))


# --------------------------------------------------------------------------
# K8 GroupNorm fused into the 3x3 conv
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "shape,bias_kind,res,gn_act,shift",
    [
        ((2, 9, 8, 32, 16), "batch", False, "silu", 0.0),   # resnet conv1: (B, Cout) bias
        ((2, 6, 7, 16, 16), "shared", True, "silu", 0.0),   # resnet conv2: bias + residual
        ((2, 8, 8, 32, 4), "shared", False, "silu", 0.0),   # conv_out-like Cout = 4
        ((1, 8, 8, 16, 8), "shared", False, None, 4.0),     # large shift: zero border
    ],
)
def test_gn_conv2d_fused_vs_pallas(shape, bias_kind, res, gn_act, shift):
    """The fused op against the JAX package's gn_conv2d_fused (its Pallas
    conv with the GN prologue, in interpret mode). With a large beta the
    normalized input is far from 0, so a border that took the prologue would
    differ by ~4 per tap."""
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(25)
    x = _arr(rng, b, h, w, cin, scale=2.0, shift=0.5)
    gamma, beta = _arr(rng, cin, scale=0.3, shift=1.0), _arr(rng, cin, shift=shift)
    wt = _arr(rng, 3, 3, cin, cout, scale=0.1)
    bias = _arr(rng, *((b, cout) if bias_kind == "batch" else (cout,)))
    r = _arr(rng, b, h, w, cout) if res else None
    j = jconv.gn_conv2d_fused(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                              jnp.asarray(wt), jnp.asarray(bias), num_groups=4,
                              gn_act=gn_act, residual=None if r is None else jnp.asarray(r))
    t = tconv.gn_conv2d_fused(torch.from_numpy(x), torch.from_numpy(gamma),
                              torch.from_numpy(beta), torch.from_numpy(wt),
                              torch.from_numpy(bias), num_groups=4, gn_act=gn_act,
                              residual=None if r is None else torch.from_numpy(r))
    _close(j, t, CONV_ATOL)


def test_gn_conv3x3_plain_keeps_the_border_zero():
    """The plain version pads the NORMALIZED input with zeros: with a 1x1
    identity-like centre tap only, every output equals its normalized input,
    border pixels included."""
    rng = np.random.default_rng(26)
    x = torch.from_numpy(_arr(rng, 1, 8, 8, 4))
    scale, shift = torch.full((1, 4), 0.5), torch.full((1, 4), 4.0)
    w = torch.zeros(3, 3, 4, 4)
    w[1, 1] = torch.eye(4)
    out = tconv.gn_conv3x3(x, scale, shift, w, gn_act=None)
    np.testing.assert_allclose(out.numpy(), (x * 0.5 + 4.0).numpy(), atol=1e-6)
    w_corner = torch.zeros(3, 3, 4, 4)
    w_corner[0, 0] = torch.eye(4)  # reads the pixel up-left: zero on the top row
    out = tconv.gn_conv3x3(x, scale, shift, w_corner, gn_act=None)
    assert torch.equal(out[0, 0], torch.zeros(8, 4)) and torch.equal(out[0, :, 0],
                                                                      torch.zeros(8, 4))


@pytest.mark.parametrize("kw,ksize", [({"stride": 2}, 3), ({"padding": 0}, 1)])
def test_gn_conv2d_fused_composes_the_binding_on_other_shapes(kw, ksize):
    """Strided or 1x1 convs are not the kernel's: the op composes group_norm
    and conv2d through the active binding, as the JAX package does."""
    rng = np.random.default_rng(27)
    x = torch.from_numpy(_arr(rng, 2, 8, 8, 8))
    g, b = torch.from_numpy(_arr(rng, 8)), torch.from_numpy(_arr(rng, 8))
    w = torch.from_numpy(_arr(rng, ksize, ksize, 8, 4, scale=0.2))
    with tops.use_backends(group_norm="reference", conv2d="reference"):
        want = tops.reference.gn_conv2d(x, g, b, w, num_groups=2, **kw)
        got = tconv.gn_conv2d_fused(x, g, b, w, num_groups=2, **kw)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)


# --------------------------------------------------------------------------
# the binding
# --------------------------------------------------------------------------


def test_resolve_binding_overrides():
    binding = resolve_binding(CompileConfig(overrides=FUSED_OP_OVERRIDES))
    assert {op: binding[op] for op, _ in FUSED_OP_OVERRIDES} == dict(FUSED_OP_OVERRIDES)
    assert binding["attention_qkv"] == "cuda" and binding["conv2d"] == "direct"
    # the reference base with kernel overrides, like the JAX package's "ops:" grammar
    binding = resolve_binding(CompileConfig(backend="reference",
                                            overrides=(("layer_norm", "cuda"),)))
    assert binding == {"layer_norm": "cuda"}
    # "reference" always binds; an unregistered backend raises
    assert resolve_binding(CompileConfig(overrides=(("geglu", "reference"),)))["geglu"] == (
        "reference")
    with pytest.raises(ValueError, match="not registered"):
        resolve_binding(CompileConfig(overrides=(("geglu", "pallas"),)))
    with pytest.raises(ValueError, match="not registered"):
        resolve_binding(CompileConfig(overrides=(("no_such_op", "cuda"),)))
    registered = tops.registered_ops()
    assert all("cuda" in registered[op] for op in OPTIONAL_KERNEL_OPS)
    assert "fused" in registered["gn_conv2d"]
