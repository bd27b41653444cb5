"""GroupNorm's fold (K9), now on the device, host side on the CPU.

``st_group_norm`` (csrc/group_norm.cu) runs the stats pass, the fold of the
(B, C) moments into per-channel scale / shift, and the apply pass behind one
C entry; ``st_group_norm_fold`` runs the first two for the fused GN conv
(K8). The kernels run only on the card (tests/test_torch_port_gpu.py). What
the CPU can hold: the fold's plain twin (:func:`fold`, which the wrappers use
for CPU tensors and which adds a group's channels in channel order, as the
fold kernel does) against the JAX package's Pallas ``group_norm`` in
interpret mode and against its ``_gn_fold`` (K8's fold), f32, within 1e-5 of
the largest value (f32 summation order); the fold's arithmetic, bit for bit,
against a numpy emulation of the kernel's order; batch invariance; and C3:
the JAX K9 fold takes no clamp, so a near-constant group gives NaN there,
where the port's fold clamps E[x^2] - mean^2 at 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu.kernels.conv_direct import _gn_fold as jgn_fold
from stabletriton_tpu.kernels.group_norm import group_norm as jgroup_norm
from stabletriton_tpu_torch.kernels import group_norm as tgn
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TOL = 1e-5

# (2, 8, 8, 16) / 4 and (1, 9, 7, 24) / 8 as the fused-op tests; (1, 5, 6, 80)
# / 16 has five channels a group, so a group straddles any 8-channel vector
SHAPES = [((2, 8, 8, 16), 4), ((1, 9, 7, 24), 8), ((1, 5, 6, 80), 16)]


def _inputs(seed, shape, scale=3.0, shift=1.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * scale + shift).astype(np.float32)
    g = (rng.standard_normal(shape[3]) * 0.5 + 1.0).astype(np.float32)
    b = rng.standard_normal(shape[3]).astype(np.float32)
    return x, g, b


@pytest.mark.parametrize("act", [None, "silu"])
@pytest.mark.parametrize("shape,groups", SHAPES)
def test_device_fold_twin_vs_pallas_group_norm(shape, groups, act):
    """scale_shift (the fold kernel's wrapper; its plain twin on the CPU),
    applied, against the JAX package's Pallas K9 in interpret mode."""
    x, g, b = _inputs(40 + shape[3], shape)
    scale, shift = tgn.scale_shift(torch.from_numpy(x), torch.from_numpy(g),
                                   torch.from_numpy(b), num_groups=groups, eps=1e-5)
    got = tgn.apply_plain(torch.from_numpy(x), scale, shift, act).numpy()
    want = np.asarray(jgroup_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                                  num_groups=groups, act=act, interpret=True))
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("shape,groups", SHAPES)
def test_device_fold_twin_vs_jax_gn_fold(shape, groups):
    """scale / shift themselves against the JAX package's K8 fold
    (``_gn_fold``), gamma and beta in f32."""
    x, g, b = _inputs(50 + shape[3], shape)
    scale, shift = tgn.scale_shift(torch.from_numpy(x), torch.from_numpy(g),
                                   torch.from_numpy(b), num_groups=groups, eps=1e-5)
    jscale, jshift = (np.asarray(a) for a in jgn_fold(jnp.asarray(x), jnp.asarray(g),
                                                      jnp.asarray(b), groups, 1e-5))
    assert scale.shape == shift.shape == (shape[0], shape[3])
    assert np.abs(scale.numpy() - jscale).max() <= TOL * np.abs(jscale).max()
    assert np.abs(shift.numpy() - jshift).max() <= TOL * np.abs(jshift).max()


def _kernel_order_fold(s1, s2, gamma, beta, hw, groups, eps):
    """The fold kernel's arithmetic in numpy f32: each group's channel sums
    added one by one in channel order, every operation rounded on its own;
    rsqrt as torch's, the one operation numpy has no f32 form of."""
    n, c = s1.shape
    per = c // groups
    f = np.float32
    scale = np.empty((n, c), np.float32)
    shift = np.empty((n, c), np.float32)
    for i in range(n):
        for grp in range(groups):
            cs = slice(grp * per, (grp + 1) * per)
            gs, gq = f(0), f(0)
            for v1, v2 in zip(s1[i, cs], s2[i, cs]):
                gs, gq = f(gs + v1), f(gq + v2)
            mean, ex2 = f(gs / f(hw * per)), f(gq / f(hw * per))
            var = max(f(ex2 - f(mean * mean)), f(0))
            rstd = torch.rsqrt(torch.tensor(f(var + f(eps)))).item()
            scale[i, cs] = (f(rstd) * gamma[cs]).astype(np.float32)
            shift[i, cs] = (beta[cs] - (f(mean) * scale[i, cs]).astype(np.float32))
    return scale, shift


@pytest.mark.parametrize("groups", [1, 4])
def test_fold_adds_channels_in_channel_order(groups):
    """The plain fold equals the kernel's order bit for bit. The channel sums
    are built so that another order (numpy's pairwise sum) gives another
    group mean: 2^24 + 1 + 1 - 2^24 is 0 in f32 in channel order, 1 in
    pairs."""
    c, hw = 16, 7
    s1 = np.tile(np.array([2.0**24, 1.0, 1.0, -(2.0**24)], np.float32), (2, c // 4))
    s1[1] *= -0.75
    s2 = np.abs(s1) * 4.0 + 3.0
    rng = np.random.default_rng(60)
    gamma = (rng.standard_normal(c) + 1.0).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    scale, shift = tgn.fold(torch.from_numpy(s1), torch.from_numpy(s2),
                            torch.from_numpy(gamma), torch.from_numpy(beta), hw=hw,
                            num_groups=groups, eps=1e-5)
    want_scale, want_shift = _kernel_order_fold(s1, s2, gamma, beta, hw, groups, 1e-5)
    assert np.array_equal(scale.numpy(), want_scale)
    assert np.array_equal(shift.numpy(), want_shift)
    per = c // groups
    assert (np.float32(sum(np.float32(v) for v in s1[0, :per]))
            != s1[0, :per].reshape(-1, 2).sum(-1, dtype=np.float32).sum(dtype=np.float32))


def test_fold_reads_gamma_and_beta_in_their_dtype():
    """bf16 gamma / beta enter the fold as their exact f32 values."""
    x, g, b = _inputs(61, (2, 4, 4, 32))
    xt = torch.from_numpy(x)
    gb, bb = torch.from_numpy(g).bfloat16(), torch.from_numpy(b).bfloat16()
    got = tgn.scale_shift(xt, gb, bb, num_groups=8)
    want = tgn.scale_shift(xt, gb.float(), bb.float(), num_groups=8)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("shape,groups", SHAPES)
def test_scale_shift_is_batch_invariant(shape, groups):
    """An image gets the same scale / shift, bit for bit, alone and beside
    another image; the kernels' stats chunking is a function of (H*W, C)
    alone, whatever the batch."""
    x, g, b = _inputs(70 + shape[3], shape)
    y, _, _ = _inputs(71 + shape[3], shape)
    xt, gt, bt = (torch.from_numpy(a) for a in (x, g, b))
    alone = tgn.scale_shift(xt[:1], gt, bt, num_groups=groups)
    batch = tgn.scale_shift(torch.cat([xt[:1], torch.from_numpy(y)]), gt, bt,
                            num_groups=groups)
    assert torch.equal(alone[0], batch[0][:1]) and torch.equal(alone[1], batch[1][:1])
    h, w, c = shape[1:]
    for vec in (1, 4, 8):
        if c % vec == 0:
            _, one = tgn._workspace(torch.empty((1, h, w, c)), vec)
            _, four = tgn._workspace(torch.empty((4, h, w, c)), vec)
            assert one == four == tgn.stats_chunks(h * w, c, vec)


def test_c3_near_constant_group_is_nan_in_jax_k9_and_clamped_in_the_port():
    """C3: x = 1000 + N(0, 1e-3), (1, 16, 16, 64), 32 groups. The JAX K9
    fold, rsqrt(E[x^2] - mean^2 + eps) with no clamp, gives NaN where the
    difference rounds below 0; the port clamps it at 0, so those groups take
    rstd = rsqrt(eps) and every output is finite."""
    rng = np.random.default_rng(0)
    x = (1000.0 + rng.standard_normal((1, 16, 16, 64)) * 1e-3).astype(np.float32)
    g = np.ones(64, np.float32)
    b = np.zeros(64, np.float32)
    jax_out = np.asarray(jgroup_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                                     num_groups=32, interpret=True))
    assert np.isnan(jax_out).sum() > 0
    xt, gt, bt = (torch.from_numpy(a) for a in (x, g, b))
    out = tgn.group_norm(xt, gt, bt, num_groups=32)
    assert torch.isfinite(out).all()
    # which groups clamp: E[x^2] - mean^2 from the same f32 sums as the fold
    s1, s2 = tgn.moments_plain(xt)
    per = 2
    gs = s1.reshape(1, 32, per)[..., 0] + s1.reshape(1, 32, per)[..., 1]
    gq = s2.reshape(1, 32, per)[..., 0] + s2.reshape(1, 32, per)[..., 1]
    mean, ex2 = gs / (256 * per), gq / (256 * per)
    clamped = (ex2 - mean.square() < 0).repeat_interleave(per, dim=1)
    assert clamped.any()
    scale, _ = tgn.scale_shift(xt, gt, bt, num_groups=32)
    rsqrt_eps = torch.rsqrt(torch.tensor(1e-5, dtype=torch.float32))
    assert torch.equal(scale[clamped], rsqrt_eps.expand(int(clamped.sum())))
