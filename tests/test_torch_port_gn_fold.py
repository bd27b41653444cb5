"""GroupNorm's fold (K9), on the device, host side on the CPU.

``st_group_norm`` (csrc/group_norm.cu) runs the stats-and-fold kernel (the
(B, C) moments and their fold into per-channel scale / shift, one launch)
and the apply kernel behind one C entry; ``st_group_norm_fold`` runs the
first for the fused GN conv (K8). The kernels run only on the card
(tests/test_torch_port_gpu.py). What the CPU can hold: the fold's plain twin
(:func:`fold`, which the wrappers use for CPU tensors and which adds a
group's channels in channel order, as the fold kernel does) against the JAX
package's Pallas ``group_norm`` in interpret mode and against its
``_gn_fold`` (K8's fold), f32, within 1e-5 of the largest value (f32
summation order); the fold's arithmetic, bit for bit, against a numpy
emulation of the kernel's order; the stats kernel's plan (:func:`plan`:
every element summed once, no idle lane, a function of (H*W, C, vec) only)
and its order of summation emulated in numpy, folded, against the Pallas
``group_norm``; batch invariance; and C3: the JAX K9 fold takes no clamp, so
a near-constant group gives NaN there, where the port's fold clamps E[x^2] -
mean^2 at 0.
"""

import inspect
import math

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
            chunks = tgn.plan(h * w, c, vec, groups)[3]
            for n in (1, 4):
                ws = tgn._workspace(torch.empty((n, h, w, c)), chunks)
                assert ws.numel() * 8 == 8 * n * c * (1 + 2 * chunks)


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


def _kernel_order_moments(x, vec, groups):
    """The stats kernel's sums in numpy, in its order (csrc/group_norm.cu
    gn_stats_fold): per unit (slab, chunk) of :func:`plan`, each thread (row
    lane, vector lane) sums runs of 16 of its rows in f32 and adds each run
    into a double; the row lanes meet in double in the kernel's two-stage
    order; the chunks' partials add in chunk order; each channel's total is
    rounded to f32 once. Also returns how often each element was summed."""
    n, h, w, c = x.shape
    hw = h * w
    sv, slabs, rows, chunks = tgn.plan(hw, c, vec, groups)
    lanes, nch = tgn.THREADS // sv, sv * vec
    parts = max(1, lanes * sv // nch)
    xs = x.reshape(n, hw, c).astype(np.float32)
    seen = np.zeros((n, hw, c), np.int64)
    s1 = np.zeros((n, c), np.float32)
    s2 = np.zeros((n, c), np.float32)
    for b in range(n):
        for slab in range(slabs):
            cs = slice(slab * nch, (slab + 1) * nch)
            unit = np.zeros((chunks, 2, nch))
            for chunk in range(chunks):
                r0, r1 = chunk * rows, min(hw, (chunk + 1) * rows)
                acc = np.zeros((lanes, 2, nch))
                for rl in range(lanes):
                    mine = np.arange(r0 + rl, r1, lanes)
                    seen[b, mine, cs] += 1
                    for run in range(0, len(mine), 16):
                        fs = np.zeros(nch, np.float32)
                        fq = np.zeros(nch, np.float32)
                        for v in xs[b, mine[run:run + 16], cs]:
                            fs = (fs + v).astype(np.float32)
                            fq = (v.astype(np.float64) ** 2 + fq).astype(np.float32)  # fmaf
                        acc[rl, 0] += fs
                        acc[rl, 1] += fq
                # part j sums row lanes j, j + parts, ...; then the parts in order
                unit[chunk] = _in_order(np.stack([_in_order(acc[j::parts])
                                                  for j in range(parts)]))
            tot = _in_order(unit)
            s1[b, cs], s2[b, cs] = tot[0].astype(np.float32), tot[1].astype(np.float32)
    return s1, s2, seen


def _in_order(a):
    """The sum over a's first axis, one element after another (double)."""
    out = np.zeros(a.shape[1:])
    for v in a:
        out = out + v
    return out


# the kernel paths' plans at small sizes: 16-byte vectors (vec 8 bf16, 4 f32)
# with one and several slabs and chunks, 2-byte elements (vec 1), and a
# 12-channel f32 row of three vectors (one slab narrower than MIN_SLAB)
PLAN_SHAPES = [((2, 9, 7, 64), 8), ((1, 40, 40, 16), 8), ((1, 33, 31, 128), 4),
               ((2, 9, 7, 20), 1), ((1, 5, 6, 12), 4), ((1, 70, 70, 640), 8)]


@pytest.mark.parametrize("shape,vec", PLAN_SHAPES)
def test_kernel_order_moments_fold_to_pallas_group_norm(shape, vec):
    """The stats kernel's order of summation (emulated) sums every element
    once; its moments, folded by :func:`fold` and applied, agree with the
    JAX package's Pallas K9 (interpret) within 1e-5 of the largest value,
    and its sums with float64 ones within 1e-6."""
    x, g, b = _inputs(80 + shape[3], shape)
    groups = 4 if shape[3] % 4 == 0 else 2
    s1, s2, seen = _kernel_order_moments(x, vec, groups)
    assert (seen == 1).all()
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(s1, x64.sum(axis=(1, 2)), rtol=1e-6,
                               atol=1e-6 * np.abs(x64).sum(axis=(1, 2)).max())
    np.testing.assert_allclose(s2, (x64 ** 2).sum(axis=(1, 2)), rtol=1e-6)
    hw = shape[1] * shape[2]
    scale, shift = tgn.fold(torch.from_numpy(s1), torch.from_numpy(s2), torch.from_numpy(g),
                            torch.from_numpy(b), hw=hw, num_groups=groups, eps=1e-5)
    got = tgn.apply_plain(torch.from_numpy(x), scale, shift, "silu").numpy()
    want = np.asarray(jgroup_norm(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b),
                                  num_groups=groups, act="silu", interpret=True))
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


# (H*W, C, vec) of every GroupNorm the port's paths run through the kernels:
# SDXL-base 1024^2 and the refiner (bf16), SD1.5 512^2, SD2.x 768^2, and the
# f32 VAE decoder and encoder; 32 groups
PATH_PLANS = [(hw * hw, c, 8) for hw, c in [
    (128, 320), (128, 640), (128, 960), (128, 384), (128, 1152), (64, 320), (64, 640),
    (64, 768), (64, 960), (64, 1280), (64, 1920), (64, 2304), (32, 640), (32, 1280),
    (32, 1920), (32, 2560), (16, 1280), (16, 2560), (8, 1280), (8, 2560), (96, 320),
    (48, 640), (24, 1280), (12, 1280), (12, 2560)]] + [(hw * hw, c, 4) for hw, c in [
        (128, 512), (256, 512), (512, 512), (512, 256), (1024, 256), (1024, 128),
        (512, 128), (256, 256)]]


@pytest.mark.parametrize("hw,c,vec", PATH_PLANS)
def test_plan_at_path_shapes(hw, c, vec):
    """At every path shape: no idle lane (a block is whole row lanes of sv
    vectors, the slabs tile the row, a stats slab holds whole groups and
    spans at least MIN_SLAB vectors; the apply's rows are 128 bytes), whole
    row lanes a chunk and at least LOADS rows a lane, the chunks cover H*W
    once, at most UNITS_PER_IMAGE units (one wave of a CFG batch of two) and
    at least 70% of them where H*W allows, the ticket buffer holds a batch of 64, and the
    workspace is 8 B C (1 + 2 chunks) bytes at every batch size; the plans
    take no batch."""
    assert list(inspect.signature(tgn.plan).parameters) == ["hw", "c", "vec", "groups"]
    for sv, slabs, rows, chunks in (tgn.plan(hw, c, vec, 32), tgn.apply_plan(hw, c, vec)):
        lanes = tgn.THREADS // sv
        assert slabs * sv == c // vec and lanes * sv > tgn.THREADS - sv
        assert rows % lanes == 0 and rows >= tgn.LOADS * lanes
        assert (chunks - 1) * rows < hw <= chunks * rows
        assert slabs * chunks <= tgn.UNITS_PER_IMAGE
        if hw >= tgn.LOADS * lanes * (tgn.UNITS_PER_IMAGE // slabs):
            assert slabs * chunks >= 0.7 * tgn.UNITS_PER_IMAGE
    sv, slabs, _, chunks = tgn.plan(hw, c, vec, 32)
    assert sv * vec % (c // 32) == 0 and sv >= tgn.MIN_SLAB and 64 * slabs <= tgn.TICKETS
    assert tgn.apply_plan(hw, c, vec)[0] == 8
    for n in (1, 2, 4):
        ws = tgn._workspace(torch.empty((n, 1, 1, c)), chunks)
        assert ws.numel() * 8 == 8 * n * c * (1 + 2 * chunks)
