"""C4: the bf16 attention epilogue divides by the row sum, as JAX does.

The JAX kernels (K1-K5) store ``o / l.clip(1e-30)``: the correctly rounded
f32 quotient, rounded once to bf16. Multiplying by the row's reciprocal
instead gives another bf16 for some outputs. ``division_probe``
(kernels/flash_attention.py) makes operands on which every output is such a
quotient: ``live`` keys score 0 (p = 1, l = live), the rest about -2000
(p = 0), and each v column sums, exactly in any order, to an integer x
whose ``bf16(x / live)`` differs from ``bf16(x * f32(1 / live))``.

On the CPU this file holds:

  * the JAX package's K1-K5 routes (Pallas in interpret mode) and the
    port's ``attention_plain`` give exactly ``bf16(x / live)``, and every
    output of the probe differs from the reciprocal's, so the inputs expose
    the fault;
  * the epilogue's arithmetic (csrc/flash_attention.cu ``div_rn``: a
    correctly rounded reciprocal a row, then one Markstein step an element),
    emulated exactly, equals the f32 division on the probe's values and on
    random operands across the kernel's range.

  * ``range_probe``'s outputs outside that step's range (zeros, quotients
    under 2^-99 or over 2^99, infinities, NaN), beside in-range outputs in
    the same rows of a warp: JAX and ``attention_plain`` give bf16(x / l)
    there too, and the emulated range test sends exactly the planted
    outputs to the division.

The kernels themselves run only on the card (tests/test_torch_port_gpu.py,
``test_gpu_attention_divides_like_jax`` and
``test_gpu_attention_divides_out_of_range``).
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu.kernels import flash_attention as jfa
from stabletriton_tpu_torch.kernels import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

BF16 = torch.bfloat16


def _expected(x, sq, live):
    """(B, Sq, C) bf16: every row bf16(x / live), the f32 quotient rounded once."""
    return (x / live).to(BF16)[:, None, :].expand(-1, sq, -1)


def _reciprocal(x, sq, live):
    return (x * torch.tensor(1.0 / live, dtype=torch.float32)).to(BF16)[:, None, :].expand(
        -1, sq, -1)


def _jnp(t):
    return jnp.asarray(t.numpy(), jnp.bfloat16)


# (route, form, b, sq, sk, h, d, live, JAX blocks): the JAX entry point and
# its Pallas body; "qkv" self-attention off one fused buffer, "kv" against a
# fused KV buffer, "sep" separate q, k, v
JAX_ROUTES = [
    ("K1 self", "qkv", 2, 56, 56, 2, 64, 56, None),            # _packed_single_kv_kernel
    ("K1 self, dead keys", "qkv", 1, 64, 64, 2, 64, 60, None),
    ("K1 cross", "kv", 2, 16, 28, 2, 64, 28, None),
    ("K1 cross SDXL keys", "kv", 1, 16, 77, 2, 64, 56, None),
    ("K2", "qkv", 1, 224, 224, 2, 64, 224, (128, 128)),        # _packed_flash_kernel
    ("K3 d=40 h=1", "sep", 1, 16, 224, 1, 40, 224, (16, 128)),  # _flash_kernel
    ("K4 d=80", "sep", 1, 16, 224, 2, 80, 224, None),          # _single_kv_kernel_bh
    ("K4 d=160", "sep", 1, 16, 448, 2, 160, 448, None),
    ("K5 d=40", "sep", 2, 16, 28, 2, 40, 28, None),            # _single_kv_kernel
    ("K5 d=80", "sep", 1, 16, 112, 2, 80, 112, None),
    ("K5 d=160", "sep", 1, 16, 56, 2, 160, 56, None),
    ("K5 mid self S=64", "sep", 1, 64, 64, 2, 160, 56, None),
]


@pytest.mark.parametrize("route,form,b,sq,sk,h,d,live,blocks", JAX_ROUTES,
                         ids=[r[0] for r in JAX_ROUTES])
def test_jax_and_attention_plain_divide(route, form, b, sq, sk, h, d, live, blocks):
    q, k, v, x = tfa.division_probe(b, sq, sk, h, d, live, seed=sk + d)
    want = _expected(x, sq, live)
    assert (want != _reciprocal(x, sq, live)).all(), "the probe must expose the reciprocal"
    bq, bk = blocks or (None, None)
    if form == "qkv":
        j = jfa.flash_attention_qkv(_jnp(torch.cat([q, k, v], -1)), num_heads=h, block_q=bq,
                                    block_k=bk)
    elif form == "kv":
        j = jfa.flash_attention_kv(_jnp(q), _jnp(torch.cat([k, v], -1)), num_heads=h)
    else:
        j = jfa.flash_attention(_jnp(q), _jnp(k), _jnp(v), num_heads=h, block_q=bq, block_k=bk)
    j = torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16)
    assert torch.equal(j, want), f"{route}: JAX differs from bf16(x / l)"
    plain = tfa.attention_plain(q.to(BF16), k.to(BF16), v.to(BF16), num_heads=h)
    assert torch.equal(plain, want), f"{route}: attention_plain differs from bf16(x / l)"


@pytest.mark.parametrize("live", [7, 28, 56, 112, 224, 448, 1792])
def test_division_targets_differ_under_the_reciprocal(live):
    """Each target's quotient and reciprocal product round to different bf16
    values, and the key counts the card test uses have targets (the routes'
    Sk <= 128, K4's 224 / 448, K2's 1792)."""
    x = tfa.division_targets(live)
    assert len(x) >= 100
    assert ((x / live).to(BF16) != (x * torch.tensor(1.0 / live)).to(BF16)).all()
    assert torch.equal(x, x.round()) and x.abs().max() <= 20000


def test_division_probe_sums_exactly():
    """The live keys' v sum to x in f32 in any order; with q prescaled as
    the kernels do (times bf16(scale * log2 e)), the live keys score 0 and
    the dead ones below -1000, where exp2 is exactly 0."""
    b, sq, sk, h, d, live = 2, 8, 77, 2, 64, 56
    q, k, v, x = tfa.division_probe(b, sq, sk, h, d, live)
    for t in (q, k, v):
        assert torch.equal(t, t.to(BF16).float())
    assert torch.equal(v[:, :live].double().sum(1), x.double())
    assert torch.equal(v[:, :live].sum(1), x) and torch.equal(v[:, :live].flip(1).sum(1), x)
    qs = q * float(torch.tensor(tfa.LOG2E / d ** 0.5, dtype=BF16))
    s = torch.einsum("bqhd,bkhd->bhqk", qs.reshape(b, sq, h, d), k.reshape(b, sk, h, d))
    assert (s[..., :live] == 0).all() and (s[..., live:] < -1000).all()
    assert (torch.exp2(s[..., live:]) == 0).all()
    with pytest.raises(ValueError, match="live"):
        tfa.division_probe(1, 4, 8, 1, 40, 9)


# --------------------------------------------------------------------------
# the epilogue's arithmetic, emulated exactly
# --------------------------------------------------------------------------


def _round_f32(v: Fraction) -> np.float32:
    """v rounded to the nearest float32, ties to even (normal range)."""
    if v == 0:
        return np.float32(0.0)
    sign = -1 if v < 0 else 1
    a = abs(v)
    e = a.numerator.bit_length() - a.denominator.bit_length()
    if Fraction(2) ** e > a:
        e -= 1
    scaled = a / Fraction(2) ** (e - 23)  # in [2^23, 2^24)
    m = scaled.numerator // scaled.denominator
    rest = scaled - m
    if rest > Fraction(1, 2) or (rest == Fraction(1, 2) and m % 2):
        m += 1
    return np.float32(sign * float(Fraction(m) * Fraction(2) ** (e - 23)))


def _fma(a, b, c) -> np.float32:
    return _round_f32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def div_rn(acc: np.float32, l: np.float32) -> np.float32:
    """csrc/flash_attention.cu div_rn: r = RN(1 / l), q = RN(acc r), then
    q + (acc - q l) r with both steps fused."""
    r = np.float32(1.0) / l
    with np.errstate(over="ignore", invalid="ignore"):
        q = acc * r
        if not np.isfinite(q):
            return np.float32(np.nan)
    return _fma(_fma(-q, l, acc), r, q)


def fast(acc: np.float32, l: np.float32) -> bool:
    """store_tile's test of a div_rn output: |out| in [max(2^-99, 2^-99 r),
    2^99] (zeros, NaN, infinities fall outside; the warp then divides)."""
    out = div_rn(acc, l) if np.isfinite(acc) and acc != 0 else np.float32(np.nan)
    lo = max(np.float32(2.0 ** -99), np.float32(2.0 ** -99) * (np.float32(1.0) / l))
    return bool(lo <= abs(out) <= 2.0 ** 99)


def test_markstein_step_divides_on_the_probe_values():
    for live in (7, 28, 56, 112, 224, 1792):
        l = np.float32(live)
        for x in tfa.division_targets(live).numpy()[::7]:
            assert fast(x, l) and div_rn(x, l) == x / l
            assert x * (np.float32(1.0) / l) != x / l


def test_markstein_step_divides_on_random_operands():
    """acc over the magnitudes an attention output takes, l from a tiny row
    sum to Sk * 2^80 (the clipped softmax's largest p); both as the f32
    division, which the plain reciprocal product misses on some."""
    rng = np.random.default_rng(11)
    n = 3000
    acc = (rng.standard_normal(n) * 2.0 ** rng.integers(-60, 60, n)).astype(np.float32)
    l = (rng.random(n) * 2.0 ** rng.integers(-60, 90, n) + 2.0 ** -90).astype(np.float32)
    misses = taken = 0
    for a, b in zip(acc, l):
        if not fast(a, b):
            continue
        taken += 1
        assert div_rn(a, b) == a / b
        misses += np.float32(a * (np.float32(1.0) / b)) != a / b
    assert taken > n // 2 and misses > 0


@pytest.mark.parametrize("acc,l,want", [
    (0.0, 3.0, False), (-0.0, 3.0, False), (1e-31, 1.0, False), (3e38, 1.0, False),
    (np.inf, 5.0, False), (np.nan, 5.0, False), (2.0 ** -90, 2.0 ** 20, False),
    (1.0, 2.0 ** 80 * 77, True), (2.0 ** 126, 1e-30, False), (-7.0, 3.0, True)])
def test_markstein_range(acc, l, want):
    """Zeros, subnormal, huge, infinite and NaN sums, and quotients past
    2^+-99, take the division; the rest the Markstein step, which there
    equals it."""
    acc, l = np.float32(acc), np.float32(l)
    assert fast(acc, l) == want
    if want:
        assert div_rn(acc, l) == acc / l


# --------------------------------------------------------------------------
# outputs outside the Markstein step's range (range_probe)
# --------------------------------------------------------------------------


def _same_bits(out, want):
    """Bit for bit, NaN by position (a NaN's payload is the hardware's)."""
    nan = want.isnan()
    return torch.equal(out.isnan(), nan) and torch.equal(
        out.view(torch.int16)[~nan], want.view(torch.int16)[~nan])


# (route, form, b, sq, sk, h, d, live): live keys a half, the rest dead
RANGE_JAX_ROUTES = [
    ("K1 self", "qkv", 2, 56, 56, 2, 64, 28),
    ("K1 cross SDXL keys", "kv", 2, 40, 77, 2, 64, 28),
    ("K4 d=80", "sep", 2, 40, 224, 2, 80, 112),
    ("K5 d=160", "sep", 2, 40, 112, 2, 160, 56),
]


@pytest.mark.parametrize("route,form,b,sq,sk,h,d,live", RANGE_JAX_ROUTES,
                         ids=[r[0] for r in RANGE_JAX_ROUTES])
def test_jax_and_attention_plain_divide_out_of_range(route, form, b, sq, sk, h, d, live):
    q, k, v, x, l = tfa.range_probe(b, sq, sk, h, d, live, seed=sk + d)
    want = (x / l[..., None]).to(BF16)
    if form == "qkv":
        j = jfa.flash_attention_qkv(_jnp(torch.cat([q, k, v], -1)), num_heads=h)
    elif form == "kv":
        j = jfa.flash_attention_kv(_jnp(q), _jnp(torch.cat([k, v], -1)), num_heads=h)
    else:
        j = jfa.flash_attention(_jnp(q), _jnp(k), _jnp(v), num_heads=h)
    j = torch.from_numpy(np.array(j.astype(jnp.float32))).to(BF16)
    assert _same_bits(j, want), f"{route}: JAX differs from bf16(x / l)"
    plain = tfa.attention_plain(q.to(BF16), k.to(BF16), v.to(BF16), num_heads=h)
    assert _same_bits(plain, want), f"{route}: attention_plain differs from bf16(x / l)"


def test_range_probe_plants_out_of_range_outputs_in_one_warp():
    """Operands bf16-exact; the emulated range test fails exactly on the
    planted outputs (batch 0's rows RANGE_ROW mod 32 in each head's first
    columns, and batch 1's non-finite columns), every one of which is
    present, and passes every other output, those of the planted rows
    included; each output's quotient is what the kernels must store."""
    b, sq, sk, h, d, live = 2, 40, 77, 2, 64, 28
    q, k, v, x, l = tfa.range_probe(b, sq, sk, h, d, live)
    for t in (q, k, v):
        assert torch.equal(t.nan_to_num(), t.to(BF16).float().nan_to_num())
    taken = np.vectorize(lambda a, n: fast(np.float32(a), np.float32(n)))(
        x.numpy(), l[..., None].expand_as(x).numpy())
    planted = np.zeros(x.shape, bool)
    heads = np.arange(h) * d
    for j in range(len(tfa.RANGE_SCALES)):
        planted[0, tfa.RANGE_ROW::32, heads + j] = True
    for j in range(len(tfa.RANGE_NONFINITE)):
        planted[1, :, heads + j] = True
    assert np.array_equal(~taken, planted)
    want = (x / l[..., None]).float()
    a = want.abs()
    assert (want[0, tfa.RANGE_ROW, heads] == 0).all()
    assert (a[0, tfa.RANGE_ROW, heads + 1] < 2.0 ** -99).all()
    assert (a[0, tfa.RANGE_ROW, heads + 2] > 2.0 ** 99).all()
    assert (a[0, tfa.RANGE_ROW, heads + 3] > 2.0 ** 99).all()
    assert (want[1, :, heads] == np.inf).all() and (want[1, :, heads + 1] == -np.inf).all()
    assert want[1, :, heads + 2].isnan().all()
    with pytest.raises(ValueError, match="range_probe"):
        tfa.range_probe(1, 8, 64, 1, 64, 28)
    with pytest.raises(ValueError, match="range_probe"):
        tfa.range_probe(2, 8, 50, 1, 64, 28)
