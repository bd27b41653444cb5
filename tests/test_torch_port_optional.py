"""The rest of the opt-in kernels against the JAX package: linear (K13), the
timestep embedding (K12) and seeded dropout (K14), and the all-kernel binding.

On the CPU the port's wrappers run their kernels' plain versions (a CUDA
kernel has no interpret mode); the JAX entry points run their Pallas kernels
in interpret mode, as tests/test_kernels.py runs them. Inputs are made with
numpy from seeds. Tolerances:

  * linear, f32: max abs error within 1e-5 of the largest output (f32
    summation order; the Pallas GELU's erf polynomial is within 1.5e-7);
  * linear, bf16: outputs equal, or 1 bf16 ulp apart (the f32 sums meet
    the rounding boundary in another order), on at most 0.2% of outputs or
    one output; measured: at most 7 of 6160 (0.11%, gelu) and 1 of 80;
  * time_embed: abs 2.5e-4, about two f32 ulps of a 1024-rad argument;
  * dropout: the kernel's stream is Philox, JAX's on the CPU is
    jax.random, so against JAX only the drop fraction is compared (within
    4 standard deviations of the rate); kept values within 1 f32 ulp of
    x / (1 - rate).

The CUDA kernels themselves are checked on the card by
tests/test_torch_port_gpu.py.
"""

import ctypes
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu import ops as jops
from stabletriton_tpu.kernels.dropout import seeded_dropout as jdropout
from stabletriton_tpu.kernels.linear import fused_linear as jfused_linear
from stabletriton_tpu.kernels.time_embed import time_embed as jtime_embed
from stabletriton_tpu_torch import ops as tops
from stabletriton_tpu_torch.compile import (
    ALL_KERNEL_OVERRIDES,
    FUSED_OP_OVERRIDES,
    OPTIONAL_KERNEL_OPS,
    CompileConfig,
    resolve_binding,
)
from stabletriton_tpu_torch.kernels import conv_direct as tconv
from stabletriton_tpu_torch.kernels import dropout as tdropout
from stabletriton_tpu_torch.kernels import linear as tlinear
from stabletriton_tpu_torch.kernels import time_embed as ttime

# --------------------------------------------------------------------------
# K13 linear
# --------------------------------------------------------------------------


def _bf16_ulp(*arrays):
    """1 bf16 ulp (8 significant bits) of the larger magnitude, at least
    2^-21 (the f32 sum-order noise where outputs approach 0)."""
    mag = np.maximum.reduce([np.abs(a) for a in arrays])
    return 2.0 ** (np.floor(np.log2(np.maximum(mag, 2.0**-14))) - 7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", [None, "silu", "gelu"])
@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("m,k", [(2, 2816), (12, 24), (154, 2816)])
def test_linear_vs_pallas_and_reference(m, k, bias, act, dtype):
    """The kernel's plain version and the "cuda" wrapper on CPU tensors
    against JAX's K13 (interpret) and JAX's reference op, N = 40."""
    n = 40
    rng = np.random.default_rng(30 + m + k)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / math.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32) if bias else None
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jargs = [jnp.asarray(a, jd) for a in (x, w)] + [None if b is None else jnp.asarray(b, jd)]
    targs = [torch.from_numpy(a).to(td) for a in (x, w)] + [
        None if b is None else torch.from_numpy(b).to(td)]
    kernel = np.asarray(jfused_linear(*jargs, act=act, interpret=True).astype(jnp.float32))
    ref = np.asarray(jops.linear(*jargs, act=act).astype(jnp.float32))
    plain = tlinear.linear_plain(*targs, act=act)
    wrapped = tlinear.linear(*targs, act=act)
    assert plain.dtype == wrapped.dtype == td and plain.shape == (m, n)
    assert torch.equal(plain, wrapped)  # CPU tensors take the plain version
    got = plain.float().numpy()
    for want in (kernel, ref):
        if dtype == "float32":
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        else:
            differ = got != want
            assert differ.sum() <= max(1, 0.002 * differ.size)
            assert (np.abs(got - want) <= _bf16_ulp(got, want))[differ].all()


def test_linear_flattens_leading_dims_and_refuses_bad_operands():
    rng = np.random.default_rng(31)
    x = torch.from_numpy(rng.standard_normal((2, 7, 24)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((24, 40)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(40).astype(np.float32))
    out = tlinear.linear(x, w, b, act="gelu")
    assert out.shape == (2, 7, 40)
    np.testing.assert_allclose(out.numpy(), tops.reference.linear(x, w, b, act="gelu").numpy(),
                               atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="act"):
        tlinear.linear(x, w, b, act="relu")
    with pytest.raises(ValueError, match="weight"):
        tlinear.linear(x, w.T, b)
    with pytest.raises(ValueError, match="bias"):
        tlinear.linear(x, w, b[:20])


def test_linear_variant_by_rows_and_dtype():
    """M <= 16 takes the skinny kernel; above it bf16 takes the wgmma kernel
    where TMA takes the operands (else the WMMA kernel) and f32 the 3xTF32
    wgmma GEMM, whose wrapper pads or copies what TMA cannot take."""
    assert tlinear.variant(2, 1280, 1280, torch.bfloat16) == "skinny_bf16"
    assert tlinear.variant(16, 64, 64, torch.float32) == "skinny_f32"
    assert tlinear.variant(17, 64, 64, torch.bfloat16) == "wgmma_bf16"
    assert tlinear.variant(154, 2048, 2560, torch.bfloat16) == "wgmma_bf16"
    assert tlinear.variant(154, 2048, 2560, torch.bfloat16, aligned=False) == "wmma_bf16"
    assert tlinear.variant(16384, 512, 512, torch.float32) == "wgmma_tf32x3"
    assert tlinear.variant(17, 70, 45, torch.float32, aligned=False) == "wgmma_tf32x3"


def test_silu_only_kernels_refuse_gelu():
    """ACT_CODES now names gelu for the linear kernel; the conv kernel's
    epilogue applies SiLU only and still refuses it."""
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="act"):
        tconv.conv3x3(x, torch.zeros(3, 3, 8, 4), act="gelu")


# --------------------------------------------------------------------------
# K12 timestep embedding
# --------------------------------------------------------------------------

TIMESTEPS = np.array([0.0, 1.0, 500.0, 999.0, 1024.0], np.float32)


@pytest.mark.parametrize("shift", [0.0, 1.0])
@pytest.mark.parametrize("flip", [True, False])
@pytest.mark.parametrize("dim", [320, 256])
def test_time_embed_vs_pallas(dim, flip, shift):
    j = jtime_embed(jnp.asarray(TIMESTEPS), dim=dim, flip_sin_to_cos=flip,
                    downscale_freq_shift=shift, interpret=True)
    t = torch.from_numpy(TIMESTEPS)
    plain = ttime.time_embed_plain(t, dim=dim, flip_sin_to_cos=flip,
                                   downscale_freq_shift=shift)
    assert plain.shape == (5, dim) and plain.dtype == torch.float32
    assert torch.equal(ttime.time_embed(t, dim=dim, flip_sin_to_cos=flip,
                                        downscale_freq_shift=shift), plain)
    np.testing.assert_allclose(plain.numpy(), np.asarray(j), atol=2.5e-4, rtol=0)


def test_time_embed_refuses_odd_dims_and_batched_timesteps():
    with pytest.raises(ValueError, match="even"):
        ttime.time_embed(torch.zeros(2), dim=33)
    with pytest.raises(ValueError, match=r"\(B,\)"):
        ttime.time_embed(torch.zeros(2, 1), dim=32)


@pytest.fixture
def no_library(monkeypatch):
    """time_embed._route with its C entry looked up as a name, so the route
    can be made where there is no kernel library; its cache cleared before
    and after."""
    monkeypatch.setattr(ttime, "function", lambda name, argtypes: name)
    ttime._route.cache_clear()
    yield
    ttime._route.cache_clear()


CUDA0 = torch.device("cuda", 0)


def test_time_embed_route_is_cached_by_signature(no_library):
    """One route per (device, t's shape and dtype, dim, max_period, flip,
    shift): made once, holding the C entry, the f32 coefficient (the
    double -ln(max_period) / (half - shift) rounded once, as the plain
    version), the grid, the struct argument and the launch key; t as f32
    needs no conversion, f64 does."""
    sig = (CUDA0, (2,), torch.float32, 320, 10000.0, True, 0.0)
    route = ttime._route(*sig)
    assert ttime._route(*sig) is route and ttime._route.cache_info().misses == 1
    for i, other in [(0, torch.device("cuda", 1)), (1, (12,)), (2, torch.float64), (3, 256),
                     (4, 1000.0), (5, False), (6, 1.0)]:
        assert ttime._route(*sig[:i], other, *sig[i + 1:]) is not route
    assert ttime._route.cache_info().misses == 8
    coef = float(torch.tensor(-math.log(10000.0) / 160, dtype=torch.float32))
    assert route.fn == "st_time_embed" and not route.convert
    assert route.key == "b=2 dim=320 flip=1 shift=0"
    dims = route.dims
    assert (dims.b, dims.half, dims.c, dims.flip, dims.blocks, dims.threads) == (
        2, 160, coef, 1, 3, 256)
    assert route.address == ctypes.addressof(dims)
    assert ttime._route(CUDA0, (12,), torch.float64, 256, 10000.0, False, 1.0).convert
    assert ttime._route(CUDA0, (0,), torch.float32, 256, 10000.0, True, 0.0).fn is None


@pytest.mark.parametrize("shape,dim,match", [((2,), 33, "even"), ((2, 1), 32, r"\(B,\)"),
                                             ((), 32, r"\(B,\)")])
def test_time_embed_route_refuses_every_time(no_library, shape, dim, match):
    """A bad signature raises on every call: the cache keeps no exception."""
    for _ in range(2):
        with pytest.raises(ValueError, match=match):
            ttime._route(CUDA0, shape, torch.float32, dim, 10000.0, True, 0.0)
    assert ttime._route.cache_info().currsize == 0


@pytest.mark.parametrize("total", [1, 255, 256, 640, 3072, 64 * 1280 + 1])
def test_time_embed_grid_covers_every_output(total):
    """One thread an output, 256 a block: every output covered, no block
    beyond the last output's."""
    blocks, threads = ttime.grid(total)
    assert threads == 256 and blocks * threads >= total > (blocks - 1) * threads


# --------------------------------------------------------------------------
# K14 seeded dropout
# --------------------------------------------------------------------------


def test_philox_known_answers():
    """Philox4x32-10 against the known-answer vectors of its authors'
    Random123 library: the plain version's words are the generator's."""
    cases = [((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
             ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2,
              (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
             ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
              (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]
    ctr = torch.tensor([c for c, _, _ in cases], dtype=torch.int64)
    for i, (_, key, want) in enumerate(cases):
        assert tdropout.philox4x32_10(ctr[i:i + 1], key)[0].tolist() == list(want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_contract(dtype):
    """Mirrors tests/test_dropout.py: determinism, another seed another mask,
    kept values x / (1 - rate), rate 0 the identity, rate 1 refused."""
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.standard_normal((64, 96)).astype(np.float32) + 3.0).to(dtype)
    a = tdropout.dropout(x, 7, rate=0.25)
    assert a.dtype == dtype and a.shape == x.shape
    assert torch.equal(a, tdropout.dropout(x, 7, rate=0.25))
    assert torch.equal(a, tdropout.dropout_plain(x, 7, rate=0.25))
    assert not torch.equal(a, tdropout.dropout(x, 8, rate=0.25))
    kept = a != 0
    want = x.double() / 0.75
    if dtype == torch.float32:
        np.testing.assert_allclose(a[kept].double().numpy(), want[kept].numpy(),
                                   rtol=2.0**-23, atol=0)
    else:  # one bf16 rounding of the f32 product
        np.testing.assert_allclose(a[kept].double().numpy(), want[kept].numpy(),
                                   rtol=2.0**-8, atol=0)
    assert 0.2 < 1 - kept.float().mean().item() < 0.3
    assert tdropout.dropout(x, 0, rate=0.0) is x
    for rate in (1.0, -0.1):
        with pytest.raises(ValueError, match="rate"):
            tdropout.dropout(x, 0, rate=rate)


def test_dropout_drop_fraction_vs_jax():
    """The drop fraction of the port's Philox stream and of JAX's
    seeded_dropout (interpret: jax.random) at (256, 1024), rate 0.1, each
    within 4 standard deviations of the rate."""
    rate, shape = 0.1, (256, 1024)
    sigma = math.sqrt(rate * (1 - rate) / (shape[0] * shape[1]))
    ones = np.ones(shape, np.float32)
    for seed in (0, 1, 2**33 + 5):
        port = (tdropout.dropout(torch.from_numpy(ones), seed, rate=rate) == 0).float().mean()
        jax_frac = float((np.asarray(jdropout(jnp.asarray(ones), seed % 2**31, rate=rate,
                                              interpret=True)) == 0).mean())
        assert abs(port.item() - rate) <= 4 * sigma
        assert abs(jax_frac - rate) <= 4 * sigma


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", range(8))
def test_dropout_out_like_keeps_the_address_modulo_16(dtype, offset):
    """The wrapper's output has x's shape and dtype, is contiguous and lies
    at x's address modulo 16, so one 16-byte boundary serves both."""
    x = torch.zeros(101 + offset, dtype=dtype)[offset:].view(101)
    out = tdropout.out_like(x)
    assert out.shape == x.shape and out.dtype == dtype and out.is_contiguous()
    assert out.data_ptr() % 16 == x.data_ptr() % 16


@pytest.mark.parametrize("itemsize,head", [(2, h) for h in range(8)] + [(4, h) for h in range(4)])
def test_dropout_piece_words(itemsize, head):
    """csrc/dropout.cu drop_piece: a 16-byte piece of 16 / itemsize elements
    starting at element e0 = head + piece * width takes the words of the
    (phase + width + 3) // 4 groups from e0 // 4 on, element k word
    phase + k (phase = head % 4): each element's word of dropout_plain."""
    width = 16 // itemsize
    n = head + 3 * width
    g = torch.arange((n + 3) // 4, dtype=torch.int64)
    ctr = torch.stack([g, g >> 32, torch.zeros_like(g), torch.zeros_like(g)], -1)
    words = tdropout.philox4x32_10(ctr, (11, 12)).reshape(-1)
    phase = head % 4
    for piece in range(3):
        e0 = head + piece * width
        groups = (phase + width + 3) // 4
        g0 = torch.arange(e0 // 4, e0 // 4 + groups, dtype=torch.int64)
        w = tdropout.philox4x32_10(torch.stack([g0, g0 >> 32, g0 * 0, g0 * 0], -1),
                                   (11, 12)).reshape(-1)
        assert torch.equal(w[phase:phase + width], words[e0:e0 + width])


def test_dropout_mask_depends_on_the_index_alone():
    """Element i's bits are Philox word i % 4 of counter i // 4: a tensor's
    prefix gets the same mask as the tensor, whatever its shape."""
    x = torch.ones(1001)
    full = tdropout.dropout_plain(x, 5, rate=0.5)
    assert torch.equal(tdropout.dropout_plain(x[:333], 5, rate=0.5), full[:333])
    assert torch.equal(tdropout.dropout_plain(x[:1000].reshape(10, 100), 5, rate=0.5),
                       full[:1000].reshape(10, 100))


# --------------------------------------------------------------------------
# the binding
# --------------------------------------------------------------------------


def test_all_kernel_binding_resolves():
    assert OPTIONAL_KERNEL_OPS == ("geglu", "group_norm", "layer_norm", "rms_norm", "linear",
                                   "time_embed", "dropout")
    registered = tops.registered_ops()
    assert all("cuda" in registered[op] for op in OPTIONAL_KERNEL_OPS)
    assert ALL_KERNEL_OVERRIDES[:len(FUSED_OP_OVERRIDES)] == FUSED_OP_OVERRIDES
    binding = resolve_binding(CompileConfig(overrides=ALL_KERNEL_OVERRIDES))
    assert {op: binding[op] for op, _ in ALL_KERNEL_OVERRIDES} == dict(ALL_KERNEL_OVERRIDES)
    assert binding["linear"] == binding["time_embed"] == "cuda"
    assert binding["attention_qkv"] == "cuda" and binding["conv2d"] == "direct"
    # the default binding keeps linear and time_embed on the reference ops
    default = resolve_binding(CompileConfig())
    assert "linear" not in default and "time_embed" not in default


def test_dropout_override_binds_and_dispatches():
    binding = resolve_binding(CompileConfig(backend="reference",
                                            overrides=(("dropout", "cuda"),)))
    assert binding == {"dropout": "cuda"}
    x = torch.ones(4, 64)
    with tops.use_backends(binding):
        out = tops.dispatch("dropout", x, 3, rate=0.5)
    assert torch.equal(out, tdropout.dropout_plain(x, 3, rate=0.5))
    with tops.use_backends(dropout="reference"):
        assert torch.equal(tops.dispatch("dropout", x, 3, rate=0.5), out)
