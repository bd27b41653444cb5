"""The turbo int8 mode (``CompileConfig.quantize``) against the JAX package,
on the CPU.

The pieces: ``quantize_linear_weights`` in its three modes, the quantize
branch of ``resolve_binding``, the W8A8 ops (``linear_int8``,
``conv2d_int8``, with ``int8_mm`` for the int32 product), the reference
ops' dequantization of an (int8, scale) pair, the kernel bindings' guards
against a pair, ``cast_params`` passing pairs through, the tiny UNet in
each mode and a tiny turbo txt2img.

The same numpy weights and inputs (from seeds) go through both packages.
Tolerances:

  * quantized weights and scales: exact (the same float32 operations,
    division and half-to-even rounding included);
  * the int8 activations and the int32 accumulators of the ops: exact;
  * the ops' outputs: 1e-6 relative to the largest output in float32
    (the activation's float32 implementation), one bfloat16 ulp (2^-8
    relative) in bfloat16 (the final cast of that float32 value);
  * the reference ops on a pair: 1e-5 in float32 (summation order);
  * the tiny UNet and txt2img against JAX under the same mode, with each
    int8 op on a quantized weight fed JAX's input to it: 1e-5 relative to
    the largest output (float32 summation order between the int8 ops);
  * the same, free-running: 0.05 for the UNet, 0.1 for the images (after
    two steps and the decode). Summation order moves a float32 activation
    by ~1e-7, which now and then moves its int8 value by one step where it
    sits at a rounding boundary; that step changes one term of a later
    product by 1/127 of it, and the next quantized layer amplifies it
    (measured 0 - 0.028 for the UNet over the three modes and two
    bindings, 0.036 for the images);
  * turbo against exact: JAX's own draft bounds
    (``tests/test_int8_turbo.py``): relative max error under 0.15 for
    int8 and int8_ff, under 0.25 for int8_conv, and not allclose at 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu import ops as jops
from stabletriton_tpu.compile import CompileConfig as JCompileConfig
from stabletriton_tpu.compile import fuse_attention_projections as jfuse
from stabletriton_tpu.compile import quantize_linear_weights as jquantize
from stabletriton_tpu.compile import resolve_binding as jresolve
from stabletriton_tpu.models import clip as jclip
from stabletriton_tpu.models import unet as junet
from stabletriton_tpu.models import vae as jvae
from stabletriton_tpu.ops import reference as jref
from stabletriton_tpu.ops import registry as jregistry
from stabletriton_tpu.runtime import pipeline as jpipe
from stabletriton_tpu_torch import ops as tops
from stabletriton_tpu_torch.compile import (
    FUSED_OP_OVERRIDES,
    CompileConfig,
    cast_params,
    fuse_attention_projections,
    quantize_linear_weights,
    resolve_binding,
)
from stabletriton_tpu_torch.io.convert import params_from_numpy
from stabletriton_tpu_torch.kernels import conv_direct as tconv
from stabletriton_tpu_torch.kernels import linear as tlinear
from stabletriton_tpu_torch.models import unet as tunet
from stabletriton_tpu_torch.ops import reference as tref
from stabletriton_tpu_torch.ops import registry as tregistry
from stabletriton_tpu_torch.runtime import pipeline as tpipe
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

MODES = {"int8": {}, "int8_ff": {"ff_only": True}, "int8_conv": {"conv": True}}
DRAFT_BOUND = {"int8": 0.15, "int8_ff": 0.15, "int8_conv": 0.25}
FREE_TOL = 0.05
IMAGE_FREE_TOL = 0.1
FORCED_TOL = 1e-5
STEP_SEED = 1


def np_init(shapes: dict, seed: int) -> dict:
    """Zero biases, unit norm scales, N(0, 1/fan_in) weights, from numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in sorted(shapes.items()):
        if name.endswith(".bias"):
            out[name] = np.zeros(shape, np.float32)
        elif "norm" in name and len(shape) == 1:
            out[name] = np.ones(shape, np.float32)
        else:
            fan = int(np.prod(shape[:-1]))
            out[name] = (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)
    return out


def _configs():
    tcfg = tpipe.tiny_configs()[0]
    return tcfg, junet.UNetConfig(**dataclasses.asdict(tcfg))


@pytest.fixture(scope="module")
def fused_params():
    """The tiny UNet's fused params: (numpy via JAX's fusion, port's)."""
    tcfg, jcfg = _configs()
    raw = np_init(junet.unet_param_shapes(jcfg), 0)
    jp = {k: np.asarray(v) for k, v in jfuse({k: jnp.asarray(v) for k, v in raw.items()}).items()}
    tp = fuse_attention_projections({k: torch.from_numpy(v) for k, v in raw.items()})
    assert sorted(jp) == sorted(tp)
    return jp, tp


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


def _jnp(a: np.ndarray, dtype):
    return jnp.asarray(a, jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)


# --------------------------------------------------------------------------
# quantize_linear_weights and the binding
# --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_matches_jax_bit_for_bit(fused_params, mode, dtype):
    """The same keys quantize; each int8 weight bit for bit and each scale
    exactly JAX's, from float32 or bfloat16 weights."""
    jp, tp = fused_params
    want = jquantize({k: _jnp(v, dtype) for k, v in jp.items()}, min_dim=16, **MODES[mode])
    got = quantize_linear_weights({k: v.to(dtype) for k, v in tp.items()}, min_dim=16,
                                  **MODES[mode])
    assert sorted(got) == sorted(want)
    pairs = sorted(k for k, v in want.items() if isinstance(v, tuple))
    assert pairs == sorted(k for k, v in got.items() if isinstance(v, tuple))
    assert pairs and not any("time_embedding" in k or "add_embedding" in k for k in pairs)
    if mode == "int8_ff":
        assert all(".net.0.proj." in k for k in pairs)
    if mode == "int8_conv":
        assert any(got[k][0].dim() == 4 for k in pairs)
        assert not isinstance(got["conv_in.weight"], tuple)
        assert not isinstance(got["conv_out.weight"], tuple)
    else:
        assert all(got[k][0].dim() == 2 for k in pairs)
    for k in pairs:
        wq, scale = got[k]
        assert wq.dtype == torch.int8 and scale.dtype == torch.float32
        assert wq.movedim(-1, 0).is_contiguous()  # output-channel-major storage
        np.testing.assert_array_equal(wq.numpy(), np.asarray(want[k][0]))
        np.testing.assert_array_equal(scale.numpy(), np.asarray(want[k][1]))
    for k in set(got) - set(pairs):
        assert got[k] is not None and not isinstance(got[k], tuple)


def test_quantize_rounds_half_to_even():
    """A weight at exact half steps of its scale rounds to even, as
    ``jnp.round`` does."""
    w = np.asarray([[127.0], [0.5], [1.5], [2.5], [-0.5], [-2.5]], np.float32) * np.ones(
        (1, 4), np.float32)
    got = quantize_linear_weights({"a.weight": torch.from_numpy(w)}, min_dim=1)["a.weight"]
    want = jquantize({"a.weight": jnp.asarray(w)}, min_dim=1)["a.weight"]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0][:, 0].tolist() == [127, 0, 2, 2, 0, -2]


PORT_TO_JAX = {"cuda": "pallas"}


def _as_jax(binding: dict) -> dict:
    """The port's binding in the JAX package's backend names: "cuda" is
    "pallas"; the default binding's kernel forms ("cuda_bf16apply") compute
    JAX's plain forms, the "bf16apply" norms and the reference GEGLU (which
    JAX leaves unbound)."""
    out = {}
    for op, bk in binding.items():
        if bk == "cuda_bf16apply":
            if op == "geglu":
                continue
            bk = "bf16apply"
        out[op] = PORT_TO_JAX.get(bk, bk)
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("backend,overrides", [
    ("cuda", ()), ("reference", ()), ("cuda", FUSED_OP_OVERRIDES),
])
def test_resolve_binding_matches_jax(mode, backend, overrides):
    """The quantize branch sits where JAX's does: after the backend's
    binding, before the overrides ("cuda" is JAX's "pallas")."""
    got = resolve_binding(CompileConfig(backend=backend, overrides=overrides, quantize=mode))
    jover = tuple((op, PORT_TO_JAX.get(bk, bk)) for op, bk in overrides)
    want = jresolve(JCompileConfig(backend=PORT_TO_JAX.get(backend, backend), overrides=jover,
                                   quantize=mode))
    assert _as_jax(got) == want
    assert got["linear"] == "int8"
    assert got.get("conv2d") == ("int8" if mode == "int8_conv" else
                                 "direct" if backend == "cuda" else None)
    # an override rebinds an op over the quantize mode
    assert resolve_binding(CompileConfig(quantize=mode, overrides=(("linear", "cuda"),))
                           )["linear"] == "cuda"


def test_unknown_quantize_mode_raises():
    for backend in ("cuda", "reference"):
        with pytest.raises(ValueError, match="unknown quantize mode"):
            resolve_binding(CompileConfig(backend=backend, quantize="fp8"))
    with pytest.raises(ValueError, match="unknown quantize mode"):
        jresolve(JCompileConfig(backend="reference", quantize="fp8"))


def test_cast_params_passes_pairs_through():
    pair = (torch.ones((4, 4), dtype=torch.int8), torch.ones(4))
    out = cast_params({"a.weight": pair, "b.weight": torch.ones(3)},
                      CompileConfig(dtype="bfloat16"))
    assert out["a.weight"] is pair
    assert out["b.weight"].dtype == torch.bfloat16


# --------------------------------------------------------------------------
# the W8A8 ops
# --------------------------------------------------------------------------


def _pair(rng, shape, dtype):
    """A weight quantized by both packages: (numpy float32 weight, port
    pair, JAX pair)."""
    w = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    tw = torch.from_numpy(w).to(dtype)
    got = quantize_linear_weights({"w.weight": tw}, min_dim=1, conv=len(shape) == 4)["w.weight"]
    want = jquantize({"w.weight": _jnp(w, dtype)}, min_dim=1, conv=len(shape) == 4)["w.weight"]
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    return got, want


def _check_out(got: torch.Tensor, want, dtype):
    assert got.dtype == dtype and tuple(got.shape) == tuple(want.shape)
    tol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-6
    assert _rel(_np(got), np.asarray(want, np.float32)) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("x_shape", [(1, 64), (2, 64), (17, 64), (2, 9, 64)])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("act", [None, "silu", "gelu"])
def test_linear_int8_matches_jax(dtype, x_shape, bias, act):
    """The per-token activation quantization and the int32 accumulators
    are JAX's exactly (M = 1 and 2 pad to 17 rows); the output within the
    file's op tolerance."""
    rng = np.random.default_rng(sum(x_shape) + bias)
    (wq, scale), jpair = _pair(rng, (64, 96), dtype)
    x = rng.standard_normal(x_shape).astype(np.float32)
    b = (rng.standard_normal(96) * 0.1).astype(np.float32) if bias else None
    tx, jx = torch.from_numpy(x).to(dtype), _jnp(x, dtype)
    xq, sx = tref._quantize_activations(tx.float(), -1)
    jxf = jx.astype(jnp.float32)
    jsx = jnp.maximum(jnp.max(jnp.abs(jxf), axis=-1, keepdims=True), 1e-8) * (1.0 / 127.0)
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    jxq = jnp.clip(jnp.round(jxf / jsx), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    acc = tref.int8_mm(xq.reshape(-1, 64), wq)
    jacc = jnp.dot(jxq.reshape(-1, 64), jpair[0], preferred_element_type=jnp.int32)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    got = tref.linear_int8(tx, (wq, scale), None if b is None else torch.from_numpy(b), act=act)
    want = jref.linear_int8(jx, jpair, None if b is None else jnp.asarray(b), act=act)
    _check_out(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_linear_int8_passes_an_unquantized_weight_through(dtype):
    """A float weight takes the reference linear: the port's own bits, and
    JAX's within the reference op's tolerance."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((5, 32)).astype(np.float32)
    w = (rng.standard_normal((32, 48)) * 0.2).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    tx, tw, tb = (torch.from_numpy(a).to(dtype) for a in (x, w, b))
    got = tref.linear_int8(tx, tw, tb, act="silu")
    assert torch.equal(got, tref.linear(tx, tw, tb, act="silu"))
    want = jref.linear_int8(_jnp(x, dtype), _jnp(w, dtype), _jnp(b, dtype), act="silu")
    _check_out(got, want, dtype)


@pytest.mark.parametrize("m", [1, 2, 16, 17, 40])
def test_int8_mm_pads_rows_exactly(m):
    """Rows pad with zeros to 17 (cuBLASLt's M > 16); the product is the
    exact int32 one, on a row-major and on an output-channel-major weight."""
    rng = np.random.default_rng(m)
    a = rng.integers(-127, 128, (m, 24)).astype(np.int8)
    b = rng.integers(-127, 128, (24, 40)).astype(np.int8)
    padded = tref.pad_int8_rows(torch.from_numpy(a))
    assert padded.shape == (max(m, 17), 24) and not padded[m:].any()
    want = a.astype(np.int64) @ b.astype(np.int64)
    for tb in (torch.from_numpy(b), torch.from_numpy(b).t().contiguous().t()):
        got = tref.int8_mm(torch.from_numpy(a), tb)
        assert got.dtype == torch.int32 and tuple(got.shape) == (m, 40)
        np.testing.assert_array_equal(got.numpy(), want)


CONV_CASES = {
    "3x3 s1": dict(k=3, stride=1, padding=1),
    "3x3 s2 asym": dict(k=3, stride=2, padding=((0, 1), (0, 1))),
    "3x3 s2 (downsampler)": dict(k=3, stride=2, padding=1),
    "1x1 (shortcut)": dict(k=1, stride=1, padding=0),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CONV_CASES))
@pytest.mark.parametrize("epilogue", [
    {}, {"bias": "cout"}, {"bias": "batch", "act": "silu"},
    {"bias": "cout", "residual": True, "act": "gelu"},
])
def test_conv2d_int8_matches_jax(dtype, case, epilogue):
    """Per-sample activation quantization, the int8 patches' int32
    accumulators (strides and asymmetric padding) and the epilogue
    ((Cout,) or (B, Cout) bias, residual, act) against JAX's op."""
    c = CONV_CASES[case]
    k, stride, padding = c["k"], c["stride"], c["padding"]
    rng = np.random.default_rng(len(case) + len(epilogue))
    (wq, scale), jpair = _pair(rng, (k, k, 16, 24), dtype)
    x = rng.standard_normal((2, 9, 10, 16)).astype(np.float32)
    tx, jx = torch.from_numpy(x).to(dtype), _jnp(x, dtype)
    xq, _ = tref._quantize_activations(tx.float(), (1, 2, 3))
    cols, (bsz, ho, wo) = tref._im2col(xq, k, k, stride, padding)
    acc = tref.int8_mm(cols, wq.reshape(-1, 24)).reshape(bsz, ho, wo, 24)
    jxf = jx.astype(jnp.float32)
    jsx = jnp.maximum(jnp.max(jnp.abs(jxf), axis=(1, 2, 3), keepdims=True), 1e-8) * (1 / 127)
    jxq = jnp.clip(jnp.round(jxf / jsx), -127, 127).astype(jnp.int8)
    np.testing.assert_array_equal(xq.numpy(), np.asarray(jxq))
    pad = [(padding, padding)] * 2 if isinstance(padding, int) else list(padding)
    jacc = jax.lax.conv_general_dilated(jxq, jpair[0], (stride, stride), pad,
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"),
                                        preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(acc.numpy(), np.asarray(jacc))
    kw = {"act": epilogue.get("act")}
    if "bias" in epilogue:
        b = (rng.standard_normal((24,) if epilogue["bias"] == "cout" else (2, 24)) * 0.1
             ).astype(np.float32)
        kw["b"] = b
    if epilogue.get("residual"):
        kw["residual"] = rng.standard_normal((2, ho, wo, 24)).astype(np.float32)
    tkw = {n: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for n, v in kw.items()}
    if "residual" in tkw:
        tkw["residual"] = tkw["residual"].to(dtype)
    jkw = {n: (_jnp(v, dtype) if n == "residual" else jnp.asarray(v))
           if isinstance(v, np.ndarray) else v for n, v in kw.items()}
    got = tref.conv2d_int8(tx, (wq, scale), stride=stride, padding=padding, **tkw)
    want = jref.conv2d_int8(jx, jpair, stride=stride, padding=padding, **jkw)
    assert got.is_contiguous()
    _check_out(got, want, dtype)


def test_conv2d_int8_passes_an_unquantized_weight_through():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 6, 6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 8, 8)).astype(np.float32))
    assert torch.equal(tref.conv2d_int8(x, w, act="silu"), tref.conv2d(x, w, act="silu"))


@pytest.mark.parametrize("op", ["linear", "conv2d"])
def test_reference_ops_dequantize_a_pair(op):
    """The exact path on a pair: the dequantized weight (``wq * scale``,
    cast to x's dtype) through the reference op, as JAX's, within 1e-5."""
    rng = np.random.default_rng(11)
    shape = (40, 24) if op == "linear" else (3, 3, 16, 24)
    pair, jpair = _pair(rng, shape, torch.float32)
    x = rng.standard_normal((3, 40) if op == "linear" else (2, 7, 7, 16)).astype(np.float32)
    tx = torch.from_numpy(x)
    got = getattr(tref, op)(tx, pair)
    assert torch.equal(got, getattr(tref, op)(tx, tref.dequantize(pair)))
    want = getattr(jref, op)(jnp.asarray(x), jpair)
    assert _rel(_np(got), want) <= 1e-5


# --------------------------------------------------------------------------
# the kernel bindings' guards
# --------------------------------------------------------------------------


def _conv_pair(seed=5, c=16):
    rng = np.random.default_rng(seed)
    pair, _ = _pair(rng, (3, 3, c, c), torch.float32)
    x = torch.from_numpy(rng.standard_normal((2, 8, 8, c)).astype(np.float32))
    return x, pair


def test_direct_conv_steps_aside_on_a_pair():
    """conv2d "direct" on a pair is the reference conv on it, bit for bit."""
    x, pair = _conv_pair()
    b = torch.linspace(-1, 1, 16)
    assert torch.equal(tconv.conv2d_direct(x, pair, b, act="silu"),
                       tref.conv2d(x, pair, b, act="silu"))


@pytest.mark.parametrize("conv_backend", ["direct", "int8"])
def test_fused_gn_conv_composes_on_a_pair(conv_backend):
    """gn_conv2d "fused" on a pair composes group_norm -> conv2d through
    the active binding: under int8_conv that conv is the int8 op."""
    x, pair = _conv_pair()
    gamma, beta = torch.ones(16), torch.zeros(16)
    with tops.use_backends({"gn_conv2d": "fused", "group_norm": "cuda",
                            "conv2d": conv_backend}):
        got = tops.gn_conv2d(x, gamma, beta, pair, None, num_groups=4, act="silu")
        h = tops.group_norm(x, gamma, beta, num_groups=4, act="silu")
    conv = tref.conv2d_int8 if conv_backend == "int8" else tref.conv2d
    assert torch.equal(got, conv(h, pair, None, act="silu"))


def test_cuda_linear_refuses_a_pair():
    pair = (torch.ones((8, 8), dtype=torch.int8), torch.ones(8))
    with pytest.raises(ValueError, match="quantized"):
        tlinear.linear(torch.ones((2, 8)), pair)


# --------------------------------------------------------------------------
# the tiny UNet in each mode, and a tiny turbo txt2img
# --------------------------------------------------------------------------


def _step_inputs(tcfg, seed):
    """numpy (sample, t, ehs, text_embeds, time_ids) at JAX's test shapes."""
    rng = np.random.default_rng(seed)
    pooled = tcfg.projection_class_embeddings_input_dim - 6 * tcfg.addition_time_embed_dim
    return (rng.standard_normal((2, 16, 16, 4)).astype(np.float32),
            np.full((2,), 500.0, np.float32),
            rng.standard_normal((2, 7, tcfg.cross_attention_dim)).astype(np.float32),
            rng.standard_normal((2, pooled)).astype(np.float32),
            np.zeros((2, 6), np.float32))


def _recorder(op, fn, seen):
    """JAX's int8 op ``fn``, appending the input of each call on a quantized
    weight to ``seen`` in program order as the program runs."""
    def wrapped(x, w, *a, **kw):
        if isinstance(w, tuple):
            jax.debug.callback(lambda v: seen.append((op, np.array(v))), x, ordered=True)
        return fn(x, w, *a, **kw)
    return wrapped


def _forcer(op, fn, calls):
    """The port's int8 op ``fn``, each call on a quantized weight fed the
    next of JAX's recorded inputs (the same op and shape) in place of its
    own."""
    def wrapped(x, w, *a, **kw):
        if not isinstance(w, tuple):
            return fn(x, w, *a, **kw)
        jop, jx = next(calls)
        assert (op, tuple(x.shape)) == (jop, jx.shape)
        return fn(torch.from_numpy(jx).to(x.dtype), w, *a, **kw)
    return wrapped


def _wrap_int8_ops(monkeypatch, registry, wrap, *extra):
    """Replace the registry's int8 linear and conv2d by ``wrap(op, fn, *extra)``."""
    for op in ("linear", "conv2d"):
        monkeypatch.setitem(registry._REGISTRY[op], "int8",
                            wrap(op, registry._REGISTRY[op]["int8"], *extra))


@pytest.fixture(scope="module")
def jax_forwards(fused_params):
    """JAX's tiny UNet forward (jitted, reference binding) on the fused
    params at STEP_SEED's inputs: "exact", and for each mode its turbo
    forward with the inputs of its int8 ops on quantized weights, in
    program order."""
    tcfg, jcfg = _configs()
    jp, _ = fused_params
    args = [jnp.asarray(a) for a in _step_inputs(tcfg, STEP_SEED)]

    def forward(params):
        return np.asarray(jax.jit(lambda p, *a: junet.unet_apply(jcfg, p, *a))(params, *args))

    out = {"exact": forward({k: jnp.asarray(v) for k, v in jp.items()})}
    with pytest.MonkeyPatch.context() as mp:
        for mode in MODES:
            seen = []
            _wrap_int8_ops(mp, jregistry, _recorder, seen)
            jq = jquantize({k: jnp.asarray(v) for k, v in jp.items()}, min_dim=16, **MODES[mode])
            with jops.use_backends(jresolve(JCompileConfig(backend="reference", quantize=mode))):
                want = forward(jq)
            jax.effects_barrier()
            out[mode] = want, seen
            mp.undo()
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("backend", ["reference", "cuda"])
def test_turbo_unet_matches_jax_and_stays_near_exact(fused_params, jax_forwards, monkeypatch,
                                                       mode, backend):
    """The tiny UNet on the quantized fused params under each mode's
    binding (``backend="cuda"`` runs the kernels' plain versions on the
    CPU, the fused-op binding's GN-fused conv stepping aside on a pair),
    against JAX's reference binding in the same mode:

      * free-running, within FREE_TOL of JAX's turbo forward, and against
        the exact forward inside JAX's draft bound and not allclose at 1e-4;
      * with each int8 op on a quantized weight fed JAX's input to that op
        (the same sequence of such ops), within FORCED_TOL of JAX. (JAX's
        reference GN-conv also sends its unquantized convs through the int8
        op's pass-through, where the port's fused one runs its kernel.)"""
    tcfg, _ = _configs()
    _, tp = fused_params
    want, seen = jax_forwards[mode]
    exact = jax_forwards["exact"]
    tq = quantize_linear_weights(tp, min_dim=16, **MODES[mode])
    args = _step_inputs(tcfg, STEP_SEED)
    overrides = FUSED_OP_OVERRIDES if backend == "cuda" else ()
    binding = resolve_binding(CompileConfig(backend=backend, quantize=mode, overrides=overrides))

    def port_forward():
        with torch.inference_mode(), tops.use_backends(binding):
            return tunet.unet_apply(tcfg, tq, *(torch.from_numpy(a) for a in args)).numpy()

    got = port_forward()
    assert _rel(got, want) <= FREE_TOL
    assert _rel(got, exact) < DRAFT_BOUND[mode]
    assert not np.allclose(got, exact, atol=1e-4)

    calls = iter(seen)
    _wrap_int8_ops(monkeypatch, tregistry, _forcer, calls)
    forced = port_forward()
    assert seen and next(calls, None) is None
    assert _rel(forced, want) <= FORCED_TOL


@pytest.mark.parametrize("mode", list(MODES))
def test_pipeline_quantizes_after_fusing_and_casting(mode):
    """SDXLPipeline's UNet params under ``quantize``: the fused params cast
    to the compile dtype, then quantized with the mode's rules."""
    raw = tunet.init_unet_params(tpipe.tiny_configs()[0], 0)
    config = CompileConfig(dtype="bfloat16", quantize=mode, quantize_min_dim=16)
    pipe = tpipe.make_tiny_pipeline(config)
    want = quantize_linear_weights(cast_params(fuse_attention_projections(raw), config),
                                   min_dim=16, **MODES[mode])
    got = pipe.params["unet"]
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        if isinstance(w, tuple):
            assert torch.equal(got[key][0], w[0]) and torch.equal(got[key][1], w[1])
        else:
            assert torch.equal(got[key], w)


def _ids(cfg, batch, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.full((batch, cfg.max_position_embeddings), cfg.eos_token_id, np.int32)
    for i in range(batch):
        n = 3 + 2 * i
        ids[i, 0] = cfg.bos_token_id
        ids[i, 1:1 + n] = rng.integers(0, 90, n)
    return ids


def _jax_noise(seeds, shape, device):
    """The JAX pipeline's initial noise (one PRNG key per image's seed)."""
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
        jax.random.PRNGKey(s), shape, jnp.float32)) for s in seeds]))


def test_turbo_txt2img_matches_jax(monkeypatch):
    """A tiny 2-step txt2img under ``quantize="int8"``, ``quantize_min_dim=16``
    against JAX's tiny pipeline with the same config and numpy weights
    (the same initial noise): free-running, finite, within IMAGE_FREE_TOL
    of JAX's images and not the exact pipeline's; with each int8 linear fed
    JAX's input to it (recorded in program order while JAX's program runs;
    the same sequence of calls on quantized weights), within FORCED_TOL of
    JAX's images."""
    ucfg, c1, c2, vcfg = tpipe.tiny_configs()
    ju, jc1, jc2 = (junet.UNetConfig(**dataclasses.asdict(ucfg)),
                    jclip.CLIPTextConfig(**dataclasses.asdict(c1)),
                    jclip.CLIPTextConfig(**dataclasses.asdict(c2)))
    jv = jvae.VAEConfig(**dataclasses.asdict(vcfg))
    params = {"unet": np_init(junet.unet_param_shapes(ju), 0),
              "text_encoder": np_init(jclip.clip_param_shapes(jc1), 1),
              "text_encoder_2": np_init(jclip.clip_param_shapes(jc2), 2),
              "vae": np_init(jvae.vae_decoder_param_shapes(jv), 3)}
    turbo = dict(dtype="float32", quantize="int8", quantize_min_dim=16)
    jp = jpipe.SDXLPipeline(
        unet_config=ju, clip_config=jc1, clip2_config=jc2, vae_config=jv,
        params={g: {k: jnp.asarray(v) for k, v in tree.items()} for g, tree in params.items()},
        compile_config=JCompileConfig(backend="reference", **turbo))
    monkeypatch.setattr(tpipe, "initial_noise", _jax_noise)
    tp = tpipe.make_tiny_pipeline(CompileConfig(backend="reference", **turbo),
                                  params=params_from_numpy(params))
    exact = tpipe.make_tiny_pipeline(CompileConfig(backend="reference", dtype="float32"),
                                     params=params_from_numpy(params))
    assert any(isinstance(v, tuple) for v in tp.params["unet"].values())
    ids = _ids(c1, 2)
    kw = dict(height=32, width=32, steps=2, seed=[3, 4])

    seen = []
    _wrap_int8_ops(monkeypatch, jregistry, _recorder, seen)
    want = np.asarray(jp.txt2img(jnp.asarray(ids), jnp.asarray(ids), **kw))
    jax.effects_barrier()
    got = tp.txt2img(ids, ids, **kw).numpy()
    assert got.shape == want.shape == (2, 32, 32, 3) and np.isfinite(got).all()
    assert _rel(got, want) <= IMAGE_FREE_TOL
    assert not np.allclose(got, exact.txt2img(ids, ids, **kw).numpy(), atol=1e-4)

    calls = iter(seen)
    _wrap_int8_ops(monkeypatch, tregistry, _forcer, calls)
    forced = tp.txt2img(ids, ids, **kw).numpy()
    assert seen and next(calls, None) is None
    assert _rel(forced, want) <= FORCED_TOL
