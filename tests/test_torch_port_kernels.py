"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the port's wrappers run their kernels' plain versions (a CUDA
kernel has no interpret mode); the JAX entry points run their Pallas kernels
in interpret mode, as tests/test_kernels.py runs them. Same numpy inputs,
float32, atol 1e-3 as in tests/test_kernels.py (the Pallas kernels' own
gate against the reference ops).

The CUDA kernels themselves are checked on the card by
tests/test_torch_port_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu.kernels.conv_direct import conv3x3_direct
from stabletriton_tpu.kernels.flash_attention import (
    flash_attention,
    flash_attention_kv,
    flash_attention_qkv,
)
from stabletriton_tpu_torch.kernels import build
from stabletriton_tpu_torch.kernels import conv_direct as tconv
from stabletriton_tpu_torch.kernels import flash_attention as tfa
from stabletriton_tpu_torch.ops import reference as tref
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-3


def _arr(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(j, t, atol=ATOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=0)


@pytest.mark.parametrize(
    "block_q,block_k",
    [(128, 256),   # packed single-KV: the whole KV in one block (K1)
     (128, 128)],  # packed online softmax: KV blocked (K2)
)
def test_attention_qkv_vs_packed_pallas(block_q, block_k):
    rng = np.random.default_rng(0)
    qkv = _arr(rng, 1, 256, 3 * 2 * 64)
    j = flash_attention_qkv(jnp.asarray(qkv), num_heads=2, block_q=block_q, block_k=block_k)
    _close(j, tfa.flash_attention_qkv(torch.from_numpy(qkv), num_heads=2))


def test_attention_kv_padded_cross_vs_pallas():
    """Cross attention against 77 keys, padded to a 128 block and masked."""
    rng = np.random.default_rng(1)
    q, kv = _arr(rng, 2, 128, 128), _arr(rng, 2, 77, 256)
    j = flash_attention_kv(jnp.asarray(q), jnp.asarray(kv), num_heads=2,
                           block_q=64, block_k=128)
    _close(j, tfa.flash_attention_kv(torch.from_numpy(q), torch.from_numpy(kv), num_heads=2))


def test_attention_head_major_d512_vs_pallas():
    """h=1, d=512: the VAE mid-block shape, the head-major online kernel (K3)."""
    rng = np.random.default_rng(2)
    q, k, v = (_arr(rng, 1, 256, 512, scale=0.5) for _ in range(3))
    j = flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), num_heads=1,
                        block_q=128, block_k=128)
    t = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), num_heads=1)
    _close(j, t)


def test_attention_plain_agrees_with_reference_op():
    """The shift-free base-2 softmax is the max-subtracted softmax when no
    base-2 logit reaches the clip at 80."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_arr(rng, 2, 40, 64)) for _ in range(3))
    np.testing.assert_allclose(tfa.attention_plain(q, k, v, num_heads=2).numpy(),
                               tref.attention(q, k, v, num_heads=2).numpy(), atol=1e-5)


@pytest.mark.parametrize(
    "shape,bias_kind,res,act",
    [
        ((2, 11, 8, 16, 32), "batch", True, "silu"),   # (B, Cout) bias, residual, SiLU
        ((2, 9, 7, 4, 3), "shared", False, None),      # Cin=4 / Cout=3 ragged edges
        ((1, 6, 5, 8, 4), "shared", True, None),
    ],
)
def test_conv3x3_vs_pallas(shape, bias_kind, res, act):
    b, h, w, cin, cout = shape
    rng = np.random.default_rng(4)
    x = _arr(rng, b, h, w, cin)
    wt = _arr(rng, 3, 3, cin, cout, scale=0.2)
    bias = _arr(rng, *((b, cout) if bias_kind == "batch" else (cout,)))
    r = _arr(rng, b, h, w, cout) if res else None
    j = conv3x3_direct(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
                       residual=None if r is None else jnp.asarray(r), act=act)
    t = tconv.conv3x3(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(bias),
                      residual=None if r is None else torch.from_numpy(r), act=act)
    _close(j, t)


def test_conv2d_direct_routes_by_shape():
    """3x3 stride-1 SAME goes to the kernel wrapper; strided, 1x1 and
    asymmetric padding go to the plain conv; CPU tensors launch nothing."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(_arr(rng, 2, 8, 8, 6))
    w3 = torch.from_numpy(_arr(rng, 3, 3, 6, 5, scale=0.2))
    w1 = torch.from_numpy(_arr(rng, 1, 1, 6, 5, scale=0.2))
    bias = torch.from_numpy(_arr(rng, 5))
    before = tconv.LAUNCHES.count
    for kw, wt in [({}, w3), ({"stride": 2}, w3), ({"padding": 0}, w1),
                   ({"stride": 2, "padding": ((0, 1), (0, 1))}, w3)]:
        np.testing.assert_allclose(tconv.conv2d_direct(x, wt, bias, **kw).numpy(),
                                   tref.conv2d(x, wt, bias, **kw).numpy(), atol=1e-5)
    assert tconv.LAUNCHES.count == before  # the plain version launches nothing


def test_wrappers_reject_what_kernels_do_not_take():
    x = torch.zeros(1, 4, 4, 8)
    with pytest.raises(ValueError, match="weight"):
        tconv.conv3x3(x, torch.zeros(3, 3, 4, 8))
    with pytest.raises(ValueError, match="bias"):
        tconv.conv3x3(x, torch.zeros(3, 3, 8, 8), torch.zeros(3, 8))
    with pytest.raises(ValueError, match="act"):
        tconv.conv3x3(x, torch.zeros(3, 3, 8, 8), act="gelu")
    with pytest.raises(ValueError, match="fused kv"):
        tfa.flash_attention_kv(torch.zeros(1, 4, 8), torch.zeros(1, 3, 8), num_heads=1)
    with pytest.raises(ValueError, match="shapes disagree"):
        tfa.flash_attention(torch.zeros(1, 4, 8), torch.zeros(1, 3, 8), torch.zeros(1, 2, 8))


def test_build_sources_and_flags():
    """The library is built from every csrc/*.cu for sm_90a; the cache key
    follows the sources."""
    names = {p.name for p in build.sources()}
    assert {"flash_attention.cu", "conv3x3.cu"} <= names
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert len(build._source_hash()) == 16


def test_launch_counter():
    c = build.LaunchCounter()
    c.add("a")
    c.add("a")
    c.add("b")
    assert (c.count, c.by_key) == (3, {"a": 2, "b": 1})
    c.reset()
    assert (c.count, c.by_key) == (0, {})
