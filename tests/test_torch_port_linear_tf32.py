"""The f32 linear (K13 in f32) on the 3xTF32 wgmma GEMM, host side on the CPU.

``gemm_wgmma_tf32x3<2>`` (csrc/tf32_gemm.cuh, the f32 attention's GEMM in
its plain-GEMM mode) runs only on the card (tests/test_torch_port_gpu.py).
What the CPU can hold: the route (f32 above 16 rows to ``wgmma_tf32x3``,
at most 16 to the skinny kernel), the exact B split of w^T the wrapper
hands the kernel (:func:`tf32_weight`: big + small == w^T with zero columns
up to a multiple of 4, big exact in tf32), the A operand it hands TMA
(:func:`_tf32_rows`: K padded, or a copy at an aligned base), and the
kernel's arithmetic emulated in float64 (a_small w_big + a_big w_small +
a_big w_big, each operand read as tf32, then the bias in its own dtype and
the activation on the f32 sum) against :func:`linear_plain` and the JAX
package's Pallas ``fused_linear`` in interpret mode, within 1e-5 of the
largest output: what 3xTF32 drops (a_small w_small and the small parts' own
tf32 truncation) is ~2^-21 of a product.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu.kernels.linear import fused_linear as jfused_linear
from stabletriton_tpu_torch.kernels import linear as tlinear
from stabletriton_tpu_torch.ops.reference import apply_activation
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOW13 = 0x1FFF


@pytest.mark.parametrize("m,k,n,want", [
    (16384, 512, 512, "wgmma_tf32x3"),  # the SDXL VAE's mid-attention projections
    (4096, 512, 512, "wgmma_tf32x3"),   # SD1.5's
    (17, 70, 45, "wgmma_tf32x3"),       # the fewest rows above the skinny kernel's
    (16, 512, 512, "skinny_f32"),
    (2, 1280, 1280, "skinny_f32"),
])
def test_f32_linear_routes(m, k, n, want):
    assert tlinear.variant(m, k, n, torch.float32) == want
    assert tlinear.variant(m, k, n, torch.float32, aligned=False) == want


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """t as the tensor cores read a tf32 operand: low 13 mantissa bits dropped."""
    return (t.float().contiguous().view(torch.int32) & -8192).view(torch.float32)


@pytest.mark.parametrize("k,n", [(512, 512), (70, 45), (1, 3), (0, 8)])
def test_tf32_weight_is_the_exact_split_of_w_t(k, n):
    rng = np.random.default_rng(k + n)
    w = torch.from_numpy((rng.standard_normal((k, n)) * 3).astype(np.float32))
    big, small = tlinear.tf32_weight(w)
    k4 = max(4, -(-k // 4) * 4)
    assert big.shape == small.shape == (n, k4)
    assert big.dtype == small.dtype == torch.float32
    assert big.is_contiguous() and small.is_contiguous()
    assert torch.equal(big + small, torch.cat([w.t(), torch.zeros((n, k4 - k))], dim=1))
    assert not (big.view(torch.int32) & LOW13).any()
    assert torch.equal(big[:, k:], torch.zeros_like(big[:, k:]))
    assert (small.abs() <= big.abs() * 2.0 ** -10).all()


def test_tf32_rows_pads_k_and_aligns_the_base():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((5, 70)).astype(np.float32))
    padded = tlinear._tf32_rows(x)
    assert padded.shape == (5, 72) and torch.equal(padded[:, :70], x)
    assert torch.equal(padded[:, 70:], torch.zeros((5, 2)))
    flat = torch.from_numpy(rng.standard_normal(5 * 64 + 1).astype(np.float32))
    off = flat[1:].view(5, 64)
    assert off.data_ptr() % 16 != 0
    moved = tlinear._tf32_rows(off)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, off)
    aligned = torch.from_numpy(rng.standard_normal((5, 64)).astype(np.float32))
    if aligned.data_ptr() % 16 == 0:
        assert tlinear._tf32_rows(aligned) is aligned


def _emulate(x, w, b, act):
    """The kernel's function in float64: the 3xTF32 products of the split
    operands (x split in registers, w^T by the wrapper), summed, then the
    bias in its own dtype and the activation, rounded to f32."""
    x2 = tlinear._tf32_rows(x)
    xb = _tf32(x2)
    xs = _tf32(x2 - xb)
    big, small = tlinear.tf32_weight(w)
    wb, ws = big.double().t(), _tf32(small).double().t()
    out = xs.double() @ wb + xb.double() @ ws + xb.double() @ wb
    if b is not None:
        out = out + b.double()
    return apply_activation(out.float(), act)


@pytest.mark.parametrize("act", [None, "silu", "gelu"])
@pytest.mark.parametrize("bias", [None, "float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(200, 512, 64), (154, 70, 45)])
def test_tf32x3_linear_arithmetic_matches_f32(m, k, n, bias, act):
    """(154, 70, 45): odd M, K % 4 != 0 (padded) and odd N."""
    rng = np.random.default_rng(m + k + n)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / math.sqrt(k)).astype(np.float32)
    b = None if bias is None else rng.standard_normal(n).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w)
    tb = None if b is None else torch.from_numpy(b).to(getattr(torch, bias))
    got = _emulate(tx, tw, tb, act).numpy()
    plain = tlinear.linear_plain(tx, tw, tb, act=act).numpy()
    jb = None if tb is None else jnp.asarray(tb.float().numpy(), getattr(jnp, bias))
    pallas = np.asarray(jfused_linear(jnp.asarray(x), jnp.asarray(w), jb, act=act,
                                      interpret=True))
    scale = np.abs(plain).max()
    assert np.abs(got - plain).max() <= 1e-5 * scale
    assert np.abs(got - pallas).max() <= 1e-5 * scale
    # one tf32 product alone is ~1e-3 off: the split is what keeps f32 accuracy
    one = apply_activation((_tf32(tx).double() @ _tf32(tw).double()
                            + (0 if tb is None else tb.double())).float(), act).numpy()
    assert np.abs(one - plain).max() > 1e-4 * scale
