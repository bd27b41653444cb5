"""The f32 attention's 3xTF32 kernel (K3 in f32), host side on the CPU.

``gemm_wgmma_tf32x3`` (csrc/flash_attention.cu) runs only on the card
(tests/test_torch_port_gpu.py). What the CPU can hold: which launches route
to it, the operands the wrapper hands it (:func:`tf32_attention_operands`:
K per head as it lies, V^T padded to whole 128-key tiles, each split into
big + small exactly), the query-row chunking (:func:`attention_chunk_rows`),
and the kernel's arithmetic emulated in float64: q times f32(scale log2e)
rounded once, the three tf32 products of the split operands (each operand
read as tf32: low 13 mantissa bits dropped), p = exp2(min(s, 80)) masked
past Sk, the per-128-key-tile row partials of p summed in the kernel's fixed
order, P V the same way, a chunk of query rows at a time. Held against
``attention_plain`` and the JAX package's K3 route (``_flash_kernel``, a KV
loop of 128-key blocks, interpret mode) on the same numpy inputs, within
1e-5 of the largest output: what 3xTF32 drops is ~2^-21 of a product, and
the f32 sums differ from the plain version's only in order.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu.kernels import flash_attention as jfa
from stabletriton_tpu_torch.kernels import flash_attention as tfa
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TILE = tfa.TF32_TILE


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """t as the tensor cores read a tf32 operand: low 13 mantissa bits dropped."""
    return (t.float().contiguous().view(torch.int32) & -8192).view(torch.float32)


def _products(a: torch.Tensor, b_big: torch.Tensor, b_small: torch.Tensor) -> torch.Tensor:
    """a_small b_big + a_big b_small + a_big b_big in float64, B as (N, K)
    K-major parts; a split in registers as the kernel does."""
    a_big = _tf32(a)
    a_small = _tf32(a - a_big)
    b_big, b_small = b_big.double(), _tf32(b_small).double()
    return (a_small.double() @ b_big.T + a_big.double() @ b_small.T
            + a_big.double() @ b_big.T).float()


def _row_sums(p: torch.Tensor) -> torch.Tensor:
    """The kernel's l: one f32 partial a 128-key tile, then lane q of a quad
    sums tiles q, q + 4, ... in order and the quad adds (l0 + l1) + (l2 + l3)."""
    partials = p.reshape(p.shape[0], -1, TILE).sum(-1)  # f32, within a tile
    lanes = []
    for q in range(4):
        acc = torch.zeros(p.shape[0], dtype=torch.float32)
        for t in range(q, partials.shape[1], 4):
            acc = acc + partials[:, t]
        lanes.append(acc)
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def _emulate(q, k, v, num_heads, rows=None):
    """gemm_wgmma_tf32x3's function in plain PyTorch (see the module note)."""
    b, sq, c = q.shape
    sk, d = k.shape[1], c // num_heads
    qscale = torch.tensor(tfa.LOG2E / math.sqrt(d), dtype=torch.float32)
    k_big, k_small, vt_big, vt_small = tfa.tf32_attention_operands(k, v, num_heads)
    keys = vt_big.shape[2]
    rows = rows or tfa.attention_chunk_rows(b * num_heads, sq, sk)
    out = torch.empty_like(q)
    for z in range(b * num_heads):
        bi, hi = divmod(z, num_heads)
        cols = slice(hi * d, (hi + 1) * d)
        for r0 in range(0, sq, rows):
            qz = q[bi, r0:r0 + rows, cols] * qscale           # one f32 rounding
            s = _products(qz, k_big[z], k_small[z])           # (rows, Sk)
            p = torch.exp2(torch.clamp(s, max=tfa.SOFTMAX_CLIP))
            p = torch.nn.functional.pad(p, (0, keys - sk))     # keys past Sk: p = 0
            o = _products(p, vt_big[z], vt_small[z])
            out[bi, r0:r0 + rows, cols] = o / _row_sums(p).clamp(min=1e-30)[:, None]
    return out


@pytest.mark.parametrize("rows", [None, 128])
@pytest.mark.parametrize("d", [64, 512])
def test_tf32_attention_emulation_matches_plain_and_pallas(d, rows):
    """Sq = 200 (two 128-row chunks when rows = 128, one planned), Sk = 300
    (84 keys masked in the last 128-key tile), h = 1 as in the VAE."""
    sq, sk = 200, 300
    rng = np.random.default_rng(d + (rows or 0))
    q, k, v = (rng.standard_normal((1, s, d)).astype(np.float32) for s in (sq, sk, sk))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = _emulate(tq, tk, tv, 1, rows).numpy()
    plain = tfa.attention_plain(tq, tk, tv, num_heads=1).numpy()
    pallas = np.asarray(jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            num_heads=1, block_q=128, block_k=128,
                                            interpret=True))
    scale = np.abs(plain).max()
    assert np.abs(got - plain).max() <= 1e-5 * scale
    assert np.abs(got - pallas).max() <= 1e-5 * scale
    # one tf32 product alone is far off: the split is what keeps f32 accuracy
    k_one = _tf32(tk)
    one = tfa.attention_plain(_tf32(tq), k_one, _tf32(tv), num_heads=1).numpy()
    assert np.abs(one - plain).max() > 1e-4 * scale


def test_f32_attention_routes_to_the_tf32_kernel():
    """Every f32 class (the VAE's h=1 is K3) names the 3xTF32 kernel, which
    takes both f32 head dims; bf16 keeps its kernels."""
    for h, d, sk in [(1, 512, 16384), (1, 512, 4096), (1, 64, 300), (2, 64, 77), (3, 64, 2000)]:
        cls = tfa.attention_class(h, d, sk)
        assert cls in ("K1", "K3", "K5")
        assert tfa.kernel_name(torch.float32, sk) == "wgmma_tf32x3"
    assert tfa.kernel_name(torch.float32, 16384) == "wgmma_tf32x3"
    assert tfa.kernel_name(torch.bfloat16, 16384) == "wgmma_bf16"
    assert tfa.HEAD_DIMS[torch.float32] == (64, 512)
    assert all(d % 32 == 0 for d in tfa.HEAD_DIMS[torch.float32])  # k steps of 32 f32


@pytest.mark.parametrize("h,sk", [(1, 300), (3, 128), (2, 1)])
def test_tf32_attention_operands_layout(h, sk):
    """K per head as it lies (B*H, Sk, D); V^T (B*H, D, keys), keys = Sk
    rounded up to 128 with zero columns; big + small == the operand exactly,
    big exact in tf32; all contiguous f32 (TMA's terms)."""
    b, d = 2, 64
    rng = np.random.default_rng(h * sk)
    k = torch.from_numpy((rng.standard_normal((b, sk, h * d)) * 3).astype(np.float32))
    v = torch.from_numpy((rng.standard_normal((b, sk, h * d)) * 3).astype(np.float32))
    k_big, k_small, vt_big, vt_small = tfa.tf32_attention_operands(k, v, h)
    keys = -(-sk // TILE) * TILE
    assert k_big.shape == k_small.shape == (b * h, sk, d)
    assert vt_big.shape == vt_small.shape == (b * h, d, keys)
    for t in (k_big, k_small, vt_big, vt_small):
        assert t.dtype == torch.float32 and t.is_contiguous()
    k_heads = k.reshape(b, sk, h, d).transpose(1, 2).reshape(b * h, sk, d)
    v_t = v.reshape(b, sk, h, d).permute(0, 2, 3, 1).reshape(b * h, d, sk)
    assert torch.equal(k_big + k_small, k_heads)
    assert torch.equal((vt_big + vt_small)[..., :sk], v_t)
    assert not (vt_big[..., sk:].any() or vt_small[..., sk:].any())
    assert not ((k_big.view(torch.int32) & 0x1FFF).any() or (vt_big.view(torch.int32) & 0x1FFF).any())


@pytest.mark.parametrize("bh,sq,sk", [(1, 16384, 16384), (2, 16384, 16384), (1, 4096, 4096),
                                      (1, 200, 300), (1, 4097, 16384), (64, 100, 16384)])
def test_attention_chunk_rows_bound_the_workspace(bh, sq, sk):
    """A chunk is whole 128-row tiles, at least one, at most Sq rounded up,
    and its P workspace stays within 256 MiB unless one tile is more: at
    the VAE's 16384 keys, 4096 rows."""
    rows = tfa.attention_chunk_rows(bh, sq, sk)
    keys = -(-sk // TILE) * TILE
    assert rows % TILE == 0 and TILE <= rows <= -(-sq // TILE) * TILE
    assert rows == TILE or bh * rows * keys * 4 <= tfa.P_WORKSPACE_BYTES
    assert rows == -(-sq // TILE) * TILE or bh * (rows + TILE) * keys * 4 > tfa.P_WORKSPACE_BYTES
    if (bh, sk) == (1, 16384):
        assert rows == min(4096, -(-sq // TILE) * TILE)
