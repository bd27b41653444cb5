"""The f32 3x3 conv's 3xTF32 kernel, host side on the CPU.

``conv_wgmma_tf32x3`` (csrc/conv3x3.cu) runs only on the card
(tests/test_torch_port_gpu.py). What the CPU can hold: the weight split the
wrapper hands it (:func:`tf32_split`: big + small == w exactly, big exact in
tf32, Cout padded to a multiple of 8 with zero rows, K-major), which f32
convs route to it (every 3x3 conv of the SDXL VAE decoder but conv_in),
and the kernel's arithmetic emulated in float64: a_big w_big + a_big w_small
+ a_small w_big, each operand read as tf32 (the low 13 mantissa bits
dropped), against the plain f32 conv and the JAX package's Pallas conv
(interpret mode). Tolerance 1e-5 of the largest output: what 3xTF32 drops
(a_small w_small and the small parts' own tf32 truncation) is ~2^-21 of a
product, far under the 1e-4 the card's f32 rows are held to.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu.kernels.conv_direct import conv3x3_direct
from stabletriton_tpu_torch.kernels import conv_direct as tconv
from stabletriton_tpu_torch.models import vae as tvae
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

LOW13 = 0x1FFF


@pytest.mark.parametrize("cin", [8, 128])
@pytest.mark.parametrize("cout", [3, 8, 128])
def test_tf32_split_is_exact(cin, cout):
    rng = np.random.default_rng(cin + cout)
    w = torch.from_numpy((rng.standard_normal((3, 3, cin, cout)) * 3).astype(np.float32))
    big, small = tconv.tf32_split(w)
    pad = -cout % 8
    assert big.shape == small.shape == (cout + pad, 9 * cin)
    assert big.dtype == small.dtype == torch.float32
    assert big.is_contiguous() and small.is_contiguous()
    # K-major: row n holds w[ky, kx, ci, n] at k = (3 ky + kx) Cin + ci
    assert torch.equal(big + small, torch.cat([w.reshape(9 * cin, cout).t(),
                                               torch.zeros((pad, 9 * cin))]))
    assert not (big.view(torch.int32) & LOW13).any()
    assert torch.equal(big[cout:], torch.zeros_like(big[cout:]))
    assert torch.equal(small[cout:], torch.zeros_like(small[cout:]))
    # the small part is the dropped low bits: under a tf32 ulp of big
    assert (small.abs() <= big.abs() * 2.0 ** -10).all()


def test_vae_decoder_convs_route_to_tf32():
    """Of the SDXL VAE decoder's 33 3x3 convs, the 32 with Cin % 8 == 0 go
    to the tf32 kernel and conv_in (Cin = 4) to the direct kernel."""
    shapes = tvae.vae_decoder_param_shapes(tvae.sdxl_vae_config())
    routes = {}
    for name, shape in shapes.items():
        if len(shape) == 4 and shape[:2] == (3, 3):
            route = tconv.conv_variant((1, 128, 128, shape[2]), shape[3], torch.float32)
            routes.setdefault(route, []).append(name)
    assert len(routes["wgmma_tf32x3"]) == 32
    assert routes["direct_f32"] == ["decoder.conv_in.weight"]


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """t as the tensor cores read a tf32 operand: low 13 mantissa bits dropped."""
    return (t.float().contiguous().view(torch.int32) & -8192).view(torch.float32)


def _emulate(x, w, bias, residual, act):
    """The kernel's function in float64: the 3xTF32 products of the split
    operands, summed, then the f32 epilogue."""
    xb = _tf32(x)
    xs = _tf32(x - xb)
    big, small = tconv.tf32_split(w)
    cin, cout = w.shape[2], w.shape[3]
    to_hwio = lambda m: m[:cout].t().reshape(3, 3, cin, cout).double()
    wb, ws = to_hwio(big), to_hwio(_tf32(small))

    def conv(a, b):
        return torch.nn.functional.conv2d(a.double().permute(0, 3, 1, 2),
                                          b.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)

    out = (conv(xs, wb) + conv(xb, ws) + conv(xb, wb)).float()
    out = out + (bias[:, None, None, :] if bias.dim() == 2 else bias)
    if residual is not None:
        out = out + residual
    return torch.nn.functional.silu(out) if act == "silu" else out


@pytest.mark.parametrize("cin,cout,batch_bias,res,act", [
    (128, 128, False, True, None),     # the decoder's resnet conv2 form
    (64, 3, False, False, None),       # conv_out: Cout padded to 8
    (32, 40, True, False, "silu"),
    (24, 16, False, True, "silu"),     # a ragged channel chunk (Cin % 32)
])
def test_tf32x3_arithmetic_matches_f32(cin, cout, batch_bias, res, act):
    rng = np.random.default_rng(cin * cout)
    b, h, w = 2, 9, 11
    x = rng.standard_normal((b, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((3, 3, cin, cout)) / math.sqrt(9 * cin)).astype(np.float32)
    bias = rng.standard_normal((b, cout) if batch_bias else (cout,)).astype(np.float32)
    r = rng.standard_normal((b, h, w, cout)).astype(np.float32) if res else None
    tx, tw, tb = (torch.from_numpy(a) for a in (x, wt, bias))
    tr = None if r is None else torch.from_numpy(r)
    got = _emulate(tx, tw, tb, tr, act).numpy()
    plain = tconv.conv3x3_plain(tx, tw, tb, residual=tr, act=act).numpy()
    pallas = np.asarray(conv3x3_direct(jnp.asarray(x), jnp.asarray(wt), jnp.asarray(bias),
                                       residual=None if r is None else jnp.asarray(r), act=act,
                                       interpret=True))
    scale = np.abs(plain).max()
    assert np.abs(got - plain).max() <= 1e-5 * scale
    assert np.abs(got - pallas).max() <= 1e-5 * scale
    # one tf32 product alone is ~1e-3 off: the split is what keeps f32 accuracy
    one = _emulate(_tf32(tx), _tf32(tw), tb, tr, act).numpy()
    assert np.abs(one - plain).max() > 1e-4 * scale
