"""The port's exploratory FFT convolution against the JAX package's, on the CPU.

The same numpy inputs (from seeds) go through ``stabletriton_tpu.kernels.
fft_conv`` and ``stabletriton_tpu_torch.kernels.fft_conv`` at the JAX
package's own test shapes (``tests/test_fft_conv.py``), with its tolerances:
1e-3 * max(1, K / 32) in 1D, 1e-4 in 2D, 1e-5 for the identity kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stabletriton_tpu.kernels import fft_conv as jfft
from stabletriton_tpu_torch.kernels import fft_conv as tfft
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("n,k", [(64, 5), (256, 33), (1024, 257)])
def test_fft_conv1d_matches_jax(n, k):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, n)).astype(np.float32)
    kern = rng.standard_normal(k).astype(np.float32)
    got = tfft.fft_conv1d(torch.from_numpy(x), torch.from_numpy(kern))
    want = np.asarray(jfft.fft_conv1d(jnp.asarray(x), jnp.asarray(kern)))
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, n)
    tol = 1e-3 * max(1, k / 32)
    np.testing.assert_allclose(got.numpy(), want, atol=tol)
    direct = np.stack([np.convolve(row, kern)[:n] for row in x])
    np.testing.assert_allclose(got.numpy(), direct, atol=tol)


def test_fft_conv2d_matches_jax():
    from scipy import signal

    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 16, 16, 2)).astype(np.float32)
    kern = rng.standard_normal((5, 5)).astype(np.float32)
    got = tfft.fft_conv2d(torch.from_numpy(x), torch.from_numpy(kern))
    want = np.asarray(jfft.fft_conv2d(jnp.asarray(x), jnp.asarray(kern)))
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    for c in range(2):
        ref = signal.convolve2d(x[0, :, :, c], kern, mode="same")
        np.testing.assert_allclose(got[0, :, :, c].numpy(), ref, atol=1e-4)


def test_fft_conv2d_identity_kernel_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
    kern = np.zeros((3, 3), np.float32)
    kern[1, 1] = 1.0
    got = tfft.fft_conv2d(torch.from_numpy(x), torch.from_numpy(kern)).numpy()
    np.testing.assert_allclose(got, np.asarray(jfft.fft_conv2d(jnp.asarray(x),
                                                               jnp.asarray(kern))), atol=1e-5)
    np.testing.assert_allclose(got, x, atol=1e-5)


def test_fft_conv_registers_no_op():
    from stabletriton_tpu.ops.registry import registered_ops as jregistered
    from stabletriton_tpu_torch.ops.registry import registered_ops as tregistered

    assert not any("fft" in op for op in tregistered())
    assert not any("fft" in op for op in jregistered())
