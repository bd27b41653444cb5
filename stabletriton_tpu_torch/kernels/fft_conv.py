"""FFT convolution (exploratory), on ``torch.fft``.

Counterpart of ``stabletriton_tpu/kernels/fft_conv.py``, which follows the
reference's FFT-conv track (reference ``src/stabletriton/tests/flash_fft.py``):
an O(N log N) convolution for kernels far beyond 3x3 (long 1D operators,
large blur kernels), where a direct conv's operations explode. It is on no
model path and registers no op, as in the JAX package. It is no Pallas
kernel there (it is ``jnp.fft``), so its counterpart is ``torch.fft``: cuFFT
on the card, the CPU's FFT on the CPU.
"""

from __future__ import annotations

import torch


def _pow2(n: int) -> int:
    size = 1
    while size < n:
        size *= 2
    return size


def fft_conv1d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Linear (not circular) 1D convolution via FFT.

    x: (..., N); kernel: (K,) with K <= N. Returns the 'same' slice (the
    first N samples of the full convolution), float32."""
    n, k = x.shape[-1], kernel.shape[-1]
    size = _pow2(n + k - 1)
    xf = torch.fft.rfft(x.float(), size)
    kf = torch.fft.rfft(kernel.float(), size)
    return torch.fft.irfft(xf * kf, size)[..., :n]


def fft_conv2d(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise 'same' 2D convolution via FFT.

    x: (B, H, W, C); kernel: (kh, kw), applied to every channel (a
    blur-style operator). Odd kernel sizes; zero boundary. float32."""
    b, h, w, c = x.shape
    kh, kw = kernel.shape
    sh, sw = _pow2(h + kh - 1), _pow2(w + kw - 1)
    xf = torch.fft.rfft2(x.float().permute(0, 3, 1, 2), (sh, sw))  # (B, C, H, W)
    kf = torch.fft.rfft2(kernel.float(), (sh, sw))
    full = torch.fft.irfft2(xf * kf, (sh, sw))
    oy, ox = kh // 2, kw // 2
    return full[:, :, oy:oy + h, ox:ox + w].permute(0, 2, 3, 1)
