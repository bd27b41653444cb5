"""stabletriton_tpu_torch: the SDXL txt2img serving path on PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

A port of the JAX package ``stabletriton_tpu``, which stays the reference:
the same op registry and bindings, the same models over the same HF-keyed
parameter dicts and layouts (NHWC activations, HWIO convs, (in, out)
linears), the same pipeline and serving engine. It imports neither JAX nor
``stabletriton_tpu``.

  ops/        op registry and plain-PyTorch reference backends
  kernels/    wrappers of the CUDA kernels in csrc/, built at first use
  models/     UNet, CLIP text encoders, VAE decoder
  runtime/    schedule and solvers, the CFG denoise loop (guidance interval,
              DeepCache), its CUDA-graph replay, txt2img pipeline, serving
  io/         conversion of the JAX package's parameters
"""

__version__ = "0.1.0"

from stabletriton_tpu_torch import ops  # noqa: F401
from .compile import CompileConfig, resolve_binding  # noqa: F401
