"""stabletriton_tpu_torch: the SDXL / SD1.x / SD2.x serving path on PyTorch, with
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
  io/         checkpoints in (safetensors, diffusers directories, SGM / A1111
              single files of SDXL, SD2.x and SD1.x), the CLIP tokenizer,
              LoRA, torch-module ingestion, the JAX package's parameters
  frontends/  the diffusers drop-in (``compile(pipe.unet)``), the sgm / A1111
              splice and ComfyUI nodes
  native.py   the C++ host library (native/src): widening, transposes, RGB8
              and PNG output, the BPE tokenizer
"""

__version__ = "0.1.0"

from stabletriton_tpu_torch import ops  # noqa: F401
from .compile import CompileConfig, resolve_binding  # noqa: F401
