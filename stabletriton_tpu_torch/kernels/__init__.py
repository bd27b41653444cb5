"""Hand-written Hopper kernels; importing this package registers their backends.

  flash_attention - attention, attention_qkv, attention_kv -> "cuda"
                    (csrc/flash_attention.cu)
  conv_direct     - conv2d -> "direct" (csrc/conv3x3.cu for 3x3 stride-1 SAME);
                    gn_conv2d -> "fused" (the same kernel with a GroupNorm
                    prologue, scale / shift from csrc/group_norm.cu)
  group_norm      - group_norm -> "cuda", "cuda_bf16apply" (csrc/group_norm.cu)
  layer_norm      - layer_norm -> "cuda", "cuda_bf16apply"; rms_norm -> "cuda"
                    (csrc/layer_norm.cu)
  geglu           - geglu -> "cuda", "cuda_bf16apply" (csrc/geglu.cu)
  linear          - linear -> "cuda" (csrc/linear.cu; f32 on csrc/tf32_gemm.cuh)
  time_embed      - time_embed -> "cuda" (csrc/time_embed.cu)
  dropout         - dropout -> "cuda" (csrc/dropout.cu) and "reference" (its
                    plain version; no model path reaches dropout)

Beside them, registering nothing: ``wgmma_plan`` (the fitted tile / split
rules), ``autotune`` (the measured table the routes read first) and
``fft_conv`` (exploratory FFT convolution on torch.fft).

The default binding uses flash_attention, conv2d "direct" and the
"cuda_bf16apply" forms of group_norm, layer_norm and geglu (the kernels
with the roundings of that binding's plain forms); the others are opt-in
through ``CompileConfig.overrides``. The CUDA sources are compiled at
first launch (kernels/build.py); importing builds nothing.
"""

from stabletriton_tpu_torch.kernels import (  # noqa: F401
    conv_direct,
    dropout,
    flash_attention,
    geglu,
    group_norm,
    layer_norm,
    linear,
    time_embed,
)
