"""Public op surface: model code calls these; the registry binds the backend.

``ops.attention(...)`` dispatches to whichever implementation the active
binding selects ("reference" plain PyTorch, or a hand-written kernel).
"""

from functools import partial

from stabletriton_tpu_torch.ops.registry import (  # noqa: F401
    current_binding,
    dispatch,
    register,
    registered_ops,
    resolve,
    use_backends,
)
from stabletriton_tpu_torch.ops import reference  # noqa: F401  (registers "reference")

attention = partial(dispatch, "attention")
attention_qkv = partial(dispatch, "attention_qkv")
attention_kv = partial(dispatch, "attention_kv")
group_norm = partial(dispatch, "group_norm")
layer_norm = partial(dispatch, "layer_norm")
rms_norm = partial(dispatch, "rms_norm")
geglu = partial(dispatch, "geglu")
linear = partial(dispatch, "linear")
time_embed = partial(dispatch, "time_embed")
conv2d = partial(dispatch, "conv2d")
gn_conv2d = partial(dispatch, "gn_conv2d")
