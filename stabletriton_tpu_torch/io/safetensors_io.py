"""safetensors files in and out, and torch layout -> this package's layout.

Counterpart of ``stabletriton_tpu/io/safetensors_io.py``. The container is
parsed directly (8-byte little-endian header length, a JSON table of
tensors, raw little-endian data): each tensor is a ``torch.frombuffer``
view of the file, mapped copy-on-write, in its own dtype (BF16 and F16 stay
bf16 and f16 up to the caller's cast). Each tensor is then converted to
this package's layout, the JAX package's rules:

  torch nn.Linear weight (out, in)  -> (in, out)
  torch conv weight OIHW            -> HWIO
  embeddings / norms / biases       -> unchanged

Key names stay the HF state_dict keys the models use. :func:`write_safetensors`
writes the same container, for the checkpoints the tests and the card's
smoke run make (no ``safetensors`` package needed).
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path

import numpy as np
import torch

DTYPES = {
    "F64": torch.float64,
    "F32": torch.float32,
    "F16": torch.float16,
    "BF16": torch.bfloat16,
    "I64": torch.int64,
    "I32": torch.int32,
    "I16": torch.int16,
    "I8": torch.int8,
    "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}

# older diffusers VAE checkpoints name the mid-block attention's projections so
_VAE_ATTN_RENAMES = {
    ".query.": ".to_q.",
    ".key.": ".to_k.",
    ".value.": ".to_v.",
    ".proj_attn.": ".to_out.0.",
}


def read_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """A .safetensors file -> {name: CPU tensor}, each a view of the mapped
    file in the file's dtype (copy-on-write: writing a tensor never writes
    the file). The mapping lives as long as its tensors."""
    path = Path(path)
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        mapped = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + header_len
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = DTYPES.get(info["dtype"])
        if dtype is None:
            raise ValueError(f"unsupported dtype {info['dtype']} for {name}")
        start, end = info["data_offsets"]
        shape = tuple(info["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != itemsize * int(np.prod(shape, dtype=np.int64)):
            raise ValueError(f"{name}: {end - start} bytes for shape {shape} {info['dtype']}")
        if end == start:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(mapped, dtype=dtype, count=(end - start) // itemsize,
                                         offset=base + start).reshape(shape)
    return out


def write_safetensors(path: str | Path, tensors: dict, metadata: dict | None = None) -> None:
    """{name: tensor or array} -> a .safetensors file. Tensors are written
    in order of their item size, largest first, then by name (so each lies
    at an offset that is a multiple of its item size), after a header padded
    to 8 bytes; a tensor on the card is copied to the host one at a time."""
    items = []
    for name, t in tensors.items():
        t = torch.as_tensor(t)
        if t.dtype not in _NAMES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors name")
        items.append((name, t))
    items.sort(key=lambda it: (-it[1].element_size(), it[0]))
    header: dict = {"__metadata__": dict(metadata)} if metadata else {}
    offset = 0
    for name, t in items:
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for _, t in items:
            if t.numel():
                host = t.detach().contiguous().cpu()
                f.write(host.reshape(-1).view(torch.uint8).numpy().data)


def to_framework_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """One torch-layout tensor in this package's layout, contiguous, on its
    own device: every 2D ``.weight`` transposed but embeddings', 4D OIHW to
    HWIO."""
    if not name.endswith(".weight"):
        return t
    if "embedding" in name.rsplit(".", 2)[-2]:
        return t  # token / position embeddings stay (vocab, d)
    if t.dim() == 2:
        return t.t().contiguous()
    if t.dim() == 4:
        return t.permute(2, 3, 1, 0).contiguous()
    return t


def convert_state_dict(sd: dict, *, strip_prefix: str = "", dtype: torch.dtype | None = None,
                       device=None) -> dict[str, torch.Tensor]:
    """A whole torch-layout state_dict (tensors or arrays) -> this package's
    param dict: the prefix stripped, the VAE attention renamed, each tensor
    moved to ``device`` (None: where it lies), in this package's layout,
    cast to ``dtype`` (None: its own)."""
    out = {}
    for name, t in sd.items():
        if strip_prefix and name.startswith(strip_prefix):
            name = name[len(strip_prefix):]
        for old, new in _VAE_ATTN_RENAMES.items():
            if old in name:
                name = name.replace(old, new)
        t = torch.as_tensor(t).detach()
        if device is not None:
            t = t.to(device)
        t = to_framework_layout(name, t)
        if dtype is not None:
            t = t.to(dtype)
        out[name] = t
    return out


def load_params(path: str | Path, *, strip_prefix: str = "", dtype: torch.dtype | None = None,
                device=None) -> dict[str, torch.Tensor]:
    """read_safetensors + convert_state_dict in one call."""
    return convert_state_dict(read_safetensors(path), strip_prefix=strip_prefix, dtype=dtype,
                              device=device)


def validate_against_shapes(params: dict, expected: dict[str, tuple[int, ...]]) -> None:
    """Raise ValueError unless a param dict matches a model's shape table
    exactly: the same keys, each of its shape."""
    missing = sorted(set(expected) - set(params))
    extra = sorted(set(params) - set(expected))
    if missing or extra:
        raise ValueError(
            f"param mismatch: {len(missing)} missing (e.g. {missing[:3]}), "
            f"{len(extra)} unexpected (e.g. {extra[:3]})"
        )
    for k, shape in expected.items():
        if tuple(params[k].shape) != tuple(shape):
            raise ValueError(f"{k}: shape {tuple(params[k].shape)} != expected {tuple(shape)}")
