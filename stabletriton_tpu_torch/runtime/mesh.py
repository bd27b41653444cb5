"""Device mesh and tensor-parallel sharding over ``torch.distributed``.

Counterpart of ``stabletriton_tpu/runtime/mesh.py``. The JAX package is one
controller over a ``jax.sharding.Mesh`` with axes ("data", "model"), and XLA
inserts the collectives. The port is SPMD: one process per rank (started by
``torchrun``), a ``DeviceMesh`` with the same two axis names, and every rank
running the same program on its own shards:

  * "data" splits the request batch: a rank runs its contiguous slice of
    it, and the images are all-gathered, so every rank returns the whole
    batch, as JAX returns one global array (``runtime/pipeline.py``);
  * "model" splits the UNet's attention heads and feed-forward width,
    Megatron-style, by the JAX package's name rules (:func:`param_sharding`):
    q / k / v column-parallel, so a rank runs h / model heads on the same
    kernels; to_out.0 and ff.net.2 row-parallel, each rank's partial product
    (rounded to the activations' dtype by the linear) all-reduced over
    "model" in float32, the bias added once after the reduce
    (:func:`row_parallel_linear`).

On one rank both axes are size 1 and nothing here runs. Under NCCL the
row-parallel all-reduces are captured with the rest of the denoise loop;
a gloo group cannot be captured, so a tensor-parallel pipeline on the card
needs NCCL (``SDXLPipeline`` raises otherwise).

Not ported: ``audit_hlo_collectives`` (there is no HLO; the one collective
inside the model is the explicit all-reduce above), ``batch_sharding`` (a
rank slices its batch itself) and the Pallas kernels' ``shard_map``
wrappers (a rank's kernels see only its shards).
"""

from __future__ import annotations

import contextlib
import contextvars
import os

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

# the mesh the model runs under (the pipeline enters it around each program
# call, as JAX's pipeline wraps its traces in use_mesh)
_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "stabletriton_torch_active_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Run the model under ``mesh`` inside the block (None: off a mesh)."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def active_mesh():
    return _ACTIVE_MESH.get()


def make_mesh(data: int | None = None, model: int = 1, device_type: str = "cuda"):
    """A ("data", "model") DeviceMesh over every rank: data-parallel x
    tensor-parallel, data-major (the ranks of one "model" group are
    consecutive). Initialises the default process group from torchrun's
    environment where none exists; on the card each rank takes the card of
    its LOCAL_RANK first. The mesh is on the card unless the caller asks for
    ``device_type="cpu"`` (gloo); without a card a "cuda" mesh raises."""
    from torch.distributed.device_mesh import init_device_mesh

    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: torch sees no CUDA device; pass device_type='cpu' "
                           "for a CPU (gloo) mesh")
    if device_type == "cuda" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    n = dist.get_world_size() if dist.is_initialized() else int(os.environ["WORLD_SIZE"])
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh data x model must be the world size: {(data, model, n)}")
    return init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis_size(mesh, axis: str) -> int:
    """The number of ranks along ``axis``; 1 off a mesh."""
    if mesh is None:
        return 1
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def replicated(mesh) -> None:
    """The layout of a parameter every rank holds whole: split on no
    dimension (:func:`param_sharding`'s None)."""
    return None


def param_sharding(name: str, shape: tuple[int, ...], mesh) -> int | None:
    """The dimension a UNet / CLIP / VAE parameter is split on over "model",
    by state-dict name, or None where every rank holds it whole. The JAX
    package's rules:

      * column-parallel (dim 1, output features) for ``.to_q.`` / ``.to_k.``
        / ``.to_v.`` weights, whose head-aligned column shards feed a rank's
        heads; row-parallel (dim 0, input features) for ``.to_out.0.`` and
        ``.ff.net.2.`` weights, each followed by one all-reduce;
      * only inside ``transformer_blocks`` (the VAE's single-head attention
        shares the names; one head cannot be split) and only where the
        dimension divides;
      * everything else whole: convs, norms, embeddings, proj_in / proj_out
        (their consumers need full channels), the GEGLU up-projection (its
        [state | gate] concat is not split-aligned) and fused to_qkv /
        to_kv weights (the reason a tensor-parallel pipeline keeps the
        projections unfused)."""
    model = axis_size(mesh, MODEL_AXIS)
    if model == 1 or len(shape) != 2 or "transformer_blocks" not in name:
        return replicated(mesh)
    if name.endswith(".weight"):
        if any(m in name for m in (".to_q.", ".to_k.", ".to_v.")) and shape[1] % model == 0:
            return 1
        if any(m in name for m in (".to_out.0.", ".ff.net.2.")) and shape[0] % model == 0:
            return 0
    return replicated(mesh)


def _rank_slice(size: int, mesh, axis: str) -> slice:
    parts, rank = axis_size(mesh, axis), mesh.get_local_rank(axis)
    step = size // parts
    return slice(rank * step, (rank + 1) * step)


def shard_params(params: dict, mesh) -> dict:
    """This rank's slices of a flat param dict, by :func:`param_sharding`,
    each copied into its own memory (the whole tensors can be freed). A quantized
    (int8, scale) pair splits the int8 weight by the same rules and its
    per-output-channel scale with the weight's output dimension; the int8
    weight stays output-channel-major, the layout cuBLASLt's int8 GEMM
    takes (a row-major slice ran 1.8-5.5x slower, PERF.md)."""
    out = {}
    for k, v in params.items():
        w = v[0] if isinstance(v, tuple) else v
        dim = param_sharding(k, tuple(w.shape), mesh)
        if dim is None:
            out[k] = v
            continue
        sl = _rank_slice(w.shape[dim], mesh, MODEL_AXIS)
        if isinstance(v, tuple):
            wq, scale = v
            # copied in the (out, in) order the weight is stored in
            wq = (wq.movedim(-1, 0)[sl] if dim == 1 else wq.movedim(-1, 0)[:, sl])
            out[k] = (_compact(wq).movedim(0, -1), _compact(scale[sl]) if dim == 1 else scale)
        else:
            out[k] = _compact(w[:, sl] if dim == 1 else w[sl])
    return out


def _compact(t: torch.Tensor) -> torch.Tensor:
    """A row-major copy of the slice ``t`` in its own memory."""
    return t.clone(memory_format=torch.contiguous_format)


def row_parallel_linear(x: torch.Tensor, w, b: torch.Tensor | None, full_in: int):
    """``ops.linear(x, w, b)`` for a row-parallel weight: ``full_in`` is the
    unsplit weight's input width. Off a tensor-parallel mesh, or where w
    holds all ``full_in`` rows, it is that linear. Else w holds this rank's
    rows: x's matching columns (x itself where it holds only those, as the
    local heads' attention output does) times w, all-reduced over "model"
    in float32, then the bias, once, and a rounding to x's dtype. The
    linear returns each rank's partial in x's dtype, so in bf16 the
    partials are rounded before the reduce as well: two roundings where
    the unsharded linear makes one (the model=2 step's error, PERF.md)."""
    from stabletriton_tpu_torch import ops

    mesh = active_mesh()
    k_local = (w[0] if isinstance(w, tuple) else w).shape[0]
    if axis_size(mesh, MODEL_AXIS) == 1 or k_local == full_in:
        return ops.linear(x, w, b)
    if x.shape[-1] == full_in:
        x = x[..., _rank_slice(full_in, mesh, MODEL_AXIS)]
    part = ops.linear(x, w).float()
    dist.all_reduce(part, group=mesh.get_group(MODEL_AXIS))
    if b is not None:
        part = part + b.float()
    return part.to(x.dtype)


def batch_slice(batch: int, mesh) -> slice:
    """This rank's contiguous rows of a batch split over "data"; a batch the
    data axis does not divide raises."""
    data = axis_size(mesh, DATA_AXIS)
    if batch % data:
        raise ValueError(f"batch {batch} is not divisible by the mesh's data axis ({data})")
    return _rank_slice(batch, mesh, DATA_AXIS) if data > 1 else slice(0, batch)


def gather_batch(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every rank's ``t`` along dim 0, in rank order over "data": the whole
    batch on every rank."""
    if axis_size(mesh, DATA_AXIS) == 1:
        return t
    group = mesh.get_group(DATA_AXIS)
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)
