"""The whole-loop replay runtime: a function captured as one CUDA graph per
call signature, and replayed on every later call of that signature.

Counterpart of what ``jax.jit`` and its shape-keyed cache do for the JAX
package (``stabletriton_tpu/compile.py``, ``runtime/denoise.py``), and of
the original StableTriton's dynamic graph cache (SURVEY.md §2):

  jit trace per signature      -> an eager warm-up, then a torch.cuda.graph
                                  capture of the same call
  one dispatch per call        -> graph.replay(): no kernel launch from Python
  shape-keyed memo             -> :func:`signature`-keyed dict per function
  fresh output arrays          -> clones of the graph's static outputs

The first call of a signature runs the function eagerly on copies of its
inputs (the warm-up: lazy builds, ``cudaFuncSetAttribute`` and cuBLAS's
workspace happen there, outside the capture) and returns that result; then it
captures the same call on the same copies, which become the graph's static
input buffers. A later call copies its inputs into those buffers in place,
replays the graph and returns clones of the static outputs, so a call never
hands out memory that the next replay overwrites.

Arguments are trees of tuples, lists, dicts, None, tensors and Python
scalars, passed by position or by name (bound to positions, defaults
filled in, as the function's signature says). Scalars are part of the
signature (the graph bakes them in), as are each tensor's shape, dtype and
device. The tensors of argument 0, the parameters, are not copied: the graph
reads them in place at the addresses seen at capture, which are part of the
signature, so parameters must not move while their graphs are in use, and a
parameter changed in place is read by the next replay. On the CPU there is no graph: the function runs as it is.
On the card a capture that fails raises; nothing falls back to eager runs.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
import threading
import time
from typing import Any, Callable

import torch

from stabletriton_tpu_torch.kernels import build

_TENSOR = object()  # the place of a tensor leaf in a tree's spec


def flatten(tree, leaves: list) -> Any:
    """Appends the tree's tensors to ``leaves`` in order; returns its spec: a
    hashable description of the structure, dict keys and scalars."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _TENSOR
    if isinstance(tree, dict):
        return (dict, tuple((k, flatten(v, leaves)) for k, v in tree.items()))
    if isinstance(tree, (tuple, list)):
        return (type(tree), tuple(flatten(v, leaves) for v in tree))
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return (type(tree), tree)
    raise TypeError(f"a graphed call takes trees of tensors and scalars, got {type(tree)}")


def unflatten(spec, leaves) -> Any:
    """The tree of ``spec`` with its tensors taken in order from the
    iterator ``leaves``."""
    if spec is _TENSOR:
        return next(leaves)
    kind, body = spec
    if kind is dict:
        return {k: unflatten(s, leaves) for k, s in body}
    if kind in (tuple, list):
        return kind(unflatten(s, leaves) for s in body)
    return body


def signature(args: tuple) -> tuple[tuple, list, list]:
    """The key of a call, and its tensors split into those copied into
    static buffers and those of argument 0 (the parameters), read in place.
    The key holds every argument's spec, each copied tensor's shape, dtype
    and device, and each parameter's address."""
    copied, held = [], []
    specs = [flatten(arg, copied if i else held) for i, arg in enumerate(args)]
    key = (tuple(specs), tuple((tuple(t.shape), t.dtype, t.device) for t in copied),
           tuple(t.data_ptr() for t in held))
    return key, copied, held


def on_card(t: torch.Tensor) -> bool:
    """Whether a call on ``t`` is captured: graphs exist only on the card."""
    return t.device.type == "cuda"


@dataclasses.dataclass
class Captured:
    """One signature's graph, its static buffers and what its capture cost."""

    graph: torch.cuda.CUDAGraph
    inputs: list            # static input buffers, in the order of the copied leaves
    outputs: list           # static outputs, in the order of out_spec's leaves
    out_spec: Any
    held: list              # the parameters, kept alive: the graph reads them
    tally: dict             # launches a replay runs (build.recording)
    warmup_s: float         # host seconds of the eager warm-up (its result returned)
    enter_s: float          # host seconds of torch.cuda.graph's entry (synchronize,
                            # empty_cache) and cudaStreamBeginCapture
    capture_s: float        # host seconds of the captured call
    end_s: float            # host seconds of cudaStreamEndCapture
    instantiate_s: float    # host seconds of cudaGraphInstantiate


class Graphs:
    """The graphs of one owner (a pipeline, or compile_unet_kv's triple):
    one memory pool all of them share, one side stream for warm-ups and
    captures, and one lock every capture and replay holds. The graphs share
    the pool, so no two may run at once, and their static buffers are shared
    state: a replay starts after the previous one's outputs were copied out
    (an event on the stream that copied them), whichever thread or stream it
    came from. Makes no CUDA call before the first capture."""

    def __init__(self):
        self.lock = threading.Lock()
        self._streams: dict = {}
        self._pool = None
        self._done: torch.cuda.Event | None = None

    def wrap(self, fn: Callable) -> GraphedCallable:
        """``fn`` replayed from one graph per signature; its argument 0 is
        read in place (module docstring)."""
        return GraphedCallable(fn, self)

    def _side_stream(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._streams[device]

    def _after_last(self, stream: torch.cuda.Stream) -> None:
        if self._done is not None:
            stream.wait_event(self._done)

    def _mark_done(self, stream: torch.cuda.Stream) -> None:
        if self._done is None:
            self._done = torch.cuda.Event()
        self._done.record(stream)


class GraphedCallable:
    """``fn`` captured as one CUDA graph per signature (module docstring).
    ``__wrapped__`` is ``fn`` itself, and ``captured`` maps each signature
    to its :class:`Captured`. On the card every call runs under
    ``torch.inference_mode()``: a replay records no autograd graph."""

    def __init__(self, fn: Callable, graphs: Graphs):
        functools.update_wrapper(self, fn)
        self._fn, self._graphs = fn, graphs
        self._params = inspect.signature(fn)
        self.captured: dict[tuple, Captured] = {}

    def __call__(self, *args, **kwargs):
        call = self._params.bind(*args, **kwargs)
        call.apply_defaults()
        args = call.args
        key, copied, held = signature(args)
        first = copied[0] if copied else held[0] if held else None
        if first is None or not on_card(first):
            return self._fn(*args)
        with torch.inference_mode(), self._graphs.lock:
            entry = self.captured.get(key)
            if entry is None:
                return self._capture(key, args, copied, held, first.device)
            stream = torch.cuda.current_stream(first.device)
            self._graphs._after_last(stream)
            for buf, x in zip(entry.inputs, copied):
                buf.copy_(x)
            entry.graph.replay()
            outs = [t.clone() for t in entry.outputs]
            self._graphs._mark_done(stream)
            build.count_replay(entry.tally)
            return unflatten(entry.out_spec, iter(outs))

    def _capture(self, key, args, copied, held, device):
        """The first call of a signature: the eager warm-up on static copies
        of the inputs (its result is returned), then the capture."""
        if any(t.device != device for t in copied + held):
            raise ValueError("a graphed call takes tensors on one device")
        graphs = self._graphs
        side = graphs._side_stream(device)
        caller = torch.cuda.current_stream(device)
        graphs._after_last(caller)
        side.wait_stream(caller)
        t0 = time.perf_counter()
        with torch.cuda.stream(side):
            inputs = [t.clone(memory_format=torch.contiguous_format) for t in copied]
            static_args = self._static_args(args, inputs)
            result = self._fn(*static_args)
        caller.wait_stream(side)
        result_leaves = []
        flatten(result, result_leaves)
        for t in result_leaves:
            t.record_stream(caller)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t1 = time.perf_counter()
        try:
            # the outer stream context gives the caller its stream back even
            # where torch.cuda.graph's exit raises (an invalidated capture)
            with torch.cuda.stream(side), build.recording() as tally, torch.cuda.graph(
                    graph, pool=graphs._pool, stream=side, capture_error_mode="thread_local"):
                t2 = time.perf_counter()
                out = self._fn(*static_args)
                t3 = time.perf_counter()
            t4 = time.perf_counter()
            graph.instantiate()
        except Exception as e:
            # such a capture can leave the allocator recording to the pool:
            # the next capture takes a new one
            graphs._pool = None
            raise RuntimeError(f"capturing {self.__name__} failed; nothing runs eagerly "
                               f"in its place") from e
        t5 = time.perf_counter()
        outputs = []
        out_spec = flatten(out, outputs)
        self.captured[key] = Captured(graph, inputs, outputs, out_spec, held, tally,
                                      t1 - t0, t2 - t1, t3 - t2, t4 - t3, t5 - t4)
        graphs._mark_done(caller)
        return result

    @staticmethod
    def _static_args(args, inputs):
        """``args`` with the copied tensors replaced by ``inputs``."""
        it = iter(inputs)
        return [args[0], *(unflatten(flatten(arg, []), it) for arg in args[1:])]
