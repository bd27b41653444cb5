"""Timing and tracing utilities, and the port's logger.

Counterpart of ``stabletriton_tpu/runtime/profiling.py``:

  * ``bench_fn``: steady-state seconds per call of a chained function. Each
    call's output is fed back into one positional argument, so the calls
    serialize. On the card the chain runs between a CUDA event pair on the
    current stream (the pair is the fence); on the CPU the JAX package's
    two-length ``perf_counter`` slope cancels the fixed overhead.
  * ``trace``: ``torch.profiler`` around a block, written as a Chrome trace.
  * ``logger``: the pipeline logs one INFO line per new program signature
    (the counterpart of JAX's one line per jitted signature).
"""

from __future__ import annotations

import contextlib
import logging
import os
import tempfile
import time
from typing import Callable

import torch

logger = logging.getLogger("stabletriton_tpu_torch")


def _first_tensor(tree) -> torch.Tensor | None:
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        for v in tree:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def bench_fn(
    fn: Callable,
    *args,
    chain_arg: int = 0,
    n_short: int = 4,
    n_long: int = 20,
    reps: int = 3,
    min_window: float = 0.030,
    **kwargs,
) -> float:
    """Steady-state seconds per call of ``fn(*args, **kwargs)``.

    Feeds each output back into positional argument ``chain_arg`` (its
    shape and dtype must match), so every call waits for the one before.
    Each chain length is timed ``reps`` times and the minimum kept, and the
    chain grows 4x at a time until its window reaches ``min_window``
    seconds (at most 5000 calls).

    The device follows the arguments (or, with no tensor among them, the
    output). On the card the chain of ``n_long`` calls runs between two
    CUDA events on the current stream after a warm-up, and the result is
    the window over the calls; ``n_short`` is not used there. On the CPU
    it is the slope between chains of ``n_short`` and ``n_long`` calls,
    each ended by reading one element, as in the JAX package.
    """
    args = list(args)
    out = fn(*args, **kwargs)
    first = _first_tensor(args)
    if first is None:
        first = _first_tensor(out)
    on_card = first is not None and first.device.type == "cuda"

    def run(n):
        a = list(args)
        o = out
        for _ in range(n):
            a[chain_arg] = o
            o = fn(*a, **kwargs)
        return o

    if on_card:
        stream = torch.cuda.current_stream(first.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def window(n):
            start.record(stream)
            run(n)
            end.record(stream)
            end.synchronize()
            return start.elapsed_time(end) / 1e3

        window(2)  # steady-state warm-up
        t = min(window(n_long) for _ in range(reps))
        while t < min_window and n_long < 5000:
            n_long *= 4
            t = min(window(n_long) for _ in range(reps))
        return max(t / n_long, 1e-9)

    def chain(n):
        t0 = time.perf_counter()
        o = _first_tensor(run(n))
        if o is not None:
            o.reshape(-1)[:1].tolist()
        return time.perf_counter() - t0

    chain(2)  # steady-state warm-up
    t_s = min(chain(n_short) for _ in range(reps))
    t_l = min(chain(n_long) for _ in range(reps))
    while t_l - t_s < min_window and n_long < 5000:
        n_long *= 4
        t_l = min(chain(n_long) for _ in range(reps))
    return max((t_l - t_s) / (n_long - n_short), 1e-9)


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` around the with-block (CPU activity, and CUDA
    where torch sees a card), written as a Chrome trace into ``log_dir``
    (default: ``stabletriton_trace`` under the temporary directory). Yields
    the trace file's path; the file is written, and its path logged, when
    the block ends."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "stabletriton_trace")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = profile(activities=activities)
    prof.start()
    try:
        yield path
        if cuda:
            torch.cuda.synchronize()
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        logger.info("profiler trace written to %s", path)
