"""Timing and tracing utilities, and the port's logger.

Counterpart of ``stabletriton_tpu/runtime/profiling.py``:

  * ``bench_fn``: steady-state seconds per call of a chained function. Each
    call's output is fed back into one positional argument, so the calls
    serialize. On the card the chain runs between a CUDA event pair on the
    current stream (the pair is the fence); on the CPU the JAX package's
    two-length ``perf_counter`` slope cancels the fixed overhead.
  * ``trace``: ``torch.profiler`` around a block, on every thread, written
    as a Chrome trace with the recorder's spans merged in.
  * ``logger``: the pipeline logs one INFO line per new program signature
    (the counterpart of JAX's one line per jitted signature).
  * the recorder: spans and counters at the boundaries of the serving
    engine, the pipeline and the graph replay, kept in memory (a ring of
    ``RING`` spans) and read with ``spans()`` / ``counters()``. A span's
    host times are ``time.perf_counter_ns()``. A span that enqueues work on
    the card also gets that work's device interval on the same clock: CUDA
    events on the current stream at its opening and closing, measured from
    an anchor event recorded, with a host timestamp, when its group opened
    on an idle stream; they are resolved when read, never on the hot path.
    On by default; ``set_recording(False)`` turns it off.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import logging
import os
import tempfile
import threading
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


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

RING = 65536  # spans kept: the last few thousand groups


class _Anchor:
    """A group's zero on the card: a host timestamp, then an event recorded
    on the current stream, the stream its spans' events go on. The spans
    measured from it hold it until their intervals are resolved."""

    __slots__ = ("host_ns", "event", "stream")

    def __init__(self, host_ns, stream):
        self.host_ns, self.stream, self.event = host_ns, stream, None


@dataclasses.dataclass(eq=False, slots=True)
class Span:
    """One timed piece of the program's work. ``start_ns`` / ``end_ns`` are
    host ``time.perf_counter_ns()``; ``end_ns`` is None while it is open.
    ``parent`` is the id of the span it ran inside, ``requests`` the ids the
    serving engine gave the requests it serves, ``thread`` the native id of
    the thread that opened it. ``device`` is (start, end) on the same clock
    of the work it enqueued on the card, or None (on the CPU, while it is
    open, or for a span that enqueues nothing). Used as a context manager
    (:func:`span`), it is the parent of the spans its thread opens inside
    the block, and closes at its end."""

    id: int
    name: str
    parent: int | None
    requests: tuple
    thread: int
    start_ns: int
    end_ns: int | None = None
    attrs: dict = dataclasses.field(default_factory=dict)
    device: tuple[int, int] | None = None
    _anchor: _Anchor | None = dataclasses.field(default=None, repr=False)
    _events: list | None = dataclasses.field(default=None, repr=False)

    @property
    def seconds(self) -> float:
        """Host seconds from opening to closing (to now while open)."""
        end = time.perf_counter_ns() if self.end_ns is None else self.end_ns
        return (end - self.start_ns) / 1e9

    def end_device(self) -> None:
        """Close the device interval here, before the span itself closes
        (for host work after the last device work, such as handing back)."""
        if self._events is not None and len(self._events) == 1:
            self._events.append(_record(self._anchor))

    def __enter__(self) -> "Span":
        _stack().append(self)
        return self

    def __exit__(self, *exc) -> None:
        _stack().pop()
        finish(self)


_state = threading.local()
_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=RING)
_counters: dict[str, int] = {}
_pending: list[Span] = []   # closed spans whose device interval is unresolved
_pool: list = []            # free CUDA timing events
_ids = itertools.count(1)
_on = True


def set_recording(on: bool) -> None:
    """Turn the recorder on (the default) or off. Off, no span or counter is
    kept and no event is recorded; spans still time themselves for their
    caller (``Captured``'s timers)."""
    global _on
    _on = bool(on)


def reset() -> None:
    """Forget every span and counter."""
    spans()
    with _lock:
        _ring.clear()
        _counters.clear()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    if _on:
        with _lock:
            _counters[name] = _counters.get(name, 0) + n


def counters() -> dict[str, int]:
    with _lock:
        return dict(_counters)


def spans() -> list[Span]:
    """The spans in the ring, oldest first, each device interval resolved
    (this waits for the events of the spans already closed)."""
    for s in _take_pending():
        _resolve(s, wait=True)
    with _lock:
        return list(_ring)


def _stack() -> list[Span]:
    try:
        return _state.stack
    except AttributeError:
        _state.stack = []
        return _state.stack


def _record(anchor: _Anchor):
    """A pool event recorded on the anchor's stream, or None while the
    current stream is capturing a graph."""
    if torch.cuda.is_current_stream_capturing():
        return None
    with _lock:
        ev = _pool.pop() if _pool else None
    if ev is None:
        ev = torch.cuda.Event(enable_timing=True)
    ev.record(anchor.stream)
    return ev


def _resolve(s: Span, wait: bool) -> bool:
    """Turn a closed span's events into its device interval and give them
    back to the pool; False where they have not completed (and ``wait`` is
    off)."""
    a, evs = s._anchor, s._events
    if len(evs) == 2 and None not in evs:
        if wait:
            evs[1].synchronize()
        elif not evs[1].query():
            return False
        s.device = tuple(a.host_ns + round(a.event.elapsed_time(ev) * 1e6) for ev in evs)
    with _lock:
        _pool.extend(ev for ev in evs if ev is not None)
    s._events = s._anchor = None
    return True


def _take_pending() -> list[Span]:
    """The unresolved spans, taken from the list: one thread resolves each."""
    with _lock:
        todo = _pending[:]
        _pending.clear()
    return todo


def _collect() -> None:
    """Resolve the device intervals whose events have completed (at a new
    group's opening: the last group ended in a synchronising copy), so that
    their events return to the pool."""
    left = [s for s in _take_pending() if not _resolve(s, wait=False)]
    if left:
        with _lock:
            _pending.extend(left)


def start(name: str, *, parent: Span | None = None, requests: tuple | None = None,
          device: bool = False, anchor=None, **attrs) -> Span:
    """Open a span (closed by :func:`finish`, on any thread). Its parent is
    ``parent``, else the innermost span this thread has open in a ``with
    span(...)``; its requests are ``requests``, else its parent's. With
    ``anchor`` a CUDA device and no anchor above it, it anchors its
    subtree's device intervals on that device's current stream; with
    ``device`` it records its own."""
    if parent is None:
        st = _stack()
        parent = st[-1] if st else None
    if requests is None:
        requests = parent.requests if parent is not None else ()
    s = Span(next(_ids), name, None if parent is None else parent.id, requests,
             threading.get_native_id(), 0, None, attrs)
    if _on:
        a = None if parent is None else parent._anchor
        if a is None and anchor is not None and anchor.type == "cuda":
            _collect()
            stream = torch.cuda.current_stream(anchor)
            a = _Anchor(time.perf_counter_ns(), stream)
            a.event = _record(a)
            if a.event is None:
                a = None
        s._anchor = a
        if device and a is not None:
            s._events = [_record(a)]
        with _lock:
            _ring.append(s)
    s.start_ns = time.perf_counter_ns()
    return s


def finish(s: Span) -> None:
    """Close a span opened by :func:`start` (a second call does nothing)."""
    if s.end_ns is not None:
        return
    s.end_ns = time.perf_counter_ns()
    if s._events is not None:
        s.end_device()
        with _lock:
            _pending.append(s)
    else:
        s._anchor = None


def span(name: str, *, device: bool = False, anchor=None, **attrs) -> Span:
    """A span for a with-block (:func:`start`'s arguments): the parent of
    the spans this thread opens inside it, closed at its end."""
    return start(name, device=device, anchor=anchor, **attrs)


def _chrome_events(lo_ns: int, hi_ns: int, to_us) -> list[dict]:
    """The spans that overlap [lo_ns, hi_ns] as Chrome trace events: each
    on its thread's row, its device interval on a row of its own."""
    pid = os.getpid()
    out = [{"ph": "M", "name": "thread_name", "pid": pid, "tid": 0,
            "args": {"name": "program spans: device intervals"}}]
    for s in spans():
        if s.end_ns is None or s.end_ns < lo_ns or s.start_ns > hi_ns:
            continue
        args = {"id": s.id, "parent": s.parent, "requests": list(s.requests),
                **{k: v if isinstance(v, (int, float, str, bool)) else repr(v)
                   for k, v in s.attrs.items()}}
        out.append({"ph": "X", "cat": "program_span", "name": s.name, "pid": pid,
                    "tid": s.thread, "ts": to_us(s.start_ns),
                    "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
        if s.device is not None:
            out.append({"ph": "X", "cat": "program_span_device", "name": s.name, "pid": pid,
                        "tid": 0, "ts": to_us(s.device[0]),
                        "dur": (s.device[1] - s.device[0]) / 1e3, "args": args})
    return out


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """``torch.profiler`` around the with-block (CPU activity on every
    thread, where the installed torch can profile all threads, and CUDA
    where torch sees a card), written as a Chrome trace into ``log_dir``
    (default: ``stabletriton_trace`` under the temporary directory), with
    the recorder's spans that overlap the block merged in on the
    profiler's clock. Yields the trace file's path; the file is written,
    and its path logged, when the block ends."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = os.path.join(tempfile.gettempdir(), "stabletriton_trace")
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    kw = {}
    try:  # the serving worker's ops are on another thread than the caller's
        from torch._C._profiler import _ExperimentalConfig

        kw["experimental_config"] = _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        pass
    prof = profile(activities=activities, **kw)
    # the profiler's timestamps are on the wall clock, the spans' on perf_counter
    offset_ns = time.time_ns() - time.perf_counter_ns()
    lo_ns = time.perf_counter_ns()
    prof.start()
    try:
        yield path
        if cuda:
            torch.cuda.synchronize()
    finally:
        prof.stop()
        hi_ns = time.perf_counter_ns()
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
        base_ns = int(doc.get("baseTimeNanoseconds", 0))
        doc["traceEvents"].extend(_chrome_events(
            lo_ns, hi_ns, lambda t: (t + offset_ns - base_ns) / 1e3))
        with open(path, "w") as f:
            json.dump(doc, f)
        logger.info("profiler trace written to %s", path)
