"""The recorder of ``runtime/profiling.py``: the spans and counters of the
serving engine, the pipeline and the graph replay, and the benchmark's
readers of them (``gpubench/metrics/``).

On the CPU: three requests of two signatures served through
``ServingEngine`` on the tiny pipeline give the span tree (parents, the
requests' ids, each child inside its parent), the counters, and no device
interval; the ring keeps its bound; switched off, the recorder keeps
nothing; each reader reads hand-computed values off a synthetic recorder.

Marked ``gpu`` (they skip where torch sees no card): on the card the device
intervals come in order, no event is recorded while a graph captures, the
loop's interval agrees with CUDA events around the same call, and
``trace()`` around served requests holds the worker's ops and kernels and
the spans. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_spans.py -q
"""

import collections
import json

import numpy as np
import pytest
import torch

from gpubench import harness
from stabletriton_tpu_torch.runtime import graphs as tgraphs
from stabletriton_tpu_torch.runtime import pipeline as tpipe
from stabletriton_tpu_torch.runtime import profiling
from stabletriton_tpu_torch.runtime.serving import Request, ServingEngine
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SIZE = 32


class _Tok:
    def encode_batch(self, texts, *, max_len=16, pad=99, **kw):
        out = np.full((len(texts), max_len), pad, np.int32)
        for i, t in enumerate(texts):
            ids = [98] + [(ord(c) % 90) + 5 for c in t[: max_len - 2]] + [99]
            out[i, : len(ids)] = ids
        return out


@pytest.fixture
def fresh():
    """An empty recorder, on; left on."""
    profiling.set_recording(True)
    profiling.reset()
    yield
    profiling.set_recording(True)


def _serve(pipe, requests, **engine_kw):
    eng = ServingEngine(pipe, _Tok(), _Tok(), **engine_kw)
    try:
        futs = [eng.submit(r) for r in requests]
        return [f.result(timeout=300) for f in futs]
    finally:
        eng.close()


def _tree():
    spans = profiling.spans()
    return spans, {s.id: s for s in spans}


def _children(spans, parent):
    return [s for s in spans if s.parent == parent.id]


# --------------------------------------------------------------------------
# the engine's spans and counters on the CPU
# --------------------------------------------------------------------------


def test_three_requests_of_two_signatures(fresh):
    """A, B, C submitted at once, B of another signature, at most 2 a group:
    the worker takes A, defers B, takes C (the window ends full), then
    serves B alone (the window times out). Every request has its request
    and queue spans; each group its window, tokenize, call and hand-back,
    the call its build, conditioning, loop and decode; every span of a
    group carries its requests' ids and lies inside its parent; nothing on
    the CPU has a device interval."""
    pipe = tpipe.make_tiny_pipeline()
    kw = dict(height=SIZE, width=SIZE, guidance_scale=5.0)
    reqs = [Request(prompt="a", steps=2, seed=1, **kw), Request(prompt="b", steps=3, seed=2, **kw),
            Request(prompt="c", steps=2, seed=3, **kw)]
    imgs = _serve(pipe, reqs, max_batch=2, max_wait_s=0.5)
    assert [i.shape for i in imgs] == [(SIZE, SIZE, 3)] * 3
    spans, by_id = _tree()
    assert all(s.end_ns is not None and s.device is None for s in spans)

    requests = [s for s in spans if s.name == "serve.request"]
    assert len(requests) == 3 and all(s.parent is None for s in requests)
    ids = [s.requests[0] for s in requests]
    assert len(set(ids)) == 3 and all(len(s.requests) == 1 for s in requests)
    for r in requests:
        (q,) = _children(spans, r)
        assert q.name == "serve.queue" and q.requests == r.requests

    groups = [s for s in spans if s.name == "serve.group"]
    assert [g.requests for g in groups] == [(ids[0], ids[2]), (ids[1],)]
    assert [(g.attrs["rows"], g.attrs["bucket"]) for g in groups] == [(2, 2), (1, 1)]
    assert [g.attrs["signature"] for g in groups] == [reqs[0].signature, reqs[1].signature]
    for g, cause, deferred in zip(groups, ("full", "timeout"), (1, 0)):
        assert g.parent is None
        kids = _children(spans, g)
        assert [k.name for k in kids] == ["serve.window", "serve.tokenize", "pipeline.call",
                                          "serve.handback"]
        assert kids[0].attrs["cause"] == cause and kids[0].attrs["deferred"] == deferred
        call = kids[2]
        assert call.attrs["entry"] == "txt2img"
        assert [k.name for k in _children(spans, call)] == [
            "pipeline.build", "pipeline.conditioning", "pipeline.loop", "pipeline.decode"]
        loop = next(k for k in _children(spans, call) if k.name == "pipeline.loop")
        assert loop.attrs == {"rows": g.attrs["rows"], "steps": 3 if g is groups[1] else 2,
                              "lat_h": SIZE // 2, "lat_w": SIZE // 2, "guidance_scale": 5.0,
                              "prediction": "epsilon"}
        below = [s for s in spans if s.parent is not None and _root(s, by_id) is g]
        assert len(below) == 8 and all(s.requests == g.requests for s in below)
    # the request ends when its future has its result: inside the hand-back
    for r in requests:
        g = next(g for g in groups if r.requests[0] in g.requests)
        back = next(k for k in _children(spans, g) if k.name == "serve.handback")
        assert back.start_ns <= r.end_ns <= back.end_ns
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns, (s.name, p.name)

    assert profiling.counters() == {
        "serve.requests": 3, "serve.groups": 2, "serve.rows_real": 3, "serve.rows_padded": 0,
        "serve.window_exit.full": 1, "serve.window_exit.timeout": 1,
        "pipeline.calls": 2, "pipeline.builds": 2}


def _root(s, by_id):
    while s.parent is not None:
        s = by_id[s.parent]
    return s


def test_a_padded_group_and_a_window_ended_by_close(fresh):
    """Three requests of one signature pad to the bucket of 4; a request
    whose window the engine's close ends is served, and its window's cause
    is "close"."""
    pipe = tpipe.make_tiny_pipeline()
    kw = dict(height=SIZE, width=SIZE, steps=2)
    _serve(pipe, [Request(prompt=p, seed=i, **kw) for i, p in enumerate("abc")], max_wait_s=0.5)
    eng = ServingEngine(pipe, _Tok(), _Tok(), max_wait_s=30.0)
    fut = eng.submit(Request(prompt="d", **kw))
    eng.close()
    assert fut.result(timeout=60).shape == (SIZE, SIZE, 3)
    windows = [s for s in profiling.spans() if s.name == "serve.window"]
    assert [w.attrs["cause"] for w in windows] == ["timeout", "close"]
    assert windows[1].seconds < 30.0
    assert profiling.counters() == {
        "serve.requests": 4, "serve.groups": 2, "serve.rows_real": 4, "serve.rows_padded": 1,
        "serve.window_exit.timeout": 1, "serve.window_exit.close": 1,
        "pipeline.calls": 2, "pipeline.builds": 2}


def test_pipeline_call_outside_the_engine(fresh):
    """A pipeline called directly: its call is a root with no requests, its
    spans its children; a second call of the signature builds nothing.
    Nothing is captured on the CPU."""
    pipe = tpipe.make_tiny_pipeline()
    ids = _Tok().encode_batch(["x"])
    for _ in range(2):
        pipe.txt2img(ids, ids, height=SIZE, width=SIZE, steps=2)
    spans, _ = _tree()
    calls = [s for s in spans if s.name == "pipeline.call"]
    assert len(calls) == 2 and all(c.parent is None and c.requests == () for c in calls)
    assert [k.name for k in _children(spans, calls[1])] == [
        "pipeline.conditioning", "pipeline.loop", "pipeline.decode"]
    assert profiling.counters() == {"pipeline.calls": 2, "pipeline.builds": 1}


def test_the_ring_keeps_the_last_spans(fresh, monkeypatch):
    """The ring holds RING spans (64k); past it the oldest go first."""
    assert profiling.RING == 65536
    monkeypatch.setattr(profiling, "_ring", collections.deque(maxlen=8))
    for i in range(20):
        with profiling.span("s", i=i):
            pass
    assert [s.attrs["i"] for s in profiling.spans()] == list(range(12, 20))


def test_nested_and_explicit_spans(fresh):
    """A span opened inside a with-block is its child and takes its
    requests; an explicit span takes its parent's; finish is idempotent;
    a span times itself even when the recorder is off, and then nothing is
    kept."""
    with profiling.span("outer") as outer:
        outer.requests = (7,)
        with profiling.span("inner", k=1) as inner:
            explicit = profiling.start("explicit")
        profiling.finish(explicit)
        end = explicit.end_ns
        profiling.finish(explicit)
    assert explicit.end_ns == end
    assert (inner.parent, inner.requests, inner.attrs) == (outer.id, (7,), {"k": 1})
    assert (explicit.parent, explicit.requests) == (inner.id, (7,))
    assert [s.name for s in profiling.spans()] == ["outer", "inner", "explicit"]
    profiling.set_recording(False)
    profiling.count("c")
    with profiling.span("off") as off:
        pass
    assert off.seconds >= 0 and off.end_ns is not None
    assert [s.name for s in profiling.spans()] == ["outer", "inner", "explicit"]
    assert profiling.counters() == {}
    profiling.reset()
    assert profiling.spans() == []


# --------------------------------------------------------------------------
# the readers, on a synthetic recorder
# --------------------------------------------------------------------------

MS = 1_000_000  # ns


def _span(i, name, start_ms, end_ms, requests=(), device=None, parent=None, **attrs):
    return profiling.Span(i, name, parent, tuple(requests), 1, start_ms * MS, end_ms * MS,
                          attrs, None if device is None else (device[0] * MS, device[1] * MS))


def _synthetic(monkeypatch, spans, cell="sdxl-base-1.0.interactive"):
    """A run of ``cell`` whose window is 1000-2000 ms, and a recorder that
    holds ``spans``."""
    monkeypatch.setattr(profiling, "spans", lambda: list(spans), raising=False)
    run = harness.Run(harness.load_cell(cell), 0, 1.0, "NVIDIA H100 80GB HBM3")
    run.t0, run.t_end = 1.0, 2.0
    return run


def _read(run, name):
    return run.spec.reader(name).read(run, name)


def _recorded():
    """Two served requests inside the window, and spans outside it."""
    return [
        _span(1, "serve.window", 900, 950),                      # before the window
        _span(2, "serve.request", 1000, 1100, [1]),
        _span(3, "serve.window", 1001, 1051, [1]),
        _span(4, "pipeline.conditioning", 1052, 1060, [1], device=(1052, 1062)),
        _span(5, "pipeline.loop", 1060, 1061, [1], device=(1062, 1082), rows=1, steps=30,
              lat_h=128, lat_w=128, guidance_scale=5.0),
        _span(6, "pipeline.decode", 1061, 1070, [1], device=(1082, 1090), rows=1),
        _span(7, "serve.handback", 1090, 1099, [1], device=(1090, 1092)),
        _span(8, "serve.request", 1200, 1400, [2]),
        _span(9, "serve.window", 1201, 1254, [2]),
        _span(10, "pipeline.conditioning", 1255, 1260, [2], device=(1255, 1269)),
        _span(11, "pipeline.loop", 1260, 1262, [2], device=(1270, 1330), rows=1, steps=30,
              lat_h=128, lat_w=128, guidance_scale=5.0),
        _span(12, "pipeline.decode", 1262, 1270, [2], device=(1330, 1346), rows=2),
        _span(13, "serve.request", 1950, 2050, [3]),             # ends after the window
        _span(14, "serve.window", 1951, 2001, [3]),
    ]


def test_serve_window_and_pipeline_readers(monkeypatch):
    run = _synthetic(monkeypatch, _recorded())
    assert _read(run, "serve_window_ms.interactive") == pytest.approx((50 + 53) / 2)
    assert _read(run, "conditioning_ms.interactive") == pytest.approx((10 + 14) / 2)
    # 8 ms for one image, 16 ms for two
    assert _read(run, "decode_ms.interactive") == pytest.approx((8 + 16) / 3)


def test_engine_idle_reader(monkeypatch):
    """Request 1: 100 ms, its group's device intervals cover 1052-1092 ms
    (40 ms): 60% idle; request 2: 200 ms, 1255-1269 and 1270-1346 (90 ms):
    55% idle."""
    run = _synthetic(monkeypatch, _recorded())
    assert _read(run, "engine_idle.interactive") == pytest.approx((60 + 55) / 2)


def test_unet_loop_mfu_reader(monkeypatch):
    """Two loops of one real image under CFG (UNet batch 2), 30 steps at
    128x128 latents, over 20 + 60 ms of device time, against 989 TFLOP/s."""
    run = _synthetic(monkeypatch, _recorded())
    work = run.spec.work()
    flops = 2 * 30 * work.evaluation_flops(run.cfg["unet"], 2, 128, 128)
    want = 100 * flops / 0.080 / 989e12
    assert _read(run, "unet_loop_mfu.interactive") == pytest.approx(want)
    # a loop served outside the engine counts its rows; no CFG at scale 1
    loop = _span(5, "pipeline.loop", 1060, 1061, (), device=(1062, 1082), rows=3, steps=4,
                 lat_h=64, lat_w=64, guidance_scale=1.0)
    run = _synthetic(monkeypatch, [_span(1, "x", 999, 999), loop], "sd-1.5.batch8")
    flops = 4 * work.evaluation_flops(run.cfg["unet"], 3, 64, 64)
    assert _read(run, "unet_loop_mfu.batch") == pytest.approx(100 * flops / 0.020 / 989e12)


@pytest.mark.parametrize("name", ["serve_window_ms.interactive", "engine_idle.interactive",
                                  "conditioning_ms.interactive", "decode_ms.interactive",
                                  "unet_loop_mfu.interactive"])
def test_readers_give_none_without_the_window(monkeypatch, name):
    """None where the ring no longer holds the window's first span, where
    the recorder holds nothing, where the port has no recorder, and (but
    the host-clock window) where no span has a device interval."""
    spans = _recorded()
    run = _synthetic(monkeypatch, spans[2:])
    assert _read(run, name) is None
    run = _synthetic(monkeypatch, [])
    assert _read(run, name) is None
    monkeypatch.delattr(profiling, "spans")
    assert _read(run, name) is None
    host = [_span(s.id, s.name, s.start_ns // MS, s.end_ns // MS, s.requests, None,
                  **s.attrs) for s in spans]
    run = _synthetic(monkeypatch, host)
    assert (_read(run, name) is None) == (name != "serve_window_ms.interactive")


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def card(fresh):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _card_pipeline(card):
    return tpipe.make_tiny_pipeline(params=None, device=card)


@pytest.mark.gpu
def test_device_intervals_in_order_and_none_during_capture(card, monkeypatch):
    """Two groups served, the first capturing its loop: no CUDA event is
    recorded while a stream captures; each group's conditioning, loop,
    decode and hand-back copy have device intervals, in that order, inside
    their group's host span (after its anchor)."""
    recorded = []
    real = torch.cuda.Event.record

    def record(self, stream=None):
        recorded.append(torch.cuda.is_current_stream_capturing())
        return real(self, stream)

    monkeypatch.setattr(torch.cuda.Event, "record", record)
    pipe = _card_pipeline(card)
    kw = dict(height=64, width=64, steps=4)
    for seed in (1, 2):
        _serve(pipe, [Request(prompt="a", seed=seed, **kw)], max_wait_s=0.01)
    assert recorded and not any(recorded)
    assert profiling.counters()["graphs.captures"] == 1
    assert profiling.counters()["graphs.replays"] == 1
    spans, by_id = _tree()
    groups = [s for s in spans if s.name == "serve.group"]
    assert len(groups) == 2
    order = ["pipeline.conditioning", "pipeline.loop", "pipeline.decode", "serve.handback"]
    for g in groups:
        timed = {s.name: s.device for s in spans if s.device is not None and _root(s, by_id) is g}
        assert sorted(timed) == sorted(order)
        ivs = [timed[n] for n in order]
        assert g.start_ns <= ivs[0][0]
        for (a0, a1), (b0, b1) in zip(ivs, ivs[1:]):
            assert a0 <= a1 <= b0 <= b1
        assert ivs[-1][1] <= g.end_ns


@pytest.mark.gpu
def test_loop_interval_agrees_with_cuda_events(card, monkeypatch):
    """The replayed loop's device interval is within 2% of CUDA events
    recorded around the same graphed call."""
    marks = []
    real = tgraphs.GraphedCallable.__call__

    def timed(self, *args, **kwargs):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = real(self, *args, **kwargs)
        e1.record()
        marks.append((e0, e1))
        return out

    monkeypatch.setattr(tgraphs.GraphedCallable, "__call__", timed)
    pipe = _card_pipeline(card)
    ids = _Tok().encode_batch(["a photo"])
    for _ in range(3):
        pipe.txt2img(ids, ids, height=128, width=128, steps=30)
    torch.cuda.synchronize()
    loops = [s for s in profiling.spans() if s.name == "pipeline.loop"]
    for loop, (e0, e1) in list(zip(loops, marks))[1:]:
        span_ms = (loop.device[1] - loop.device[0]) / 1e6
        event_ms = e0.elapsed_time(e1)
        assert span_ms == pytest.approx(event_ms, rel=0.02), (span_ms, event_ms)


@pytest.mark.gpu
def test_trace_holds_the_worker_kernels_and_spans(card, tmp_path):
    """trace() around requests served on the card writes one Chrome file
    with the worker thread's ops, the card's kernels and the spans (a
    profile that recorded no kernel, as one now and then does, is taken
    again, at most three times)."""
    pipe = _card_pipeline(card)
    eng = ServingEngine(pipe, _Tok(), _Tok(), max_wait_s=0.01)
    try:
        eng.generate("warm", height=64, width=64, steps=4)
        for _ in range(3):
            with profiling.trace(log_dir=str(tmp_path)) as path:
                eng.generate("traced", height=64, width=64, steps=4)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
            if any(e.get("cat") == "kernel" for e in events):
                break
        worker = eng._thread.native_id
    finally:
        eng.close()
    assert any(e.get("tid") == worker and e.get("name", "").startswith("aten::") for e in events)
    assert any(e.get("cat") == "kernel" for e in events)
    names = {e["name"] for e in events if e.get("cat") == "program_span"}
    assert {"serve.group", "pipeline.loop", "serve.handback"} <= names
    assert {e["name"] for e in events if e.get("cat") == "program_span_device"} >= {
        "pipeline.loop", "serve.handback"}
