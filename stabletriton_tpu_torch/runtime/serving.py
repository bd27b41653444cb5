"""Batched multi-prompt serving over an SDXLPipeline.

Counterpart of ``stabletriton_tpu/runtime/serving.py``, with the same
behaviour:

  * requests queue up; a worker thread groups them by signature
    (resolution, steps, guidance, solver, guidance interval, DeepCache) so
    one program, and on the card one replayed graph a bucket, serves the
    group;
  * a group's batch pads up to a bucket size (1/2/4/8);
  * per-request seeds ride along, so batching never changes a request's image;
  * over a mesh (``runtime/mesh.py``) the buckets are multiples of the data
    axis, and under SPMD only global rank 0 takes requests: it checks each
    group's call (``SDXLPipeline.check_txt2img``) and broadcasts its ids,
    seeds and settings, and every other rank's engine runs the same call on
    them (a follower loop), so the ranks' collectives meet. A call that
    fails anyway fails on every rank alike: the leader gives the error to
    the group's futures and a follower logs it, and both go on to the next.

The worker runs the pipeline under ``torch.inference_mode()``; grad mode is
thread-local, so nothing the caller's thread sets reaches the worker.

Each request gets an id at ``submit``. The engine records
(``runtime/profiling.py``) a ``serve.request`` span from submit to its
future's result, with ``serve.queue`` inside it until the worker takes the
request, and for each group a ``serve.group`` span, the anchor of its device
intervals, around
``serve.window`` (the wait for co-batchers, with the cause that ended it),
``serve.tokenize``, the pipeline's ``pipeline.call`` and ``serve.handback``
(the copy to the host, the device interval, and the futures' results); and
the counters ``serve.requests``, ``serve.groups``, ``serve.rows_real``,
``serve.rows_padded`` and ``serve.window_exit.<cause>``.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
from concurrent.futures import Future

import numpy as np
import torch
import torch.distributed as dist

from stabletriton_tpu_torch.runtime import mesh as mesh_mod
from stabletriton_tpu_torch.runtime import profiling
from stabletriton_tpu_torch.runtime.denoise import norm_deep_cache, norm_guidance_interval
from stabletriton_tpu_torch.runtime.profiling import logger

_BUCKETS = (1, 2, 4, 8)
_REQUEST_IDS = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class Request:
    prompt: str
    negative: str = ""
    height: int = 1024
    width: int = 1024
    steps: int = 30
    guidance_scale: float = 5.0
    solver: str = "euler"
    seed: int = 0
    # the draft knobs (see SDXLPipeline.txt2img), part of the batching
    # signature, since requests share a program only if they sample alike:
    # CFG only inside this sigma window; DeepCache's interval (and depth)
    guidance_interval: tuple[float, float] | None = None
    deep_cache: int | tuple[int, int] | None = None

    @property
    def signature(self):
        # the knobs normalised as the pipeline's program key holds them, so
        # deep_cache=2 and (2, 1) co-batch
        return (self.height, self.width, self.steps, float(self.guidance_scale), self.solver,
                norm_guidance_interval(self.guidance_interval, self.guidance_scale),
                norm_deep_cache(self.deep_cache))


@dataclasses.dataclass
class _Queued:
    """A submitted request in the engine: its future, its id and its spans."""

    request: Request
    future: Future
    id: int
    span: profiling.Span      # serve.request
    waiting: profiling.Span   # serve.queue


def _bucket(n: int, buckets=_BUCKETS) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


class ServingEngine:
    """Dynamic-batching front end over an SDXLPipeline. Over a mesh every
    rank makes one engine; rank 0's takes the requests (``submit``) and the
    others follow it until it closes."""

    def __init__(self, pipeline, tok1, tok2, *, max_batch: int = _BUCKETS[-1],
                 max_wait_s: float = 0.05):
        mesh = getattr(pipeline, "mesh", None)
        data = mesh_mod.axis_size(mesh, mesh_mod.DATA_AXIS)
        self._buckets = tuple(b * data for b in _BUCKETS)
        if max_batch < self._buckets[0]:
            # never exceed a caller's memory / latency cap: a sharded
            # pipeline runs no batch below the data axis
            raise ValueError(
                f"max_batch={max_batch} is below the smallest mesh-compatible "
                f"bucket {self._buckets[0]} (data axis {data}); raise "
                f"max_batch or use a smaller data axis")
        self.pipeline = pipeline
        self.tok1, self.tok2 = tok1, tok2
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._spmd = mesh is not None and dist.get_world_size() > 1
        self.leader = not self._spmd or dist.get_rank() == 0
        self._q: "queue.Queue[_Queued | None]" = queue.Queue()
        self._thread = threading.Thread(target=self._worker if self.leader else self._follow,
                                        daemon=True)
        self._thread.start()

    # -- client side --------------------------------------------------------
    def submit(self, request: Request) -> Future:
        if not self.leader:
            raise RuntimeError("only global rank 0's engine takes requests; the others "
                               "follow it")
        fut: Future = Future()
        rid = next(_REQUEST_IDS)
        req = profiling.start("serve.request", parent=None, requests=(rid,))
        profiling.count("serve.requests")
        self._q.put(_Queued(request, fut, rid, req, profiling.start("serve.queue", parent=req)))
        return fut

    def generate(self, prompt: str, **kw) -> np.ndarray:
        return self.submit(Request(prompt=prompt, **kw)).result()

    def close(self):
        """Stop the worker (rank 0 also stops the followers); a follower's
        close waits for rank 0's."""
        if self.leader:
            self._q.put(None)
        self._thread.join(timeout=None if self._spmd else 30)

    # -- worker -------------------------------------------------------------
    def _drain_group(self, first: _Queued) -> list[_Queued]:
        """Collect up to max_batch same-signature requests within the window;
        a request of another signature goes back to the queue."""
        group = [first]
        leftovers = []
        cause = "full"
        with profiling.span("serve.window") as window:
            try:
                while len(group) < self.max_batch:
                    item = self._q.get(timeout=self.max_wait_s)
                    if item is None:
                        leftovers.append(None)
                        cause = "close"
                        break
                    if item.request.signature == first.request.signature:
                        profiling.finish(item.waiting)
                        group.append(item)
                    else:
                        leftovers.append(item)
            except queue.Empty:
                cause = "timeout"
            window.requests = tuple(item.id for item in group)
            window.attrs.update(cause=cause,
                                deferred=sum(item is not None for item in leftovers))
        profiling.count(f"serve.window_exit.{cause}")
        for item in leftovers:
            self._q.put(item)
        return group

    def _run_group(self, reqs: list[Request]) -> torch.Tensor:
        """The group's images on the device (padded rows included)."""
        n = len(reqs)
        pad = _bucket(n, self._buckets) - n
        prompts = [r.prompt for r in reqs] + [""] * pad
        negatives = [r.negative for r in reqs] + [""] * pad
        c1, c2 = self.pipeline.clip_config, self.pipeline.clip2_config
        # each encoder pads with its own pad id (SD2.x's OpenCLIP-H and
        # SDXL's bigG: 0, "!"); one without keeps the tokenizer's default
        # (CLIP-L's EOS), as ``CLIPTextConfig.empty_prompt_ids`` does
        pad1, pad2 = ({} if c.pad_token_id is None else {"pad": c.pad_token_id}
                      for c in (c1, c2))
        seq1, seq2 = c1.max_position_embeddings, c2.max_position_embeddings
        r0 = reqs[0]
        with profiling.span("serve.tokenize"):
            ids = dict(ids1=self.tok1.encode_batch(prompts, max_len=seq1, **pad1),
                       ids2=self.tok2.encode_batch(prompts, max_len=seq2, **pad2),
                       neg_ids1=self.tok1.encode_batch(negatives, max_len=seq1, **pad1),
                       neg_ids2=self.tok2.encode_batch(negatives, max_len=seq2, **pad2))
        call = dict(
            **ids,
            height=r0.height, width=r0.width, steps=r0.steps,
            guidance_scale=r0.guidance_scale, solver=r0.solver,
            guidance_interval=r0.guidance_interval, deep_cache=r0.deep_cache,
            seed=[r.seed for r in reqs] + [0] * pad,
        )
        if self._spmd:
            # only a call the followers can run is broadcast
            self.pipeline.check_txt2img(height=r0.height, width=r0.width, solver=r0.solver,
                                        deep_cache=r0.deep_cache)
            dist.broadcast_object_list([call], src=0)
        return self.pipeline.txt2img(**call)

    def _follow(self):
        """A follower rank: run each call rank 0 broadcasts, until it
        broadcasts None (its close). A call that raises raised on rank 0
        too, which gave the error to its waiters: log it and follow on."""
        with torch.inference_mode():
            while True:
                box = [None]
                dist.broadcast_object_list(box, src=0)
                if box[0] is None:
                    return
                try:
                    self.pipeline.txt2img(**box[0])
                except Exception:
                    logger.exception("follower rank %d: a served call failed", dist.get_rank())

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                if self._spmd:
                    dist.broadcast_object_list([None], src=0)
                return
            profiling.finish(item.waiting)
            with profiling.span("serve.group", anchor=self.pipeline.device) as grp:
                group = self._drain_group(item)
                n = len(group)
                pad = _bucket(n, self._buckets) - n
                grp.requests = tuple(q.id for q in group)
                grp.attrs.update(rows=n, bucket=n + pad, signature=item.request.signature)
                profiling.count("serve.groups")
                profiling.count("serve.rows_real", n)
                profiling.count("serve.rows_padded", pad)
                try:
                    with torch.inference_mode():
                        imgs = self._run_group([q.request for q in group])
                    with profiling.span("serve.handback", device=True) as back:
                        imgs = imgs.float().cpu().numpy()
                        back.end_device()
                        for i, q in enumerate(group):
                            q.future.set_result(imgs[i])
                            profiling.finish(q.span)
                except Exception as e:  # deliver the failure to every waiter
                    for q in group:
                        if not q.future.done():
                            q.future.set_exception(e)
                        profiling.finish(q.span)
