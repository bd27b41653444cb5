"""Batched multi-prompt serving over an SDXLPipeline.

Counterpart of ``stabletriton_tpu/runtime/serving.py``, with the same
behaviour:

  * requests queue up; a worker thread groups them by signature
    (resolution, steps, guidance, solver, guidance interval, DeepCache) so
    one program, and on the card one replayed graph a bucket, serves the
    group;
  * a group's batch pads up to a bucket size (1/2/4/8);
  * per-request seeds ride along, so batching never changes a request's image.

The worker runs the pipeline under ``torch.inference_mode()``; grad mode is
thread-local, so nothing the caller's thread sets reaches the worker.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from concurrent.futures import Future

import numpy as np
import torch

from stabletriton_tpu_torch.runtime.denoise import norm_deep_cache, norm_guidance_interval

_BUCKETS = (1, 2, 4, 8)


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


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return _BUCKETS[-1]


class ServingEngine:
    """Dynamic-batching front end over an SDXLPipeline."""

    def __init__(self, pipeline, tok1, tok2, *, max_batch: int = _BUCKETS[-1],
                 max_wait_s: float = 0.05):
        if max_batch < _BUCKETS[0]:
            raise ValueError(f"max_batch={max_batch} is below the smallest bucket")
        self.pipeline = pipeline
        self.tok1, self.tok2 = tok1, tok2
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self._q: "queue.Queue[tuple[Request, Future] | None]" = queue.Queue()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    # -- client side --------------------------------------------------------
    def submit(self, request: Request) -> Future:
        fut: Future = Future()
        self._q.put((request, fut))
        return fut

    def generate(self, prompt: str, **kw) -> np.ndarray:
        return self.submit(Request(prompt=prompt, **kw)).result()

    def close(self):
        self._q.put(None)
        self._thread.join(timeout=30)

    # -- worker -------------------------------------------------------------
    def _drain_group(self, first):
        """Collect up to max_batch same-signature requests within the window."""
        group = [first]
        leftovers = []
        try:
            while len(group) < self.max_batch:
                item = self._q.get(timeout=self.max_wait_s)
                if item is None:
                    leftovers.append(None)
                    break
                if item[0].signature == first[0].signature:
                    group.append(item)
                else:
                    leftovers.append(item)
        except queue.Empty:
            pass
        for item in leftovers:
            self._q.put(item)
        return group

    def _run_group(self, reqs: list[Request]) -> np.ndarray:
        n = len(reqs)
        pad = _bucket(n) - n
        prompts = [r.prompt for r in reqs] + [""] * pad
        negatives = [r.negative for r in reqs] + [""] * pad
        seq1 = self.pipeline.clip_config.max_position_embeddings
        seq2 = self.pipeline.clip2_config.max_position_embeddings
        r0 = reqs[0]
        imgs = self.pipeline.txt2img(
            self.tok1.encode_batch(prompts, max_len=seq1),
            self.tok2.encode_batch(prompts, max_len=seq2, pad=0),
            neg_ids1=self.tok1.encode_batch(negatives, max_len=seq1),
            neg_ids2=self.tok2.encode_batch(negatives, max_len=seq2, pad=0),
            height=r0.height, width=r0.width, steps=r0.steps,
            guidance_scale=r0.guidance_scale, solver=r0.solver,
            guidance_interval=r0.guidance_interval, deep_cache=r0.deep_cache,
            seed=[r.seed for r in reqs] + [0] * pad,
        )
        return imgs.float().cpu().numpy()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            group = self._drain_group(item)
            futs = [f for _, f in group]
            try:
                with torch.inference_mode():
                    imgs = self._run_group([r for r, _ in group])
                for i, fut in enumerate(futs):
                    fut.set_result(imgs[i])
            except Exception as e:  # deliver the failure to every waiter
                for fut in futs:
                    if not fut.done():
                        fut.set_exception(e)
