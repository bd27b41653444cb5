"""The one traffic generator and its clients.

A mix is a JSON file under ``traffic/``: its parameters, read here and
nowhere else. Keys:

  loop         "closed": a request is sent only when one in flight
               completed; "open": requests arrive on a schedule drawn from
               the seed, whatever is in flight
  outstanding  closed: the requests the client keeps in flight
  rate_per_s   open: the mean number of requests arriving a second
  burst        open, optional: [least, most] requests arriving together
               (default [1, 1]); the rate counts requests, not bursts
  warm         optional: the group sizes set-up serves once each, for every
               signature (default: the closed loop's group; an open mix names
               every bucket of the engine it can reach)
  words        [least, most] words a prompt has, drawn uniformly
  signatures   optional: a list of request fields that differ from the
               configuration's (height, width, steps, guidance_scale), one
               dict a signature, taken in turn in an order drawn from the
               seed (default: one signature, the configuration's)
  stretch      requests in a traced run's profiled stretch (whole groups)
  generator    optional: the name of a module ``traffic/<generator>.py``
               whose ``request_params(seed, index, mix)`` replaces this
               module's (for requests that parameters cannot describe)

A request's prompt, seed and signature depend only on the run's seed and the
request's index, and an open mix's arrivals only on the run's seed, so a
seed repeats its traffic exactly and the traffic of two seeds differs. Each
block of requests (and of arrival gaps) holds the same set of signatures
(and gaps) for every seed, in another order, so every seed gives the same
work. Every request's negative prompt is the empty one.
"""

from __future__ import annotations

import dataclasses
import pathlib
import queue
import time

import numpy as np

# the prompts' vocabulary: words of image prompts
WORDS = tuple("""
a an the of in on at with under over beside behind portrait photo painting
sketch render illustration landscape city street harbor forest desert mountain
river lake ocean island castle tower bridge garden market station library
kitchen studio cathedral temple village valley canyon glacier volcano meadow
cat dog horse fox owl raven whale dragon robot astronaut knight wizard child
woman man old young smiling quiet lonely crowded ancient futuristic ruined
golden silver red blue green violet amber crimson pale dark bright misty foggy
rainy snowy sunny stormy night dawn dusk noon winter spring summer autumn
oil watercolor charcoal pastel ink digital cinematic dramatic soft hard rim
volumetric lighting shadows reflections bokeh detailed intricate minimal
wide angle close up aerial macro lens 35mm 85mm film grain sharp focus
highly realistic stylized baroque art nouveau cyberpunk steampunk gothic
impressionist surreal abstract geometric ornate rustic elegant cozy vast tiny
""".split())

# the request fields a signature may set (the reference follows each)
SIGNATURE_KEYS = ("height", "width", "steps", "guidance_scale")
# arrival gaps (and signatures) are drawn in blocks of this many, each block
# a permutation of the same set
BLOCK = 256
# the largest group: the harness builds its ServingEngine with this max_batch
MAX_GROUP = 8


@dataclasses.dataclass(frozen=True)
class Mix:
    name: str
    loop: str
    outstanding: int
    words: tuple[int, int]
    stretch: int
    rate_per_s: float = 0.0
    burst: tuple[int, int] = (1, 1)
    warm: tuple[int, ...] = ()
    signatures: tuple[dict, ...] = ({},)
    generator: str | None = None
    root: pathlib.Path | None = None

    @classmethod
    def from_file(cls, name: str, data: dict, root: pathlib.Path | None = None) -> "Mix":
        loop = data["loop"]
        lo, hi = data["words"]
        if not 1 <= lo <= hi:
            raise ValueError(f"mix {name}: bad words {data['words']}")
        sigs = tuple(data.get("signatures") or [{}])
        for s in sigs:
            if set(s) - set(SIGNATURE_KEYS):
                raise ValueError(f"mix {name}: a signature sets {sorted(set(s) - set(SIGNATURE_KEYS))};"
                                 f" only {SIGNATURE_KEYS} are followed by the reference")
        if loop == "closed":
            outstanding = int(data["outstanding"])
            if outstanding < 1:
                raise ValueError(f"mix {name}: outstanding {outstanding}")
            warm = tuple(data.get("warm") or [min(outstanding, MAX_GROUP)])
            extra = {}
        elif loop == "open":
            burst = tuple(int(b) for b in data.get("burst", (1, 1)))
            if float(data["rate_per_s"]) <= 0 or not 1 <= burst[0] <= burst[1] or "warm" not in data:
                raise ValueError(f"mix {name}: an open mix needs rate_per_s > 0, a good burst "
                                 "and the group sizes it warms")
            outstanding, warm = max(data["warm"]), tuple(data["warm"])
            extra = {"rate_per_s": float(data["rate_per_s"]), "burst": burst}
        else:
            raise ValueError(f"mix {name}: loop {loop!r} is neither closed nor open")
        return cls(name, loop, outstanding, (int(lo), int(hi)), int(data["stretch"]),
                   warm=tuple(int(w) for w in warm), signatures=sigs,
                   generator=data.get("generator"), root=root, **extra)

    def request_params(self, seed: int, index: int) -> tuple[str, int, dict]:
        """(prompt, image seed, signature fields) of request ``index``."""
        if self.generator:
            from gpubench.harness import load_module

            mod = load_module((self.root or pathlib.Path(__file__).parent / "traffic")
                              / f"{self.generator}.py")
            return mod.request_params(seed, index, self)
        return request_params(seed, index, self)

    def arrivals(self, seed: int):
        """An open mix's arrival times (seconds after the window opens), one
        per request, without end."""
        rng = np.random.default_rng([int(seed) % 2**64, 1 << 40])
        sizes = np.arange(BLOCK) % (self.burst[1] - self.burst[0] + 1) + self.burst[0]
        mean = float(np.mean(sizes))
        # the exponential's quantiles: the same gaps in every block and seed
        gaps = -np.log1p(-(np.arange(BLOCK) + 0.5) / BLOCK) * mean / self.rate_per_s
        t = 0.0
        while True:
            for gap, size in zip(rng.permutation(gaps), rng.permutation(sizes)):
                t += float(gap)
                for _ in range(int(size)):
                    yield t


def request_params(seed: int, index: int, mix: Mix) -> tuple[str, int, dict]:
    """(prompt, image seed, signature fields) of request ``index`` of a run
    with ``seed``."""
    rng = np.random.default_rng([int(seed) % 2**64, index])
    n = int(rng.integers(mix.words[0], mix.words[1] + 1))
    prompt = " ".join(WORDS[i] for i in rng.integers(0, len(WORDS), n))
    image_seed = int(rng.integers(0, 2**62))
    sig = mix.signatures[0]
    if len(mix.signatures) > 1:
        block, at = divmod(index, BLOCK)
        order = np.random.default_rng([int(seed) % 2**64, 1 << 41, block]).permutation(BLOCK)
        sig = mix.signatures[int(order[at]) % len(mix.signatures)]
    return prompt, image_seed, dict(sig)


@dataclasses.dataclass
class Record:
    """One request as the client saw it."""

    index: int
    prompt: str
    seed: int
    t_submit: float
    signature: dict = dataclasses.field(default_factory=dict)
    t_done: float | None = None
    image: np.ndarray | None = None
    error: str | None = None


class _Client:
    """Sends requests and collects their completions."""

    def __init__(self, submit, make_request):
        self.submit, self.make_request = submit, make_request
        self.done: "queue.Queue[Record]" = queue.Queue()
        self.records: list[Record] = []

    def send(self):
        prompt, seed, sig = self.make_request(len(self.records))
        rec = Record(len(self.records), prompt, seed, time.perf_counter(), sig)
        self.records.append(rec)
        fut = self.submit(rec)

        def finished(f, rec=rec):
            rec.t_done = time.perf_counter()
            try:
                rec.image = f.result()
            except Exception as e:  # the engine delivers a failure to the future
                rec.error = f"{type(e).__name__}: {e}"
            self.done.put(rec)

        fut.add_done_callback(finished)

    def wait_one(self, deadline: float) -> bool:
        try:
            self.done.get(timeout=max(deadline - time.perf_counter(), 0.001))
            return True
        except queue.Empty:
            return False


def closed_loop(submit, make_request, outstanding: int, seconds: float,
                total: int | None = None,
                settle_s: float = 600.0) -> tuple[list[Record], float, float]:
    """Runs a closed loop: ``outstanding`` requests in flight, each
    completion replaced by a new request until ``seconds`` have passed since
    the first was sent (with ``total``: until ``total`` were sent, whatever
    the time); then waits (at most ``settle_s``) for those still in
    flight. ``submit(record)`` sends one and returns its future;
    ``make_request(index)`` gives (prompt, seed, signature). Returns the
    records in sending order, the window's start and its end (perf_counter
    seconds). A record's t_done is when its future's result was set."""
    c = _Client(submit, make_request)
    t0 = time.perf_counter()
    t_end = t0 + seconds
    first = outstanding if total is None else min(outstanding, total)
    for _ in range(first):
        c.send()
    in_flight = first
    deadline = t_end + settle_s
    while in_flight and c.wait_one(deadline):
        in_flight -= 1
        more = (time.perf_counter() < t_end) if total is None else len(c.records) < total
        if more:
            c.send()
            in_flight += 1
    return c.records, t0, t_end


def open_loop(submit, make_request, arrivals, seconds: float, total: int | None = None,
              settle_s: float = 600.0) -> tuple[list[Record], float, float]:
    """Runs an open loop: request i is sent at ``arrivals``' i-th time after
    the window opens, whatever is in flight, for every arrival before
    ``seconds`` (with ``total``: the first ``total`` arrivals, whatever the
    time); then waits (at most ``settle_s``) for those in flight. Returns as
    :func:`closed_loop`."""
    c = _Client(submit, make_request)
    t0 = time.perf_counter()
    t_end = t0 + seconds
    for at in arrivals:
        if (total is None and at >= seconds) or (total is not None and len(c.records) >= total):
            break
        while time.perf_counter() < t0 + at:
            time.sleep(min(t0 + at - time.perf_counter(), 0.01))
        c.send()
    deadline = max(t_end, time.perf_counter()) + settle_s
    left = len(c.records)
    while left and c.wait_one(deadline):
        left -= 1
    return c.records, t0, t_end


def serve(submit, mix: Mix, seed: int, seconds: float, first_index: int = 0,
          total: int | None = None, outstanding: int | None = None):
    """The mix's client on ``submit``: its window, or ``total`` requests
    (a closed loop of ``outstanding`` where given, as set-up and the traced
    stretch serve whole groups)."""
    def make(i):
        return mix.request_params(seed, first_index + i)

    if mix.loop == "open" and outstanding is None:
        return open_loop(submit, make, mix.arrivals(seed), seconds, total=total)
    return closed_loop(submit, make, outstanding or mix.outstanding, seconds, total=total)


def signature_of(sig: dict, cfg: dict) -> dict:
    """A request's full signature: the configuration's, with the mix's
    fields over it."""
    out = {k: cfg[k] for k in SIGNATURE_KEYS}
    out.update(sig)
    return out

