"""engine_idle: over the requests the window completed, the mean share of a
request's ``serve.request`` span (submit to its result) that no device
interval of its group covers (the group's conditioning, loop, decode and
hand-back copy, each from its first to its last work on the card): the
time the request waited on the host, in the queue, the batching window,
tokenizing, launching and handing back."""

from gpubench import spans


def covered_ns(intervals, lo: int, hi: int) -> int:
    """The time the union of ``intervals`` covers inside [lo, hi]."""
    total, reach = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, hi)
        if e > s:
            total += e - s
            reach = e
    return total


def read(run, name):
    got = spans.window(run)
    if not got:
        return None
    timed = [s for s in got if s.device is not None]
    shares = []
    for r in spans.named(got, "serve.request"):
        rid = r.requests[0]
        ivs = [s.device for s in timed if rid in s.requests]
        dur = r.end_ns - r.start_ns
        if ivs and dur > 0:
            shares.append(1.0 - covered_ns(ivs, r.start_ns, r.end_ns) / dur)
    return 100.0 * sum(shares) / len(shares) if shares else None
