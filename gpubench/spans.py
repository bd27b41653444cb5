"""The program's own spans for the per-layer readers: the port's recorder
(``stabletriton_tpu_torch/runtime/profiling.py``) read after the run, its
spans clipped to the window.

A checkout whose port has no recorder gives nothing, and neither does a
ring that no longer holds the window's first span: the readers then
return None.
"""

from __future__ import annotations


def window(run) -> list | None:
    """The spans that opened and closed inside the window (``run.t0`` to
    ``run.t_end``), or None."""
    try:
        from stabletriton_tpu_torch.runtime import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    spans = read()
    lo, hi = round(run.t0 * 1e9), round(run.t_end * 1e9)
    if not spans or spans[0].start_ns > lo:
        return None
    return [s for s in spans if s.start_ns >= lo and s.end_ns is not None and s.end_ns <= hi]


def named(spans: list, name: str) -> list:
    return [s for s in spans if s.name == name]


def device_s(s) -> float:
    """A span's device interval in seconds."""
    return (s.device[1] - s.device[0]) / 1e9

