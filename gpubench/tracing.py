"""The traced run's profiled stretch, and its reduction to device times.

After the window a traced run serves the mix's ``stretch`` requests (whole
groups) under ``torch.profiler``, inside one annotation whose span is the
stretch's window. The device's busy time is the union of the device
operations (kernels, copies, sets) inside that window. Every kernel name
falls into at most one family of ``families/*.json`` (a name that two
families claim is a fault of the families), or into "other".
"""

from __future__ import annotations

import bisect
import dataclasses
import pathlib
import re
import sys

STRETCH = "gpubench.stretch"
_KERNEL_RE = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


@dataclasses.dataclass
class Stretch:
    window_s: float
    busy_s: float
    kernel_s: dict          # kernel name -> device seconds
    family_s: dict          # family -> device seconds
    family_n: dict          # family -> kernels run
    groups: list            # the engine's groups inside the stretch
    gaps: dict              # host op at an idle gap -> idle seconds
    port_kernels_seen: int  # kernels the profiler saw whose name is the port's
    port_launches: int      # launches the port's LaunchCounters counted
    events: dict            # the profiler's events by kind

    def breakdown(self) -> dict:
        ops = sorted(self.kernel_s.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": [[n[:200], s] for n, s in gaps]}


def port_kernel_names() -> list[str]:
    """The names of the port's own CUDA kernels, read from its sources."""
    import stabletriton_tpu_torch

    csrc = pathlib.Path(stabletriton_tpu_torch.__file__).resolve().parent / "csrc"
    names = set()
    for path in sorted(csrc.glob("*.cu*")):
        names.update(_KERNEL_RE.findall(path.read_text()))
    names.discard("void")
    return sorted(names)


def launch_counters() -> list:
    """Every LaunchCounter of the port's kernel wrappers that is loaded."""
    from stabletriton_tpu_torch.kernels.build import LaunchCounter

    out = []
    for name, mod in list(sys.modules.items()):
        if name.startswith("stabletriton_tpu_torch.kernels."):
            out.extend(v for v in vars(mod).values() if isinstance(v, LaunchCounter))
    return list({id(c): c for c in out}.values())


def classify(names, families: dict[str, dict]) -> dict[str, str]:
    """{kernel name: its family, or "other"}; a name two families claim
    raises."""
    from gpubench.harness import HarnessFault

    pats = {f: [re.compile(p) for p in spec["patterns"]] for f, spec in families.items()}
    out = {}
    for n in names:
        hits = [f for f, ps in pats.items() if any(p.search(n) for p in ps)]
        if len(hits) > 1:
            raise HarnessFault(f"kernel {n!r} falls into families {hits}")
        out[n] = hits[0] if hits else "other"
    return out


def _kind(e) -> str:
    """"device" (a kernel, copy or set on the card), "annotation" (a user
    annotation), or "host"."""
    try:
        act = str(e.activity_type()).lower()
    except AttributeError:  # older profilers: judge by the device and the name
        act = ""
    if "annotation" in act or e.name() == STRETCH:
        return "annotation" if "gpu" not in act else "device_annotation"
    if "cuda" in str(e.device_type()).lower() and not e.name().startswith(("cuda", "cu")):
        return "device"
    return "host"


def _is_kernel(name: str) -> bool:
    return not name.startswith(("Memcpy", "Memset"))


def _union(intervals, lo, hi):
    """The merged intervals of ``intervals`` clipped to [lo, hi]."""
    merged = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _host_op(cpu, starts, t):
    """The innermost host event running at time ``t``, or None."""
    best = None
    i = bisect.bisect_right(starts, t)
    for k in range(i - 1, max(i - 4000, -1), -1):
        s, e, name = cpu[k]
        if e >= t and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return best[2] if best else None


def reduce_events(events, families: dict, port_names: list[str]) -> dict:
    """Window, busy time, per-kernel and per-family device time and the idle
    gaps by host op, from the profiler's events (ns)."""
    window = None
    device, cpu = [], []
    kinds: dict[str, int] = {}
    for e in events:
        name = e.name()
        start, dur = e.start_ns(), e.duration_ns()
        kind = _kind(e)
        kinds[kind] = kinds.get(kind, 0) + 1
        if name == STRETCH and kind == "annotation":
            window = (start, start + dur)
        elif kind == "device":
            device.append((start, start + dur, name, _is_kernel(name)))
        elif kind == "host":
            cpu.append((start, start + dur, name))
    if window is None:
        raise RuntimeError("the profiler recorded no stretch annotation")
    lo, hi = window
    inside = [d for d in device if d[1] > lo and d[0] < hi]
    busy = _union([(s, e) for s, e, _, _ in inside], lo, hi)
    kernel_ns: dict[str, int] = {}
    for s, e, name, _ in inside:
        kernel_ns[name] = kernel_ns.get(name, 0) + (min(e, hi) - max(s, lo))
    fam_of = classify([n for s, e, n, k in inside if k], families)
    family_ns: dict[str, int] = {}
    family_n: dict[str, int] = {}
    for s, e, name, is_kernel in inside:
        if not is_kernel:
            continue
        f = fam_of[name]
        family_ns[f] = family_ns.get(f, 0) + (min(e, hi) - max(s, lo))
        family_n[f] = family_n.get(f, 0) + 1
    cpu.sort()
    starts = [c[0] for c in cpu]
    gaps: dict[str, float] = {}
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b - a <= 0:
            continue
        label = _host_op(cpu, starts, (a + b) / 2) or "no host op"
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e9
    seen = sum(1 for s, e, n, k in inside if k and any(p in n for p in port_names))
    return {"window_s": (hi - lo) / 1e9, "busy_s": sum(e - s for s, e in busy) / 1e9,
            "kernel_s": {k: v / 1e9 for k, v in kernel_ns.items()},
            "family_s": {k: v / 1e9 for k, v in family_ns.items()},
            "family_n": family_n, "gaps": gaps, "port_kernels_seen": seen, "events": kinds}


def profile_stretch(run, engine, group_log, on_card: bool, log=print) -> Stretch:
    """Serves the stretch under the profiler and reduces its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from gpubench.harness import serve

    spec, mix = run.spec, run.spec.mix
    counters = launch_counters()
    before = sum(c.count for c in counters)
    n0 = len(group_log.groups)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        with record_function(STRETCH):
            serve(engine, run.cfg, mix, run.seed, 0.0, first_index=1 << 31, total=mix.stretch,
                  outstanding=None if mix.loop == "open" else min(mix.outstanding, mix.stretch))
            if on_card:
                torch.cuda.synchronize()
    launches = sum(c.count for c in counters) - before
    events = prof.profiler.kineto_results.events()
    r = reduce_events(events, spec.families(), port_kernel_names())
    st = Stretch(groups=group_log.groups[n0:], port_launches=launches, **r)
    log(f"profiler events by kind: {st.events}", file=sys.stderr)
    fam_of = classify([n for n in st.kernel_s if _is_kernel(n)], spec.families())
    fam_of.update({n: "copy" for n in st.kernel_s if not _is_kernel(n)})
    for n, sec in sorted(st.kernel_s.items(), key=lambda kv: -kv[1]):
        log(f"kernel {fam_of[n]} {sec:.6f} s {n[:160]}", file=sys.stderr)
    log(f"stretch: {len(st.groups)} groups, {st.window_s:.4f} s, device busy {st.busy_s:.4f} s; "
        f"families {sorted(st.family_s.items())}", file=sys.stderr)
    log(f"kernels: the profiler saw {st.port_kernels_seen} launches of the port's kernels; "
        f"its LaunchCounters counted {st.port_launches} wrapper launches in the stretch"
        + ("" if st.port_kernels_seen >= st.port_launches else
           f" -- {st.port_launches - st.port_kernels_seen} or more kernels lost by the profiler"),
        file=sys.stderr)
    return st
