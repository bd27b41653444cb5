"""Readings that set a cell's limits: the output check's numbers for the
system under test and for its control, seed by seed, in one process.

    python3 gpubench/calibrate.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

For each seed the run's weights are made, the system is built under the
configuration's binding, warmed as a run warms, and then serves the
requests a run would compare (one full group for a batched mix, the
sample's count of requests one after another for a mix of one client), on
the timed path (replays). The control is the program with its own path one
precision below the configuration's switched on (the configuration's
``control``: CompileConfig fields, the port's int8 turbo path), on the same
weights and requests. Each is compared with the reference as a run compares
(its sample, its numbers, the worst over the sample) and held to the
configuration's limits (``harness.sample_numbers``, with the float32
reference where the limits ask for it). Prints one JSON line a seed, and
the extremes at the end: the system's largest reading (the lower end of a
limit) and the control's smallest (the upper end).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def served(spec, params, seed, device, compile_fields=None):
    """The records of the requests a run would compare, served on replays."""
    import torch

    from gpubench import harness

    pipe, engine = harness.build_system(spec.config, params, device, **(compile_fields or {}))
    log = harness.GroupLog(pipe, sync=False)
    bucket = min(spec.mix.outstanding, engine.max_batch)
    t0 = time.perf_counter()
    harness.warm_up(engine, spec.config, spec.mix, seed)
    t1 = time.perf_counter()
    n = bucket if bucket > 1 else int(spec.config["check"]["sample"])
    log.groups.clear()
    recs, _, _ = harness.serve(engine, spec.config, spec.mix, seed, 0.0, total=n,
                               outstanding=bucket)
    t2 = time.perf_counter()
    engine.close()
    groups = list(log.groups)
    del engine, pipe, log
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return recs, groups, (t1 - t0, t2 - t1)


def readings(name: str, seed: int, control: bool, device: str = "cuda",
             root: pathlib.Path | None = None) -> dict:
    """One seed's readings: the system's and, with ``control``, the
    control's (the program with the configuration's ``control`` fields), each
    with its verdict against the configuration's limits."""
    import torch

    from gpubench import harness, weights

    spec = harness.load_cell(name, root or harness.BENCH_DIR)
    cfg = spec.config
    params = weights.make(spec.reference().param_shapes(cfg), cfg["dtypes"], seed, device)
    recs, groups, times = served(spec, params, seed, device)
    run = harness.Run(spec, seed, 0.0, "", records=recs, groups=groups)
    sample = harness.sample_requests(run, [r for r in recs if r.image is not None],
                                     int(cfg["check"]["sample"]))
    out = {"cell": name, "seed": seed, "sample": [r.index for r in sample],
           "warm_s": times[0], "served_s": times[1]}
    ctl_recs = None
    if control:
        crecs, _, ctimes = served(spec, params, seed, device, cfg["control"]["compile"])
        ctl_recs = {r.index: r for r in crecs}
        out["control_served_s"] = ctimes[1]
    t = time.perf_counter()
    refs = harness.reference_images(spec, params, sample, device)
    out["reference_s"] = time.perf_counter() - t
    refs32 = None
    if harness.float32_references(spec):
        t = time.perf_counter()
        refs32 = harness.reference_images(spec, params, sample, device, torch.float32)
        out["reference_f32_s"] = time.perf_counter() - t
    limits = cfg["check"]["limits"]
    kinds = {"system": {r.index: r for r in recs}, "control": ctl_recs}
    for kind, by_index in kinds.items():
        if by_index is None:
            continue
        got = harness.sample_numbers([by_index[r.index].image for r in sample], refs, refs32)
        out[kind] = got
        out[f"{kind}_correct"] = all(got[k] <= lim for k, lim in limits.items())
    if device == "cuda":
        out["memory_peak_bytes"] = torch.cuda.max_memory_allocated()
    return out


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    args = p.parse_args()
    from run import MARK, environment

    if os.environ.get(MARK) != "1":
        os.execve(sys.executable, [sys.executable, *sys.argv], environment())
    sys.path.insert(0, str(ROOT))
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    worst, least = {}, {}
    for seed in seeds:
        r = readings(args.workload, seed, seed in control)
        print(json.dumps(r), flush=True)
        for k, v in r["system"].items():
            worst[k] = max(worst.get(k, 0.0), v)
            if "control" in r:
                least[k] = min(least.get(k, float("inf")), r["control"][k])
    print(json.dumps({"cell": args.workload, "system_max": worst, "control_min": least}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
