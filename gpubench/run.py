"""The port's benchmark: one run of one cell.

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the run's result as the last line of standard output (one JSON
object) and the numbers its output check compared, each beside its limit,
as the last lines of standard error. Exits non-zero, printing no result,
when torch sees no CUDA device (or fewer than the cell asks for), when the
port is missing, or when a module of JAX or of the JAX package is loaded.

The run sets its own environment, then executes itself again under it:
glibc's malloc keeps one arena (a serving thread's first capture otherwise
pays for a fresh one), the autotuner is off and reads its user cache from
a file under the temporary directory (only the packaged table chooses
plans), and the kernel and Triton caches live in the checkout's ``build/``.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parent.parent
MARK = "GPUBENCH_ENV"


def environment() -> dict[str, str]:
    env = dict(os.environ)
    env.pop("ST_TPU_AUTOTUNE", None)
    env.update({
        MARK: "1",
        "MALLOC_ARENA_MAX": "1",
        "ST_TPU_AUTOTUNE_CACHE": os.path.join(tempfile.gettempdir(), "gpubench",
                                              "autotune_user.json"),
        "TRITON_CACHE_DIR": str(ROOT / "build" / "triton_cache"),
        "TORCH_EXTENSIONS_DIR": str(ROOT / "build" / "torch_extensions"),
        "USE_FLAX": "0",
        "OMP_NUM_THREADS": "4",
    })
    return env


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if os.environ.get(MARK) != "1":
        os.execve(sys.executable, [sys.executable, *sys.argv], environment())

    sys.path.insert(0, str(ROOT))
    import torch

    from gpubench import harness

    cells = {w["name"]: w for w in harness.load_json(ROOT / "BENCHMARK.json")["workloads"]}
    if args.workload not in cells:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    line = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 4
    print(f"correct: {line['correct']}", file=sys.stderr)
    for k, v in line["compared"].items():
        print(f"compared {k}: {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
