"""One run of one cell: set-up, the measured window, the traced stretch, the
output check, the result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in ``configs/<config>.json`` (with the reference module
``reference/<reference>.py`` and the work counts ``work/<work>.py`` it
names, and the port's binding by the name of its overrides), its mix in
``traffic/<traffic>.json`` (and the generator module it may name), each
metric's reader in
``metrics/<metric>.py`` (or ``metrics/<base>.py``, the name before its
first dot), the kernel families in ``families/*.json``.

The system under test is the port's ``SDXLPipeline`` under the
configuration's binding, behind its ``ServingEngine``; the window's client
submits ``Request``s and waits on their futures.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import pathlib
import sys
import time
from typing import Any

import numpy as np

from gpubench.traffic import MAX_GROUP, SIGNATURE_KEYS

BENCH_DIR = pathlib.Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "stabletriton_tpu")


class HarnessFault(RuntimeError):
    """A fault of the benchmark itself (a metric out of its range, a kernel
    in two families): the run prints no result."""


# ---------------------------------------------------------------------------
# finding things by name
# ---------------------------------------------------------------------------


def load_json(path: pathlib.Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_module(path: pathlib.Path):
    """A module from a file, whatever characters its name has."""
    spec = importlib.util.spec_from_file_location(
        "gpubench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class CellSpec:
    name: str
    config: dict
    mix: Any
    end_to_end: list[dict]
    per_layer: list[dict]
    root: pathlib.Path

    def metrics(self, trace: bool) -> list[dict]:
        """The cell's metrics of one kind: those whose "workloads" name it,
        or that have no "workloads" key."""
        return [m for m in (self.per_layer if trace else self.end_to_end)
                if self.name in m.get("workloads", [self.name])]

    def reader(self, name: str):
        d = self.root / "metrics"
        path = d / f"{name}.py"
        if not path.exists():
            path = d / f"{name.split('.')[0]}.py"
        return load_module(path)

    def reference(self):
        return load_module(self.root / "reference" / f"{self.config['reference']}.py")

    def work(self):
        return load_module(self.root / "work" / f"{self.config['work']}.py")

    def families(self) -> dict[str, dict]:
        return {p.stem: load_json(p) for p in sorted((self.root / "families").glob("*.json"))}

    def peaks(self, kind: str) -> dict | None:
        return load_json(self.root / "peaks.json").get(kind)


def load_cell(name: str, root: pathlib.Path = BENCH_DIR) -> CellSpec:
    from gpubench.traffic import Mix

    bench = load_json(root.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[name]
    config = load_json(root / "configs" / f"{cell['config']}.json")
    mix = Mix.from_file(cell["traffic"], load_json(root / "traffic" / f"{cell['traffic']}.json"),
                        root=root / "traffic")
    return CellSpec(name, config, mix, bench["end_to_end"], bench["per_layer"], root)


# ---------------------------------------------------------------------------
# the system under test
# ---------------------------------------------------------------------------


def compile_config(cfg: dict, **fields):
    """The port's CompileConfig for the configuration: its ``binding``
    ("reference": the plain-PyTorch backend; "default": the hand-written
    kernels' own binding; any other name: the port's ``<NAME>_OVERRIDES``
    on them), its ``compile`` fields, then ``fields`` (a control's)."""
    from stabletriton_tpu_torch import compile as cc

    binding = cfg["binding"]
    kw = {"backend": "reference" if binding == "reference" else "cuda",
          "dtype": cfg["dtypes"]["unet"], "overrides": ()}
    if binding not in ("reference", "default"):
        kw["overrides"] = getattr(cc, f"{binding.upper()}_OVERRIDES")
    kw.update(cfg.get("compile", {}))
    kw.update(fields)
    return cc.CompileConfig(**kw)


def tokenizers(cfg: dict):
    from gpubench.tokenizer import StubTokenizer

    c1 = cfg["text_encoder"]
    c2 = cfg.get("text_encoder_2") or c1
    return (StubTokenizer(c1["bos_token_id"], c1["eos_token_id"]),
            StubTokenizer(c2["bos_token_id"], c2["eos_token_id"]))


def build_system(cfg: dict, params: dict, device, **compile_fields):
    """(pipeline, engine): the port's SDXLPipeline for the configuration, on
    the harness's weights, behind a ServingEngine with its default window
    (``compile_fields``: CompileConfig fields over the configuration's)."""
    from stabletriton_tpu_torch.models.clip import CLIPTextConfig
    from stabletriton_tpu_torch.models.unet import UNetConfig
    from stabletriton_tpu_torch.models.vae import VAEConfig
    from stabletriton_tpu_torch.runtime.pipeline import SDXLPipeline
    from stabletriton_tpu_torch.runtime.scheduler import SchedulerConfig
    from stabletriton_tpu_torch.runtime.serving import ServingEngine

    def tuples(d):
        return {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}

    c1 = CLIPTextConfig(**cfg["text_encoder"])
    c2 = CLIPTextConfig(**cfg["text_encoder_2"]) if cfg.get("text_encoder_2") else c1
    pipe = SDXLPipeline(
        unet_config=UNetConfig(**tuples(cfg["unet"])), clip_config=c1, clip2_config=c2,
        vae_config=VAEConfig(**tuples(cfg["vae"])), params=dict(params),
        compile_config=compile_config(cfg, **compile_fields),
        scheduler_config=SchedulerConfig(**cfg["scheduler"]),
        clip_skip=cfg.get("clip_skip", 1), device=device)
    tok1, tok2 = tokenizers(cfg)
    return pipe, ServingEngine(pipe, tok1, tok2, max_batch=MAX_GROUP)


def request_for(cfg: dict, rec):
    """The port's Request for a record: the configuration's signature with
    the mix's fields over it, the empty negative prompt."""
    from stabletriton_tpu_torch.runtime.serving import Request

    from gpubench.traffic import signature_of

    return Request(prompt=rec.prompt, negative="", solver=cfg["solver"], seed=rec.seed,
                   **signature_of(rec.signature, cfg))


class GroupLog:
    """Wraps the engine's ``pipeline.txt2img``, the call that serves one
    group: records each call's start and end (after a synchronise where
    ``sync``) and its per-image seeds, which name the group's requests."""

    def __init__(self, pipe, sync: bool):
        self.groups: list[dict] = []
        inner = pipe.txt2img

        def txt2img(*args, **kwargs):
            t0 = time.perf_counter()
            out = inner(*args, **kwargs)
            if sync:
                import torch
                torch.cuda.synchronize()
            self.groups.append({"t_start": t0, "t_end": time.perf_counter(),
                                "seeds": list(kwargs["seed"]),
                                **{k: kwargs[k] for k in SIGNATURE_KEYS}})
            return out

        pipe.txt2img = txt2img


def serve(engine, cfg, mix, seed: int, seconds: float, first_index: int = 0,
          total: int | None = None, outstanding: int | None = None):
    """The mix's client on the engine (traffic.serve): its window, or
    ``total`` requests (with ``outstanding`` in flight where given)."""
    from gpubench import traffic

    return traffic.serve(lambda rec: engine.submit(request_for(cfg, rec)), mix, seed, seconds,
                         first_index=first_index, total=total, outstanding=outstanding)


def warm_up(engine, cfg, mix, seed: int) -> list:
    """Set-up's requests: one group of each size the mix warms, for each of
    its signatures (the loop's eager run and capture, CLIP, the decode),
    outside the window. Returns their records."""
    from gpubench import traffic

    out = []
    for j, sig in enumerate(mix.signatures):
        for k, size in enumerate(mix.warm):
            first = (1 << 30) + (j * len(mix.warm) + k) * 8

            def make(i, first=first, sig=sig):
                prompt, image_seed, _ = mix.request_params(seed, first + i)
                return prompt, image_seed, dict(sig)

            recs, _, _ = traffic.closed_loop(lambda rec: engine.submit(request_for(cfg, rec)),
                                             make, size, 0.0, total=size)
            out.extend(recs)
    return out


# ---------------------------------------------------------------------------
# the run's record, read by the metric readers
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Run:
    spec: CellSpec
    seed: int
    seconds: float
    device_kind: str
    setup_s: float = 0.0
    records: list = dataclasses.field(default_factory=list)
    groups: list = dataclasses.field(default_factory=list)
    t0: float = 0.0
    t_end: float = 0.0
    captured: list = dataclasses.field(default_factory=list)
    stretch: Any = None
    synced: bool = False

    @property
    def cfg(self) -> dict:
        return self.spec.config

    def group_of(self) -> dict[int, tuple[dict, int]]:
        """{request seed: (its group, its slot)}."""
        out = {}
        for g in self.groups:
            for slot, s in enumerate(g["seeds"]):
                out.setdefault(s, (g, slot))
        return out

    def window_requests(self) -> list:
        """The requests that completed inside the window, without error."""
        return [r for r in self.records
                if r.t_done is not None and r.t_done <= self.t_end and r.error is None]

    def counted_groups(self) -> tuple[list[dict], list, float]:
        """The groups that started inside the window, their requests, and
        the time from the window's start to the last of them completing."""
        started = [g for g in self.groups if self.t0 <= g["t_start"] < self.t_end]
        seeds = {s for g in started for s in g["seeds"]}
        reqs = [r for r in self.records if r.seed in seeds and r.t_done is not None]
        last = max((r.t_done for r in reqs), default=self.t_end)
        return started, reqs, last - self.t0

    def lat_hw(self, group: dict) -> tuple[int, int]:
        """The latent's height and width in a group's call."""
        f = 2 ** (len(self.cfg["vae"]["block_out_channels"]) - 1)
        return group["height"] // f, group["width"] // f

    def unet_batch(self, images: int, group: dict) -> int:
        """Rows of a UNet evaluation serving ``images`` in a group's call:
        doubled under CFG."""
        return 2 * images if group["guidance_scale"] > 1.0 else images


# ---------------------------------------------------------------------------
# output check
# ---------------------------------------------------------------------------


def sample_requests(run: Run, candidates: list, n: int) -> list:
    """A sample of ``n`` of the candidates, drawn from the run's seed: the
    request with the longest prompt; where the engine served groups of
    k > 1, one served in the last slot of its group and one in a slot drawn
    from the seed (0 to k - 1, so that a fault confined to any slot is
    caught by some seeds); random others."""
    if not candidates:
        return []
    rng = np.random.default_rng([int(run.seed) % 2**64, 7])
    picked = [max(candidates, key=lambda r: (len(r.prompt), -r.index))]
    where = run.group_of()
    slots = {r.index: (where[r.seed][1], len(where[r.seed][0]["seeds"]))
             for r in candidates if r.seed in where}
    k = max((size for _, size in slots.values()), default=1)
    if k > 1:
        for want in (k - 1, int(rng.integers(k))):
            at = [r for r in candidates if r not in picked and slots.get(r.index) == (want, k)]
            if at and len(picked) < n:
                picked.append(at[int(rng.integers(len(at)))])
    rest = [r for r in candidates if r not in picked]
    for i in rng.permutation(len(rest)):
        if len(picked) >= n:
            break
        picked.append(rest[int(i)])
    return picked[:max(n, 1)]


def reference_ids(cfg: dict, prompts: list[str], negatives: list[str], device):
    """The token ids the reference reads, made with the traffic's tokenizer:
    ids1, ids2, neg1, neg2 as int64 tensors (ids2 and neg2 None for one
    encoder). Encoder 2 pads with its configured pad id."""
    import torch

    tok1, tok2 = tokenizers(cfg)
    c1 = cfg["text_encoder"]
    c2 = cfg.get("text_encoder_2")

    def ids(tok, c, texts):
        pad = c.get("pad_token_id")
        a = tok.encode_batch(texts, max_len=c["max_position_embeddings"], pad=pad)
        return torch.as_tensor(a, dtype=torch.long, device=device)

    out = [ids(tok1, c1, prompts), None, ids(tok1, c1, negatives), None]
    if c2:
        out[1], out[3] = ids(tok2, c2, prompts), ids(tok2, c2, negatives)
    return out


def compare_images(got: np.ndarray, ref: np.ndarray) -> dict[str, float]:
    """The numbers compared for one image: the gap's RMS over the
    reference's RMS, and the largest absolute gap."""
    d = got.astype(np.float64) - ref.astype(np.float64)
    rms_ref = np.sqrt(np.mean(ref.astype(np.float64) ** 2))
    return {"image_rel_rms": float(np.sqrt(np.mean(d * d)) / max(rms_ref, 1e-12)),
            "image_max_abs": float(np.max(np.abs(d)))}


def reference_images(spec: CellSpec, params: dict, requests: list,
                     device, unet_dtype=None) -> list[np.ndarray]:
    """The reference's image of each request, computed in blocks of at most
    the configuration's ``check.block`` images of one signature (its UNet in
    ``unet_dtype``, by default the configuration's)."""
    import torch

    from gpubench.traffic import signature_of

    ref = spec.reference()
    cfg = spec.config
    block = int(cfg["check"].get("block", 1))
    out: dict[int, np.ndarray] = {}
    sigs: dict[tuple, list] = {}
    for r in requests:
        sigs.setdefault(tuple(sorted(r.signature.items())), []).append(r)
    with torch.inference_mode(), ref.strict_float32():
        for sig, reqs in sigs.items():
            c = dict(cfg, **signature_of(dict(sig), cfg))
            for i in range(0, len(reqs), block):
                chunk = reqs[i:i + block]
                ids = reference_ids(c, [r.prompt for r in chunk], [""] * len(chunk), device)
                imgs = ref.txt2img(c, params, *ids, [r.seed for r in chunk], unet_dtype)
                for r, img in zip(chunk, imgs.float().cpu().numpy()):
                    out[id(r)] = img
                del imgs
    return [out[id(r)] for r in requests]


def float32_references(spec: CellSpec) -> bool:
    """Whether the configuration's numbers need the reference a second time
    with its UNet in float32 (``image_gap_ratio``)."""
    return "image_gap_ratio" in spec.config["check"]["limits"]


def sample_numbers(images: list, refs: list, refs32: list | None = None) -> dict[str, float]:
    """The numbers of one sample of images: each image's numbers, the worst
    over the sample; with ``refs32`` (the reference with its UNet in
    float32), ``reference_gap``, the mean over the sample of the two
    references' ``image_rel_rms``, and ``image_gap_ratio``, the worst
    ``image_rel_rms`` over that gap. The ratio reads the program's gap in
    units of how far the configuration's precision alone moves this seed's
    images: the seed's weights set how much 30 steps amplify any rounding,
    and that amplification cancels."""
    per = [compare_images(g, r) for g, r in zip(images, refs)]
    out = {k: max(x[k] for x in per) for k in per[0]}
    if refs32 is not None:
        gap = float(np.mean([compare_images(r, r32)["image_rel_rms"]
                             for r, r32 in zip(refs, refs32)]))
        out["reference_gap"] = gap
        out["image_gap_ratio"] = out["image_rel_rms"] / max(gap, 1e-12)
    return out


def check_outputs(spec: CellSpec, params: dict, requests: list, device,
                  log=print) -> dict[str, dict]:
    """{number: {"value": its value over the sample, "limit": its limit}}
    for every number the configuration limits; the others on standard
    error."""
    import torch

    limits = spec.config["check"]["limits"]
    refs = reference_images(spec, params, requests, device)
    refs32 = (reference_images(spec, params, requests, device, torch.float32)
              if float32_references(spec) else None)
    got = sample_numbers([r.image for r in requests], refs, refs32)
    log(f"sample numbers: {got}", file=sys.stderr)
    return {k: {"value": got[k], "limit": limits[k]} for k in limits}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def process_age_s() -> float:
    """Seconds since this process started (the kernel's record of it: an
    exec keeps it)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def captured_graphs(pipe) -> list:
    """The Captured record of every graph of the pipeline's programs."""
    out = []
    for sig in pipe.cache_signatures():
        loop = getattr(pipe._cache[sig], "loop", None)
        out.extend(getattr(loop, "captured", {}).values())
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             root: pathlib.Path = BENCH_DIR, t_start: float | None = None,
             log=print) -> dict:
    """One run; returns the result line as a dict. ``device`` "cpu" skips the
    look for a card (the CPU tests drive the rest of a run so)."""
    import torch

    from gpubench import weights

    t_start = time.perf_counter() - process_age_s() if t_start is None else t_start
    spec = load_cell(name, root)
    cfg = spec.config
    on_card = device == "cuda"
    kind = torch.cuda.get_device_name(0) if on_card else "cpu"
    run = Run(spec, seed, seconds, kind, synced=trace)

    params = weights.make(spec.reference().param_shapes(cfg), cfg["dtypes"], seed, device)
    pipe, engine = build_system(cfg, params, device)
    log_groups = GroupLog(pipe, sync=run.synced and on_card)
    warm = warm_up(engine, cfg, spec.mix, seed)
    if any(r.error for r in warm):
        raise RuntimeError(f"set-up request failed: {warm[0].error}")
    if on_card:
        torch.cuda.synchronize()
    log_groups.groups.clear()
    run.setup_s = time.perf_counter() - t_start

    run.records, run.t0, run.t_end = serve(engine, cfg, spec.mix, seed, seconds)
    run.groups = list(log_groups.groups)
    if trace:
        from gpubench import tracing

        run.stretch = tracing.profile_stretch(run, engine, log_groups, on_card)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    run.captured = captured_graphs(pipe)
    engine.close()
    del engine, pipe, log_groups
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    metrics = {}
    for m in spec.metrics(trace):
        value = spec.reader(m["name"]).read(run, m["name"])
        if value is None:
            if not trace:
                raise HarnessFault(f"end-to-end metric {m['name']} has no value")
            continue
        if m["unit"] == "%" and not 0.0 <= value <= 100.0:
            raise HarnessFault(f"{m['name']} = {value}%: the work or the time is counted wrong")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    lat = sorted(r.t_done - r.t_submit for r in run.window_requests())
    started, counted, span = run.counted_groups()
    if lat:
        log(f"window: {len(lat)} requests completed in {seconds:g} s, latency p50 "
            f"{np.percentile(lat, 50):.4f} s p90 {np.percentile(lat, 90):.4f} s max {lat[-1]:.4f} s; "
            f"{len(started)} groups started ({len(counted)} requests, {span:.3f} s to the last "
            f"completion); sizes {sorted({len(g['seeds']) for g in started})}; latency deciles "
            f"{[round(float(x), 4) for x in np.percentile(lat, range(10, 100, 10))]}", file=sys.stderr)
        log("latency by request in sending order, ms: "
            f"{[round(1e3 * (r.t_done - r.t_submit), 1) for r in run.window_requests()]}",
            file=sys.stderr)
    attempted = len(run.records)
    failed = sum(1 for r in run.records if r.error is not None or r.t_done is None)
    candidates = [r for r in run.records if r.error is None and r.image is not None]
    sample = sample_requests(run, candidates, int(cfg["check"]["sample"]))
    t_ref = time.perf_counter()
    compared = check_outputs(spec, params, sample, device, log) if sample else {}
    log(f"reference: {len(sample)} requests checked in {time.perf_counter() - t_ref:.1f} s "
        f"(indices {[r.index for r in sample]})", file=sys.stderr)
    correct = (bool(sample) and failed == 0
               and all(v["value"] <= v["limit"] for v in compared.values()))

    device_info = {"platform": "gpu" if on_card else "cpu", "kind": kind, "count": 1,
                   "memory_peak_bytes": int(memory_peak)}
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_info}
    if trace and run.stretch is not None:
        device_info["busy_s"] = run.stretch.busy_s
        device_info["window_s"] = run.stretch.window_s
        line["breakdown"] = run.stretch.breakdown()
    line["compared"] = compared
    return line
