"""Per-shape tuning of the Hopper kernels' launch parameters, with a
persistent table.

Counterpart of ``stabletriton_tpu/kernels/autotune.py``. The capability both
mirror is the reference's launch-time Triton GEMM autotune (reference
``src/stabletriton/kernels/linear.py:38-63``), which times its configs at a
shape's first launch. Here, as in the JAX package, tuning is split:

  * **lookup at dispatch**: each wrapper's route consults the table for its
    exact key before the fitted rule (``linear._route``: the wgmma GEMM's
    ``wgmma_plan.gemm_plan`` and the skinny kernel's ``skinny_plan``;
    ``conv_direct._wgmma_route``: ``wgmma_plan.conv_plan``;
    ``flash_attention._route``: the bf16 kernel and ``tiny_kv_plan``);
  * **measure ahead of capture**: ``tune_linear``, ``tune_conv``,
    ``tune_attention`` and ``tune_attention_fused`` time each candidate
    plan on the card and record the fastest; ``ensure_*_tuned`` enumerate
    every shape a (UNet config, resolution, batch) dispatches and tune the
    missing ones. With ``ST_TPU_AUTOTUNE=1`` the pipeline does so before it
    builds (and captures) a new signature.

What is tuned is the port's own: the Hopper kernels' launch parameters, not
the JAX package's ``block_q`` / ``block_k`` / ``span`` / ``block_rows``:

  ``linear:m:k:n:dtype``   {"bn", "splits"} (wgmma GEMM, M > 16) or
                           {"cols", "splits"} (skinny kernel, M <= 16)
  ``conv3x3:...``          {"bn", "splits"} (wgmma conv; ``:gn`` keys the
                           GroupNorm prologue, K8, at widths 128, 192,
                           256; Cout <= 8 runs at width 8 unsplit)
  ``attention:...``,       {"kernel": "tinykv_wgmma_bf16" | "wgmma_bf16",
  ``attention_qkv:...``,    "tiles"} (bf16; both kernels take Sk <=
  ``attention_kv:...``      TINY_KV_KEYS)

Every entry also carries ``t_us``, its time a launch. An entry of
``t_us`` alone records that the shape was measured and the fitted rule's
plan kept: a tuner records a plan off the rule only where it beats the
rule's time by more than two timings of the rule differ, so noise never
makes a second plan path. No value routes a
launch away from the hand-written kernels: there is no library route, and a
value that a kernel cannot take raises at lookup, naming its key.
``conv_tile`` (and K8's ``gn_conv_tile``) stays a pure function of the
shape. Not ported, because they are TPU layouts with no Hopper meaning:
the JAX module's device kinds in ``platform_tag``, the ``views`` /
``element`` halo plans, ``conv_block_rows_candidates``,
``attention_spans`` and ``attention_variants``.

Two-layer store, as in the JAX package: a packaged table in the repo
(``kernels/tuned/<platform>.json``, the plans off the rule that
``scripts/tune_torch_table.py`` measured on the card) and a writable user
cache (``$ST_TPU_AUTOTUNE_CACHE`` or
``~/.cache/stabletriton_tpu_torch/<platform>.json``); user entries override
packaged ones. A card whose tag has no packaged file uses the rules until
it is tuned.

The routes are cached per signature, so :func:`record` clears their caches:
a process launches a recorded plan from its next call on. A CUDA graph that
is already captured keeps the plan it captured until its owner drops it (a
pipeline's ``_cache``).
"""

from __future__ import annotations

import contextlib
import fcntl
import json
import math
import os
import pathlib
import tempfile
import threading
from typing import Callable, NamedTuple

import torch

_LOCK = threading.Lock()
_TABLES: dict[str, dict] = {}  # platform -> {key: entry}
# the packaged tables; a tuner that must start from nothing points it at
# an empty directory (scripts/tune_torch_table.py, the card tests' empty_table)
PACKAGED_DIR = pathlib.Path(__file__).parent / "tuned"
_DISABLED = [False]  # set inside :func:`disabled`
REPS = 10  # launches in one measured graph


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------


def platform_tag() -> str:
    """The table's name for the current card, e.g. 'nvidia_h100_80gb_hbm3';
    'cpu' where torch sees no card."""
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name().lower().replace(" ", "_").replace("-", "_")


def _user_cache_path(platform: str) -> pathlib.Path:
    env = os.environ.get("ST_TPU_AUTOTUNE_CACHE")
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "stabletriton_tpu_torch" / f"{platform}.json"


def packaged_path(platform: str) -> pathlib.Path:
    return PACKAGED_DIR / f"{platform}.json"


def _load_table(platform: str) -> dict:
    with _LOCK:
        tbl = _TABLES.get(platform)
        if tbl is not None:
            return tbl
        tbl = {}
        for path in (packaged_path(platform), _user_cache_path(platform)):
            try:
                tbl.update(json.loads(path.read_text()))
            except FileNotFoundError:
                pass
            except ValueError as e:
                raise ValueError(f"autotune table {path} is not valid JSON: {e}") from e
        _TABLES[platform] = tbl
        return tbl


def _clear_routes() -> None:
    """Drop every cached route and plan, so the next launch reads the table."""
    from stabletriton_tpu_torch.kernels import conv_direct, flash_attention, linear, wgmma_plan

    for fn in (linear._route, conv_direct._wgmma_route, flash_attention._route,
               wgmma_plan.gemm_plan, wgmma_plan.conv_plan):
        fn.cache_clear()


def reload() -> None:
    """Forget the loaded tables (they are read again at the next lookup) and
    the routes made from them."""
    with _LOCK:
        _TABLES.clear()
    _clear_routes()


def lookup(key: str, platform: str | None = None) -> dict | None:
    if _DISABLED[0]:
        return None
    return _load_table(platform or platform_tag()).get(key)


def keeps_rule(entry: dict) -> bool:
    """Whether a table entry records only that the rule's plan was kept."""
    return set(entry) == {"t_us"}


def plan_entry(key: str) -> dict | None:
    """The table's entry for ``key`` where it names a plan; None where the
    table has none or kept the rule's (the route takes its rule)."""
    entry = lookup(key)
    return None if entry is None or keeps_rule(entry) else entry


@contextlib.contextmanager
def _file_lock(path: pathlib.Path):
    """An exclusive lock on ``path``'s ``.lock`` file beside it, between
    processes (the ranks of a mesh on one host share one user cache)."""
    with open(path.with_name(path.name + ".lock"), "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def record(key: str, config: dict, platform: str | None = None,
           persist: bool = True) -> None:
    """Enter ``config`` under ``key``; with ``persist`` also merge it into
    the user cache on disk (with what other tuners wrote there), under the
    lock and a lock on the file, and replace the file whole, so a reader
    never sees it half written. Clears the routes' caches."""
    platform = platform or platform_tag()
    tbl = _load_table(platform)
    with _LOCK:
        tbl[key] = config
        if persist:
            path = _user_cache_path(platform)
            path.parent.mkdir(parents=True, exist_ok=True)
            with _file_lock(path):
                try:
                    existing = json.loads(path.read_text())
                except FileNotFoundError:
                    existing = {}
                existing[key] = config
                fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=path.name, suffix=".tmp")
                with os.fdopen(fd, "w") as f:
                    json.dump(existing, f, indent=1, sort_keys=True)
                os.replace(tmp, path)
    _clear_routes()


@contextlib.contextmanager
def disabled():
    """Inside, every lookup finds nothing, so the routes take the fitted
    rules (for timing them beside the table); the routes' caches are
    cleared on entry and on exit."""
    _DISABLED[0] = True
    _clear_routes()
    try:
        yield
    finally:
        _DISABLED[0] = False
        _clear_routes()


def autotune_enabled() -> bool:
    return os.environ.get("ST_TPU_AUTOTUNE", "") not in ("", "0")


def check_entry(key: str, entry: dict, fields: tuple[str, ...]) -> dict:
    """``entry``, checked to hold exactly ``fields`` (and ``t_us``); raises
    naming the key otherwise."""
    extra = set(entry) - set(fields) - {"t_us"}
    missing = [f for f in fields if f not in entry]
    if extra or missing:
        raise ValueError(f"autotune entry {key} = {entry}: a launch here takes exactly "
                         f"{list(fields)} (and t_us)")
    return entry


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


def _dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def attention_key(b: int, sq: int, sk: int, h: int, d: int, dtype) -> str:
    return f"attention:b{b}:sq{sq}:sk{sk}:h{h}:d{d}:{_dtype_name(dtype)}"


def fused_attention_key(kind: str, b: int, sq: int, sk: int, h: int, d: int, dtype) -> str:
    """Key of the fused-operand entry points (kind: 'qkv' | 'kv'), tuned
    apart from the split interface as in the JAX package."""
    return f"attention_{kind}:b{b}:sq{sq}:sk{sk}:h{h}:d{d}:{_dtype_name(dtype)}"


def conv_key(n: int, h: int, w: int, cin: int, cout: int, dtype, has_res: bool, act,
             gn: bool = False) -> str:
    """``gn=True`` keys the GroupNorm-prologue conv (K8) apart."""
    base = (f"conv3x3:n{n}:h{h}:w{w}:ci{cin}:co{cout}:"
            f"{_dtype_name(dtype)}:res{int(bool(has_res))}:{act or '-'}")
    return base + ":gn" if gn else base


def linear_key(m: int, k: int, n: int, dtype) -> str:
    """An (m, k) @ (k, n) GEMM: the bf16 linear and conv share one wgmma
    mainloop and one Plan, so a GEMM is tuned as a conv is."""
    return f"linear:m{m}:k{k}:n{n}:{_dtype_name(dtype)}"


# ---------------------------------------------------------------------------
# candidates
# ---------------------------------------------------------------------------


def _around(m_tiles: int, n: int, steps: int, out_rows: int, moved: int,
            widths: tuple[int, ...], rule, model=None) -> list:
    """The rule's plan, and at each width the split of least modelled time
    (``model``, else the wgmma mainloop's) with its neighbours, its half and
    double, and no split."""
    from stabletriton_tpu_torch.kernels import wgmma_plan as wp

    model = model or wp.modelled_seconds
    top = min(steps, wp.MAX_SPLITS)
    cands = {rule}
    for bn in widths:
        best = min(range(1, top + 1), key=lambda s: (
            model(m_tiles, n, steps, out_rows, moved, bn, s), s))
        for s in (1, best // 2, best - 1, best, best + 1, 2 * best):
            if 1 <= s <= top:
                cands.add(wp.Plan(bn, s))
    return sorted(cands, key=lambda p: (p.bn, p.splits))


def gemm_candidates(m: int, k: int, n: int) -> list:
    from stabletriton_tpu_torch.kernels import wgmma_plan as wp

    return _around(math.ceil(m / wp.BM), n, math.ceil(k / wp.BK), m,
                   (m * k + k * n + m * n) * 2, wp.WIDTHS, wp.gemm_plan(m, k, n))


def conv_candidates(n: int, h: int, w: int, cin: int, cout: int, gn: bool = False) -> list:
    """The wgmma conv's plans for Cin padded to 8, as the wrapper launches
    it: width 8 unsplit alone for Cout <= 8; under the GroupNorm prologue
    K8's widths around its own model."""
    from stabletriton_tpu_torch.kernels import wgmma_plan as wp

    cin8 = -(-cin // 8) * 8
    tile, rule = wp.conv_plan(n, h, w, cin8, cout, gn=gn)
    if cout <= wp.N8:
        return [rule]
    return _around(math.prod(tile.counts(n, h, w)), cout, 9 * math.ceil(cin8 / wp.BK),
                   n * h * w, (n * h * w * (cin8 + cout) + 9 * cin8 * cout) * 2,
                   wp.GN_WIDTHS if gn else wp.WIDTHS, rule,
                   wp.gn_modelled_seconds if gn else None)


def skinny_candidates(m: int, k: int, n: int, itemsize: int) -> list:
    """The skinny kernel's rule, and every slice width at K splits of 1, 2,
    4 and 8 blocks."""
    from stabletriton_tpu_torch.kernels import linear as lin

    cands = {lin.skinny_plan(m, k, n, itemsize)}
    vec = 16 // itemsize
    for width in lin.SKINNY_WIDTHS:
        for want in (1, 2, 4, lin.SKINNY_MAX_SPLITS):
            rows = max(1, -(-k // want))
            cands.add(lin.SkinnyPlan(width * vec, max(1, -(-k // rows)), rows))
    return sorted(cands)


def attention_candidates(b: int, sq: int, sk: int, h: int, d: int) -> list[tuple[str, int]]:
    """(kernel, tiles) of the bf16 kernels that take the shape: at Sk <=
    TINY_KV_KEYS the tiny-KV kernel at every tile count its query boxes
    allow, and the KV-loop kernel; above, the KV-loop kernel alone."""
    from stabletriton_tpu_torch.kernels import flash_attention as fa

    out = [("wgmma_bf16", 1)]
    if sk <= fa.TINY_KV_KEYS:
        rule = fa.tiny_kv_plan(b, h, sq, d).tiles
        top = min(fa.tiny_kv_tiles_cap(d), -(-sq // fa.QUERY_TILE))
        tiles = set(range(1, top + 1)) | {rule}
        out += [("tinykv_wgmma_bf16", t) for t in sorted(tiles)]
    return out


# ---------------------------------------------------------------------------
# measuring
# ---------------------------------------------------------------------------


class Candidate:
    """One plan of one shape. A call replays a CUDA graph of REPS launches
    at the plan (captured at the first call, after one eager launch) and
    returns its argument, so ``bench_fn`` chains it; its launches are kept
    out of the wrappers' counters. ``plan`` names it (a fake clock reads
    it)."""

    def __init__(self, plan, launch: Callable[[], object]):
        self.plan, self._launch, self._graph = plan, launch, None

    def __call__(self, token):
        if self._graph is None:
            self._graph = _graphed(self._launch)
        self._graph.replay()
        return token

    def release(self) -> None:
        self._graph = None


def _graphed(launch) -> torch.cuda.CUDAGraph:
    from stabletriton_tpu_torch.kernels import build

    with build.recording():
        launch()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(REPS):
                launch()
    return graph


class Tuned(NamedTuple):
    key: str
    entry: dict                # what was recorded
    times_us: dict             # candidate plan -> its time a launch
    rule: object               # the fitted rule's plan
    retimed_us: dict           # the rule and the fastest other plan, timed again


def _check_can_measure(measure) -> None:
    from stabletriton_tpu_torch.runtime.profiling import bench_fn

    if measure is bench_fn and not torch.cuda.is_available():
        raise RuntimeError("tuning measures the kernels on the card and torch sees none: "
                           "the plain versions do not depend on the plan")
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError("tuning runs ahead of a capture, never inside one")


def _tune(key: str, cands: list, rule, make_launch, entry_of, *, measure, persist,
          verbose, device) -> Tuned:
    """Time each candidate (the rule's always among them) with ``measure``.
    Where another plan is fastest, time it and the rule's again: it is
    recorded under ``key`` as ``entry_of(plan)`` plus its time only if both
    its times beat both of the rule's by more than the rule's two differ.
    Otherwise the entry is the rule's time alone (:func:`keeps_rule`)."""
    _check_can_measure(measure)
    if rule not in cands:
        cands = [rule, *cands]
    token = torch.empty(1, device=device)

    def timed(plan) -> float:
        cand = Candidate(plan, make_launch(plan))
        try:
            us = measure(cand, token, chain_arg=0, min_window=0.01) / REPS * 1e6
        finally:
            cand.release()
        if verbose:
            print(f"  [autotune] {key} {entry_of(plan)}: {us:.2f} us", flush=True)
        return us

    times = {plan: timed(plan) for plan in cands}
    best = min(times, key=lambda p: (times[p], p != rule))
    retimed = {}
    if best != rule:
        retimed = {rule: timed(rule), best: timed(best)}
        rule_us = (times[rule], retimed[rule])
        spread = abs(rule_us[0] - rule_us[1])
        if max(times[best], retimed[best]) < min(rule_us) - spread:
            entry = {**entry_of(best), "t_us": round(min(times[best], retimed[best]), 3)}
        else:
            entry = {"t_us": round(min(rule_us), 3)}
    else:
        entry = {"t_us": round(times[rule], 3)}
    record(key, entry, persist=persist)
    return Tuned(key, entry, times, rule, retimed)


def _device(device):
    return torch.device(device if device is not None else
                        ("cuda" if torch.cuda.is_available() else "cpu"))


def _randn(shape, dtype, device, gen):
    return torch.randn(shape, generator=gen, device=device).to(dtype)


def tune_linear(m: int, k: int, n: int, dtype=torch.bfloat16, *, measure=None,
                persist: bool = True, verbose: bool = False, device=None) -> Tuned:
    """Measure the plans of an (m, k) @ (k, n) GEMM (bias, no act): the wgmma
    kernel's {"bn", "splits"} above 16 rows, the skinny kernel's {"cols",
    "splits"} at most 16; record the fastest. A shape neither kernel takes
    with a plan raises."""
    from stabletriton_tpu_torch.kernels import linear as lin
    from stabletriton_tpu_torch.kernels import wgmma_plan as wp
    from stabletriton_tpu_torch.runtime.profiling import bench_fn

    measure = measure or bench_fn
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    name = lin.variant(m, k, n, dtype)
    if name == "wgmma_bf16":
        rule, cands = wp.gemm_plan(m, k, n), gemm_candidates(m, k, n)
        entry_of = lambda p: {"bn": p.bn, "splits": p.splits}  # noqa: E731
    elif name.startswith("skinny"):
        rule = lin.skinny_plan(m, k, n, dtype.itemsize)
        cands = skinny_candidates(m, k, n, dtype.itemsize)
        entry_of = lambda p: {"cols": p.cols, "splits": p.splits}  # noqa: E731
    else:
        raise ValueError(f"{linear_key(m, k, n, dtype)}: the {name} kernel takes no plan")
    device = _device(device)
    ops = {}

    def make_launch(plan):
        def launch():
            if not ops:
                gen = torch.Generator(device=device).manual_seed(0)
                ops["x"] = _randn((m, k), dtype, device, gen)
                ops["w"] = (_randn((k, n), dtype, device, gen) / k ** 0.5).to(dtype)
                ops["b"] = _randn((n,), dtype, device, gen)
            return lin._launch(ops["x"], ops["w"], ops["b"], None, name, plan=plan)
        return launch

    try:
        return _tune(linear_key(m, k, n, dtype), cands, rule, make_launch, entry_of,
                     measure=measure, persist=persist, verbose=verbose, device=device)
    finally:
        ops.clear()


def tune_conv(n: int, h: int, w: int, cin: int, cout: int, dtype=torch.bfloat16, *,
              has_res: bool = True, act: str | None = "silu", gn: bool = False,
              measure=None, persist: bool = True, verbose: bool = False,
              device=None) -> Tuned:
    """Measure the wgmma conv's plans at one shape (``gn``: with the
    GroupNorm prologue, its scale / shift as inputs) and record the
    fastest under its ``conv3x3`` key."""
    from stabletriton_tpu_torch.kernels import conv_direct as cd
    from stabletriton_tpu_torch.kernels import wgmma_plan as wp
    from stabletriton_tpu_torch.runtime.profiling import bench_fn

    measure = measure or bench_fn
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    key = conv_key(n, h, w, cin, cout, dtype, has_res, act, gn)
    if dtype != torch.bfloat16 or not wp.conv_fits(n, h, w, cin, cout, gn=gn):
        raise ValueError(f"{key}: no wgmma conv takes the shape")
    rule = wp.conv_plan(n, h, w, -(-cin // 8) * 8, cout, gn=gn)[1]
    device = _device(device)
    ops = {}

    def make_launch(plan):
        def launch():
            if not ops:
                gen = torch.Generator(device=device).manual_seed(0)
                ops["x"] = _randn((n, h, w, cin), dtype, device, gen)
                ops["w"] = (_randn((3, 3, cin, cout), dtype, device, gen)
                            / (9 * cin) ** 0.5).to(dtype)
                ops["b"] = torch.zeros((n, cout), device=device)
                ops["r"] = _randn((n, h, w, cout), dtype, device, gen) if has_res else None
                ops["gn"] = ((torch.ones((n, cin), device=device),
                              torch.zeros((n, cin), device=device), "silu") if gn else None)
            return cd._launch(ops["x"], ops["w"], ops["b"], ops["r"], act, ops["gn"],
                              "wgmma_bf16", plan=plan)
        return launch

    try:
        return _tune(key, conv_candidates(n, h, w, cin, cout, gn), rule, make_launch,
                     lambda p: {"bn": p.bn, "splits": p.splits}, measure=measure,
                     persist=persist, verbose=verbose, device=device)
    finally:
        ops.clear()


def _tune_attention_entry(kind: str, b: int, sq: int, sk: int, h: int, d: int, dtype, *,
                          measure, persist, verbose, device) -> Tuned:
    from stabletriton_tpu_torch.kernels import flash_attention as fa
    from stabletriton_tpu_torch.runtime.profiling import bench_fn

    measure = measure or bench_fn
    dtype = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    key = (attention_key(b, sq, sk, h, d, dtype) if kind == "attention"
           else fused_attention_key(kind, b, sq, sk, h, d, dtype))
    if dtype != torch.bfloat16 or d not in fa.HEAD_DIMS[torch.bfloat16]:
        raise ValueError(f"{key}: only the bf16 attention kernels take a plan")
    rule = (fa.kernel_name(dtype, sk),
            fa.tiny_kv_plan(b, h, sq, d).tiles if sk <= fa.TINY_KV_KEYS else 1)
    device = _device(device)
    c = h * d
    ops = {}

    def make_launch(plan):
        def launch():
            if not ops:
                gen = torch.Generator(device=device).manual_seed(0)
                ops["q"] = _randn((b, sq, 3 * c if kind == "qkv" else c), dtype, device, gen)
                ops["k"] = _randn((b, sk, 2 * c if kind == "kv" else c), dtype, device, gen)
                ops["v"] = _randn((b, sk, c), dtype, device, gen)
            q = ops["q"]
            k = q if kind == "qkv" else ops["k"]
            v = {"qkv": q, "kv": ops["k"]}.get(kind, ops["v"])
            offs = {"qkv": (0, c, 2 * c), "kv": (0, 0, c)}.get(kind, (0, 0, 0))
            return fa._launch(q, offs[0], k, offs[1], v, offs[2], sq=sq, sk=sk, num_heads=h,
                              d=d, scale=None, kernel=plan[0], tiles=plan[1], entry=kind)
        return launch

    try:
        return _tune(key, attention_candidates(b, sq, sk, h, d), rule, make_launch,
                     lambda p: {"kernel": p[0], "tiles": p[1]}, measure=measure,
                     persist=persist, verbose=verbose, device=device)
    finally:
        ops.clear()


def tune_attention(b: int, sq: int, sk: int, h: int, d: int, dtype=torch.bfloat16, *,
                   measure=None, persist: bool = True, verbose: bool = False,
                   device=None) -> Tuned:
    """Measure the bf16 kernels' plans for q, k, v (B, S, H*D) apart and
    record the fastest under the ``attention`` key."""
    return _tune_attention_entry("attention", b, sq, sk, h, d, dtype, measure=measure,
                                 persist=persist, verbose=verbose, device=device)


def tune_attention_fused(b: int, sq: int, sk: int, h: int, d: int, dtype=torch.bfloat16, *,
                         measure=None, persist: bool = True, verbose: bool = False,
                         device=None) -> Tuned:
    """The same for the fused-operand entry point the UNet dispatches: self
    attention (sq == sk) out of the (B, S, 3C) QKV buffer, cross attention
    against the (B, Sk, 2C) KV buffer; recorded under the ``attention_qkv``
    or ``attention_kv`` key."""
    return _tune_attention_entry("qkv" if sq == sk else "kv", b, sq, sk, h, d, dtype,
                                 measure=measure, persist=persist, verbose=verbose,
                                 device=device)


# ---------------------------------------------------------------------------
# a signature's shapes
# ---------------------------------------------------------------------------


def attention_shapes_for_unet(cfg, lat_h: int, lat_w: int, batch: int, ctx_len: int = 77,
                              cfg_factor: int = 2) -> list[tuple[int, int, int, int, int]]:
    """Every (b, sq, sk, h, d) the UNet dispatches at this signature: one
    self and one cross shape per attention level. ``cfg_factor=2`` is the
    CFG-doubled batch; the no-CFG and guidance-interval cond-only branches
    dispatch at ``cfg_factor=1``."""
    shapes = set()
    b = cfg_factor * batch
    h_, w_ = lat_h, lat_w
    for i, btype in enumerate(cfg.down_block_types):
        ch = cfg.block_out_channels[i]
        if btype == "CrossAttnDownBlock2D":
            heads = cfg.num_heads(ch)
            s = h_ * w_
            shapes.add((b, s, s, heads, ch // heads))
            shapes.add((b, s, ctx_len, heads, ch // heads))
        if i < len(cfg.block_out_channels) - 1:
            h_, w_ = h_ // 2, w_ // 2
    # the mid block's attention at the innermost resolution; the up path
    # mirrors the down shapes
    ch = cfg.block_out_channels[-1]
    heads = cfg.num_heads(ch)
    s = h_ * w_
    shapes.add((b, s, s, heads, ch // heads))
    shapes.add((b, s, ctx_len, heads, ch // heads))
    return sorted(shapes)


def _probe_unet(cfg, lat_h: int, lat_w: int, batch: int, cfg_factor: int, binding: dict,
                probes: dict, fused: bool = True) -> None:
    """Run the UNet step as the pipeline does (the cross K/V precompute, then
    ``unet_apply`` on it) on torch's ``meta`` device under ``binding``, with
    ``probes`` ({op: fn}) registered as the "_shape_probe" backend: no
    operations and no real parameters, the counterpart of the JAX module's
    ``jax.eval_shape`` probe."""
    from stabletriton_tpu_torch import ops
    from stabletriton_tpu_torch.compile import fuse_attention_projections
    from stabletriton_tpu_torch.models import unet as unet_mod
    from stabletriton_tpu_torch.ops.registry import _REGISTRY

    meta = torch.device("meta")
    params = {k: torch.empty(s, dtype=torch.bfloat16, device=meta)
              for k, s in unet_mod.unet_param_shapes(cfg).items()}
    if fused:
        params = fuse_attention_projections(params)
    b = cfg_factor * batch
    if cfg.has_addition_embedding:
        pooled = cfg.projection_class_embeddings_input_dim - 6 * cfg.addition_time_embed_dim
        te, tid = (torch.empty((b, pooled), dtype=torch.bfloat16, device=meta),
                   torch.empty((b, 6), device=meta))
    else:
        te, tid = (torch.empty((b, 0), dtype=torch.bfloat16, device=meta),
                   torch.empty((b, 0), device=meta))
    for op, fn in probes.items():
        _REGISTRY.setdefault(op, {})["_shape_probe"] = fn
    try:
        with torch.inference_mode(), ops.use_backends(binding):
            ctx = torch.empty((b, 77, cfg.cross_attention_dim), dtype=torch.bfloat16,
                              device=meta)
            kv = unet_mod.precompute_cross_kv(cfg, params, ctx)
            unet_mod.unet_apply(cfg, params,
                                torch.empty((b, lat_h, lat_w, cfg.in_channels),
                                            dtype=torch.bfloat16, device=meta),
                                torch.empty((b,), device=meta), None, te, tid, cross_kv=kv)
    finally:
        for op in probes:
            _REGISTRY[op].pop("_shape_probe", None)


def conv_shapes_for_unet(cfg, lat_h: int, lat_w: int, batch: int, cfg_factor: int = 2,
                         gn_pairs: bool = False) -> list[tuple]:
    """Every 3x3 stride-1 SAME conv the UNet dispatches at this signature,
    as (n, h, w, cin, cout, has_res, act), recorded by running the step on
    the meta device under a shape-probe binding, so no transition conv,
    skip-concat input, conv_in / conv_out or upsampler is missed.
    ``gn_pairs=True`` records only the convs dispatched through the
    ``gn_conv2d`` pair op (the ``:gn`` keys' shapes)."""
    from stabletriton_tpu_torch.ops import reference

    shapes: set = set()

    def probe(x, w, b=None, *, stride=1, padding=1, residual=None, act=None):
        if (not isinstance(w, tuple) and w.dim() == 4 and tuple(w.shape[:2]) == (3, 3)
                and stride == 1 and padding == 1):
            shapes.add((int(x.shape[0]), int(x.shape[1]), int(x.shape[2]),
                        int(w.shape[2]), int(w.shape[3]), residual is not None, act))
        return reference.conv2d(x, w, b, stride=stride, padding=padding, residual=residual,
                                act=act)

    def gn_probe(x, gamma, beta, w, b=None, *, num_groups=32, eps=1e-5, gn_act="silu",
                 stride=1, padding=1, residual=None, act=None):
        probe(x, w, b, stride=stride, padding=padding, residual=residual, act=act)
        return reference.gn_conv2d(x, gamma, beta, w, b, num_groups=num_groups, eps=eps,
                                   gn_act=gn_act, stride=stride, padding=padding,
                                   residual=residual, act=act)

    if gn_pairs:
        probes, binding = {"gn_conv2d": gn_probe}, {"conv2d": "reference",
                                                   "gn_conv2d": "_shape_probe"}
    else:
        # gn_conv2d composes through the conv2d binding, so the probe sees
        # the resnet pairs' convs as dispatched
        probes, binding = {"conv2d": probe}, {"conv2d": "_shape_probe",
                                             "gn_conv2d": "reference"}
    _probe_unet(cfg, lat_h, lat_w, batch, cfg_factor, binding, probes)
    return sorted(shapes, key=lambda s: (s[:5], s[5], str(s[6])))


def linear_shapes_for_unet(cfg, lat_h: int, lat_w: int, batch: int, cfg_factor: int = 2,
                           fused: bool = True) -> list[tuple[int, int, int]]:
    """Every (m, k, n) GEMM the UNet step dispatches through the linear op
    at this signature (its cross K/V precompute included), probed as
    :func:`conv_shapes_for_unet` is; ``fused``: with the attention
    projections fused, as the pipeline runs them off a mesh."""
    from stabletriton_tpu_torch.ops import reference

    shapes: set = set()

    def probe(x, w, b=None, *, act=None):
        shapes.add((math.prod(x.shape[:-1]), int(x.shape[-1]), int(w.shape[-1])))
        return reference.linear(x, w, b, act=act)

    _probe_unet(cfg, lat_h, lat_w, batch, cfg_factor, {"linear": "_shape_probe"},
                {"linear": probe}, fused=fused)
    return sorted(shapes)


# ---------------------------------------------------------------------------
# a signature, tuned
# ---------------------------------------------------------------------------


def _union(fn, cfg_factors, *args, **kw) -> list:
    return sorted({s for f in cfg_factors for s in fn(*args, cfg_factor=f, **kw)},
                  key=lambda s: (s[:5], str(s[5:])))


def ensure_attention_tuned(cfg, lat_h: int, lat_w: int, batch: int, dtype=torch.bfloat16,
                           ctx_len: int = 77, cfg_factors: tuple[int, ...] = (2,),
                           **tune_kw) -> list[Tuned]:
    """Tune every attention shape of this signature that has no entry: the
    split interface first, then the fused-operand entry points the UNet
    dispatches. ``cfg_factors``: the UNet batch multiples the loop runs, (2,)
    for CFG, (1,) without, (1, 2) under a guidance interval. Returns what
    was tuned."""
    shapes = _union(attention_shapes_for_unet, cfg_factors, cfg, lat_h, lat_w, batch, ctx_len)
    tuned = []
    for b, sq, sk, h, d in shapes:
        if lookup(attention_key(b, sq, sk, h, d, dtype)) is None:
            tuned.append(tune_attention(b, sq, sk, h, d, dtype, **tune_kw))
    for b, sq, sk, h, d in shapes:
        kind = "qkv" if sq == sk else "kv"
        if lookup(fused_attention_key(kind, b, sq, sk, h, d, dtype)) is None:
            tuned.append(tune_attention_fused(b, sq, sk, h, d, dtype, **tune_kw))
    return tuned


def ensure_conv_tuned(cfg, lat_h: int, lat_w: int, batch: int, dtype=torch.bfloat16,
                      cfg_factors: tuple[int, ...] = (2,), gn: bool = False,
                      **tune_kw) -> list[Tuned]:
    """Tune every wgmma conv shape of this signature that has no entry
    (``gn``: the GroupNorm-prologue convs of the gn_conv2d pairs, under
    their ``:gn`` keys); returns what was tuned."""
    from stabletriton_tpu_torch.kernels import wgmma_plan as wp

    tuned = []
    for n, h, w, cin, cout, has_res, act in _union(conv_shapes_for_unet, cfg_factors, cfg,
                                                    lat_h, lat_w, batch, gn_pairs=gn):
        if (wp.conv_fits(n, h, w, cin, cout, gn=gn)
                and lookup(conv_key(n, h, w, cin, cout, dtype, has_res, act, gn)) is None):
            tuned.append(tune_conv(n, h, w, cin, cout, dtype, has_res=has_res, act=act, gn=gn,
                                   **tune_kw))
    return tuned


def ensure_linear_tuned(cfg, lat_h: int, lat_w: int, batch: int, dtype=torch.bfloat16,
                        cfg_factors: tuple[int, ...] = (2,), fused: bool = True,
                        **tune_kw) -> list[Tuned]:
    """Tune every GEMM of this signature that the wgmma or skinny kernel
    takes and has no entry; returns what was tuned."""
    from stabletriton_tpu_torch.kernels import linear as lin

    tuned = []
    for m, k, n in sorted({s for f in cfg_factors for s in linear_shapes_for_unet(
            cfg, lat_h, lat_w, batch, cfg_factor=f, fused=fused)}):
        name = lin.variant(m, k, n, dtype)
        if ((name == "wgmma_bf16" or name.startswith("skinny"))
                and lookup(linear_key(m, k, n, dtype)) is None):
            tuned.append(tune_linear(m, k, n, dtype, **tune_kw))
    return tuned


def cfg_factors(guidance_scale: float, guidance_interval) -> tuple[int, ...]:
    """The UNet batch multiples a loop runs, the JAX pipeline's rule: (1,)
    without CFG, (1, 2) under a guidance interval, else (2,)."""
    if guidance_scale <= 1:
        return (1,)
    if guidance_interval is not None:
        return (1, 2)
    return (2,)


def ensure_tuned_for(binding: dict, cfg, lat_h: int, lat_w: int, batch: int, dtype,
                     factors: tuple[int, ...], fused: bool = True, **tune_kw) -> list[Tuned]:
    """Tune the ops ``binding`` sends to a kernel at this signature:
    attention and the conv under "cuda" attention and "direct" conv, the
    GroupNorm-prologue conv under gn_conv2d "fused", the linear under
    linear "cuda". Returns what was tuned."""
    tuned = []
    if binding.get("attention") == "cuda":
        tuned += ensure_attention_tuned(cfg, lat_h, lat_w, batch, dtype, cfg_factors=factors,
                                        **tune_kw)
    if binding.get("conv2d") == "direct":
        tuned += ensure_conv_tuned(cfg, lat_h, lat_w, batch, dtype, cfg_factors=factors,
                                   **tune_kw)
    if binding.get("gn_conv2d") == "fused":
        tuned += ensure_conv_tuned(cfg, lat_h, lat_w, batch, dtype, cfg_factors=factors,
                                   gn=True, **tune_kw)
    if binding.get("linear") == "cuda":
        tuned += ensure_linear_tuned(cfg, lat_h, lat_w, batch, dtype, cfg_factors=factors,
                                     fused=fused, **tune_kw)
    return tuned
