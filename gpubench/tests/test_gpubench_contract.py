"""BENCHMARK.json and the files it names keep to the benchmark's contract."""

import json
import re

import pytest

from gpubench import harness, tracing

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gpubench/run.py"]
    assert BENCH["paths"] == ["gpubench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 2 + 14 * 24 <= (43200 - 1200 - 24 * 180) // (BENCH["run_seconds"] + 60) + 1
    assert 1 <= cells <= 24
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_have_just_their_keys_and_good_names(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[section] <= set(e) <= ENTRY_KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"])
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] and "\t" not in e[k]


def test_cells_configs_and_metrics_are_consistent():
    configs = {c["name"]: c for c in BENCH["configs"]}
    cells = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for c in configs.values():
        assert (REPO / c["file"]).is_file() and c["file"].startswith("gpubench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in cells.values())
    for w in cells.values():
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (REPO / "gpubench/traffic" / f"{w['traffic']}.json").is_file()
        reported = [m for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        layered = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert len(reported) >= 2 and layered
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in moved.get("workloads", cells)
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_metric_has_a_reader_and_every_name_a_file():
    spec = harness.load_cell(BENCH["workloads"][0]["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]).read), m["name"]
    for path in (REPO / "gpubench").rglob("*"):
        rel = path.relative_to(REPO).as_posix()
        if "__pycache__" not in rel:
            assert re.match(r"^[A-Za-z0-9_.\-/]+$", rel), rel


def test_families_claim_each_port_kernel_at_most_once():
    spec = harness.load_cell(BENCH["workloads"][0]["name"])
    fams = spec.families()
    for f in fams.values():
        assert f["patterns"] and set(f["work"]) <= {"attention", "conv3x3", "conv1x1", "linear"}
    got = tracing.classify(tracing.port_kernel_names(), fams)
    assert got["attn_wgmma_bf16"] == "attention"
    assert got["conv_gn_wgmma_bf16"] == "conv3x3"


def test_a_name_in_two_families_is_a_fault():
    with pytest.raises(harness.HarnessFault):
        tracing.classify(["k"], {"a": {"patterns": ["k"]}, "b": {"patterns": ["^k$"]}})


def test_the_result_line(tiny_root):
    line = harness.run_cell("tiny.tinymix", 2**31 + 5, 1.0, False, device="cpu",
                            root=tiny_root)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "compared"]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["metrics"]) == {"images_per_s", "request_s_p50", "setup_s"}
    for name, m in line["metrics"].items():
        assert NAME.match(name) and UNIT.match(m["unit"]) and m["value"] > 0
    for k, v in line["compared"].items():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
