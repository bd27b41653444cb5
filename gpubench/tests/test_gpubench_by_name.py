"""A configuration, a mix, a per-layer metric and a kernel family dropped
into a copy of the benchmark are found by name, with no other edit."""

import json

from gpubench import harness, tracing


def test_new_files_are_found_by_name(tiny_root):
    # a per-layer metric: its reader file and its BENCHMARK.json entry
    (tiny_root / "metrics" / "tiny_requests.py").write_text(
        "def read(run, name):\n    return float(len(run.window_requests()))\n")
    bench_path = tiny_root.parent / "BENCHMARK.json"
    bench = json.loads(bench_path.read_text())
    bench["per_layer"].append({"name": "tiny_requests.interactive", "unit": "requests",
                               "better": "higher", "source": "host_clock", "layer": "serving",
                               "moves": "request_s_p50", "workloads": ["tiny.tinymix"]})
    bench_path.write_text(json.dumps(bench))
    # a kernel family
    (tiny_root / "families" / "tiny_family.json").write_text(json.dumps(
        {"why": "test", "work": [], "patterns": ["^tiny_kernel$"]}))

    spec = harness.load_cell("tiny.tinymix", tiny_root)
    assert spec.config["name"] == "tiny" and spec.mix.name == "tinymix"
    assert tracing.classify(["tiny_kernel", "elsewhere"], spec.families()) == {
        "tiny_kernel": "tiny_family", "elsewhere": "other"}
    line = harness.run_cell("tiny.tinymix", 99, 1.0, True, device="cpu", root=tiny_root)
    assert line["correct"] is True
    assert line["metrics"]["tiny_requests.interactive"]["value"] > 0
    assert "serve_wait_ms.interactive" in line["metrics"]
    assert "images_per_s" not in line["metrics"]  # trace runs report per-layer metrics
    assert line["device"]["window_s"] > 0 and "breakdown" in line


def test_a_mix_with_open_arrivals_signatures_and_a_generator_runs_from_files(tmp_path):
    """An open mix, two signatures the reference follows, a generator module
    found by the mix's name for it, and a configuration's CompileConfig
    fields and binding by name: all as new files, none edited."""
    from conftest import make_root

    root = make_root(tmp_path, mix={
        "loop": "open", "rate_per_s": 6.0, "burst": [1, 2], "warm": [1, 2], "words": [3, 8],
        "stretch": 2, "generator": "tiny_gen",
        "signatures": [{}, {"height": 48, "width": 32, "steps": 2}]})
    (root / "traffic" / "tiny_gen.py").write_text(
        "from gpubench import traffic\n"
        "def request_params(seed, index, mix):\n"
        "    prompt, image_seed, sig = traffic.request_params(seed, index, mix)\n"
        "    return 'tiny ' + prompt, image_seed, sig\n")
    cfg_path = root / "configs" / "tiny.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["compile"] = {"cache_cross_kv": False}
    cfg_path.write_text(json.dumps(cfg))
    assert harness.compile_config(cfg).cache_cross_kv is False
    assert harness.compile_config(dict(cfg, binding="all_kernel")).overrides  # by name

    line = harness.run_cell("tiny.tinymix", 2**31 + 9, 1.5, False, device="cpu", root=root)
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] >= 4 and line["failed"] == 0
    spec = harness.load_cell("tiny.tinymix", root)
    assert spec.mix.request_params(5, 0)[0].startswith("tiny ")
