"""A run whose timed path is broken underneath comes out not correct.

The look for a card is skipped: the run drives the port's tiny models on
the CPU, whose plain float32 binding agrees with the reference to ~3e-6."""

import numpy as np
import pytest

from gpubench import harness


def _run(root, seed=4242):
    return harness.run_cell("tiny.tinymix", seed, 1.0, False, device="cpu", root=root)


def test_a_sound_run_is_correct(tiny_root):
    assert _run(tiny_root)["correct"] is True


def _state_unchanged(monkeypatch):
    from stabletriton_tpu_torch.runtime import scheduler

    monkeypatch.setattr(scheduler, "euler_step", lambda sample, eps, sigma, nxt: sample)


def _half_batch(monkeypatch):
    from stabletriton_tpu_torch.runtime.serving import ServingEngine

    inner = ServingEngine._run_group

    def run_group(self, reqs):
        # the first half of the group served, the rest copied from it
        half = max(len(reqs) // 2, 1)
        imgs = inner(self, reqs[:half])
        return np.concatenate([imgs[:half]] * 2 + [imgs[:1]] * len(reqs))[:len(reqs)]

    monkeypatch.setattr(ServingEngine, "_run_group", run_group)


def _answer_altered(monkeypatch):
    from stabletriton_tpu_torch.runtime import pipeline

    inner = pipeline._decode_images

    def decode(cfg, params, latents):
        return inner(cfg, params, latents) + 0.01

    monkeypatch.setattr(pipeline, "_decode_images", decode)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _answer_altered])
def test_a_broken_path_is_not_correct(tiny_root, monkeypatch, fault):
    fault(monkeypatch)
    line = _run(tiny_root)
    assert line["correct"] is False
    assert any(v["value"] > v["limit"] for v in line["compared"].values())


def test_the_gap_ratio_cancels_the_seeds_amplification():
    """image_gap_ratio reads the program's gap in units of the two
    references' gap: amplifying every gap alike leaves it as it was, and a
    program that strays farther than the references reads more."""
    rng = np.random.default_rng(5)
    refs = [rng.normal(size=(8, 8, 3)) for _ in range(3)]
    d_prog = [rng.normal(size=r.shape) for r in refs]
    d_ref = [rng.normal(size=r.shape) for r in refs]

    def ratio(scale, prog=1.0):
        got = harness.sample_numbers([r + 1e-3 * scale * prog * d for r, d in zip(refs, d_prog)],
                                     refs, [r + 1e-3 * scale * d for r, d in zip(refs, d_ref)])
        return got["image_gap_ratio"]

    assert ratio(1.0) == pytest.approx(ratio(7.0), rel=1e-3)
    assert ratio(1.0) == pytest.approx(1.0, rel=0.2)
    assert ratio(1.0, prog=3.0) == pytest.approx(3.0 * ratio(1.0), rel=1e-3)


def test_the_float32_reference_runs_where_the_limits_ask(tiny_root, monkeypatch):
    spec = harness.load_cell("tiny.tinymix", tiny_root)
    dtypes = []

    def refs(spec, params, requests, device, unet_dtype=None):
        dtypes.append(unet_dtype)
        return [np.ones((4, 4, 3)) for _ in requests]

    monkeypatch.setattr(harness, "reference_images", refs)
    reqs = [type("R", (), {"image": np.ones((4, 4, 3))})()]
    harness.check_outputs(spec, {}, reqs, "cpu", log=lambda *a, **k: None)
    assert dtypes == [None]
    spec.config["check"]["limits"] = {"image_gap_ratio": 1.5}
    dtypes.clear()
    out = harness.check_outputs(spec, {}, reqs, "cpu", log=lambda *a, **k: None)
    import torch
    assert dtypes == [None, torch.float32]
    assert set(out) == {"image_gap_ratio"}
