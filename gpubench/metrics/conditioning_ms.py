"""conditioning_ms: the mean device interval of the pipeline's
``pipeline.conditioning`` spans (the loop's inputs: CLIP, the time ids,
the noise) in the window: one a group."""

from gpubench import spans


def read(run, name):
    got = spans.window(run)
    if not got:
        return None
    done = [s for s in spans.named(got, "pipeline.conditioning") if s.device is not None]
    if not done:
        return None
    return 1e3 * sum(spans.device_s(s) for s in done) / len(done)
