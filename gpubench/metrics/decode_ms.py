"""decode_ms: the device interval of the pipeline's ``pipeline.decode``
spans in the window over the images they decoded (each span's ``rows``,
padded rows included): the VAE decode's milliseconds an image."""

from gpubench import spans


def read(run, name):
    got = spans.window(run)
    if not got:
        return None
    done = [s for s in spans.named(got, "pipeline.decode") if s.device is not None]
    rows = sum(s.attrs["rows"] for s in done)
    if not rows:
        return None
    return 1e3 * sum(spans.device_s(s) for s in done) / rows
