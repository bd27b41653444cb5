"""serve_window_ms: the mean host duration of the serving engine's batching
windows (its ``serve.window`` spans: the worker's wait for requests to
co-batch with the one it took) that opened and closed inside the window."""

from gpubench import spans


def read(run, name):
    got = spans.window(run)
    if not got:
        return None
    windows = spans.named(got, "serve.window")
    if not windows:
        return None
    return 1e3 * sum(s.seconds for s in windows) / len(windows)
