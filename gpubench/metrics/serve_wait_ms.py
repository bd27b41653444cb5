"""serve_wait_ms: the mean over the window's requests of the latency less
the wall time of the pipeline call that served the request's group (the
traced run synchronises at that call's end): the time a request spent in
the engine (its queue, the batching window, the hand-back) and not in the
pipeline."""


def read(run, name):
    if not run.synced:
        return None
    where = run.group_of()
    waits = []
    for r in run.window_requests():
        if r.seed in where:
            g = where[r.seed][0]
            waits.append((r.t_done - r.t_submit) - (g["t_end"] - g["t_start"]))
    return 1e3 * sum(waits) / len(waits) if waits else None
