"""images_per_s: the images of every group that started inside the window,
over the time from the window's start to the last of them completing (a
stall anywhere counts)."""


def read(run, name):
    _, reqs, span = run.counted_groups()
    done = [r for r in reqs if r.error is None]
    if not done or span <= 0:
        return None
    return len(done) / span
