"""request_s_p50: the median latency, submit to the future's result, of
the requests completed inside the window."""

import numpy as np


def read(run, name):
    lat = [r.t_done - r.t_submit for r in run.window_requests()]
    return float(np.percentile(lat, 50)) if lat else None
